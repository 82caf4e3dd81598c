"""Random network weights from a seed, made on the device.

``make_params(specs, seed, device)`` draws every ``lecun`` and ``normal``
parameter of ``reference.nets.param_specs`` from ONE normal draw of a
generator on ``device``: a ``lecun`` kernel is that draw cut at ±2 and
scaled by ``1 / (0.8796·√fan-in)`` (the spread of flax's truncated LeCun
normal), a ``normal`` one (the ViT's CLS token and position embedding) is
the draw itself; biases are 0 and LayerNorm and batch-norm scales 1.  The
same seed gives the same weights on the same kind of device.  A network's
state (batch norm's running statistics) is not drawn: the harness
calibrates it on positions drawn from the seed
(``azbench.harness.weights``).
"""

from __future__ import annotations

import math

import torch

TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at ±2


def make_params(specs, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    drawn = [(n, s, i) for n, s, i in specs if i in ("lecun", "normal")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            w = z[at:at + n].reshape(shape)
            at += n
            if init == "lecun":
                fan_in = n // shape[0]
                w = w.clamp(-2.0, 2.0) * (1.0 / (TRUNC_STD
                                                 * math.sqrt(fan_in)))
            out[name] = w.contiguous()
    return out
