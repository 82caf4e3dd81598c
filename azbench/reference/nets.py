"""Plain forwards of the benchmark's networks, in float32 with TF32 off.

Each model family is a file of its own, ``families/<family>.py``, found by
the name in a configuration's ``model["family"]`` (:func:`family`), so a
new family adds a file and edits none.  A family file defines

* ``param_specs(model, g)``: ``[(name, shape, init)]`` of the parameters,
  under the flax tree's names; ``init`` is ``lecun`` (normal over
  √fan-in, cut at 2σ), ``normal``, ``zeros`` or ``ones``;
* ``forward(net, obs) -> (logits (B, A), value (B,))``: the forward of a
  :class:`Net`, built from its parameters ``net.p``, its rounding
  ``net.q`` and its ``_linear`` and ``_ln``;
* ``flops_per_pos(model, g)``: the forward FLOPs of one position, which
  ``azbench.counts.model_flops_per_pos`` reports;
* and, where the network carries state (per-layer tensors that are not
  trained parameters, such as batch norm's running statistics),
  ``state(net, obs) -> {name: float32 tensor}``: the family's layers run
  with each batch norm normalising by the batch's own per-channel mean and
  biased variance, which it returns under the names of the program's
  buffers.  With them in ``net.p``, ``forward`` gives the same outputs on
  that batch, up to float32 rounding.  The harness calibrates the state on
  positions drawn from the seed (``azbench.harness.weights``) and hands it
  to the program in one dict with the parameters.

LayerNorm eps is 1e-6 (flax).  Parameters and state are one dict of
float32 tensors.  ``precision="fp8"`` rounds both operands of every matrix
product and convolution to float8 e4m3 with a per-tensor scale, the
control of the benchmark's correctness check; it rounds no state.
"""

from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F

from azbench.reference.games import Game

LN_EPS = 1e-6
FP8_MAX = 448.0          # largest finite float8 e4m3fn
FAMILIES = Path(__file__).resolve().parent / "families"


def family(name: str, directory: Path = FAMILIES):
    """The module of ``directory/<name>.py``; raises ValueError naming the
    file where there is none."""
    directory = Path(directory)
    path = directory / f"{name}.py"
    if path.parent != directory or not path.is_file():
        raise ValueError(f"no reference network for family {name!r}: "
                         f"{path} is not a file")
    spec = importlib.util.spec_from_file_location(
        f"azbench_family_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def param_specs(model: dict, g: Game) -> list:
    """``[(name, shape, init)]`` of a configuration's ``model`` section."""
    return family(model["family"]).param_specs(model, g)


def linear_specs(name: str, o: int, i: int) -> list:
    """Specs of a linear layer ``name`` from ``i`` to ``o`` features."""
    return [(f"{name}.weight", (o, i), "lecun"), (f"{name}.bias", (o,),
                                                  "zeros")]


def ln_specs(name: str, d: int) -> list:
    """Specs of a LayerNorm ``name`` over ``d`` features."""
    return [(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")]


@contextlib.contextmanager
def ieee_float32():
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, back in
    float32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Net:
    """``net(obs (B, F, R, C)) → (probs (B, A), value (B,))`` of a
    configuration's model on parameters ``params``, by the forward of its
    family's file in ``directory``."""

    def __init__(self, model: dict, g: Game, params: dict,
                 precision: str = "float32", directory: Path = FAMILIES):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.model, self.g = model, g
        self.family = family(model["family"], directory)
        self.forward = self.family.forward
        self.p = {k: v.float() for k, v in params.items()}
        self.q = fp8 if precision == "fp8" else (lambda t: t)

    def _linear(self, x, name):
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                        self.p[f"{name}.bias"])

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor):
        with ieee_float32():
            logits, value = self.forward(self, obs.float())
        return torch.softmax(logits, -1), value

    @torch.no_grad()
    def state(self, obs: torch.Tensor) -> dict:
        """The family's state calibrated on the batch ``obs``."""
        with ieee_float32():
            return self.family.state(self, obs.float())
