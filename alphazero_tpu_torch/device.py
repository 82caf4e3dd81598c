"""Device resolution shared by the package's entry points, and the
float32 precision the plain forwards keep on the card."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    The default is the GPU.  Without CUDA the call raises instead of moving
    to the CPU on its own: the plain PyTorch path runs only when the caller
    asks for it with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def ieee_float32_convs():
    """cuDNN runs float32 convs in TF32 unless told not to; the port keeps
    them IEEE float32 (the bfloat16 default dtype is unaffected)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def ieee_float32_matmuls():
    """The heads and the plain tower multiply in IEEE float32: TF32 off for
    the enclosed products (PyTorch's default, set here so that no caller's
    setting changes the heads)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
