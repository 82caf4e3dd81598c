"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), placed in
``build/alphazero_tpu_torch/`` at the repository root and named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt at its next use.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Every C entry point takes pointers as ``void*`` (``tensor.data_ptr()``), the
stream as ``void*`` (:func:`stream`), launches on that stream and returns
``cudaGetLastError()``; :class:`CudaKernel` raises when it is not 0 and
counts each successful launch in ``launches``.  A wrapper runs its plain
PyTorch version only for CPU tensors (:func:`plain`) and checks every
operand it passes to a kernel (:func:`check`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "alphazero_tpu_torch"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# source → extra flags.  The search kernels must reproduce the plain
# versions' float32 arithmetic bit for bit: no multiply-add contraction.
# The forward kernels are held to a tolerance and keep it.
SOURCES = {
    "dense_forward.cu": [],
    "search.cu": ["-fmad=false"],
    "sim.cu": ["-fmad=false"],
    "resnet_tower.cu": [],
}

_LIBS: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _flags(source: str):
    return ARCH + BASE_FLAGS + SOURCES[source]


def lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(sources=None) -> dict:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together.  Returns ``{source: ptxas log}`` of
    the sources built now; raises with the compiler's output on failure."""
    sources = list(SOURCES) if sources is None else list(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path()] + _flags(src) + ["-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {src} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        path = lib_path(source)
        if not path.exists():
            build_all([source])
        lib = ctypes.CDLL(str(path))
        lib.az_error_string.argtypes = [ctypes.c_int]
        lib.az_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


class CudaKernel:
    """One C entry point of one source, with its launch count.

    ``argtypes`` are ctypes types; pass ``ctypes.c_void_p`` for every
    pointer and the stream, or ctypes would cut them to 32 bits.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    @property
    def name(self) -> str:
        return self.symbol

    def __call__(self, *args):
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = load(self.source).az_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


def plain(t: torch.Tensor) -> bool:
    """Whether a wrapper runs the plain version: yes for a CPU tensor, no for
    a CUDA tensor (the kernel runs); other devices have neither."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, for a kernel launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(t: torch.Tensor, dtype, shape, device, name):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel operand must be."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} contiguous on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
