"""Checkpoints of the whole training state with ``torch.save``.

Counterpart of the JAX package's Orbax ``utils/checkpoint.py``, in the
port's own format: step ``s`` is one file, ``<directory>/<s>/state.pt``, a
nested dict of CPU tensors written to a temporary file and moved into place
with ``os.replace``, loadable with ``torch.load(weights_only=True)``.  The
JAX package does not read these files, and this module does not read Orbax
checkpoints.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

STATE_FILE = "state.pt"


def _to_cpu(state):
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if torch.is_tensor(state):
        return state.detach().cpu()
    return state


def _check_like(got, like, where: str):
    """Raise ``ValueError`` where ``got`` differs from ``like`` in a name,
    a shape or a dtype (Orbax's restore against an abstract target)."""
    if isinstance(like, dict):
        if not isinstance(got, dict) or set(got) != set(like):
            raise ValueError(f"checkpoint{where}: names {sorted(got)} != "
                             f"{sorted(like)}" if isinstance(got, dict) else
                             f"checkpoint{where}: not a dict")
        for k in like:
            _check_like(got[k], like[k], f"{where}.{k}")
    elif torch.is_tensor(like):
        if not torch.is_tensor(got) or got.shape != like.shape \
                or got.dtype != like.dtype:
            desc = (f"{got.dtype} {tuple(got.shape)}" if torch.is_tensor(got)
                    else type(got).__name__)
            raise ValueError(f"checkpoint{where}: {desc} where "
                             f"{like.dtype} {tuple(like.shape)} is expected")
    elif type(got) is not type(like):
        raise ValueError(f"checkpoint{where}: {type(got).__name__} where "
                         f"{type(like).__name__} is expected")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(step), STATE_FILE)

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self._dir)
                      if d.isdigit() and os.path.exists(self._path(int(d))))

    def save(self, step: int, state: Any):
        path = self._path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_raw(self, step: Optional[int] = None) -> Any:
        """The state of ``step`` (default: the latest) as saved, on the
        CPU, without a target to check it against; None when there is
        none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """The state of ``step`` (default: the latest), on the CPU, after
        checking that it has ``state_like``'s names, shapes and dtypes
        (``ValueError`` otherwise); None when there is no checkpoint."""
        state = self.restore_raw(step)
        if state is not None:
            _check_like(state, state_like, "")
        return state
