"""Symmetry augmentation as permutation gathers.

Counterpart of the JAX package's ``data/augment.py``: each env exposes its
symmetry group as cell and action index permutations (identity and the
left-right flip for connect4), so augmenting a position is a gather.
"""

from __future__ import annotations

import torch

from alphazero_tpu_torch.device import resolve_device


class Symmetries:
    """Permutation tables of one env's symmetry group, on a device."""

    def __init__(self, env, device="cuda"):
        dev = resolve_device(device)
        cell_perms, action_perms = env.symmetries()
        self.cell_perms = torch.as_tensor(cell_perms, dtype=torch.long,
                                          device=dev)       # (S, R·C)
        self.action_perms = torch.as_tensor(action_perms, dtype=torch.long,
                                            device=dev)     # (S, A)
        self.num = int(cell_perms.shape[0])
