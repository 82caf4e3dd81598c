"""Fixed-size batched search trees of the per-simulation engines.

Counterpart of the JAX package's ``search/tree.py``: struct-of-arrays over
``(B, N)`` with one node slot per simulation (slot 0 is the root, slot i
belongs to simulation i), per-node ``stats [visit, value_sum, expanded]``,
per-edge priors with the finite ``NEG`` at illegal actions and child slot
ids (-1 = never descended).  Edge statistics live on the child node.
Priors are exact float32 (or the stats' dtype): unlike the whole-move
search of ``search/fused.py`` they are not quantised.
"""

from __future__ import annotations

import dataclasses

import torch

VISIT, VALUE, EXPANDED = 0, 1, 2   # stats channels
NEG = -1e30                        # finite stand-in for -inf in priors


@dataclasses.dataclass
class Tree:
    """Batched search trees: leading axis B (games), second axis N (nodes).

    Attributes:
      stats: ``(B, N, 3)`` float — visit, value sum, expanded flag.
      prior: ``(B, N, A)`` float — priors, ``NEG`` at illegal actions.
      children: ``(B, N, A)`` int32 — child slot or -1.
      root_board: ``(B, 2, R, C)`` int8; root_player, root_move_count
      ``(B,)`` int32.
    """

    stats: torch.Tensor
    prior: torch.Tensor
    children: torch.Tensor
    root_board: torch.Tensor
    root_player: torch.Tensor
    root_move_count: torch.Tensor

    def clone(self) -> "Tree":
        return Tree(*(getattr(self, f.name).clone()
                      for f in dataclasses.fields(self)))


def init_tree(env, boards, players, move_counts, num_simulations,
              dtype=torch.float32) -> Tree:
    """Fresh trees rooted at the given positions, N = num_simulations + 1
    (the root is expanded separately)."""
    B = boards.shape[0]
    N = num_simulations + 1
    A = env.action_dim
    z = dict(device=boards.device)
    return Tree(
        stats=torch.zeros((B, N, 3), dtype=dtype, **z),
        prior=torch.full((B, N, A), NEG, dtype=dtype, **z),
        children=torch.full((B, N, A), -1, dtype=torch.int32, **z),
        root_board=boards.to(torch.int8).contiguous(),
        root_player=players.to(torch.int32).contiguous(),
        root_move_count=move_counts.to(torch.int32).contiguous(),
    )


def root_visit_counts(tree: Tree) -> torch.Tensor:
    """Visit counts of the root's children per action, ``(B, A)`` int32."""
    child = tree.children[:, 0].long()
    visit = torch.gather(tree.stats[:, :, VISIT], 1, child.clamp(min=0))
    return torch.where(child >= 0, visit, torch.zeros_like(visit)).to(
        torch.int32)


def root_q(tree: Tree) -> torch.Tensor:
    """Root mean value ``(B,)``: value sum over max(visits, 1)."""
    return tree.stats[:, 0, VALUE] / torch.clamp(tree.stats[:, 0, VISIT],
                                                 min=1.0)
