"""Device-resident replay ring of whole-game blocks.

Counterpart of the JAX package's ``data/replay.py``: a finished game's
trajectory slab (observations and root policies of up to ``L =
env.max_moves`` moves, its length and winner) is written as one block of a
ring.  Sampling draws a game ∝ its length, a move in it and a symmetry, and
rebuilds the value target from the winner and the move's parity.

Under a mesh (``parallel/``) every data rank keeps a ring of its own, of
``G // N`` blocks (``G = capacity // L``, N data ranks), and writes and
samples only that ring.  The JAX package stacks those rings into one
sharded buffer, ``(N, G // N, ...)`` arrays with ``(N,)`` cursors and sizes:
:func:`create_sharded` and :func:`to_sharded` build that layout as JAX
does, :func:`create_ring` makes one rank's ring alone, :func:`shard_of`
takes one rank's ring out of the layout and
:func:`stack_shards` puts the rings back together (for checkpoints and
``--load-buffer``).
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_tpu_torch.device import resolve_device


@dataclasses.dataclass
class ReplayBuffer:
    """Ring of whole-game trajectory blocks (one per finished game)."""

    obs: torch.Tensor      # (G, L, F, R, C) int8 canonical observations
    policy: torch.Tensor   # (G, L, A) float32 root visit distributions
    length: torch.Tensor   # (G,) int32 recorded moves (0 = empty block)
    winner: torch.Tensor   # (G,) int32 0/1 winner or -1 draw
    cursor: torch.Tensor   # () int32 next block slot
    size: torch.Tensor     # () int32 valid blocks (≤ G)

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def max_len(self) -> int:
        return self.obs.shape[1]


def create(env, capacity: int, device="cuda") -> ReplayBuffer:
    """``capacity`` is in positions; the ring holds ``capacity // L`` games."""
    dev = resolve_device(device)
    L = env.max_moves
    G = max(capacity // L, 1)
    z = dict(device=dev)
    return ReplayBuffer(
        obs=torch.zeros((G, L, env.feature_dim, env.rows, env.cols),
                        dtype=torch.int8, **z),
        policy=torch.zeros((G, L, env.action_dim), dtype=torch.float32, **z),
        length=torch.zeros((G,), dtype=torch.int32, **z),
        winner=torch.full((G,), -1, dtype=torch.int32, **z),
        cursor=torch.zeros((), dtype=torch.int32, **z),
        size=torch.zeros((), dtype=torch.int32, **z),
    )


def _fields(buf: ReplayBuffer) -> dict:
    return {f.name: getattr(buf, f.name) for f in dataclasses.fields(buf)}


def create_ring(env, capacity: int, num_shards: int,
                device="cuda") -> ReplayBuffer:
    """One data rank's empty ring: ``G // num_shards`` of the ``G =
    capacity // L`` blocks, the ring :func:`to_sharded` gives each rank of
    an empty flat buffer (the blocks that do not divide are dropped)."""
    G = max(capacity // env.max_moves, 1)
    if G < num_shards:
        raise ValueError(f"{G} blocks cannot make {num_shards} rings")
    return create(env, G // num_shards * env.max_moves, device)


def create_sharded(env, capacity: int, num_shards: int,
                   device="cuda") -> ReplayBuffer:
    """``num_shards`` empty rings stacked: the JAX package's sharded
    layout.  The block count ``capacity // L`` must divide over them."""
    if max(capacity // env.max_moves, 1) % num_shards:
        raise ValueError(f"{capacity // env.max_moves} blocks do not divide "
                         f"over {num_shards} rings")
    return stack_shards([create_ring(env, capacity, num_shards, device)
                         for _ in range(num_shards)])


def to_sharded(buf: ReplayBuffer, num_shards: int) -> ReplayBuffer:
    """A flat buffer re-laid out as ``num_shards`` rings, contiguous blocks
    each; the last ``G % num_shards`` blocks are dropped.  Ring ``i`` holds
    ``clip(min(size, Gs·S) - i·Gs, 0, Gs)`` blocks with its cursor at that
    count modulo ``Gs``, the JAX package's arithmetic (a wrapped ring's age
    order is not rebuilt: uniform sampling does not see it)."""
    if buf.cursor.dim() == 1:
        if buf.cursor.shape[0] != num_shards:
            raise ValueError(f"buffer has {buf.cursor.shape[0]} rings, "
                             f"not {num_shards}")
        return buf
    S, G = num_shards, buf.capacity
    Gs = G // S
    if Gs == 0:
        raise ValueError(f"{G} blocks cannot make {S} rings")
    dev = buf.size.device
    sizes = torch.clamp(torch.minimum(buf.size.long(),
                                      torch.tensor(Gs * S, device=dev))
                        - torch.arange(S, device=dev) * Gs, 0, Gs)
    blocks = {k: v[:Gs * S].reshape((S, Gs) + v.shape[1:])
              for k, v in _fields(buf).items() if v.dim() > 0}
    return ReplayBuffer(**blocks, cursor=(sizes % Gs).to(torch.int32),
                        size=sizes.to(torch.int32))


def shard_of(buf: ReplayBuffer, index: int) -> ReplayBuffer:
    """Ring ``index`` of a sharded buffer, as a flat buffer of its own
    (a copy)."""
    return ReplayBuffer(**{k: v[index].clone()
                           for k, v in _fields(buf).items()})


def stack_shards(rings) -> ReplayBuffer:
    """Flat rings of one capacity, stacked into the sharded layout."""
    return ReplayBuffer(**{k: torch.stack([_fields(r)[k] for r in rings])
                           for k in _fields(rings[0])})


def add_games(buf: ReplayBuffer, obs_slab, policy_slab, length, winner,
              mask) -> ReplayBuffer:
    """Write the masked games' slabs (``obs_slab (B, L, F, R, C)``,
    ``policy_slab (B, L, A)``, ``length``/``winner``/``mask (B,)``) at
    consecutive ring blocks from the cursor, in game order.  Updates
    ``buf`` in place and returns it."""
    G = buf.capacity
    m = mask.to(torch.int64)
    ranks = torch.cumsum(m, 0) - 1
    sel = mask.nonzero().reshape(-1)
    idx = ((buf.cursor.long() + ranks) % G)[sel]
    buf.obs[idx] = obs_slab[sel].to(torch.int8)
    buf.policy[idx] = policy_slab[sel].to(torch.float32)
    buf.length[idx] = length[sel].to(torch.int32)
    buf.winner[idx] = winner[sel].to(torch.int32)
    n = m.sum()
    buf.cursor = ((buf.cursor.long() + n) % G).to(torch.int32)
    buf.size = torch.clamp(buf.size.long() + n, max=G).to(torch.int32)
    return buf


def num_rows(buf: ReplayBuffer) -> torch.Tensor:
    """Recorded positions (before augmentation) across valid blocks."""
    return buf.length.sum()


def num_rows_augmented(buf: ReplayBuffer, num_syms: int,
                       skip: int) -> torch.Tensor:
    """Position count with each row ≥ ``skip`` counting its whole symmetry
    orbit."""
    l = buf.length.long()
    return (torch.clamp(l, max=skip) + torch.clamp(l - skip, min=0) * num_syms
            ).sum()


def sample_indices(buf: ReplayBuffer, batch_size: int, *, generator,
                   num_syms: int = 1, augment_skip: int = 0):
    """Draw ``(g, r, s)`` per row: the game with probability ∝ its length
    (game 0 when the buffer is empty), the move ``randint % length``, and
    the group element, uniform over ``num_syms`` and the identity for moves
    before ``augment_skip``."""
    dev = buf.length.device
    length = buf.length.long()
    weights = length.clamp(min=0).to(torch.float32)
    first = torch.zeros_like(weights)
    first[0] = 1.0
    weights = torch.where((length > 0).any(), weights, first)
    g = torch.multinomial(weights, batch_size, replacement=True,
                          generator=generator)
    r = torch.randint(0, 1 << 30, (batch_size,), generator=generator,
                      device=dev) % length[g].clamp(min=1)
    if num_syms > 1:
        s = torch.randint(0, num_syms, (batch_size,), generator=generator,
                          device=dev)
        s = torch.where(r < augment_skip, 0, s)
    else:
        s = torch.zeros_like(r)
    return g, r, s


def gather_sample(buf: ReplayBuffer, g, r, s=None, syms=None):
    """Rows ``(g, r)`` under group elements ``s`` → ``obs (bs, F, R, C)``
    float32, ``policy (bs, A)`` and ``value (bs,)``: the game's outcome
    from the row's player, who is ``r % 2`` (self-play games open with
    player 0)."""
    obs = buf.obs[g, r].to(torch.float32)
    pol = buf.policy[g, r]
    w = buf.winner[g].long()
    val = torch.where(w < 0, 0.0, torch.where(r % 2 == w, 1.0, -1.0)
                      ).to(torch.float32)
    if syms is not None and syms.num > 1:
        cp = syms.cell_perms[s]                           # (bs, RC)
        ap = syms.action_perms[s]                         # (bs, A)
        flat = obs.reshape(obs.shape[:-2] + (cp.shape[-1],))
        obs = torch.gather(flat, -1, cp[:, None, :].expand_as(flat)
                           ).reshape(obs.shape)
        pol = torch.gather(pol, -1, ap)
    return obs, pol, val


def sample(buf: ReplayBuffer, batch_size: int, *, generator, syms=None,
           augment_skip: int = 0):
    """Uniform position sample with the symmetry drawn per row: the JAX
    package's single-device ``sample``."""
    num = syms.num if syms is not None else 1
    g, r, s = sample_indices(buf, batch_size, generator=generator,
                             num_syms=num, augment_skip=augment_skip)
    return gather_sample(buf, g, r, s, syms)
