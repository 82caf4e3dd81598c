"""What every driver shares: the run's context, the configuration and
weights handed to the program, and the draws the benchmark makes."""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from typing import Optional

import torch

from azbench.reference import games, nets
from azbench.spec import Cell
from azbench.weights import make_params


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class Run:
    """One run of one cell.  ``control`` names the reference precision put
    in the program's place in the checked calls (None: the program)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: Optional[str] = None
    # filled in by the driver
    setup_s: Optional[float] = None
    memory_peak_bytes: int = 0
    data: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    profile: object = None
    _t0: float = dataclasses.field(default_factory=time.perf_counter)
    _age0: float = dataclasses.field(default_factory=process_age_s)

    @property
    def model(self) -> dict:
        return self.cell.config["config"]["model"]

    @property
    def mcts(self) -> dict:
        return self.cell.config["config"]["mcts"]

    @property
    def game(self) -> games.Game:
        return games.game(self.cell.config["config"]["env"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_opens(self) -> float:
        """Mark the end of set-up; returns the window's start clock."""
        self.sync()
        now = time.perf_counter()
        self.setup_s = self._age0 + (now - self._t0)
        return now

    def window_closed(self):
        """Read the peak of device memory once the window has closed."""
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))

    def check(self, name: str, value):
        self.checks[name] = {"value": value,
                             "limit": self.cell.limits[name]}

    def sub_seed(self, k: int) -> int:
        """A seed of the benchmark's own draws, ``k`` apart from others."""
        return (self.seed * 1_000_003 + k) % (2 ** 63)

    def generator(self, k: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.sub_seed(k))

    def net(self, params: dict, precision: str = "float32"):
        return nets.Net(self.model, self.game, params, precision)


def port_config(run: Run):
    """The program's ``Config`` of the cell's configuration, its training
    seed the run's seed."""
    from alphazero_tpu_torch.config import from_json
    cfg = dict(run.cell.config["config"])
    cfg["train"] = dict(cfg["train"], seed=run.seed)
    return from_json(json.dumps(cfg))


CALIBRATION_POSITIONS = 512


def random_positions(g: games.Game, n: int, gen: torch.Generator,
                     device) -> torch.Tensor:
    """Observations ``(n, F, R, C)`` of ``n`` positions by the rules, each
    from its own game of uniformly random legal moves that stops at a move
    count drawn uniformly from 0 to ``max_moves // 2``, or at its end."""
    half = g.max_moves // 2
    stop = torch.randint(0, half + 1, (n,), generator=gen, device=device)
    board = torch.zeros((n, 2, g.rows, g.cols), dtype=torch.int8,
                        device=device)
    moves = torch.zeros(n, dtype=torch.long, device=device)
    ended = torch.zeros(n, dtype=torch.bool, device=device)
    for _ in range(half):
        live = (moves < stop) & ~ended
        player = moves % 2
        u = torch.rand((n, g.action_dim), generator=gen, device=device)
        act = torch.where(g.legal(board), u, -1.0).argmax(-1)
        after = g.play(board, player, act)
        board = torch.where(live[:, None, None, None], after, board)
        ended |= live & g.won(after, player)
        moves += live.long()
    return g.observation(board, moves % 2)


def calibration_positions(run: Run) -> torch.Tensor:
    """The positions a family's state is calibrated on, from the run's
    seed (sub-seed 4, apart from the benchmark's other draws)."""
    return random_positions(run.game, CALIBRATION_POSITIONS,
                            run.generator(4), run.device)


def weights(run: Run, model) -> dict:
    """The run's weights, made on the device from its seed, with the
    state of a family that carries it (``state`` of its file) calibrated
    by the float32 reference on :func:`calibration_positions`: one dict,
    checked by name and shape against the program's parameters and
    persistent floating-point buffers (integer bookkeeping, such as batch
    norm's ``num_batches_tracked``, is the program's own)."""
    params = make_params(nets.param_specs(run.model, run.game), run.seed,
                         run.device)
    net = run.net(params)
    if hasattr(net.family, "state"):
        params.update(net.state(calibration_positions(run)))
    have = {k: tuple(t.shape) for k, t in
            model.state_dict(keep_vars=True).items() if t.is_floating_point()}
    want = {k: tuple(v.shape) for k, v in params.items()}
    if have != want:
        raise RuntimeError(f"the program's parameters and persistent float "
                           f"buffers {have} are not the configuration's "
                           f"{want}")
    return params


def dirichlet(run: Run, k: int, shape, alpha: float) -> torch.Tensor:
    """Symmetric Dirichlet(alpha) noise normalised over the last axis."""
    gam = torch._standard_gamma(torch.full(shape, float(alpha),
                                           device=run.device),
                                generator=run.generator(k))
    gam = gam.clamp(min=1e-30)
    return gam / gam.sum(-1, keepdim=True)


def gumbel(run: Run, k: int, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=run.generator(k), device=run.device)
    u = u.clamp(min=1e-12, max=1.0 - 1e-7)
    return -torch.log(-torch.log(u))


def sample(run: Run, k: int, n: int, count: int) -> list:
    """``count`` distinct indices of ``range(n)`` drawn from the seed,
    sorted."""
    g = torch.Generator().manual_seed(run.sub_seed(k))
    return sorted(torch.randperm(n, generator=g)[:count].tolist())


def quantile(values, q: float) -> float:
    """The ``q``-quantile of ``values`` (Python's ``statistics``,
    ``n=100`` cut points, inclusive of the sample's range)."""
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return float(cuts[int(round(q * 100)) - 1])


def kernel_launches() -> int:
    """Launches of every hand-written kernel of the program so far (its
    ``CudaKernel`` counters)."""
    import sys
    from alphazero_tpu_torch.ops.build import CudaKernel
    seen, total = set(), 0
    for name, mod in list(sys.modules.items()):
        if not name.startswith("alphazero_tpu_torch.") or mod is None:
            continue
        for v in vars(mod).values():
            if isinstance(v, CudaKernel) and id(v) not in seen:
                seen.add(id(v))
                total += v.launches
    return total
