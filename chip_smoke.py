"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. build every CUDA source of the port with nvcc (in parallel) and print
     the card's name and power limit;
  2. the dense-forward kernel against its plain PyTorch version at B=512,
     width 512, 2 blocks, seeded random weights, observations from random
     playouts: error and time of both; then at B=512, 128 and the ragged
     1, 17, 129, and at phase 13a's 256 games a rank: error, launch geometry (CTAs, cluster, games per tile,
     shared memory, clusters the card holds), and the device time of the
     kernel and of the eager module (make_eval_fn): CUDA events around
     calls queued behind a sleep kernel (``device_ms``);
  3. the whole-chunk search kernels against the plain chunk, bit for bit,
     under the exact stub evaluator at B=512, S=200, M=4 with Dirichlet
     noise and temperature sampling (both fed the same noise and uniforms),
     empty boards and boards one move from a win mixed in; the same at
     B=256, the batch each rank of phase 13a plays;
  4. the main path: ``Trainer(preset("connect4")).collect`` at full width
     with the real forward kernel, launch counts set to 0 before and read
     after (the simulation kernels as the search graphs leave them,
     ``chunk_launches``), checks on the games it produced, env-steps/s
     over >= 3 chunks;
     and the device time of every kernel over one profiled chunk;
  5. each search kernel against its plain version on a snapshot of a
     main-path move, with times, and the launch geometry of the group
     kernels (az_root_init, the descent, the apply, az_move_tail,
     az_root_counts: lanes per game, games per CTA, CTAs) at self-play's
     batch and the gate's, as the kernels report it; the device time of
     az_root_init and az_move_tail at self-play's batch (``device_ms``;
     each tail on its own copy of the board; the tail with the next move's
     root observation, as the chunk runs every move but its last, and
     without); both kernels bit for bit on the case trees of the card-only
     tests (``root_trees``, ``tail_trees``; the tail with the next root
     and without) at connect4 and tictactoe, B=512;
  6. the move search (the gate's search, kernel 2) on the card against its
     plain version, bit for bit, under the exact stub evaluator at B=128,
     S=200 with Dirichlet noise fed to both and live, won and drawn games
     mixed; then az_move_root_init and az_root_counts each against its
     plain version on a main-path snapshot (real weights), with times,
     their device times at B=128 (``device_ms``) beside the launch floor
     (``torch.cuda._sleep(0)``) and their bounds, both bit for bit on the
     case trees of the card-only tests (``count_trees``, ``dirty_trees`` at
     N = 401 and 201) at connect4 B=128, and the forward kernel against its
     plain version at the gate's B=128 on every simulation of that search;
  7. the main path's whole outer iteration,
     ``Trainer(preset("connect4")).iterate(vanilla_eval=False)``: launch
     counts set to 0 before and read after, and measured per phase
     (collect, train, gate; the simulation kernels as the search graphs
     leave them, ``chunk_launches`` and ``move_search_launches``);
     seconds of
     collect, train and gate, checks on
     the gate's searches, the score, the loss and the promote/revert
     bookkeeping; then one gate move (both agents) profiled;
  8. the per-simulation engine (kernels 3 and 4, csrc/sim.cu, a group of
     lanes per game): the kernels' launch geometry (lanes per game, games
     per CTA, CTAs, edges a lane reads) at every batch and game below; the
     whole search on the card against its plain version, bit for bit,
     under the exact stub evaluator with Dirichlet noise fed to both and
     live, won and drawn roots mixed: connect4 at self-play's B=512 and
     the gate's B=128, S=200, tictactoe at B=256, S=50 and gomoku9 at
     B=256, S=400; then az_sim_step and az_sim_flush each against its
     plain version on a snapshot of a real-weights connect4-resnet search,
     with times and bounds; both on exact-stub trees at connect4's B=128,
     tictactoe's B=256, gomoku9's A=81 and gomoku15's A=225 (B=256,
     S=400): one step and one flush bitwise against their plain versions,
     their device times (``device_ms``, each call on its own copy of the
     snapshot) and bounds; one fused gomoku9 self-play move profiled; and
     one vanilla (rollout) search on the card;
  9. the second model family's outer iteration,
     ``Trainer(preset("connect4-resnet")).iterate(vanilla_eval=False)`` at
     full width: launch counts measured per phase (the dense kernels must
     show 0), seconds of collect, train and gate, env-steps/s, checks on the
     games, the gate's searches and the bookkeeping; then one self-play
     move and one gate move profiled;
 10. the fused ResNet tower (kernel 5, csrc/resnet_tower.cu) behind the
     port's CLI: ``AZ_FUSED_RESNET=1`` and ``cli.main(["train", "--preset",
     "connect4-resnet", "--iterations", "1", "--workdir",
     "build/smoke_cli"])`` in process at full width, launch counts set to 0
     before and measured per phase (the tower 200 x searches in collect and
     gate, the sim kernels 199 x searches, the dense kernels 0);
     metrics.jsonl, config.json, the checkpoint restored into a fresh
     trainer, ``eval --vs self --games 32`` and ``agent_move`` for a
     connect4 dense agent and a tictactoe ResNet; then the tower kernel
     against its plain version on the run's self-play snapshot (B=512 and
     B=128, and the ragged 1, 17, 129), at gomoku9 128x8, B=256, and at
     the leaf-batched 8 x 512, with launch geometry, times, the device time
     of kernel and eager forward (``device_ms``), and the bound; one
     self-play move profiled under the fused and the
     eager evaluator, and one gate move under the fused evaluator; one
     leaf-batched search (K=8) on the fused evaluator;
 11. the dense tower's searches off connect4: the forward kernel against
     its plain version at gomoku9-dense's width (512×2, A=81) at B=256,
     128 and the ragged 1, 17, 129 (with the device-time sweeps of phase
     2) and on a dense tictactoe tower; the chunk's kernels against the
     plain chunk, bit for bit, under the exact stub with Dirichlet noise
     and temperature sampling, at gomoku9 B=256, S=400, M=2 and tictactoe
     B=256, S=50, M=4, empty and near-win boards mixed in; the move search
     bitwise at gomoku9 B=128, S=400 with live, won and drawn roots;
     ``Trainer(preset("gomoku9-dense")).iterate(vanilla_eval=False)`` at
     full width, launch counts set to 0 before and measured per phase (as
     in phase 7), env-steps/s of its chunks, and checks on every move its
     chunks played
     (legal, the first in the centre, a winner exactly where a line was
     completed); each search kernel against its plain version on that
     path's snapshots (B=256 and the gate's B=128) with times, bounds, the
     group kernels' launch geometry, the root's and the tail's device time
     and their case trees at gomoku9 B=256, the move search's root init and
     counts (device times, case trees) at gomoku9 B=128; one chunk and one
     gate move profiled (az_root_counts must be in the gate move's path);
     the phase's seconds;
 12. the ViT family and the ``gomoku7-reference`` preset (gomoku 7x7, ViT
     512 x 1, patch 5, 8 heads, dropout 0.1, 100 sims, the reference PUCT
     formula, the gate off): the sim kernels' whole search bitwise against
     its plain version at B=256, S=100 (live, won and drawn roots,
     Dirichlet, exact stub) and one step and one flush at A=49 with device
     times and bounds; the ViT's plain forward on the card against the same
     forward on the CPU (float32 and bf16, ``TOL_VIT``) with its device
     time at B=256 and its bound; ``Trainer(preset("gomoku7-reference"))
     .iterate(vanilla_eval=False)`` at full width, launch counts set to 0
     before and measured per phase (az_sim_step 99 per move searched, the
     dense kernels and the tower 0), collect env-steps/s, train seconds and
     steps/s, and checks on every move it played (legal, the first in the
     centre, a winner exactly where a line was completed) and on the
     learner's dropout draws; one self-play move profiled (busy, idle, the
     ViT forward's and az_sim_step's shares of busy time); then
     ``expand_depth(2)`` on the card, one move on the deeper model, and a
     trainer built from the workdir's config.json restoring its checkpoint
     (the dropout generator included);
 13. multi-process training (``parallel/``, ``training/spmd_loop.py``) on
     the one card, each rank a process of its own whose output is captured
     (``build/smoke_mesh``) and joined before the result: (a)
     ``SpmdTrainer(preset("connect4")).iterate(vanilla_eval=False)`` at
     data=2, two gloo ranks of 256 games each: launches per rank and phase
     (the chunk kernels every chunk on both, the gate's on rank 0 only),
     each rank's first chunk bitwise against the single-process chunk on
     its games from the same generator state, the global counters against
     the sum over the ranks, the contender bitwise equal on both ranks
     after ``train_epoch``, one learner step's all-reduced gradients
     against one process's on the two half batches together
     (``TOL_GRAD``), the same gate score and decision on both ranks,
     collect / train / gate seconds and the time of one all-reduce of the
     gradients; (b) ``python -m alphazero_tpu_torch train --preset
     connect4 --mesh data=1 --iterations 1 --no-gate`` in a subprocess, one
     NCCL rank: its metrics, ``config.json`` and checkpoint; (c)
     ``gomoku7-reference`` at data=1, model=2, two gloo ranks: the split
     ViT's forward at B=256 against the replicated one (float32 and bf16,
     ``TOL_VIT``) with its time beside the replicated forward's, one loss's
     gradients against the replicated ones (``TOL_GRAD``), and one search
     on the sim kernels with the split forward, its trees bitwise equal
     across the model ranks.  Two ranks on one card are not a scaling
     measurement;
 14. train to strength (``strength.py``): the per-simulation engine's
     whole search bitwise against its plain version at tictactoe B=128,
     S=50 (the evaluations' half batch; live, won and drawn roots,
     Dirichlet, exact stub); then the ``validate_learning`` recipe at full
     preset width (ResNet 32x2, eager, S=50, 512 games an iteration, 6
     iterations, the gate off) with 256-game evaluations against
     vanilla-200: launch counts set to 0 before each collect, train
     epoch, gate and evaluation and read after each (az_sim_step S-1 per
     move searched, az_sim_flush one per search, the dense kernels and
     the tower 0), every vanilla search timed, and checks on the curve
     (finite losses, the last below the first, each score summing to the
     games, the verdict PASS under ``trained > max(0.5, untrained)``);
     it prints the curve, each iteration's collect and train seconds,
     each evaluation's seconds and the vanilla search's ms per move;
then the main-path summaries, one JSON line of all eleven kernels (each
with the games it was held at, the group kernels' geometry, the
``device_ms`` of the root, the tail and the move search's two ends (with
the launch floor), the eager dense forward's device time beside the dense
kernel, the gomoku9-dense path's launches, times and bounds under
``by_path``, the sim kernels' gomoku7-reference launches and times, and
the chunk and move kernels' rank-0 launches of phase 13a, and every
kernel's launches in phase 14 by phase), the phase-13 ``mesh_path`` and
phase-14 ``strength`` summaries, the card line, and the device JSON.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

TOL_FWD_MAX = 1e-2      # max |kernel - plain| on probs and value
TOL_FWD_FRAC = 0.99     # ... and this share of outputs within 1e-3
REPLACES = "alphazero_tpu/search/pallas_fused.py:805"        # _chunk_kernel
REPLACES_MOVE = "alphazero_tpu/search/pallas_fused.py:661"   # _move_kernel
REPLACES_SIM = {"az_sim_step": "alphazero_tpu/search/pallas_mcts.py:555",
                "az_sim_flush": "alphazero_tpu/search/pallas_mcts.py:685"}
REPLACES_TOWER = "alphazero_tpu/ops/pallas_resnet.py:76"        # _kernel


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate(kernel_fn, plain_fn, rounds=5, k_reps=20, p_reps=3):
    """Medians of kernel and plain times, measured in turns."""
    tk, tp = [], []
    for _ in range(rounds):
        tk.append(cuda_ms(kernel_fn, k_reps))
        tp.append(cuda_ms(plain_fn, p_reps))
    return statistics.median(tk), statistics.median(tp)


def bound(nbytes, bf16_ops=0.0, f32_ops=0.0):
    """``azbench.counts.bound_s`` in ms."""
    from azbench.counts import bound_s
    t, by = bound_s(nbytes, bf16_ops, f32_ops)
    return t * 1e3, by


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# kernel function names in csrc/ → the C entry that launches each (a name
# that holds another comes first)
KERNEL_FUNCS = {"resnet_tower_kernel": "az_resnet_tower",
                "sim_step_kernel": "az_sim_step",
                "sim_flush_kernel": "az_sim_flush",
                "move_root_init_kernel": "az_move_root_init",
                "root_counts_kernel": "az_root_counts",
                "descend_leaf_kernel": "az_descend_leaf",
                "move_tail_kernel": "az_move_tail",
                "root_init_kernel": "az_root_init",
                "root_obs_kernel": "az_root_obs",
                "dense_forward_kernel": "az_dense_forward",
                "apply_kernel": "az_apply"}


def device_profile(fn, names=False):
    """Device time of every kernel that ``fn`` launches, by torch.profiler
    (CUPTI): ``({entry: (launches, total µs)}, busy µs, span µs)``, with
    PyTorch's own kernels under "other" (under their own names, cut to 60
    characters, with ``names``); None when the trace holds no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # a failure of the profiler is reported and skipped, one of fn raises
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except RuntimeError as e:
        log(f"[profile] torch.profiler failed to start ({e})")
        return None
    stop_error = None
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except RuntimeError as e:
            stop_error = e
    if stop_error is not None:
        log(f"[profile] torch.profiler failed ({stop_error})")
        return None
    # a host span is mirrored on the device's timeline as an annotation (a
    # replayed CUDA graph's ``model.graph``): not an operation
    kev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not kev:
        return None
    per = {}
    for e in kev:
        us = e.time_range.end - e.time_range.start
        tag = next((v for k, v in KERNEL_FUNCS.items() if k in e.name),
                   e.name[:60] if names else "other")
        n, t = per.get(tag, (0, 0.0))
        per[tag] = (n + 1, t + us)
    span = (max(e.time_range.end for e in kev)
            - min(e.time_range.start for e in kev))
    return per, sum(t for _, t in per.values()), span


def random_positions(env, B, gen, dev):
    """B positions of random legal play, each stopped at its own length."""
    state = env.init(B, dev)
    target = torch.randint(0, 30, (B,), generator=gen, device=dev)
    for t in range(30):
        mask = env.valid_mask(state) & (t < target)[:, None]
        live = mask.any(-1)
        noise = torch.rand(mask.shape, generator=gen, device=dev)
        act = torch.where(mask, noise, -1.0).argmax(-1).to(torch.int32)
        nxt = env.step(state, act)
        for k in vars(state):
            old, new = getattr(state, k), getattr(nxt, k)
            sel = live.reshape((B,) + (1,) * (old.dim() - 1))
            setattr(state, k, torch.where(sel, new, old))
    return state


def with_drawn_game(state, env):
    """``state`` with its last game replaced by a drawn full board (no line
    for either player)."""
    from alphazero_tpu_torch.search.stub import drawn_board
    state.board[-1] = drawn_board(env).to(state.board.device)
    state.current_player[-1] = 0
    state.move_count[-1] = env.max_moves
    state.done[-1] = True
    state.winner[-1] = -1
    return state


def print_profile(tag, prof, wall_ms):
    """Print a device profile; returns {entry: device ms per launch}."""
    dev_ms = {}
    if prof is None:
        log(f"[profile] {tag}: torch.profiler recorded no device events: "
            "kernel device times not measured")
        return dev_ms
    per, busy, span = prof
    for name, (n, us) in sorted(per.items(), key=lambda x: -x[1][1]):
        log(f"[profile] {tag}: {name}: {n} launches, {us / 1e3:.2f} ms "
            f"device, {us / max(n, 1):.2f} us each, {us / busy:.1%} of busy "
            "time")
        if name != "other":
            dev_ms[name] = us / n / 1e3
    log(f"[profile] {tag}: device busy {busy / 1e3:.1f} ms, kernel span "
        f"{span / 1e3:.1f} ms; idle share vs the unprofiled wall time "
        f"({wall_ms:.1f} ms) {1 - busy / 1e3 / wall_ms:.3f}")
    return dev_ms


def fresh_ms(fn, states):
    """Mean ms per call of ``fn`` on each of ``states`` after the first
    (a warm-up), by CUDA events: every call starts from its own state."""
    fn(states[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in states[1:]:
        fn(s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(states) - 1)


def device_ms(runs):
    """Device time per call of each ``(name, fn, reps)`` of ``runs``: CUDA
    events around ``reps`` calls queued behind a sleep kernel.  The host
    issues every call while the card sleeps, so the calls run back to back
    and the events time the card's work, not the host's.  That holds only
    if the start event is still pending when the last call has been
    issued; the script checks it, retries with longer sleeps and, failing
    that, says so and gives None.  Returns ``{name: ms per call}``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    out = {}
    for name, fn, reps in runs:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        out[name] = None
        for attempt in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 2)
                                  * 4 ** attempt))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            ahead = not start.query()
            torch.cuda.synchronize()
            if ahead:
                out[name] = start.elapsed_time(end) / reps
                break
        if out[name] is None:
            log(f"[device] {name}: not measured (the card reached the "
                f"calls before the host had issued them, three times)")
    return out


@contextlib.contextmanager
def planned(module, name, plan):
    """Route a wrapper's launch planner ``module.name`` to ``plan`` for the
    enclosed calls: to time geometries the planner did not pick."""
    old = getattr(module, name)
    setattr(module, name, plan)
    try:
        yield
    finally:
        setattr(module, name, old)


def max_diff(a, b):
    """Largest ``|a - b|`` over the elements that differ (0 when equal)."""
    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.where(a == b, torch.zeros_like(d), d).max())


def compare(name, kern, plain, state, outputs, reps=50, preps=3,
            fresh=False):
    """Run kernel and plain version on clones of ``state`` (a dict of
    tensors and trees) and compare ``outputs`` bit for bit.  With
    ``fresh`` every timed call starts from its own clone of ``state`` (for
    a call that may not be repeated on its own output).  Returns the
    per-call ms of kernel and plain version and the largest difference,
    under the kernels line's keys."""
    def clone(s):
        return {k: (v.clone() if hasattr(v, "clone") else v)
                for k, v in s.items()}
    sk, sp_ = clone(state), clone(state)
    rk, rp = kern(sk), plain(sp_)
    torch.cuda.synchronize()
    diff, err = [], 0.0
    for get in outputs:
        a, b = get(sk, rk), get(sp_, rp)
        err = max(err, max_diff(a, b))
        if not torch.equal(a, b):
            diff.append(get.__doc__ or "?")
    if fresh:
        tk, tp = [], []
        for _ in range(3):
            tk.append(fresh_ms(kern, [clone(state) for _ in range(reps + 1)]))
            tp.append(fresh_ms(plain, [clone(state)
                                       for _ in range(preps + 1)]))
        ms_k, ms_p = statistics.median(tk), statistics.median(tp)
    else:
        ms_k, ms_p = alternate(lambda: kern(sk), lambda: plain(sp_),
                               k_reps=reps, p_reps=preps)
    log(f"[kernel] {name}: {'bitwise equal' if not diff else diff}; "
        f"per call: kernel wrapper {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    if diff:
        fail(f"{name} differs from its plain version in {diff}")
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=err)


def out(fn, doc):
    fn.__doc__ = doc
    return fn


def tree_clone(s):
    s = dict(s)
    s["tree"] = s["tree"].clone()
    return s


def counted_phases(obj, phases, kernels, split, graphs=None):
    """Wrap the methods ``phases`` of ``obj`` so that each stores the
    launches of ``kernels`` it made in ``split[phase]`` and, with
    ``graphs``, the search graphs' counters it moved (``graphs_since``) in
    ``graphs[phase]``."""
    def counts():
        return {k.name: k.launches for k in kernels}

    def wrap(phase, fn):
        def run(*a, **kw):
            before, graphs0 = counts(), graph_counts()
            r = fn(*a, **kw)
            split[phase] = {n: c - before[n] for n, c in counts().items()}
            if graphs is not None:
                graphs[phase] = graphs_since(graphs0)
            return r
        return run

    for phase in phases:
        setattr(obj, phase, wrap(phase, getattr(obj, phase)))
    return counts


def graph_counts():
    """The search graphs' counters (``fused.MOVE_GRAPHS``, the move
    search's and the chunk's), ``(captures, replays)``."""
    from alphazero_tpu_torch.search import fused
    return fused.MOVE_GRAPHS.captures, fused.MOVE_GRAPHS.replays


def graphs_since(before):
    """``(captures, replays)`` made since ``graph_counts()`` read
    ``before``."""
    return tuple(n - b for n, b in zip(graph_counts(), before))


def move_search_launches(searches, S, graphs):
    """Launches of the move search's kernels that ``searches`` searches on
    their own forward made while they made ``graphs`` = ``(captures,
    replays)``.  Each simulation kernel (descent, forward, apply): S-1 a
    search run eagerly, none a search that replayed a graph, and 2(S-1) a
    capture (its warm-up and the capture itself; the capturing search's
    own result is a replay).  The root init: one a search and one more a
    capture (the tree's reset after the warm-up); the root counts: one a
    search."""
    captures, replays = graphs
    chain = (searches - replays + 2 * captures) * (S - 1)
    return {"az_dense_forward": chain, "az_descend_leaf": chain,
            "az_apply": chain, "az_move_root_init": searches + captures,
            "az_root_counts": searches}


def chunk_launches(chunks, M, S, graphs):
    """Launches of the chunk's kernels that ``chunks`` chunks of M moves on
    their own forward made while they made ``graphs`` = ``(captures,
    replays)``, a replay a move.  The descent and the apply: S-1 a move run
    eagerly, none a move that replayed a graph, and 2(S-1) a capture (as
    in :func:`move_search_launches`); the forward the same plus one a move
    (the root's).  The root init: one a move and one more a capture; the
    first root observation one a chunk and the tail one a move."""
    captures, replays = graphs
    moves = chunks * M
    chain = (moves - replays + 2 * captures) * (S - 1)
    return {"az_dense_forward": chain + moves, "az_root_obs": chunks,
            "az_root_init": moves + captures, "az_descend_leaf": chain,
            "az_apply": chain, "az_move_tail": moves,
            "az_move_root_init": 0, "az_root_counts": 0}


def forward_by_batch(env, model, params, packed, batches, sweep, gen, dev):
    """The forward kernel against its plain version at each batch of
    ``batches`` (observations of random play): error, launch geometry and
    the device time of the kernel and of the eager module (models/dense.py
    through make_eval_fn), both by device_ms; at the batches of ``sweep``
    also the other tiles and the launch with fewer blocks.  Fails on a
    disagreement; returns ``{batch: summary}``."""
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.search import fused
    eager_dense = make_eval_fn(model, params)
    by_batch = {}
    for Bx in batches:
        ox = env.observation(random_positions(env, Bx, gen, dev))
        flat = ox.reshape(Bx, -1).contiguous()
        pk, vk = fused.dense_forward(flat, packed)
        pp, vp = fused.dense_forward_reference(flat, packed)
        torch.cuda.synchronize()
        err = torch.cat([(pk - pp).abs().reshape(-1), (vk - vp).abs()])
        e_max, share = float(err.max()), float((err <= 1e-3).float().mean())
        ok = (bool(torch.isfinite(err).all()) and e_max <= TOL_FWD_MAX
              and share >= TOL_FWD_FRAC)
        geo = fused.dense_geometry(Bx, packed)
        # device times: the kernel, the eager module; at the main path's
        # batches also the other tiles and the launch with 0 and 1 of the 2
        # blocks (the fixed cost: input, stem, final LayerNorm, heads; and
        # the cost per block)
        runs = [("kernel", lambda: fused.dense_forward(flat, packed), 20),
                ("eager", lambda: eager_dense(ox), 5)]
        if Bx in sweep:
            for tg in fused.dense_tiles(*fused._dense_widths(packed)):
                def run_tile(tg=tg):
                    with planned(fused, "dense_plan",
                                 lambda *a: {"games_per_tile": tg}):
                        fused.dense_forward(flat, packed)

                runs.append((f"tile {tg}", run_tile, 10))
            for nb_cut in range(model.blocks):
                cut = dict(packed, **{k: packed[k][:nb_cut].contiguous()
                                      for k in ("ln_s", "ln_b", "w1", "b1",
                                                "w2", "b2")})
                runs.append((f"blocks {nb_cut}",
                             lambda cut=cut: fused.dense_forward(flat, cut),
                             10))
        dev_t = device_ms(runs)

        def kern(name):
            return None if dev_t[name] is None else dev_t[name] * 1e3

        k_us, e_dev = kern("kernel"), dev_t["eager"]
        alts = {int(n[5:]): kern(n) for n, _, _ in runs
                if n.startswith("tile ")}
        depth = {int(n[7:]): kern(n) for n, _, _ in runs
                 if n.startswith("blocks ")}
        if depth:
            depth[model.blocks] = k_us
        log(f"[forward] {env.name} B={Bx}: max abs err {e_max:.3e}, share within 1e-3 "
            f"{share:.4f} -> {'ok' if ok else 'FAIL'}; geometry {geo}; "
            f"device per launch {k_us} us; eager module device "
            f"{e_dev} ms per call; device us per launch by games per tile "
            f"{alts}, by blocks {depth}")
        if not ok:
            fail(f"forward kernel disagrees with its plain version at B={Bx}")
        by_batch[str(Bx)] = dict(max_abs_err=e_max, share_within_1e3=share,
                                 device_us=k_us, eager_device_ms=e_dev,
                                 geometry=geo, device_us_by_tile=alts,
                                 device_us_by_blocks=depth)
    return by_batch


def card_tests():
    """The card-only test module, tests/test_torch_cuda.py, loaded by its
    path: a "tests" package installed elsewhere would shadow the
    repository's tests/ directory."""
    spec = importlib.util.spec_from_file_location(
        "card_tests", Path(__file__).resolve().parent / "tests"
        / "test_torch_cuda.py")
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)
    return t


def count_init_cases(games, B, dev):
    """az_root_counts and az_move_root_init, one launch each, bit for bit
    against their plain versions at B games of each of ``games`` on the
    case trees of the card-only tests (tests/test_torch_cuda.py:
    count_trees; dirty_trees at N = 401 and 201), each case checked for
    what it holds."""
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.search import fused
    t = card_tests()
    for game in games:
        env = make_env(game)
        bad = []
        tree = t.count_trees(env, B, 41, dev)
        got = fused.root_counts(tree)
        want = fused.root_counts_reference(tree)
        bad += [f"az_root_counts {n}" for n, x, y in zip(
            ("counts", "policy", "root_q"), got, want)
            if not torch.equal(x, y)]
        try:
            t.check_count_cases(env, *want)
        except AssertionError as e:
            bad.append(f"count case {e}")
        for S in (400, 200):
            tree, prior, value, live = t.dirty_trees(env, B, S, 42, dev)
            tk, tp = tree.clone(), tree.clone()
            fused.move_root_init(tk, prior, value, live)
            fused.move_root_init_reference(tp, prior, value, live)
            bad += [f"az_move_root_init N={S + 1} {f}" for f in (
                "visit", "val", "child", "prior")
                if not torch.equal(getattr(tk, f), getattr(tp, f))]
            try:
                t.check_dirty_init(tp, tree, prior, value, live)
            except AssertionError as e:
                bad.append(f"dirty tree N={S + 1} {e}")
        log(f"[counts/init cases] {game} B={B}: az_root_counts on "
            f"count_trees, az_move_root_init on dirty_trees (N = 401, 201): "
            f"{'bitwise equal, every case holds' if not bad else bad}")
        if bad:
            fail(f"az_root_counts / az_move_root_init at {game} B={B}: "
                 f"{bad}")


def root_tail_cases(games, B, dev):
    """az_root_init and az_move_tail, one launch each, bit for bit against
    their plain versions at B games of each of ``games`` on the case trees
    of the card-only tests (tests/test_torch_cuda.py: root_trees with and
    without noise, tail_trees), each case checked for what it holds."""
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.search import fused
    t = card_tests()
    for game in games:
        env = make_env(game)
        bad = []
        cfg, tree, probs, value, noise, board = t.root_trees(env, B, 31, dev)
        for noise_m in (noise, None):
            tk, tp = tree.clone(), tree.clone()
            fused.root_init(env, cfg, tk, probs, value, noise_m, board)
            fused.root_init_reference(env, cfg, tp, probs, value, noise_m,
                                      board)
            bad += [f"az_root_init {f}" for f in ("visit", "val", "child",
                                                  "prior")
                    if not torch.equal(getattr(tk, f), getattr(tp, f))]
        try:
            t.check_root_cases(env, tp, tree, value)
        except AssertionError as e:
            bad.append(f"root case {e}")
        cfg, tree, u, board, player, mc = t.tail_trees(env, B, 32, dev)
        got, want = [(board.clone(), player.clone(), mc.clone(),
                      t.tail_records(B, env.action_dim, dev))
                     for _ in range(2)]
        fused.move_tail(env, cfg, tree, u, *got)
        fused.move_tail_reference(env, cfg, tree, u, *want)
        bad += [f"az_move_tail {n}" for n, x, y in zip(
            ("board", "player", "mc"), got, want) if not torch.equal(x, y)]
        bad += [f"az_move_tail rec.{n}" for n in want[3]
                if not torch.equal(got[3][n], want[3][n])]
        try:
            t.check_tail_cases(env, board, *want)
        except AssertionError as e:
            bad.append(f"tail case {e}")
        # the tail that writes the next move's root observation
        got, want = [t.tail_with_next_root(tail, env, cfg, tree, u, board,
                                           player, mc)
                     for tail in (fused.move_tail, fused.move_tail_reference)]
        try:
            t.next_root_equal(got, want)
            t.check_tail_cases(env, board, *want[0])
        except AssertionError as e:
            bad.append(f"az_move_tail with the next root: {e}")
        log(f"[root/tail cases] {game} B={B}: az_root_init (with noise and "
            f"without) and az_move_tail (with the next root and without) on "
            f"root_trees / tail_trees: "
            f"{'bitwise equal, every case holds' if not bad else bad}")
        if bad:
            fail(f"az_root_init / az_move_tail at {game} B={B}: {bad}")


def chunk_kernels_phase(env, mcfg, tr, gen, dev, case_games):
    """Each search kernel of the chunk against its plain version on a
    snapshot of the trainer's self-play state (a main-path move of the
    trainer's game), with times and bounds, the device time of
    az_root_init and az_move_tail (the tail with the next move's root
    observation and without), the group kernels' launch geometry, and the
    root and tail on the case trees of ``case_games`` (at the chunk's
    batch): ``{kernel: summary}``."""
    from alphazero_tpu_torch.search import fused
    summary = {}
    S = mcfg.num_simulations
    A, RC, F = env.action_dim, env.rows * env.cols, env.feature_dim
    B = tr.sp.env_state.board.shape[0]
    tree_fields = ("visit", "val", "child", "prior")
    sp = tr.sp
    board = sp.env_state.board.clone()
    player = sp.env_state.current_player.clone()
    mc = sp.env_state.move_count.clone()
    N, dcap = S + 1, int(min(env.max_moves + 1, S + 1))
    tree = fused.Tree(env, B, S, dev)
    rec_obs = torch.zeros((B, F, env.rows, env.cols), dtype=torch.int8,
                          device=dev)
    packed = fused.pack_dense_params(tr.model, tr.params_best, dev)
    noise_m = fused.dirichlet_noise(1, A, B, mcfg.dirichlet_alpha, gen, dev)[0]
    u = torch.rand((B,), generator=gen, device=dev)

    # root observation and tree init at the start of the move
    base = {"board": board, "player": player, "rec": rec_obs}
    ms = compare("az_root_obs",
                 lambda s: fused.root_obs(env, s["board"], s["player"], s["rec"]),
                 lambda s: fused.root_obs_reference(env, s["board"], s["player"],
                                                    s["rec"]),
                 base, [out(lambda s, r: r, "obs"),
                        out(lambda s, r: s["rec"], "rec_obs")])
    b_ms, b_by = bound(nbytes(board, player) + B * F * RC * 5)
    summary["az_root_obs"] = dict(**ms, bound_ms=b_ms,
                                  bound_by=b_by)
    # the launch geometry of the group kernels (root init, descent, apply,
    # tail, the move search's root counts) at the chunk's batch and the
    # gate's, as the kernels' library reports it
    geometry = {str(Bx): fused.search_kernel_geometry(Bx, A)
                for Bx in (B, tr.cfg.train.gate_games // 2)}
    for Bx, g in geometry.items():
        log(f"  az_root_init / az_descend_leaf / az_apply / az_move_tail / "
            f"az_root_counts geometry, {env.name} A={A} B={Bx}: "
            f"{g['lanes_per_game']} lanes "
            f"per game, {g['games_per_cta']} games per CTA, {g['ctas']} CTAs "
            f"of {g['threads_per_cta']} threads")
    root_tail_cases(case_games, B, dev)
    obs0 = fused.root_obs(env, board, player, rec_obs)
    probs0, value0 = fused.dense_forward(obs0, packed)
    state = {"tree": tree, "probs": probs0, "value": value0, "noise": noise_m,
             "board": board}

    ms = compare("az_root_init",
                 lambda s: fused.root_init(env, mcfg, s["tree"], s["probs"],
                                           s["value"], s["noise"], s["board"]),
                 lambda s: fused.root_init_reference(
                     env, mcfg, s["tree"], s["probs"], s["value"], s["noise"],
                     s["board"]),
                 tree_clone(state),
                 [out(lambda s, r, f=f: getattr(s["tree"], f), f)
                  for f in tree_fields])
    b_ms, b_by = bound(nbytes(probs0, value0, noise_m, board)
                       + 2 * B * N * 4 + B * A * 8, f32_ops=4.0 * B * A)
    # idempotent: every call writes the same root on the same tree
    r_dev = device_ms([("az_root_init", lambda: fused.root_init(
        env, mcfg, tree, probs0, value0, noise_m, board), 200)])
    summary["az_root_init"] = dict(**ms, bound_ms=b_ms, bound_by=b_by,
                                   device_ms=r_dev["az_root_init"],
                                   geometry=geometry)
    fused.root_init(env, mcfg, tree, probs0, value0, noise_m, board)
    half = S // 2
    for slot in range(1, half):
        fused.descend_leaf(env, mcfg, tree, board, player, mc, slot)
        p, v = fused.dense_forward(tree.obs, packed)
        fused.apply(tree, slot, p, v)
    # descend at slot S/2
    dstate = {"tree": tree, "board": board, "player": player, "mc": mc}
    ms = compare("az_descend_leaf",
                 lambda s: fused.descend_leaf(env, mcfg, s["tree"], s["board"],
                                              s["player"], s["mc"], half),
                 lambda s: fused.descend_leaf_reference(
                     env, mcfg, s["tree"], s["board"], s["player"], s["mc"],
                     half),
                 tree_clone(dstate),
                 [out(lambda s, r, f=f: getattr(s["tree"], f), f)
                  for f in ("path", "apath", "pend", "valid", "obs")],
                 preps=2)
    fused.descend_leaf(env, mcfg, tree, board, player, mc, half)
    depth = tree.pend[:, fused.P_DEPTH].long()
    steps = int(depth.sum())
    path_nodes = tree.path.long().clamp(max=N - 1)
    on_path = torch.arange(dcap, device=dev)[None] < depth[:, None]
    kids = (tree.child[torch.arange(B, device=dev)[:, None], path_nodes] >= 0
            ).sum(-1)
    n_kids = int(kids[on_path].sum())
    d_bytes = (steps * A * 8 + n_kids * 8 + nbytes(board, player, mc)
               + 2 * B * dcap * 4 + B * 28 + B * A + B * F * RC * 4)
    b_ms, b_by = bound(d_bytes, f32_ops=steps * A * 8.0)
    summary["az_descend_leaf"] = dict(**ms, bound_ms=b_ms,
                                      bound_by=b_by, geometry=geometry)
    log(f"  descend at slot {half}: {steps} walk steps over {B} games "
        f"(deepest {int(depth.max())}), {n_kids} child reads")
    p, v = fused.dense_forward(tree.obs, packed)
    ms = compare("az_apply",
                 lambda s: fused.apply(s["tree"], half, s["p"], s["v"]),
                 lambda s: fused.apply_reference(s["tree"], half, s["p"], s["v"]),
                 tree_clone({"tree": tree, "p": p, "v": v}),
                 [out(lambda s, r, f=f: getattr(s["tree"], f), f)
                  for f in tree_fields], preps=2)
    plies = int((depth + 1).sum())
    a_bytes = (nbytes(p, v, tree.pend, tree.valid) + plies * (4 + 16)
               + B * A * 8 + B * 4)
    b_ms, b_by = bound(a_bytes, f32_ops=2.0 * plies)
    summary["az_apply"] = dict(**ms, bound_ms=b_ms,
                               bound_by=b_by, geometry=geometry)
    fused.apply(tree, half, p, v)
    for slot in range(half + 1, S):
        fused.descend_leaf(env, mcfg, tree, board, player, mc, slot)
        p, v = fused.dense_forward(tree.obs, packed)
        fused.apply(tree, slot, p, v)
    rec = {"policy": torch.zeros((B, A), device=dev)}
    for k in ("player", "t", "action", "winner"):
        rec[k] = torch.zeros((B,), dtype=torch.int32, device=dev)
    rec["done"] = torch.zeros((B,), dtype=torch.bool, device=dev)
    rec["root_q"] = torch.zeros((B,), device=dev)
    rec_next = torch.zeros((B, F, env.rows, env.cols), dtype=torch.int8,
                           device=dev)
    tstate = {"tree": tree, "u": u, "board": board, "player": player,
              "mc": mc, "rec_next": rec_next,
              **{f"rec_{k}": v for k, v in rec.items()}}

    def recs(s):
        return {k: s[f"rec_{k}"] for k in rec}

    # the tail of every move but the chunk's last: it also writes the next
    # move's root observation and its record
    ms = compare("az_move_tail",
                 lambda s: fused.move_tail(env, mcfg, s["tree"], s["u"],
                                           s["board"], s["player"], s["mc"],
                                           recs(s), s["rec_next"]),
                 lambda s: fused.move_tail_reference(
                     env, mcfg, s["tree"], s["u"], s["board"], s["player"],
                     s["mc"], recs(s), s["rec_next"]),
                 tree_clone(tstate),
                 [out(lambda s, r, k=k: s[k], k) for k in
                  ("board", "player", "mc")]
                 + [out(lambda s, r, k=k: s[f"rec_{k}"], f"rec_{k}")
                    for k in rec]
                 + [out(lambda s, r: r, "obs_next"),
                    out(lambda s, r: s["rec_next"], "rec_obs_next")])
    t_bytes = (B * A * 4 * 2 + B * 8 * 2 + nbytes(u) + 2 * nbytes(board)
               + 4 * B * 4 + B * (A * 4 + 5 * 4 + 1) + B * F * RC * 5)
    b_ms, b_by = bound(t_bytes, f32_ops=4.0 * B * A)

    def on_copies(*tail_args):
        """A tail on its own copy of the board, player and move count per
        call: the tail steps them."""
        pool = iter([(board.clone(), player.clone(), mc.clone())
                     for _ in range(1 + 4 * 200)])
        return lambda: fused.move_tail(env, mcfg, tree, u, *next(pool), rec,
                                       *tail_args)

    t_dev = device_ms([("az_move_tail", on_copies(rec_next), 200),
                       ("last move", on_copies(), 200)])
    summary["az_move_tail"] = dict(**ms, bound_ms=b_ms, bound_by=b_by,
                                   device_ms=t_dev["az_move_tail"],
                                   geometry=geometry)
    us = {k: "not measured" if t is None else f"{t * 1e3:.2f} us"
          for k, t in (("root", r_dev["az_root_init"]),
                       ("tail", t_dev["az_move_tail"]),
                       ("last", t_dev["last move"]))}
    log(f"  device time at B={B} (device_ms): az_root_init {us['root']}, "
        f"az_move_tail {us['tail']} with the next root, {us['last']} "
        f"without (the chunk's last move) per launch")
    torch.cuda.synchronize()
    return summary


def move_kernels_phase(env, mcfg, model, params, margs, noise, dev,
                       case_games):
    """az_move_root_init and az_root_counts against their plain versions on
    a move search of the roots ``margs`` (boards, players, move counts,
    dones) with ``model``'s weights, their device times (``device_ms``) at
    that batch beside the launch floor (``torch.cuda._sleep(0)``) and
    their bounds, both on the case trees of ``case_games`` at that batch,
    and the forward kernel against its plain version on every simulation
    of that search: ``({kernel: summary}, the forward's max abs err)``."""
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.search import fused
    from alphazero_tpu_torch.search.mcts import root_prior
    summary = {}
    Bg, S, A = margs[0].shape[0], mcfg.num_simulations, env.action_dim
    N = S + 1
    tree_fields = ("visit", "val", "child", "prior")
    packed = fused.pack_dense_params(model, params, dev)
    root_fn = make_eval_fn(model, params)
    use6 = torch.ones(Bg, dtype=torch.bool, device=dev)
    rp, v0, live6 = root_prior(env, mcfg, root_fn, *margs, use6, noise)
    tree6 = fused.Tree(env, Bg, S, dev)
    ms = compare("az_move_root_init",
                 lambda s: fused.move_root_init(s["tree"], s["rp"], s["v"],
                                                s["live"]),
                 lambda s: fused.move_root_init_reference(
                     s["tree"], s["rp"], s["v"], s["live"]),
                 tree_clone({"tree": tree6, "rp": rp, "v": v0,
                             "live": live6}),
                 [out(lambda s, r, f=f: getattr(s["tree"], f), f)
                  for f in tree_fields])
    b_ms, b_by = bound(nbytes(rp, v0, live6) + 2 * Bg * N * 4 + Bg * A * 8,
                       f32_ops=4.0 * Bg * A)
    # idempotent: every call writes the same root on the same tree
    i_dev = device_ms([("az_move_root_init", lambda: fused.move_root_init(
        tree6, rp, v0, live6), 200), ("launch floor", lambda:
                                       torch.cuda._sleep(0), 200)])
    summary["az_move_root_init"] = dict(
        **ms, bound_ms=b_ms, bound_by=b_by,
        device_ms=i_dev["az_move_root_init"],
        launch_floor_ms=i_dev["launch floor"])
    count_init_cases(case_games, Bg, dev)
    # the search with the real forward kernel, held against its plain
    # version at the gate's shape on every simulation
    fwd_err = []

    def checked_forward(o):
        pk, vk = fused.dense_forward(o, packed)
        pp, vp = fused.dense_forward_reference(o, packed)
        if not (torch.isfinite(pk).all() and torch.isfinite(vk).all()):
            fail(f"forward kernel at B={Bg}: non-finite output")
        fwd_err.append(torch.cat([(pk - pp).abs().reshape(-1),
                                  (vk - vp).abs()]))
        return pk, vk

    tree6 = fused._move_tree(fused.DISPATCH, env, mcfg, root_fn, *margs,
                             use6, noise, checked_forward)
    err = torch.cat(fwd_err)
    err_b128 = float(err.max())
    frac = float((err <= 1e-3).float().mean())
    ok = err_b128 <= TOL_FWD_MAX and frac >= TOL_FWD_FRAC
    log(f"[forward] B={Bg}, the {len(fwd_err)} simulations of a move search: "
        f"max abs err {err_b128:.3e} (tol {TOL_FWD_MAX}), share within 1e-3 "
        f"{frac:.4f} (tol {TOL_FWD_FRAC}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"forward kernel disagrees with its plain version at B={Bg}")
    ms = compare("az_root_counts", lambda s: fused.root_counts(s["tree"]),
                 lambda s: fused.root_counts_reference(s["tree"]),
                 tree_clone({"tree": tree6}),
                 [out(lambda s, r, i=i: r[i], name) for i, name in
                  enumerate(("counts", "policy", "root_q"))])
    n_kids = int((tree6.child[:, 0] >= 0).sum())
    b_c, c_by = bound(Bg * A * 4 + n_kids * 4 + Bg * 8 + Bg * A * 8
                      + Bg * 4, f32_ops=float(Bg * A + Bg))
    # it only reads the tree
    c_dev = device_ms([("az_root_counts", lambda: fused.root_counts(tree6),
                        200)])["az_root_counts"]
    summary["az_root_counts"] = dict(
        **ms, bound_ms=b_c, bound_by=c_by, device_ms=c_dev,
        geometry={str(Bg): fused.search_kernel_geometry(Bg, A)})
    us = {k: "not measured" if t is None else f"{t * 1e3:.2f} us"
          for k, t in (("init", i_dev["az_move_root_init"]),
                       ("counts", c_dev), ("floor", i_dev["launch floor"]))}
    log(f"  device time at B={Bg} (device_ms): az_move_root_init "
        f"{us['init']} (bound {b_ms * 1e3:.3f} us), az_root_counts "
        f"{us['counts']} (bound {b_c * 1e3:.4f} us) per launch; launch "
        f"floor (torch.cuda._sleep(0)) {us['floor']}")

    return summary, err_b128


def sim_search_bitwise(pname, B, gen, dev, drawn_tictactoe=False):
    """The per-simulation engine's whole search on the card against its
    plain version, bit for bit, at preset ``pname``'s game and search with
    B games: the exact stub evaluator, Dirichlet noise fed to both, live
    roots, a drawn one (not tictactoe) and, at gomoku, won ones (put in by
    hand: random play rarely completes a line of five).  Tictactoe's
    random positions hold drawn games of their own; ``drawn_tictactoe``
    puts one in all the same.  Fails on a difference; returns the largest
    difference (0)."""
    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.search.stub import exact_stub_evaluator
    pc = preset(pname)
    env, mcfg = make_env(pc.env), pc.mcts
    S, A = mcfg.num_simulations, env.action_dim
    st = random_positions(env, B, gen, dev)
    if env.name != "tictactoe" or drawn_tictactoe:
        st = with_drawn_game(st, env)
    if env.name.startswith("gomoku"):
        st = won_roots(env, st, slice(B // 2, B // 2 + min(8, B // 4)))
    roots = (st.board, st.current_player, st.move_count, st.done)
    won = st.done & (st.winner >= 0)
    drawn = st.done & (st.winner < 0)
    noise = fused.dirichlet_noise(1, A, B, mcfg.dirichlet_alpha, gen,
                                  dev)[0].T.contiguous()
    stub = exact_stub_evaluator(env)
    ev = lambda o: stub(o.reshape(o.shape[0], -1))  # noqa: E731
    t0 = time.perf_counter()
    got = sim.run_mcts_sim(env, ev, *roots, mcfg, noise=noise, device=dev)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = sim.sim_search_reference(env, ev, *roots, mcfg, noise=noise)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    fields = ("visit_counts", "policy", "root_q")
    bad = [k for k in fields
           if not torch.equal(getattr(got, k), getattr(want, k))]
    err = max(max_diff(getattr(got, k), getattr(want, k)) for k in fields)
    sums = got.visit_counts.sum(-1)
    log(f"[sim search] {pname} B={B} S={S} {mcfg.formula} formula, "
        f"Dirichlet, exact stub, {int((~st.done).sum())} live / "
        f"{int(won.sum())} won / {int(drawn.sum())} drawn roots: mismatched "
        f"{bad or 'none'}; kernel search {t_kern:.2f} s, plain search "
        f"{t_plain:.2f} s")
    if bad:
        fail(f"per-simulation kernels differ from the plain search in "
             f"{bad} ({env.name})")
    checks = {
        "live roots count S-1 visits": bool((sums[~st.done]
                                             == S - 1).all()),
        "finished roots count none": bool((sums[st.done] == 0).all()),
        "won roots: root Q (S-1)/S": bool(won.any()) and bool(
            (got.root_q[won] == torch.tensor((S - 1) / S,
                                             device=dev)).all()),
        "drawn roots: root Q 0": bool(drawn.any()) and bool(
            (got.root_q[drawn] == 0).all()),
    }
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail(f"per-simulation search checks failed ({env.name})")
    return err


def sim_phase(gen, dev):
    """Phase 8: the per-simulation engine on the card against its plain
    version, bit for bit, at every batch the main path gives it;
    az_sim_step / az_sim_flush on a real-weights
    snapshot with times and bounds; one vanilla search."""
    from alphazero_tpu_torch.config import MCTSConfig, preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.search.mcts import expand_root, run_mcts
    from alphazero_tpu_torch.search.tree import init_tree

    summary = {}
    search_err = 0.0
    c4 = preset("connect4-resnet")
    # the kernels' launch geometry (a group of lanes per game) at every
    # batch and game the searches below give them
    geometry = {}
    for pname, B in (("connect4-resnet", c4.train.selfplay_batch),
                     ("connect4-resnet", c4.train.gate_games // 2),
                     ("tictactoe", 256), ("gomoku9", 256), ("gomoku15", 256)):
        A = make_env(preset(pname).env).action_dim
        geo = sim.sim_kernel_geometry(B, A)
        geometry[f"{pname} B={B}"] = geo
        log(f"[sim geometry] {pname} B={B} A={A}: {geo['lanes_per_game']} "
            f"lanes per game, {geo['games_per_cta']} games per CTA, "
            f"{geo['ctas']} CTAs of {geo['threads_per_cta']} threads, "
            f"{geo['edges_per_lane']} edges a lane per walk step")
    # self-play's batch and the gate's (each agent's half), tictactoe, and
    # gomoku9's self-play at its S=400
    for pname, B in (("connect4-resnet", c4.train.selfplay_batch),
                     ("connect4-resnet", c4.train.gate_games // 2),
                     ("tictactoe", preset("tictactoe").train.selfplay_batch),
                     ("gomoku9", preset("gomoku9").train.selfplay_batch)):
        search_err = max(search_err, sim_search_bitwise(pname, B, gen, dev))

    # az_sim_step / az_sim_flush on a snapshot of a real-weights
    # connect4-resnet search at slot S/2
    pc = preset("connect4-resnet")
    env, mcfg = make_env(pc.env), pc.mcts
    B, S, A = pc.train.selfplay_batch, mcfg.num_simulations, env.action_dim
    model = build_model(pc.model, env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    ev = make_eval_fn(model, params)
    st = random_positions(env, B, gen, dev)
    noise = fused.dirichlet_noise(1, A, B, mcfg.dirichlet_alpha, gen,
                                  dev)[0].T.contiguous()
    tree = init_tree(env, st.board, st.current_player, st.move_count, S)
    expand_root(env, mcfg, tree, ev, st.done,
                torch.ones(B, dtype=torch.bool, device=dev), noise, None)
    ss = sim.SimState.create(env, B, S, dev)
    p = torch.zeros((B, A), device=dev)
    v = torch.zeros((B,), device=dev)
    half = S // 2

    def forward(o):
        pr, va = ev(o)
        return pr.float().contiguous(), va.float().contiguous()

    for slot in range(1, half):
        sim.sim_step(env, mcfg, tree, ss, p, v, slot - 1, slot)
        p, v = forward(ss.obs)
    tree_f = ("stats", "prior", "children")
    st_f = ("path", "apath", "meta", "valid", "obs")
    outs = ([out(lambda s, r, f=f: getattr(s["tree"], f), f) for f in tree_f]
            + [out(lambda s, r, f=f: getattr(s["st"], f), f) for f in st_f])
    state = {"tree": tree, "st": ss, "p": p, "v": v}
    ms = compare("az_sim_step",
                 lambda s: sim.sim_step(env, mcfg, s["tree"], s["st"], s["p"],
                                        s["v"], half - 1, half),
                 lambda s: sim.sim_step_reference(
                     env, mcfg, s["tree"], s["st"], s["p"], s["v"],
                     half - 1, half),
                 state, outs, reps=30, preps=2, fresh=True)
    b_ms, b_by, depth = sim_step_bound(sim, env, mcfg, tree, ss, p, v,
                                       half)
    summary["az_sim_step"] = dict(**ms, bound_ms=b_ms, bound_by=b_by)
    p, v = forward(ss.obs)
    ms = compare("az_sim_flush",
                 lambda s: sim.flush(env, s["tree"], s["st"], s["p"], s["v"],
                                     half),
                 lambda s: sim.flush_reference(s["tree"], s["st"], s["p"],
                                               s["v"], half),
                 {"tree": tree, "st": ss, "p": p, "v": v},
                 [out(lambda s, r, f=f: getattr(s["tree"], f), f)
                  for f in tree_f], reps=30, preps=2, fresh=True)
    b_ms, b_by = sim_flush_bound(B, A, depth)
    summary["az_sim_flush"] = dict(**ms, bound_ms=b_ms, bound_by=b_by)
    for name in ("az_sim_step", "az_sim_flush"):
        summary[name]["geometry"] = geometry
    # one step and one flush on exact-stub trees at the gate's connect4
    # batch, tictactoe, gomoku9's A=81 and gomoku15's A=225
    for name in ("az_sim_step", "az_sim_flush"):
        summary[name]["by_cell"] = {}
    for pname, B in (("connect4-resnet", c4.train.gate_games // 2),
                     ("tictactoe", 256), ("gomoku9", 256), ("gomoku15", 256)):
        step, flush = sim_step_at(pname, B, gen, dev)
        summary["az_sim_step"]["by_cell"][f"{pname} B={B}"] = step
        summary["az_sim_flush"]["by_cell"][f"{pname} B={B}"] = flush
    # the searches above held both kernels against the plain search too
    for name in ("az_sim_step", "az_sim_flush"):
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                           search_err)
    summary["az_sim_step"]["gomoku9_fused_move"] = gomoku9_move_profile(dev)

    # vanilla (rollout) search on the card
    env = make_env("tictactoe")
    Bv, Sv = 8, 16
    st = env.init(Bv, dev)
    res = run_mcts(env, None, st.board, st.current_player, st.move_count,
                   st.done, MCTSConfig(num_simulations=Sv, use_dirichlet=False),
                   generator=gen, device=dev)
    ok = (res.visit_counts.device.type == "cuda"
          and bool((res.visit_counts.sum(-1) == Sv - 1).all()))
    log(f"[vanilla search] tictactoe B={Bv} S={Sv} on {res.visit_counts.device}: "
        f"counts sum to S-1 -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("vanilla search on the card")
    return summary


def sim_step_bound(sim, env, mcfg, tree, ss, p, v, slot):
    """Run ``az_sim_step`` (flush of ``slot - 1``, descent of ``slot``) on
    ``tree``/``ss`` and return its bound from this step's data (the plies
    flushed, the walk's steps and child reads) and the walk's depths:
    ``(bound ms, bound by, depth (B,))``."""
    B, N, A = tree.prior.shape
    RC, F = env.rows * env.cols, env.feature_dim
    prev_plies = int((ss.meta[:, sim.M_DEPTH].long() + 1).sum())
    sim.sim_step(env, mcfg, tree, ss, p, v, slot - 1, slot)
    depth = ss.meta[:, sim.M_DEPTH].long()
    steps = int(depth.sum())
    dcap = ss.path.shape[1]
    nodes = ss.path.long().clamp(max=N - 1)
    on_path = torch.arange(dcap, device=depth.device)[None] < depth[:, None]
    kids = (tree.children[torch.arange(B, device=depth.device)[:, None],
                          nodes] >= 0).sum(-1)
    n_kids = int(kids[on_path].sum())
    flush_bytes = (B * A * 4 + B * 4 + B * 32 + B * A + prev_plies * 4
                   + prev_plies * 24 + B * A * 4 + B * 4)
    step_bytes = (flush_bytes + nbytes(tree.root_board, tree.root_player,
                                       tree.root_move_count)
                  + steps * A * 8 + n_kids * 12 + 2 * B * dcap * 4 + B * 32
                  + B * A + B * F * RC * 4)
    b_ms, b_by = bound(step_bytes, f32_ops=steps * A * 8.0 + 2 * prev_plies)
    log(f"  sim step at slot {slot}, {env.name} B={B}: {steps} walk steps "
        f"(deepest {int(depth.max())}), {n_kids} child reads, flush of "
        f"{prev_plies} plies; bound {b_ms:.6f} ms ({b_by})")
    return b_ms, b_by, depth


def gomoku9_move_profile(dev):
    """One self-play move of the ``gomoku9`` preset (ResNet 128×8, B=256,
    S=400, random weights from seed 0) on the fused tower, wall time and
    device profile.  Returns its summary."""
    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.data import create
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    from alphazero_tpu_torch.training.selfplay import (init_selfplay,
                                                       selfplay_step)
    cfg = preset("gomoku9")
    env = make_env(cfg.env)
    model = build_model(cfg.model, env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    ev = make_eval_fn(model, params, fused_resnet=True)
    B = cfg.train.selfplay_batch
    sp = [init_selfplay(env, B, 1, dev), create(env, cfg.replay.capacity,
                                                dev)]

    def move():
        sp[0], sp[1] = selfplay_step(env, ev, cfg.mcts, sp[0], sp[1])

    move()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    move()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof = device_profile(move)
    dev_ms = print_profile(f"one gomoku9 self-play move, fused evaluator "
                           f"(B={B}, S={cfg.mcts.num_simulations})", prof,
                           wall)
    return dict(wall_ms=wall, busy_ms=prof[1] / 1e3 if prof else None,
                idle_share=1 - prof[1] / 1e3 / wall if prof else None,
                dev_ms=dev_ms,
                launches={k: n for k, (n, _) in prof[0].items()}
                if prof else None)


def sim_flush_bound(B, A, depth):
    """Bound of ``az_sim_flush`` of walks of ``depth (B,)``: the meta row,
    legal mask, probs and value read, the new prior row written, the path
    read and each ply's three stats read and written, two additions per
    ply.  ``(bound ms, bound by)``."""
    plies = int((depth + 1).sum())
    return bound(B * A * 4 + B * 4 + B * 32 + B * A + plies * 4
                 + plies * 24 + B * A * 4 + B * 4, f32_ops=2.0 * plies)


def sim_step_at(pname, B, gen, dev):
    """az_sim_step and az_sim_flush at a preset's action count and search
    with B games (gomoku9: A=81, gomoku15: A=225, both S=400): a tree of
    S/2 simulations under the exact stub, one step held
    bitwise against its plain version, then the device time of the step
    and of the flush after it by device_ms with every call on its own copy
    of the snapshot (neither may be repeated on its own output), and their
    bounds.  Returns the step's and the flush's summaries."""
    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.search.mcts import expand_root
    from alphazero_tpu_torch.search.stub import exact_stub_evaluator
    from alphazero_tpu_torch.search.tree import init_tree
    pc = preset(pname)
    env, mcfg = make_env(pc.env), pc.mcts
    S, A = mcfg.num_simulations, env.action_dim
    stub = exact_stub_evaluator(env)
    ev = lambda o: stub(o.reshape(o.shape[0], -1))  # noqa: E731
    st = random_positions(env, B, gen, dev)
    noise = fused.dirichlet_noise(1, A, B, mcfg.dirichlet_alpha, gen,
                                  dev)[0].T.contiguous()
    tree = init_tree(env, st.board, st.current_player, st.move_count, S)
    expand_root(env, mcfg, tree, ev, st.done,
                torch.ones(B, dtype=torch.bool, device=dev), noise, None)
    ss = sim.SimState.create(env, B, S, dev)
    p = torch.zeros((B, A), device=dev)
    v = torch.zeros((B,), device=dev)
    half = S // 2
    for slot in range(1, half):
        sim.sim_step(env, mcfg, tree, ss, p, v, slot - 1, slot)
        p, v = ev(ss.obs)
    tp, sp = tree.clone(), ss.clone()
    sim.sim_step_reference(env, mcfg, tp, sp, p, v, half - 1, half)
    reps = 10

    def timed(name, fn):
        pool = iter([(tree.clone(), ss.clone()) for _ in range(1 + 4 * reps)])
        return device_ms([(name, lambda: fn(*next(pool)), reps)])[name]

    s_ms = timed("az_sim_step", lambda t, s_: sim.sim_step(
        env, mcfg, t, s_, p, v, half - 1, half))
    b_ms, b_by, depth = sim_step_bound(sim, env, mcfg, tree, ss, p, v, half)
    bad = [f for f in ("stats", "prior", "children")
           if not torch.equal(getattr(tree, f), getattr(tp, f))]
    bad += [f for f in ("path", "apath", "meta", "valid", "obs")
            if not torch.equal(getattr(ss, f), getattr(sp, f))]
    p, v = ev(ss.obs)
    f_ms = timed("az_sim_flush", lambda t, s_: sim.flush(env, t, s_, p, v,
                                                         half))
    fb_ms, fb_by = sim_flush_bound(B, A, depth)
    sim.flush(env, tree, ss, p, v, half)
    sim.flush_reference(tp, sp, p, v, half)
    bad += [f"flush {f}" for f in ("stats", "prior", "children")
            if not torch.equal(getattr(tree, f), getattr(tp, f))]
    us = {k: "not measured" if t is None else f"{t * 1e3:.2f} us"
          for k, t in (("step", s_ms), ("flush", f_ms))}
    log(f"[sim kernels at A={A}] {pname} B={B} S={S}, slot {half} of an "
        f"exact-stub search: {'bitwise equal' if not bad else bad} to the "
        f"plain versions; az_sim_step {us['step']} per launch (device_ms, "
        f"each call on its own copy), bound {b_ms * 1e3:.3f} us ({b_by}); "
        f"az_sim_flush {us['flush']}, bound {fb_ms * 1e3:.3f} us ({fb_by})")
    if bad:
        fail(f"the sim kernels differ from their plain versions at {pname} "
             f"in {bad}")
    geo = sim.sim_kernel_geometry(B, A)
    return (dict(batch=B, num_simulations=S, device_ms=s_ms, bound_ms=b_ms,
                 bound_by=b_by, geometry=geo),
            dict(batch=B, num_simulations=S, device_ms=f_ms, bound_ms=fb_ms,
                 bound_by=fb_by, geometry=geo))


def resnet_iterate_phase(gen, dev):
    """Phase 9: ``Trainer(preset("connect4-resnet")).iterate(
    vanilla_eval=False)`` with launches per phase, then one self-play move
    and one gate move profiled.  Returns (launch split, iterate result,
    device ms per launch of the move and of the gate move, walls)."""
    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.eval import arena
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops import resnet_tower
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.search.mcts import run_mcts
    from alphazero_tpu_torch.training import Trainer
    from alphazero_tpu_torch.training.selfplay import selfplay_step
    from alphazero_tpu_torch.utils.metrics import MetricsLogger

    cfg = preset("connect4-resnet")
    tr = Trainer(cfg, device="cuda", logger=MetricsLogger(stdout=False))
    env, mcfg = tr.env, cfg.mcts
    S, B = mcfg.num_simulations, cfg.train.selfplay_batch
    log(f"[resnet iterate] model {type(tr.model).__name__} channels "
        f"{tr.model.channels} blocks {tr.model.blocks}, {S} sims, B={B}, "
        f"{cfg.train.gate_games} gate games")
    init = {k: v.clone() for k, v in tr.params_best.items()}
    kernels = fused.KERNELS + sim.KERNELS + resnet_tower.KERNELS
    split, trace = {}, []
    counts = counted_phases(tr, ("collect", "train_epoch", "gate"), kernels,
                            split)

    def traced_run_mcts(env_, eval_fn, boards, players, mcs, dones, cfg_,
                        **kw):
        res = run_mcts(env_, eval_fn, boards, players, mcs, dones, cfg_, **kw)
        trace.append((dones, res.visit_counts))
        return res

    arena.run_mcts = traced_run_mcts
    for k in kernels:
        k.launches = 0
    try:
        it = tr.iterate(vanilla_eval=False)
    finally:
        arena.run_mcts = run_mcts
    total = counts()
    M = cfg.train.selfplay_chunk_steps or 32
    moves = len(it["chunk_seconds"]) * M
    searches = 2 * env.max_moves
    expect = {
        "collect": {"az_sim_step": moves * (S - 1), "az_sim_flush": moves},
        "train_epoch": {},
        "gate": {"az_sim_step": searches * (S - 1),
                 "az_sim_flush": searches}}
    log(f"[resnet iterate] launches {total}; measured per phase {split}")
    for phase, want in expect.items():
        got = split.get(phase)
        full = {k.name: want.get(k.name, 0) for k in kernels}
        if got != full:
            fail(f"{phase} launches {got} != expected {full} (the dense "
                 "kernels and the fused tower must show 0)")
    if any(sum(split[ph][n] for ph in split) != total[n] for n in total):
        fail("the per-phase launch counts do not add up to the total")
    log(f"[resnet iterate] collect {it['collect_seconds']:.3f} s "
        f"({len(it['chunk_seconds'])} chunks of {M} moves, {it['games']} "
        f"games, {it['env_steps']} env-steps, {it['env_steps_per_s']:.1f} "
        f"env-steps/s); train {it['train_seconds']:.3f} s ({it['steps']} "
        f"steps of batch {cfg.train.batch_size}, "
        f"{it['steps'] / it['train_seconds']:.1f} steps/s, loss "
        f"{it['loss']:.4f}); gate {it['gate_seconds']:.3f} s "
        f"({env.max_moves} moves, score {tr.last_gate_score}, rate "
        f"{it['gate_rate']}, accepted {it['accepted']})")

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    if it["accepted"]:
        kept = (tr.version == 1 and same(tr.params_best, tr.params_new)
                and not same(tr.params_best, init))
    else:
        kept = (tr.version == 0 and same(tr.params_new, init)
                and same(tr.params_best, init))
    size = int(tr.buffer.size)
    lens = tr.buffer.length[:size].long()
    rows = torch.arange(env.max_moves, device=dev)[None] < lens[:, None]
    pol = tr.buffer.policy[:size]
    obs_b = tr.buffer.obs[:size].long()
    stones = obs_b[:, :, :2].sum(dim=(2, 3, 4))
    counts_b = pol * (S - 1)
    checks = {
        "buffer holds the finished games": size == min(
            it["games"], tr.buffer.capacity) and size > 0,
        "game lengths 7..42": bool(((lens >= 7) & (lens <= 42)).all()),
        "policies sum to 1": bool(((pol.sum(-1) - 1).abs()
                                   <= 1e-6)[rows].all()),
        "root counts sum to S-1": bool(
            ((counts_b - counts_b.round()).abs() <= 1e-3)[rows].all()
            and (counts_b.round().sum(-1) == S - 1)[rows].all()),
        "one stone per move": bool(
            (stones == torch.arange(env.max_moves, device=dev)[None])[rows]
            .all()),
        "gate score sums to the game count": sum(
            tr.last_gate_score[:2]) == cfg.train.gate_games,
        "every gate search recorded": len(trace) == searches,
        "gate: live roots count S-1, finished none": all(
            bool((c.sum(-1)[~d] == S - 1).all())
            and bool((c.sum(-1)[d] == 0).all()) for d, c in trace),
        "train steps = buffer rows // batch": it["steps"] == max(
            it["buffer_size"] // cfg.train.batch_size, 1),
        "finite losses": all(math.isfinite(it[k]) for k in (
            "loss", "policy_loss", "value_loss", "l2")),
        "promote/revert bookkeeping": kept,
    }
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail("connect4-resnet iteration checks failed")

    # one self-play move (B games) and one gate move (2 x B/2), profiled
    ev = make_eval_fn(tr.model, tr.params_best)

    def sp_move():
        tr.sp, tr.buffer = selfplay_step(env, ev, mcfg, tr.sp, tr.buffer)

    sp_move()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp_move()
    torch.cuda.synchronize()
    sp_wall = (time.perf_counter() - t0) * 1e3
    sp_ms = print_profile(f"one connect4-resnet self-play move (B={B})",
                          device_profile(sp_move), sp_wall)
    Bg = cfg.train.gate_games // 2
    st = random_positions(env, cfg.train.gate_games, gen, dev)
    agents = (make_eval_fn(tr.model, tr.params_best),
              make_eval_fn(tr.model, tr.params_new))

    def gate_move():
        for fn, sl in zip(agents, (slice(0, Bg), slice(Bg, None))):
            run_mcts(env, fn, st.board[sl], st.current_player[sl],
                     st.move_count[sl], st.done[sl], mcfg, generator=gen,
                     device=dev)

    gate_move()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gate_move()
    torch.cuda.synchronize()
    gate_wall = (time.perf_counter() - t0) * 1e3
    gate_ms = print_profile(f"one connect4-resnet gate move (2 x B={Bg})",
                            device_profile(gate_move), gate_wall)
    return split, total, it, sp_ms, gate_ms, sp_wall, gate_wall


# (max, median) of |kernel - plain| over logits and value, per tower: bf16
# reads of float32 sums taken in another order round the other way near a
# bf16 boundary, more often the deeper the tower (the card gave 2.9e-3 /
# 3e-7 at 64×4 and 1.2e-2 / 1.1e-3 at 128×8 on random weights)
TOL_TOWER = {"connect4-resnet": (2e-2, 1e-5), "gomoku9": (5e-2, 5e-3)}


def states_equal(a, b):
    """Nested dicts of tensors, equal name for name and bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(states_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def fused_resnet_phase(gen, dev):
    """Phase 10: the fused ResNet tower (kernel 5) behind the port's CLI.
    b. ``AZ_FUSED_RESNET=1`` and ``cli.main(["train", "--preset",
    "connect4-resnet", "--iterations", "1", ...])`` in process, launches
    counted per phase; metrics.jsonl, config.json and the checkpoint
    restored into a fresh trainer; ``eval --vs self``; ``agent_move`` for a
    connect4 dense agent (B=1) and a tictactoe ResNet.  a. the tower kernel
    against its plain version on the run's self-play snapshot (B=512 and
    B=128) and at gomoku9's 128×8, B=256, with times and bounds.  c. one
    self-play move profiled under the fused and the eager evaluator.  d. one
    leaf-batched search (K=8, B=512) on the fused evaluator.  c also
    profiles one gate move (2 x B=128) on the fused evaluator."""
    import contextlib
    import dataclasses
    import io
    import os
    import shutil

    from alphazero_tpu_torch import cli
    from alphazero_tpu_torch.config import preset, to_json
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.eval import arena
    from alphazero_tpu_torch.eval.play import agent_move
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    from alphazero_tpu_torch.ops import resnet_tower as rt
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.search.mcts import run_mcts
    from alphazero_tpu_torch.training import Trainer
    from alphazero_tpu_torch.training.selfplay import selfplay_step
    from alphazero_tpu_torch.utils.metrics import MetricsLogger

    cfg = preset("connect4-resnet")
    mcfg = cfg.mcts
    S, B = mcfg.num_simulations, cfg.train.selfplay_batch
    kernels = fused.KERNELS + sim.KERNELS + rt.KERNELS

    def counts():
        return {k.name: k.launches for k in kernels}

    # ---- b. the user's command, in process
    wd = "build/smoke_cli"
    shutil.rmtree(wd, ignore_errors=True)
    split, gate_trace = {}, []
    methods = {ph: getattr(Trainer, ph)
               for ph in ("collect", "train_epoch", "gate")}

    def wrap(phase, fn):
        def run(self, *a, **kw):
            before = counts()
            r = fn(self, *a, **kw)
            split[phase] = {n: c - before[n] for n, c in counts().items()}
            return r
        return run

    def traced_run_mcts(env_, eval_fn, boards, players, mcs, dones, cfg_,
                        **kw):
        res = run_mcts(env_, eval_fn, boards, players, mcs, dones, cfg_, **kw)
        gate_trace.append((dones, res.visit_counts))
        return res

    argv = ["train", "--preset", "connect4-resnet", "--iterations", "1",
            "--workdir", wd]
    os.environ["AZ_FUSED_RESNET"] = "1"
    for ph, fn in methods.items():
        setattr(Trainer, ph, wrap(ph, fn))
    arena.run_mcts = traced_run_mcts
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            tr = cli.main(argv)
    finally:
        for ph, fn in methods.items():
            setattr(Trainer, ph, fn)
        arena.run_mcts = run_mcts
    t_cli = time.perf_counter() - t0
    total = counts()
    env = tr.env
    with open(f"{wd}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    kinds = [r["kind"] for r in recs]
    it = recs[-1]
    M = cfg.train.selfplay_chunk_steps or 32
    moves = len(it["chunk_seconds"]) * M
    gsearch = 2 * env.max_moves
    expect = {
        "collect": {"az_resnet_tower": moves * S,
                    "az_sim_step": moves * (S - 1), "az_sim_flush": moves},
        "train_epoch": {},
        "gate": {"az_resnet_tower": gsearch * S,
                 "az_sim_step": gsearch * (S - 1), "az_sim_flush": gsearch}}
    log(f"[fused cli] AZ_FUSED_RESNET=1 python -m alphazero_tpu_torch "
        f"{' '.join(argv)}: {t_cli:.1f} s; launches {total}; measured per "
        f"phase {split}")
    for phase, want in expect.items():
        full = {k.name: want.get(k.name, 0) for k in kernels}
        if split.get(phase) != full:
            fail(f"fused cli {phase} launches {split.get(phase)} != expected "
                 f"{full} (the dense kernels must show 0)")
    if any(sum(split[ph][n] for ph in split) != total[n] for n in total):
        fail("the per-phase launch counts do not add up to the total")
    log(f"[fused cli] collect {it['collect_seconds']:.3f} s "
        f"({len(it['chunk_seconds'])} chunks of {M} moves, {it['games']} "
        f"games, {it['env_steps']} env-steps, {it['env_steps_per_s']:.1f} "
        f"env-steps/s); train {it['train_seconds']:.3f} s ({it['steps']} "
        f"steps, loss {it['loss']:.4f}); gate {it['gate_seconds']:.3f} s "
        f"(score {tr.last_gate_score}, rate {it['gate_rate']}, accepted "
        f"{it['accepted']})")

    # the checkpoint: the run's own at a promotion, else saved here
    if it["accepted"]:
        case = "promoted: the run saved its checkpoint at version 1"
    else:
        tr.save_checkpoint()
        case = "rejected: this phase saved the trainer's state at version 0"
    fresh = Trainer(tr.cfg, device="cuda", workdir=wd, persist_config=False,
                    logger=MetricsLogger(stdout=False), fused_resnet=True)
    restored = fresh.restore_checkpoint()
    log(f"[fused cli] checkpoint: {case}")
    with open(f"{wd}/config.json") as f:
        cfg_text = f.read()
    checks = {
        "metrics.jsonl holds collect, train, gate, iteration":
            kinds == ["collect", "train", "gate", "iteration"],
        "config.json equals to_json(preset)": cfg_text == to_json(cfg),
        "the tower launched in collect and in gate": (
            split["collect"]["az_resnet_tower"] > 0
            and split["gate"]["az_resnet_tower"] > 0),
        "a fresh Trainer restores equal state": restored and states_equal(
            tr._state(), fresh._state()),
        "gate score sums to the game count": sum(
            tr.last_gate_score[:2]) == cfg.train.gate_games,
        "gate: every search recorded, live roots S-1, finished none": (
            len(gate_trace) == gsearch and all(
                bool((c.sum(-1)[~d] == S - 1).all())
                and bool((c.sum(-1)[d] == 0).all()) for d, c in gate_trace)),
        "finite losses": all(math.isfinite(it[k]) for k in (
            "loss", "policy_loss", "value_loss", "l2")),
    }

    # eval --vs self on the run's checkpoint, through the CLI
    n0 = rt.K_TOWER.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = cli.main(["eval", "--preset", "connect4-resnet", "--workdir",
                        wd, "--vs", "self", "--games", "32"])
    t_eval = time.perf_counter() - t0
    del os.environ["AZ_FUSED_RESNET"]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    eval_launches = rt.K_TOWER.launches - n0
    log(f"[fused cli] eval --vs self --games 32: {line} in {t_eval:.1f} s, "
        f"{eval_launches} tower launches")
    checks["eval prints its line, 32 games scored"] = (
        line == res and line["games"] == 32 and sum(line["score"][:2]) == 32)
    checks["eval searched on the tower: 2 x 42 searches x S"] = (
        eval_launches == gsearch * S)

    # agent_move: a connect4 dense agent (the move search at B=1) and a
    # tictactoe ResNet (the per-simulation engine)
    for name, kname in (("connect4", "az_move_root_init"),
                        ("tictactoe", "az_sim_flush")):
        pc = preset(name)
        e = make_env(pc.env)
        m = build_model(pc.model, e).to(dev)
        p = {k: v.to(dev) for k, v in init_params(
            m, torch.Generator().manual_seed(0)).items()}
        st = e.init(1, dev)
        before = counts()
        a = agent_move(e, make_eval_fn(m, p), st, gen,
                       dataclasses.replace(pc.mcts, use_dirichlet=False),
                       verbose=False)
        ran = counts()[kname] - before[kname]
        log(f"[agent_move] {name} ({pc.model.family}, B=1): action {a}, "
            f"{kname} launched {ran}")
        checks[f"agent_move {name}: a legal action on the card"] = (
            bool(e.valid_mask(st)[0, a]) and ran == 1)

    # ---- a. the tower kernel against its plain version
    summary = {}
    snap = env.observation(tr.sp.env_state).contiguous()
    pk = rt.pack(tr.params_best, cfg.model.blocks)
    g9 = preset("gomoku9")
    env9 = make_env(g9.env)
    model9 = build_model(g9.model, env9).to(dev)
    params9 = {k: v.to(dev) for k, v in init_params(
        model9, torch.Generator().manual_seed(0)).items()}
    st9 = random_positions(env9, g9.train.selfplay_batch, gen, dev)
    # self-play's B, the gate's, gomoku9's, and the leaf-batched K·B of
    # part d (K=8)
    lb_pos = random_positions(env, 8 * B, torch.Generator(
        device=dev).manual_seed(8 * B), dev)
    cases = [("connect4-resnet", snap, pk, tr.model, tr.params_best),
             ("connect4-resnet", snap[:cfg.train.gate_games // 2].contiguous(),
              pk, tr.model, tr.params_best),
             ("gomoku9", env9.observation(st9).contiguous(),
              rt.pack(params9, g9.model.blocks), model9, params9),
             ("connect4-resnet", env.observation(lb_pos).contiguous(), pk,
              tr.model, tr.params_best)]
    ragged = [("connect4-resnet", snap[:n].contiguous(), pk, tr.model,
               tr.params_best) for n in (1, 17, 129)]
    tower = {}
    for pname, x, packed, model, params in ragged:
        Bx, F, R, Cc = x.shape
        lk, vk = rt.heads(rt.resnet_tower(x, packed), packed)
        lp, vp = rt.heads(rt.tower_reference(x, packed), packed)
        torch.cuda.synchronize()
        err = torch.cat([(lk - lp).abs().reshape(-1), (vk - vp).abs()])
        e_max, e_med = float(err.max()), float(err.median())
        t_max, t_med = TOL_TOWER[pname]
        ok = bool(torch.isfinite(err).all()) and e_max <= t_max \
            and e_med <= t_med
        geo = rt.geometry(Bx, R * Cc, model.channels)
        log(f"[tower] {pname} B={Bx} (ragged): max err {e_max:.3e}, median "
            f"{e_med:.3e} -> {'ok' if ok else 'FAIL'}; geometry {geo}")
        if not ok:
            fail(f"az_resnet_tower disagrees with its plain version "
                 f"({pname} B={Bx})")
        tower[f"{pname} B={Bx}"] = dict(max_abs_err=e_max,
                                        median_abs_err=e_med, geometry=geo)
    for pname, x, packed, model, params in cases:
        Bx, F, R, Cc = x.shape
        RC, C, nb = R * Cc, model.channels, model.blocks
        fk = rt.resnet_tower(x, packed)
        fp = rt.tower_reference(x, packed)
        lk, vk = rt.heads(fk, packed)
        lp, vp = rt.heads(fp, packed)
        torch.cuda.synchronize()
        err = torch.cat([(lk - lp).abs().reshape(-1), (vk - vp).abs()])
        e_max, e_med = float(err.max()), float(err.median())
        f_max = float((fk - fp).abs().max())
        t_max, t_med = TOL_TOWER[pname]
        ok = (bool(torch.isfinite(fk).all()) and e_max <= t_max
              and e_med <= t_med)
        ms_k, ms_p = alternate(lambda: rt.resnet_tower(x, packed),
                               lambda: rt.tower_reference(x, packed),
                               k_reps=20, p_reps=3)
        eager = make_eval_fn(model, params)
        ms_e = cuda_ms(lambda: eager(x), 5)
        geo = rt.geometry(Bx, RC, C)
        # device times: the kernel, the eager forward, and the planner's
        # choice against other rings and tiles that fit; at connect4's K·B
        # also what the planner took before it preferred whole-conv stages
        # beyond one wave (the most games per CTA: 10, on single taps)
        runs = [("kernel", lambda: rt.resnet_tower(x, packed), 10),
                ("eager", lambda: eager(x), 3)]
        alts = [dict(geo, games=games, taps_per_stage=tps, stages=stages)
                for games in sorted({geo["games"], max(1, geo["games"] // 2)})
                for tps, stages in ((9, 2), (3, 3), (1, 2))]
        if pname == "connect4-resnet" and Bx == 8 * B:
            alts.append(dict(geo, games=10, mt=2, taps_per_stage=1, stages=3))
        for alt in alts:
            if rt.smem_bytes(alt["games"], RC, C, alt["mt"], alt["stages"],
                             alt["taps_per_stage"]) > rt.SMEM_LIMIT:
                continue

            def run_alt(alt=alt):
                with planned(rt, "plan", lambda *a: alt):
                    rt.resnet_tower(x, packed)

            runs.append((f"games={alt['games']} mt={alt['mt']} "
                         f"taps/stage={alt['taps_per_stage']} "
                         f"stages={alt['stages']}", run_alt, 5))
        dev_t = device_ms(runs)
        k_us = None if dev_t["kernel"] is None else dev_t["kernel"] * 1e3
        e_dev = dev_t["eager"]
        alts = {name: None if dev_t[name] is None else dev_t[name] * 1e3
                for name, _, _ in runs[2:]}
        ops = 2.0 * Bx * RC * (9 * F * C + nb * 2 * 9 * C * C)
        moved = (nbytes(x) + 2 * (9 * F * C + nb * 2 * 9 * C * C)
                 + nbytes(packed["lns"]) + Bx * RC * C * 4)
        b_ms, b_by = bound(moved, bf16_ops=ops)
        tag = f"{pname} {C}x{nb} B={Bx}"
        log(f"[tower] {tag}: logits+value max err {e_max:.3e} (tol {t_max}), "
            f"median {e_med:.3e} (tol {t_med}), tower output max err "
            f"{f_max:.3e} -> {'ok' if ok else 'FAIL'}; per call: kernel "
            f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, eager F.conv2d forward "
            f"(make_eval_fn) {ms_e:.4f} ms; bound {b_ms:.5f} ms ({b_by}, "
            f"{ops / 1e9:.3f} GFLOP bf16); device: kernel {k_us} us per "
            f"launch, eager forward {e_dev} ms per call; geometry {geo}; "
            f"device us per launch of the alternatives {alts}")
        if not ok:
            fail(f"az_resnet_tower disagrees with its plain version ({tag})")
        tower[tag] = dict(max_abs_err=e_max, median_abs_err=e_med, ms=ms_k,
                          plain_ms=ms_p, eager_forward_ms=ms_e, bound_ms=b_ms,
                          bound_by=b_by, device_us=k_us,
                          eager_device_ms=e_dev, geometry=geo,
                          device_us_by_geometry=alts)

    # ---- c. one self-play move, fused and eager evaluator, profiled
    mcfg_sp = cfg.mcts
    moves_prof = {}
    for tag, fused_on in (("fused", True), ("eager", False)):
        ev = make_eval_fn(tr.model, tr.params_best, fused_resnet=fused_on)

        def sp_move(ev=ev):
            tr.sp, tr.buffer = selfplay_step(env, ev, mcfg_sp, tr.sp,
                                             tr.buffer)

        sp_move()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp_move()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof = device_profile(sp_move)
        dev_ms = print_profile(f"one self-play move, {tag} evaluator "
                               f"(B={B})", prof, wall)
        fwd = device_profile(lambda ev=ev: ev(snap))
        per_fwd = sum(n for n, _ in fwd[0].values()) if fwd else None
        log(f"[profile] {tag} evaluator: {per_fwd} device launches per "
            f"forward at B={B}")
        moves_prof[tag] = dict(
            wall_ms=wall, busy_ms=prof[1] / 1e3 if prof else None,
            idle_share=1 - prof[1] / 1e3 / wall if prof else None,
            launches_per_forward=per_fwd, dev_ms=dev_ms)

    # one gate move (2 x B=128) on the fused evaluator, profiled
    Bg = cfg.train.gate_games // 2
    stg = random_positions(env, cfg.train.gate_games, gen, dev)
    agents = (make_eval_fn(tr.model, tr.params_best, fused_resnet=True),
              make_eval_fn(tr.model, tr.params_new, fused_resnet=True))

    def gate_move():
        for fn, sl in zip(agents, (slice(0, Bg), slice(Bg, None))):
            run_mcts(env, fn, stg.board[sl], stg.current_player[sl],
                     stg.move_count[sl], stg.done[sl], mcfg, generator=gen,
                     device=dev)

    gate_move()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gate_move()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof = device_profile(gate_move)
    gate_ms = print_profile(f"one gate move, fused evaluator (2 x B={Bg})",
                            prof, wall)
    moves_prof["gate_fused"] = dict(
        wall_ms=wall, busy_ms=prof[1] / 1e3 if prof else None,
        idle_share=1 - prof[1] / 1e3 / wall if prof else None,
        dev_ms=gate_ms)

    # ---- d. one leaf-batched search, K=8, on the fused evaluator
    K = 8
    s = tr.sp.env_state
    ev = make_eval_fn(tr.model, tr.params_best, fused_resnet=True)
    n0 = rt.K_TOWER.launches
    t0 = time.perf_counter()
    res = run_mcts(env, ev, s.board, s.current_player, s.move_count, s.done,
                   dataclasses.replace(mcfg, leaf_batch=K), generator=gen,
                   device=dev)
    torch.cuda.synchronize()
    t_lb = time.perf_counter() - t0
    lb_launches = rt.K_TOWER.launches - n0
    sums = res.visit_counts.sum(-1)
    log(f"[leaf batch] K={K} B={B} S={S} on the fused evaluator: "
        f"{lb_launches} tower launches (of {K * B} games each after the "
        f"root), {t_lb:.2f} s")
    checks[f"leaf batch: 1 + ceil({S - 1}/{K}) tower launches"] = (
        lb_launches == 1 + -(-(S - 1) // K))
    checks["leaf batch: live roots S-1 visits, finished none"] = (
        bool((sums[~s.done] == S - 1).all())
        and bool((sums[s.done] == 0).all()))
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail("fused ResNet phase checks failed")

    b512 = tower[f"connect4-resnet {cfg.model.channels}x{cfg.model.blocks} "
                 f"B={B}"]
    summary["az_resnet_tower"] = dict(
        max_abs_err=max(t["max_abs_err"] for t in tower.values()),
        ms=moves_prof["fused"]["dev_ms"].get("az_resnet_tower"),
        gate_ms=moves_prof["gate_fused"]["dev_ms"].get("az_resnet_tower"),
        call_ms=b512["ms"], plain_ms=b512["plain_ms"],
        bound_ms=b512["bound_ms"], bound_by=b512["bound_by"],
        eager_forward_ms=b512["eager_forward_ms"], by_shape=tower)
    path = {"preset": "connect4-resnet", "argv": argv, "cli_seconds": t_cli,
            "iterate": {k: it[k] for k in (
                "collect_seconds", "train_seconds", "gate_seconds", "steps",
                "games", "env_steps", "env_steps_per_s", "loss", "gate_rate",
                "accepted", "chunk_seconds")},
            "launches_by_phase": split, "checkpoint": case,
            "eval": line, "eval_seconds": t_eval,
            "moves": {k: {n: v for n, v in m.items() if n != "dev_ms"}
                      for k, m in moves_prof.items()},
            "leaf_batch": {"K": K, "seconds": t_lb,
                           "tower_launches": lb_launches}}
    return summary, split, total, path


def near_win(env, dev):
    """A board where player 0, to move, completes a line with one stone:
    ``(board, move count, (row, col) of the winning stone)``.  connect4
    player 0's three on the bottom row, player 1's three on top of them;
    tictactoe X X . / O O . / . . .; gomoku four stones of player 0 on the
    middle row, player 1's four on the row below, not in a line."""
    R = env.rows
    b = torch.zeros((2, R, env.cols), dtype=torch.int8)
    if env.name == "connect4":
        b[0, R - 1, :3] = 1
        b[1, R - 2, :3] = 1
        return b.to(dev), 6, (R - 1, 3)
    if env.name == "tictactoe":
        b[0, 0, :2] = 1
        b[1, 1, :2] = 1
        return b.to(dev), 4, (0, 2)
    b[0, R // 2, 1:5] = 1
    b[1, R // 2 + 1, [0, 2, 4, 6]] = 1
    return b.to(dev), 8, (R // 2, 5)


def chunk_roots(env, B, gen, dev):
    """Chunk roots for any game: random play (finished games reset to an
    empty board), every fourth game an empty board with player 0 to move
    (gomoku's centre rule) and every fourth one move from a win
    (:func:`near_win`)."""
    st = random_positions(env, B, gen, dev)
    board = torch.where(st.done[:, None, None, None], 0, st.board)
    player = torch.where(st.done, 0, st.current_player)
    mc = torch.where(st.done, 0, st.move_count)
    board[0::4], player[0::4], mc[0::4] = 0, 0, 0
    nw, nw_mc, _ = near_win(env, dev)
    board[1::4], player[1::4], mc[1::4] = nw, 0, nw_mc
    return board.contiguous(), player.contiguous(), mc.contiguous()


def chunk_bitwise(env, mcfg, B, M, gen, dev):
    """The chunk's search kernels against the plain chunk, bit for bit,
    under the exact stub at B games, S = mcfg.num_simulations, M moves,
    with Dirichlet noise and temperature sampling (both fed the same draws)
    on :func:`chunk_roots`.  Fails on a difference or an illegal opening;
    returns the phase's numbers."""
    from alphazero_tpu_torch.search import fused
    from alphazero_tpu_torch.search.stub import exact_stub_evaluator
    if not (mcfg.use_dirichlet and mcfg.temperature_moves > 0):
        fail(f"{env.name} chunk: Dirichlet and temperature sampling expected")
    A, S = env.action_dim, mcfg.num_simulations
    board, player, mc = chunk_roots(env, B, gen, dev)
    noise = fused.dirichlet_noise(M, A, B, mcfg.dirichlet_alpha, gen, dev)
    unif = torch.rand((M, B), generator=gen, device=dev)
    kw = dict(noise=noise, unif=unif, evaluator=exact_stub_evaluator(env))
    t0 = time.perf_counter()
    got = fused.run_selfplay_chunk(env, None, None, board, player, mc, mcfg,
                                   M, device=dev, **kw)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fused.selfplay_chunk_reference(env, None, None, board, player, mc,
                                          mcfg, M, **kw)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    sampled = int((got["action"] != got["policy"].argmax(-1)).sum())
    won_first = int((got["done"][0, 1::4] & (got["winner"][0, 1::4] == 0)
                     ).sum())
    log(f"[{env.name} chunk] B={B} S={S} M={M} Dirichlet+temperature, exact "
        f"stub: {len(want)} record arrays, mismatched {bad or 'none'}; "
        f"{sampled} sampled non-argmax actions, {int(got['done'].sum())} "
        f"games finished, {won_first} of {B // 4} near-win roots won on "
        f"their first move; kernel chunk {t_kern:.2f} s, plain chunk "
        f"{t_plain:.2f} s")
    if bad:
        fail(f"{env.name}: search kernels differ from the plain chunk in {bad}")
    if env.name.startswith("gomoku"):
        centre = (env.rows // 2) * env.cols + env.cols // 2
        if not bool((got["action"][0, 0::4] == centre).all()):
            fail(f"{env.name}: an empty board did not open in the centre")
    return dict(batch=B, num_simulations=S, moves=M, seconds=t_kern,
                plain_seconds=t_plain, sampled=sampled,
                finished=int(got["done"].sum()), near_win_won=won_first)


def check_chunk_records(env, recs):
    """Checks on every move of the captured chunk records ``recs``: each
    action legal on the board before it (the env's mask), the first
    move of a game in the centre (gomoku), a winner exactly where the
    mover's stones then hold a line, a game done exactly where it was won
    or the board is full.  Returns ``{check: bool}``."""
    R, C, RC = env.rows, env.cols, env.rows * env.cols
    ok = {"legal moves only": True, "first move in the centre": True,
          "winners hold a line, and only they": True,
          "done = won or board full": True}
    for rec in recs:
        M, B = rec["action"].shape
        obs = rec["obs"][:, :, :2].reshape(M * B, 2, R, C)
        act = rec["action"].reshape(-1).long()
        ar = torch.arange(M * B, device=act.device)
        legal = env.valid_mask_board(obs, None)[ar, act]
        ok["legal moves only"] &= bool(legal.all())
        t = rec["t"].reshape(-1)
        if env.name.startswith("gomoku"):
            centre = (R // 2) * C + C // 2
            ok["first move in the centre"] &= bool(
                (act[t == 0] == centre).all())
        mine = obs[:, 0].reshape(M * B, RC).clone()
        mine[ar, act] = 1
        won = env.won_batch(mine.reshape(M * B, R, C))
        winner = rec["winner"].reshape(-1)
        ok["winners hold a line, and only they"] &= bool(
            torch.equal(won, winner >= 0)
            and (winner[won] == rec["player"].reshape(-1)[won]).all())
        ok["done = won or board full"] &= bool(torch.equal(
            rec["done"].reshape(-1), won | (t + 1 >= env.max_moves)))
    return ok


def won_roots(env, st, idx):
    """Games ``idx`` of ``st`` replaced by a won position: player 0's line
    completed, player 1 to move."""
    won, mc, (r, c) = near_win(env, st.board.device)
    won[0, r, c] = 1
    st.board[idx] = won
    st.current_player[idx], st.move_count[idx] = 1, mc + 1
    st.done[idx], st.winner[idx] = True, 0
    return st


def dense_games_phase(gen, dev):
    """Phase 11: the dense tower's searches off connect4.  The forward at
    gomoku9-dense's width with A=81 and a dense tictactoe tower; the chunk
    bitwise at gomoku9-dense and tictactoe; the move search bitwise at
    gomoku9; ``Trainer(preset("gomoku9-dense")).iterate(vanilla_eval=False)``
    at full width with launches per phase and checks on every move of its
    chunks; each search kernel against its plain version on its self-play
    snapshot and the gate's batch; one chunk and one gate move profiled.
    Returns the phase's summary."""
    from alphazero_tpu_torch.config import ModelConfig, preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.eval import arena
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    from alphazero_tpu_torch.search import fused
    from alphazero_tpu_torch.search.mcts import run_mcts
    from alphazero_tpu_torch.search.stub import exact_stub_evaluator
    from alphazero_tpu_torch.training import Trainer, selfplay
    from alphazero_tpu_torch.utils.metrics import MetricsLogger
    t_phase = time.perf_counter()
    cfg = preset("gomoku9-dense")
    env = make_env(cfg.env)
    mcfg = cfg.mcts
    S, A = mcfg.num_simulations, env.action_dim
    B, Bg = cfg.train.selfplay_batch, cfg.train.gate_games // 2
    out_ = {"preset": "gomoku9-dense", "batch": B, "num_simulations": S}

    # ---- a. the forward kernel at A=81 (and a dense tictactoe tower)
    fwd = {}
    for game, mcfg_model, batches, sweep in (
            ("gomoku9", cfg.model, (B, Bg, 1, 17, 129), (B, Bg)),
            ("tictactoe", ModelConfig(family="dense", width=512, blocks=2),
             (256, 1, 17), ())):
        genv = make_env(game)
        model = build_model(mcfg_model, genv).to(dev)
        params = {k: v.to(dev) for k, v in init_params(
            model, torch.Generator().manual_seed(0)).items()}
        packed = fused.pack_dense_params(model, params, dev)
        fwd[game] = forward_by_batch(genv, model, params, packed, batches,
                                     sweep, gen, dev)
        if game == "gomoku9":            # per call and bound at B=256, A=81
            obs = genv.observation(random_positions(genv, B, gen, dev)
                                   ).reshape(B, -1).contiguous()
            ms_k, ms_p = alternate(
                lambda: fused.dense_forward(obs, packed),
                lambda: fused.dense_forward_reference(obs, packed))
            kin, D = packed["kin"], model.width
            DV, nb = D // 4, model.blocks
            b_ms, b_by = bound(
                nbytes(*(v for v in packed.values() if torch.is_tensor(v)))
                + nbytes(obs) + B * (A + 1) * 4,
                2.0 * B * (kin * D + nb * 2 * D * D + D * DV),
                2.0 * B * (D * A + DV))
            dense11 = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=max(
                               v["max_abs_err"] for v in fwd[game].values()))
            log(f"[forward] gomoku9 B={B}: per call kernel wrapper "
                f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by})")
    out_["forward"] = fwd

    # ---- b. the chunk, bit for bit, at gomoku9-dense and tictactoe
    ttt = make_env("tictactoe")
    out_["chunk_bitwise"] = {
        "gomoku9": chunk_bitwise(env, mcfg, B, 2, gen, dev),
        "tictactoe": chunk_bitwise(ttt, preset("tictactoe").mcts, 256, 4,
                                   gen, dev)}

    # ---- c. the move search, bit for bit, at gomoku9 B=128, S=400
    st = won_roots(env, with_drawn_game(random_positions(env, Bg, gen, dev),
                                        env),
                   slice(Bg // 2, Bg // 2 + max(1, min(8, Bg // 8))))
    margs = (st.board, st.current_player, st.move_count, st.done)
    won = st.done & (st.winner >= 0)
    drawn = st.done & (st.winner < 0)
    noise = fused.dirichlet_noise(1, A, Bg, mcfg.dirichlet_alpha, gen,
                                  dev)[0].T.contiguous()
    stub = exact_stub_evaluator(env)
    root_stub = lambda o: stub(o.reshape(o.shape[0], -1))  # noqa: E731
    t0 = time.perf_counter()
    got = fused.run_mcts_fused(env, None, None, root_stub, *margs, mcfg,
                               noise=noise, evaluator=stub, device=dev)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fused.move_search_reference(env, None, None, root_stub, *margs,
                                       mcfg, noise=noise, evaluator=stub)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    bad = [k for k in ("visit_counts", "policy", "root_q")
           if not torch.equal(getattr(got, k), getattr(want, k))]
    sums = got.visit_counts.sum(-1)
    log(f"[gomoku9 move search] B={Bg} S={S} Dirichlet, exact stub, "
        f"{int((~st.done).sum())} live / {int(won.sum())} won / "
        f"{int(drawn.sum())} drawn roots: mismatched {bad or 'none'}; kernel "
        f"search {t_kern:.2f} s, plain search {t_plain:.2f} s")
    if bad:
        fail(f"gomoku9 move search kernels differ from the plain search in "
             f"{bad}")
    checks = {
        "live roots count S-1 visits": bool((sums[~st.done] == S - 1).all()),
        "finished roots count none": bool((sums[st.done] == 0).all()),
        "won roots: root Q (S-1)/S": bool(won.any()) and bool(
            (got.root_q[won] == torch.tensor((S - 1) / S, device=dev)).all()),
        "the drawn root: root Q 0": bool(drawn.any()) and bool(
            (got.root_q[drawn] == 0).all()),
    }
    out_["move_search_bitwise"] = dict(batch=Bg, seconds=t_kern,
                                       plain_seconds=t_plain)

    # ---- d. the path: one outer iteration at full width
    tr = Trainer(cfg, device="cuda", logger=MetricsLogger(stdout=False))
    split, graphs, trace, recs = {}, {}, [], []
    launch_counts = counted_phases(tr, ("collect", "train_epoch", "gate"),
                                   fused.KERNELS, split, graphs)
    real_chunk = selfplay.run_selfplay_chunk

    def captured_chunk(*a, **kw):
        rec = real_chunk(*a, **kw)
        recs.append({k: rec[k] for k in ("obs", "action", "t", "player",
                                         "done", "winner")})
        return rec

    def traced_run_mcts(env_, eval_fn, boards, players, mcs, dones, cfg_,
                        **kw):
        res = run_mcts(env_, eval_fn, boards, players, mcs, dones, cfg_, **kw)
        trace.append((dones, res.visit_counts))
        return res

    selfplay.run_selfplay_chunk, arena.run_mcts = captured_chunk, \
        traced_run_mcts
    for k in fused.KERNELS:
        k.launches = 0
    try:
        it = tr.iterate(vanilla_eval=False)
    finally:
        selfplay.run_selfplay_chunk, arena.run_mcts = real_chunk, run_mcts
    total = launch_counts()
    split = {p: dict(c) for p, c in split.items()}   # the later collect
    chunks = len(it["chunk_seconds"])
    M = cfg.train.selfplay_chunk_steps or 32
    searches = 2 * env.max_moves
    expect = {
        "collect": chunk_launches(chunks, M, S, graphs["collect"]),
        "train_epoch": {k: 0 for k in total},
        "gate": {k: 0 for k in total}}
    expect["gate"].update(move_search_launches(searches, S, graphs["gate"]))
    log(f"[gomoku9-dense iterate] Trainer(preset('gomoku9-dense'))"
        f".iterate(vanilla_eval=False): launches {total}; measured per "
        f"phase {split}")
    if split != expect:
        fail(f"gomoku9-dense launches per phase {split} != expected {expect}")
    rate = M * B / statistics.median(it["chunk_seconds"])
    log(f"[gomoku9-dense iterate] collect {it['collect_seconds']:.3f} s "
        f"({chunks} chunks {it['chunk_seconds']}, {it['games']} games, "
        f"{rate:.1f} env-steps/s at B={B}, S={S}); train "
        f"{it['train_seconds']:.3f} s ({it['steps']} steps, loss "
        f"{it['loss']:.4f}); gate {it['gate_seconds']:.3f} s (score "
        f"{tr.last_gate_score}, accepted {it['accepted']})")
    checks.update(check_chunk_records(env, recs))
    checks.update({
        "collect ran >= 2 chunks": chunks >= 2,
        "gate score sums to the game count": sum(
            tr.last_gate_score[:2]) == cfg.train.gate_games,
        "every gate search recorded": len(trace) == searches,
        "gate: live roots count S-1 visits": all(
            bool((c.sum(-1)[~d] == S - 1).all()) for d, c in trace),
        "gate: finished roots count none": all(
            bool((c.sum(-1)[d] == 0).all()) for d, c in trace),
        "finite losses": all(math.isfinite(it[k]) for k in (
            "loss", "policy_loss", "value_loss", "l2")),
        "every kernel launched": all(v > 0 for v in total.values()),
    })
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail("gomoku9-dense phase checks failed")

    # ---- e. each search kernel against its plain version: the self-play
    # snapshot (B=256) and the gate's batch (B=128), real weights
    log("[gomoku9-dense] each kernel against its plain version: a self-play "
        f"snapshot (B={B}) and a gate search (B={Bg})")
    kern = chunk_kernels_phase(env, mcfg, tr, gen, dev, ("gomoku9",))
    ms_move, err_move = move_kernels_phase(env, mcfg, tr.model,
                                           tr.params_best, margs, noise, dev,
                                           ("gomoku9",))
    kern.update(ms_move)
    dense11["max_abs_err"] = max(dense11["max_abs_err"], err_move)
    kern["az_dense_forward"] = dense11

    # ---- f. one chunk and one gate move (both agents, B=128), profiled
    med = statistics.median(it["chunk_seconds"])
    chunk_us = print_profile(
        "gomoku9-dense, one chunk",
        device_profile(lambda: tr.collect(games_target=0)), med * 1e3)
    st_g = random_positions(env, cfg.train.gate_games, gen, dev)
    agents = (make_eval_fn(tr.model, tr.params_best),
              make_eval_fn(tr.model, tr.params_new))

    def gate_move():
        for fn, sl in zip(agents, (slice(0, Bg), slice(Bg, None))):
            run_mcts(env, fn, st_g.board[sl], st_g.current_player[sl],
                     st_g.move_count[sl], st_g.done[sl], mcfg, generator=gen,
                     device=dev)

    gate_move()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gate_move()
    torch.cuda.synchronize()
    gate_wall = (time.perf_counter() - t0) * 1e3
    gate_us = print_profile(f"gomoku9-dense, one gate move (2 x B={Bg})",
                            device_profile(gate_move), gate_wall)
    if gate_us:
        if "az_root_counts" not in gate_us:
            fail("the profiled gomoku9-dense gate move ran no az_root_counts")
        log(f"[gomoku9-dense] az_root_counts in the gate move's path: "
            f"{gate_us['az_root_counts'] * 1e3:.2f} us per launch, "
            f"az_move_root_init "
            f"{gate_us.get('az_move_root_init', float('nan')) * 1e3:.2f} us")
    seconds = time.perf_counter() - t_phase
    log(f"[gomoku9-dense] phase 11 took {seconds:.1f} s")
    out_.update(env_steps_per_s=rate,
                chunk_seconds=it["chunk_seconds"], iterate={
                    k: it[k] for k in ("collect_seconds", "train_seconds",
                                       "gate_seconds", "steps", "games",
                                       "loss", "gate_rate", "accepted")},
                gate_score=tr.last_gate_score, gate_move_ms=gate_wall,
                launches_by_phase=split, phase_seconds=seconds)
    return out_, kern, total, split, chunk_us, gate_us


# max |card - CPU| of the ViT's plain forward on logits and value: float32
# (no TF32) differs by summation order only; bf16 rounds an activation near
# a boundary the other way (the bf16 forward lies within 1.6e-2 of the
# float32 one on the CPU at these widths)
TOL_VIT = {"float32": 1e-4, "bfloat16": 5e-2}


def vit_forward_phase(env, cfg, gen, dev):
    """The ViT's plain forward at the preset's widths and self-play batch:
    on the card against the same forward on the CPU (float32 and bf16,
    ``TOL_VIT``), its device time per call (``device_ms``, through
    ``make_eval_fn``) and its bound.  Returns ``{dtype: summary}``."""
    import dataclasses

    from alphazero_tpu_torch.bench import _model_flops_per_pos
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    B = cfg.train.selfplay_batch
    # the patch conv, the attention's projections and products and the MLP
    # in the compute dtype; the heads on the CLS row in float32
    mm = B * _model_flops_per_pos(cfg, env)
    heads = 2.0 * B * cfg.model.embed_dim * (env.action_dim + 1)
    obs = env.observation(random_positions(env, B, gen, dev))
    out_ = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(dataclasses.replace(cfg.model,
                                                compute_dtype=dtype), env)
        params = init_params(model, torch.Generator().manual_seed(0))
        with torch.no_grad():
            want = torch.func.functional_call(model, params, (obs.cpu(),))
        model = model.to(dev)
        params = {k: v.to(dev) for k, v in params.items()}
        with torch.no_grad():
            got = torch.func.functional_call(model, params, (obs,))
        torch.cuda.synchronize()
        err = max(float((a.float().cpu() - b.float()).abs().max())
                  for a, b in zip(got, want))
        ok = (all(bool(torch.isfinite(a).all()) for a in got)
              and err <= TOL_VIT[dtype])
        ev = make_eval_fn(model, params)
        # ≈ 55 launches a forward: 5 calls stay inside the launch queue
        t = device_ms([("vit", lambda: ev(obs), 5)])["vit"]
        reps = 10
        prof = device_profile(lambda: [ev(obs) for _ in range(reps)],
                              names=True)
        if prof is not None:
            per, busy, _ = prof
            top = sorted(per.items(), key=lambda x: -x[1][1])[:8]
            log(f"[vit forward] {dtype} profile of {reps} forwards: "
                f"{sum(n for n, _ in per.values()) / reps:.0f} launches and "
                f"{busy / reps / 1e3:.4f} ms device busy per forward; "
                + "; ".join(f"{k}: {n // reps} x {us / n:.2f} us"
                            for k, (n, us) in top))
        wbytes = nbytes(*params.values())
        if dtype == "bfloat16":
            b_ms, b_by = bound(wbytes + nbytes(obs) + B * (env.action_dim
                                                           + 1) * 4,
                               bf16_ops=mm, f32_ops=heads)
        else:
            b_ms, b_by = bound(wbytes + nbytes(obs) + B * (env.action_dim
                                                           + 1) * 4,
                               f32_ops=mm + heads)
        log(f"[vit forward] {env.name} B={B} E={model.embed_dim} depth "
            f"{model.depth} patch {model.patch_size} heads "
            f"{model.num_heads} {dtype}: card vs CPU max abs err {err:.3e} "
            f"(tol {TOL_VIT[dtype]}) -> {'ok' if ok else 'FAIL'}; device "
            f"{t} ms per call (make_eval_fn, device_ms), bound {b_ms:.5f} ms "
            f"({b_by}; {(mm + heads) / 1e9:.2f} GFLOP, "
            f"{wbytes / 1e6:.2f} MB weights)")
        if not ok:
            fail(f"the ViT's forward on the card disagrees with the CPU "
                 f"({dtype})")
        out_[dtype] = dict(
            batch=B, max_abs_err=err, device_ms=t, bound_ms=b_ms,
            bound_by=b_by, gflop=(mm + heads) / 1e9,
            profiled_ms=None if prof is None else prof[1] / reps / 1e3,
            launches=None if prof is None else sum(
                n for n, _ in prof[0].values()) / reps)
    return out_


def vit_phase(gen, dev):
    """Phase 12: the ViT family and the ``gomoku7-reference`` preset.  The
    sim kernels at gomoku 7x7 (A=49) under the reference formula; the ViT's
    forward; ``Trainer(preset("gomoku7-reference")).iterate(vanilla_eval=
    False)`` at full width with launches per phase and checks on every
    move it played; one self-play move profiled; ``expand_depth(2)`` on
    the card with one move and a checkpoint round trip.  Returns (summary,
    the sim kernels' step and flush at A=49, launch split, total, the
    move's device ms per launch)."""
    import shutil

    from alphazero_tpu_torch.config import load_config, preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops import resnet_tower
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.training import Trainer, selfplay
    from alphazero_tpu_torch.utils.metrics import MetricsLogger
    t_phase = time.perf_counter()
    pname = "gomoku7-reference"
    cfg = preset(pname)
    env = make_env(cfg.env)
    mcfg = cfg.mcts
    S, A, B = mcfg.num_simulations, env.action_dim, cfg.train.selfplay_batch
    out_ = {"preset": pname, "batch": B, "num_simulations": S,
            "formula": mcfg.formula}

    # ---- a. the sim kernels at A=49 under the reference formula
    geo = sim.sim_kernel_geometry(B, A)
    log(f"[sim geometry] {pname} B={B} A={A}: {geo['lanes_per_game']} "
        f"lanes per game, {geo['games_per_cta']} games per CTA, "
        f"{geo['ctas']} CTAs, {geo['edges_per_lane']} edges a lane")
    sim_search_bitwise(pname, B, gen, dev)
    step, flush = sim_step_at(pname, B, gen, dev)

    # ---- b. the ViT forward at the path's batch
    out_["forward"] = vit_forward_phase(env, cfg, gen, dev)

    # ---- c. the path: one outer iteration at full width
    wd = Path(__file__).resolve().parent / "build" / "smoke_vit"
    shutil.rmtree(wd, ignore_errors=True)
    tr = Trainer(cfg, device="cuda", workdir=str(wd),
                 logger=MetricsLogger(stdout=False))
    log(f"[vit iterate] model {type(tr.model).__name__} embed "
        f"{tr.model.embed_dim} depth {tr.model.depth} patch "
        f"{tr.model.patch_size} heads {tr.model.num_heads} dropout "
        f"{tr.model.dropout} {cfg.model.compute_dtype}, {S} sims "
        f"({mcfg.formula}), B={B}, batch {cfg.train.batch_size}, gate "
        f"{'on' if cfg.train.gate_enabled else 'off'}")
    init = {k: v.clone() for k, v in tr.params_best.items()}
    drop0 = tr.dropout_generator.get_state()
    kernels = fused.KERNELS + sim.KERNELS + resnet_tower.KERNELS
    split, moves = {}, []
    counts = counted_phases(tr, ("collect", "train_epoch", "gate"), kernels,
                            split)
    real_step = selfplay.selfplay_step

    def captured_step(env_, eval_fn, mcfg_, sp, buffer, **kw):
        s, seen = sp.env_state, {}
        rec = dict(obs=env_.observation(s).to(torch.int8), t=sp.t.clone(),
                   player=s.current_player.clone())
        real_env_step = env_.step

        def spy(state, action):     # the move is the step's last env.step
            new = real_env_step(state, action)
            seen.update(action=action.clone(), done=new.done.clone(),
                        winner=new.winner.clone())
            return new

        env_.step = spy
        try:
            res = real_step(env_, eval_fn, mcfg_, sp, buffer, **kw)
        finally:
            del env_.step
        moves.append(dict(rec, **seen))
        return res

    selfplay.selfplay_step = captured_step
    for k in kernels:
        k.launches = 0
    try:
        it = tr.iterate(vanilla_eval=False)
    finally:
        selfplay.selfplay_step = real_step
    total = counts()
    M = cfg.train.selfplay_chunk_steps or 32
    chunks = len(it["chunk_seconds"])
    expect = {"collect": {"az_sim_step": len(moves) * (S - 1),
                          "az_sim_flush": len(moves)},
              "train_epoch": {}, "gate": {}}
    log(f"[vit iterate] Trainer(preset('{pname}')).iterate(vanilla_eval="
        f"False): launches {total}; measured per phase {split}")
    for phase, want in expect.items():
        full = {k.name: want.get(k.name, 0) for k in kernels}
        if split.get(phase) != full:
            fail(f"{pname} {phase} launches {split.get(phase)} != expected "
                 f"{full} (the dense kernels and the tower must show 0)")
    rate = M * B / statistics.median(it["chunk_seconds"])
    steps_rate = it["steps"] / it["train_seconds"]
    log(f"[vit iterate] collect {it['collect_seconds']:.3f} s ({chunks} "
        f"chunks of {M} moves {it['chunk_seconds']}, {it['games']} games, "
        f"{it['env_steps']} env-steps, {it['env_steps_per_s']:.1f} "
        f"env-steps/s over collect, {rate:.1f} over the median chunk); "
        f"train {it['train_seconds']:.3f} s ({it['steps']} steps of batch "
        f"{cfg.train.batch_size}, {steps_rate:.1f} steps/s, loss "
        f"{it['loss']:.4f}); gate {it['gate_seconds']:.6f} s (disabled, "
        f"rate {it['gate_rate']}, accepted {it['accepted']})")
    recs = {k: torch.stack([m[k] for m in moves]) for k in moves[0]}
    checks = check_chunk_records(env, [recs])
    size = int(tr.buffer.size)
    lens = tr.buffer.length[:size].long()
    rows = torch.arange(env.max_moves, device=dev)[None] < lens[:, None]
    pol = tr.buffer.policy[:size]
    counts_b = pol * (S - 1)
    checks.update({
        "a self-play search per move, M per chunk": len(moves) == chunks * M,
        "buffer holds the finished games": size == min(
            it["games"], tr.buffer.capacity) and size > 0,
        "policies sum to 1": bool(((pol.sum(-1) - 1).abs()
                                   <= 1e-6)[rows].all()),
        "root counts sum to S-1": bool(
            ((counts_b - counts_b.round()).abs() <= 1e-3)[rows].all()
            and (counts_b.round().sum(-1) == S - 1)[rows].all()),
        "train steps = buffer rows // batch": it["steps"] == max(
            it["buffer_size"] // cfg.train.batch_size, 1),
        "finite losses": all(math.isfinite(it[k]) for k in (
            "loss", "policy_loss", "value_loss", "l2")),
        "the learner drew dropout masks": not torch.equal(
            tr.dropout_generator.get_state(), drop0),
        "gate disabled: promoted": it["accepted"] and tr.version == 1
        and all(torch.equal(tr.params_best[k], tr.params_new[k])
                for k in init)
        and not all(torch.equal(tr.params_best[k], init[k]) for k in init),
        "the sim kernels launched": all(total[n] > 0 for n in (
            "az_sim_step", "az_sim_flush")),
    })
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail(f"{pname} iteration checks failed")

    # ---- d. one self-play move (B games), profiled
    ev = make_eval_fn(tr.model, tr.params_best)

    def sp_move():
        tr.sp, tr.buffer = selfplay.selfplay_step(env, ev, mcfg, tr.sp,
                                                  tr.buffer)

    sp_move()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp_move()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof = device_profile(sp_move)
    dev_ms = print_profile(f"one {pname} self-play move (B={B}, S={S})",
                           prof, wall)
    move = dict(wall_ms=wall)
    if prof is not None:
        per, busy, _ = prof
        # the forward's busy time as the profiler counts it (device_ms also
        # counts the gaps between its ≈ 55 launches)
        fwd = out_["forward"][cfg.model.compute_dtype]
        fwd_ms = fwd["profiled_ms"] or fwd["device_ms"]
        move.update(
            busy_ms=busy / 1e3, idle_share=1 - busy / 1e3 / wall,
            sim_step_share=per.get("az_sim_step", (0, 0.0))[1] / busy,
            other_share=per.get("other", (0, 0.0))[1] / busy,
            vit_share=(None if fwd_ms is None
                       else S * fwd_ms * 1e3 / busy),
            launches={k: n for k, (n, _) in per.items()})
        log(f"[vit move] wall {wall:.1f} ms, device busy {busy / 1e3:.1f} "
            f"ms, idle share {move['idle_share']:.3f}; az_sim_step "
            f"{move['sim_step_share']:.1%} of busy time, PyTorch's kernels "
            f"(the ViT forward, the root's expansion and the move) "
            f"{move['other_share']:.1%}; the ViT forward (S x its profiled "
            f"device time at B={B}, {fwd_ms} ms) "
            + ("not measured" if fwd_ms is None
               else f"{move['vit_share']:.1%}") + " of busy time")
    # ---- e. depth surgery on the card: grow to 2 blocks, play a move,
    # and restore the checkpoint (the dropout generator with it) into a
    # trainer built from the workdir's config.json
    before = {k: v.clone() for k, v in tr.params_best.items()}
    tr.expand_depth(2)
    n0 = sim.K_SIM_STEP.launches
    tr.sp, tr.buffer = selfplay.selfplay_step(
        env, make_eval_fn(tr.model, tr.params_best), mcfg, tr.sp, tr.buffer)
    tr.save_checkpoint()
    fresh = Trainer(load_config(str(wd)), device="cuda", workdir=str(wd),
                    persist_config=False, logger=MetricsLogger(stdout=False))
    checks = {
        "expand_depth(2): two blocks on the card": tr.model.depth == 2
        and all(v.device.type == dev.type for v in tr.params_best.values()),
        "old parameters kept": all(torch.equal(tr.params_best[k], v)
                                   for k, v in before.items()),
        "one draw for both parameter sets": all(
            torch.equal(tr.params_best[k], tr.params_new[k])
            for k in tr.params_best),
        "a move's search on the deeper model": sim.K_SIM_STEP.launches
        == n0 + S - 1,
        "config.json and the checkpoint restore the deeper model, the "
        "dropout generator included": fresh.model.depth == 2
            and fresh.restore_checkpoint() and torch.equal(
                fresh.dropout_generator.get_state(),
                tr.dropout_generator.get_state())
            and all(torch.equal(fresh.params_best[k], tr.params_best[k])
                    for k in tr.params_best),
    }
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail(f"{pname} depth surgery checks failed")
    seconds = time.perf_counter() - t_phase
    log(f"[{pname}] phase 12 took {seconds:.1f} s")
    out_.update(env_steps_per_s=rate, train_steps_per_s=steps_rate,
                chunk_seconds=it["chunk_seconds"], iterate={
                    k: it[k] for k in ("collect_seconds", "train_seconds",
                                       "gate_seconds", "steps", "games",
                                       "env_steps", "env_steps_per_s",
                                       "loss", "gate_rate", "accepted")},
                launches_by_phase=split, selfplay_move=move,
                phase_seconds=seconds)
    return out_, step, flush, split, total, dev_ms


# ---------------------------------------------------------------------------
# phase 13: multi-process training (parallel/, training/spmd_loop.py)
# ---------------------------------------------------------------------------

TOL_GRAD = {"float32": 1e-4, "bfloat16": 5e-2}   # of a tensor's largest |g|
MESH_TIMEOUT_S = 600


def _digest(t):
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _grad_err(got, want):
    """Largest ``|got - want|`` over ``want``'s largest ``|g|``, over every
    tensor but the attention's key biases (true gradient 0: the softmax
    ignores a shift common to every key)."""
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30)
               for k in want if not k.endswith("attn.key.bias"))


def mesh_dp_rank(out):
    """Phase 13a on one of two ranks sharing the card over gloo:
    ``SpmdTrainer(preset("connect4")).iterate(vanilla_eval=False)`` at
    data=2 (256 games a rank) with launches per phase, its first chunk
    against the single-process chunk on this rank's games, the contender
    after ``train_epoch``, one learner step's all-reduced gradients on a
    sampled half batch, and the time of one all-reduce of the gradients."""
    import dataclasses

    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.data.replay import ReplayBuffer, sample
    from alphazero_tpu_torch.parallel.distributed import (all_reduce,
                                                          process_info)
    from alphazero_tpu_torch.parallel.mesh import make_mesh
    from alphazero_tpu_torch.search import fused
    from alphazero_tpu_torch.training import learner
    from alphazero_tpu_torch.training.selfplay import selfplay_chunk
    from alphazero_tpu_torch.training.spmd_loop import SpmdTrainer
    from alphazero_tpu_torch.utils.checkpoint import _to_cpu as _cpu
    from alphazero_tpu_torch.utils.metrics import MetricsLogger
    cfg = preset("connect4")
    mesh = make_mesh(2)
    dev = process_info()["device"]
    tr = SpmdTrainer(cfg, mesh, logger=MetricsLogger(stdout=False))
    M = tr._chunk_steps

    def clone_sp(sp):
        gen = torch.Generator(device=dev)
        gen.set_state(sp.generator.get_state())
        return dataclasses.replace(
            sp, env_state=dataclasses.replace(sp.env_state, **{
                f.name: getattr(sp.env_state, f.name).clone()
                for f in dataclasses.fields(sp.env_state)}),
            traj_obs=sp.traj_obs.clone(), traj_policy=sp.traj_policy.clone(),
            t=sp.t.clone(), generator=gen)

    def clone_ring(b):
        return ReplayBuffer(**{f.name: getattr(b, f.name).clone()
                               for f in dataclasses.fields(b)})

    init = {k: v.clone() for k, v in tr.params_best.items()}
    sp0, ring0 = clone_sp(tr.sp), clone_ring(tr.buffer)
    first, trained = {}, {}
    runner = tr._runner

    def capture(params, sp, buf):
        sp, buf = runner(params, sp, buf)
        if not first:
            first.update(sp=clone_sp(sp), ring=clone_ring(buf))
        return sp, buf

    tr._runner = capture
    split, graphs = {}, {}
    counts = counted_phases(tr, ("collect", "train_epoch", "gate"),
                            fused.KERNELS, split, graphs)
    train_epoch = tr.train_epoch

    def train_and_keep():
        m = train_epoch()
        trained.update(_cpu(tr.params_new))
        return m

    tr.train_epoch = train_and_keep
    for k in fused.KERNELS:
        k.launches = 0
    it = tr.iterate(vanilla_eval=False)
    launches = counts()
    S = cfg.mcts.num_simulations
    gate_expect = move_search_launches(2 * tr.env.max_moves, S,
                                       graphs["gate"])
    collect_expect = chunk_launches(len(it["chunk_seconds"]), M, S,
                                    graphs["collect"])
    log(f"[mesh a] rank {mesh.rank}: iterate launches {launches}; per phase "
        f"{split}")

    # the first chunk again, in this process alone, on this rank's games
    sp1, ring1 = selfplay_chunk(tr.env, tr.model, init, cfg.mcts, cfg.replay,
                                sp0, ring0, M)
    torch.cuda.synchronize()
    got = first["sp"]
    same = {k: torch.equal(getattr(got, k), getattr(sp1, k))
            for k in ("traj_obs", "traj_policy", "t")}
    same["board"] = torch.equal(got.env_state.board, sp1.env_state.board)
    for f in dataclasses.fields(ReplayBuffer):
        same[f"ring.{f.name}"] = torch.equal(getattr(first["ring"], f.name),
                                             getattr(ring1, f.name))

    # one learner step on a sampled half batch: all-reduced gradients
    gen = torch.Generator(device=dev).manual_seed(100 + mesh.rank)
    obs, pol, val = sample(tr.buffer, cfg.train.batch_size // 2,
                           generator=gen, syms=tr._syms,
                           augment_skip=cfg.replay.augment_skip_moves)
    ps = learner.leaf_copies(tr.params_new)
    opt = learner.make_optimizer(cfg.train, ps)
    learner.train_step(tr.model, ps, opt, obs, pol, val, cfg.train.l2_coeff,
                       None, mesh)
    grads = {k: p.grad for k, p in ps.items()}

    # the all-reduce of one step's gradients and metrics, alone
    n = sum(p.numel() for p in tr.params_new.values()) + 4
    flat = torch.zeros(n, device=dev)
    reps = 20
    for _ in range(3):
        all_reduce(flat, mesh.data_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce(flat, mesh.data_group)
    torch.cuda.synchronize()
    ar_ms = (time.perf_counter() - t0) * 1e3 / reps
    return _cpu(dict(
        iterate={k: it[k] for k in (
            "collect_seconds", "train_seconds", "gate_seconds", "games",
            "env_steps", "steps", "loss", "accepted", "gate_rate",
            "buffer_size", "chunk_seconds")},
        launches=launches, split=split, gate_expect=gate_expect,
        collect_expect=collect_expect,
        chunks=len(it["chunk_seconds"]), M=M, same_first_chunk=same,
        local={"games": int(sp1.games_done - sp0.games_done),
               "env_steps": int(sp1.env_steps - sp0.env_steps),
               "results": (sp1.results - sp0.results).tolist()},
        global_first={"games": int(got.games_done),
                      "env_steps": int(got.env_steps),
                      "results": got.results.tolist()},
        games_local=int(tr.sp.t.numel()), trained=trained,
        gate_score=tr.last_gate_score, version=tr.version,
        ring_size=int(tr.buffer.size), params_in=tr.params_new,
        batch=dict(obs=obs, pol=pol, val=val), grads=grads,
        allreduce_ms=ar_ms, allreduce_bytes=4 * n))


def mesh_tp_rank(out):
    """Phase 13c on one of two model ranks sharing the card over gloo
    (``gomoku7-reference``, data=1, model=2): the split ViT's forward at
    B=256 against the replicated one in float32 and bf16, with times; one
    learner loss's gradients against the replicated ones; and one self-play
    search on the sim kernels with the split forward, whose tree each rank
    reduces to a digest."""
    import dataclasses

    from torch.func import functional_call

    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    from alphazero_tpu_torch.parallel import TPViT, make_mesh
    from alphazero_tpu_torch.parallel.distributed import (barrier,
                                                          process_info)
    from alphazero_tpu_torch.parallel.mesh import (shard_vit_params,
                                                   vit_split_dim)
    from alphazero_tpu_torch.search import sim
    from alphazero_tpu_torch.search.mcts import search_inputs
    from alphazero_tpu_torch.training import learner
    cfg = preset("gomoku7-reference")
    env = make_env(cfg.env)
    mesh = make_mesh(1, 2)
    dev = process_info()["device"]
    B, A = cfg.train.selfplay_batch, env.action_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    obs = env.observation(random_positions(env, B, gen, dev))
    pol = torch.softmax(torch.randn((B, A), generator=gen, device=dev), -1)
    val = torch.rand((B,), generator=gen, device=dev) * 2 - 1
    res = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(dataclasses.replace(cfg.model,
                                                compute_dtype=dtype), env)
        params = {k: v.to(dev) for k, v in init_params(
            model, torch.Generator().manual_seed(0)).items()}
        model = model.to(dev)
        tp = TPViT(model, mesh)
        local = shard_vit_params(params, mesh)
        with torch.no_grad():
            want = functional_call(model, params, (obs,))
            got = functional_call(tp, local, (obs,))
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        ev_rep, ev_tp = make_eval_fn(model, params), make_eval_fn(tp, local)
        # the replicated forward timed on rank 0 while rank 1 waits: two
        # processes' kernels time-slice the card
        rep_ms = (device_ms([("vit", lambda: ev_rep(obs), 5)])["vit"]
                  if mesh.rank == 0 else None)
        barrier()
        reps = 10
        tp_wall = cuda_ms(lambda: ev_tp(obs), reps)
        prof = device_profile(lambda: [ev_tp(obs) for _ in range(reps)],
                              names=True)
        tp_busy = tp_copy = None
        if prof is not None:
            copy = sum(us for name, (_, us) in prof[0].items()
                       if name.startswith("Memcpy"))
            tp_busy = (prof[1] - copy) / reps / 1e3
            tp_copy = copy / reps / 1e3
        rs, ps = learner.leaf_copies(params), learner.leaf_copies(local)
        for net, p in ((model, rs), (tp, ps)):
            loss, _ = learner.loss_fn(net, p, obs, pol, val,
                                      cfg.train.l2_coeff)
            loss.backward()
        want_g = {k: (p.grad if vit_split_dim(k) is None else p.grad.chunk(
            2, vit_split_dim(k))[mesh.model_index]) for k, p in rs.items()}
        g_err = _grad_err({k: p.grad for k, p in ps.items()}, want_g)
        log(f"[mesh c] rank {mesh.rank} {dtype}: split forward vs replicated "
            f"max abs err {err:.3e} (tol {TOL_VIT[dtype]}); gradients "
            f"{g_err:.3e} of the largest (tol {TOL_GRAD[dtype]}); replicated "
            f"forward {rep_ms} ms device (device_ms, rank 0 alone), split "
            f"forward {tp_wall:.4f} ms per call (CUDA events, two gloo "
            f"all-reduces a block), {tp_busy} ms of kernels and {tp_copy} "
            f"ms of copies (profile)")
        res[dtype] = dict(max_abs_err=err, grad_err=g_err,
                          replicated_device_ms=rep_ms, split_call_ms=tp_wall,
                          split_kernel_ms=tp_busy, split_copy_ms=tp_copy,
                          finite=all(bool(torch.isfinite(a).all())
                                     for a in got))

    # one self-play search (the preset's bf16 split forward) on sim kernels
    st = random_positions(env, B, torch.Generator(device=dev).manual_seed(1),
                          dev)
    args = search_inputs(env, cfg.mcts, st.board, st.current_player,
                         st.move_count, st.done,
                         torch.Generator(device=dev).manual_seed(2), None,
                         None, dev)
    for k in sim.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    tree = sim._search_tree(sim.DISPATCH, env, cfg.mcts, ev_tp, *args)
    torch.cuda.synchronize()
    res["search"] = dict(
        seconds=time.perf_counter() - t0,
        launches={k.name: k.launches for k in sim.KERNELS},
        digests={f.name: _digest(getattr(tree, f.name))
                 for f in dataclasses.fields(tree)},
        visits=int(tree.stats[:, 0, 0].sum()))
    return res


RANK_PROGRAMS = {"dp": mesh_dp_rank, "tp": mesh_tp_rank}


def rank_main(name, rank, world, coordinator, out):
    """One rank of a phase-13 program (``chip_smoke.py --rank ...``, started
    by :func:`run_ranks`): join the group, run, save the result."""
    from alphazero_tpu_torch.parallel import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(coordinator, int(world), int(rank), "cuda",
                           timeout=MESH_TIMEOUT_S)
    try:
        res = RANK_PROGRAMS[name](Path(out))
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        distributed.destroy()


def run_ranks(name, world, out):
    """Start ``world`` ranks of program ``name`` as processes of their own
    (their output captured in ``out/rank<r>.log``), wait for all of them
    (a failing rank stops the others) and return their results."""
    import shutil

    from alphazero_tpu_torch.parallel.distributed import free_port
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    coord = f"127.0.0.1:{free_port()}"
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", name,
         str(r), str(world), coord, str(out)],
        cwd=Path(__file__).resolve().parent, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        for line in (out / f"rank{r}.log").read_text().splitlines():
            if line.startswith("[") or p.returncode:
                log(f"  [rank {r}] {line}")
    if any(p.returncode for p in procs):
        fail(f"phase 13 {name}: rank exit codes "
             f"{[p.returncode for p in procs]}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def mesh_phase(dev, forward_held, chunk_held):
    """Phase 13: multi-process training on the one card.  (a) connect4,
    data=2, two gloo ranks; (b) ``python -m alphazero_tpu_torch train
    --preset connect4 --mesh data=1`` on NCCL; (c) gomoku7-reference,
    data=1, model=2, two gloo ranks.  ``forward_held`` and ``chunk_held``
    are the connect4 batches at which phases 2 and 3 held the forward and
    the chunk's kernels against their plain versions.  Returns the summary
    and (a)'s rank-0 launches per phase."""
    import dataclasses
    import shutil

    from alphazero_tpu_torch.config import load_config, preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.models import build_model
    from alphazero_tpu_torch.training import learner
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "smoke_mesh"
    cfg = preset("connect4")
    env = make_env(cfg.env)
    summary = {}

    # ---- a. connect4, data=2
    ra = run_ranks("dp", 2, root / "a")
    r0, r1 = ra
    Bl = r0["games_local"]
    # what rank 0's gate searches launch, graphs and all
    gate = r0["gate_expect"]

    def same(a, b):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)

    batch = {k: torch.cat([r["batch"][k] for r in ra]).to(dev)
             for k in ("obs", "pol", "val")}
    model = build_model(cfg.model, env).to(dev)
    ps = learner.leaf_copies({k: v.to(dev) for k, v in
                              r0["params_in"].items()})
    loss, _ = learner.loss_fn(model, ps, batch["obs"], batch["pol"],
                              batch["val"], cfg.train.l2_coeff)
    loss.backward()
    g_err = _grad_err({k: v.to(dev) for k, v in r0["grads"].items()},
                      {k: p.grad for k, p in ps.items()})
    checks = {
        "each rank plays half the games": Bl == cfg.train.selfplay_batch // 2
        and r1["games_local"] == Bl,
        f"the forward and the chunk's kernels held against their plain "
        f"versions at the rank's B={Bl} (phases 2-3)": Bl in forward_held
        and Bl in chunk_held,
        "collect launches: the chunk kernels, every chunk, each rank": all(
            r["split"]["collect"] == r["collect_expect"] for r in ra),
        "the learner launches no search kernel": all(
            not any(r["split"]["train_epoch"].values()) for r in ra),
        "the gate plays on rank 0 only": r0["split"]["gate"] == {
            n: gate.get(n, 0) for n in r0["split"]["gate"]}
        and not any(r1["split"]["gate"].values()),
        "first chunk = the single-process chunk on the rank's games": all(
            all(r["same_first_chunk"].values()) for r in ra),
        "global counters = the sum over the ranks": all(
            r["global_first"]["games"] == r0["local"]["games"]
            + r1["local"]["games"]
            and r["global_first"]["env_steps"] == r0["local"]["env_steps"]
            + r1["local"]["env_steps"]
            and r["global_first"]["results"] == [
                a + b for a, b in zip(r0["local"]["results"],
                                      r1["local"]["results"])] for r in ra),
        "contender bitwise equal on both ranks after train_epoch": same(
            r0["trained"], r1["trained"]) and bool(r0["trained"]),
        "the all-reduced gradients equal on both ranks": same(r0["grads"],
                                                              r1["grads"]),
        f"gradients vs one process on the whole batch (tol "
        f"{TOL_GRAD['bfloat16']})": g_err <= TOL_GRAD["bfloat16"],
        "same decision and gate score on both ranks": r0["gate_score"]
        == r1["gate_score"] and r0["version"] == r1["version"]
        and r0["iterate"]["accepted"] == r1["iterate"]["accepted"],
        "finite loss, every ring holds games": math.isfinite(
            r0["iterate"]["loss"]) and all(r["ring_size"] > 0 for r in ra),
    }
    it = r0["iterate"]
    log(f"[mesh a] connect4 data=2 (gloo, two ranks on one card; not a "
        f"scaling number): collect {it['collect_seconds']:.3f} s "
        f"({r0['chunks']} chunks, {it['games']} games, {it['env_steps']} "
        f"env-steps, {it['env_steps'] / it['collect_seconds']:.1f} "
        f"env-steps/s), train {it['train_seconds']:.3f} s ({it['steps']} "
        f"steps of 2 x {cfg.train.batch_size // 2}), gate "
        f"{it['gate_seconds']:.3f} s (score {r0['gate_score']}, accepted "
        f"{it['accepted']}); gradients vs one process {g_err:.3e} of the "
        f"largest; all-reduce of {r0['allreduce_bytes'] / 1e6:.2f} MB: "
        f"{r0['allreduce_ms']:.3f} / {r1['allreduce_ms']:.3f} ms")
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail("phase 13a (connect4, data=2) checks failed")
    summary["connect4_data2"] = dict(
        backend="gloo", ranks_on_one_card=2, iterate=it,
        chunks=r0["chunks"], launches_by_phase={r: ra[r]["split"]
                                                for r in (0, 1)},
        gate_score=r0["gate_score"], grad_err=g_err,
        allreduce_ms=[r["allreduce_ms"] for r in ra],
        allreduce_bytes=r0["allreduce_bytes"])

    # ---- b. the command line, data=1, on NCCL
    wd = root / "b"
    shutil.rmtree(wd, ignore_errors=True)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "alphazero_tpu_torch", "train", "--preset",
         "connect4", "--mesh", "data=1", "--iterations", "1", "--no-gate",
         "--workdir", str(wd)], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=MESH_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    recs = [json.loads(ln) for ln in cli.stdout.splitlines()
            if ln.startswith("{")]
    logged = ([json.loads(ln) for ln in (wd / "metrics.jsonl").read_text()
               .splitlines()] if (wd / "metrics.jsonl").exists() else [])
    ckpt = wd / "checkpoints" / "1" / "state.pt"
    state = (torch.load(ckpt, map_location="cpu", weights_only=True)
             if ckpt.exists() else None)
    stored = load_config(str(wd)) if (wd / "config.json").exists() else None
    itb = recs[-1] if recs else {}
    checks = {
        "exit 0": cli.returncode == 0,
        "one NCCL rank": "rank 0 of 1: device cuda:0, backend nccl"
        in cli.stderr,
        "collect / train / gate / iteration printed and logged": [
            r["kind"] for r in recs] == ["collect", "train", "iteration"]
        and [r["kind"] for r in logged] == [r["kind"] for r in recs],
        "config.json is the preset's, gate off": stored == dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, gate_enabled=False)),
        "checkpoint at version 1 with one ring and finite parameters":
        state is not None and int(state["version"]) == 1
        and tuple(state["buffer"]["size"].shape) == (1,)
        and int(state["buffer"]["size"][0]) > 0
        and all(bool(torch.isfinite(v).all())
                for v in state["params_best"].values()),
    }
    log(f"[mesh b] python -m alphazero_tpu_torch train --preset connect4 "
        f"--mesh data=1 --iterations 1 --no-gate: {cli_s:.1f} s, collect "
        f"{itb.get('collect_seconds')} s, train {itb.get('train_seconds')} s "
        f"({itb.get('steps')} steps)")
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        log(cli.stderr[-4000:])
        fail("phase 13b (the command line on NCCL) checks failed")
    summary["connect4_cli_data1"] = dict(
        backend="nccl", seconds=cli_s, iterate={k: itb.get(k) for k in (
            "collect_seconds", "train_seconds", "steps", "games", "loss")})

    # ---- c. gomoku7-reference, data=1, model=2
    rc = run_ranks("tp", 2, root / "c")
    cs = [r["search"] for r in rc]
    pc = preset("gomoku7-reference")
    checks = {
        **{f"split forward vs replicated, {dt} (tol {TOL_VIT[dt]})": all(
            r[dt]["finite"] and r[dt]["max_abs_err"] <= TOL_VIT[dt]
            for r in rc) for dt in TOL_VIT},
        **{f"split gradients vs replicated, {dt} (tol {TOL_GRAD[dt]})": all(
            r[dt]["grad_err"] <= TOL_GRAD[dt] for r in rc) for dt in TOL_GRAD},
        "the search's trees bitwise equal on both model ranks":
        cs[0]["digests"] == cs[1]["digests"],
        "sim kernels: S-1 steps and one flush": all(
            c["launches"] == {"az_sim_step": pc.mcts.num_simulations - 1,
                              "az_sim_flush": 1} for c in cs),
    }
    log(f"[mesh c] gomoku7-reference data=1 model=2 (gloo, two ranks on one "
        f"card): bf16 split forward {rc[0]['bfloat16']['split_call_ms']:.4f} "
        f"ms per call, {rc[0]['bfloat16']['split_kernel_ms']} ms of kernels, "
        f"beside the replicated {rc[0]['bfloat16']['replicated_device_ms']} "
        f"ms; one search {cs[0]['seconds']:.2f} s")
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail("phase 13c (gomoku7-reference, model=2) checks failed")
    summary["gomoku7_model2"] = dict(
        backend="gloo", ranks_on_one_card=2,
        **{dt: [r[dt] for r in rc] for dt in TOL_VIT},
        search_seconds=[c["seconds"] for c in cs],
        search_launches=cs[0]["launches"])
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 13 took {summary['phase_seconds']:.1f} s")
    return summary, r0["split"]


# ---------------------------------------------------------------------------
# phase 14: train to strength (strength.py), the validate_learning recipe
# ---------------------------------------------------------------------------

STRENGTH_EVAL_GAMES = 256   # the recipe's 64 cannot resolve ±0.05


def strength_phase(dev):
    """Phase 14: ``strength.py``'s ``validate_learning`` recipe at full
    preset width with 256-game evaluations.  The sim search bitwise at the
    evaluations' half batch; launches set to 0 before each collect, train
    epoch, gate and evaluation and read after each (az_sim_step S-1 per
    move searched, az_sim_flush one per search, every other kernel 0);
    every vanilla search of the evaluations timed; the curve checked
    (finite losses, the last below the first, scores summing to the games,
    the verdict PASS).  Returns (summary, launches by phase)."""
    import shutil

    from alphazero_tpu_torch import strength
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.eval import arena
    from alphazero_tpu_torch.ops import resnet_tower
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.search.mcts import run_mcts
    t_phase = time.perf_counter()
    name = "validate_learning"
    recipe = strength.RECIPES[name]
    cfg = recipe.config()
    env = make_env(cfg.env)
    S, G = cfg.mcts.num_simulations, STRENGTH_EVAL_GAMES
    M = cfg.train.selfplay_chunk_steps or 32
    out_ = {"recipe": name, "preset": "tictactoe", "eval_games": G,
            "vanilla_sims": recipe.vanilla_sims, "num_simulations": S,
            "model": f"{cfg.model.family} {cfg.model.channels}x"
                     f"{cfg.model.blocks}"}

    # ---- a. the evaluation's search, bitwise, at its half batch
    sim_search_bitwise("tictactoe", G // 2,
                       torch.Generator(device=dev).manual_seed(14), dev,
                       drawn_tictactoe=True)

    # ---- b. the recipe, launches counted per phase call
    wd = Path(__file__).resolve().parent / "build" / "smoke_strength"
    shutil.rmtree(wd, ignore_errors=True)
    lines = []

    def emit(line):
        lines.append(line)
        log(f"[strength] {json.dumps(line)}")

    run = strength.Strength(recipe, cfg, str(wd), G, device=dev, emit=emit)
    kernels = fused.KERNELS + sim.KERNELS + resnet_tower.KERNELS
    calls, searches, vanilla_ms = [], [0], []

    def counted(obj, attr, phase):
        fn = getattr(obj, attr)

        def call(*a, **kw):
            for k in kernels:
                k.launches = 0
            searches[0] = 0
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            calls.append((phase, {k.name: k.launches for k in kernels},
                          searches[0], res))
            return res
        setattr(obj, attr, call)

    for obj, attr, phase in ((run.tr, "collect", "collect"),
                             (run.tr, "train_epoch", "train"),
                             (run.tr, "gate", "gate"),
                             (run, "evaluate", "evaluate")):
        counted(obj, attr, phase)

    def timed_run_mcts(env_, eval_fn, *a, **kw):
        if eval_fn is not None:
            searches[0] += 1
            return run_mcts(env_, eval_fn, *a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_mcts(env_, eval_fn, *a, **kw)
        torch.cuda.synchronize()
        vanilla_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    arena.run_mcts = timed_run_mcts
    try:
        result = run.run(recipe.iterations)
    finally:
        arena.run_mcts = run_mcts

    # ---- c. launches: each call against what its searches require
    bad, split = [], {}
    for phase, got, n_model, res in calls:
        moves = (len(res["chunk_seconds"]) * M if phase == "collect"
                 else env.max_moves if phase == "evaluate" else 0)
        want = {k.name: 0 for k in kernels}
        want.update(az_sim_step=moves * (S - 1), az_sim_flush=moves)
        if got != want or (phase == "evaluate" and n_model != moves):
            bad.append((phase, got, want, n_model))
        tot = split.setdefault(phase, {k.name: 0 for k in kernels})
        for n, c in got.items():
            tot[n] += c
    log(f"[strength] launches by phase {split}")
    if bad:
        fail(f"phase 14 launch counts differ from the searches: {bad}")

    # ---- d. the curve
    train = [res for phase, _, _, res in calls if phase == "train"]
    evals = [line for line in lines if "tag" in line]
    iters = [line for line in lines if "iter" in line]
    key = f"model_score_vs_vanilla{recipe.vanilla_sims}"
    checks = {
        f"{recipe.iterations} iterations, the gate off": len(iters)
        == recipe.iterations and all(i["accepted"] for i in iters),
        "every iteration's loss finite": len(train) == recipe.iterations
        and all(math.isfinite(t[k]) for t in train for k in (
            "loss", "policy_loss", "value_loss", "l2")),
        "the last iteration's loss below the first": train[-1]["loss"]
        < train[0]["loss"],
        "every evaluation's score sums to the games": [
            e["tag"] for e in evals] == ["untrained", "trained"] and all(
            e["score"][0] + e["score"][1] == G and e["games"] == G
            for e in evals),
        "the untrained and trained evaluations ran the vanilla agent":
            len(vanilla_ms) == 2 * env.max_moves,
        "verdict PASS: trained > max(0.5, untrained)": result["result"]
        == "PASS" and result["trained"] > max(0.5, result["untrained"]),
    }
    for cname, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {cname}")
    curve = [[e["tag"], e["version"], e[key], e["score"]] for e in evals]
    seconds = time.perf_counter() - t_phase
    out_.update(
        curve=curve, verdict=result,
        losses=[t["loss"] for t in train],
        iteration_seconds=[{k: i[k] for k in (
            "collect_seconds", "train_seconds", "gate_seconds")}
            for i in iters],
        train_steps=[t["steps"] for t in train],
        eval_seconds=[e["seconds"] for e in evals],
        vanilla_ms_per_move=statistics.mean(vanilla_ms),
        vanilla_ms_per_move_range=[min(vanilla_ms), max(vanilla_ms)],
        launches_by_phase=split, phase_seconds=seconds)
    log(f"[strength] {name} on the card: curve {curve}; losses "
        f"{out_['losses']}; collect / train seconds by iteration "
        f"{[(i['collect_seconds'], i['train_seconds']) for i in iters]}; "
        f"evaluation seconds {out_['eval_seconds']}; vanilla-"
        f"{recipe.vanilla_sims} search {out_['vanilla_ms_per_move']:.1f} ms "
        f"a move at B={G // 2} (range {out_['vanilla_ms_per_move_range']})")
    if not all(checks.values()):
        fail("phase 14 (validate_learning) checks failed")
    log(f"[strength] phase 14 took {seconds:.1f} s")
    return out_, split


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.eval import arena
    from alphazero_tpu_torch.models import (build_model, init_params,
                                            make_eval_fn)
    from alphazero_tpu_torch.ops import build
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.search.mcts import run_mcts
    from alphazero_tpu_torch.search.stub import exact_stub_evaluator
    from alphazero_tpu_torch.training import Trainer
    from alphazero_tpu_torch.utils.metrics import MetricsLogger

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build
    t0 = time.perf_counter()
    try:
        logs = build.build_all()
    except RuntimeError as e:
        fail(str(e))
    log(f"[build] {len(logs)} sources built in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    cfg = preset("connect4")
    env = make_env("connect4")
    S = cfg.mcts.num_simulations
    B = cfg.train.selfplay_batch
    A, RC, F = env.action_dim, env.rows * env.cols, env.feature_dim
    summary = {}

    # ---- 2. dense forward kernel vs plain
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg.model, env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    packed = fused.pack_dense_params(model, params, dev)
    st = random_positions(env, B, gen, dev)
    obs = env.observation(st).reshape(B, -1).contiguous()
    pk, vk = fused.dense_forward(obs, packed)
    pp, vp = fused.dense_forward_reference(obs, packed)
    torch.cuda.synchronize()
    err = torch.cat([(pk - pp).abs().reshape(-1), (vk - vp).abs()])
    err_max = float(err.max())
    frac = float((err <= 1e-3).float().mean())
    if not (torch.isfinite(pk).all() and torch.isfinite(vk).all()):
        fail("forward kernel: non-finite output")
    ok = err_max <= TOL_FWD_MAX and frac >= TOL_FWD_FRAC
    log(f"[forward] B={B} D={model.width} blocks={model.blocks}: max abs err "
        f"{err_max:.3e} (tol {TOL_FWD_MAX}), share within 1e-3 {frac:.4f} "
        f"(tol {TOL_FWD_FRAC}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("forward kernel disagrees with its plain version")
    ms_k, ms_p = alternate(lambda: fused.dense_forward(obs, packed),
                           lambda: fused.dense_forward_reference(obs, packed))
    kin, D = packed["kin"], model.width
    DV, nb = D // 4, model.blocks
    bf16_ops = 2.0 * B * (kin * D + nb * 2 * D * D + D * DV)
    f32_ops = 2.0 * B * (D * A + DV)
    wbytes = nbytes(*(v for v in packed.values() if torch.is_tensor(v)))
    b_ms, b_by = bound(wbytes + nbytes(obs) + B * (A + 1) * 4, bf16_ops,
                       f32_ops)
    summary["az_dense_forward"] = dict(
        source="alphazero_tpu_torch/csrc/dense_forward.cu",
        max_abs_err=err_max, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
        bound_by=b_by)
    log(f"[forward] per call: kernel wrapper {ms_k:.4f} ms, plain "
        f"{ms_p:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}; {bf16_ops / 1e9:.3f} GFLOP bf16, "
        f"{wbytes / 1e6:.2f} MB weights)")
    # self-play's and the gate's batches and ragged ones: error, launch
    # geometry, and the device time of the kernel and of the eager module
    # (models/dense.py through make_eval_fn), both by device_ms
    by_batch = forward_by_batch(env, model, params, packed,
                                (B, cfg.train.gate_games // 2, 1, 17, 129),
                                (B, cfg.train.gate_games // 2), gen, dev)
    # phase 13a's batch: each of its two data ranks plays B / 2 games (a
    # generator of its own leaves the other batches' draws as they were)
    by_batch.update(forward_by_batch(
        env, model, params, packed, (B // 2,), (),
        torch.Generator(device=dev).manual_seed(13), dev))
    summary["az_dense_forward"]["by_batch"] = by_batch

    # ---- 3. search kernels vs the plain chunk, bitwise (exact stub), at
    # self-play's batch and at phase 13a's batch a rank
    mcfg = cfg.mcts
    chunk_held = [chunk_bitwise(env, mcfg, Bc, 4, g, dev)["batch"]
                  for Bc, g in ((B, gen), (B // 2, torch.Generator(
                      device=dev).manual_seed(13)))]
    stub = exact_stub_evaluator(env)

    # ---- 4. the main path
    tr = Trainer(cfg, device="cuda", logger=MetricsLogger(stdout=False))
    for k in fused.KERNELS:
        k.launches = 0
    graphs0 = graph_counts()
    m = tr.collect(games_target=2 * B)
    launches = {k.name: k.launches for k in fused.KERNELS}
    chunks = len(m["chunk_seconds"])
    M = cfg.train.selfplay_chunk_steps or 32
    expect = chunk_launches(chunks, M, S, graphs_since(graphs0))
    log(f"[main path] Trainer(preset('connect4')).collect: {chunks} chunks of "
        f"{M} moves, {m['games']} games, launches {launches}")
    if launches != expect:
        fail(f"launch counts {launches} != expected {expect}")
    chunk_seconds = list(m["chunk_seconds"])
    while len(chunk_seconds) < 3:        # one more timed chunk
        chunk_seconds += tr.collect(games_target=0)["chunk_seconds"]
    size = int(tr.buffer.size)
    lens = tr.buffer.length[:size].long()
    pol = tr.buffer.policy[:size]
    obs_b = tr.buffer.obs[:size].long()
    rows = torch.arange(env.max_moves, device=dev)[None] < lens[:, None]
    psum = pol.sum(-1)[rows]
    counts = pol * (S - 1)
    full = (obs_b[:, :, 0, 0] + obs_b[:, :, 1, 0]) > 0           # (G, L, C)
    stones = obs_b[:, :, :2].sum(dim=(2, 3, 4))
    below = torch.cat([obs_b[:, :, :2, 1:], torch.ones_like(
        obs_b[:, :, :2, :1])], dim=3).sum(2)                  # support
    floating = ((obs_b[:, :, :2].sum(2) > 0) & (below == 0))[rows].any()
    checks = {
        "buffer holds finished games": size > 0 and size == min(
            m["games"], tr.buffer.capacity),
        "game lengths >= 7": bool((lens >= 7).all()),
        "policies sum to 1": bool(((psum - 1).abs() <= 1e-6).all()),
        "root counts sum to S-1": bool(
            ((counts - counts.round()).abs() <= 1e-3)[rows].all()
            and ((counts.round().sum(-1) - (S - 1)).abs() == 0)[rows].all()),
        "full columns never visited": not bool(
            ((pol > 0) & full)[rows].any()),
        "one stone per move": bool(
            (stones == torch.arange(env.max_moves, device=dev)[None])[rows].all()),
        "stones obey gravity": not bool(floating),
        "finite root policies": bool(torch.isfinite(pol).all()),
        "every chunk kernel launched": all(
            launches[k] > 0 for k, v in expect.items() if v),
    }
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail("main-path checks failed")
    steps_per_chunk = M * B
    med = statistics.median(chunk_seconds)
    rate = steps_per_chunk / med
    log(f"[main path] chunk seconds {chunk_seconds}; median {med:.4f} s "
        f"-> {rate:.1f} env-steps/s ({rate * S:.0f} sims/s) at B={B}, S={S}")
    dev_ms = print_profile("one chunk",
                           device_profile(lambda: tr.collect(games_target=0)),
                           med * 1e3)

    # ---- 5. search kernels vs plain versions on a main-path move
    summary.update(chunk_kernels_phase(env, mcfg, tr, gen, dev,
                                       ("connect4", "tictactoe")))

    # ---- 6. the move search (kernel 2) vs its plain version, bitwise
    Bg = cfg.train.gate_games // 2           # each agent's half of the gate
    st6 = with_drawn_game(random_positions(env, Bg, gen, dev), env)
    margs = (st6.board, st6.current_player, st6.move_count, st6.done)
    won6 = st6.done & (st6.winner >= 0)
    drawn6 = st6.done & (st6.winner < 0)
    noise6 = fused.dirichlet_noise(1, A, Bg, mcfg.dirichlet_alpha, gen,
                                   dev)[0].T.contiguous()
    root_stub = lambda o: stub(o.reshape(o.shape[0], -1))  # noqa: E731
    t0 = time.perf_counter()
    got6 = fused.run_mcts_fused(env, None, None, root_stub, *margs, mcfg,
                                noise=noise6, evaluator=stub, device=dev)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    want6 = fused.move_search_reference(env, None, None, root_stub, *margs,
                                        mcfg, noise=noise6, evaluator=stub)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    bad = [k for k in ("visit_counts", "policy", "root_q")
           if not torch.equal(getattr(got6, k), getattr(want6, k))]
    sums6 = got6.visit_counts.sum(-1)
    log(f"[move search] B={Bg} S={S} Dirichlet, exact stub, "
        f"{int((~st6.done).sum())} live / {int(won6.sum())} won / "
        f"{int(drawn6.sum())} drawn roots: mismatched {bad or 'none'}; "
        f"kernel search {t_kern:.2f} s, plain search {t_plain:.2f} s")
    if bad:
        fail(f"move search kernels differ from the plain search in {bad}")
    checks = {
        "live roots count S-1 visits": bool(
            (sums6[~st6.done] == S - 1).all()),
        "finished roots count none": bool((sums6[st6.done] == 0).all()),
        "won roots back up their win: root Q (S-1)/S": bool(won6.any()) and bool(
            (got6.root_q[won6] == torch.tensor((S - 1) / S,
                                               device=dev)).all()),
        "the drawn root: root Q 0": bool((got6.root_q[drawn6] == 0).all()),
    }
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail("move search checks failed")

    # az_move_root_init and az_root_counts on a main-path snapshot: the
    # gate's half batch, the trainer's weights, the real forward
    ms6, err_b128 = move_kernels_phase(env, mcfg, tr.model, tr.params_best,
                                       margs, noise6, dev, ("connect4",))
    summary.update(ms6)
    fwd = summary["az_dense_forward"]
    fwd["max_abs_err_by_batch"] = {str(B): fwd["max_abs_err"],
                                   str(Bg): err_b128}
    fwd["max_abs_err"] = max(fwd["max_abs_err"], err_b128)
    # ---- 7. the main path's outer iteration
    tr7 = Trainer(cfg, device="cuda", logger=MetricsLogger(stdout=False))
    init7 = {k: v.clone() for k, v in tr7.params_best.items()}
    trace, split, graphs = [], {}, {}

    launch_counts = counted_phases(tr7, ("collect", "train_epoch", "gate"),
                                   fused.KERNELS, split, graphs)

    def traced_run_mcts(env_, eval_fn, boards, players, mcs, dones, cfg_,
                        **kw):
        res = run_mcts(env_, eval_fn, boards, players, mcs, dones, cfg_, **kw)
        trace.append((dones, res.visit_counts))
        return res

    arena.run_mcts = traced_run_mcts
    for k in fused.KERNELS:
        k.launches = 0
    try:
        it = tr7.iterate(vanilla_eval=False)
    finally:
        arena.run_mcts = run_mcts
    launches7 = launch_counts()
    chunks7 = len(it["chunk_seconds"])
    searches = 2 * env.max_moves             # both agents, every gate move
    gate_launches = move_search_launches(searches, S, graphs["gate"])
    collect7 = chunk_launches(chunks7, M, S, graphs["collect"])
    expect7 = {name: collect7[name] + gate_launches.get(name, 0)
               for name in launches7}
    log(f"[iterate] Trainer(preset('connect4')).iterate(vanilla_eval=False): "
        f"launches {launches7}; measured per phase {split}")
    if launches7 != expect7:
        fail(f"launch counts {launches7} != expected {expect7}")
    if set(split) != {"collect", "train_epoch", "gate"} or any(
            sum(split[p][n] for p in split) != launches7[n]
            for n in launches7):
        fail("the per-phase launch counts do not add up to the total")
    if split["gate"] != {n: gate_launches.get(n, 0) for n in launches7} \
            or any(split["train_epoch"].values()):
        fail(f"gate launches {split['gate']} != expected {gate_launches}, "
             f"or the learner launched a search kernel")
    steps_rate = it["steps"] / it["train_seconds"]
    log(f"[iterate] collect {it['collect_seconds']:.3f} s ({chunks7} chunks, "
        f"{it['games']} games, {it['env_steps']} env-steps); train "
        f"{it['train_seconds']:.3f} s ({it['steps']} steps of batch "
        f"{cfg.train.batch_size}, {steps_rate:.1f} steps/s, loss "
        f"{it['loss']:.4f}); gate {it['gate_seconds']:.3f} s "
        f"({env.max_moves} moves, {cfg.train.gate_games} games, score "
        f"{tr7.last_gate_score}, rate {it['gate_rate']}, accepted "
        f"{it['accepted']}); gate launches {split['gate']}")

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    if it["accepted"]:
        kept = (tr7.version == 1 and tr7.reject_count == 0
                and same(tr7.params_best, tr7.params_new)
                and not same(tr7.params_best, init7))
    else:
        kept = (tr7.version == 0 and tr7.reject_count == 1
                and same(tr7.params_new, init7)
                and same(tr7.params_best, init7))
    checks = {
        "gate score sums to the game count": sum(
            tr7.last_gate_score[:2]) == cfg.train.gate_games,
        "every gate search recorded": len(trace) == searches,
        "gate: live roots count S-1 visits": all(
            bool((c.sum(-1)[~d] == S - 1).all()) for d, c in trace),
        "gate: finished roots count none": all(
            bool((c.sum(-1)[d] == 0).all()) for d, c in trace),
        "train steps = buffer rows // batch": it["steps"] == max(
            it["buffer_size"] // cfg.train.batch_size, 1),
        "finite losses": all(math.isfinite(it[k]) for k in (
            "loss", "policy_loss", "value_loss", "l2")),
        "promote/revert bookkeeping": kept,
        "every kernel launched": all(v > 0 for v in launches7.values()),
    }
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    if not all(checks.values()):
        fail("iteration checks failed")

    # one gate move, both agents (B=128 each), profiled
    st7 = random_positions(env, cfg.train.gate_games, gen, dev)
    agents = (make_eval_fn(tr7.model, tr7.params_best),
              make_eval_fn(tr7.model, tr7.params_new))
    halves = (slice(0, Bg), slice(Bg, None))

    def gate_move():
        for fn, sl in zip(agents, halves):
            run_mcts(env, fn, st7.board[sl], st7.current_player[sl],
                     st7.move_count[sl], st7.done[sl], mcfg, generator=gen,
                     device=dev)

    gate_move()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gate_move()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    gate_ms = print_profile(f"one gate move (2 x B={Bg})",
                            device_profile(gate_move), wall_ms)

    # ---- 8. the per-simulation engine (kernels 3 and 4)
    summary.update(sim_phase(gen, dev))

    # ---- 9. the connect4-resnet outer iteration
    split9, total9, it9, sp_ms9, gate_ms9, sp_wall9, gate_wall9 = \
        resnet_iterate_phase(gen, dev)

    # ---- 10. the fused ResNet tower behind the port's CLI
    summary10, split10, total10, path10 = fused_resnet_phase(gen, dev)

    # ---- 11. the dense tower's searches off connect4 (gomoku9-dense)
    path11, kern11, total11, split11, chunk_us11, gate_us11 = \
        dense_games_phase(gen, dev)

    # ---- 12. the ViT and the gomoku7-reference preset
    path12, step12, flush12, split12, total12, move_ms12 = vit_phase(gen,
                                                                     dev)

    # ---- 13. multi-process training
    path13, split13 = mesh_phase(dev, {int(b) for b in by_batch},
                                 chunk_held)

    # ---- 14. train to strength: the validate_learning recipe
    path14, split14 = strength_phase(dev)

    def strength_path(kname):
        return {"tictactoe-validate_learning": {
            "launches": sum(split14[p][kname] for p in split14),
            **{f"launches_{p}": split14[p][kname] for p in split14}}}

    kernels = []
    for k in fused.KERNELS:
        s = summary[k.name]
        new = k.name in ("az_move_root_init", "az_root_counts")
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": s.get("source", "alphazero_tpu_torch/csrc/search.cu"),
            "replaces": REPLACES_MOVE if new else REPLACES,
            "launches": launches7[k.name],
            "launches_collect": split["collect"][k.name],
            "launches_gate": split["gate"][k.name],
            "max_abs_err": s["max_abs_err"],
            **({"max_abs_err_by_batch": s["max_abs_err_by_batch"]}
               if "max_abs_err_by_batch" in s else {}),
            "ms": (gate_ms if new else dev_ms).get(k.name),
            "gate_ms": gate_ms.get(k.name), "call_ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "games": ["connect4", "tictactoe", "gomoku9"],
            **{f: s[f] for f in ("geometry", "device_ms", "launch_floor_ms")
               if f in s},
            **({"eager_forward_ms": {
                f"connect4 B={Bx}": s["by_batch"][str(Bx)]["eager_device_ms"]
                for Bx in (B, Bg)} | {
                f"gomoku9-dense B={Bx}":
                    path11["forward"]["gomoku9"][str(Bx)]["eager_device_ms"]
                    for Bx in (path11["batch"], Bg)}}
               if k.name == "az_dense_forward" else {}),
            "by_path": {"gomoku9-dense": {
                "launches": total11[k.name],
                "launches_collect": split11["collect"][k.name],
                "launches_gate": split11["gate"][k.name],
                "ms": (gate_us11 if new else chunk_us11).get(k.name),
                "gate_ms": gate_us11.get(k.name),
                "call_ms": kern11[k.name]["ms"],
                **{f: kern11[k.name][f] for f in (
                    "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                    "geometry", "device_ms", "launch_floor_ms")
                    if f in kern11[k.name]}},
                "mesh_connect4_data2_rank0": {
                    "launches_collect": split13["collect"][k.name],
                    "launches_gate": split13["gate"][k.name]}}
            | strength_path(k.name)})
    for k in sim.KERNELS:
        s = summary[k.name]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": "alphazero_tpu_torch/csrc/sim.cu",
            "replaces": REPLACES_SIM[k.name],
            "launches": total9[k.name],
            "launches_collect": split9["collect"][k.name],
            "launches_gate": split9["gate"][k.name],
            "max_abs_err": s["max_abs_err"],
            "ms": sp_ms9.get(k.name),
            "gate_ms": gate_ms9.get(k.name), "call_ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "games": ["connect4", "tictactoe", "gomoku7", "gomoku9",
                      "gomoku15"],
            "geometry": s["geometry"], "by_cell": s["by_cell"] | {
                "gomoku7-reference B=256": (step12 if k.name == "az_sim_step"
                                            else flush12)},
            "by_path": {"gomoku7-reference": {
                "launches": total12[k.name],
                "launches_collect": split12["collect"][k.name],
                "ms": move_ms12.get(k.name)}} | strength_path(k.name)})
    s = summary10["az_resnet_tower"]
    kernels.append({
        "name": "az_resnet_tower", "route": "cuda",
        "source": "alphazero_tpu_torch/csrc/resnet_tower.cu",
        "replaces": REPLACES_TOWER,
        "launches": total10["az_resnet_tower"],
        "launches_collect": split10["collect"]["az_resnet_tower"],
        "launches_gate": split10["gate"]["az_resnet_tower"],
        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
        "gate_ms": s["gate_ms"], "call_ms": s["call_ms"],
        "plain_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
        "library_ms": None, "games": ["connect4", "gomoku9"],
        "eager_forward_ms": s["eager_forward_ms"],
        "by_shape": s["by_shape"],
        "by_path": strength_path("az_resnet_tower")})
    log(json.dumps({"main_path": {
        "preset": "connect4", "batch": B, "num_simulations": S,
        "chunk_moves": M, "chunk_seconds": chunk_seconds,
        "env_steps_per_s": rate, "iterate": {
            k: it[k] for k in ("collect_seconds", "train_seconds",
                               "gate_seconds", "steps", "games", "loss",
                               "gate_rate", "accepted")},
        "train_steps_per_s": steps_rate, "gate_score": tr7.last_gate_score,
        "gate_move_ms": wall_ms}}))
    log(json.dumps({"resnet_path": {
        "preset": "connect4-resnet", "iterate": {
            k: it9[k] for k in ("collect_seconds", "train_seconds",
                                "gate_seconds", "steps", "games",
                                "env_steps", "env_steps_per_s", "loss",
                                "gate_rate", "accepted", "chunk_seconds")},
        "launches_by_phase": split9, "selfplay_move_ms": sp_wall9,
        "gate_move_ms": gate_wall9}}))
    log(json.dumps({"fused_resnet_path": path10}))
    log(json.dumps({"gomoku9_dense_path": path11}))
    log(json.dumps({"vit_path": path12}))
    log(json.dumps({"mesh_path": path13}))
    log(json.dumps({"strength": path14}))
    log(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(*sys.argv[2:])
    else:
        main()
