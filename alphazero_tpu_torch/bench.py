"""Self-play throughput of every preset the port runs, on one GPU.

Counterpart of the repository's root ``bench.py`` (which benchmarks the JAX
package).  Run ``python -m alphazero_tpu_torch bench``.  It prints one JSON
line per preset (connect4, tictactoe, connect4-resnet, gomoku9-dense,
gomoku9, gomoku15)
with env-steps/s (the median of 3 timed windows and their spread), sims/s
and the model's forward FLOP/s, each line naming the card, then the
headline line last:

  {"metric": "connect4_selfplay_env_steps_per_s", "value": N, ...}

Every timed window ends in ``torch.cuda.synchronize()``.  The headline runs
first; a wall-clock budget (``AZ_BENCH_BUDGET_S``, default 1500 s) guards
the other presets, which are reported as skipped when it is spent, and
``AZ_BENCH_CONFIGS`` (comma-separated) picks a subset of them.
With ``AZ_FUSED_RESNET=1`` the CLI runs the ResNet presets on the fused
tower.
The weights are random (seed 0).  There is no CPU mode: without CUDA it
raises.
"""

from __future__ import annotations

import json
import os
import time

import torch

from alphazero_tpu_torch.config import preset
from alphazero_tpu_torch.data import create
from alphazero_tpu_torch.device import resolve_device
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import build_model, init_params
from alphazero_tpu_torch.training.selfplay import (init_selfplay,
                                                   make_selfplay_runner)

BASELINE_ENV_STEPS_PER_S = 100_000.0   # the north-star target of the root bench


def _model_flops_per_pos(cfg, env) -> float:
    """Rough forward FLOPs per position (matmul/conv MACs × 2), as the root
    bench counts them."""
    m = cfg.model
    RC = env.rows * env.cols
    if m.family == "dense":
        L = len(env.lines)
        d_in = env.feature_dim * RC + 2 * L
        f = d_in * m.width + 2 * m.blocks * m.width * m.width \
            + m.width * (env.action_dim + m.width // 4)
        return 2.0 * f
    if m.family == "resnet":
        f = 9 * env.feature_dim * m.channels * RC \
            + m.blocks * 2 * 9 * m.channels * m.channels * RC \
            + 2 * m.channels * RC + 32 * RC
        return 2.0 * f
    E, D = m.embed_dim, m.depth
    T = RC + 1
    f = (m.patch_size ** 2) * env.feature_dim * E * RC \
        + D * (4 * E * E * T + 2 * T * T * E + 8 * E * E * T)
    return 2.0 * f


def bench_config(name: str, steps_per_chunk: int, chunks: int,
                 fused_resnet: bool = False, device="cuda") -> dict:
    """Env-steps/s of ``preset(name)``'s self-play at its batch: one
    warm-up chunk, then 3 windows of ``chunks`` chunks of
    ``steps_per_chunk`` moves; the median window and the spread."""
    dev = resolve_device(device)
    cfg = preset(name)
    env = make_env(cfg.env)
    model = build_model(cfg.model, env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    B = cfg.train.selfplay_batch
    runner = make_selfplay_runner(env, model, cfg.mcts, cfg.replay,
                                  steps_per_chunk, fused_resnet)
    sp = init_selfplay(env, B, 1, dev)
    buffer = create(env, cfg.replay.capacity, dev)
    sp, buffer = runner(params, sp, buffer)
    torch.cuda.synchronize(dev)
    reps, rates, total = 3, [], 0.0
    env_steps = chunks * steps_per_chunk * B
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chunks):
            sp, buffer = runner(params, sp, buffer)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        rates.append(env_steps / dt)
        total += dt
    rates.sort()
    steps_per_s = rates[reps // 2]
    sims_per_s = steps_per_s * cfg.mcts.num_simulations
    return {
        "config": name,
        "env_steps_per_s": round(steps_per_s, 1),
        "spread_env_steps_per_s": [round(rates[0], 1), round(rates[-1], 1)],
        "sims_per_s": round(sims_per_s, 1),
        "batch": B,
        "sims_per_move": cfg.mcts.num_simulations,
        "model_tflops_per_s": round(
            sims_per_s * _model_flops_per_pos(cfg, env) / 1e12, 2),
        "seconds": round(total, 2),
        "fused_resnet": bool(fused_resnet and cfg.model.family == "resnet"),
        "device": torch.cuda.get_device_name(dev),
    }


def main(fused_resnet: bool = False, device="cuda"):
    """The bench; the CLI passes ``fused_resnet`` from ``AZ_FUSED_RESNET``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures a GPU; it has no CPU mode")
    budget = float(os.environ.get("AZ_BENCH_BUDGET_S", "1500"))
    only = os.environ.get("AZ_BENCH_CONFIGS")
    t_start = time.perf_counter()

    headline = bench_config("connect4", 32, 6, fused_resnet, dev)
    print(json.dumps(headline), flush=True)
    secondary = [
        ("tictactoe", 32, 3),
        ("connect4-resnet", 8, 3),
        ("gomoku9-dense", 8, 3),
        ("gomoku9", 2, 2),
        ("gomoku15", 1, 2),
    ]
    for name, spc, chunks in secondary:
        if only and name not in only.split(","):
            continue
        if time.perf_counter() - t_start > budget:
            print(json.dumps({"config": name, "skipped": "budget"}),
                  flush=True)
            continue
        print(json.dumps(bench_config(name, spc, chunks, fused_resnet, dev)),
              flush=True)
    print(json.dumps({
        "metric": "connect4_selfplay_env_steps_per_s",
        "value": headline["env_steps_per_s"],
        "unit": "env_steps/s",
        "vs_baseline": round(headline["env_steps_per_s"]
                             / BASELINE_ENV_STEPS_PER_S, 4),
        "device": headline["device"],
    }), flush=True)
