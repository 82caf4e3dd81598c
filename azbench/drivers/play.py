"""Play traffic: a human against the agent, one game at a time, as ``play``
runs it (``eval/play.py``): each agent move is ``agent_move`` on a batch
of one game, ``verbose=False``, root noise off; the "human" plays a legal
move drawn from the seed with no think time; a finished game restarts,
the human's side drawn from the seed.

``move_ms_p95`` is the 95th percentile of every agent move of the window,
each timed on the host from the call to the returned action (which waits
for the card).  Set-up warms ``warm_moves`` agent moves; with ``--trace 1``
``profile_moves`` more are profiled after the window.

The check, once the window has closed: every move of the window (human and
agent) by the rules; ``check_moves`` agent moves drawn from the seed
searched again at batch one as ``agent_move`` searches (``run_mcts_fused``
with the dense kernel's own forward, every forward recorded), whose first
most-visited action must be the one played (``records_bad``); each search
followed from its recorded forwards gives the reference search's visit
counts exactly (``search_bad``), and the forwards lie within ``logit_gap``
of the reference's.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time

import numpy as np
import torch

from azbench import check, harness, trace
from azbench.reference import search
from azbench.harness import Run


def run(r: Run):
    from alphazero_tpu_torch.envs import EnvState, make_env
    from alphazero_tpu_torch.eval.play import agent_move
    from alphazero_tpu_torch.models import build_model, make_eval_fn
    tr = r.cell.traffic
    cfg = harness.port_config(r)
    env = make_env(cfg.env)
    model = build_model(cfg.model, env).to(r.device)
    params = harness.weights(r, model)
    eval_fn = make_eval_fn(model, params)
    mcfg = dataclasses.replace(cfg.mcts, use_dirichlet=False)
    gen = r.generator(5)
    human = random.Random(r.sub_seed(6))
    g = r.game
    st = {"state": env.init(1, r.device), "human": human.randrange(2)}
    # (board, player, moves, action, board after, done after, agent?)
    log = []

    def ply(latencies=None):
        s = st["state"]
        agent = int(s.current_player[0]) != st["human"]
        if agent:
            t = time.perf_counter()
            a = agent_move(env, eval_fn, s, gen, mcfg, verbose=False)
            if latencies is not None:
                latencies.append(time.perf_counter() - t)
        else:
            legal = torch.nonzero(env.valid_mask(s)[0]).reshape(-1).tolist()
            a = human.choice(legal)
        nxt = env.step(s, torch.tensor([a], dtype=torch.int32,
                                       device=r.device))
        done = bool(nxt.done[0])
        # kept on the host: the window's record holds no device tensors
        log.append((s.board[0].cpu().numpy(), int(s.current_player[0]),
                    int(s.move_count[0]), a, nxt.board[0].cpu().numpy(),
                    done, agent))
        if done:
            nxt = env.init(1, r.device)
            st["human"] = human.randrange(2)
        st["state"] = nxt
        return agent

    def moves(n, latencies=None):
        done = 0
        while done < n:
            done += ply(latencies)

    moves(tr["warm_moves"])
    log.clear()
    lat = []
    launches0 = harness.kernel_launches() if r.device.type == "cuda" else 0
    t0 = r.window_opens()
    while True:
        agent = ply(lat)
        if agent and time.perf_counter() - t0 >= r.seconds:
            break
    window_s = time.perf_counter() - t0
    launches = (harness.kernel_launches() - launches0
                if r.device.type == "cuda" else None)
    r.window_closed()
    r.e2e["move_ms_p95"] = harness.quantile(lat, 0.95) * 1e3
    print(f"azbench: window {window_s:.4f} s, {len(lat)} agent moves, p50 "
          f"{harness.quantile(lat, 0.5) * 1e3:.3f} ms, p95 "
          f"{r.e2e['move_ms_p95']:.3f} ms", file=sys.stderr)
    r.data.update(latencies=lat, window_s=window_s, launches=launches,
                  moves=len(lat))
    window_log = list(log)
    if r.trace:
        r.profile = trace.profile(lambda: moves(tr["profile_moves"]),
                                  r.device)
    # every move of the window by the rules
    dev = r.device
    cols = list(zip(*window_log))
    boards = torch.as_tensor(np.stack(cols[0]), device=dev)
    player = torch.tensor(cols[1], device=dev)
    mc = torch.tensor(cols[2], device=dev)
    acts = torch.tensor(cols[3], device=dev)
    after = torch.as_tensor(np.stack(cols[4]), device=dev)
    done = torch.tensor(cols[5], device=dev)
    legal = g.legal(boards).gather(1, acts[:, None])[:, 0]
    nxt = g.play(boards, player, acts)
    ends = g.won(nxt, player) | (mc + 1 >= g.max_moves)
    wrong = int((~legal | (after != nxt).flatten(1).any(-1)
                 | (done != ends)).sum())
    # agent moves searched again, and against the reference
    agent = [k for k, row in enumerate(window_log) if row[6]]
    picked = [agent[k] for k in harness.sample(r, 7, len(agent),
                                               tr["check_moves"])]
    sb, sp, sm = boards[picked], player[picked], mc[picked]
    counts, calls = [], []
    for i, k in enumerate(picked):
        s = EnvState(board=sb[i:i + 1], current_player=sp[i:i + 1].int(),
                     move_count=sm[i:i + 1].int(),
                     winner=torch.full((1,), -1, dtype=torch.int32,
                                       device=dev),
                     done=torch.zeros((1,), dtype=torch.bool, device=dev))
        c, rec = _search(r, env, model, params, eval_fn, s, mcfg, gen)
        counts.append(c)
        calls.append(rec)
        wrong += int(int(c[0].cpu().argmax()) != window_log[k][3])
    del model, eval_fn
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    prog = torch.cat(counts).float()
    # the searches of the picked moves as one batch: call j of every move
    batch = [tuple(torch.cat(x) for x in zip(*step)) for step in zip(*calls)]
    replay = check.Replay(batch)
    ref = search.search(g, replay, sb, sp, sm, r.mcts["num_simulations"],
                        r.mcts["formula"], r.mcts["c_puct"], quantize=True)
    search_bad = int(((prog != ref).any(-1) | (replay.mismatch > 0)).sum())
    gaps = check.logit_gaps(r.net(params), batch)
    r.attempted = len(window_log) + len(picked)
    r.failed = wrong + search_bad
    r.check("records_bad", wrong)
    r.check("search_bad", search_bad)
    r.check("logit_gap", float(torch.cat(gaps).mean()))


def _search(r: Run, env, model, params, eval_fn, s, mcfg, gen):
    """The agent's search of state ``s`` as ``agent_move`` runs it
    (``run_mcts`` → ``run_mcts_fused``, the root on ``eval_fn``, the
    simulations on the dense kernel), every forward recorded: ``(root
    visit counts (1, A), [(obs, probs, value)] per forward)``.  With
    ``--control`` the reference in the control's precision takes both
    forwards' place."""
    from alphazero_tpu_torch.search import fused
    g = r.game
    if r.control:
        net = r.net(params, r.control)
        root = check.Recorder(net)

        def sims(obs):
            return net(obs.reshape(obs.shape[0], g.feature_dim, g.rows,
                                   g.cols))
    else:
        packed = fused.pack_dense_params(model, params, r.device)
        root = check.Recorder(eval_fn)

        def sims(obs):
            return fused.dense_forward(obs, packed)
    leaf = check.Recorder(sims, root.calls)
    res = fused.run_mcts_fused(env, model, params, root, s.board,
                               s.current_player, s.move_count, s.done, mcfg,
                               generator=gen, evaluator=leaf, device=r.device)
    return res.visit_counts, root.take()
