"""Self-play traffic: ``Trainer.collect`` called again and again, nothing
else (no learner, no gate).

Set-up builds the trainer with the run's weights and warms
``warm_calls`` calls.  The window runs from the first timed call's start
to the end of the first call that ends after ``--seconds``; every call ends
in a device synchronisation, and ``selfplay_env_steps_per_s`` is all the
env-steps completed in the window over its seconds.  With ``--trace 1``
one more call of the runner the window drove is profiled after the
window: the trainer's own whole chunk, for the whole-chunk search; for the
move-by-move engine, whose 32-move chunk takes a trace too long to read,
the program's self-play runner of ``profile_moves`` moves, the same step
at the cell's batch, called once untraced first.

The check, once the window has closed: every game block in the replay
ring by the rules (:func:`check.ring_bad`); then more moves of the engine
the window ran, from the trainer's state, with root noise and action
draws made by the benchmark from the seed and handed in through the
program's own arguments.  Each move's records follow the rules and its
engine's action rule exactly (``records_bad``).

* The whole-chunk search (``search.fused.run_selfplay_chunk``, one chunk
  of the trainer's length): the visit distributions of ``check_moves`` of
  its moves, drawn from the seed, lie within ``visit_tv`` of the float32
  reference search's.
* The move-by-move step (``training.selfplay.selfplay_step``,
  ``check_moves`` steps): each search followed from its own recorded
  forwards gives the reference search's visit counts exactly
  (``search_bad``), and those forwards lie within ``logit_gap`` of the
  reference's.
"""

from __future__ import annotations

import sys
import time

import torch

from azbench import check, harness, trace
from azbench.harness import Run


class _Records:
    """A ``MetricsLogger`` that keeps the records in memory."""

    def __init__(self):
        self.records = []

    def log(self, kind, **fields):
        self.records.append({"kind": kind, **fields})

    def close(self):
        pass


def run(r: Run):
    from alphazero_tpu_torch.search.fused import supports_chunk
    from alphazero_tpu_torch.training import loop, selfplay
    tr = r.cell.traffic
    cfg = harness.port_config(r)
    log = _Records()
    trainer = loop.Trainer(cfg, device=r.device, logger=log,
                           persist_config=False)
    params = harness.weights(r, trainer.model)
    trainer.params_best = params
    trainer.params_new = {k: v.clone() for k, v in params.items()}
    games = tr["games_per_collect"]
    for _ in range(tr["warm_calls"]):
        trainer.collect(games)
    log.records.clear()
    t0 = r.window_opens()
    steps = calls = 0
    while True:
        steps += trainer.collect(games)["env_steps"]
        calls += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    window_s = time.perf_counter() - t0
    r.window_closed()
    r.e2e["selfplay_env_steps_per_s"] = steps / window_s
    chunks = [c for rec in log.records if rec["kind"] == "collect"
              for c in rec["chunk_seconds"]]
    S = cfg.mcts.num_simulations
    M = cfg.train.selfplay_chunk_steps or loop.SELFPLAY_CHUNK_STEPS
    B = cfg.train.selfplay_batch
    r.data.update(chunk_seconds=chunks, window_s=window_s, env_steps=steps,
                  forwards=steps * S, batch=B)
    print(f"azbench: window {window_s:.4f} s, {steps} env-steps, {calls} "
          f"calls, chunks {[round(c, 4) for c in chunks]}", file=sys.stderr)
    chunk = supports_chunk(trainer.env, trainer.model, cfg.mcts)
    if r.trace:
        runner = trainer._runner
        if not chunk:
            runner = selfplay.make_selfplay_runner(
                trainer.env, trainer.model, cfg.mcts, cfg.replay,
                tr["profile_moves"])

        def moves():
            trainer.sp, trainer.buffer = runner(
                trainer.params_best, trainer.sp, trainer.buffer)
        if not chunk:
            moves()
        r.profile = trace.profile(moves, r.device)
    g = r.game
    # every chunk of the window completes M moves of all B games
    lost = len(chunks) * M * B - steps
    ring_n, ring_wrong = check.ring_bad(g, trainer.buffer, S)
    moves = (_chunk_moves if chunk else _step_moves)(r, trainer, params, M)
    del trainer
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    n, wrong, roots = moves
    r.attempted = ring_n + n
    r.failed = ring_wrong + wrong + abs(lost)
    r.check("records_bad", ring_wrong + wrong + abs(lost))
    net = r.net(params)
    if chunk:
        dists = []
        for k in harness.sample(r, 3, len(roots), tr["check_moves"]):
            board, player, mc, noise, policy = roots[k]
            ref = check.reference_policy(g, net, board, player, mc, r.mcts,
                                         noise=noise, quantize=True)
            dists.append(check.tv(policy, ref))
        r.check("visit_tv", float(torch.cat(dists).mean()))
        return
    # the move-by-move engine: each search followed from the program's own
    # forwards, and those forwards against the reference's
    diff, errs = 0, []
    for board, player, mc, noise, policy, calls in roots:
        replay = check.Replay(calls)
        ref = check.reference_policy(g, replay, board, player, mc, r.mcts,
                                     noise=noise)
        diff += int((((policy - ref).abs().max(-1).values > 0)
                     | (replay.mismatch > 0)).sum())
        errs.extend(check.logit_gaps(net, calls))
    r.failed += diff
    r.check("search_bad", diff)
    r.check("logit_gap", float(torch.cat(errs).mean()))


def _control_eval(r: Run, params, flat: bool):
    net = r.net(params, r.control)
    g = r.game
    if not flat:
        return net
    return lambda obs: net(obs.reshape(obs.shape[0], g.feature_dim, g.rows,
                                       g.cols))


def _chunk_moves(r: Run, trainer, params, M: int):
    """One whole chunk from the trainer's state, with the benchmark's
    noise and uniforms: ``(moves, wrong, [(board, player, mc, noise,
    policy)] per move)``."""
    from alphazero_tpu_torch.search import fused
    s = trainer.sp.env_state
    mcts = trainer.cfg.mcts
    B, A = s.board.shape[0], trainer.env.action_dim
    noise = harness.dirichlet(r, 1, (M, B, A), mcts.dirichlet_alpha)
    unif = torch.rand((M, B), generator=r.generator(2), device=r.device)
    start = (s.board.clone(), s.current_player.clone(), s.move_count.clone())
    ev = _control_eval(r, params, True) if r.control else None
    rec = fused.run_selfplay_chunk(
        trainer.env, trainer.model, params, *start, mcts, M,
        noise=noise.permute(0, 2, 1).contiguous(), unif=unif, evaluator=ev,
        device=r.device)
    r.sync()
    g = r.game
    n, wrong = check.chunk_bad(g, start, rec, unif, mcts.num_simulations,
                               mcts.temperature_moves)
    roots = []
    for m in range(M):
        player = rec["player"][m]
        board = g.board_from_observation(rec["obs"][m].float(), player)
        roots.append((board, player, rec["t"][m], noise[m], rec["policy"][m]))
    return n, wrong, roots


def _step_moves(r: Run, trainer, params, M: int):
    """``check_moves`` move-by-move steps from the trainer's state, with
    the benchmark's noise and action draws; each root also keeps the
    evaluator's calls of its search (:class:`check.Recorder`)."""
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.training.selfplay import selfplay_step
    mcts = trainer.cfg.mcts
    sp, buf = trainer.sp, trainer.buffer
    B, A = sp.t.shape[0], trainer.env.action_dim
    ev = check.Recorder(_control_eval(r, params, False) if r.control
                        else make_eval_fn(trainer.model, params))
    g = r.game
    n = wrong = 0
    roots = []
    for k in range(r.cell.traffic["check_moves"]):
        noise = harness.dirichlet(r, 10 + k, (B, A), mcts.dirichlet_alpha)
        gum = harness.gumbel(r, 1000 + k, (B, A))
        s = sp.env_state
        nxt, buf = selfplay_step(trainer.env, ev, mcts, sp, buf, noise=noise,
                                 gumbel=gum)
        policy = nxt.traj_policy[torch.arange(B, device=r.device),
                                 sp.t.long()]
        wrong += check.step_bad(
            g, (s.board, s.current_player, sp.t),
            (nxt.env_state.board, nxt.env_state.current_player, nxt.t),
            policy, gum, mcts.num_simulations, mcts.temperature_moves)
        n += B
        roots.append((s.board, s.current_player, s.move_count, noise,
                      policy, ev.take()))
        sp = nxt
    r.sync()
    return n, wrong, roots
