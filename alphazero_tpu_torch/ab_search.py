"""A/B timing of the search kernels of two checkouts on one GPU.

Run it once per checkout, in turns (parent, change, change, parent), on
one card:

    python alphazero_tpu_torch/ab_search.py PATH_TO_CHECKOUT

For the package under ``PATH_TO_CHECKOUT`` it builds ``csrc/search.cu``
and ``csrc/sim.cu`` and makes search trees from seeded random positions.
The dense searches: ``connect4`` at its S=200 with B=512 (self-play) and
B=128 (the gate), and ``gomoku9-dense`` at its S=400 with B=256 and B=128;
it runs the first S/2 simulations under the exact stub evaluator and
prints the device time of ``az_descend_leaf`` and ``az_apply`` at slot
S/2, then runs the rest and prints that of ``az_root_counts`` on the
finished tree (it only reads the tree), of ``az_move_tail`` (each call on
its own copy of the board, player and move count, which it steps), of
``az_root_obs`` and of a move's end: the tail and the next move's root
observation.  Where the package's tail writes that observation itself (a
``rec_obs_next`` argument), ``az_move_tail_us`` and ``move_end_us`` are
that tail, timed twice (two samples of one number), and
``az_move_tail_last_us`` the tail of a chunk's last move, which writes
none; else ``az_move_tail_us`` is the tail and ``move_end_us`` each tail
followed by ``az_root_obs`` on its output.  Then it prints the device time
of ``az_root_init`` on the move's root and then of ``az_move_root_init``
from the stub's prior with ``NEG`` on about 20% of actions and on the
finished games, the stub's value and ``live = ~done`` (both idempotent:
the same inputs, the same writes).  It also prints ``launch_floor_us``,
the device time of ``torch.cuda._sleep(0)`` (a one-thread kernel that
spins for no cycles) in the same harness.  The per-simulation engine:
``connect4-resnet`` (S=200) at B=512 and B=128, ``tictactoe`` (S=50) at
B=256, ``gomoku9`` and ``gomoku15`` (S=400) at B=256, with Dirichlet
noise and the exact stub; it prints the device time of ``az_sim_step``
(the flush of slot S/2 - 1 and the walk of S/2) and of ``az_sim_flush``
(slot S/2).  Times are CUDA events around calls queued behind a sleep
kernel, so that they time the card and not the host: 200 launches of
each dense search kernel (and of the sleep), 10 of each sim kernel,
every one on its own copy of the snapshot (a step may not be repeated on
its own output).
"""

import inspect
import sys


def device_ms(fn, reps):
    """ms per call of ``fn``: ``reps`` calls queued behind a sleep kernel,
    or None when the card reached them before the host had issued them."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        torch.cuda._sleep(50_000_000 * 4 ** attempt)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
    return None


def positions(env, B, gen, dev):
    """B positions of random legal play, each stopped at its own length."""
    import torch
    state = env.init(B, dev)
    target = torch.randint(0, 30, (B,), generator=gen, device=dev)
    for t in range(30):
        mask = env.valid_mask(state) & (t < target)[:, None]
        noise = torch.rand(mask.shape, generator=gen, device=dev)
        act = torch.where(mask, noise, -1.0).argmax(-1).to(torch.int32)
        nxt = env.step(state, act)
        live = mask.any(-1)
        for k in vars(state):
            old, new = getattr(state, k), getattr(nxt, k)
            sel = live.reshape((B,) + (1,) * (old.dim() - 1))
            setattr(state, k, torch.where(sel, new, old))
    return state


def on_copies(fn, snapshot, reps):
    """``fn(copy)`` timed by :func:`device_ms`, every call on its own copy
    of ``snapshot`` (a tuple of objects with ``clone``)."""
    copies = iter([tuple(x.clone() for x in snapshot)
                   for _ in range(1 + 4 * reps)])
    return device_ms(lambda: fn(*next(copies)), reps)


def sim_cells(dev):
    """Device µs of ``az_sim_step`` and ``az_sim_flush`` per cell."""
    import torch

    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.search import fused, sim
    from alphazero_tpu_torch.search.mcts import expand_root
    from alphazero_tpu_torch.search.stub import exact_stub_evaluator
    from alphazero_tpu_torch.search.tree import init_tree
    out = {}
    for name, B in (("connect4-resnet", 512), ("connect4-resnet", 128),
                    ("tictactoe", 256), ("gomoku9", 256), ("gomoku15", 256)):
        cfg = preset(name).mcts
        env = make_env(preset(name).env)
        S, half, A = cfg.num_simulations, cfg.num_simulations // 2, \
            env.action_dim
        stub = exact_stub_evaluator(env)

        def ev(o, stub=stub):
            return stub(o.reshape(o.shape[0], -1))

        gen = torch.Generator(device=dev).manual_seed(B)
        st = positions(env, B, gen, dev)
        noise = fused.dirichlet_noise(1, A, B, cfg.dirichlet_alpha, gen,
                                      dev)[0].T.contiguous()
        tree = init_tree(env, st.board, st.current_player, st.move_count, S)
        expand_root(env, cfg, tree, ev, st.done,
                    torch.ones(B, dtype=torch.bool, device=dev), noise, None)
        ss = sim.SimState.create(env, B, S, dev)
        p = torch.zeros((B, A), device=dev)
        v = torch.zeros((B,), device=dev)
        for slot in range(1, half):
            sim.sim_step(env, cfg, tree, ss, p, v, slot - 1, slot)
            p, v = ev(ss.obs)
        s_ms = on_copies(lambda t, s_: sim.sim_step(
            env, cfg, t, s_, p, v, half - 1, half), (tree, ss), 10)
        sim.sim_step(env, cfg, tree, ss, p, v, half - 1, half)
        p, v = ev(ss.obs)
        f_ms = on_copies(lambda t, s_: sim.flush(env, t, s_, p, v, half),
                         (tree, ss), 10)
        out[f"{name} B={B}"] = {"az_sim_step_us": s_ms and s_ms * 1e3,
                                "az_sim_flush_us": f_ms and f_ms * 1e3}
        del tree, ss
    return out


def main(root):
    sys.path.insert(0, root)
    import torch

    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.search import fused
    from alphazero_tpu_torch.search.stub import exact_stub_evaluator
    dev = torch.device("cuda")
    out = {}
    for name, batches in (("connect4", (512, 128)),
                          ("gomoku9-dense", (256, 128))):
        cfg = preset(name).mcts
        env = make_env(preset(name).env)
        stub = exact_stub_evaluator(env)
        S, half = cfg.num_simulations, cfg.num_simulations // 2
        for B in batches:
            gen = torch.Generator(device=dev).manual_seed(B)
            state = positions(env, B, gen, dev)
            live = ~state.done
            board = torch.where(live[:, None, None, None], state.board, 0
                                ).contiguous()
            player = torch.where(live, state.current_player, 0).contiguous()
            mc = torch.where(live, state.move_count, 0).contiguous()
            tree = fused.Tree(env, B, S, dev)
            obs = env.observation_from_board(board, player).reshape(B, -1)
            p0, v0 = stub(obs.contiguous())
            noise = fused.dirichlet_noise(1, env.action_dim, B,
                                          cfg.dirichlet_alpha, gen, dev)[0]
            fused.root_init(env, cfg, tree, p0, v0, noise, board)
            for slot in range(1, half):
                fused.descend_leaf(env, cfg, tree, board, player, mc, slot)
                fused.apply(tree, slot, *stub(tree.obs))
            d_ms = device_ms(lambda: fused.descend_leaf(
                env, cfg, tree, board, player, mc, half), 200)
            fused.descend_leaf(env, cfg, tree, board, player, mc, half)
            p, v = stub(tree.obs)
            a_ms = device_ms(lambda: fused.apply(tree, half, p, v), 200)
            fused.apply(tree, half, p, v)
            for slot in range(half + 1, S):
                fused.descend_leaf(env, cfg, tree, board, player, mc, slot)
                fused.apply(tree, slot, *stub(tree.obs))
            c_ms = device_ms(lambda: fused.root_counts(tree), 200)
            rec = {k: torch.empty((B, env.action_dim) if k == "policy"
                                  else (B,), dtype=dt, device=dev)
                   for k, dt in fused._REC_TYPES.items()}
            u = torch.rand((B,), generator=gen, device=dev)
            rec_next = torch.empty((B, env.feature_dim, env.rows, env.cols),
                                   dtype=torch.int8, device=dev)
            folded = "rec_obs_next" in inspect.signature(
                fused.move_tail).parameters
            nxt = (rec_next,) if folded else ()
            snap = (board, player, mc)
            t_ms = on_copies(lambda bd, pl, m: fused.move_tail(
                env, cfg, tree, u, bd, pl, m, rec, *nxt), snap, 200)
            if folded:
                e_ms = on_copies(lambda bd, pl, m: fused.move_tail(
                    env, cfg, tree, u, bd, pl, m, rec, rec_next), snap, 200)
                l_ms = on_copies(lambda bd, pl, m: fused.move_tail(
                    env, cfg, tree, u, bd, pl, m, rec), snap, 200)
            else:
                def move_end(bd, pl, m):
                    fused.move_tail(env, cfg, tree, u, bd, pl, m, rec)
                    fused.root_obs(env, bd, pl, rec_next)
                e_ms = on_copies(move_end, snap, 200)
                l_ms = None
            o_ms = device_ms(lambda: fused.root_obs(env, board, player,
                                                    rec_next), 200)
            r_ms = device_ms(lambda: fused.root_init(
                env, cfg, tree, p0, v0, noise, board), 200)
            cut = torch.rand(p0.shape, generator=gen, device=dev) < 0.2
            rp = torch.where(cut | ~live[:, None], fused.NEG, p0)
            m_ms = device_ms(lambda: fused.move_root_init(tree, rp, v0, live),
                             200)
            out[f"{name} B={B}"] = {"az_descend_leaf_us": d_ms and d_ms * 1e3,
                                    "az_apply_us": a_ms and a_ms * 1e3,
                                    "az_root_init_us": r_ms and r_ms * 1e3,
                                    "az_move_tail_us": t_ms and t_ms * 1e3,
                                    "az_move_tail_last_us":
                                        l_ms and l_ms * 1e3,
                                    "move_end_us": e_ms and e_ms * 1e3,
                                    "az_root_obs_us": o_ms and o_ms * 1e3,
                                    "az_root_counts_us": c_ms and c_ms * 1e3,
                                    "az_move_root_init_us":
                                        m_ms and m_ms * 1e3}
    f_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
    out["launch_floor_us"] = f_ms and f_ms * 1e3
    out.update(sim_cells(dev))
    print(f"{fused.__file__}: {out}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
