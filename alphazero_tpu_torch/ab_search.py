"""A/B timing of the dense searches' walk kernels of two checkouts on one GPU.

Run it once per checkout, in turns (parent, change, change, parent), on
one card:

    python alphazero_tpu_torch/ab_search.py PATH_TO_CHECKOUT

For the package under ``PATH_TO_CHECKOUT`` it builds ``csrc/search.cu``
and makes self-play trees from seeded random positions, for ``connect4``
at its S=200 with B=512 (self-play) and B=128 (the gate), and for
``gomoku9-dense`` at its S=400 with B=256 and B=128; it runs the first S/2
simulations under the exact stub evaluator and prints the device time of
``az_descend_leaf`` and ``az_apply`` at slot S/2: CUDA events around 200
launches queued behind a sleep kernel, so that they time the card and not
the host.
"""

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
            state = env.init(B, dev)
            target = torch.randint(0, 30, (B,), generator=gen, device=dev)
            for t in range(30):                  # random play, own lengths
                mask = env.valid_mask(state) & (t < target)[:, None]
                noise = torch.rand(mask.shape, generator=gen, device=dev)
                act = torch.where(mask, noise, -1.0).argmax(-1).to(
                    torch.int32)
                nxt = env.step(state, act)
                live = mask.any(-1)
                for k in vars(state):
                    old, new = getattr(state, k), getattr(nxt, k)
                    sel = live.reshape((B,) + (1,) * (old.dim() - 1))
                    setattr(state, k, torch.where(sel, new, old))
            live = ~state.done
            board = torch.where(live[:, None, None, None], state.board, 0
                                ).contiguous()
            player = torch.where(live, state.current_player, 0).contiguous()
            mc = torch.where(live, state.move_count, 0).contiguous()
            tree = fused.Tree(env, B, S, dev)
            obs = env.observation_from_board(board, player).reshape(B, -1)
            p, v = stub(obs.contiguous())
            noise = fused.dirichlet_noise(1, env.action_dim, B,
                                          cfg.dirichlet_alpha, gen, dev)[0]
            fused.root_init(env, cfg, tree, p, v, noise, board)
            for slot in range(1, half):
                fused.descend_leaf(env, cfg, tree, board, player, mc, slot)
                fused.apply(tree, slot, *stub(tree.obs))
            d_ms = device_ms(lambda: fused.descend_leaf(
                env, cfg, tree, board, player, mc, half), 200)
            fused.descend_leaf(env, cfg, tree, board, player, mc, half)
            p, v = stub(tree.obs)
            a_ms = device_ms(lambda: fused.apply(tree, half, p, v), 200)
            out[f"{name} B={B}"] = {"az_descend_leaf_us": d_ms and d_ms * 1e3,
                                    "az_apply_us": a_ms and a_ms * 1e3}
    print(f"{fused.__file__}: {out}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
