"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where CUDA is absent.  On a machine with
a GPU run them without the repository's conftest (which needs JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

The kernels build with nvcc into build/alphazero_tpu_torch/ at first use.
"""

import numpy as np
import pytest
import torch

from alphazero_tpu_torch.config import MCTSConfig, ModelConfig
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import build_model, init_params
from alphazero_tpu_torch.search import fused, sim
from alphazero_tpu_torch.search.stub import drawn_board, exact_stub_evaluator

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _positions(env, B, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    boards = (torch.rand((B, 2, env.rows, env.cols), generator=g,
                         device=dev) < 0.25).to(torch.int8)
    boards[:, 1] *= 1 - boards[:, 0]
    players = torch.randint(0, 2, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    return boards, players


@pytest.mark.parametrize("B", [1, 17, 129, 512])
@pytest.mark.parametrize("width", [64, 128, 192, 448, 512])
def test_dense_forward_kernel_close_to_plain(dev, width, B):
    """bf16 products with float32 sums in another order: outputs agree to
    1e-2 at most and 99% of them to 1e-3, at every width the presets and
    tests use (clusters of 1, 2 and 8 CTAs), at clusters of 3 and 7 CTAs
    that do not divide a tile, and at ragged batches."""
    env = make_env("connect4")
    model = build_model(ModelConfig(family="dense", width=width, blocks=2),
                        env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    packed = fused.pack_dense_params(model, params, dev)
    boards, players = _positions(env, B, 1, dev)
    obs = env.observation_from_board(boards, players).reshape(B, -1)
    n0 = fused.K_DENSE.launches
    pk, vk = fused.dense_forward(obs, packed)
    assert fused.K_DENSE.launches == n0 + 1
    pp, vp = fused.dense_forward_reference(obs, packed)
    err = torch.cat([(pk - pp).abs().reshape(-1), (vk - vp).abs()])
    assert bool(torch.isfinite(err).all())
    assert float(err.max()) <= 1e-2
    assert float((err <= 1e-3).float().mean()) >= 0.99
    geo = fused.dense_geometry(B, packed)
    assert geo["cluster"] == width // 64 and geo["max_active_clusters"] >= 1


@pytest.mark.parametrize("width", [96, 1024])
def test_dense_forward_kernel_raises_for_unsupported_width(dev, width):
    env = make_env("connect4")
    model = build_model(ModelConfig(family="dense", width=width, blocks=1),
                        env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    packed = fused.pack_dense_params(model, params, dev)
    obs = torch.zeros((4, 3 * 42), device=dev)
    n0 = fused.K_DENSE.launches
    with pytest.raises(ValueError):
        fused.dense_forward(obs, packed)
    assert fused.K_DENSE.launches == n0


@pytest.mark.parametrize("dirichlet,formula", [(False, "reference"),
                                               (True, "reference"),
                                               (True, "alphazero")])
def test_chunk_kernels_bitwise_vs_plain_chunk(dev, dirichlet, formula):
    env = make_env("connect4")
    cfg = MCTSConfig(num_simulations=32, dirichlet_alpha=0.3,
                     use_dirichlet=dirichlet,
                     temperature_moves=8 if dirichlet else 0,
                     formula=formula, c_puct=1.7)
    B, M = 64, 6
    g = torch.Generator(device=dev).manual_seed(2)
    noise = fused.dirichlet_noise(M, env.action_dim, B, 0.3, g, dev)
    unif = torch.rand((M, B), generator=g, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    boards = torch.zeros((B, 2, env.rows, env.cols), dtype=torch.int8,
                         device=dev)
    kw = dict(noise=noise, unif=unif, evaluator=exact_stub_evaluator(env))
    n_obs, n_tail = fused.K_ROOT_OBS.launches, fused.K_TAIL.launches
    got = fused.run_selfplay_chunk(env, None, None, boards, zeros, zeros, cfg,
                                   M, device=dev, **kw)
    # the first move's root has its own launch, the tails write the rest
    assert fused.K_ROOT_OBS.launches == n_obs + 1
    assert fused.K_TAIL.launches == n_tail + M
    want = fused.selfplay_chunk_reference(env, None, None, boards, zeros,
                                          zeros, cfg, M, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_kernel_wrappers_count_launches(dev):
    env = make_env("connect4")
    boards, players = _positions(env, 8, 3, dev)
    rec = torch.zeros((8, env.feature_dim, env.rows, env.cols),
                      dtype=torch.int8, device=dev)
    before = fused.K_ROOT_OBS.launches
    obs = fused.root_obs(env, boards, players, rec)
    assert fused.K_ROOT_OBS.launches == before + 1
    want = fused.root_obs_reference(env, boards, players, rec.clone())
    assert torch.equal(obs, want)
    with pytest.raises(ValueError):
        fused.root_obs(env, boards.to(torch.int32), players, rec)


def _move_positions(env, B, seed, dev):
    """B arena roots from random legal play, each stopped at its own
    length (some finished by a win), with the last one a drawn full
    board."""
    g = torch.Generator().manual_seed(seed)
    st = env.init(B)
    target = torch.randint(0, 40, (B,), generator=g)
    for t in range(40):
        mask = env.valid_mask(st) & (t < target)[:, None]
        act = torch.where(mask, torch.rand(mask.shape, generator=g), -1.0
                          ).argmax(-1).to(torch.int32)
        nxt = env.step(st, act)
        live = mask.any(-1)
        st = type(st)(*(torch.where(
            live.reshape((B,) + (1,) * (getattr(st, f).dim() - 1)),
            getattr(nxt, f), getattr(st, f)) for f in vars(st)))
    st.board[-1] = drawn_board(env)
    st.current_player[-1], st.move_count[-1] = 0, env.max_moves
    st.done[-1], st.winner[-1] = True, -1
    assert st.done[:-1].any() and (~st.done).any()
    return (st.board.to(dev), st.current_player.to(dev),
            st.move_count.to(dev), st.done.to(dev))


def test_move_root_init_and_root_counts_kernels_vs_plain(dev):
    env = make_env("connect4")
    B, S, A = 96, 24, env.action_dim
    boards, players, mcs, dones = _move_positions(env, B, 4, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    prior = torch.rand((B, A), generator=g, device=dev)
    prior = torch.where(torch.rand((B, A), generator=g, device=dev) < 0.2,
                        fused.NEG, prior)
    value = torch.rand((B,), generator=g, device=dev) * 2 - 1
    live = ~dones
    tk, tp = fused.Tree(env, B, S, dev), fused.Tree(env, B, S, dev)
    tk.visit.fill_(7.0)                            # stale values to clear
    before = fused.K_MOVE_ROOT_INIT.launches
    fused.move_root_init(tk, prior, value, live)
    assert fused.K_MOVE_ROOT_INIT.launches == before + 1
    fused.move_root_init_reference(tp, prior, value, live)
    for f in ("visit", "val"):
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f
    for f in ("child", "prior"):
        assert torch.equal(getattr(tk, f)[:, 0], getattr(tp, f)[:, 0]), f
    cfg = MCTSConfig(num_simulations=S)
    stub = exact_stub_evaluator(env)
    for slot in range(1, S):
        fused.descend_leaf(env, cfg, tk, boards, players, mcs, slot)
        fused.apply(tk, slot, *stub(tk.obs))
    got = fused.root_counts(tk)
    want = fused.root_counts_reference(tk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[0].sum(-1)[live] == S - 1).all()
    assert (got[0].sum(-1)[dones] == 0).all()


@pytest.mark.parametrize("dirichlet,formula", [(False, "reference"),
                                               (True, "alphazero")])
def test_move_search_kernels_bitwise_vs_plain(dev, dirichlet, formula):
    """The whole move search with finished (won and drawn) games present."""
    env = make_env("connect4")
    cfg = MCTSConfig(num_simulations=40, dirichlet_alpha=0.3,
                     use_dirichlet=dirichlet, formula=formula, c_puct=1.7)
    B = 128
    args = _move_positions(env, B, 6, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    noise = fused.dirichlet_noise(1, env.action_dim, B, 0.3, g, dev)[0].T
    stub = exact_stub_evaluator(env)
    kw = dict(noise=noise, evaluator=stub)
    root = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    got = fused.run_mcts_fused(env, None, None, root, *args, cfg, device=dev,
                               **kw)
    want = fused.move_search_reference(env, None, None, root, *args, cfg,
                                       **kw)
    for name in ("visit_counts", "policy", "root_q"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    sums = got.visit_counts.sum(-1)
    dones = args[3]
    assert (sums[~dones] == 39).all() and (sums[dones] == 0).all()


def test_learner_step_on_card_close_to_cpu(dev):
    """One Adam step, float32 compute, no TF32: loss within 1e-5 relative
    and each gradient within 1e-5 of its largest entry (summation order);
    parameters after the step within 2·lr everywhere (the most one Adam
    step moves a parameter; a gradient near 0 may take either sign) and
    within 1e-6 on 99% of entries."""
    from alphazero_tpu_torch.config import TrainConfig
    from alphazero_tpu_torch.data import Symmetries, create, sample
    from alphazero_tpu_torch.training import learner
    env = make_env("connect4")
    model = build_model(ModelConfig(family="dense", width=64, blocks=2,
                                    compute_dtype="float32"), env)
    params = init_params(model, torch.Generator().manual_seed(0))
    buf = create(env, 42 * 8, device="cpu")
    g = torch.Generator().manual_seed(1)
    buf.obs.copy_((torch.rand(buf.obs.shape, generator=g) < 0.3).to(torch.int8))
    buf.policy.copy_(torch.softmax(torch.randn(buf.policy.shape, generator=g),
                                   -1))
    buf.length.copy_(torch.randint(1, 43, buf.length.shape, generator=g))
    buf.winner.copy_(torch.randint(-1, 2, buf.winner.shape, generator=g))
    batch = sample(buf, 64, generator=g, syms=Symmetries(env, "cpu"),
                   augment_skip=2)
    cfg = TrainConfig(learning_rate=2.5e-4)
    out = {}
    for d in ("cpu", dev):
        m = model.to(d)
        ps = {k: v.to(d).clone().requires_grad_(True)
              for k, v in params.items()}
        opt = learner.make_optimizer(cfg, ps)
        met = learner.train_step(m, ps, opt, *(x.to(d) for x in batch),
                                 cfg.l2_coeff)
        out[str(d)] = (float(met.loss),
                       {k: v.grad.cpu() for k, v in ps.items()},
                       {k: v.detach().cpu() for k, v in ps.items()})
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-5 * float(
            gc[k].abs().max()), k
        d = (pg[k] - pc[k]).abs()
        assert float(d.max()) <= 2 * cfg.learning_rate, k
        assert float((d <= 1e-6).float().mean()) >= 0.99, k


def _sim_positions(env, B, seed, dev):
    """B roots of random legal play for any game, each stopped at its own
    length: live, won and (board full) drawn games mixed."""
    g = torch.Generator().manual_seed(seed)
    st = env.init(B)
    T = min(env.max_moves, 40)
    target = torch.randint(0, T, (B,), generator=g)
    target[-2:] = T                           # some long games
    for t in range(T):
        mask = env.valid_mask(st) & (t < target)[:, None]
        act = torch.where(mask, torch.rand(mask.shape, generator=g), -1.0
                          ).argmax(-1).to(torch.int32)
        nxt = env.step(st, act)
        live = mask.any(-1)
        st = type(st)(*(torch.where(
            live.reshape((B,) + (1,) * (getattr(st, f).dim() - 1)),
            getattr(nxt, f), getattr(st, f)) for f in vars(st)))
    return (st.board.to(dev), st.current_player.to(dev),
            st.move_count.to(dev), st.done.to(dev))


@pytest.mark.parametrize("name,dirichlet,formula", [
    ("connect4", True, "reference"), ("tictactoe", False, "alphazero"),
    ("gomoku9", True, "reference"), ("gomoku", True, "reference")])
def test_sim_search_kernels_bitwise_vs_plain(dev, name, dirichlet, formula):
    """The per-simulation engine: az_sim_step × (S-1) and az_sim_flush
    against their plain versions, with finished roots present."""
    from alphazero_tpu_torch.search import sim
    env = make_env(name)
    S, B = 40, 64
    cfg = MCTSConfig(num_simulations=S, dirichlet_alpha=0.3,
                     use_dirichlet=dirichlet, formula=formula, c_puct=1.7)
    args = _sim_positions(env, B, 8, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    noise = fused.dirichlet_noise(1, env.action_dim, B, 0.3, g, dev)[0].T
    stub = exact_stub_evaluator(env)
    ev = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    n0 = (sim.K_SIM_STEP.launches, sim.K_SIM_FLUSH.launches)
    got = sim.run_mcts_sim(env, ev, *args, cfg, noise=noise, device=dev)
    assert (sim.K_SIM_STEP.launches - n0[0],
            sim.K_SIM_FLUSH.launches - n0[1]) == (S - 1, 1)
    want = sim.sim_search_reference(env, ev, *args, cfg, noise=noise)
    for f in ("visit_counts", "policy", "root_q"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    sums = got.visit_counts.sum(-1)
    dones = args[3]
    assert (sums[~dones] == S - 1).all() and (sums[dones] == 0).all()


def test_sim_step_and_flush_one_launch_vs_plain(dev):
    """One az_sim_step (flush of slot 9, descent of slot 10) and one
    az_sim_flush on a mid-search snapshot: every output equal."""
    from alphazero_tpu_torch.search import sim
    from alphazero_tpu_torch.search.mcts import expand_root
    from alphazero_tpu_torch.search.tree import init_tree
    env = make_env("connect4")
    B, S = 96, 24
    cfg = MCTSConfig(num_simulations=S, use_dirichlet=False)
    board, player, mc, dones = _sim_positions(env, B, 3, dev)
    stub = exact_stub_evaluator(env)
    ev = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    tree = init_tree(env, board, player, mc, S)
    expand_root(env, cfg, tree, ev, dones, None, None, None)
    st = sim.SimState.create(env, B, S, dev)
    p = torch.zeros((B, env.action_dim), device=dev)
    v = torch.zeros((B,), device=dev)
    for slot in range(1, 10):
        sim.sim_step(env, cfg, tree, st, p, v, slot - 1, slot)
        p, v = ev(st.obs)
    snap = (init_tree(env, board, player, mc, S), st.clone())
    for f in ("stats", "prior", "children"):
        getattr(snap[0], f).copy_(getattr(tree, f))
    sim.sim_step(env, cfg, tree, st, p, v, 9, 10)
    sim.sim_step_reference(env, cfg, snap[0], snap[1], p, v, 9, 10)
    for f in ("stats", "prior", "children"):
        assert torch.equal(getattr(tree, f), getattr(snap[0], f)), f
    for f in ("path", "apath", "meta", "valid", "obs"):
        assert torch.equal(getattr(st, f), getattr(snap[1], f)), f
    p, v = ev(st.obs)
    sim.flush(env, tree, st, p, v, 10)
    sim.flush_reference(snap[0], snap[1], p, v, 10)
    for f in ("stats", "prior", "children"):
        assert torch.equal(getattr(tree, f), getattr(snap[0], f)), f


@pytest.mark.parametrize("B", [1, 17, 129, 512])
@pytest.mark.parametrize("game,channels,blocks", [
    ("connect4", 64, 4),           # the connect4-resnet tower
    ("tictactoe", 32, 2),
    ("gomoku9", 128, 2)])
def test_resnet_tower_kernel_close_to_plain(dev, game, channels, blocks, B):
    """az_resnet_tower against tower_reference, heads on both: bf16 reads
    of float32 sums taken in another order, so an activation near a bf16
    boundary may round the other way and move its game's outputs; logits
    and value within 5e-2 at most and 1e-3 in the median (seen on the card
    at 128×8: 1.2e-2 and 1.1e-3; at 64×4: 2.9e-3 and 3e-7)."""
    from alphazero_tpu_torch.ops import resnet_tower as rt
    env = make_env(game)
    model = build_model(ModelConfig(family="resnet", channels=channels,
                                    blocks=blocks), env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    packed = rt.pack(params, blocks)
    boards, players = _positions(env, B, 10, dev)
    obs = env.observation_from_board(boards, players)
    n0 = rt.K_TOWER.launches
    got = rt.heads(rt.resnet_tower(obs, packed), packed)
    assert rt.K_TOWER.launches == n0 + 1
    want = rt.heads(rt.tower_reference(obs, packed), packed)
    err = torch.cat([(g - w).abs().reshape(-1) for g, w in zip(got, want)])
    assert bool(torch.isfinite(err).all())
    assert float(err.max()) <= 5e-2 and float(err.median()) <= 1e-3
    rt.geometry(B, env.rows * env.cols, channels)
    with pytest.raises(ValueError):
        rt.resnet_tower(obs.double(), packed)


@pytest.mark.parametrize("channels", [24, 192])
def test_resnet_tower_kernel_raises_for_unsupported_channels(dev, channels):
    from alphazero_tpu_torch.ops import resnet_tower as rt
    env = make_env("connect4")
    model = build_model(ModelConfig(family="resnet", channels=channels,
                                    blocks=1), env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    packed = rt.pack(params, 1)
    obs = torch.zeros((2, env.feature_dim, env.rows, env.cols), device=dev)
    n0 = rt.K_TOWER.launches
    with pytest.raises(ValueError, match="channels"):
        rt.resnet_tower(obs, packed)
    assert rt.K_TOWER.launches == n0


@pytest.mark.parametrize("B", [1, 17, 129, 256])
@pytest.mark.parametrize("game,width", [
    ("gomoku9", 512),      # gomoku9-dense: A=81, Kp=448
    ("gomoku9", 384),      # 6 CTAs per cluster: no tile divides
    ("tictactoe", 512), ("tictactoe", 64)])
def test_dense_forward_kernel_close_to_plain_off_connect4(dev, game, width,
                                                          B):
    """The forward at tictactoe's 9 and gomoku9's 81 actions (three
    softmax actions per lane), the same tolerance as connect4's."""
    env = make_env(game)
    model = build_model(ModelConfig(family="dense", width=width, blocks=2),
                        env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(0)).items()}
    packed = fused.pack_dense_params(model, params, dev)
    boards, players = _positions(env, B, 1, dev)
    obs = env.observation_from_board(boards, players).reshape(B, -1)
    pk, vk = fused.dense_forward(obs, packed)
    pp, vp = fused.dense_forward_reference(obs, packed)
    err = torch.cat([(pk - pp).abs().reshape(-1), (vk - vp).abs()])
    assert bool(torch.isfinite(err).all())
    assert float(err.max()) <= 1e-2
    assert float((err <= 1e-3).float().mean()) >= 0.99
    assert torch.allclose(pk.sum(-1), torch.ones(B, device=dev), atol=1e-5)


@pytest.mark.parametrize("game", ["tictactoe", "gomoku", "gomoku9"])
def test_chunk_kernels_bitwise_vs_plain_chunk_off_connect4(dev, game):
    """The chunk's search kernels under each game's rules, from random
    positions (finished games replaced by empty boards: the centre rule),
    with Dirichlet noise and temperature sampling."""
    env = make_env(game)
    cfg = MCTSConfig(num_simulations=32, dirichlet_alpha=0.3,
                     temperature_moves=8)
    B, M = 64, 4
    boards, players, mcs, dones = _sim_positions(env, B, 11, dev)
    boards = torch.where(dones[:, None, None, None], 0, boards)
    players = torch.where(dones, 0, players)
    mcs = torch.where(dones, 0, mcs)
    g = torch.Generator(device=dev).manual_seed(12)
    kw = dict(noise=fused.dirichlet_noise(M, env.action_dim, B, 0.3, g, dev),
              unif=torch.rand((M, B), generator=g, device=dev),
              evaluator=exact_stub_evaluator(env))
    n0 = fused.K_DESCEND.launches
    got = fused.run_selfplay_chunk(env, None, None, boards, players, mcs, cfg,
                                   M, device=dev, **kw)
    assert fused.K_DESCEND.launches == n0 + M * 31
    want = fused.selfplay_chunk_reference(env, None, None, boards, players,
                                          mcs, cfg, M, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("game", ["tictactoe", "gomoku9"])
def test_move_search_kernels_bitwise_vs_plain_off_connect4(dev, game):
    """The move search with live, won and drawn roots of each game."""
    env = make_env(game)
    cfg = MCTSConfig(num_simulations=40, dirichlet_alpha=0.3)
    B = 96
    board, player, mc, done = _sim_positions(env, B, 6, dev)
    board[-1] = drawn_board(env).to(dev)
    player[-1], mc[-1], done[-1] = 0, env.max_moves, True
    args = (board, player, mc, done)
    g = torch.Generator(device=dev).manual_seed(7)
    noise = fused.dirichlet_noise(1, env.action_dim, B, 0.3, g, dev)[0].T
    stub = exact_stub_evaluator(env)
    kw = dict(noise=noise, evaluator=stub)
    root = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    got = fused.run_mcts_fused(env, None, None, root, *args, cfg, device=dev,
                               **kw)
    want = fused.move_search_reference(env, None, None, root, *args, cfg,
                                       **kw)
    for name in ("visit_counts", "policy", "root_q"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    sums = got.visit_counts.sum(-1)
    assert (sums[~done] == 39).all() and (sums[done] == 0).all()


def test_supports_chunk_same_on_card(dev):
    """The engine gate reads the env, the model and the config, not the
    device: the same answer with the model's weights on the card."""
    for game, mcfg, cfg in (
            ("connect4", ModelConfig(family="dense", width=512, blocks=2),
             MCTSConfig()),
            ("gomoku9", ModelConfig(family="dense", width=512, blocks=2),
             MCTSConfig(num_simulations=400)),
            ("connect4", ModelConfig(family="dense", width=64, blocks=1),
             MCTSConfig(num_simulations=510)),
            ("gomoku15", ModelConfig(family="dense", width=512, blocks=1),
             MCTSConfig()),
            ("connect4", ModelConfig(family="dense", width=32, blocks=1),
             MCTSConfig())):
        env = make_env(game)
        model = build_model(mcfg, env)
        cpu = fused.supports_chunk(env, model, cfg)
        assert fused.supports_chunk(env, model.to(dev), cfg) == cpu
        assert cpu == (game in ("connect4", "gomoku9") and mcfg.width >= 64
                       and cfg.num_simulations < 510)


# ---- one launch of the descent and the apply on trees with every walk case

WALK_GAMES = ("connect4", "tictactoe", "gomoku9")
CASES = 6


def walk_trees(env, B, seed, dev):
    """Trees for one launch of ``az_descend_leaf`` and ``az_apply`` at the
    last slot, S = max_moves + 8 (so the walk's cap, max_moves + 1, fits in
    the tree).  Game b holds case b % 6:

    0. a fresh root with uniform priors: every legal edge ties;
    1. an empty board's fresh root (gomoku: the centre alone is legal);
    2. a chain of dcap + 1 expanded nodes: the walk is cut at dcap;
    3. two plies to an existing, visited, unexpanded child (``e_sel == 0``);
    4. a finished root, unexpanded;
    5. random play and S - 2 simulations of the plain search under the
       exact stub.

    Returns ``(cfg, tree, board, player, mc, slot)``."""
    S = env.max_moves + 8
    cfg = MCTSConfig(num_simulations=S, use_dirichlet=False)
    A, R = env.action_dim, env.rows
    board, player, mc, done = _sim_positions(env, B, seed, dev)
    board = torch.where(done[:, None, None, None], 0, board).contiguous()
    player = torch.where(done, 0, player).contiguous()
    mc = torch.where(done, 0, mc).contiguous()
    stub = exact_stub_evaluator(env)
    tree = fused.Tree(env, B, S, dev)
    probs, value = stub(env.observation_from_board(board, player
                                                   ).reshape(B, -1))
    fused.root_init_reference(env, cfg, tree, probs, value, None, board)
    slot = S - 1
    for s in range(1, slot):
        fused.descend_leaf_reference(env, cfg, tree, board, player, mc, s)
        fused.apply_reference(tree, s, *stub(tree.obs))
    case = torch.arange(B, device=dev) % CASES
    synth = case < 5
    tree.visit[synth], tree.val[synth] = 0.0, 0.0
    tree.child[synth], tree.prior[synth] = fused.ILLEGAL, 0.0
    empty = case == 1
    board[empty], player[empty], mc[empty] = 0, 0, 0
    legal = (fused._heights(board) < R if env.rules == fused.RULES_GRAVITY
             else env.valid_mask_board(board, None))
    fresh = case <= 1
    tree.visit[fresh, 0], tree.val[fresh, 0] = 1.5, 0.25
    tree.child[fresh, 0] = torch.where(legal[fresh], fused.NO_CHILD,
                                       fused.ILLEGAL).to(torch.int32)
    tree.prior[fresh, 0] = torch.where(legal[fresh], 0.125, 0.0)

    def link(games, node, a, kid, visit, val):
        """Expanded ``node`` of ``games``: every edge open at prior 1/64,
        edge ``a`` to ``kid`` at 1/2, which holds ``visit`` and ``val``."""
        tree.child[games, node] = fused.NO_CHILD
        tree.prior[games, node] = 1.0 / 64
        tree.child[games, node, a] = kid
        tree.prior[games, node, a] = 0.5
        tree.visit[games, kid], tree.val[games, kid] = visit, val

    chain = case == 2
    dcap = tree.dcap
    tree.visit[chain, 0], tree.val[chain, 0] = dcap + 2.5, 0.0
    for k in range(dcap):
        link(chain, k, (5 * k + 1) % A, k + 1, dcap + 1.5 - k, dcap + 1.0 - k)
    two = case == 3
    tree.visit[two, 0] = 3.5
    link(two, 0, A // 2, 1, 2.5, 2.0)
    link(two, 1, 0, 2, 1.0, 1.0)           # visited once, not expanded
    tree.visit[case == 4, 0], tree.val[case == 4, 0] = 1.0, 0.5
    return cfg, tree, board, player, mc, slot


def check_walk_cases(env, tree, root_child):
    """What the descent must have found in each case of :func:`walk_trees`
    (``root_child``: the root edges before the launch)."""
    pend = tree.pend.long()
    B = pend.shape[0]
    case = torch.arange(B, device=pend.device) % CASES
    depth, leaf = pend[:, fused.P_DEPTH], pend[:, fused.P_LEAF]
    alloc, terminal = pend[:, fused.P_ALLOC], pend[:, fused.P_TERMINAL]
    first = (root_child != fused.ILLEGAL).to(torch.int32).argmax(-1)
    fresh = case <= 1
    assert (depth[fresh] == 1).all() and (alloc[fresh] == 1).all()
    assert torch.equal(pend[fresh, fused.P_ACTION], first[fresh].long())
    if env.name.startswith("gomoku"):
        centre = (env.rows // 2) * env.cols + env.cols // 2
        assert (pend[case == 1, fused.P_ACTION] == centre).all()
    chain = case == 2
    assert (depth[chain] == tree.dcap).all() and (leaf[chain] == tree.dcap
                                                  ).all()
    assert (alloc[chain] == 0).all() and (terminal[chain] == 1).all()
    two = case == 3
    assert (depth[two] == 2).all() and (leaf[two] == 2).all()
    assert (alloc[two] == 0).all() and (pend[two, fused.P_PARENT] == 1).all()
    done = case == 4
    assert (depth[done] == 0).all() and (terminal[done] == 1).all()


@pytest.mark.parametrize("B", [1, 17, 129, 256])
@pytest.mark.parametrize("game", WALK_GAMES)
def test_descend_and_apply_one_launch_bitwise(dev, game, B):
    """One az_descend_leaf and one az_apply against their plain versions,
    bit for bit, on trees with ties, the centre opening, a walk cut at
    dcap, a terminal child and a finished root (:func:`walk_trees`), at
    batches that fill no CTA, one and part of the next, and the chunk's."""
    env = make_env(game)
    cfg, tree, board, player, mc, slot = walk_trees(env, B, 21, dev)
    tk, tp = tree.clone(), tree.clone()
    n0 = (fused.K_DESCEND.launches, fused.K_APPLY.launches)
    fused.descend_leaf(env, cfg, tk, board, player, mc, slot)
    fused.descend_leaf_reference(env, cfg, tp, board, player, mc, slot)
    for f in ("path", "apath", "pend", "valid", "obs"):
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f
    check_walk_cases(env, tp, tree.child[:, 0])
    g = torch.Generator(device=dev).manual_seed(B)
    probs = torch.rand((B, env.action_dim), generator=g, device=dev)
    value = torch.rand((B,), generator=g, device=dev) * 2 - 1
    fused.apply(tk, slot, probs, value)
    fused.apply_reference(tp, slot, probs, value)
    for f in ("visit", "val", "child", "prior"):
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f
    assert (fused.K_DESCEND.launches, fused.K_APPLY.launches) == (
        n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("game", WALK_GAMES)
def test_search_kernel_geometry_on_card(dev, game):
    """The kernels' own launch geometry equals search_geometry's (the
    group kernels' one layout: az_root_init, az_descend_leaf, az_apply,
    az_move_tail and az_root_counts)."""
    A = make_env(game).action_dim
    for B in (1, 17, 129, 256, 512):
        assert fused.search_kernel_geometry(B, A) == fused.search_geometry(
            B, A)


# ---- one launch of az_sim_step and az_sim_flush on trees of every walk case

SIM_GAMES = ("connect4", "tictactoe", "gomoku9", "gomoku15")
SIM_CASES = 7


def win_in_one(env):
    """``(cells, action)``: player 0's stones on every cell of a line but
    the last (the bottom row under gravity), and the move that completes
    it."""
    lines = [tuple(int(c) for c in line) for line in env.lines]
    if env.rules == fused.RULES_GRAVITY:
        bottom = (env.rows - 1) * env.cols
        line = next(li for li in lines if min(li) >= bottom)
        return line[:-1], line[-1] % env.cols
    return lines[0][:-1], lines[0][-1]


def sim_trees(env, B, seed, dev):
    """Trees in ``search/tree.py``'s layout for one ``az_sim_step`` with
    nothing to flush (previous slot 0, slot S - 2), one that flushes it
    (slot S - 1) and one ``az_sim_flush``, S = max_moves + 8 (the walk's
    cap, max_moves + 1, fits in the tree).  Game b holds case b % 7:

    0. a fresh root with uniform priors: every legal edge ties (its flush
       allocates and expands);
    1. an empty board's fresh root (gomoku: the centre alone is legal);
    2. a chain of dcap + 1 expanded nodes: the walk is cut at dcap (no
       allocation, terminal); under gravity the board fills first, so the
       chain plays max_moves moves round the columns to an unexpanded node;
    3. two plies to an existing, visited, unexpanded child (``e_sel ==
       0``): no allocation;
    4. a finished root, unexpanded: the root case;
    5. a win in one: the edge of the highest prior completes the mover's
       line (allocation, terminal, won);
    6. random play and a few simulations of the plain search under the
       exact stub (finished roots among them).

    The state carried in is stale (the last random simulation's), as the
    kernel must ignore it at previous slot 0.  Returns ``(cfg, tree, st,
    slot)``."""
    from alphazero_tpu_torch.search.mcts import expand_root
    from alphazero_tpu_torch.search.tree import NEG, init_tree
    S = env.max_moves + 8
    cfg = MCTSConfig(num_simulations=S, use_dirichlet=False)
    A = env.action_dim
    board, player, mc, done = _sim_positions(env, B, seed, dev)
    case = torch.arange(B, device=dev) % SIM_CASES
    empty = done | (case == 1) | (case == 2) | (case == 3)
    board = torch.where(empty[:, None, None, None], 0, board)
    player, mc = torch.where(empty, 0, player), torch.where(empty, 0, mc)
    win = case == 5
    cells, win_action = win_in_one(env)
    board[win], player[win], mc[win] = 0, 0, len(cells)
    for cell in cells:
        board[win, 0, cell // env.cols, cell % env.cols] = 1
    stub = exact_stub_evaluator(env)
    ev = lambda obs: stub(obs.reshape(obs.shape[0], -1))  # noqa: E731
    tree = init_tree(env, board.contiguous(), player.contiguous(),
                     mc.contiguous(), S)
    expand_root(env, cfg, tree, ev, done & (case == 6), None, None, None)
    st = sim.SimState.create(env, B, S, dev)
    p = torch.zeros((B, A), device=dev)
    v = torch.zeros((B,), device=dev)
    for s in range(1, 8):
        sim.sim_step_reference(env, cfg, tree, st, p, v, s - 1, s)
        p, v = ev(st.obs)
    sim.flush_reference(tree, st, p, v, 7)

    synth = case < 6
    tree.stats[synth], tree.prior[synth], tree.children[synth] = \
        0.0, NEG, -1
    legal = env.valid_mask_board(tree.root_board, None)
    fresh = (case <= 1) | win
    tree.stats[fresh, 0] = torch.tensor([1.0, 0.25, 1.0], device=dev)
    tree.prior[fresh, 0] = torch.where(legal[fresh], 0.125, NEG)
    tree.prior[win, 0, win_action] = 0.5

    def link(games, node, a, kid, visit, val, expanded):
        """Expanded ``node`` of ``games``: every edge open at prior 1/64,
        edge ``a`` to ``kid`` at 1/2, which holds the given stats."""
        tree.prior[games, node] = 1.0 / 64
        tree.prior[games, node, a] = 0.5
        tree.children[games, node, a] = kid
        tree.stats[games, kid] = torch.tensor([visit, val, expanded],
                                              device=dev)

    chain = case == 2
    n = chain_depth(env, st)
    gravity = env.rules == fused.RULES_GRAVITY
    tree.stats[chain, 0] = torch.tensor([n + 2.0, 0.0, 1.0], device=dev)
    for k in range(n):
        link(chain, k, k % A if gravity else (5 * k + 1) % A, k + 1,
             n + 1.0 - k, n - k, 0.0 if gravity and k == n - 1 else 1.0)
    two = case == 3
    tree.stats[two, 0] = torch.tensor([3.0, 0.0, 1.0], device=dev)
    link(two, 0, A // 2, 1, 2.0, 2.0, 1.0)
    link(two, 1, 0, 2, 1.0, 1.0, 0.0)      # visited once, not expanded
    tree.stats[case == 4, 0] = torch.tensor([1.0, 0.5, 0.0], device=dev)
    return cfg, tree, st, S - 2


def chain_depth(env, st):
    """The depth of case 2's walk: dcap, or max_moves under gravity."""
    dcap = st.path.shape[1]
    return env.max_moves if env.rules == fused.RULES_GRAVITY else dcap


def check_sim_cases(env, st, root_prior, slot):
    """What the walk of :func:`sim_trees`' first step must have found in
    each case (``root_prior``: the root rows before the launch)."""
    meta = st.meta.long()
    B = meta.shape[0]
    case = torch.arange(B, device=meta.device) % SIM_CASES
    depth, leaf = meta[:, sim.M_DEPTH], meta[:, sim.M_LEAF]
    alloc, terminal = meta[:, sim.M_ALLOC], meta[:, sim.M_TERMINAL]
    action, won = meta[:, sim.M_ACTION], meta[:, sim.M_WON]
    first = (root_prior > -1e29).to(torch.int32).argmax(-1).long()
    fresh = case <= 1
    assert (depth[fresh] == 1).all() and (alloc[fresh] == 1).all()
    assert (leaf[fresh] == slot).all()
    assert torch.equal(action[fresh], first[fresh])
    if env.name.startswith("gomoku"):
        centre = (env.rows // 2) * env.cols + env.cols // 2
        assert (action[case == 1] == centre).all()
    chain = case == 2
    n = chain_depth(env, st)
    assert (depth[chain] == n).all() and (leaf[chain] == n).all()
    assert (alloc[chain] == 0).all() and (terminal[chain] == 1).all()
    two = case == 3
    assert (depth[two] == 2).all() and (leaf[two] == 2).all()
    assert (alloc[two] == 0).all() and (meta[two, sim.M_PARENT] == 1).all()
    done = case == 4
    assert (depth[done] == 0).all() and (terminal[done] == 1).all()
    assert (meta[done, sim.M_PARENT] == -1).all() and (leaf[done] == 0).all()
    win = case == 5
    assert (depth[win] == 1).all() and (alloc[win] == 1).all()
    assert (terminal[win] == 1).all() and (won[win] == 1).all()
    assert (action[win] == win_in_one(env)[1]).all()


def sim_outputs_equal(tk, sk, tp, sp):
    for f in ("stats", "prior", "children"):
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f
    for f in ("path", "apath", "meta", "valid", "obs"):
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f


@pytest.mark.parametrize("B", [1, 17, 129, 256])
@pytest.mark.parametrize("game", SIM_GAMES)
def test_sim_step_and_flush_one_launch_bitwise(dev, game, B):
    """az_sim_step with nothing to flush, az_sim_step flushing each kind of
    simulation (alloc and expand, alloc and terminal, no alloc, the root
    case), then az_sim_flush, each against its plain version bit for bit,
    on the trees of :func:`sim_trees` (ties, the centre opening, a walk cut
    at dcap, a terminal child, a finished root, a win in one), at batches
    that fill no CTA, one and part of the next, and self-play's, up to
    gomoku15's 225 actions."""
    env = make_env(game)
    cfg, tree, st, slot = sim_trees(env, B, 21, dev)
    tk, sk, tp, sp = tree.clone(), st.clone(), tree.clone(), st.clone()
    g = torch.Generator(device=dev).manual_seed(B)
    n0 = (sim.K_SIM_STEP.launches, sim.K_SIM_FLUSH.launches)
    for prev, cur in ((0, slot), (slot, slot + 1)):
        probs = torch.rand((B, env.action_dim), generator=g, device=dev)
        value = torch.rand((B,), generator=g, device=dev) * 2 - 1
        sim.sim_step(env, cfg, tk, sk, probs, value, prev, cur)
        sim.sim_step_reference(env, cfg, tp, sp, probs, value, prev, cur)
        sim_outputs_equal(tk, sk, tp, sp)
        if prev == 0:
            check_sim_cases(env, sp, tree.prior[:, 0], slot)
    probs = torch.rand((B, env.action_dim), generator=g, device=dev)
    value = torch.rand((B,), generator=g, device=dev) * 2 - 1
    sim.flush(env, tk, sk, probs, value, slot + 1)
    sim.flush_reference(tp, sp, probs, value, slot + 1)
    sim_outputs_equal(tk, sk, tp, sp)
    assert (sim.K_SIM_STEP.launches, sim.K_SIM_FLUSH.launches) == (
        n0[0] + 2, n0[1] + 1)


@pytest.mark.parametrize("game", SIM_GAMES)
def test_sim_kernel_geometry_on_card(dev, game):
    """The kernels' own launch geometry equals sim_geometry's."""
    A = make_env(game).action_dim
    for B in (1, 17, 129, 256, 512):
        assert sim.sim_kernel_geometry(B, A) == sim.sim_geometry(B, A)


# ---- one launch of az_root_init and az_move_tail on trees of every case

ROOT_CASES = 5
TAIL_CASES = 8
TAIL_TEMPERATURE = 4                 # temperature_moves of tail_trees
ROOT_TAIL_BATCHES = [(game, B) for game in WALK_GAMES
                     for B in (1, 17, 129, 256)] + [("connect4", 512)]


def near_full(env, dev):
    """A drawn full board with three places cleared: under gravity the top
    of columns 1 and 4 and the top two cells of column 5, else cells 0,
    RC // 2 and RC - 1.  Returns ``(board, the legal actions)``."""
    board = drawn_board(env).to(dev)
    if env.rules == fused.RULES_GRAVITY:
        for r, c in ((0, 1), (0, 4), (0, 5), (1, 5)):
            board[:, r, c] = 0
        return board, (1, 4, 5)
    RC = env.rows * env.cols
    cells = (0, RC // 2, RC - 1)
    board.reshape(2, RC)[:, list(cells)] = 0
    return board, cells


def root_legal(env, case):
    """The legal root actions ``(A,)`` bool of case ``case`` (1-4) of
    :func:`root_trees`."""
    A, C = env.action_dim, env.cols
    legal = torch.zeros(A, dtype=torch.bool)
    gomoku = env.rules == fused.RULES_NEIGHBOURHOOD
    if case == 1:
        if gomoku:
            legal[(env.rows // 2) * C + C // 2] = True
        else:
            legal[:] = True
    elif case == 2:
        legal[list(near_full(env, "cpu")[1])] = True
    elif case == 3:
        if gomoku:
            legal[[1, C, C + 1]] = True
        else:
            legal[:] = True
            legal[0] = env.rules == fused.RULES_GRAVITY
    return legal


def root_trees(env, B, seed, dev):
    """Operands of one ``az_root_init`` launch, S = 60, on a tree left dirty
    by earlier moves (every row of it random).  Game b holds case b % 5:

    0. a position of random play (finished games among them);
    1. an empty board (gomoku: the centre alone is legal);
    2. a full board but three cells or columns (:func:`near_full`), under
       gravity full and nearly full columns side by side;
    3. one stone, the second player's, in the corner cell (under gravity
       at the foot of column 0): gomoku's three neighbours are legal;
    4. a full drawn board: nothing is legal.

    Returns ``(cfg, tree, probs, value, noise (A, B), board)``."""
    S = 60
    cfg = MCTSConfig(num_simulations=S, dirichlet_alpha=0.3)
    A, N = env.action_dim, S + 1
    board = _sim_positions(env, B, seed, dev)[0].clone()
    case = torch.arange(B, device=dev) % ROOT_CASES
    board[case == 1] = 0
    board[case == 2] = near_full(env, dev)[0]
    one = case == 3
    board[one] = 0
    board[one, 1, env.rows - 1 if env.rules == fused.RULES_GRAVITY else 0,
          0] = 1
    board[case == 4] = drawn_board(env).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    tree = fused.Tree(env, B, S, dev)
    tree.visit.copy_(torch.rand((B, N), generator=g, device=dev) * 9)
    tree.val.copy_(torch.rand((B, N), generator=g, device=dev) * 2 - 1)
    tree.child.copy_(torch.randint(-2, N, (B, N, A), generator=g, device=dev,
                                   dtype=torch.int32))
    tree.prior.copy_(torch.rand((B, N, A), generator=g, device=dev))
    probs = torch.rand((B, A), generator=g, device=dev)
    probs = probs / probs.sum(-1, keepdim=True)
    value = torch.rand((B,), generator=g, device=dev) * 2 - 1
    noise = fused.dirichlet_noise(1, A, B, 0.3, g, dev)[0].contiguous()
    return cfg, tree, probs, value, noise, board.contiguous()


def check_root_cases(env, tree, before, value):
    """What the tree init must leave in each case of :func:`root_trees`
    (``before``: the tree before it)."""
    B = tree.B
    case = torch.arange(B, device=tree.visit.device) % ROOT_CASES
    ch0, pr0 = tree.child[:, 0], tree.prior[:, 0]
    legal = ch0 != fused.ILLEGAL
    assert (ch0[legal] == fused.NO_CHILD).all()
    assert (pr0[~legal] == 0).all() and (pr0[legal] >= 0).all()
    assert torch.equal(tree.child[:, 1:], before.child[:, 1:])
    assert torch.equal(tree.prior[:, 1:], before.prior[:, 1:])
    assert (tree.visit[:, 0] == 1.5).all() and (tree.visit[:, 1:] == 0).all()
    assert torch.equal(tree.val[:, 0], -value)
    assert (tree.val[:, 1:] == 0).all()
    for c in range(1, ROOT_CASES):
        want = root_legal(env, c).to(legal.device)
        assert (legal[case == c] == want).all(), c


def tail_records(B, A, dev):
    """A move's records, filled with a value no record takes (7, True)."""
    return {name: torch.full((B, A) if name == "policy" else (B,), 7,
                             dtype=dt, device=dev)
            for name, dt in fused._REC_TYPES.items()}


def tail_trees(env, B, seed, dev):
    """Operands of one ``az_move_tail`` launch, S = A + 8 (a node for
    every root edge), temperature_moves 4.  Game b holds case b % 8, the
    root's edges visited as given (edge a to node a + 1, every other edge
    open and unvisited):

    0. counts 1, 3, 3 on actions 0-2, played greedily: the tie goes to
       action 1;
    1. no visited edge, sampled: the greedy fallback, action 0, on a full
       column under gravity (else a cell of the other player);
    2. counts 4, 7, 1 and u = 1 - 2⁻²⁴, sampled: the float32 running sum
       ends at u, not above it, so the last visited action, 2;
    3. and 4. counts 1 and 5 on actions 1 and 3, u = 0, move count 3 and 4
       (either side of temperature_moves): sampled 1, greedy 3;
    5. a win in one (:func:`win_in_one`), its edge alone visited: the
       winner set, the game reset;
    6. a drawn board but cell 0 (the first player's), its edge alone
       visited, move count max_moves - 1: a draw, the game reset;
    7. random play and 7 simulations of the plain search under the exact
       stub, u uniform.

    Returns ``(cfg, tree, u, board, player, mc)``."""
    A, R, C = env.action_dim, env.rows, env.cols
    S = A + 8
    T = TAIL_TEMPERATURE
    cfg = MCTSConfig(num_simulations=S, use_dirichlet=False,
                     temperature_moves=T)
    board, player, mc, done = _sim_positions(env, B, seed, dev)
    board = torch.where(done[:, None, None, None], 0, board)
    player = torch.where(done, 0, player)
    mc = torch.where(done, 0, mc)
    stub = exact_stub_evaluator(env)
    tree = fused.Tree(env, B, S, dev)
    obs = env.observation_from_board(board, player).reshape(B, -1)
    fused.root_init_reference(env, cfg, tree, *stub(obs), None, board)
    for s in range(1, 8):
        fused.descend_leaf_reference(env, cfg, tree, board, player, mc, s)
        fused.apply_reference(tree, s, *stub(tree.obs))
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((B,), generator=g, device=dev)
    case = torch.arange(B, device=dev) % TAIL_CASES
    synth = case < 7
    board[synth], player[synth], mc[synth] = 0, 0, 0
    tree.visit[synth], tree.val[synth] = 0.0, 0.0
    tree.child[synth, 0] = fused.NO_CHILD
    tree.val[synth, 0] = case[synth].float() * 0.375 - 1.0

    def visits(c, counts):
        """Root of case c's games: edge a to node a + 1 with counts[a]
        visits (expanded where a is even)."""
        games = case == c
        for a, n in counts.items():
            tree.child[games, 0, a] = a + 1
            tree.visit[games, a + 1] = n + 0.5 * (a % 2 == 0)
        tree.visit[games, 0] = sum(counts.values()) + 1.5

    visits(0, {0: 1, 1: 3, 2: 3})
    mc[case == 0] = T
    full = case == 1
    if env.rules == fused.RULES_GRAVITY:
        for r in range(R):
            board[full, r % 2, r, 0] = 1
    else:
        board[full, 1, 0, 0] = 1
    tree.child[full, 0, 0] = fused.ILLEGAL
    visits(1, {})
    visits(2, {0: 4, 1: 7, 2: 1})
    u[case == 2] = 1.0 - 2.0 ** -24
    for c in (3, 4):
        visits(c, {1: 1, 3: 5})
        u[case == c] = 0.0
        mc[case == c] = T - 1 + (c - 3)
    win = case == 5
    cells, win_action = win_in_one(env)
    for cell in cells:
        board[win, 0, cell // C, cell % C] = 1
    mc[win] = len(cells)
    visits(5, {win_action: 5})
    draw = case == 6
    board[draw] = drawn_board(env).to(dev)
    board[draw, :, 0, 0] = 0
    mc[draw] = env.max_moves - 1
    visits(6, {0: 5})
    return cfg, tree, u, board.contiguous(), player.contiguous(), \
        mc.contiguous()


def check_tail_cases(env, board0, board, player, mc, rec):
    """What the tail must have played in each case of :func:`tail_trees`
    (``board0``: the boards before it)."""
    B = board.shape[0]
    case = torch.arange(B, device=board.device) % TAIL_CASES
    act, done, winner = rec["action"], rec["done"], rec["winner"]
    want = {0: 0 + 1, 1: 0, 2: 2, 3: 1, 4: 3, 5: win_in_one(env)[1], 6: 0}
    for c, a in want.items():
        assert (act[case == c] == a).all(), c
    full = case == 1
    if env.rules == fused.RULES_GRAVITY:      # no stone in a full column
        assert torch.equal(board[full], board0[full])
    assert not done[full].any() and (player[full] == 1).all()
    assert (mc[full] == 1).all()
    for c, w in ((5, 0), (6, -1)):
        g = case == c
        assert done[g].all() and (winner[g] == w).all(), c
        assert (board[g] == 0).all() and (player[g] == 0).all()
        assert (mc[g] == 0).all()
    policy = rec["policy"]
    visited = policy.sum(-1) > 0
    assert ((policy.sum(-1)[visited] - 1).abs() <= 1e-6).all()
    assert not visited[full].any()


def tail_outputs_equal(a, b):
    """``(board, player, mc, rec)`` of kernel and plain version, bit for
    bit."""
    for name, x, y in zip(("board", "player", "mc"), a[:3], b[:3]):
        assert torch.equal(x, y), name
    for name in a[3]:
        assert torch.equal(a[3][name], b[3][name]), f"rec.{name}"


def tail_with_next_root(tail, env, cfg, tree, u, board, player, mc):
    """One call of ``tail`` (``fused.move_tail`` or its plain version) on
    copies of the state, writing the next move's root: its record is the
    middle one of three rows filled with 7.  Returns ``((board, player, mc,
    rec), rows, obs)``."""
    B, F = board.shape[0], env.feature_dim
    st = (board.clone(), player.clone(), mc.clone(),
          tail_records(B, env.action_dim, board.device))
    rows = torch.full((3, B, F, env.rows, env.cols), 7, dtype=torch.int8,
                      device=board.device)
    return st, rows, tail(env, cfg, tree, u, *st, rows[1])


def next_root_equal(got, want):
    """Outputs of :func:`tail_with_next_root` for kernel and plain version:
    bit for bit, the rows around the record untouched, a finished game's
    next root an empty board with player 0."""
    tail_outputs_equal(got[0], want[0])
    assert torch.equal(got[2], want[2]), "obs"
    assert torch.equal(got[1], want[1]), "rec_obs"
    assert (got[1][0] == 7).all() and (got[1][2] == 7).all()
    done = want[0][3]["done"]
    assert (got[2][done] == 0).all()


@pytest.mark.parametrize("game,B", ROOT_TAIL_BATCHES)
def test_root_init_one_launch_bitwise(dev, game, B):
    """az_root_init against its plain version bit for bit on the whole tree
    (rows below the root untouched), with noise and without, on the boards
    of :func:`root_trees` (empty, near full, one stone, full), at batches
    that fill no CTA, one and part of the next, and the chunk's; its launch
    geometry is the descent's."""
    env = make_env(game)
    A = env.action_dim
    cfg, tree, probs, value, noise, board = root_trees(env, B, 31, dev)
    n0 = fused.K_ROOT_INIT.launches
    for noise_m in (noise, None):
        tk, tp = tree.clone(), tree.clone()
        fused.root_init(env, cfg, tk, probs, value, noise_m, board)
        fused.root_init_reference(env, cfg, tp, probs, value, noise_m, board)
        for f in ("visit", "val", "child", "prior"):
            assert torch.equal(getattr(tk, f), getattr(tp, f)), f
        check_root_cases(env, tp, tree, value)
    assert fused.K_ROOT_INIT.launches == n0 + 2
    assert fused.search_kernel_geometry(B, A) == fused.search_geometry(B, A)


@pytest.mark.parametrize("game,B", ROOT_TAIL_BATCHES)
def test_move_tail_one_launch_bitwise(dev, game, B):
    """az_move_tail against its plain version bit for bit on the board,
    player, move count and all seven records, on the trees of
    :func:`tail_trees` (a tie, no visits, u past the running sum, either
    side of temperature_moves, a win, a draw, a full column), at the
    batches of the root test; its launch geometry is the descent's."""
    env = make_env(game)
    A = env.action_dim
    cfg, tree, u, board, player, mc = tail_trees(env, B, 32, dev)
    n0 = fused.K_TAIL.launches
    got, want = [(board.clone(), player.clone(), mc.clone(),
                  tail_records(B, A, dev)) for _ in range(2)]
    # the chunk's last move: no next root
    assert fused.move_tail(env, cfg, tree, u, *got) is None
    fused.move_tail_reference(env, cfg, tree, u, *want)
    tail_outputs_equal(got, want)
    check_tail_cases(env, board, *want)
    assert fused.K_TAIL.launches == n0 + 1
    assert fused.search_kernel_geometry(B, A) == fused.search_geometry(B, A)


@pytest.mark.parametrize("game,B", ROOT_TAIL_BATCHES)
def test_move_tail_next_root_one_launch_bitwise(dev, game, B):
    """az_move_tail writing the next move's root: its float32 observation
    and int8 record bit for bit against the plain version (the tail
    followed by root_obs_reference), with the board, player, move count
    and records, on the trees of :func:`tail_trees` (games won and drawn on
    the move, so reset), at the batches of the root test (F = 3 on connect4
    and tictactoe, 2 on gomoku9); nothing outside the record is written."""
    env = make_env(game)
    cfg, tree, u, board, player, mc = tail_trees(env, B, 32, dev)
    n0 = fused.K_TAIL.launches
    got = tail_with_next_root(fused.move_tail, env, cfg, tree, u, board,
                              player, mc)
    assert fused.K_TAIL.launches == n0 + 1
    want = tail_with_next_root(fused.move_tail_reference, env, cfg, tree, u,
                               board, player, mc)
    next_root_equal(got, want)
    check_tail_cases(env, board, *want[0])


# ---- one launch of az_root_counts and az_move_root_init on case trees

COUNT_CASES = 7
COUNT_SIMS = 7                       # simulations of case 6's plain search
COUNT_BATCHES = [(game, B) for game in WALK_GAMES for B in (1, 17, 128, 129)]


def count_case(A, c):
    """Case c (0-5) of :func:`count_trees` at A actions: ``(visits,
    illegal)``, the visit value of each visited edge's child (edge a to
    node a + 1, visits + 0.5 where the child is expanded) and the ILLEGAL
    edges; every other edge is open and unvisited."""
    if c == 0:
        return {}, set(range(A))
    if c == 1:
        return {a: float(a % 5 + 1) for a in range(2, A, 3)}, set(
            range(0, A, 3))
    if c == 2:
        return {0: 3.5, 1: 1.5, 2: 2.0}, set()
    if c == 3:
        return {1: 4.0, A - 1: 4.5}, set()
    if c == 4:
        return {A // 2: A + 7.5}, set()
    return {a: a + 1 + 0.5 * (a % 2 == 0)
            for a in range(A - 1, -1, -(A // 8 + 1))}, set()


def count_trees(env, B, seed, dev):
    """A tree for one ``az_root_counts`` launch, S = A + 8 (a node for
    every root edge).  Game b holds case b % 7, cases 0-5 on a tree left
    dirty (every row random but the root's edges and their children's
    visits, :func:`count_case`):

    0. a finished game, its root unexpanded: no legal edge, root visit 1,
       value 0 (counts 0, policy 0, root Q 0/1);
    1. illegal edges, legal unvisited edges and visited ones, in turn;
    2. visits carrying the 0.5 expanded bit, which the floor drops;
    3. a tie of counts on actions 1 and A - 1;
    4. all S - 1 visits on one edge;
    5. visited edges spread over every action block of a lane (at A=81
       actions 3 to 80, past the first 32);
    6. random play and 7 simulations of the plain search under the exact
       stub.

    Cases 1-5 have root visit Σ + 1.5 and value c·0.375 - 1."""
    A = env.action_dim
    S = A + 8
    N = S + 1
    cfg = MCTSConfig(num_simulations=S, use_dirichlet=False)
    board, player, mc, done = _sim_positions(env, B, seed, dev)
    board = torch.where(done[:, None, None, None], 0, board)
    player = torch.where(done, 0, player)
    mc = torch.where(done, 0, mc)
    stub = exact_stub_evaluator(env)
    tree = fused.Tree(env, B, S, dev)
    obs = env.observation_from_board(board, player).reshape(B, -1)
    fused.root_init_reference(env, cfg, tree, *stub(obs), None, board)
    for s in range(1, COUNT_SIMS + 1):
        fused.descend_leaf_reference(env, cfg, tree, board, player, mc, s)
        fused.apply_reference(tree, s, *stub(tree.obs))
    g = torch.Generator(device=dev).manual_seed(seed)
    case = torch.arange(B, device=dev) % COUNT_CASES
    synth = case < 6
    n = int(synth.sum())
    tree.visit[synth] = torch.rand((n, N), generator=g, device=dev) * 9
    tree.val[synth] = torch.rand((n, N), generator=g, device=dev) * 2 - 1
    tree.child[synth] = torch.randint(-2, N, (n, N, A), generator=g,
                                      device=dev, dtype=torch.int32)
    tree.prior[synth] = torch.rand((n, N, A), generator=g, device=dev)
    for c in range(6):
        games = case == c
        visits, illegal = count_case(A, c)
        tree.child[games, 0] = fused.NO_CHILD
        for a in illegal:
            tree.child[games, 0, a] = fused.ILLEGAL
        for a, v in visits.items():
            tree.child[games, 0, a] = a + 1
            tree.visit[games, a + 1] = v
        total = sum(int(v) for v in visits.values())
        tree.visit[games, 0] = 1.0 if c == 0 else total + 1.5
        tree.val[games, 0] = 0.0 if c == 0 else c * 0.375 - 1.0
    return tree


def check_count_cases(env, counts, policy, root_q):
    """What the root counts must be in each case of :func:`count_trees`."""
    B, A = counts.shape
    dev = counts.device
    case = torch.arange(B, device=dev) % COUNT_CASES
    for c in range(6):
        games = case == c
        visits, _ = count_case(A, c)
        want = np.zeros(A, dtype=np.int32)
        for a, v in visits.items():
            want[a] = int(v)
        total = max(int(want.sum()), 1)
        # numpy's float32 division, correctly rounded (CUDA's division by
        # a scalar multiplies by its reciprocal)
        pol = want.astype(np.float32) / np.float32(total)
        q = np.float32(0.0 if c == 0 else c * 0.375 - 1.0) / np.float32(
            1.0 if c == 0 else total + 1.0)
        assert (counts[games] == torch.from_numpy(want).to(dev)).all(), c
        assert (policy[games] == torch.from_numpy(pol).to(dev)).all(), c
        assert (root_q[games] == float(q)).all(), c
    assert (counts[case == 4, A // 2] == A + 7).all()
    assert (policy[case == 4, A // 2] == 1).all()
    assert (counts[case == 3, 1] == counts[case == 3, A - 1]).all()
    assert (counts[case == 6].sum(-1) == COUNT_SIMS).all()


def dirty_trees(env, B, S, seed, dev):
    """Operands of one ``az_move_root_init`` launch on a tree left dirty:
    visit and val 7.0 everywhere, every edge (the root's too) a sentinel
    (child 12345, prior 3.25) that the rows below the root must keep.  The
    root prior is ``NEG`` on about 20% of actions and on every finished
    game (about a quarter), uniform elsewhere; the value is uniform in
    [-1, 1).  Returns ``(tree, root_prior, value, live)``."""
    A = env.action_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    tree = fused.Tree(env, B, S, dev)
    tree.visit.fill_(7.0)
    tree.val.fill_(7.0)
    tree.child.fill_(12345)
    tree.prior.fill_(3.25)
    live = torch.rand((B,), generator=g, device=dev) >= 0.25
    prior = torch.rand((B, A), generator=g, device=dev)
    cut = torch.rand((B, A), generator=g, device=dev) < 0.2
    prior = torch.where(cut | ~live[:, None], fused.NEG, prior)
    value = torch.rand((B,), generator=g, device=dev) * 2 - 1
    return tree, prior, value, live


def check_dirty_init(tree, before, root_prior, value, live):
    """What the move search's tree init must leave on a tree of
    :func:`dirty_trees` (``before``: the tree before it): every visit and
    val element rewritten, the root's edges from its prior, the rows below
    untouched."""
    one = torch.ones_like(value)
    assert torch.equal(tree.visit[:, 0], torch.where(live, one * 1.5, one))
    assert (tree.visit[:, 1:] == 0).all()
    assert torch.equal(tree.val[:, 0],
                       torch.where(live, -value, torch.zeros_like(value)))
    assert (tree.val[:, 1:] == 0).all()
    ok = root_prior > -1e29
    assert torch.equal(tree.child[:, 0], torch.where(
        ok, fused.NO_CHILD, fused.ILLEGAL).to(torch.int32))
    assert torch.equal(tree.prior[:, 0], torch.where(
        ok, fused.qprior(root_prior), torch.zeros_like(root_prior)))
    assert torch.equal(tree.child[:, 1:], before.child[:, 1:])
    assert torch.equal(tree.prior[:, 1:], before.prior[:, 1:])


@pytest.mark.parametrize("game,B", COUNT_BATCHES)
def test_root_counts_one_launch_bitwise(dev, game, B):
    """az_root_counts against its plain version bit for bit (counts,
    policy, root Q) on the trees of :func:`count_trees` (a finished root,
    illegal and unvisited edges, expanded bits, a tie, one edge, edges past
    the first 32 actions), at batches that fill no CTA, exactly the gate's,
    and one past it (idle groups on the last CTA)."""
    env = make_env(game)
    tree = count_trees(env, B, 41, dev)
    n0 = fused.K_ROOT_COUNTS.launches
    got = fused.root_counts(tree)
    want = fused.root_counts_reference(tree)
    for name, x, y in zip(("counts", "policy", "root_q"), got, want):
        assert torch.equal(x, y), name
    check_count_cases(env, *want)
    assert fused.K_ROOT_COUNTS.launches == n0 + 1


@pytest.mark.parametrize("game,B", COUNT_BATCHES)
def test_move_root_init_one_launch_bitwise(dev, game, B):
    """az_move_root_init against its plain version bit for bit on the whole
    tree of :func:`dirty_trees` (every visit and val element, the root's
    edges, the rows below kept), at N = 401 and 201 (B·N not a multiple of
    4 but at B=128) and the batches of the counts test."""
    env = make_env(game)
    n0 = fused.K_MOVE_ROOT_INIT.launches
    for S in (400, 200):
        tree, prior, value, live = dirty_trees(env, B, S, 42, dev)
        tk, tp = tree.clone(), tree.clone()
        fused.move_root_init(tk, prior, value, live)
        fused.move_root_init_reference(tp, prior, value, live)
        for f in ("visit", "val", "child", "prior"):
            assert torch.equal(getattr(tk, f), getattr(tp, f)), (S, f)
        check_dirty_init(tp, tree, prior, value, live)
    assert fused.K_MOVE_ROOT_INIT.launches == n0 + 2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_vit_forward_on_the_card_close_to_cpu(dev, dtype, tol):
    """The ViT's plain forward (gomoku 7×7, embedding 512, patch 5, 8
    heads, the preset's widths) on the card against the same forward on
    the CPU: float32 (no TF32) within 1e-4, bf16 (another summation order)
    within 5e-2 on logits and value."""
    env = make_env("gomoku")
    model = build_model(ModelConfig(family="vit", embed_dim=512, patch_size=5,
                                    num_heads=8, depth=1,
                                    compute_dtype=dtype), env)
    params = init_params(model, torch.Generator().manual_seed(0))
    boards, players = _positions(env, 64, 2, torch.device("cpu"))
    obs = env.observation_from_board(boards, players)
    want = torch.func.functional_call(model, params, (obs,))
    model_d = model.to(dev)
    got = torch.func.functional_call(
        model_d, {k: v.to(dev) for k, v in params.items()}, (obs.to(dev),))
    for a, b in zip(got, want):
        assert float((a.float().cpu() - b.float()).abs().max()) <= tol


def _graph_model(name, dev, seed=0):
    """The preset's network and fresh weights on the card."""
    from alphazero_tpu_torch.config import preset
    cfg = preset(name)
    env = make_env(cfg.env)
    model = build_model(cfg.model, env).to(dev)
    params = {k: v.to(dev) for k, v in init_params(
        model, torch.Generator().manual_seed(seed)).items()}
    return env, model, params


def _graph_obs(env, B, seed, dev):
    return env.observation_from_board(*_positions(env, B, seed, dev))


@pytest.mark.parametrize("name,B", [("gomoku7-reference", 256),
                                    ("gomoku7-reference", 1),
                                    ("connect4", 1),
                                    ("gomoku15-alphazero", 256)])
def test_graphed_evaluator_equals_the_eager_forward(dev, name, B):
    """From the shape's CAPTURE_AT-th call on, the evaluator replays a CUDA
    graph, whose outputs equal the eager forward's bit for bit: the ViT of
    ``gomoku7-reference`` at self-play's B=256 and at B=1, the connect4
    dense tower at the root's B=1, AlphaZero's 19×256 batch-norm tower at
    self-play's B=256."""
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    env, model, params = _graph_model(name, dev)
    ev = make_eval_fn(model, params)
    calls = CAPTURE_AT + 3
    for k in range(calls):
        obs = _graph_obs(env, B, 100 + k, dev)
        probs, value = ev(obs)
        with torch.no_grad():
            want_p, want_v = ev.forward(obs)
        gap = max(float((probs - want_p).abs().max()),
                  float((value - want_v).abs().max()))
        assert torch.equal(probs, want_p) and torch.equal(value, want_v), (
            k, gap)
    assert (ev.captures, ev.replays) == (1, calls - CAPTURE_AT + 1)


def test_graphed_outputs_are_not_changed_by_the_next_call(dev):
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    env, model, params = _graph_model("gomoku7-reference", dev)
    ev = make_eval_fn(model, params)
    for k in range(CAPTURE_AT):
        ev(_graph_obs(env, 256, k, dev))
    assert ev.captures == 1
    p1, v1 = ev(_graph_obs(env, 256, 50, dev))
    keep = (p1.clone(), v1.clone())
    p2, v2 = ev(_graph_obs(env, 256, 51, dev))
    torch.cuda.synchronize()
    assert torch.equal(p1, keep[0]) and torch.equal(v1, keep[1])
    assert not torch.equal(p1, p2)
    assert p1.data_ptr() != p2.data_ptr()


def test_graph_sees_an_in_place_parameter_update(dev):
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    env, model, params = _graph_model("gomoku7-reference", dev)
    ev = make_eval_fn(model, params)
    obs = _graph_obs(env, 256, 7, dev)
    for _ in range(CAPTURE_AT):
        before = ev(obs)
    assert ev.captures == 1
    with torch.no_grad():
        for w in params.values():
            w.mul_(1.25).add_(0.01)
    p, v = ev(obs)
    with torch.no_grad():
        want_p, want_v = ev.forward(obs)
    assert torch.equal(p, want_p) and torch.equal(v, want_v)
    assert not torch.equal(p, before[0])
    assert ev.replays == 2


def test_graph_sees_an_in_place_running_statistic_update(dev):
    """AlphaZero's tower folds its batch norms inside the forward, so the
    replayed graph reads a running statistic updated in place."""
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    env, model, params = _graph_model("gomoku15-alphazero", dev)
    ev = make_eval_fn(model, params)
    obs = _graph_obs(env, 256, 7, dev)
    for _ in range(CAPTURE_AT):
        before = ev(obs)
    assert ev.captures == 1
    with torch.no_grad():
        params["block_3.bn2.running_var"].mul_(4.0)
        params["block_3.bn2.running_mean"].add_(0.5)
    p, v = ev(obs)
    with torch.no_grad():
        want_p, want_v = ev.forward(obs)
    assert torch.equal(p, want_p) and torch.equal(v, want_v)
    assert not torch.equal(p, before[0])
    assert ev.replays == 2


def test_resnet_bn_bf16_forward_within_the_cells_logit_gap(dev):
    """AlphaZero's tower at its widths (256 × 19, gomoku15, B=256, bf16,
    batch norm folded into the convolutions), its state calibrated by the
    float32 reference on 512 positions, against the float32 reference on
    the card (the unfolded product, no cuDNN): the mean widest logit gap
    lies within the ``gomoku15-alphazero.selfplay-deep`` cell's limit."""
    import json
    import pathlib
    from alphazero_tpu_torch.models import make_eval_fn
    from azbench import check, harness
    from azbench.reference import games, nets
    root = pathlib.Path(__file__).resolve().parents[1]
    limit = json.loads((root / "azbench" / "workloads" /
                        "gomoku15-alphazero.selfplay-deep.json").read_text())[
        "limits"]["logit_gap"]
    env, model, params = _graph_model("gomoku15-alphazero", dev, seed=3)
    g = games.game("gomoku15")
    spec = {"family": "resnet_bn", "channels": 256, "blocks": 19}
    calib = harness.random_positions(
        g, 512, torch.Generator(device=dev).manual_seed(4), dev)
    params.update(nets.Net(spec, g, params).state(calib))
    obs = harness.random_positions(
        g, 256, torch.Generator(device=dev).manual_seed(5), dev)
    probs, value = make_eval_fn(model, params)(obs)
    gaps = torch.cat(check.logit_gaps(nets.Net(spec, g, params),
                                      [(obs, probs, value)]))
    assert float(gaps.mean()) < limit, float(gaps.mean())


def test_graph_capture_and_replay_under_the_profiler(dev):
    """As in the benchmark's traced stretch: a fresh evaluator captures
    and replays while a torch.profiler records the card, every replay is
    a ``model.graph`` span, and the outputs are the eager forward's."""
    from torch.profiler import ProfilerActivity, profile
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    from alphazero_tpu_torch.utils import profiling
    env, model, params = _graph_model("gomoku7-reference", dev)
    ev = make_eval_fn(model, params)
    obs = [_graph_obs(env, 256, 20 + k, dev) for k in range(CAPTURE_AT + 2)]
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [ev(o) for o in obs]
        torch.cuda.synchronize()
    t = profiling.totals()
    profiling.reset()
    assert ev.captures == 1 and ev.replays == 3
    assert t["model.forward"][0] == len(obs)
    assert t["model.graph"][0] == ev.replays
    from torch.autograd import DeviceType
    assert any(e.device_type == DeviceType.CUDA for e in prof.events())
    with torch.no_grad():
        for o, (p, v) in zip(obs, outs):
            want_p, want_v = ev.forward(o)
            assert torch.equal(p, want_p) and torch.equal(v, want_v)


def test_a_model_that_runs_collectives_is_never_captured_on_the_card(dev):
    """``TPViT`` all-reduces inside its forward: a model flagged as it is
    flagged keeps the eager forward on the card."""
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    from alphazero_tpu_torch.parallel import TPViT
    assert TPViT.runs_collectives
    env, model, params = _graph_model("gomoku7-reference", dev)
    model.runs_collectives = True
    ev = make_eval_fn(model, params)
    obs = _graph_obs(env, 256, 3, dev)
    for _ in range(CAPTURE_AT + 2):
        p, v = ev(obs)
    with torch.no_grad():
        want_p, _ = ev.forward(obs)
    assert (ev.captures, ev.replays) == (0, 0)
    assert torch.equal(p, want_p)


# ---------------------------------------------------------------------------
# the move search's simulations as one CUDA graph (fused.MoveGraphs)
# ---------------------------------------------------------------------------

@pytest.fixture
def graphs(monkeypatch):
    """A fresh graph cache for the test's move searches."""
    g = fused.MoveGraphs()
    monkeypatch.setattr(fused, "MOVE_GRAPHS", g)
    return g


def _gate_cfg(**kw):
    import dataclasses
    from alphazero_tpu_torch.config import preset
    return dataclasses.replace(preset("connect4").mcts, **kw)


def _move_both(env, model, params, eval_fn, roots, cfg, dev, **kw):
    """The search as ``agent_move`` and the gate run it (its own forward,
    which the cache may replay as a graph) and the same search with the
    dense kernel passed as the ``evaluator`` (always eager)."""
    got = fused.run_mcts_fused(env, model, params, eval_fn, *roots, cfg,
                               device=dev, **kw)
    packed = fused.pack_dense_params(model, params, dev)
    want = fused.run_mcts_fused(
        env, model, params, eval_fn, *roots, cfg, device=dev,
        evaluator=lambda o: fused.dense_forward(o, packed), **kw)
    return got, want


RESULT = ("visit_counts", "policy", "root_q")


def _same_search(got, want):
    for name in RESULT:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("B", [1, 128])
def test_move_graph_equals_the_eager_search(dev, graphs, B):
    """connect4's tower at S=200: every search of a run of consecutive
    ones at one shape, the capture's and the replays', gives the eager
    search's visit counts, policy and root Q bit for bit, on live, won and
    drawn roots (at B=1 one root a search; at B=128 with root noise)."""
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    env, model, params = _graph_model("connect4", dev)
    eval_fn = make_eval_fn(model, params)
    calls = CAPTURE_AT + 5
    if B == 1:
        cfg = _gate_cfg(use_dirichlet=False)
        pool = _move_positions(env, 128, 30, dev)
        dones = pool[3]
        rows = [0, int(torch.nonzero(dones[:-1])[0]), 127, 1, 2,
                int(torch.nonzero(dones[:-1])[-1]), 3, 4]
        assert len(rows) == calls
    else:
        cfg = _gate_cfg()
    for k in range(calls):
        kw = {}
        if B == 1:
            roots = tuple(x[rows[k]:rows[k] + 1] for x in pool)
        else:
            roots = _move_positions(env, B, 40 + k, dev)
            g = torch.Generator(device=dev).manual_seed(50 + k)
            kw["noise"] = fused.dirichlet_noise(1, env.action_dim, B, 0.3, g,
                                                dev)[0].T
        got, want = _move_both(env, model, params, eval_fn, roots, cfg, dev,
                               **kw)
        _same_search(got, want)
        sums = got.visit_counts.sum(-1)
        assert (sums[~roots[3]] == cfg.num_simulations - 1).all()
        assert (sums[roots[3]] == 0).all()
        assert graphs.captures == int(k + 1 >= CAPTURE_AT)
        assert graphs.replays == max(0, k + 2 - CAPTURE_AT)


def test_move_graph_takes_each_searchs_params(dev, graphs):
    """The gate's case at B=128: two players' params alternating at one
    shape, then an in-place update of one weight (as a learner's step
    makes it); each search equals the eager one with its own weights, and
    a result kept from an earlier search is left as it was."""
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    env, model, p0 = _graph_model("connect4", dev, seed=0)
    _, _, p1 = _graph_model("connect4", dev, seed=1)
    players = [(p0, make_eval_fn(model, p0)), (p1, make_eval_fn(model, p1))]
    cfg = _gate_cfg(use_dirichlet=False)
    calls = 2 * CAPTURE_AT + 2
    kept = None
    for k in range(calls):
        params, eval_fn = players[k % 2]
        roots = _move_positions(env, 128, 60 + k, dev)
        got, want = _move_both(env, model, params, eval_fn, roots, cfg, dev)
        _same_search(got, want)
        if k == CAPTURE_AT:
            kept = (got, {n: getattr(got, n).clone() for n in RESULT})
    assert (graphs.captures, graphs.replays) == (1, calls - CAPTURE_AT + 1)
    roots = _move_positions(env, 128, 90, dev)
    params, eval_fn = players[0]
    before, _ = _move_both(env, model, params, eval_fn, roots, cfg, dev)
    with torch.no_grad():
        params["block_0.fc1.weight"].mul_(-1.5)
    got, want = _move_both(env, model, params, eval_fn, roots, cfg, dev)
    _same_search(got, want)
    assert not torch.equal(got.visit_counts, before.visit_counts)
    torch.cuda.synchronize()
    for n, c in kept[1].items():
        assert torch.equal(getattr(kept[0], n), c), n


def test_move_graph_capture_and_replay_under_the_profiler(dev, graphs):
    """As in a profiled gate: the key's capture and its replays while a
    torch.profiler records the card, a ``search.graph`` span a replay, and
    the results the eager search's."""
    from torch.profiler import ProfilerActivity, profile
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    from alphazero_tpu_torch.utils import profiling
    env, model, params = _graph_model("connect4", dev)
    eval_fn = make_eval_fn(model, params)
    cfg = _gate_cfg(use_dirichlet=False)
    roots = [_move_positions(env, 128, 70 + k, dev)
             for k in range(CAPTURE_AT + 2)]
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = [fused.run_mcts_fused(env, model, params, eval_fn, *r, cfg,
                                    device=dev) for r in roots]
        torch.cuda.synchronize()
    t = profiling.totals()
    profiling.reset()
    assert (graphs.captures, graphs.replays) == (1, 3)
    assert t["search.graph"][0] == 3 and t["search.sims"][0] == len(roots)
    from torch.autograd import DeviceType
    assert any(e.device_type == DeviceType.CUDA for e in prof.events())
    for r, g in zip(roots, got):
        _, want = _move_both(env, model, params, eval_fn, r, cfg, dev)
        _same_search(g, want)


def _chunk_roots(env, B, seed, dev):
    """B live chunk roots: random legal play stopped at each game's own
    length, finished games reset to an empty board, as the collector hands
    them in."""
    g = torch.Generator().manual_seed(seed)
    st = env.init(B)
    target = torch.randint(0, 16, (B,), generator=g)
    for t in range(16):
        mask = (env.valid_mask(st) & (t < target)[:, None]
                & ~st.done[:, None])
        act = torch.where(mask, torch.rand(mask.shape, generator=g), -1.0
                          ).argmax(-1).to(torch.int32)
        nxt = env.step(st, act)
        live = mask.any(-1)
        st = type(st)(*(torch.where(
            live.reshape((B,) + (1,) * (getattr(st, f).dim() - 1)),
            getattr(nxt, f), getattr(st, f)) for f in vars(st)))
    board = torch.where(st.done[:, None, None, None], 0, st.board)
    player = torch.where(st.done, 0, st.current_player).to(torch.int32)
    mc = torch.where(st.done, 0, st.move_count).to(torch.int32)
    return board.to(dev), player.to(dev), mc.to(dev)


@pytest.mark.parametrize("name,B,M", [("connect4", 512, 4),
                                      ("gomoku9-dense", 32, 2)])
def test_chunk_graph_equals_the_eager_chunk(dev, graphs, name, B, M):
    """The collector's chunk on its own forward: every call of a run at
    one shape, the eager ones, the capture's and the replays', gives the
    records and final state of the same chunk run eagerly with the dense
    kernel passed as the ``evaluator``, bit for bit, with root noise and
    temperature sampling (connect4's preset tower at self-play's B=512 and
    S=200; gomoku9-dense's at B=32 and S=400, a second key).  The key's
    CAPTURE_AT-th call captures and every move from then on replays; a
    replayed chunk's result is left as it was by the next call."""
    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.ops.graphs import CAPTURE_AT
    env, model, params = _graph_model(name, dev)
    cfg = preset(name).mcts
    assert cfg.use_dirichlet and cfg.temperature_moves > 0
    packed = fused.pack_dense_params(model, params, dev)
    kept = None
    for k in range(CAPTURE_AT + 2):
        roots = _chunk_roots(env, B, 80 + k, dev)
        g = torch.Generator(device=dev).manual_seed(90 + k)
        draws = dict(
            noise=fused.dirichlet_noise(M, env.action_dim, B,
                                        cfg.dirichlet_alpha, g, dev),
            unif=torch.rand((M, B), generator=g, device=dev))
        got = fused.run_selfplay_chunk(env, model, params, *roots, cfg, M,
                                       device=dev, **draws)
        want = fused.run_selfplay_chunk(
            env, model, params, *roots, cfg, M, device=dev,
            evaluator=lambda o: fused.dense_forward(o, packed), **draws)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (k, key)
        assert graphs.captures == int(k + 1 >= CAPTURE_AT)
        assert graphs.replays == M * max(0, k + 2 - CAPTURE_AT)
        if k + 1 == CAPTURE_AT:
            kept = (got, {n: v.clone() for n, v in got.items()})
    torch.cuda.synchronize()
    for n, c in kept[1].items():
        assert torch.equal(kept[0][n], c), n
