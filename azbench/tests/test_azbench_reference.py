"""The benchmark's plain reference against alphazero_tpu_torch on the CPU, at
a tiny size: the rules, the forwards of every family and both search
engines; and the lookup of a family's file."""

from __future__ import annotations

import dataclasses
import hashlib

import pytest
import torch
from torch.func import functional_call

from alphazero_tpu_torch.config import MCTSConfig, ModelConfig
from alphazero_tpu_torch.envs import make_env
from alphazero_tpu_torch.models import build_model
from alphazero_tpu_torch.search import fused, sim
from alphazero_tpu_torch.training.selfplay import init_selfplay, selfplay_step
from azbench import counts, harness
from azbench.reference import games, nets, search
from azbench.weights import make_params


def random_positions(env, B, gen, plies):
    """B live positions after ``plies[b]`` random legal moves."""
    state = env.init(B, "cpu")
    for t in range(max(plies)):
        mask = env.valid_mask(state) & torch.tensor(
            [t < p for p in plies])[:, None]
        live = mask.any(-1)
        noise = torch.rand(mask.shape, generator=gen)
        act = torch.where(mask, noise, -1.0).argmax(-1).to(torch.int32)
        nxt = env.step(state, act)
        for k in vars(state):
            old, new = getattr(state, k), getattr(nxt, k)
            sel = (live & ~nxt.done).reshape((B,) + (1,) * (old.dim() - 1))
            setattr(state, k, torch.where(sel, new, old))
    return state


def stub(obs):
    """An exact evaluator of any observation layout: a fixed float64
    function of the planes, rounded once to float32."""
    B = obs.shape[0]
    x = obs.reshape(B, -1).double()
    n = x.shape[1]
    w = torch.sin(torch.arange(n * 50, dtype=torch.float64).reshape(n, 50))
    h = torch.tanh(x @ w)
    A = 7 if n == 126 else n // 2
    logits = h[:, :A] * 3.0 + h[:, -A:]
    return (torch.softmax(logits, -1).float(),
            torch.tanh(h.sum(-1) / 5.0).float())


@pytest.mark.parametrize("env_name", ["connect4", "gomoku"])
def test_rules_match(env_name):
    env, g = make_env(env_name), games.game(env_name)
    gen = torch.Generator().manual_seed(3)
    st = random_positions(env, 16, gen, [int(x) for x in
                                          torch.randint(0, 20, (16,),
                                                        generator=gen)])
    assert torch.equal(g.legal(st.board), env.valid_mask_board(
        st.board, st.move_count))
    obs = g.observation(st.board, st.current_player)
    assert torch.equal(obs, env.observation_from_board(st.board,
                                                       st.current_player))
    assert torch.equal(g.board_from_observation(obs, st.current_player),
                       st.board)
    legal = g.legal(st.board)
    act = torch.where(legal, torch.rand(legal.shape, generator=gen),
                      -1.0).argmax(-1)
    nxt = env.step(st, act.to(torch.int32))
    assert torch.equal(g.play(st.board, st.current_player, act), nxt.board)
    assert torch.equal(g.won(nxt.board, st.current_player),
                       nxt.winner == st.current_player)


# each family's port module and the board it is held on
PORT_MODELS = {
    "dense": (ModelConfig(family="dense", width=64, blocks=2,
                          compute_dtype="float32"), "connect4"),
    "vit": (ModelConfig(family="vit", embed_dim=32, num_heads=4, depth=1,
                        patch_size=5, compute_dtype="float32"), "gomoku"),
    "resnet": (ModelConfig(family="resnet", channels=16, blocks=2,
                           compute_dtype="float32"), "gomoku9"),
}


@pytest.mark.parametrize("family", ["dense", "vit", "resnet"])
def test_forward_matches_port(family):
    mcfg, env_name = PORT_MODELS[family]
    env, g = make_env(env_name), games.game(env_name)
    model = build_model(mcfg, env)
    params = make_params(nets.param_specs(dataclasses.asdict(mcfg), g), 11,
                         torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(p.shape) for k, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(5)
    st = random_positions(env, 8, gen, list(range(0, 16, 2)))
    obs = env.observation_from_board(st.board, st.current_player)
    logits, value = functional_call(model, params, (obs,))
    probs, v = nets.Net(dataclasses.asdict(mcfg), g, params)(obs)
    torch.testing.assert_close(probs, torch.softmax(logits, -1), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(v, value, rtol=1e-4, atol=1e-5)
    p8, v8 = nets.Net(dataclasses.asdict(mcfg), g, params, "fp8")(obs)
    assert (p8 - probs).abs().max() > 1e-3


@pytest.mark.cuda
def test_resnet_reference_on_the_card_matches_the_cpu():
    """At gomoku15's width 192 × 10 blocks and B=256, where cuDNN's float32
    convolutions read wrong, the ResNet reference on the card agrees with
    the same reference on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env, g = make_env("gomoku15"), games.game("gomoku15")
    model = {"family": "resnet", "channels": 192, "blocks": 10}
    gen = torch.Generator().manual_seed(5)
    plies = torch.randint(0, 60, (256,), generator=gen).tolist()
    st = random_positions(env, 256, gen, plies)
    obs = env.observation_from_board(st.board, st.current_player)
    params = make_params(nets.param_specs(model, g), 1, torch.device("cpu"))
    probs, value = nets.Net(model, g, params)(obs)
    dev = torch.device("cuda")
    p, v = nets.Net(model, g, {k: t.to(dev) for k, t in params.items()})(
        obs.to(dev))
    torch.testing.assert_close(p.cpu(), probs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v.cpu(), value, rtol=1e-4, atol=1e-5)


def _digest(*xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(x.contiguous().numpy().tobytes() if torch.is_tensor(x)
                 else repr(x).encode())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("family,model,env_name,frozen", [
    ("dense", {"family": "dense", "width": 64, "blocks": 2}, "connect4",
     ("e1141778b6306b8f", "7c593e3d6cbaed13", "d84b84c969903d16")),
    ("vit", {"family": "vit", "embed_dim": 32, "num_heads": 4, "depth": 1,
             "patch_size": 5}, "gomoku",
     ("52e258bc9850c138", "4174830d89b39d23", "aec4264f443beae8")),
    ("resnet_bn", {"family": "resnet_bn", "channels": 16, "blocks": 2},
     "gomoku9", ("1db596d97eee73ba", "b5a39fcc200317af", "5d97cb1a5043eceb",
                 "48512a73dc5a9890")),
])
def test_family_reproduces_frozen(family, model, env_name, frozen):
    """Digests of the parameter specs and of the exact float32 CPU outputs
    (float32 and fp8) that the dense and ViT references gave before they
    moved into their family files; for a family with state, the outputs
    on the state calibrated on the harness's positions, and that state."""
    g = games.game(env_name)
    specs = nets.param_specs(model, g)
    params = make_params(specs, 11, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    obs = (torch.rand((8, g.feature_dim, g.rows, g.cols), generator=gen)
           < 0.3).float()
    net = nets.Net(model, g, params)
    state = net.state(harness.random_positions(
        g, harness.CALIBRATION_POSITIONS, torch.Generator().manual_seed(4),
        torch.device("cpu"))) if hasattr(net.family, "state") else {}
    params.update(state)
    got = (_digest(specs), _digest(*nets.Net(model, g, params)(obs)),
           _digest(*nets.Net(model, g, params, "fp8")(obs)))
    if state:
        got += (_digest(*state, *state.values()),)
    assert got == frozen


def test_unknown_family_raises():
    """A family with no file is refused everywhere, never run or counted as
    another family."""
    g = games.game("gomoku")
    model = {"family": "mlp_mixer", "embed_dim": 32, "depth": 1,
             "patch_size": 5}
    for call in (lambda: nets.param_specs(model, g),
                 lambda: nets.Net(model, g, {}),
                 lambda: counts.model_flops_per_pos(model, g)):
        with pytest.raises(ValueError, match=r"families/mlp_mixer\.py"):
            call()
    with pytest.raises(ValueError, match="not a file"):
        nets.family("../nets")


TOY_FAMILY = '''
import torch

from azbench.reference.nets import linear_specs


def param_specs(model, g):
    return linear_specs("head", g.action_dim + 1, g.feature_dim * g.cells)


def forward(net, obs):
    out = net._linear(obs.reshape(obs.shape[0], -1), "head")
    return out[:, :-1], torch.tanh(out[:, -1])


def flops_per_pos(model, g):
    return 2.0 * (g.action_dim + 1) * g.feature_dim * g.cells
'''


def test_family_file_found_in_directory(tmp_path):
    """A family file in another directory is found by its name through the
    lookup's directory argument, and a Net runs its forward."""
    (tmp_path / "toy.py").write_text(TOY_FAMILY)
    g, model = games.game("gomoku"), {"family": "toy"}
    toy = nets.family("toy", tmp_path)
    specs = toy.param_specs(model, g)
    assert specs == [("head.weight", (50, 98), "lecun"),
                     ("head.bias", (50,), "zeros")]
    assert toy.flops_per_pos(model, g) == 9800.0
    params = make_params(specs, 3, torch.device("cpu"))
    obs = torch.zeros((2, 2, 7, 7))
    obs[:, 0, 3, 3] = 1.0
    probs, value = nets.Net(model, g, params, directory=tmp_path)(obs)
    assert probs.shape == (2, 49) and value.shape == (2,)
    w = params["head.weight"]
    torch.testing.assert_close(value, torch.tanh(w[-1, 24]).expand(2))
    with pytest.raises(ValueError):
        nets.param_specs(model, g)


def test_chunk_search_matches_port():
    """The whole-move search (quantized priors, inverse-CDF action) at B=4,
    24 simulations, Dirichlet noise, on the port's plain chunk."""
    torch.manual_seed(0)
    env, g = make_env("connect4"), games.game("connect4")
    cfg = MCTSConfig(num_simulations=24, dirichlet_alpha=0.3,
                     formula="alphazero")
    model = build_model(ModelConfig(family="dense", width=64, blocks=1), env)
    gen = torch.Generator().manual_seed(7)
    st = random_positions(env, 4, gen, [0, 3, 9, 14])
    M, A, B = 2, env.action_dim, 4
    noise = torch.distributions.Dirichlet(torch.full((A,), 0.3)).sample(
        (M, B)).permute(0, 2, 1).contiguous()
    unif = torch.rand((M, B), generator=gen)
    rec = fused.run_selfplay_chunk(
        env, model, None, st.board, st.current_player, st.move_count, cfg,
        M, noise=noise, unif=unif, evaluator=stub, device="cpu")
    board, player, mc = st.board, st.current_player, st.move_count
    for m in range(M):
        if m:
            player = rec["player"][m]
            board = g.board_from_observation(rec["obs"][m].float(), player)
            mc = rec["t"][m]
        counts = search.search(g, stub, board, player, mc, 24, "alphazero",
                               noise=noise[m].T, quantize=True)
        assert torch.equal(counts, torch.round(rec["policy"][m] * 23))
        act = search.inverse_cdf_action(rec["policy"][m], unif[m], mc, 8)
        assert torch.equal(act.to(torch.int32), rec["action"][m])


def test_sim_search_and_step_match_port():
    """The per-simulation engine (exact priors, reference formula) and the
    move-by-move self-play's action at gomoku 7×7, B=4, 24 simulations."""
    torch.manual_seed(0)
    env, g = make_env("gomoku"), games.game("gomoku")
    cfg = MCTSConfig(num_simulations=24, formula="reference",
                     temperature_moves=8)
    gen = torch.Generator().manual_seed(9)
    sp = init_selfplay(env, 4, 1, "cpu")
    sp.env_state = random_positions(env, 4, gen, [0, 2, 7, 12])
    sp.t = sp.env_state.move_count.clone()
    A = env.action_dim
    noise = torch.distributions.Dirichlet(torch.full((A,), 0.03)).sample(
        (4,))
    gumbel = -torch.log(-torch.log(torch.rand((4, A), generator=gen)))
    s = sp.env_state
    res = sim.run_mcts_sim(env, stub, s.board, s.current_player,
                           s.move_count, s.done, cfg, noise=noise,
                           device="cpu")
    counts = search.search(g, stub, s.board, s.current_player, s.move_count,
                           24, "reference", noise=noise)
    assert torch.equal(counts, res.visit_counts.float())
    from alphazero_tpu_torch.data import create
    buf = create(env, 49 * 8, "cpu")
    after, _ = selfplay_step(env, stub, cfg, sp, buf, noise=noise,
                             gumbel=gumbel)
    ar = torch.arange(4)
    policy = after.traj_policy[ar, sp.t.long()]
    assert torch.equal(policy, res.policy)
    act = search.gumbel_action(policy, gumbel, sp.t, 8)
    assert torch.equal(g.play(s.board, s.current_player, act),
                       after.env_state.board)
