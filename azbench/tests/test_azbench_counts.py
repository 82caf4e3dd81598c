"""The yardstick's counts from shapes against the bounds PERF.md keeps
(chip_smoke.py's arithmetic)."""

import pytest

from azbench import counts
from azbench.reference.games import game

C4 = {"family": "dense", "width": 512, "blocks": 2}
VIT = {"family": "vit", "embed_dim": 512, "depth": 1, "patch_size": 5}


def resnet(channels, blocks):
    return {"family": "resnet", "channels": channels, "blocks": blocks}


def test_dense_forward_bound_connect4():
    """0.00135 ms at connect4 B=512, bound by operations (PERF.md §6)."""
    s, by = counts.dense_forward_bound(C4, game("connect4"), 512)
    assert round(s * 1e3, 5) == 0.00135 and by == "operations"


def test_sim_step_bound_gomoku7():
    """The shape bound at gomoku 7×7 B=256 counts a one-ply walk: 0.000191
    ms (bytes), under phase 12's 0.00020 ms from the path's own walks."""
    s, by = counts.sim_step_bound(game("gomoku"), 256, 100)
    assert round(s * 1e3, 6) == 0.000191 and by == "bytes"
    assert s * 1e3 < 0.00020


@pytest.mark.parametrize("model,env,flops", [
    (C4, "connect4", 2_505_728.0), (VIT, "gomoku", 322_201_600.0),
    # the gomoku15 preset, the connect4-resnet preset, AlphaZero's widths
    (resnet(192, 10), "gomoku15", 2_987_726_400.0),
    (resnet(64, 4), "connect4", 24_931_200.0),
    (resnet(256, 19), "gomoku15", 10_088_308_800.0),
    # AlphaZero's network with batch norm at its widths
    ({"family": "resnet_bn", "channels": 256, "blocks": 19}, "gomoku15",
     10_088_308_800.0)])
def test_model_flops(model, env, flops):
    assert counts.model_flops_per_pos(model, game(env)) == flops


def test_bound_kinds():
    assert counts.bound_s(3.35e12)[0] == pytest.approx(1.0)
    assert counts.bound_s(0, bf16_ops=989e12) == (1.0, "operations")
    assert counts.bound_s(0, f32_ops=67e12)[0] == pytest.approx(1.0)
