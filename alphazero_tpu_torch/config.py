"""Configuration dataclasses and per-game presets.

A field-for-field copy of the JAX package's configuration tree, so that a
preset serialises to the same JSON in both packages.  The Pallas tuning
fields (``nseg``, ``desc_unroll``, ``backup_unroll``, ``fwd_nway``) are kept
for that reason only: the CUDA kernels of this package do not read them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """Search hyperparameters.

    ``formula='reference'`` is PUCT with no exploration constant,
    ``Q + prior·√N_parent/(n_child+1)``; ``'alphazero'`` scales the
    exploration term by ``c_puct``.
    """

    num_simulations: int = 100
    formula: str = "reference"  # 'reference' | 'alphazero'
    c_puct: float = 1.25
    dirichlet_eps: float = 0.25
    dirichlet_alpha: float = 0.03
    use_dirichlet: bool = True
    # moves before which actions are visit-sampled rather than argmax
    temperature_moves: int = 8
    leaf_batch: int = 1
    virtual_loss: float = 1.0
    # tuning fields of the JAX package's Pallas kernels (see module note)
    nseg: Optional[int] = None
    desc_unroll: Optional[int] = None
    backup_unroll: Optional[int] = None
    fwd_nway: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Policy/value network: the ViT (``'vit'``, embedding, depth, patch,
    heads, dropout), the LayerNorm conv ResNet (``'resnet'``, channels,
    blocks), AlphaZero's batch-norm conv ResNet (``'resnet_bn'``,
    channels, blocks; the port's own) or the dense tower (``'dense'``,
    width, blocks)."""

    family: str = "vit"  # 'vit' | 'resnet' | 'resnet_bn' | 'dense'
    embed_dim: int = 512
    patch_size: int = 5
    num_heads: int = 8
    depth: int = 1
    dropout: float = 0.1
    channels: int = 64
    blocks: int = 4
    width: int = 512
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    capacity: int = 100_000
    augment_skip_moves: int = 2
    augment: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 512
    learning_rate: float = 2.5e-4
    l2_coeff: float = 1e-4
    train_steps_per_iter: Optional[int] = None
    games_per_iter: int = 128
    selfplay_batch: int = 256
    gate_enabled: bool = True
    gate_threshold: float = 0.55
    gate_games: int = 256
    reject_double_after: int = 2
    outer_iterations: int = 1000
    vanilla_eval_every: int = 15
    seed: int = 0
    # self-play moves per chunk (None = training/loop.py's default of 32)
    selfplay_chunk_steps: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    env: str = "connect4"
    mcts: MCTSConfig = MCTSConfig()
    model: ModelConfig = ModelConfig()
    replay: ReplayConfig = ReplayConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()


def to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=1)


def from_json(s: str) -> Config:
    """The ``Config`` of a :func:`to_json` text, written by either
    package."""
    d = json.loads(s)
    return Config(
        env=d["env"],
        mcts=MCTSConfig(**d["mcts"]),
        model=ModelConfig(**d["model"]),
        replay=ReplayConfig(**d["replay"]),
        train=TrainConfig(**d["train"]),
        mesh=MeshConfig(**d.get("mesh", {})),
    )


def save_config(cfg: Config, workdir: str):
    """Write ``workdir/config.json``, beside the run's checkpoints."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.json"), "w") as f:
        f.write(to_json(cfg))


def load_config(workdir: str) -> Optional[Config]:
    """The config stored beside a run's checkpoints, or None."""
    path = os.path.join(workdir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return from_json(f.read())


def preset(name: str) -> Config:
    presets = {
        "tictactoe": Config(
            env="tictactoe",
            mcts=MCTSConfig(num_simulations=50, dirichlet_alpha=0.35,
                            temperature_moves=4),
            model=ModelConfig(family="resnet", channels=32, blocks=2),
            train=TrainConfig(batch_size=256, selfplay_batch=256,
                              games_per_iter=256),
            replay=ReplayConfig(capacity=50_000),
        ),
        # flagship: 200 sims/move, 512 parallel games, dense tower 512×2
        "connect4": Config(
            env="connect4",
            mcts=MCTSConfig(num_simulations=200, dirichlet_alpha=0.3,
                            nseg=10),
            model=ModelConfig(family="dense", width=512, blocks=2),
            train=TrainConfig(batch_size=512, selfplay_batch=512,
                              games_per_iter=512),
        ),
        "connect4-resnet": Config(
            env="connect4",
            mcts=MCTSConfig(num_simulations=200, dirichlet_alpha=0.3),
            model=ModelConfig(family="resnet", channels=64, blocks=4),
            train=TrainConfig(batch_size=512, selfplay_batch=512,
                              games_per_iter=512),
        ),
        "gomoku9": Config(
            env="gomoku9",
            mcts=MCTSConfig(num_simulations=400, dirichlet_alpha=0.1),
            model=ModelConfig(family="resnet", channels=128, blocks=8),
            train=TrainConfig(batch_size=512, selfplay_batch=256,
                              games_per_iter=256),
        ),
        "gomoku9-dense": Config(
            env="gomoku9",
            mcts=MCTSConfig(num_simulations=400, dirichlet_alpha=0.1),
            model=ModelConfig(family="dense", width=512, blocks=2),
            train=TrainConfig(batch_size=512, selfplay_batch=256,
                              games_per_iter=256),
        ),
        "gomoku15": Config(
            env="gomoku15",
            mcts=MCTSConfig(num_simulations=400, dirichlet_alpha=0.03),
            model=ModelConfig(family="resnet", channels=192, blocks=10),
            train=TrainConfig(batch_size=1024, selfplay_batch=256,
                              games_per_iter=256),
            replay=ReplayConfig(capacity=500_000),
        ),
        # AlphaZero's network and search (Silver et al., Science 2018) on
        # gomoku 15x15: the 19x256 batch-norm tower, 800 simulations, 30
        # visit-sampled moves, no gate; one self-play move a chunk.  The
        # port's own: the JAX package has no batch-norm tower.
        "gomoku15-alphazero": Config(
            env="gomoku15",
            mcts=MCTSConfig(num_simulations=800, formula="alphazero",
                            c_puct=1.25, dirichlet_eps=0.25,
                            dirichlet_alpha=0.03, temperature_moves=30),
            model=ModelConfig(family="resnet_bn", channels=256, blocks=19),
            train=TrainConfig(batch_size=1024, selfplay_batch=256,
                              games_per_iter=256, gate_enabled=False,
                              selfplay_chunk_steps=1),
            replay=ReplayConfig(capacity=500_000),
        ),
        # the reference production setup (gomoku 7x7, ViT 512 depth 1)
        "gomoku7-reference": Config(
            env="gomoku",
            mcts=MCTSConfig(num_simulations=100, formula="reference"),
            model=ModelConfig(family="vit", embed_dim=512, patch_size=5,
                              num_heads=8, depth=1, dropout=0.1),
            train=TrainConfig(batch_size=512, gate_enabled=False),
        ),
    }
    if name not in presets:
        raise ValueError(f"unknown preset {name!r}; have {sorted(presets)}")
    return presets[name]
