"""Command line of the port: train, eval, play and bench.

Counterpart of the JAX package's ``cli.py``, with the same subcommands and
flags, so that one command line does the same in both packages:

  python -m alphazero_tpu_torch train --preset connect4 --iterations 5 --workdir runs/c4
  python -m alphazero_tpu_torch eval  --preset connect4 --workdir runs/c4 --games 32
  python -m alphazero_tpu_torch play  --preset tictactoe --workdir runs/ttt --human-turn 0
  python -m alphazero_tpu_torch bench

``AZ_FUSED_RESNET=1`` evaluates ResNet models with the fused tower kernel
(self-play, gate, eval, play and bench), as in the JAX package.  The port
adds ``--device`` (default ``cuda``; ``--device cpu`` runs the plain
PyTorch path on the CPU, the port's counterpart of ``JAX_PLATFORMS=cpu``).
``train --expand-depth N`` grows a ViT's depth after ``--resume``, as in
the JAX package.  ``train --mesh data=N[,model=M]`` trains over N·M ranks
(``training/spmd_loop.py``): with ``--coordinator host:port
--num-processes P --process-id i`` (or torchrun's environment) this
process is one rank; without, it starts all N·M ranks on this host
(``parallel/distributed.py:launch``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _parse_mesh(spec: str):
    """'data=8' / 'data=4,model=2' → (n_data, n_model)."""
    n = {"data": None, "model": 1}
    seen = set()
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if k not in n or k in seen or not v.isdigit() or int(v) < 1:
            raise SystemExit(f"bad --mesh spec {spec!r}; "
                             "expected data=N[,model=M] with N,M >= 1")
        seen.add(k)
        n[k] = int(v)
    if n["data"] is None:
        raise SystemExit(f"bad --mesh spec {spec!r}: 'data=N' is required")
    return n["data"], n["model"]


def _apply_overrides(cfg, args):
    tr_over = {}
    if args.games_per_iter:
        tr_over["games_per_iter"] = args.games_per_iter
    if args.selfplay_batch:
        tr_over["selfplay_batch"] = args.selfplay_batch
    if args.batch_size:
        tr_over["batch_size"] = args.batch_size
    if args.gate_games:
        tr_over["gate_games"] = args.gate_games
    if args.no_gate:
        tr_over["gate_enabled"] = False
    if args.lr is not None:
        tr_over["learning_rate"] = args.lr
    if tr_over:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **tr_over))
    if args.sims:
        cfg = dataclasses.replace(
            cfg, mcts=dataclasses.replace(cfg.mcts,
                                          num_simulations=args.sims))
    m_over = {}
    for field in ("family", "width", "blocks", "channels", "embed_dim",
                  "depth", "patch_size"):
        v = getattr(args, f"model_{field}", None)
        if v is not None:
            m_over[field] = v
    if m_over:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **m_over))
    if args.capacity:
        cfg = dataclasses.replace(
            cfg, replay=dataclasses.replace(cfg.replay,
                                            capacity=args.capacity))
    return cfg


def _run_cfg(cfg, workdir):
    """The run's env, model and replay geometry from its ``config.json``
    (so a checkpoint of any width or depth restores); search and arena
    settings stay the caller's.  The caller's config for a workdir without
    one."""
    from alphazero_tpu_torch.config import load_config
    stored = load_config(workdir) if workdir else None
    if stored is None:
        return cfg
    return dataclasses.replace(cfg, env=stored.env, model=stored.model,
                               replay=stored.replay)


def cmd_train(args):
    if not args.mesh:
        return _train(args, None)
    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.parallel import distributed
    from alphazero_tpu_torch.training.spmd_loop import check_family

    check_family(_apply_overrides(preset(args.preset), args))
    shape = _parse_mesh(args.mesh)
    if not distributed.initialize(args.coordinator, args.num_processes,
                                  args.process_id, args.device):
        distributed.launch(_train, shape[0] * shape[1], args, shape,
                           device=args.device)
        return None
    try:
        return _train(args, shape)
    finally:
        distributed.destroy()


def _train(args, mesh_shape):
    """The train command in this process: a ``Trainer``, or with
    ``mesh_shape = (n_data, n_model)`` this rank's ``SpmdTrainer`` (rank 0
    alone logs, profiles and writes the workdir's files)."""
    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.training.loop import Trainer
    from alphazero_tpu_torch.utils.metrics import MetricsLogger
    from alphazero_tpu_torch.utils.profiling import trace

    cfg = _apply_overrides(preset(args.preset), args)
    rank0 = True
    if mesh_shape:
        from alphazero_tpu_torch.parallel.mesh import make_mesh
        from alphazero_tpu_torch.training.spmd_loop import SpmdTrainer
        mesh = make_mesh(*mesh_shape)
        rank0 = mesh.rank == 0
    logger = MetricsLogger(path=f"{args.workdir}/metrics.jsonl"
                           if args.workdir and rank0 else None, stdout=rank0)
    if mesh_shape:
        tr = SpmdTrainer(cfg, mesh, workdir=args.workdir, logger=logger,
                         display=args.display,
                         fused_resnet=args.fused_resnet)
        if rank0:
            print(f"mesh: {mesh.shape}", file=sys.stderr)
    else:
        tr = Trainer(cfg, device=args.device, workdir=args.workdir,
                     logger=logger, display=args.display,
                     fused_resnet=args.fused_resnet)
    if args.load_buffer:
        n = tr.import_buffer(args.load_buffer, step=args.load_buffer_step)
        print(f"imported {n} buffer rows from {args.load_buffer}",
              file=sys.stderr)
    if (args.resume or args.train_only) and tr.restore_checkpoint():
        print(f"resumed at version {tr.version}", file=sys.stderr)
    if args.expand_depth:
        tr.expand_depth(args.expand_depth)
        print(f"expanded ViT depth to {args.expand_depth}", file=sys.stderr)
    with trace(args.profile_dir if rank0 else None):
        _run_train(tr, args)
    logger.close()
    return tr


def _run_train(tr, args):
    if args.train_only:
        # SGD on the checkpointed buffer only, no self-play
        if tr._buffer_rows() == 0:
            print("train-only requires a checkpoint with a non-empty "
                  "replay buffer", file=sys.stderr)
            sys.exit(1)
        for _ in range(args.iterations or 1):
            tr.train_epoch()
        tr.params_best = {k: v.detach().clone()
                          for k, v in tr.params_new.items()}
        tr.save_checkpoint()
        return
    tr.run(args.iterations)


def cmd_eval(args):
    import torch

    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.eval.arena import Agent, compare
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.training.loop import Trainer

    cfg = _run_cfg(preset(args.preset), args.workdir)
    fused = args.fused_resnet
    tr = Trainer(cfg, device=args.device, workdir=args.workdir,
                 persist_config=False, fused_resnet=fused)
    if args.workdir and tr.restore_checkpoint(step=args.step):
        print(f"loaded version {tr.version}", file=sys.stderr)
    model_agent = Agent(make_eval_fn(tr.model, tr.params_best, fused),
                        cfg.mcts)
    if args.vs == "vanilla":
        sims = args.vanilla_sims or cfg.mcts.num_simulations
        other = Agent(None, dataclasses.replace(cfg.mcts,
                                                num_simulations=sims))
    elif args.vs == "self":      # best against contender of one checkpoint
        other = Agent(make_eval_fn(tr.model, tr.params_new, fused), cfg.mcts)
    else:     # any version of any workdir, its model from its own config
        cfg_b = _run_cfg(cfg, args.workdir_b or args.workdir)
        if cfg_b.env != cfg.env:
            print(f"--vs checkpoint: env mismatch ({cfg_b.env} vs "
                  f"{cfg.env})", file=sys.stderr)
            sys.exit(1)
        trb = Trainer(cfg_b, device=args.device,
                      workdir=args.workdir_b or args.workdir,
                      persist_config=False, fused_resnet=fused)
        if not trb.restore_checkpoint(step=args.step_b):
            print("--vs checkpoint: no checkpoint found at "
                  f"{args.workdir_b or args.workdir} step={args.step_b}",
                  file=sys.stderr)
            sys.exit(1)
        print(f"opponent: version {trb.version}", file=sys.stderr)
        other = Agent(make_eval_fn(trb.model, trb.params_best, fused),
                      cfg.mcts)
    generator = torch.Generator(device=tr.device).manual_seed(args.seed)
    rate, score = compare(tr.env, other, model_agent, args.games,
                          generator=generator, sampling=True,
                          device=tr.device)
    result = {"model_win_rate": rate, "score": score.tolist(),
              "games": args.games}
    print(json.dumps(result), flush=True)
    return result


def cmd_play(args):
    from alphazero_tpu_torch.config import preset
    from alphazero_tpu_torch.envs import make_env
    from alphazero_tpu_torch.eval.play import play_against_agent
    from alphazero_tpu_torch.models import make_eval_fn
    from alphazero_tpu_torch.training.loop import Trainer

    cfg = preset(args.preset)
    eval_fn = None
    if args.vanilla:
        env = make_env(cfg.env)
    else:
        cfg = _run_cfg(cfg, args.workdir)
        tr = Trainer(cfg, device=args.device, workdir=args.workdir,
                     persist_config=False, fused_resnet=args.fused_resnet)
        if args.workdir:
            tr.restore_checkpoint()
        env = tr.env
        eval_fn = make_eval_fn(tr.model, tr.params_best, args.fused_resnet)
    play_against_agent(env, eval_fn, cfg.mcts, args.human_turn,
                       device=args.device)


def cmd_bench(args):
    from alphazero_tpu_torch import bench
    bench.main(fused_resnet=args.fused_resnet, device=args.device)


def _parser():
    p = argparse.ArgumentParser(prog="alphazero_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(q):
        q.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu: the plain PyTorch path")

    t = sub.add_parser("train", help="self-play training loop")
    t.add_argument("--preset", default="connect4")
    t.add_argument("--iterations", type=int, default=None)
    t.add_argument("--games-per-iter", type=int, default=None)
    t.add_argument("--workdir", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--train-only", action="store_true",
                   help="SGD on the checkpointed buffer, no self-play")
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the run")
    t.add_argument("--display", action="store_true",
                   help="render game 0's board during self-play")
    t.add_argument("--load-buffer", default=None,
                   help="seed the replay buffer from another run's "
                        "checkpoint workdir")
    t.add_argument("--load-buffer-step", type=int, default=None)
    t.add_argument("--expand-depth", type=int, default=None,
                   help="grow the ViT's depth (after --resume), keeping "
                        "its trained blocks")
    t.add_argument("--mesh", default=None,
                   help="train over N·M ranks: data=N[,model=M]")
    t.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 when each rank is started "
                        "on its own (with --num-processes, --process-id)")
    t.add_argument("--num-processes", type=int, default=None)
    t.add_argument("--process-id", type=int, default=None)
    t.add_argument("--selfplay-batch", type=int, default=None,
                   help="override the preset's parallel self-play games")
    t.add_argument("--batch-size", type=int, default=None,
                   help="override the preset's SGD batch size")
    t.add_argument("--lr", type=float, default=None,
                   help="override the preset's Adam learning rate")
    t.add_argument("--model-family", dest="model_family", default=None,
                   choices=["vit", "resnet", "resnet_bn", "dense"],
                   help="override the preset's net family")
    t.add_argument("--model-width", dest="model_width", type=int,
                   default=None, help="dense-family width override")
    t.add_argument("--model-blocks", dest="model_blocks", type=int,
                   default=None, help="dense/resnet/resnet_bn blocks override")
    t.add_argument("--model-channels", dest="model_channels", type=int,
                   default=None, help="resnet/resnet_bn channels override")
    t.add_argument("--model-embed-dim", dest="model_embed_dim", type=int,
                   default=None, help="vit embed dim override")
    t.add_argument("--model-depth", dest="model_depth", type=int,
                   default=None, help="vit depth override")
    t.add_argument("--model-patch-size", dest="model_patch_size", type=int,
                   default=None, help="vit patch size override")
    t.add_argument("--sims", type=int, default=None,
                   help="override the preset's MCTS simulations per move")
    t.add_argument("--capacity", type=int, default=None,
                   help="override the preset's replay capacity (positions)")
    t.add_argument("--gate-games", type=int, default=None,
                   help="override the preset's gating arena game count")
    t.add_argument("--no-gate", action="store_true",
                   help="disable the promotion gate")
    device_flag(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="arena comparison")
    e.add_argument("--preset", default="connect4")
    e.add_argument("--workdir", default=None)
    e.add_argument("--games", type=int, default=32)
    e.add_argument("--vs", choices=["vanilla", "self", "checkpoint"],
                   default="vanilla")
    e.add_argument("--vanilla-sims", type=int, default=None)
    e.add_argument("--step", type=int, default=None,
                   help="checkpoint version for the primary agent "
                        "(default: latest)")
    e.add_argument("--workdir-b", default=None,
                   help="--vs checkpoint: opponent's workdir "
                        "(default: same as --workdir)")
    e.add_argument("--step-b", type=int, default=None,
                   help="--vs checkpoint: opponent's version "
                        "(default: latest)")
    e.add_argument("--seed", type=int, default=0,
                   help="seed of the match's random draws")
    device_flag(e)
    e.set_defaults(fn=cmd_eval)

    g = sub.add_parser("play", help="human vs agent")
    g.add_argument("--preset", default="tictactoe")
    g.add_argument("--workdir", default=None)
    g.add_argument("--human-turn", type=int, default=0, choices=[0, 1])
    g.add_argument("--vanilla", action="store_true",
                   help="play the model-free rollout agent")
    device_flag(g)
    g.set_defaults(fn=cmd_play)

    b = sub.add_parser("bench", help="self-play throughput of every preset")
    b.add_argument("--preset", default="connect4",
                   help="accepted for the JAX CLI's sake; the bench runs "
                        "every preset (AZ_BENCH_CONFIGS picks some)")
    device_flag(b)
    b.set_defaults(fn=cmd_bench)
    return p


def fused_resnet_opt_in() -> bool:
    """The JAX package's switch ``AZ_FUSED_RESNET``, read once by an entry
    point (``main`` here, ``strength.main``) and passed down."""
    return bool(os.environ.get("AZ_FUSED_RESNET"))


def main(argv=None):
    args = _parser().parse_args(argv)
    args.fused_resnet = fused_resnet_opt_in()
    return args.fn(args)


if __name__ == "__main__":
    main()
