"""What a fresh process's first train epoch pays for: ``python -m
alphazero_tpu_torch.train_clock [--device cuda|cpu] [--runs N]``.

Prints, from fresh processes, the seconds of ``import torch`` and of the
first ``torch.optim.Adam`` (its constructor imports ``torch._dynamo`` on
first use), then runs ``train --preset connect4 --mesh data=1 --iterations
2 --no-gate`` ``N`` times (default 2), each in a process of its own, with
``training.learner.make_optimizer`` timed, and prints every epoch's train
seconds beside the seconds its optimizer took to build, the collect
seconds and the command's wall time.  ``Trainer.train_epoch`` counts the
optimizer's construction in its ``seconds``.  The runs' workdirs go under
``build/train_clock``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

PROBE = ("import time; t = time.perf_counter(); import torch; "
         "a = time.perf_counter(); "
         "torch.optim.Adam([torch.zeros(1, requires_grad=True)]); "
         "b = time.perf_counter(); "
         "print(f'import torch {a - t:.3f} s, first Adam() {b - a:.3f} s')")


def child(argv):
    """The command line with the learner's optimizer construction timed;
    prints the seconds of each construction as one JSON line at the end."""
    from alphazero_tpu_torch import cli
    from alphazero_tpu_torch.training import learner
    build = learner.make_optimizer
    seconds = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        opt = build(*a, **k)
        seconds.append(time.perf_counter() - t0)
        return opt

    learner.make_optimizer = timed
    cli.main(argv)
    print(json.dumps({"optimizer_seconds": seconds}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--child", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child)
        return
    for _ in range(2):
        subprocess.run([sys.executable, "-c", PROBE], check=True)
    root = Path("build/train_clock")
    for i in range(args.runs):
        wd = root / str(i)
        shutil.rmtree(wd, ignore_errors=True)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "alphazero_tpu_torch.train_clock",
             "--child", "train", "--preset", "connect4", "--mesh", "data=1",
             "--iterations", "2", "--no-gate", "--device", args.device,
             "--workdir", str(wd)],
            capture_output=True, text=True, check=True)
        wall = time.perf_counter() - t0
        recs = [json.loads(ln) for ln in run.stdout.splitlines()
                if ln.startswith("{")]
        opt = recs[-1]["optimizer_seconds"]
        train = [r["seconds"] for r in recs if r.get("kind") == "train"]
        collect = [r["seconds"] for r in recs if r.get("kind") == "collect"]
        print(f"run {i}: wall {wall:.3f} s; train by epoch {train} s, of "
              f"which building the optimizer {opt} s; collect {collect} s",
              flush=True)


if __name__ == "__main__":
    main()
