"""Run one cell of the benchmark once.

    python3 -m azbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control fp8]

from the root of a checkout.  It drives ``alphazero_tpu_torch`` on one
GPU through its own entry points, measures for ``--seconds``, checks what
the timed path produced against the plain reference in
``azbench/reference``, and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; then ``checks``, each
number compared beside its limit, which are also the last lines of
standard error.  ``--control fp8`` puts the reference in float8 in the
program's place in the checked calls: that run must come out not correct.

Without a GPU, or with fewer than the cell asks for, it exits 3 and prints
no result; one whose process holds JAX or the JAX package once the window
has closed exits 4.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from azbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "alphazero_tpu")
CACHE = spec.ROOT / "build" / "azbench_cache"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_note() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def execute(r) -> tuple:
    """Drive the cell and judge it: ``(result line, checks)``."""
    from azbench import result
    import torch
    spec.driver(r.cell).run(r)
    if set(r.checks) != set(r.cell.limits):
        raise RuntimeError(f"the cell's limits {sorted(r.cell.limits)} are "
                           f"not the numbers compared {sorted(r.checks)}")
    if r.trace:
        metrics = {}
        for m in r.cell.per_layer:
            v = spec.reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
    else:
        values = dict(r.e2e, setup_s=r.setup_s)
        metrics = {m["name"]: (values[m["name"]], m["unit"])
                   for m in r.cell.end_to_end}
    dev = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(r.device)
                    if r.device.type == "cuda" else "cpu"),
           "count": r.cell.chips,
           "memory_peak_bytes": r.memory_peak_bytes}
    if r.trace and r.profile is not None:
        dev["busy_s"] = r.profile.busy_s
        dev["window_s"] = r.profile.window_s
    correct = (result.judge(r.checks) and r.attempted > 0
               and r.failed == 0)
    line = result.line(correct, r.attempted, r.failed, metrics, dev,
                       r.checks, r.profile.breakdown()
                       if r.trace and r.profile is not None else None)
    return line, r.checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m azbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    args = ap.parse_args(argv)
    # every compile cache of the run inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    cell = spec.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"azbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    from azbench.harness import Run
    print(f"azbench: {card_note()}; shares are of the H100 SXM's published "
          "peaks (989 TFLOP/s bf16, 67 TFLOP/s float32, 3.35 TB/s)",
          file=sys.stderr, flush=True)
    r = Run(cell=cell, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device=torch.device("cuda", 0),
            control=args.control)
    line, checks = execute(r)
    bad = forbidden_modules()
    if bad:
        print(f"azbench: this process loaded {bad}", file=sys.stderr)
        return 4
    from azbench import result
    print(json.dumps({"setup_s": r.setup_s, "seed": args.seed,
                      "cell": args.workload}), file=sys.stderr)
    result.print_checks(checks)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
