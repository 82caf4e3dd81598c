"""The run's last line: one JSON object, with the numbers compared last."""

from __future__ import annotations

import json
import sys


def judge(checks: dict) -> bool:
    """Whether every number compared is within its limit (``value <=
    limit``)."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def line(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown=None) -> str:
    """``metrics`` maps a name to ``(value, unit)``; ``checks`` a number
    compared to ``{"value", "limit"}``.  ``breakdown`` is given only for a
    traced run."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def print_checks(checks: dict, stream=sys.stderr):
    """The numbers compared, each beside its limit, as the last lines of
    standard error."""
    for name, c in checks.items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name}: {c['value']} (limit {c['limit']}) "
              f"{'ok' if ok else 'FAIL'}", file=stream, flush=True)
