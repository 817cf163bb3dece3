"""Run a cell again and again, one process a run, and summarise the spread.

    python -m benchmark.tools.sets --workload <name> --seeds 1 2 3 [--seconds 20] [--trace 0]

Each run is the benchmark's own command in a fresh process, from the
checkout's root.  Per run it prints one JSON line (seed, exit code, wall
seconds, ``correct``, the metrics and the numbers compared), appends it to
``<out>/<workload>.rows.jsonl`` and keeps the run's standard error there
(``<workload>.<seed>.<trace>.<start time>.err``); at the end, per metric,
the median and the spread (the distance between the quartiles over the
median, as ``statistics.quantiles(values, n=4)`` gives them).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from benchmark.run import ROOT
from benchmark.stats import spread

__all__ = ["run_once"]


def run_once(workload: str, seed: int, seconds: float, trace: int, out: Path | None) -> dict:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    stamp = time.time_ns()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1500)
    wall = time.perf_counter() - t0
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{workload}.{seed}.{trace}.{stamp}.err").write_text(proc.stderr[-200_000:])
    row = {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode, "wall_s": wall}
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        row["stderr_tail"] = proc.stderr[-3000:]
        return row
    row["correct"] = result["correct"]
    row["metrics"] = {k: v["value"] for k, v in result["metrics"].items()}
    row["checks"] = {k: v["value"] for k, v in result["checks"].items()}
    row["device"] = result["device"]
    if "breakdown" in result:
        row["breakdown"] = result["breakdown"]
    if out is not None:
        with open(out / f"{workload}.rows.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=20)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" / "sets"))
    args = parser.parse_args(argv)
    rows = []
    for seed in args.seeds:
        row = run_once(args.workload, seed, args.seconds, args.trace, Path(args.out))
        rows.append(row)
        print(json.dumps(row), flush=True)
    values: dict[str, list[float]] = {}
    for row in rows:
        for k, v in row.get("metrics", {}).items():
            values.setdefault(k, []).append(v)
    summary = {k: {"median": statistics.median(v), "spread": spread(v) if len(v) >= 2 else None, "n": len(v)}
               for k, v in values.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
