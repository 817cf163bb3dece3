"""The control of a cell's comparison: the reference put in the program's
place, its encoder's linear weights in float8 e4m3 (the step below the
bfloat16 the configurations serve), judged as a run's answers are.

    python -m benchmark.tools.control --workload <name> --seeds 11 12 13 [--weights fp8|served]

Per seed: the run's corpus and query pool, a sample of pool queries as a
run draws it from its answers, the control's answers to them (exact dense
search with the control's embeddings; for hybrid cells fused with exact
BM25 as raglite's hybrid search fuses), and the numbers compared against
the reference with the served weights.  ``--weights served`` answers with
the reference itself, which must read a gap of 0.  Needs no program: it
runs on the card (or ``--device cpu`` at a test's size).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from benchmark.corpus import make_corpus
from benchmark.judge import judge_window, reference_answers
from benchmark.reference.tokenizers import load_tokenizer
from benchmark.run import ROOT, Cell, check_positions, load_plugin
from benchmark.traffic import query_pool

__all__ = ["control_readings"]


def control_readings(cell: Cell, seed: int, *, device: str, weights: str = "fp8", root: Path = ROOT) -> dict:
    """The numbers compared, for the control's answers on ``seed``."""
    config, traffic = cell.config, cell.traffic
    kind = load_plugin("entries", traffic["entry"]).ANSWER
    tokenizer = load_tokenizer(config["reference"]["tokenizer"], root)
    pool = query_pool(traffic, config, tokenizer, seed)
    corpus = make_corpus(config["corpus"], int(config["corpus"]["dim"]), seed, device)
    positions = sorted(check_positions(cell, pool, seed))
    answers = reference_answers(cell, kind, [pool[p] for p in positions], corpus, device=device, weights=weights,
                                root=root)
    return judge_window(cell, kind, list(zip(positions, answers)), pool, corpus, device=device, root=root)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--weights", default="fp8", choices=("fp8", "served"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"))
    args = parser.parse_args(argv)
    cell = Cell.load(Path(args.bench), args.workload)
    for seed in args.seeds:
        checks = control_readings(cell, seed, device=args.device, weights=args.weights)
        row = {"workload": cell.name, "seed": seed, "weights": args.weights, **{k: v["value"] for k, v in checks.items()}}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
