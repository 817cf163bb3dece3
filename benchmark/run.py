"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root.  The cell names a configuration file
(``configs/``), a traffic file (``traffic/``) and its limits
(``limits/<cell>.json``); the traffic file names its entry point
(``entries/<name>.py``) and its arrival process (``arrivals/<name>.py``),
and every metric is a reader of its own (``metrics/<name>.py``).  A run:
makes the corpus and the query pool from the seed; builds the program's
store, indexes and encoder through its public entry points; warms every
shape the traffic makes (the entry's ``warm``) and runs the traffic's
clients for its warm-up requests; freezes what set-up left to the garbage
collector, as a server does once it has loaded; measures for ``--seconds``
(``--trace 1``: the per-layer metrics, with spans and a device trace);
then, with the program's state dropped, holds a seeded sample of the
window's answers to the plain reference (``judge.py``, by the entry's kind
of answer).  The last line on
standard output is the JSON result; the last lines on standard error are
the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: Top-level module names the run may not hold once the window has closed:
#: the JAX stack and the JAX package (the port's name begins with the JAX
#: package's, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "raglite_tpu")
#: Seconds the device trace covers, from the window's start (the whole
#: window where it is shorter).
TRACE_SECONDS = 10.0
#: Seconds to let the profiler settle before the traced window opens.
PROFILER_SETTLE_S = 1.0


def log(*parts) -> None:
    print("[bench]", *parts, file=sys.stderr, flush=True)


def process_start_epoch() -> float:
    """Wall-clock time at which this process started (from /proc: its age
    in clock ticks against the system's uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_plugin(kind: str, name: str, root: Path = HERE):
    """The module of file ``<root>/<kind>/<name>.py`` (names may hold dots)."""
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def load(cls, bench_path: Path, workload: str) -> "Cell":
        bench = json.loads(bench_path.read_text())
        base = bench_path.parent
        (cell,) = [w for w in bench["workloads"] if w["name"] == workload] or [None]
        if cell is None:
            msg = f"no workload {workload!r} in {bench_path}"
            raise SystemExit(msg)
        (cfg_entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
        bench_dir = base / Path(bench["paths"][0])
        config = json.loads((base / cfg_entry["file"]).read_text())
        traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
        limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())

        def mine(metric: dict) -> bool:
            return workload in metric.get("workloads", [workload])

        e2e = [m for m in bench["end_to_end"] if mine(m)]
        names = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"] if m["moves"] in names and mine(m)]
        return cls(workload, int(cell["chips"]), config, traffic, limits, e2e, layer)


@dataclass
class Context:
    """What a metric's reader sees."""

    cell: Cell
    window: tuple[float, float]
    records: list  # load.Request of the window
    tokens: dict[int, int]  # pool position -> tokens of that query
    spans: object  # spans.Spans
    pool_size: int = 1
    setup_s: float = 0.0
    trace: object = None  # devtrace.DeviceTrace in the traced run
    entry: object = None  # the module of the entry the traffic drives
    extra: dict = field(default_factory=dict)


def _drop_program_state() -> None:
    """Drop the program's cached store, indexes and encoder (its
    ``lru_cache`` factories) so that the reference runs on a freed card."""
    import torch

    for module, name in (
        ("raglite_tpu_torch.store", "_store_for_path"),
        ("raglite_tpu_torch.index.dense", "_index_for_store"),
        ("raglite_tpu_torch.index.keyword", "_keyword_index_for_path"),
        ("raglite_tpu_torch.models.encoder", "_make_encoder"),
    ):
        fn = getattr(sys.modules.get(module), name, None)
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    gc.unfreeze()  # what set-up built was frozen for the window; collect it now
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _graph_counts() -> dict[str, int]:
    """The program's CUDA-graph counters (captures, replays, evictions)
    summed over its live ``ProgramGraphs``: read before and after the
    window, they show whether anything was captured inside it."""
    graphs = sys.modules.get("raglite_tpu_torch.utils.graphs")
    total: dict[str, int] = {}
    if graphs is None:
        return total
    for obj in gc.get_objects():
        if type(obj) is graphs.ProgramGraphs:
            for k, v in obj.counts.items():
                total[k] = total.get(k, 0) + v
    return total


class _GcClock:
    """Collections and their seconds, by generation, from its making to
    ``stop()`` (the garbage collector's callbacks)."""

    def __init__(self) -> None:
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t = 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.seconds[g] += time.perf_counter() - self._t
            self.count[g] += 1

    def stop(self) -> str:
        gc.callbacks.remove(self._cb)
        return ", ".join(f"gen {g}: {self.count[g]} in {self.seconds[g]:.4f} s" for g in range(3))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str, started: float,
             root: Path = ROOT) -> dict:
    """One run of ``cell``; returns the result object (without printing)."""
    import torch

    from benchmark.corpus import fill_store, make_corpus
    from benchmark.judge import judge_window
    from benchmark.reference.tokenizers import load_tokenizer
    from benchmark.spans import Spans
    from benchmark.traffic import query_pool, token_counts

    config, traffic = cell.config, cell.traffic
    tokenizer = load_tokenizer(config["reference"]["tokenizer"], root)
    pool = query_pool(traffic, config, tokenizer, seed)
    log(f"{cell.name}: pool of {len(pool)} queries")

    from raglite_tpu_torch.config import RAGLiteConfig
    from raglite_tpu_torch.store import store_from_config

    store_root = tempfile.mkdtemp(prefix="bench_store_")  # under TMPDIR, removed at the end
    cfg = RAGLiteConfig(**config["raglite"], store_path=str(Path(store_root) / "store"), device=device)
    corpus = make_corpus(config["corpus"], int(config["corpus"]["dim"]), seed, device)
    fill_store(store_from_config(cfg), corpus)
    log(f"store filled: {len(corpus.bodies)} chunks, {corpus.rows.shape[0]} rows "
        f"({time.time() - started:.1f} s since start)")
    entry_mod = load_plugin("entries", traffic["entry"])
    entry = entry_mod.make(traffic, cfg)
    entry.warm(pool)
    log(f"shapes warm ({time.time() - started:.1f} s since start)")

    spans = Spans()
    positions_tokens: dict[int, int] = {}
    if trace:
        ctx_probe = Context(cell, (0.0, 0.0), [], positions_tokens, spans, len(pool), entry=entry_mod)
        for metric in cell.per_layer:
            reader = load_plugin("metrics", metric["name"])
            if hasattr(reader, "install"):
                reader.install(ctx_probe)
    loop = load_plugin("arrivals", traffic["arrivals"]).make(entry.call, pool, traffic, check_positions(cell, pool, seed))
    loop.start()
    warm = int(traffic["warmup_requests"])
    deadline = time.perf_counter() + 600
    while loop.sent() < warm:
        if time.perf_counter() > deadline:
            loop.stop()
            msg = f"warm-up did not reach {warm} requests in 600 s"
            raise RuntimeError(msg)
        time.sleep(0.01)
    # What set-up built (corpus, store, indexes, tables) lives as long as the
    # process: collected once and frozen, the collector's full passes in the
    # window scan only what the window allocates.
    gc.collect()
    gc.freeze()
    profiled = None
    if trace:
        from benchmark.devtrace import Profiled

        profiled = Profiled()
        profiled.start()
        time.sleep(PROFILER_SETTLE_S)
    graphs_before = _graph_counts()
    gc_clock = _GcClock()
    t0 = time.perf_counter()
    setup_s = time.time() - started
    if profiled:
        profiled.open()
    trace_end = t0 + min(seconds, TRACE_SECONDS)
    end = t0 + seconds
    if profiled and trace_end < end:
        time.sleep(max(0.0, trace_end - time.perf_counter()))
        profiled.close()
    time.sleep(max(0.0, end - time.perf_counter()))
    t1 = time.perf_counter()
    if profiled and not profiled.hi_ns:
        profiled.close()
    gc_in_window = gc_clock.stop()
    loop.stop()
    spans.restore()
    log(f"garbage collection in the window: {gc_in_window}")
    graphs_after = _graph_counts()
    log("program graphs in the window: " + ", ".join(
        f"{k} {graphs_after.get(k, 0) - graphs_before.get(k, 0)}" for k in sorted(graphs_after)))
    if device == "cuda":
        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated())
    else:
        memory_peak = 0
    records = [r for r in loop.records if t0 <= r.done <= t1]
    log(f"window {t1 - t0:.3f} s: {len(records)} requests ({sum(r.error is not None for r in records)} failed)")
    device_trace = profiled.reduce() if profiled else None

    answered = sorted({p for r in records if r.error is None for p in r.positions(len(pool))})
    for p, n in zip(answered, token_counts([pool[p] for p in answered], tokenizer)):
        positions_tokens[p] = n
    ctx = Context(cell, (t0, t1), records, positions_tokens, spans, len(pool), setup_s, device_trace, entry_mod)
    ctx.extra["trace_window"] = (t0, min(t1, trace_end))
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for metric in wanted:
        value = load_plugin("metrics", metric["name"]).read(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    window_answers = sorted((p, a) for p, (done, a) in loop.answers.items() if t0 <= done <= t1)
    del entry, loop
    _drop_program_state()
    shutil.rmtree(store_root, ignore_errors=True)
    t_check = time.perf_counter()
    checks = judge_window(cell, entry_mod.ANSWER, window_answers, pool, corpus, device=device, root=root)
    log(f"reference check {time.perf_counter() - t_check:.1f} s")
    failed = sum(r.error is not None for r in records)
    checks["failed"] = {"value": failed, "limit": int(cell.limits.get("failed", 0))}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    errors = [r.error for r in records if r.error]
    if errors:
        log("first failure:\n" + errors[0])
    out = {
        "correct": bool(correct),
        "attempted": sum(r.count for r in records),
        "failed": sum(r.count for r in records if r.error is not None),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": memory_peak,
        },
    }
    if device_trace is not None:
        out["device"]["busy_s"] = device_trace.busy_s
        out["device"]["window_s"] = device_trace.window_s
        top = sorted(device_trace.by_name.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in device_trace.idle_gaps]}
    out["checks"] = checks
    return out


def check_positions(cell: Cell, pool: list[str], seed: int) -> set[int]:
    """The pool positions whose answers the check judges: a sample drawn
    from the seed, with the longest query in it."""
    import numpy as np

    want = int(cell.traffic.get("check", {}).get("sample", 256))
    rng = np.random.default_rng([seed, 2])
    picked = set(rng.choice(len(pool), size=min(want, len(pool)), replace=False).tolist())
    return picked | {max(range(len(pool)), key=lambda p: len(pool[p]))}


def main(argv: list[str] | None = None) -> int:
    started = process_start_epoch()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = Cell.load(ROOT / "BENCHMARK.json", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda", started=started)
    bad = forbidden_modules()
    if bad:
        log(f"modules of the JAX stack or the JAX package are loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
