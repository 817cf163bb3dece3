"""A cell defined by data files alone, at a size the CPU runs in seconds:
the tiny preset encoder, 3,000 chunks, hybrid and vector traffic."""

import json
from pathlib import Path

TINY_CONFIG = {
    "raglite": {"embedder": "flax:tiny", "llm": "echo"},
    "model": {"layers": 2, "d_model": 256, "heads": 4, "d_ff": 512},
    "corpus": {"chunks": 3000, "rows_per_chunk": 2, "dim": 256, "vocab": 3000, "body_terms": 12, "zipf_a": 1.3},
    "query_tokens": [16, 64],
    "reference": {
        "tokenizer": {"kind": "bytes", "offset": 3},
        "encoder": {"source": "preset", "seed": 0, "layers": 2, "d_model": 256, "heads": 4, "d_ff": 512,
                    "vocab": 8192, "max_len": 512, "final_ln": True, "weights_dtype": "bfloat16"},
    },
}
QUERIES = {"pool": 256, "terms": {"kind": "zipf_tail", "a": 1.3, "rank_from": 200}, "max_unique_terms": 32}
TRAFFIC = {
    "hyb": {"entry": "search.hybrid_search_batch", "arrivals": "closed", "clients": 1, "batch": 8,
            "request": {"num_results": 5}, "warmup_requests": 4, "queries": QUERIES, "check": {"sample": 48}},
    "vec": {"entry": "search.vector_search_batch", "arrivals": "closed", "clients": 1, "batch": 8,
            "request": {"num_results": 10}, "warmup_requests": 4, "queries": QUERIES, "check": {"sample": 48}},
}
#: Limits for the tiny preset on the CPU (its readings: score errors and
#: order gaps under 1e-3; the float8 control's above 5e-3).
LIMITS = {
    "tiny.hybrid": {"order_gap": 0.002, "recall_miss": 0.01, "rank_faults": 0, "failed": 0},
    "tiny.vector": {"score_err": 0.002, "order_gap": 0.002, "recall_miss": 0.01, "rank_faults": 0, "failed": 0},
}


def write_tiny_bench(root: Path) -> Path:
    """BENCHMARK.json and its data files under ``root``; returns the JSON's path."""
    bench = root / "bench"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for name, spec in TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(spec))
    for name, spec in LIMITS.items():
        (bench / "limits" / f"{name}.json").write_text(json.dumps(spec))
    doc = {
        "command": ["python3", "-m", "benchmark.run"], "paths": ["bench"], "run_seconds": 2,
        "configs": [{"name": "tiny", "source": "test", "file": "bench/configs/tiny.json", "reduced": [], "why": "test"}],
        "workloads": [
            {"name": "tiny.hybrid", "config": "tiny", "traffic": "hyb", "chips": 1, "why": "test"},
            {"name": "tiny.vector", "config": "tiny", "traffic": "vec", "chips": 1, "why": "test"},
        ],
        "end_to_end": [
            {"name": "search_qps", "unit": "queries/s", "better": "higher", "bound": 0.05, "source": "host_clock"},
            {"name": "search_p95_ms", "unit": "ms", "better": "lower", "bound": 0.05, "source": "host_clock",
             "workloads": ["tiny.hybrid"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
        ],
        "per_layer": [
            {"name": "batch_call_ms.offline", "unit": "ms", "better": "lower", "source": "program_span",
             "layer": "public search API", "moves": "search_qps"},
            {"name": "encode_ms", "unit": "ms", "better": "lower", "source": "program_span",
             "layer": "query encode", "moves": "search_qps"},
            {"name": "dense_ms", "unit": "ms", "better": "lower", "source": "program_span",
             "layer": "index search", "moves": "search_qps", "workloads": ["tiny.vector"]},
            {"name": "search_mfu", "unit": "%", "better": "higher", "source": "host_clock",
             "layer": "whole step", "moves": "search_qps"},
            {"name": "int4_scan_roofline", "unit": "%", "better": "higher", "source": "device_trace",
             "layer": "scan kernels", "moves": "search_qps"},
        ],
    }
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(doc))
    return path
