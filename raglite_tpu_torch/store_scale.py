"""A measured multi-million-chunk run of the host store (counterpart of
scripts/store_scale_run.py).

Drives the port's ``Store`` through insert -> save -> reopen at ``--chunks``
scale (default 5M) and reports wall times and resident memory, showing that
the lazy open keeps the resident set O(touched records) rather than
O(corpus).  The reopen runs in a fresh subprocess, so that its resident set
holds only the open (the writer necessarily held the eager tables).  It is
host-only: no tensor reaches a device.

Usage: python -m raglite_tpu_torch.store_scale [--chunks 5000000] [--dim 8] [--dir PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024
    return -1.0


def write_phase(path: str, n_chunks: int, dim: int) -> dict:
    from raglite_tpu_torch.documents import Chunk, Document
    from raglite_tpu_torch.store import Store

    store = Store(path)
    batch = 250_000
    t0 = time.time()
    rng = np.random.default_rng(0)
    for start in range(0, n_chunks, batch):
        count = min(batch, n_chunks - start)
        doc_id = f"doc{start // batch:05d}"
        store.documents[doc_id] = Document(id=doc_id, filename=f"{doc_id}.md", url=None, metadata_={}, content=None)
        chunks = [
            Chunk(
                id=f"c{i:09d}",
                document_id=doc_id,
                index=i - start,
                headings="# Section",
                body=f"synthetic chunk body number {i} with a few filler words",
                metadata_={"topic": f"t{i % 17}", "shard": i % 7},
            )
            for i in range(start, start + count)
        ]
        embeddings = list(rng.normal(size=(count, 1, dim)).astype(np.float16))
        store.add_chunks(chunks, embeddings)
        store.save()
        # Writers keep eager overlays; a fresh Store resumes lazily, which
        # bounds the writer's own memory across batches.
        if start + count < n_chunks:
            store = Store(path)
    return {"insert_save_s": round(time.time() - t0, 1), "writer_peak_rss_mb": round(rss_mb(), 1)}


def read_phase(path: str) -> dict:
    from raglite_tpu_torch.store import Store, _LazyChunks

    rss0 = rss_mb()
    t0 = time.time()
    store = Store(path)
    open_s = time.time() - t0
    rss_open = rss_mb()
    lazy = isinstance(store.chunks, _LazyChunks)
    n = len(store.chunk_order)
    # Touch 1000 spread-out records.
    t0 = time.time()
    rng = np.random.default_rng(1)
    for i in rng.integers(0, n, size=1000):
        assert store.chunks[store.chunk_order[int(i)]].body
    touch_s = time.time() - t0
    rss_touch = rss_mb()
    # A filtered mask from the sidecar postings.
    t0 = time.time()
    mask = store.chunk_mask_for_filter({"topic": "t3"})
    filter_s = time.time() - t0
    # An embedding view resolves.
    assert store.embeddings[store.chunk_order[n // 2]].shape[0] >= 1
    return {
        "chunks": n,
        "lazy_open": lazy,
        "open_s": round(open_s, 2),
        "rss_before_mb": round(rss0, 1),
        "rss_after_open_mb": round(rss_open, 1),
        "rss_after_1000_touches_mb": round(rss_touch, 1),
        "touch_1000_s": round(touch_s, 3),
        "filtered_mask_s": round(filter_s, 3),
        "filtered_matches": int(mask.sum()),
    }


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chunks", type=int, default=5_000_000)
    parser.add_argument("--dim", type=int, default=8)
    parser.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), "store_scale_run"))
    parser.add_argument("--phase", choices=("write", "read", "all"), default="all")
    args = parser.parse_args(argv)

    if args.phase == "read":
        result = read_phase(args.dir)
        print(json.dumps(result))
        return result
    result: dict = {"n_chunks": args.chunks}
    if args.phase in ("write", "all"):
        result.update(write_phase(args.dir, args.chunks, args.dim))
    if args.phase == "all":
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))
        read = subprocess.run(  # a fresh process: the open's own resident set
            [sys.executable, "-m", "raglite_tpu_torch.store_scale", "--phase", "read", "--dir", args.dir],
            capture_output=True, text=True, check=True, env={**os.environ, "PYTHONPATH": path},
        )
        result["reopen"] = json.loads(read.stdout.strip().splitlines()[-1])
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
