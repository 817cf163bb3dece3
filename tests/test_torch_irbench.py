"""The port's IR benchmark (irbench.py) and the CLI's ``bench`` against the
JAX package's, on the CPU.

- ``compute_measure`` on the JAX tests' cases and, on random runs, equal to
  the JAX package's;
- ``run_ir_benchmark`` on ``hash:128`` (bit-exact embeddings on both sides):
  every variant's value equal, HNSW's included;
- every variant's runs (document ids per query) equal on the tiny f32
  encoder carried across, and the scores they give;
- a BEIR directory written here: the same dataset in both packages, and the
  same table;
- the pandas-free path (pandas made unimportable in a fresh process): the
  rows, and the CLI's own table with the same numbers;
- ``bench`` through both CLIs (the same text), ``bench --hnsw-recall`` (the
  same report);
- ``RemoteVectorStoreEvaluator`` against a loopback stub of the vector-store
  API, and the cases of tests/test_surfaces.py.

Each package's runs are cached in a directory of its own
(``RAGLITE_TPU_BENCH_CACHE`` set per call): the two read the same variable,
and a shared directory would replay one package's runs in the other.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

import raglite_tpu.models.encoder as jenc
import raglite_tpu_torch.models.encoder as tenc
from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu import irbench as jbench
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch import irbench as tbench
from raglite_tpu_torch.models import transformer as tt
from raglite_tpu_torch.models.tokenizer import ByteTokenizer

ROOT = Path(__file__).resolve().parent.parent
ALL = ("single_vector", "multivector", "query_adapter", "keyword", "hybrid", "rerank", "hnsw")


@contextlib.contextmanager
def _cache(monkeypatch, path: Path):
    with monkeypatch.context() as m:
        m.setenv("RAGLITE_TPU_BENCH_CACHE", str(path))
        yield


def _both_tables(tmp_path, monkeypatch, *, embedder: str, dataset: str = "synthetic", num_queries: int = 10, variants=ALL):
    with _cache(monkeypatch, tmp_path / "jax-cache"):
        jcfg = JConfig(store_path=str(tmp_path / "jax" / "store"), embedder=embedder, llm="echo")
        want = jbench.run_ir_benchmark(dataset=dataset, num_queries=num_queries, variants=variants, config=jcfg)
    with _cache(monkeypatch, tmp_path / "torch-cache"):
        tcfg = TConfig(store_path=str(tmp_path / "torch" / "store"), embedder=embedder, llm="echo", device="cpu")
        got = tbench.run_ir_benchmark(dataset=dataset, num_queries=num_queries, variants=variants, config=tcfg)
    return got, want


def test_ir_measures_match_jax() -> None:
    qrel = {"a": 1, "b": 1}
    assert tbench.compute_measure("AP@10", ["a", "x", "b"], qrel) == pytest.approx((1.0 + 2 / 3) / 2)
    assert tbench.compute_measure("recall@10", ["a", "x"], qrel) == 0.5
    assert tbench.compute_measure("MRR@10", ["x", "a"], qrel) == 0.5
    assert tbench.compute_measure("nDCG@10", ["a", "b"], qrel) == pytest.approx(1.0)
    assert tbench.compute_measure("P@2", ["a", "x"], qrel) == 0.5
    with pytest.raises(ValueError, match="unknown measure"):
        tbench.compute_measure("F1@10", ["a"], qrel)
    rng = np.random.default_rng(0)
    docs = [f"d{i}" for i in range(30)]
    for _ in range(50):
        run = list(rng.choice(docs, size=rng.integers(0, 20), replace=False))
        qrel = {d: int(rng.integers(0, 3)) for d in rng.choice(docs, size=rng.integers(0, 8), replace=False)}
        for measure in ("AP@10", "nDCG@5", "recall@20", "P@3", "MRR", "ndcg"):
            assert tbench.compute_measure(measure, run, qrel) == jbench.compute_measure(measure, run, qrel)
    assert set(jbench.__all__) <= set(dir(tbench)) and tbench.__all__ == jbench.__all__


def test_run_ir_benchmark_equals_jax_on_hash(tmp_path, monkeypatch) -> None:
    """All seven variants on ``hash:128``: the same value to the last bit
    (the same embeddings, BM25, RRF, adapter and HNSW graph)."""
    got, want = _both_tables(tmp_path, monkeypatch, embedder="hash:128")
    assert list(got.index) == list(want.index) == list(ALL)
    assert got["AP@10"].tolist() == want["AP@10"].tolist()
    assert (got["AP@10"] > 0.6).all(), got
    # A second call replays the port's own cache, not the JAX package's.
    assert list((tmp_path / "torch-cache").glob("*.runs.json")) and list((tmp_path / "jax-cache").glob("*.runs.json"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX package's tiny f32 encoder and the port's with its weights
    (as tests/test_torch_hybrid.py carries them across), the synthetic
    dataset of 8 documents in both packages, and a directory whose stores
    the variants share as run_ir_benchmark shares them."""
    j_encoder = jenc.TransformerEncoder("tiny", dtype=np.float32)
    model = tt.EncoderModel.from_params(j_encoder._cfg, j_encoder._params, dtype=torch.float32, device="cpu")
    t_encoder = tenc.TransformerEncoder.from_model(model, ByteTokenizer(vocab_size=j_encoder._cfg["vocab"]))
    ds_j, ds_t = jbench.synthetic_dataset(num_docs=8), tbench.synthetic_dataset(num_docs=8)
    assert [d.id for d in ds_t.documents] == [d.id for d in ds_j.documents] and ds_t.queries == ds_j.queries
    return tmp_path_factory.mktemp("tiny"), (j_encoder, t_encoder), ds_j, ds_t


@pytest.mark.parametrize("variant", ALL)
def test_runs_equal_jax_on_the_tiny_encoder(tiny, monkeypatch, variant: str) -> None:
    """Each variant's runs (the ranked document ids of every query) equal
    the JAX package's, and so does the score they give."""
    root, (j_encoder, t_encoder), ds_j, ds_t = tiny
    monkeypatch.setattr(jenc, "_make_encoder", lambda embedder: j_encoder)
    monkeypatch.setattr(tenc, "_make_encoder", lambda embedder, device: t_encoder)
    jcfg = JConfig(store_path=str(root / "jax" / "store"), embedder="flax:tiny", llm="echo")
    tcfg = TConfig(store_path=str(root / "torch" / "store"), embedder="flax:tiny", llm="echo", device="cpu")
    if variant == "hnsw":
        j_eval = jbench.HnswEvaluator(ds_j, config=jcfg, cache_dir=str(root / "jc"))
        t_eval = tbench.HnswEvaluator(ds_t, config=tcfg, cache_dir=str(root / "tc"))
    else:
        j_eval = jbench.RAGLiteTPUEvaluator(ds_j, variant=variant, config=jcfg, cache_dir=str(root / "jc"))
        t_eval = tbench.RAGLiteTPUEvaluator(ds_t, variant=variant, config=tcfg, cache_dir=str(root / "tc"))
    want = j_eval.runs(num_results=10)
    assert t_eval.runs(num_results=10) == want
    assert t_eval.score("AP@10") == j_eval.score("AP@10")


def _write_beir(root: Path) -> Path:
    """A BEIR directory of three topics, graded qrels with a judged
    negative."""
    root.mkdir(parents=True)
    corpus = [
        {"_id": "fox", "title": "Foxes", "text": "The quick brown fox jumps over fences at dawn."},
        {"_id": "photon", "title": "Light", "text": "Photons carry momentum and energy without mass."},
        {"_id": "violin", "title": "", "text": "Violins have four strings tuned in perfect fifths."},
        {"_id": "tide", "title": "Tides", "text": "The moon's gravity raises two tidal bulges each day."},
    ]
    (root / "corpus.jsonl").write_text("\n".join(json.dumps(r) for r in corpus))
    queries = [{"_id": "q1", "text": "which animal jumps fences"}, {"_id": "q2", "text": "momentum of light"},
               {"_id": "q3", "text": "how many strings does a violin have"}]
    (root / "queries.jsonl").write_text("\n".join(json.dumps(r) for r in queries))
    (root / "qrels.tsv").write_text("query-id\tcorpus-id\tscore\nq1\tfox\t2\nq1\ttide\t0\nq2\tphoton\t1\nq3\tviolin\t1\n")
    return root


def test_beir_directory_equals_jax(tmp_path, monkeypatch) -> None:
    path = _write_beir(tmp_path / "beir-mini")
    ds_t, ds_j = tbench.beir_directory_dataset(str(path)), jbench.beir_directory_dataset(str(path))
    assert ds_t.name == ds_j.name == "beir-mini"
    assert [(d.id, d.filename, d.content) for d in ds_t.documents] == [(d.id, d.filename, d.content) for d in ds_j.documents]
    assert ds_t.queries == ds_j.queries and ds_t.qrels == ds_j.qrels == {"q1": {"fox": 2, "tide": 0}, "q2": {"photon": 1}, "q3": {"violin": 1}}
    got, want = _both_tables(tmp_path, monkeypatch, embedder="hash:128", dataset=str(path), num_queries=2,
                             variants=("multivector", "query_adapter", "keyword", "hybrid"))
    assert got["AP@10"].tolist() == want["AP@10"].tolist()
    with pytest.raises(ValueError, match="ir_datasets is unavailable"):
        tbench.load_dataset(str(tmp_path / "no-such-dir"))


def test_pandas_free_rows_and_cli_table(tmp_path) -> None:
    """With pandas unimportable: run_ir_benchmark returns the rows, and
    ``bench`` prints its own table of the same numbers."""
    code = f"""
import json, sys
sys.modules["pandas"] = None
from raglite_tpu_torch import RAGLiteConfig
from raglite_tpu_torch.irbench import run_ir_benchmark
from raglite_tpu_torch.cli import main
cfg = RAGLiteConfig(store_path={str(tmp_path / "s" / "store")!r}, embedder="hash:128", device="cpu")
rows = run_ir_benchmark(num_queries=6, variants=("multivector", "keyword", "hnsw"), config=cfg)
print(json.dumps(rows))
sys.exit(main(["--store-path", {str(tmp_path / "c" / "store")!r}, "--embedder", "hash:128", "--device", "cpu", "bench", "--num-queries", "6"]))
"""
    env = {"RAGLITE_TPU_BENCH_CACHE": str(tmp_path / "cache"), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    rows = json.loads(lines[0])
    assert [r["variant"] for r in rows] == ["multivector", "keyword", "hnsw"] and all(r["AP@10"] > 0.5 for r in rows)
    assert lines[1].split() == ["AP@10"] and lines[2].split() == ["variant"]
    table = {line.split()[0]: float(line.split()[1]) for line in lines[3:]}
    assert list(table) == list(ALL) and table["multivector"] == rows[0]["AP@10"] and table["hnsw"] == rows[2]["AP@10"]


def test_bench_through_both_clis(tmp_path, monkeypatch) -> None:
    """``bench`` prints the JAX CLI's text (pandas' table), and
    ``bench --hnsw-recall`` its report, key for key."""
    from click.testing import CliRunner

    from raglite_tpu.cli import cli as jcli
    from raglite_tpu_torch.cli import main

    def ours(*args: str) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--store-path", str(tmp_path / "t" / "store"), "--embedder", "hash:128", "--device", "cpu", *args]) == 0
        return buf.getvalue()

    def theirs(*args: str) -> str:
        result = CliRunner().invoke(jcli, ["--store-path", str(tmp_path / "j" / "store"), "--embedder", "hash:128", *args])
        assert result.exit_code == 0, result.output
        return result.output

    with _cache(monkeypatch, tmp_path / "jc"):
        want = theirs("bench", "--num-queries", "8")
        want_report = json.loads(theirs("bench", "--hnsw-recall", "--num-rows", "500").strip().splitlines()[-1])
    with _cache(monkeypatch, tmp_path / "tc"):
        got = ours("bench", "--num-queries", "8")
        got_report = json.loads(ours("bench", "--hnsw-recall", "--num-rows", "500"))
    # The JAX CLI's progress bars go to the same stream, the last one
    # cleared with spaces before the table's first line.
    table = got.splitlines()
    tail = want.replace("\r", "\n").rstrip("\n").splitlines()[-len(table) :]
    assert tail[1:] == table[1:] and tail[0].endswith(table[0]) and re.search(r"hnsw\s+\d", got), (got, want)
    assert got_report == want_report and got_report["num_rows"] == 500.0


def test_ir_benchmark_synthetic_and_rerank_share_a_store(tmp_path, monkeypatch) -> None:
    """tests/test_surfaces.py's cases: exact dense retrieval over the
    distinctive-vocabulary documents near 1.0, hybrid at least 0.9, and the
    rerank variant inserting into the multivector store."""
    monkeypatch.setenv("RAGLITE_TPU_BENCH_CACHE", str(tmp_path / "cache"))
    config = TConfig(store_path=str(tmp_path / "s"), embedder="hash:128", llm="echo", device="cpu")
    df = tbench.run_ir_benchmark(num_queries=8, variants=("multivector", "keyword", "hybrid", "rerank"), config=config)
    assert set(df.index) == {"multivector", "keyword", "hybrid", "rerank"}
    assert (df["AP@10"] > 0.6).all(), df
    assert df.loc["hybrid", "AP@10"] >= 0.9, df
    stores = {p.name for p in tmp_path.rglob("bench_*") if p.is_dir()}
    assert stores == {"bench_synthetic_multivector_8d"}, stores


@pytest.fixture(scope="module")
def vector_store_stub():
    """/files, /vector_stores, attach and /search of the vector-store API on
    127.0.0.1, ranking by keyword overlap."""
    files: dict[str, dict] = {}
    stores: dict[str, list[str]] = {}
    counter = {"n": 0}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:
            pass

        def _reply(self, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self) -> None:  # noqa: N802
            raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            counter["n"] += 1
            if self.path == "/files":
                text = raw.decode(errors="replace")
                name = re.search(r'filename="([^"]+)"', text).group(1)
                content = text.split("\r\n\r\n", 2)[-1].rsplit("\r\n--", 1)[0]
                fid = f"file_{counter['n']}"
                files[fid] = {"filename": name, "content": content}
                self._reply({"id": fid, "filename": name})
                return
            if self.path == "/vector_stores":
                sid = f"vs_{counter['n']}"
                stores[sid] = []
                self._reply({"id": sid})
                return
            attach = re.fullmatch(r"/vector_stores/(vs_\d+)/files", self.path)
            if attach:
                payload = json.loads(raw)
                stores[attach.group(1)].append(payload["file_id"])
                self._reply({"id": payload["file_id"], "status": "completed"})
                return
            search = re.fullmatch(r"/vector_stores/(vs_\d+)/search", self.path)
            if search:
                payload = json.loads(raw)
                terms = set(payload["query"].lower().split())
                scored = []
                for fid in stores[search.group(1)]:
                    words = set(files[fid]["content"].lower().split())
                    scored.append((len(terms & words) / max(len(terms), 1), fid, files[fid]["filename"]))
                scored.sort(reverse=True)
                self._reply({"data": [
                    {"file_id": fid, "filename": name, "score": score}
                    for score, fid, name in scored[: payload.get("max_num_results", 10)] if score > 0
                ]})
                return
            self._reply({"error": "unknown path"})

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()


def test_remote_vector_store_evaluator(vector_store_stub, tmp_path) -> None:
    from raglite_tpu_torch.documents import Document

    docs = [
        Document.from_text("the quick brown fox jumps over fences", id="d_fox"),
        Document.from_text("photons carry momentum and energy", id="d_photon"),
        Document.from_text("violins have four strings in fifths", id="d_violin"),
    ]
    dataset = tbench.IRDataset(
        name="stub", documents=docs, queries={"q1": "brown fox jumps", "q2": "photons momentum"},
        qrels={"q1": {"d_fox": 1}, "q2": {"d_photon": 1}},
    )
    evaluator = tbench.RemoteVectorStoreEvaluator(dataset, base_url=vector_store_stub, api_key="test", cache_dir=str(tmp_path))
    assert evaluator.search("brown fox jumps", 2)[0] == "d_fox"
    assert evaluator.search("photons momentum", 2)[0] == "d_photon"
    assert evaluator.score("AP@10") == 1.0
