"""The port's surfaces on the CPU against the JAX package's: the CLI
(``main(argv)`` against the click CLI through ``CliRunner``), the MCP
server's protocol over an in-repo store, the micro-batcher and the phase
tracer.  Stores use the ``hash:`` embedders, whose tables equal the JAX
package's bit for bit (tests/test_torch_hash.py), so ids must be equal and
scores within rtol 1e-4 (f16 query rounding, ROADMAP queue 3)."""

import io
import json
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from raglite_tpu.cli import cli as jcli
from raglite_tpu_torch.cli import main as tmain
from raglite_tpu_torch.utils import trace
from raglite_tpu_torch.utils.microbatch import KeyedMicroBatcher, MicroBatcher

ROOT = Path(__file__).resolve().parent.parent
DOCS = ("MIGRATION.md", "BASELINE.md")
QUERIES = ("Which public symbols have equivalents?", "What does the baseline measure?")


def _run(argv: list[str], capsys) -> str:
    assert tmain(argv) == 0
    return capsys.readouterr().out


def _rows(output: str) -> list[tuple[str, float]]:
    """(chunk id, score) of each line the search command prints."""
    rows = []
    for line in output.splitlines():
        score, chunk_id = line.split()[:2]
        rows.append((chunk_id, float(score)))
    return rows


@pytest.fixture(scope="module")
def stores(tmp_path_factory: pytest.TempPathFactory):
    """The same two documents inserted through each CLI."""
    root = tmp_path_factory.mktemp("cli")
    paths = [str(ROOT / name) for name in DOCS]
    jbase = ["--store-path", str(root / "jax"), "--embedder", "hash:128", "--llm", "echo"]
    tbase = ["--store-path", str(root / "torch"), "--embedder", "hash:128", "--llm", "echo", "--device", "cpu"]
    result = CliRunner().invoke(jcli, [*jbase, "insert", *paths])
    assert result.exit_code == 0, result.output
    out = io.StringIO()
    sys_stdout, sys.stdout = sys.stdout, out
    try:
        assert tmain([*tbase, "insert", *paths]) == 0
    finally:
        sys.stdout = sys_stdout
    # The JAX output also holds tqdm's progress lines (stderr, mixed in).
    assert out.getvalue() == f"Inserted 2 document(s) into {root / 'torch'}.\n"
    assert f"Inserted 2 document(s) into {root / 'jax'}." in result.output
    return jbase, tbase


@pytest.mark.parametrize("method", ["vector", "keyword", "hybrid"])
def test_cli_search_equals_jax(stores, capsys, method: str) -> None:
    jbase, tbase = stores
    for query in QUERIES:
        result = CliRunner().invoke(jcli, [*jbase, "search", query, "--method", method, "--num-results", "4"])
        assert result.exit_code == 0, result.output
        ours = _run([*tbase, "search", query, "--method", method, "--num-results", "4"], capsys)
        theirs_rows, ours_rows = _rows(result.output), _rows(ours)
        assert [c for c, _ in ours_rows] == [c for c, _ in theirs_rows] and ours_rows
        np.testing.assert_allclose([s for _, s in ours_rows], [s for _, s in theirs_rows], rtol=RTOL_CLI, atol=1e-4)
        # The text after the id (the chunk's first line) is the JAX CLI's.
        assert [line.split(None, 2)[2:] for line in ours.splitlines()] == [
            line.split(None, 2)[2:] for line in result.output.splitlines()
        ]


#: The CLI prints scores with 4 decimals: equal up to the last digit.
RTOL_CLI = 1e-4


def test_cli_stats_equals_jax(stores, capsys) -> None:
    jbase, tbase = stores
    theirs = json.loads(CliRunner().invoke(jcli, [*jbase, "stats"]).output)
    ours = json.loads(_run([*tbase, "stats"], capsys))
    assert {k: v for k, v in ours.items() if k != "store_path"} == {k: v for k, v in theirs.items() if k != "store_path"}
    assert ours["documents"] == 2 and ours["chunks"] > 4


def test_cli_delete_equals_jax(tmp_path, capsys) -> None:
    doc = tmp_path / "doc.md"
    doc.write_text("# Physics\n\n" + "Light speed is constant in vacuum. " * 60)
    other = tmp_path / "other.md"
    other.write_text("# Cooking\n\n" + "Bread rises when yeast ferments sugar. " * 60)
    jbase = ["--store-path", str(tmp_path / "j"), "--embedder", "hash:256"]
    tbase = ["--store-path", str(tmp_path / "t"), "--embedder", "hash:256", "--device", "cpu"]
    assert CliRunner().invoke(jcli, [*jbase, "insert", str(doc), str(other)]).exit_code == 0
    _run([*tbase, "insert", str(doc), str(other)], capsys)
    from raglite_tpu_torch.documents import Document

    doc_id = Document.from_path(doc).id
    result = CliRunner().invoke(jcli, [*jbase, "delete", doc_id])
    assert _run([*tbase, "delete", doc_id], capsys) == result.output == "Deleted 1 document(s).\n"
    result = CliRunner().invoke(jcli, [*jbase, "search", "light speed", "--method", "keyword"])
    ours = _run([*tbase, "search", "light speed", "--method", "keyword"], capsys)
    assert [c for c, _ in _rows(ours)] == [c for c, _ in _rows(result.output)]
    assert json.loads(_run([*tbase, "stats"], capsys))["documents"] == 1


def test_cli_dotenv_and_environment(tmp_path, monkeypatch) -> None:
    """RAGLITE_TPU_* from .env, the environment over .env, options over
    both, as the JAX CLI reads them; RAGLITE_TPU_DEVICE picks the device."""
    from raglite_tpu.cli import _config_from_options as jconfig
    from raglite_tpu_torch.cli import _config_from_options, build_parser

    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text(
        'RAGLITE_TPU_LLM="jax:tiny"\nRAGLITE_TPU_EMBEDDER=hash:128\nRAGLITE_TPU_DEVICE=cpu\n# comment\nOTHER=1\n'
    )
    config = _config_from_options(build_parser().parse_args(["stats"]))
    theirs = jconfig(None, None, None)
    assert (config.llm, config.embedder, config.device) == (theirs.llm, theirs.embedder, "cpu")
    monkeypatch.setenv("RAGLITE_TPU_EMBEDDER", "hash:64")
    config = _config_from_options(build_parser().parse_args(["--llm", "echo", "stats"]))
    assert (config.llm, config.embedder, config.device) == ("echo", "hash:64", "cpu")
    assert (config.embedder, "echo") == (jconfig(None, "echo", None).embedder, jconfig(None, "echo", None).llm)


def test_cli_device_defaults_to_cuda(tmp_path, monkeypatch) -> None:
    from raglite_tpu_torch.cli import _config_from_options, build_parser

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RAGLITE_TPU_DEVICE", raising=False)
    assert _config_from_options(build_parser().parse_args(["stats"])).device == "cuda"


def test_mcp_install_writes_desktop_config(tmp_path, monkeypatch, capsys) -> None:
    monkeypatch.setenv("HOME", str(tmp_path))
    store = str(tmp_path / "kb")
    result = CliRunner().invoke(jcli, ["--store-path", store, "mcp", "install", "--server-name", "jaxkb"])
    assert result.exit_code == 0, result.output
    out = _run(["--store-path", store, "--device", "cpu", "mcp", "install", "--server-name", "testkb"], capsys)
    config_file = tmp_path / ".config" / "Claude" / "claude_desktop_config.json"
    assert out == f"Installed MCP server 'testkb' in {config_file}.\n"
    servers = json.loads(config_file.read_text())["mcpServers"]
    ours, theirs = servers["testkb"], servers["jaxkb"]
    assert ours["command"] == theirs["command"] == sys.executable
    assert ours["args"][:2] == ["-m", "raglite_tpu_torch"] and theirs["args"][:2] == ["-m", "raglite_tpu"]
    assert ours["args"][2:8] == theirs["args"][2:8]
    assert ours["args"][8:] == ["--device", "cpu", "mcp", "run"] and theirs["args"][8:] == ["mcp", "run"]


def test_bench_names_the_roadmap_item(capsys, monkeypatch) -> None:
    """``bench`` is ported (ROADMAP queue 1 item 7, done; its runs are in
    tests/test_torch_irbench.py): where no C++ toolchain builds the HNSW
    baseline, ``--hnsw-recall`` exits 1 saying so, as the JAX CLI does."""
    import raglite_tpu_torch.native as native

    monkeypatch.setattr(native, "native_available", lambda: False)
    assert tmain(["--device", "cpu", "bench", "--hnsw-recall"]) == 1
    assert "no C++ toolchain is available" in capsys.readouterr().err


def test_insert_missing_path_is_a_usage_error(tmp_path, capsys) -> None:
    with pytest.raises(SystemExit) as exit_info:
        tmain(["--store-path", str(tmp_path / "kb"), "insert", str(tmp_path / "absent.md")])
    assert exit_info.value.code == 2
    assert "does not exist" in capsys.readouterr().err


def test_help_without_click() -> None:
    """``--help`` and ``python -m raglite_tpu_torch`` with click made
    unimportable: every command is listed, nothing needs click."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["click"] = None
        from raglite_tpu_torch.cli import main
        try:
            main(["--help"])
        except SystemExit as e:
            assert e.code == 0
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for command in ("insert", "search", "chat", "serve", "mcp", "bench", "delete", "update-adapter", "evals", "stats"):
        assert command in out.stdout
    assert "--device" in out.stdout


def test_python_dash_m_runs_the_cli(stores) -> None:
    _, tbase = stores
    out = subprocess.run(
        [sys.executable, "-m", "raglite_tpu_torch", *tbase, "stats"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["documents"] == 2


def test_cli_chat_with_echo(tmp_path, monkeypatch, capsys) -> None:
    doc = tmp_path / "doc.md"
    doc.write_text("# Relativity\n\n" + "Einstein defines simultaneity with light signals. " * 40)
    base = ["--store-path", str(tmp_path / "kb"), "--embedder", "hash:256", "--llm", "echo", "--device", "cpu"]
    _run([*base, "insert", str(doc)], capsys)
    monkeypatch.setattr(sys, "stdin", io.StringIO("How is simultaneity defined?\n"))
    out = _run([*base, "chat"], capsys)
    assert out.startswith("RAGLite-TPU chat") and "assistant> " in out and out.rstrip().endswith("bye")


def test_cli_evals_and_adapter(tmp_path, capsys) -> None:
    """evals insert / update-adapter / evals run on a tiny store (the JAX
    CLI test's recipe: per-document evals written into the store)."""
    from raglite_tpu_torch.config import RAGLiteConfig
    from raglite_tpu_torch.documents import Document, Eval
    from raglite_tpu_torch.store import store_from_config

    store = str(tmp_path / "kb")
    base = ["--store-path", store, "--embedder", "hash:256", "--llm", "echo", "--device", "cpu"]
    docs = []
    for name, sentence in (("doc", "Light speed is constant in vacuum. "), ("other", "Bread rises when yeast ferments. ")):
        path = tmp_path / f"{name}.md"
        path.write_text(f"# {name}\n\n" + sentence * 120)
        docs.append(path)
    _run([*base, "insert", *map(str, docs)], capsys)
    assert "Inserted up to 2 eval(s)." in _run([*base, "evals", "insert", "--num-evals", "2"], capsys)
    config = RAGLiteConfig(store_path=store, embedder="hash:256", llm="echo", device="cpu")
    kb = store_from_config(config)
    for source in docs:
        doc_id = Document.from_path(source).id
        chunk_ids = [c for c in kb.chunk_order if kb.chunks[c].document_id == doc_id]
        kb.add_evals([Eval.from_chunks(question=f"About {source.stem}?", contexts=[kb.get_chunk(c) for c in chunk_ids], ground_truth=source.stem)])
    kb.save()
    assert "Query adapter updated: shape (256, 256)." in _run([*base, "update-adapter"], capsys)
    assert "answer_similarity" in _run([*base, "evals", "run", "--num-evals", "2"], capsys)


# --- MCP --------------------------------------------------------------------


@pytest.fixture(scope="module")
def mcp_configs(tmp_path_factory: pytest.TempPathFactory):
    from raglite_tpu import Document as JDocument
    from raglite_tpu import RAGLiteConfig as JConfig
    from raglite_tpu import insert_documents as jinsert
    from raglite_tpu_torch import Document as TDocument
    from raglite_tpu_torch import RAGLiteConfig as TConfig
    from raglite_tpu_torch import insert_documents as tinsert

    root = tmp_path_factory.mktemp("mcp")
    texts = [(ROOT / name).read_text(encoding="utf-8") for name in DOCS]
    jcfg = JConfig(store_path=str(root / "j"), embedder="hash:256", llm="echo")
    tcfg = TConfig(store_path=str(root / "t"), embedder="hash:256", llm="echo", device="cpu")
    jinsert([JDocument.from_text(t) for t in texts], config=jcfg)
    tinsert([TDocument.from_text(t) for t in texts], config=tcfg)
    return jcfg, tcfg


def _mcp_session(server) -> dict:
    requests = [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "method": "notifications/initialized"},
        {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
        {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
         "params": {"name": "search_knowledge_base", "arguments": {"query": QUERIES[0]}}},
        {"jsonrpc": "2.0", "id": 4, "method": "prompts/list"},
        {"jsonrpc": "2.0", "id": 5, "method": "prompts/get", "params": {"name": "kb", "arguments": {"query": "what?"}}},
        {"jsonrpc": "2.0", "id": 6, "method": "nope/nope"},
        {"jsonrpc": "2.0", "id": 7, "method": "tools/call", "params": {"name": "unknown", "arguments": {}}},
        {"jsonrpc": "2.0", "id": 8, "method": "ping"},
    ]
    stdin = io.StringIO("\n".join(json.dumps(r) for r in requests) + "\nnot json\n[1, 2]\n")
    stdout = io.StringIO()
    server.run(stdin=stdin, stdout=stdout)
    return [json.loads(line) for line in stdout.getvalue().splitlines()]


def test_mcp_protocol_equals_jax(mcp_configs) -> None:
    from raglite_tpu.mcp import create_mcp_server as jcreate
    from raglite_tpu_torch.mcp import create_mcp_server as tcreate

    jcfg, tcfg = mcp_configs
    ours, theirs = _mcp_session(tcreate(config=tcfg)), _mcp_session(jcreate(config=jcfg))
    assert len(ours) == len(theirs) == 9
    by_id = {r["id"]: r for r in ours}
    assert by_id[1]["result"]["serverInfo"]["name"] == "RAGLite-TPU"
    assert by_id[2]["result"]["tools"][0]["name"] == "search_knowledge_base"
    assert by_id[6]["error"]["code"] == -32601 and by_id[7]["error"]["code"] == -32603
    assert by_id[None]["error"]["code"] == -32600  # the batch array
    payload = json.loads(by_id[3]["result"]["content"][0]["text"])
    assert payload["documents"]
    # Every response equal, the tool's retrieved context included.
    assert ours == theirs


def test_search_knowledge_base_equals_retrieve_context(mcp_configs) -> None:
    from raglite_tpu_torch.mcp import search_knowledge_base
    from raglite_tpu_torch.rag import retrieve_context

    _, tcfg = mcp_configs
    spans = retrieve_context(QUERIES[1], config=tcfg)
    payload = json.loads(search_knowledge_base(QUERIES[1], config=tcfg))
    assert len(payload["documents"]) == len(spans)
    assert spans[0].chunks[0].id in json.dumps(payload)


# --- Micro-batcher (the cases of tests/test_microbatch.py) -------------------


def test_microbatcher_coalesces_and_orders() -> None:
    calls: list[list[int]] = []

    def batch_fn(items):
        calls.append(list(items))
        time.sleep(0.01)
        return [i * 10 for i in items]

    mb = MicroBatcher(batch_fn, max_batch=16, max_wait_ms=20.0)
    results: dict[int, int] = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, mb.submit(i))) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert results == {i: i * 10 for i in range(24)}
    assert sum(len(c) for c in calls) == 24 and max(len(c) for c in calls) > 1
    assert list(mb.batch_sizes) == [len(c) for c in calls]


def test_microbatcher_max_batch_wakes_leader_early() -> None:
    mb = MicroBatcher(lambda xs: xs, max_batch=4, max_wait_ms=5_000.0)
    out: list[int] = []
    threads = [threading.Thread(target=lambda i=i: out.append(mb.submit(i))) for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert time.perf_counter() - t0 < 2.0
    assert sorted(out) == [0, 1, 2, 3]


def test_microbatcher_propagates_errors() -> None:
    def boom(items):
        msg = "kaput"
        raise RuntimeError(msg)

    mb = MicroBatcher(boom, max_wait_ms=1.0)
    errors: list[str] = []

    def worker():
        try:
            mb.submit(1)
        except RuntimeError as exc:
            errors.append(str(exc))

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errors == ["kaput"] * 3


def test_microbatcher_keeps_one_batch_in_flight() -> None:
    """Requests that arrive while a batch runs gather under the next leader:
    64 concurrent requests make a few batches, never two at once, none
    above max_batch."""
    running, most = [0], [0]
    guard = threading.Lock()

    def batch_fn(items):
        with guard:
            running[0] += 1
            most[0] = max(most[0], running[0])
        time.sleep(0.05)
        with guard:
            running[0] -= 1
        return [i + 1 for i in items]

    mb = MicroBatcher(batch_fn, max_batch=32, max_wait_ms=2.0)
    results: dict[int, int] = {}
    start = threading.Barrier(64)

    def worker(i):
        start.wait()
        results[i] = mb.submit(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert results == {i: i + 1 for i in range(64)}
    assert most[0] == 1 and sum(mb.batch_sizes) == 64
    assert max(mb.batch_sizes) <= 32 and len(mb.batch_sizes) <= 4, list(mb.batch_sizes)


def test_microbatcher_timed_out_follower_leaves_the_queue() -> None:
    release = threading.Event()

    def batch_fn(items):
        release.wait(10)
        return items

    mb = MicroBatcher(batch_fn, max_wait_ms=0.0, timeout_s=0.2)
    leaders = [threading.Thread(target=mb.submit, args=(i,)) for i in range(2)]
    leaders[0].start()
    while not mb._running.locked():  # the first batch runs
        time.sleep(0.001)
    leaders[1].start()  # leads the next batch, waiting for the first
    while not mb._pending:
        time.sleep(0.001)
    with pytest.raises(TimeoutError):
        mb.submit(2)  # queued behind them, then gives up
    release.set()
    for t in leaders:
        t.join(timeout=10)
        assert not t.is_alive()
    assert mb.submit(3) == 3 and list(mb.batch_sizes) == [1, 1, 1]


def test_keyed_batcher_separates_and_bounds_keys() -> None:
    seen: dict[str, list[list[int]]] = {}

    def factory(key):
        def run(items):
            seen.setdefault(key, []).append(list(items))
            return items

        return run

    kb = KeyedMicroBatcher(factory, max_wait_ms=10.0, max_keys=2)
    threads = [threading.Thread(target=lambda k=k, i=i: kb.submit(k, i)) for i in range(6) for k in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sum(len(c) for c in seen["a"]) == 6 and sum(len(c) for c in seen["b"]) == 6
    kb.submit("c", 0)
    assert list(kb._batchers) == ["b", "c"]  # the least recently used key went


# --- Phases and traces (the cases of tests/test_trace.py) --------------------


def test_phase_timing_aggregates() -> None:
    trace.reset()
    with trace.phase("unit.alpha"):
        pass
    with trace.phase("unit.alpha"):
        pass
    with trace.phase("unit.beta"), trace.phase("unit.nested"):
        pass
    summary = trace.report()
    assert summary["unit.alpha"]["count"] == 2
    assert summary["unit.beta"]["count"] == summary["unit.nested"]["count"] == 1
    assert summary["unit.alpha"]["total_s"] >= 0
    with pytest.raises(KeyError), trace.phase("unit.raises"):
        raise KeyError("x")
    assert trace.report()["unit.raises"]["count"] == 1


def test_insert_and_search_emit_phases_as_jax() -> None:
    from raglite_tpu import RAGLiteConfig as JConfig
    from raglite_tpu import insert_documents as jinsert
    from raglite_tpu import vector_search as jsearch
    from raglite_tpu.documents import Document as JDocument
    from raglite_tpu.utils import trace as jtrace
    from raglite_tpu_torch import RAGLiteConfig, insert_documents, vector_search
    from raglite_tpu_torch.documents import Document

    text = "# T\n\n" + "Photons travel at light speed. " * 50
    trace.reset()
    jtrace.reset()
    config = RAGLiteConfig(store_path=":memory:", embedder="hash:256", llm="echo", device="cpu")
    insert_documents([Document.from_text(text)], config=config)
    vector_search("photons", config=config)
    jconfig = JConfig(store_path=":memory:", embedder="hash:256", llm="echo")
    jinsert([JDocument.from_text(text)], config=jconfig)
    jsearch("photons", config=jconfig)
    ours, theirs = trace.report(), jtrace.report()
    for name in ("insert.split_sentences", "insert.split_chunklets", "insert.embed", "insert.split_chunks",
                 "search.embed_query", "search.dense_scan"):
        assert ours[name]["count"] == theirs[name]["count"] == 1, name


def test_progress_meter_tty_and_silent() -> None:
    class Tty(io.StringIO):
        def isatty(self) -> bool:
            return True

    stream = Tty()
    with trace.Progress(3, "work", stream=stream) as progress:
        for _ in range(3):
            progress.update()
    assert "3/3" in stream.getvalue() and stream.getvalue().endswith("\n")
    silent = io.StringIO()
    with trace.Progress(2, "quiet", stream=silent) as progress:
        progress.update(2)
    assert silent.getvalue() == ""


def test_trace_session_writes_chrome_trace_with_phases(tmp_path) -> None:
    import torch

    with trace.trace_session(str(tmp_path)) as path:
        with trace.phase("unit.traced"):
            (torch.ones((64, 64)) @ torch.ones((64, 64))).sum()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "unit.traced" in names
    assert any("mm" in str(n) for n in names)
