"""The port's web chat (webchat.py) over a real HTTP server on 127.0.0.1,
on the CPU: the cases of tests/test_webchat.py and tests/test_microbatch.py
(settings, uploads small and large, SSE chat with sources, search, stats,
delete, the origin and content-type checks, ``store_path`` not settable,
the embedder-dimension guard, session-scoped attachments, micro-batched
concurrent searches), a binary PDF upload through ``Document.from_path``,
and ``/api/search`` answers equal to the JAX package's web chat on the same
documents (``hash:256``, whose table equals the JAX package's)."""

import json
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import raglite_tpu_torch.webchat as webchat
from raglite_tpu_torch import RAGLiteConfig
from raglite_tpu_torch.webchat import WebChatApp, create_web_app

ROOT = Path(__file__).resolve().parent.parent


def _config(path: str = ":memory:", **kw) -> RAGLiteConfig:
    return RAGLiteConfig(store_path=path, embedder="hash:256", llm="echo", device="cpu", **kw)


@pytest.fixture(scope="module")
def app_port(tmp_path_factory: pytest.TempPathFactory):
    app = create_web_app(_config(str(tmp_path_factory.mktemp("kb") / "store")))
    server, port = app.serve_background()
    yield app, port
    server.shutdown()


def _get(port: int, path: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as response:
        return response.status, response.read()


def _post(port: int, path: str, data: bytes, headers: dict | None = None) -> tuple[int, bytes]:
    merged = {"Content-Type": "application/json", **(headers or {})}
    request = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, headers=merged, method="POST")
    with urllib.request.urlopen(request) as response:
        return response.status, response.read()


def _post_error(port: int, path: str, data: bytes, headers: dict) -> int:
    request = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, headers=headers, method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(request)
    return err.value.code


def test_index_page_and_unknown_path(app_port) -> None:
    _, port = app_port
    status, body = _get(port, "/")
    assert status == 200 and b"RAGLite-TPU chat" in body
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(port, "/nope")
    assert err.value.code == 404


def test_settings_roundtrip(app_port) -> None:
    app, port = app_port
    assert json.loads(_get(port, "/api/settings")[1])["llm"] == "echo"
    _, body = _post(port, "/api/settings", json.dumps({"vector_search_query_adapter": False}).encode())
    assert json.loads(body)["vector_search_query_adapter"] is False
    assert app.config.vector_search_query_adapter is False
    assert app.config.device == "cpu"


def test_upload_small_inlines_large_inserts(app_port) -> None:
    _, port = app_port
    _, body = _post(port, "/api/upload", b"tiny note", {"X-Filename": "note.txt"})
    assert json.loads(body)["status"] == "inlined"
    _, body = _post(port, "/api/upload", ("Relativity paragraph. " * 600).encode(), {"X-Filename": "big.md"})
    payload = json.loads(body)
    assert payload["status"] == "inserted" and payload["id"]


def test_binary_pdf_upload_parses(app_port, tmp_path) -> None:
    """A PDF's bytes go through Document.from_path under its uploaded name."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from raglite_tpu_torch.store import store_from_config

    app, port = app_port
    path = tmp_path / "report.pdf"
    chip_smoke.write_pdf(path, [(1, "Glacier Report"), *[(0, "The glacier advances three meters per year in spring.")] * 40])
    _, body = _post(port, "/api/upload", path.read_bytes(), {"X-Filename": "report.pdf"})
    payload = json.loads(body)
    assert payload["status"] == "inserted"
    document = store_from_config(app.config).documents[payload["id"]]
    assert document.filename == "report.pdf" and document.metadata_["filename"] == "report.pdf"
    _, body = _post(port, "/api/search", json.dumps({"query": "glacier advances", "method": "keyword"}).encode())
    assert json.loads(body)["results"][0]["document_id"] == payload["id"]


def test_chat_streams_tokens_and_sources(app_port) -> None:
    _, port = app_port
    corpus = "# Simultaneity\n\n" + "Einstein defines simultaneity via light signals. " * 200
    _post(port, "/api/upload", corpus.encode(), {"X-Filename": "specrel.md"})
    status, body = _post(
        port, "/api/chat",
        json.dumps({"messages": [{"role": "user", "content": "How is simultaneity defined?"}]}).encode(),
    )
    assert status == 200
    events = [e for e in body.decode().split("\n\n") if e.strip()]
    kinds = [line[7:] for e in events for line in e.split("\n") if line.startswith("event: ")]
    assert "token" in kinds and "sources" in kinds and kinds[-1] == "done"


def test_search_and_stats_endpoints(app_port) -> None:
    _, port = app_port
    corpus = "# Waves\n\n" + "Interference patterns emerge from coherent waves. " * 200
    _post(port, "/api/upload", corpus.encode(), {"X-Filename": "waves.md"})
    for method in ("hybrid", "vector", "keyword"):
        _, body = _post(port, "/api/search", json.dumps({"query": "coherent interference", "method": method, "num_results": 3}).encode())
        payload = json.loads(body)
        assert payload["method"] == method and payload["results"] and "body" in payload["results"][0]
    _, body = _post(port, "/api/search", json.dumps({"query": "coherent interference", "rerank": True, "num_results": 3}).encode())
    assert json.loads(body)["results"]
    stats = json.loads(_get(port, "/api/stats")[1])
    assert stats["chunks"] >= 1 and stats["index_rows"] >= 1 and stats["num_devices"] == 1
    assert {"insert.embed", "search.embed_query"} <= set(stats["phases"])


def test_delete_endpoint(app_port) -> None:
    _, port = app_port
    doc = "# Minerals\n\n" + "Quartz crystals form hexagonal prisms. " * 300
    _, body = _post(port, "/api/upload", doc.encode(), {"X-Filename": "minerals.md"})
    doc_id = json.loads(body)["id"]
    _, body = _post(port, "/api/delete", json.dumps({"document_ids": [doc_id]}).encode())
    assert json.loads(body)["deleted_ids"] == [doc_id]
    _, body = _post(port, "/api/search", json.dumps({"query": "quartz hexagonal prisms", "method": "keyword"}).encode())
    assert all(r["document_id"] != doc_id for r in json.loads(body)["results"])


def test_cross_origin_post_rejected(app_port) -> None:
    app, port = app_port
    code = _post_error(port, "/api/settings", json.dumps({"llm": "evil"}).encode(),
                       {"Content-Type": "application/json", "Origin": "http://evil.example"})
    assert code == 403 and app.config.llm == "echo"
    status, _ = _post(port, "/api/settings", b"{}", {"Origin": f"http://127.0.0.1:{port}"})
    assert status == 200


def test_wildcard_bind_accepts_local_origin_rejects_rebinding(monkeypatch) -> None:
    """On a wildcard bind an Origin naming one of this machine's addresses
    is accepted; one that merely agrees with the Host header (a DNS
    rebind) or names another port is refused.  The address list is set
    here (no interface lookups in a test)."""
    monkeypatch.setattr(webchat, "_LOCAL_ADDRESSES", {"localhost", "127.0.0.1", "::1", "192.0.2.7"})
    app = create_web_app(_config())
    server, port = app.serve_background(host="0.0.0.0")  # noqa: S104
    try:
        status, _ = _post(port, "/api/settings", b"{}", {"Origin": f"http://192.0.2.7:{port}"})
        assert status == 200
        assert _post_error(port, "/api/settings", b"{}", {
            "Content-Type": "application/json", "Origin": f"http://evil.example:{port}", "Host": f"evil.example:{port}",
        }) == 403
        assert _post_error(port, "/api/settings", b"{}", {
            "Content-Type": "application/json", "Origin": f"http://192.0.2.7:{port + 1}",
        }) == 403
    finally:
        server.shutdown()


def test_store_path_not_settable_over_http(app_port) -> None:
    app, port = app_port
    before = app.config.store_path
    _post(port, "/api/settings", json.dumps({"store_path": "/etc", "device": "cuda"}).encode())
    assert app.config.store_path == before and app.config.device == "cpu"


def test_non_json_content_type_rejected(app_port) -> None:
    _, port = app_port
    for path in ("/api/settings", "/api/search", "/api/delete", "/api/chat"):
        assert _post_error(port, path, b"llm=evil", {"Content-Type": "application/x-www-form-urlencoded"}) == 415


def test_settings_rejects_mismatched_embedder_dim(tmp_path) -> None:
    from raglite_tpu_torch import Document, insert_documents

    config = _config(str(tmp_path / "kb"))
    insert_documents([Document.from_text("Some content for the store. " * 8)], config=config)
    app = WebChatApp(config)
    assert "error" in app.handle_settings_post({"embedder": "hash:512"})
    assert app.config.embedder == "hash:256"
    assert "error" not in app.handle_settings_post({"llm": "echo"})


def test_inline_attachments_are_session_scoped(tmp_path) -> None:
    app = WebChatApp(_config(str(tmp_path / "kb")))
    app.handle_upload("a.txt", b"alpha secret attachment", "session-A")
    events_b = list(app.chat_events([{"role": "user", "content": "hi"}], "session-B"))
    assert "alpha secret" not in "".join(d for e, d in events_b if e == "token")
    assert app._inline_docs.get("session-A")
    list(app.chat_events([{"role": "user", "content": "hi"}], "session-A"))
    assert "session-A" not in app._inline_docs  # used by its own next turn


def test_concurrent_searches_batch_and_equal_alone(tmp_path) -> None:
    """Concurrent /api/search requests coalesce (a batch larger than 1)
    and each answer equals the same search made alone."""
    from raglite_tpu_torch import Document, insert_documents, vector_search

    config = _config(str(tmp_path / "kb"))
    doc = Document.from_text(
        "# Fruit\n\nApples are red or green fruit from trees. " * 8
        + "\n\n# Light\n\nThe speed of light is a universal constant. " * 8
    )
    insert_documents([doc], config=config)
    app = WebChatApp(config)
    app.handle_search({"query": "warmup", "method": "vector", "num_results": 2})
    queries = ["red green fruit apples", "speed of light constant"] * 8
    out: dict[int, dict] = {}
    start = threading.Barrier(len(queries))

    def worker(i):
        start.wait()
        out[i] = app.handle_search({"query": queries[i], "method": "vector", "num_results": 2})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    sizes = [s for b in app._search_batcher._batchers.values() for s in b.batch_sizes]
    assert sum(sizes) == len(queries) + 1 and max(sizes) > 1
    for i, query in enumerate(queries):
        ids, scores = vector_search(query, num_results=2, config=config)
        assert [r["chunk_id"] for r in out[i]["results"]] == ids
        np.testing.assert_allclose([r["score"] for r in out[i]["results"]], scores, rtol=1e-6)
    assert "fruit" in out[0]["results"][0]["body"].lower() and "light" in out[1]["results"][0]["body"].lower()


@pytest.mark.parametrize("method", ["vector", "keyword", "hybrid"])
def test_search_answers_equal_jax(tmp_path, method: str) -> None:
    from raglite_tpu import Document as JDocument
    from raglite_tpu import RAGLiteConfig as JConfig
    from raglite_tpu import insert_documents as jinsert
    from raglite_tpu.webchat import WebChatApp as JWebChatApp
    from raglite_tpu_torch import Document, insert_documents

    texts = [(ROOT / name).read_text(encoding="utf-8") for name in ("MIGRATION.md", "BASELINE.md")]
    jcfg = JConfig(store_path=str(tmp_path / "j"), embedder="hash:256", llm="echo")
    tcfg = _config(str(tmp_path / "t"))
    jinsert([JDocument.from_text(t) for t in texts], config=jcfg)
    insert_documents([Document.from_text(t) for t in texts], config=tcfg)
    ours, theirs = WebChatApp(tcfg), JWebChatApp(jcfg)
    for query in ("Which public symbols have equivalents?", "What does the baseline measure?"):
        body = {"query": query, "method": method, "num_results": 4}
        a, b = ours.handle_search(body), theirs.handle_search(body)
        assert [r["chunk_id"] for r in a["results"]] == [r["chunk_id"] for r in b["results"]] and a["results"]
        assert [(r["headings"], r["body"], r["document_id"]) for r in a["results"]] == [
            (r["headings"], r["body"], r["document_id"]) for r in b["results"]
        ]
        np.testing.assert_allclose([r["score"] for r in a["results"]], [r["score"] for r in b["results"]], rtol=1e-4)
