"""First-party web chat frontend (stdlib HTTP + SSE; a copy of
raglite_tpu/webchat.py over the port).

The reference ships a Chainlit app (raglite/_chainlit.py:
settings widgets :24-62, attachment handling :70-91, streamed ``async_rag``
with a retrieval callback and deduped source elements :92-114).  Chainlit is
a heavyweight optional dependency; this module provides the same surface as
a zero-dependency web app:

- ``GET /``              single-page chat UI
- ``POST /api/chat``     streamed RAG answer as Server-Sent Events;
                         ``sources`` events carry the retrieved chunk spans
- ``POST /api/upload``   insert an attached document (small documents are
                         inlined into the message instead, like the
                         reference's <attachment> path, _chainlit.py:70-91)
- ``GET/POST /api/settings``  runtime store/llm/embedder/query-adapter
                         settings (the reference's settings widgets)
- ``POST /api/search``   direct retrieval (vector/keyword/hybrid, optional
                         rerank + metadata filter) — the persistent device
                         index-server role that maps to the reference's
                         Postgres server mode (SURVEY §2.2)
- ``GET /api/stats``     store/index stats + phase timings

Run with ``python -m raglite_tpu_torch serve`` (cli.py) or ``create_web_app().serve()``.
"""

from __future__ import annotations

import json
import threading
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from raglite_tpu_torch.config import RAGLiteConfig

__all__ = ["WebChatApp", "create_web_app"]


def _local_addresses() -> set[str]:
    """Hostnames/IPs that legitimately name this machine, for the wildcard
    -bind Origin check (cached — interface enumeration is not free)."""
    global _LOCAL_ADDRESSES
    if _LOCAL_ADDRESSES is None:
        import socket

        addrs = {"localhost", "127.0.0.1", "::1"}
        try:
            hostname = socket.gethostname()
            addrs.update({hostname, hostname.lower()})
            _, aliases, ips = socket.gethostbyname_ex(hostname)
            addrs.update(a.lower() for a in aliases)
            addrs.update(ips)
        except OSError:
            pass
        try:
            # UDP connect sends no packet; it just binds the outbound
            # interface, revealing the primary LAN address.
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect(("10.254.254.254", 1))
                addrs.add(s.getsockname()[0])
        except OSError:
            pass
        _LOCAL_ADDRESSES = addrs
    return _LOCAL_ADDRESSES


_LOCAL_ADDRESSES: set[str] | None = None

#: Attachments up to this many characters are inlined into the prompt
#: instead of being inserted into the knowledge base (reference inlines
#: documents that fit half the context window, _chainlit.py:74-84).
INLINE_ATTACHMENT_MAX_CHARS = 8_192

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>RAGLite-TPU</title>
<style>
body { font-family: system-ui, sans-serif; margin: 0; display: flex; height: 100vh; }
#main { flex: 3; display: flex; flex-direction: column; padding: 1rem; }
#sources { flex: 1; border-left: 1px solid #ddd; padding: 1rem; overflow-y: auto; }
#log { flex: 1; overflow-y: auto; white-space: pre-wrap; }
.msg { margin: .5rem 0; padding: .5rem .75rem; border-radius: .5rem; }
.user { background: #e8f0fe; }
.assistant { background: #f6f6f6; }
.source { font-size: .85rem; border-bottom: 1px solid #eee; padding: .4rem 0; }
form { display: flex; gap: .5rem; }
input[type=text] { flex: 1; padding: .5rem; }
</style></head>
<body>
<div id="main">
  <h3>RAGLite-TPU chat</h3>
  <div id="log"></div>
  <form id="f">
    <input type="text" id="q" placeholder="Ask the knowledge base..." autofocus>
    <input type="file" id="file">
    <button>Send</button>
  </form>
</div>
<div id="sources"><h4>Sources</h4><div id="srclist"></div></div>
<script>
const log = document.getElementById('log');
const srclist = document.getElementById('srclist');
const f = document.getElementById('f');
const session = Math.random().toString(36).slice(2) + Date.now().toString(36);
function add(cls, text) {
  const d = document.createElement('div');
  d.className = 'msg ' + cls; d.textContent = text;
  log.appendChild(d); log.scrollTop = log.scrollHeight; return d;
}
f.onsubmit = async (e) => {
  e.preventDefault();
  const q = document.getElementById('q');
  const file = document.getElementById('file');
  if (file.files.length) {
    // Raw bytes: .text() would UTF-8-mangle binary files (PDF/docx) and
    // bypass the server's binary parse path entirely.
    const body = await file.files[0].arrayBuffer();
    await fetch('/api/upload', {method: 'POST',
      headers: {'X-Filename': file.files[0].name, 'X-Session': session}, body});
    add('assistant', 'Uploaded ' + file.files[0].name);
    file.value = '';
  }
  if (!q.value) return;
  const text = q.value; q.value = '';
  add('user', text);
  const out = add('assistant', '');
  const res = await fetch('/api/chat', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({messages: [{role: 'user', content: text}], session})});
  const reader = res.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    let i;
    while ((i = buf.indexOf('\\n\\n')) >= 0) {
      const evt = buf.slice(0, i); buf = buf.slice(i + 2);
      const lines = evt.split('\\n');
      let type = 'message', data = '';
      for (const l of lines) {
        if (l.startsWith('event: ')) type = l.slice(7);
        if (l.startsWith('data: ')) data += l.slice(6);
      }
      if (type === 'token') out.textContent += JSON.parse(data);
      if (type === 'sources') {
        srclist.innerHTML = '';
        for (const s of JSON.parse(data)) {
          const d = document.createElement('div');
          d.className = 'source';
          d.textContent = s.headings + ' — ' + s.preview;
          srclist.appendChild(d);
        }
      }
    }
  }
};
</script>
</body></html>
"""


class _Server(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog for concurrent
    clients: socketserver's default of 5 resets the connections of a burst
    of simultaneous requests (the JAX package's server keeps it)."""

    request_queue_size = 128


class WebChatApp:
    """Holds mutable runtime settings + the HTTP server plumbing."""

    def __init__(self, config: RAGLiteConfig | None = None) -> None:
        self.config = config or RAGLiteConfig()
        #: Inline attachments keyed by client session id — a shared list
        #: would inject one client's attachment into whichever /api/chat
        #: request lands next (cross-user leak under the threading server).
        self._inline_docs: dict[str, list[str]] = {}
        from raglite_tpu_torch.utils.microbatch import KeyedMicroBatcher

        self._search_batcher = KeyedMicroBatcher(self._make_search_batch_fn)

    def _make_search_batch_fn(self, key):
        method, num_results, filter_json = key

        def run(queries: list[str]):
            from raglite_tpu_torch.search import (
                hybrid_search_batch,
                keyword_search_batch,
                vector_search_batch,
            )

            batch = {
                "vector": vector_search_batch,
                "keyword": keyword_search_batch,
            }.get(method, hybrid_search_batch)
            return batch(
                queries,
                num_results=num_results,
                metadata_filter=json.loads(filter_json) if filter_json else None,
                config=self.config,
            )

        return run

    def _batched_search(self, query, *, method, num_results, metadata_filter):
        """Route one query through the micro-batcher: concurrent requests
        with the same (method, num_results, filter) signature run as a
        single batched device program (utils/microbatch.py)."""
        key = (
            method,
            num_results,
            json.dumps(metadata_filter, sort_keys=True) if metadata_filter else "",
        )
        return self._search_batcher.submit(key, query)

    # --- Request handlers (exercised directly by tests) -------------------

    def handle_settings_get(self) -> dict[str, Any]:
        return {
            "store_path": self.config.store_path,
            "llm": self.config.llm,
            "embedder": self.config.embedder,
            "vector_search_query_adapter": self.config.vector_search_query_adapter,
        }

    def handle_settings_post(self, body: dict[str, Any]) -> dict[str, Any]:
        """Update runtime settings (the reference's settings widgets,
        _chainlit.py:24-62).

        ``store_path`` is deliberately NOT settable over HTTP: repointing the
        store to an attacker-chosen directory would let a drive-by page read
        or clobber arbitrary on-disk stores. Choose the store at launch.
        """
        allowed = {"llm", "embedder", "vector_search_query_adapter"}
        updates = {k: v for k, v in body.items() if k in allowed}
        if "embedder" in updates and updates["embedder"] != self.config.embedder:
            # A different embedding dimensionality cannot serve the existing
            # store's index — reject instead of 500ing on every later search.
            from raglite_tpu_torch.models.encoder import embedding_dim
            from raglite_tpu_torch.store import store_from_config

            store = store_from_config(self.config)
            if store.chunk_order:
                new_dim = embedding_dim(replace(self.config, **updates))
                old_dim = embedding_dim(self.config)
                if new_dim != old_dim:
                    return {
                        "error": (
                            f"embedder dimensionality {new_dim} does not match the "
                            f"existing store's {old_dim}; re-ingest into a fresh store"
                        )
                    }
        self.config = replace(self.config, **updates)
        return self.handle_settings_get()

    def handle_upload(self, filename: str, data: bytes, session: str = "") -> dict[str, Any]:
        """Small texts are inlined as context; larger ones are inserted into
        the knowledge base (reference: _chainlit.py:70-91)."""
        from raglite_tpu_torch.documents import Document
        from raglite_tpu_torch.insert import insert_documents

        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError:
            text = ""
        if text and len(text) <= INLINE_ATTACHMENT_MAX_CHARS:
            self._inline_docs.setdefault(session, []).append(text)
            while len(self._inline_docs) > 256:  # bound abandoned sessions
                self._inline_docs.pop(next(iter(self._inline_docs)))
            return {"status": "inlined", "filename": filename}
        if text:
            document = Document.from_text(text, filename=filename)
        else:  # binary (e.g. PDF) — parse via the document pipeline
            import os
            import tempfile
            from pathlib import Path

            with tempfile.NamedTemporaryFile(suffix=Path(filename).suffix, delete=False) as fh:
                fh.write(data)
                tmp = fh.name
            try:
                document = Document.from_path(tmp)
                # The document must carry the UPLOADED name, not the temp
                # file's — it feeds chunk metadata filters and front matter.
                document.filename = filename
                document.metadata_["filename"] = filename
            finally:
                os.unlink(tmp)
        insert_documents([document], config=self.config)
        return {"status": "inserted", "filename": filename, "id": document.id}

    def handle_search(self, body: dict[str, Any]) -> dict[str, Any]:
        """Direct retrieval API — the persistent device index-server role that
        maps to the reference's Postgres server mode (SURVEY §2.2).

        body: {"query", "method": vector|keyword|hybrid, "num_results",
               "metadata_filter", "rerank": bool}
        """
        from raglite_tpu_torch.search import (
            hybrid_search,
            keyword_search,
            retrieve_chunks,
            search_and_rerank_chunks,
            vector_search,
        )

        query = str(body.get("query", ""))
        method = body.get("method", "hybrid")
        num_results = int(body.get("num_results", 5))
        metadata_filter = body.get("metadata_filter")
        if body.get("rerank"):
            search = {"vector": vector_search, "keyword": keyword_search}.get(
                method, hybrid_search
            )
            chunks = search_and_rerank_chunks(
                query, num_results=num_results, search=search,
                metadata_filter=metadata_filter, config=self.config,
            )
            ids = [chunk.id for chunk in chunks]
            scores = [None] * len(chunks)
        else:
            # Concurrent single-query requests coalesce into ONE batched
            # device program (vector/keyword/hybrid_search_batch; the int4
            # route takes B <= 32 in one launch), so serving throughput
            # scales with concurrency instead of serializing B=1 dispatches.
            ids, scores = self._batched_search(
                query, method=method, num_results=num_results,
                metadata_filter=metadata_filter,
            )
            chunks = retrieve_chunks(ids, config=self.config)
        # Look chunks up by id rather than positional zip: retrieve_chunks
        # silently drops ids deleted concurrently, which would shift every
        # subsequent body/score under the wrong chunk_id.
        by_id = {chunk.id: chunk for chunk in chunks}
        return {
            "query": query,
            "method": method,
            "results": [
                {
                    "chunk_id": chunk_id,
                    "score": score,
                    "document_id": chunk.document_id if chunk else None,
                    "headings": chunk.headings if chunk else "",
                    "body": (chunk.body if chunk else "")[:2000],
                }
                for chunk_id, score in zip(ids, scores)
                for chunk in (by_id.get(chunk_id),)
            ],
        }

    def handle_delete(self, body: dict[str, Any]) -> dict[str, Any]:
        """Delete documents by id or metadata filter (completes the HTTP
        CRUD surface; reference deletes only through the Python API)."""
        from raglite_tpu_torch.delete import delete_documents, delete_documents_by_metadata

        document_ids = body.get("document_ids") or []
        metadata_filter = body.get("metadata_filter")
        if document_ids:
            delete_documents(list(document_ids), config=self.config)
        elif metadata_filter:
            delete_documents_by_metadata(metadata_filter, config=self.config)
        return {"deleted_ids": document_ids, "metadata_filter": metadata_filter}

    def handle_stats(self) -> dict[str, Any]:
        from raglite_tpu_torch.index.dense import dense_index_from_config
        from raglite_tpu_torch.store import store_from_config
        from raglite_tpu_torch.utils.trace import report

        store = store_from_config(self.config)
        index = dense_index_from_config(self.config)
        return {
            "documents": len(store.documents),
            "chunks": len(store.chunk_order),
            "index_rows": index.num_rows,
            "index_dtype": self.config.embedding_dtype,
            "num_devices": index.num_devices,
            "phases": report(),
        }

    def chat_events(self, messages: list[dict[str, Any]], session: str = ""):
        """Yield SSE event tuples ``(event, json_payload)`` for one turn."""
        from raglite_tpu_torch.rag import rag

        inline = self._inline_docs.pop(session, None)
        if inline and messages:
            attachments = "\n\n".join(f"<attachment>{doc}</attachment>" for doc in inline)
            messages = [
                *messages[:-1],
                {**messages[-1], "content": f"{attachments}\n\n{messages[-1]['content']}"},
            ]
        sources: list[dict[str, str]] = []

        def on_retrieval(spans) -> None:
            seen = set()
            for span in spans:
                key = span.document.id if span.document else id(span)
                if key in seen:  # dedupe per document (reference: _chainlit.py:100-113)
                    continue
                seen.add(key)
                text = span.content
                sources.append(
                    {
                        "document": str(key),
                        "headings": span.chunks[0].headings if span.chunks else "",
                        "preview": text[:240],
                    }
                )

        for token in rag(messages, on_retrieval=on_retrieval, config=self.config):
            yield "token", json.dumps(token)
        if sources:
            yield "sources", json.dumps(sources)
        yield "done", "{}"

    # --- HTTP server -------------------------------------------------------

    def make_server(self, host: str = "127.0.0.1", port: int = 8080) -> ThreadingHTTPServer:
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # quiet
                pass

            def _json(self, payload: dict[str, Any], status: int = 200) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/api/settings":
                    self._json(app.handle_settings_get())
                elif self.path == "/api/stats":
                    self._json(app.handle_stats())
                else:
                    self._json({"error": "not found"}, 404)

            def _body(self) -> bytes:
                length = int(self.headers.get("Content-Length", "0"))
                return self.rfile.read(length)

            def _same_origin(self) -> bool:
                """Reject cross-site POSTs: a drive-by web page sends an
                Origin header naming its own site.  Compare against the
                SERVER'S bound address — matching the client-controlled Host
                header would let DNS rebinding (evil.com -> 127.0.0.1, where
                Origin and Host agree) through."""
                origin = self.headers.get("Origin")
                if origin is None:
                    return True  # non-browser clients send no Origin
                origin_host = origin.split("://", 1)[-1]
                bound_host, bound_port = self.server.server_address[:2]
                allowed = {
                    f"{bound_host}:{bound_port}",
                    f"localhost:{bound_port}",
                    f"127.0.0.1:{bound_port}",
                    f"[::1]:{bound_port}",
                }
                if origin_host in allowed:
                    return True
                # Wildcard binding (serve --host 0.0.0.0/::): browsers reach
                # us via a LAN IP/hostname that is not a loopback alias, so
                # additionally accept an Origin naming one of THIS MACHINE'S
                # interface addresses/hostnames (on the bound port).  This
                # stays rebinding-safe: after a DNS rebind the attacker
                # page's Origin still spells the attacker's DOMAIN, which
                # never string-equals a literal interface IP or our
                # hostname.  (Matching the client-controlled Host header
                # instead would let rebinding through — Origin and Host
                # agree after a rebind.)  Loopback binds keep the strict
                # allow-list above.
                if bound_host in ("0.0.0.0", "::"):  # noqa: S104
                    o_host, _, o_port = origin_host.rpartition(":")
                    if not o_host or not o_port.isdigit():
                        o_host, o_port = origin_host, ""
                    default = "443" if origin.startswith("https") else "80"
                    port_ok = (o_port or default) == str(bound_port)
                    return port_ok and o_host.strip("[]") in _local_addresses()
                return False

            def do_POST(self) -> None:  # noqa: N802
                if not self._same_origin():
                    self._json({"error": "cross-origin request rejected"}, 403)
                    return
                if self.path in ("/api/settings", "/api/search", "/api/delete", "/api/chat"):
                    ctype = self.headers.get("Content-Type", "")
                    has_body = int(self.headers.get("Content-Length", "0")) > 0
                    if has_body and "application/json" not in ctype:
                        self._json({"error": "Content-Type must be application/json"}, 415)
                        return
                if self.path == "/api/settings":
                    self._json(app.handle_settings_post(json.loads(self._body() or b"{}")))
                elif self.path == "/api/search":
                    self._json(app.handle_search(json.loads(self._body() or b"{}")))
                elif self.path == "/api/delete":
                    self._json(app.handle_delete(json.loads(self._body() or b"{}")))
                elif self.path == "/api/upload":
                    filename = self.headers.get("X-Filename", "upload.txt")
                    session = self.headers.get("X-Session", "")
                    self._json(app.handle_upload(filename, self._body(), session))
                elif self.path == "/api/chat":
                    payload = json.loads(self._body() or b"{}")
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    try:
                        for event, data in app.chat_events(
                            payload.get("messages", []), payload.get("session", "")
                        ):
                            self.wfile.write(
                                f"event: {event}\ndata: {data}\n\n".encode()
                            )
                            self.wfile.flush()
                    except BrokenPipeError:
                        pass
                else:
                    self._json({"error": "not found"}, 404)

        return _Server((host, port), Handler)

    def serve(self, host: str = "127.0.0.1", port: int = 8080) -> None:
        server = self.make_server(host, port)
        print(f"RAGLite-TPU web chat on http://{host}:{server.server_address[1]}")  # noqa: T201
        server.serve_forever()

    def serve_background(self, host: str = "127.0.0.1", port: int = 0) -> tuple[ThreadingHTTPServer, int]:
        """Start on a background thread (tests); returns (server, port)."""
        server = self.make_server(host, port)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, server.server_address[1]


def create_web_app(config: RAGLiteConfig | None = None) -> WebChatApp:
    return WebChatApp(config)
