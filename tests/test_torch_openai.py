"""The port's OpenAI-compatible LLM and embedder (``openai:``) and
``async_rag`` against stdlib stub servers on 127.0.0.1, on the CPU: ports of
tests/test_openai_provider.py and tests/test_openai_embedder.py, the
early-exit test of tests/test_rag.py, and the JAX package side by side on
the same stubs.

Tolerances: requests and answers equal; the remote embeddings' f16 rows
equal the JAX package's within one f16 ulp (both normalise f32 rows, in
other summation orders) and are unit rows within rtol 1e-2 (f16).
"""

import asyncio
import hashlib
import importlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import raglite_tpu.models.encoder as jenc
import raglite_tpu.models.llm as jllm
import raglite_tpu_torch.models.llm as tllm
from raglite_tpu_torch import Document, RAGLiteConfig, async_rag, insert_documents, rag, vector_search
from raglite_tpu_torch.embed import embedding_type
from raglite_tpu_torch.models.encoder import OpenAICompatEncoder
from raglite_tpu_torch.models.llm import OpenAICompatLLM, ToolCall

# The module, not the package's ``rag`` function of the same name.
trag = importlib.import_module("raglite_tpu_torch.rag")


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def embed_server():
    received: list[dict] = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:
            pass

        def do_POST(self) -> None:  # noqa: N802
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length))
            received.append({"path": self.path, "n": len(payload["input"])})
            data = []
            for i, text in enumerate(payload["input"]):
                # A deterministic pseudo-embedding per text.
                seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "big")
                vec = np.random.default_rng(seed).normal(size=32)
                data.append({"index": i, "embedding": vec.tolist()})
            body = json.dumps({"data": data}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = _serve(Handler)
    yield server.server_address[1], received
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def stub_server():
    """An OpenAI-compatible /chat/completions stub recording requests.

    A prompt containing "slowstream" makes the SSE handler block after the
    first delta until the test sets ``release``; a request offering tools
    whose messages mention "weather" (or hold no tool result yet for a
    "search" question) gets a tool call, split across SSE fragments."""
    received: list[dict] = []
    release = threading.Event()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:
            pass

        def _sse(self, deltas: list[dict], gate_after_first: bool = False) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            for i, delta in enumerate(deltas):
                chunk = {"choices": [{"index": 0, "delta": delta}]}
                self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                self.wfile.flush()
                if gate_after_first and i == 0:
                    release.wait(10.0)
                else:
                    time.sleep(0.02)
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
            received.append({"event": "stream_done"})

        def do_POST(self) -> None:  # noqa: N802
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length))
            received.append({"path": self.path, "payload": payload})
            text = json.dumps(payload["messages"])
            tools = payload.get("tools") or []
            if tools and tools[0]["function"]["name"] == "search_knowledge_base":
                query = payload["messages"][-1]["content"]
                call = {"name": "search_knowledge_base", "arguments": json.dumps({"query": query})}
            elif tools and "weather" in text:
                call = {"name": "get_weather", "arguments": json.dumps({"city": "Paris"})}
            else:
                call = None
            if payload.get("stream"):
                if call is not None:
                    args = call["arguments"]
                    self._sse([
                        {"tool_calls": [{"index": 0, "id": "call_1", "function": {"name": call["name"], "arguments": ""}}]},
                        {"tool_calls": [{"index": 0, "function": {"arguments": args[: len(args) // 2]}}]},
                        {"tool_calls": [{"index": 0, "function": {"arguments": args[len(args) // 2 :]}}]},
                    ])
                else:
                    self._sse([{"content": "stub "}, {"content": "streamed "}, {"content": "answer"}],
                              gate_after_first="slowstream" in text)
                return
            if call is not None:
                message = {"role": "assistant", "content": None, "tool_calls": [
                    {"id": "call_1", "type": "function", "function": call}]}
            else:
                message = {"role": "assistant", "content": "stub answer"}
            body = json.dumps({"choices": [{"index": 0, "message": message, "finish_reason": "stop"}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = _serve(Handler)
    yield server.server_address[1], received, release
    server.shutdown()
    server.server_close()


WEATHER_TOOLS = [{"type": "function", "function": {"name": "get_weather", "parameters": {"type": "object"}}}]


def _last_payload(received):
    return next(r for r in reversed(received) if "payload" in r)["payload"]


# --- The embedder ------------------------------------------------------------------


def test_remote_embedder_batches_and_normalizes(embed_server) -> None:
    port, received = embed_server
    enc = OpenAICompatEncoder(f"http://127.0.0.1:{port}/v1#embed-model", device="cpu")
    assert enc.dim == 32  # the probe request
    texts = [f"text number {i}" for i in range(100)]
    out = enc.embed(texts)
    assert out.shape == (100, 32) and out.dtype == np.float16
    np.testing.assert_allclose(np.linalg.norm(out.astype(np.float32), axis=1), 1.0, rtol=1e-2)
    # 100 inputs: one batch of 96, one of 4.
    assert [r["n"] for r in received if r["path"] == "/v1/embeddings"][-2:] == [96, 4]
    np.testing.assert_array_equal(enc.embed(["text number 7"])[0], out[7])
    # The JAX package's rows, within one f16 ulp.
    want = jenc.OpenAICompatEncoder(f"http://127.0.0.1:{port}/v1#embed-model").embed(texts)
    np.testing.assert_allclose(out.astype(np.float32), want.astype(np.float32), atol=2**-11, rtol=0)


def test_remote_embedder_through_insert_search(embed_server, tmp_path) -> None:
    """The whole pipeline over the remote embedder: standard (single-vector
    per sentence) embedding, insert, search."""
    port, _ = embed_server
    config = RAGLiteConfig(
        store_path=str(tmp_path / "s"), llm="echo", device="cpu",
        embedder=f"openai:http://127.0.0.1:{port}/v1#embed-model",
    )
    assert embedding_type(config=config) == "standard"
    doc = Document.from_text("# Remote\n\n" + "The comet passed close to the outer planets. " * 60, filename="comet.md")
    insert_documents([doc], config=config)
    ids, scores = vector_search("comet outer planets", num_results=2, config=config)
    assert ids and scores


# --- The LLM -----------------------------------------------------------------------


def test_openai_provider_complete_and_path(stub_server) -> None:
    port, received, _ = stub_server
    llm = OpenAICompatLLM(f"http://127.0.0.1:{port}/v1#mymodel")
    response = llm.complete([{"role": "user", "content": "hello"}], temperature=0.5)
    assert response.content == "stub answer"
    assert received[-1]["path"] == "/v1/chat/completions"
    assert received[-1]["payload"]["model"] == "mymodel"
    assert received[-1]["payload"]["temperature"] == 0.5


def test_openai_provider_tool_calls(stub_server) -> None:
    port, received, _ = stub_server
    llm = OpenAICompatLLM(f"http://127.0.0.1:{port}/v1#mymodel")
    response = llm.complete([{"role": "user", "content": "weather in paris?"}], tools=WEATHER_TOOLS)
    assert response.content is None and len(response.tool_calls) == 1
    call = response.tool_calls[0]
    assert isinstance(call, ToolCall) and call.name == "get_weather"
    assert json.loads(call.arguments) == {"city": "Paris"}
    assert received[-1]["payload"]["tool_choice"] == "auto"
    # The stream reassembles tool-call fragments across SSE chunks.
    items = list(llm.stream([{"role": "user", "content": "weather in paris?"}], tools=WEATHER_TOOLS))
    calls = [i for i in items if isinstance(i, ToolCall)]
    assert len(calls) == 1 and calls[0].name == "get_weather"
    assert json.loads(calls[0].arguments) == {"city": "Paris"}


def test_openai_provider_streams_incrementally(stub_server) -> None:
    """The first delta arrives before the server has finished (the stub
    holds the rest until released)."""
    port, received, release = stub_server
    release.clear()
    llm = OpenAICompatLLM(f"http://127.0.0.1:{port}/v1#mymodel")
    gen = llm.stream([{"role": "user", "content": "slowstream hello"}])
    first = next(gen)
    assert first == "stub "
    assert not any(r.get("event") == "stream_done" for r in received[-1:])
    release.set()
    rest = list(gen)
    assert "".join([first, *rest]) == "stub streamed answer" and len(rest) >= 2
    assert _last_payload(received)["stream"] is True


def test_openai_provider_via_config(stub_server) -> None:
    port, _, _ = stub_server
    config = RAGLiteConfig(store_path=":memory:", embedder="hash:128", llm=f"openai:http://127.0.0.1:{port}/v1#mymodel")
    llm = tllm.llm_from_config(config)  # the config's device is never asked for
    assert isinstance(llm, OpenAICompatLLM)
    assert llm.complete([{"role": "user", "content": "hi"}]).content == "stub answer"


@pytest.mark.parametrize("tools", [None, WEATHER_TOOLS])
def test_requests_and_answers_equal_jax(stub_server, tools) -> None:
    """Both packages send the same request bodies and read the same
    answers, sync, streamed and async."""
    port, received, release = stub_server
    release.set()
    spec = f"http://127.0.0.1:{port}/v1#mymodel"
    messages = [{"role": "user", "content": "weather in paris?"}]

    def run(llm):
        out = [llm.complete(messages, tools=tools, temperature=0.2)]
        body = [_last_payload(received)]
        out.append(list(llm.stream(messages, tools=tools)))
        body.append(_last_payload(received))

        async def collect():
            return [item async for item in llm.astream(messages, tools=tools)]

        out.append(asyncio.run(collect()))
        body.append(_last_payload(received))
        return out, body

    got, got_body = run(OpenAICompatLLM(spec))
    want, want_body = run(jllm.OpenAICompatLLM(spec))
    assert got_body == want_body
    norm = lambda x: (x.id, x.name, x.arguments) if hasattr(x, "arguments") else x  # noqa: E731
    assert (got[0].content, [norm(c) for c in got[0].tool_calls]) == (want[0].content, [norm(c) for c in want[0].tool_calls])
    assert [norm(x) for x in got[1]] == [norm(x) for x in want[1]]
    assert [norm(x) for x in got[2]] == [norm(x) for x in want[2]]


def test_openai_provider_astream_native(stub_server) -> None:
    port, _, release = stub_server
    release.set()
    llm = OpenAICompatLLM(f"http://127.0.0.1:{port}/v1#mymodel")

    async def collect():
        return [item async for item in llm.astream([{"role": "user", "content": "hello"}])]

    items = asyncio.run(collect())
    assert "".join(i for i in items if isinstance(i, str)) == "stub streamed answer"
    assert len([i for i in items if isinstance(i, str)]) >= 3


def test_openai_provider_astream_tool_calls(stub_server) -> None:
    port, _, _ = stub_server
    llm = OpenAICompatLLM(f"http://127.0.0.1:{port}/v1#mymodel")

    async def collect():
        return [item async for item in llm.astream([{"role": "user", "content": "weather in paris?"}], tools=WEATHER_TOOLS)]

    calls = [i for i in asyncio.run(collect()) if isinstance(i, ToolCall)]
    assert len(calls) == 1 and calls[0].name == "get_weather"
    assert json.loads(calls[0].arguments) == {"city": "Paris"}


# --- async_rag -----------------------------------------------------------------------


def _boom(*args, **kwargs):
    msg = "the thread bridge must not be used for the openai provider"
    raise AssertionError(msg)


def test_async_rag_openai_runs_without_thread_bridge(stub_server, monkeypatch: pytest.MonkeyPatch) -> None:
    port, _, release = stub_server
    release.set()
    monkeypatch.setattr(trag, "_async_rag_bridge", _boom)
    config = RAGLiteConfig(store_path=":memory:", embedder="hash:128", device="cpu",
                           llm=f"openai:http://127.0.0.1:{port}/v1#mymodel")
    messages = [{"role": "user", "content": "hello there <context>given</context>"}]

    async def collect():
        return [t async for t in async_rag(messages, config=config)]

    assert "".join(asyncio.run(collect())) == "stub streamed answer"
    assert messages[-1] == {"role": "assistant", "content": "stub streamed answer"}


def test_async_rag_openai_tool_round(stub_server, monkeypatch: pytest.MonkeyPatch, tmp_path) -> None:
    """The native path with a tool round: the server asks for a search, the
    search runs (in the executor) over the store, and its documents go back
    in a tool message before the answer streams."""
    port, received, release = stub_server
    release.set()
    monkeypatch.setattr(trag, "_async_rag_bridge", _boom)
    config = RAGLiteConfig(store_path=str(tmp_path / "kb"), embedder="hash:128", device="cpu",
                           llm=f"openai:http://127.0.0.1:{port}/v1#mymodel")
    insert_documents([Document.from_text("# Physics\n\n" + "Photons carry momentum and energy. " * 10)], config=config)
    messages = [{"role": "user", "content": "What do photons carry?"}]
    retrieved = []

    async def collect():
        return [t async for t in async_rag(messages, on_retrieval=retrieved.extend, config=config)]

    assert "".join(asyncio.run(collect())) == "stub streamed answer"
    assert [m["role"] for m in messages] == ["user", "assistant", "tool", "assistant"]
    assert messages[1]["tool_calls"][0]["function"]["name"] == "search_knowledge_base"
    assert retrieved and "Photons" in messages[2]["content"]
    assert _last_payload(received)["messages"][-1]["role"] == "tool"


@pytest.fixture()
def kb_config(tmp_path):
    config = RAGLiteConfig(store_path=str(tmp_path / "kb"), embedder="hash:256", llm="echo", device="cpu")
    insert_documents([Document.from_text("# Physics\n\n" + "Photons carry momentum and energy. " * 10)], config=config)
    return config


def test_async_rag_bridge_equals_rag(kb_config) -> None:
    """The bridge streams rag()'s tokens and leaves the same messages."""
    sync_messages = [{"role": "user", "content": "Tell me about photons"}]
    want = list(rag(sync_messages, config=kb_config))
    messages = [{"role": "user", "content": "Tell me about photons"}]

    async def collect():
        return [t async for t in async_rag(messages, config=kb_config)]

    assert asyncio.run(collect()) == want
    assert [m["role"] for m in messages] == [m["role"] for m in sync_messages] == ["user", "assistant", "tool", "assistant"]
    assert messages[-1] == sync_messages[-1]


def test_async_rag_early_exit_stops_worker(kb_config) -> None:
    """The port of tests/test_rag.py::test_async_rag_early_exit_stops_worker."""

    async def run() -> int:
        messages = [{"role": "user", "content": "Tell me about photons"}]
        count = 0
        agen = async_rag(messages, config=kb_config)
        async for _token in agen:
            count += 1
            if count >= 2:
                break
        await agen.aclose()
        await asyncio.sleep(0.2)
        return count

    assert asyncio.run(run()) == 2


def test_async_rag_close_waits_for_the_worker(kb_config, monkeypatch: pytest.MonkeyPatch) -> None:
    """After an early exit the worker asks the LLM for no further token, and
    once ``aclose()`` returns it has left rag(): no token is produced and no
    message is written afterwards."""
    produced = []

    class Slow:
        context_size = 8192
        supports_function_calling = True
        supports_response_format = True

        def stream(self, messages, **kwargs):
            for i in range(100):
                time.sleep(0.01)
                produced.append(i)
                yield f"t{i} "

    monkeypatch.setattr(trag, "llm_from_config", lambda config: Slow())
    messages = [{"role": "user", "content": "<context>photons</context> Tell me about photons"}]

    async def run():
        agen = async_rag(messages, config=kb_config)
        got = []
        async for token in agen:
            got.append(token)
            if len(got) == 3:
                break
        await agen.aclose()
        n = len(produced)
        await asyncio.sleep(0.2)
        return got, n, len(produced)

    got, at_close, later = asyncio.run(run())
    assert got == ["t0 ", "t1 ", "t2 "]
    assert at_close == later <= 5, (at_close, later)
    assert messages == [{"role": "user", "content": "<context>photons</context> Tell me about photons"}]
