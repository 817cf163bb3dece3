"""Chat LLM abstraction (counterpart of raglite_tpu/models/llm.py).

A small first-party protocol with the JAX package's provider strings, so a
config carries across unchanged:

- ``echo``: a deterministic, fully offline LLM for tests and demos.  It
  follows the tool-calling protocol (issues ``search_knowledge_base`` calls,
  then answers from retrieved context) and satisfies JSON response formats
  with schema-conforming output.
- ``jax:<preset>``: the port's own decoder (models/decoder.py:TorchChatLLM)
  on ``config.device``, one instance per (spec, device), with JSON response
  formats, forced tool calls and ``complete_batch``.  The name stays
  ``jax:`` because the configs name the model, not the framework.
- ``openai:<base_url>#<model>``: any OpenAI-compatible HTTP endpoint over
  the standard library (urllib for ``complete`` and ``stream``, an asyncio
  socket for ``astream``); no device is involved.

Not ported yet (ROADMAP queue 1 item 9): ``hf:``/``ckpt:`` checkpoints and
``@int8`` weights.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from functools import lru_cache
from typing import TYPE_CHECKING, Any, Iterator, Protocol

if TYPE_CHECKING:
    from raglite_tpu_torch.config import RAGLiteConfig

__all__ = [
    "LLM",
    "ToolCall",
    "ChatResponse",
    "EchoLLM",
    "OpenAICompatLLM",
    "llm_from_config",
    "get_context_size",
    "supports_function_calling",
    "supports_response_format",
]


@dataclass
class ToolCall:
    id: str
    name: str
    arguments: str  # JSON string

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }


@dataclass
class ChatResponse:
    content: str | None
    tool_calls: list[ToolCall] = field(default_factory=list)

    def message_dict(self) -> dict[str, Any]:
        message: dict[str, Any] = {"role": "assistant", "content": self.content or ""}
        if self.tool_calls:
            message["tool_calls"] = [tc.to_dict() for tc in self.tool_calls]
        return message


class LLM(Protocol):
    context_size: int
    supports_function_calling: bool
    supports_response_format: bool

    def complete(
        self,
        messages: list[dict[str, Any]],
        *,
        tools: list[dict[str, Any]] | None = None,
        tool_choice: Any = None,
        response_format: dict[str, Any] | None = None,
        **sampling: Any,
    ) -> ChatResponse: ...

    def stream(
        self,
        messages: list[dict[str, Any]],
        *,
        tools: list[dict[str, Any]] | None = None,
        tool_choice: Any = None,
        **sampling: Any,
    ) -> Iterator[str | ToolCall]:
        """Yield content tokens (str) and tool calls (ToolCall)."""
        ...


class EchoLLM:
    """Deterministic LLM for hermetic tests.

    - With a ``search_knowledge_base`` tool and no ``<context>`` in the last
      message: emits one tool call whose query is the user's question.
    - With retrieved ``<context>``/tool context present: answers with a
      deterministic summary quoting the context.
    - With a JSON response format: emits an instance built from the schema.
    """

    context_size = 8192
    supports_function_calling = True
    supports_response_format = True

    def _answer_from_context(self, messages: list[dict[str, Any]]) -> str:
        context_bits: list[str] = []
        for message in messages:
            content = str(message.get("content", ""))
            if message.get("role") == "tool" or "<context>" in content or "<document" in content:
                text = re.sub(r"<[^>]+>", " ", content)
                text = re.sub(r"\s+", " ", text).strip()
                if text:
                    context_bits.append(text[:300])
        user = next(
            (str(m.get("content", "")) for m in reversed(messages) if m.get("role") == "user"),
            "",
        )
        question = user.split("\n")[-1][:200]
        if context_bits:
            return f"Based on the retrieved context: {context_bits[0]}"
        return f"Echo: {question}"

    @staticmethod
    def _significant_words(text: str) -> set[str]:
        return {w.lower() for w in re.findall(r"\w{4,}", text)}

    def _json_for_schema(
        self, schema: dict[str, Any], user_prompt: str, name: str = "", system_prompt: str = ""
    ) -> Any:
        t = schema.get("type")
        if "enum" in schema:
            return schema["enum"][0]
        if t == "object" or "properties" in schema:
            return {
                key: self._json_for_schema(sub, user_prompt, key, system_prompt)
                for key, sub in schema.get("properties", {}).items()
            }
        if t == "array":
            return []
        if t == "integer":
            return 0
        if t == "number":
            return 0.0
        if t == "boolean":
            # Relevance judgments decide by lexical overlap between the quoted
            # question in the system prompt and the provided context.
            quoted = re.findall(r'"([^"]{8,})"', system_prompt)
            if quoted:
                question_words = self._significant_words(quoted[0])
                overlap = question_words & self._significant_words(user_prompt)
                return len(overlap) >= min(2, max(len(question_words), 1))
            return True
        if isinstance(t, list):  # e.g. ["integer", "null"]
            return (
                None
                if "null" in t
                else self._json_for_schema({"type": t[0]}, user_prompt, name, system_prompt)
            )
        if "anyOf" in schema:
            options = schema["anyOf"]
            null = next((o for o in options if o.get("type") == "null"), None)
            return (
                None
                if null is not None
                else self._json_for_schema(options[0], user_prompt, name, system_prompt)
            )
        # String fields: honor common semantic field names.
        hint = f"{name} {schema.get('description', '')}".lower()
        snippet = re.sub(r"\W+", " ", user_prompt).strip()
        forbidden = {"context", "document", "question", "index", "filename", "none"}
        words = [
            w for w in snippet.split() if len(w) > 3 and w.lower() not in forbidden and not w.isdigit()
        ][:6]
        topic = " ".join(words[:4]) or "the given subject"
        if "question" in hint:
            return f"What does the passage say about {topic}?"
        if "answer" in hint:
            return f"The passage explains {topic} in detail."
        return user_prompt.strip().split("\n")[0][:80] or "echo"

    def complete(
        self,
        messages: list[dict[str, Any]],
        *,
        tools: list[dict[str, Any]] | None = None,
        tool_choice: Any = None,
        response_format: dict[str, Any] | None = None,
        **sampling: Any,
    ) -> ChatResponse:
        last = str(messages[-1].get("content", "")) if messages else ""
        have_context = any(
            s in str(m.get("content", "")) for m in messages for s in ("<context>", "<document", "from_chunk_id")
        ) or any(m.get("role") == "tool" for m in messages)
        if response_format is not None:
            schema = response_format.get("json_schema", {}).get("schema") or {"type": "object"}
            user = next(
                (str(m.get("content", "")) for m in reversed(messages) if m.get("role") == "user"), ""
            )
            system = next(
                (str(m.get("content", "")) for m in messages if m.get("role") == "system"), ""
            )
            return ChatResponse(
                content=json.dumps(self._json_for_schema(schema, user, system_prompt=system))
            )
        if tools and not have_context and tool_choice != "none":
            query = last.strip().split("\n")[-1][:200]
            call = ToolCall(
                id=f"call_{uuid.uuid4().hex[:8]}",
                name="search_knowledge_base",
                arguments=json.dumps({"query": query}),
            )
            return ChatResponse(content=None, tool_calls=[call])
        return ChatResponse(content=self._answer_from_context(messages))

    def stream(
        self,
        messages: list[dict[str, Any]],
        *,
        tools: list[dict[str, Any]] | None = None,
        tool_choice: Any = None,
        **sampling: Any,
    ) -> Iterator[str | ToolCall]:
        response = self.complete(messages, tools=tools, tool_choice=tool_choice, **sampling)
        if response.content:
            yield from re.findall(r"\S+\s*", response.content)
        yield from response.tool_calls


# --- OpenAI-compatible HTTP adapter ------------------------------------------


class _SSEAssembler:
    """Incremental OpenAI-chat SSE decoder shared by the sync and async
    streams: each fed line yields zero or more content deltas; tool-call
    fragments (id/name on the first fragment, arguments accumulating across
    fragments, keyed by index) are assembled until the stream ends."""

    def __init__(self) -> None:
        self._partial: dict[int, dict[str, str]] = {}

    def feed_line(self, line: str) -> tuple[bool, list[str]]:
        """Returns (stream_done, content_deltas) for one SSE line."""
        line = line.strip()
        if not line.startswith("data:"):
            return False, []
        data = line[5:].strip()
        if data == "[DONE]":
            return True, []
        try:
            chunk = json.loads(data)
        except json.JSONDecodeError:
            return False, []
        choices = chunk.get("choices") or []
        if not choices:
            return False, []
        delta = choices[0].get("delta") or {}
        deltas = [delta["content"]] if delta.get("content") else []
        for frag in delta.get("tool_calls") or []:
            slot = self._partial.setdefault(
                int(frag.get("index", 0)), {"id": "", "name": "", "arguments": ""}
            )
            if frag.get("id"):
                slot["id"] = frag["id"]
            fn = frag.get("function") or {}
            if fn.get("name"):
                slot["name"] += fn["name"]
            if fn.get("arguments"):
                slot["arguments"] += fn["arguments"]
        return False, deltas

    def tool_calls(self) -> list[ToolCall]:
        return [
            ToolCall(
                slot["id"] or f"call_{uuid.uuid4().hex[:8]}",
                slot["name"],
                slot["arguments"],
            )
            for _, slot in sorted(self._partial.items())
        ]


async def _async_sse_post(url: str, body: bytes, *, timeout: float = 300.0):
    """POST ``body`` to ``url`` and yield SSE chat deltas, asyncio-native.

    A minimal HTTP/1.1 client over ``asyncio.open_connection`` (standard
    library only): https through the default SSL context, chunked
    transfer-encoding and Content-Length bodies.  This is what lets
    ``async_rag`` hold a socket reader per live stream instead of an
    executor thread."""
    import asyncio
    import ssl
    import urllib.parse

    u = urllib.parse.urlsplit(url)
    https = u.scheme == "https"
    port = u.port or (443 if https else 80)
    ctx = ssl.create_default_context() if https else None
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(u.hostname, port, ssl=ctx), timeout
    )
    try:
        path = u.path + (f"?{u.query}" if u.query else "")
        head = (
            f"POST {path or '/'} HTTP/1.1\r\n"
            f"Host: {u.hostname}\r\n"
            "Content-Type: application/json\r\n"
            "Accept: text/event-stream\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode()
        writer.write(head + body)
        await writer.drain()
        status = await asyncio.wait_for(reader.readline(), timeout)
        parts = status.split()
        code = int(parts[1]) if len(parts) > 1 else 0
        headers: dict[str, str] = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout)
            if line in (b"\r\n", b"\n", b""):
                break
            key, _, value = line.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        if code != 200:
            payload = await asyncio.wait_for(reader.read(2048), timeout)
            msg = f"SSE POST {url} failed: HTTP {code} {payload[:200]!r}"
            raise RuntimeError(msg)
        chunked = headers.get("transfer-encoding", "").lower() == "chunked"
        length = int(headers.get("content-length", -1))

        async def iter_body():
            if chunked:
                while True:
                    size_line = await asyncio.wait_for(reader.readline(), timeout)
                    try:
                        size = int(size_line.strip().split(b";")[0], 16)
                    except ValueError:
                        return
                    if size == 0:
                        await reader.readline()  # trailing CRLF after last chunk
                        return
                    yield await reader.readexactly(size)
                    await reader.readexactly(2)  # chunk-terminating CRLF
            else:
                remaining = length
                while remaining != 0:
                    data = await asyncio.wait_for(
                        reader.read(
                            65536 if remaining < 0 else min(65536, remaining)
                        ),
                        timeout,
                    )
                    if not data:
                        return
                    if remaining > 0:
                        remaining -= len(data)
                    yield data

        sse = _SSEAssembler()
        buf = b""
        done = False
        async for data in iter_body():
            buf += data
            while not done and b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                done, deltas = sse.feed_line(line.decode("utf-8", errors="replace"))
                for delta in deltas:
                    yield delta
            if done:
                break
        for tool_call in sse.tool_calls():
            yield tool_call
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:  # noqa: BLE001 - close errors don't outrank stream results
            pass


class OpenAICompatLLM:
    """Minimal OpenAI-compatible chat adapter over stdlib urllib.

    Spec: ``openai:<base_url>#<model>`` (e.g. ``openai:http://host:8000/v1#llama``).
    """

    supports_function_calling = True
    supports_response_format = True

    def __init__(self, spec: str, *, context_size: int = 32768) -> None:
        base, _, model = spec.partition("#")
        self.base_url = base.rstrip("/")
        self.model = model or "default"
        self.context_size = context_size

    def _post(self, payload: dict[str, Any]) -> dict[str, Any]:
        import urllib.request

        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as resp:  # noqa: S310
            return json.loads(resp.read())

    def complete(self, messages, *, tools=None, tool_choice=None, response_format=None, **sampling):
        payload: dict[str, Any] = {"model": self.model, "messages": messages, **sampling}
        if tools:
            payload["tools"] = tools
            payload["tool_choice"] = tool_choice or "auto"
        if response_format:
            payload["response_format"] = response_format
        data = self._post(payload)
        message = data["choices"][0]["message"]
        tool_calls = [
            ToolCall(tc["id"], tc["function"]["name"], tc["function"]["arguments"])
            for tc in message.get("tool_calls") or []
        ]
        return ChatResponse(content=message.get("content"), tool_calls=tool_calls)

    def _stream_payload(self, messages, tools, tool_choice, sampling) -> dict[str, Any]:
        payload: dict[str, Any] = {
            "model": self.model, "messages": messages, "stream": True, **sampling,
        }
        if tools:
            payload["tools"] = tools
            payload["tool_choice"] = tool_choice or "auto"
        return payload

    def stream(self, messages, *, tools=None, tool_choice=None, **sampling):
        """Incremental streaming: POST with ``stream: true``, parse the SSE
        ``data:`` lines as they arrive, yield content deltas at once and
        assemble tool-call fragments across chunks."""
        import urllib.request

        payload = self._stream_payload(messages, tools, tool_choice, sampling)
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", "Accept": "text/event-stream"},
        )
        sse = _SSEAssembler()
        with urllib.request.urlopen(req, timeout=300) as resp:  # noqa: S310
            for raw in resp:
                done, deltas = sse.feed_line(raw.decode("utf-8", errors="replace"))
                yield from deltas
                if done:
                    break
        yield from sse.tool_calls()

    async def astream(self, messages, *, tools=None, tool_choice=None, **sampling):
        """Asyncio-native streaming: the SSE chat request rides an
        ``asyncio.open_connection`` stream, so a long answer costs the event
        loop one socket reader, not an executor thread."""
        body = json.dumps(
            self._stream_payload(messages, tools, tool_choice, sampling)
        ).encode()
        async for item in _async_sse_post(
            f"{self.base_url}/chat/completions", body
        ):
            yield item


@lru_cache(maxsize=4)
def _make_llm(llm: str, device: str) -> LLM:
    kind, _, arg = llm.partition(":")
    if kind == "echo":
        return EchoLLM()
    if kind == "jax":
        from raglite_tpu_torch.models.decoder import TorchChatLLM

        return TorchChatLLM(arg or "tiny", device=device)
    if kind == "openai":
        return OpenAICompatLLM(arg)
    msg = f"unknown llm {llm!r} (expected 'echo', 'jax:<preset>', or 'openai:<url>#<model>')"
    raise ValueError(msg)


def llm_from_config(config: "RAGLiteConfig") -> LLM:
    """The configured LLM, one instance per (spec, device); ``echo`` and
    ``openai:`` run on no device."""
    device = "cpu" if config.llm.partition(":")[0] in ("echo", "openai") else str(config.torch_device())
    return _make_llm(config.llm, device)


def get_context_size(config: "RAGLiteConfig") -> int:
    """Context window of the configured LLM."""
    return llm_from_config(config).context_size


def supports_function_calling(config: "RAGLiteConfig") -> bool:
    return llm_from_config(config).supports_function_calling


def supports_response_format(config: "RAGLiteConfig") -> bool:
    return llm_from_config(config).supports_response_format
