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

Not ported yet (ROADMAP queue 1 items 7 and 9): ``openai:`` endpoints,
``hf:``/``ckpt:`` checkpoints and ``@int8`` weights.
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


@lru_cache(maxsize=4)
def _make_llm(llm: str, device: str) -> LLM:
    kind, _, arg = llm.partition(":")
    if kind == "echo":
        return EchoLLM()
    if kind == "jax":
        from raglite_tpu_torch.models.decoder import TorchChatLLM

        return TorchChatLLM(arg or "tiny", device=device)
    if kind == "openai":
        msg = "openai: endpoints are not ported: ROADMAP queue 1 item 7"
        raise NotImplementedError(msg)
    msg = f"unknown llm {llm!r} (expected 'echo' or 'jax:<preset>')"
    raise ValueError(msg)


def llm_from_config(config: "RAGLiteConfig") -> LLM:
    """The configured LLM, one instance per (spec, device)."""
    device = "cpu" if config.llm.partition(":")[0] == "echo" else str(config.torch_device())
    return _make_llm(config.llm, device)


def get_context_size(config: "RAGLiteConfig") -> int:
    """Context window of the configured LLM."""
    return llm_from_config(config).context_size


def supports_function_calling(config: "RAGLiteConfig") -> bool:
    return llm_from_config(config).supports_function_calling


def supports_response_format(config: "RAGLiteConfig") -> bool:
    return llm_from_config(config).supports_response_format
