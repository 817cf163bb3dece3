"""Retrieval-augmented generation with adaptive tool-based retrieval
(counterpart of raglite_tpu/rag.py).

The tool-injection protocol, proportional context budgeting and message
clipping are the JAX package's; the LLM is the port's (models/llm.py).
``async_rag`` streams the same answer on an event loop: natively over a
provider's asyncio stream (``openai:``), else from ``rag()`` on a worker
thread (the ``jax:`` decoder and ``echo`` block on their steps).
"""

from __future__ import annotations

import contextlib
import json
import logging
from collections.abc import AsyncIterator, Callable, Iterator, Mapping, Sequence
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any

import numpy as np

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.documents import Chunk, ChunkSpan
from raglite_tpu_torch.models.llm import ChatResponse, ToolCall, get_context_size, llm_from_config
from raglite_tpu_torch.search import retrieve_chunk_spans
from raglite_tpu_torch.types import MetadataFilter

logger = logging.getLogger(__name__)

__all__ = ["retrieve_context", "add_context", "rag", "async_rag", "RAG_INSTRUCTION_TEMPLATE"]

# Anthropic long-context format.
RAG_INSTRUCTION_TEMPLATE = """
---
The following context is intended to support answering the question below.
Use this information as the primary source when forming your response.
Provide a direct answer to the question without referencing how the information was supplied.
---

<context>
{context}
</context>

{user_prompt}
""".strip()


def retrieve_context(
    query: str,
    *,
    num_chunks: int = 10,
    metadata_filter: MetadataFilter | None = None,
    config: RAGLiteConfig | None = None,
) -> list[ChunkSpan]:
    """Run the configured search method and normalize to chunk spans."""
    config = config or RAGLiteConfig()
    results = config.search_method(
        query, num_results=num_chunks, metadata_filter=metadata_filter, config=config
    )
    if isinstance(results, tuple):
        return retrieve_chunk_spans(results[0], config=config)
    if all(isinstance(r, Chunk) for r in results):
        return retrieve_chunk_spans(results, config=config)  # type: ignore[arg-type]
    if all(isinstance(r, ChunkSpan) for r in results):
        return list(results)  # type: ignore[arg-type]
    return []


def _count_tokens(item: str) -> int:
    """Cheap token estimate."""
    return len(item) // 3


def _last_message_idx(messages: list[dict[str, Any]], role: str) -> int | None:
    for i in range(len(messages) - 1, -1, -1):
        if messages[i].get("role") == role:
            return i
    return None


def _token_counts(items: Sequence[str | ChunkSpan | Mapping[str, Any]]) -> list[int]:
    out = []
    for item in items:
        if isinstance(item, ChunkSpan):
            out.append(_count_tokens(item.to_xml()))
        elif isinstance(item, Mapping):
            out.append(_count_tokens(json.dumps(item, ensure_ascii=False)))
        elif isinstance(item, str):
            out.append(_count_tokens(item))
        else:
            out.append(0)
    return out


def _cutoff_idx(token_counts: list[int], max_tokens: int, *, reverse: bool = False) -> int:
    counts = token_counts[::-1] if reverse else token_counts
    cum = np.cumsum(counts)
    idx = int(np.searchsorted(cum, max_tokens, side="right"))
    return len(token_counts) - idx if reverse else idx


def _limit_chunkspans(
    tool_chunk_spans: dict[Any, list[ChunkSpan]],
    config: RAGLiteConfig,
    *,
    messages: list[dict[str, Any]] | None = None,
    user_prompt: str | None = None,
    template: str = RAG_INSTRUCTION_TEMPLATE,
) -> dict[Any, list[ChunkSpan]]:
    """Proportionally truncate retrieved spans to the context window."""
    buffer = 0
    if messages:
        for role in ("user", "system", "assistant"):
            idx = _last_message_idx(messages, role)
            if idx is not None:
                buffer += _count_tokens(json.dumps(messages[idx]))
    elif user_prompt:
        buffer = _count_tokens(template.format(context="", user_prompt=user_prompt))
    max_tokens = get_context_size(config) - buffer
    per_tool_counts = {tid: _token_counts(spans) for tid, spans in tool_chunk_spans.items()}
    total = sum(sum(c) for c in per_tool_counts.values())
    if total <= max_tokens:
        return tool_chunk_spans
    scale = max_tokens / total
    limited: dict[Any, list[ChunkSpan]] = {}
    kept = dropped = 0
    for tool_id, spans in tool_chunk_spans.items():
        budget = int(scale * sum(per_tool_counts[tool_id]))
        cutoff = _cutoff_idx(per_tool_counts[tool_id], budget)
        limited[tool_id] = spans[:cutoff]
        kept += cutoff
        dropped += len(spans) - cutoff
    if dropped:
        logger.warning(
            "RAG context was limited to %d out of %d chunk spans due to context window size.",
            kept,
            kept + dropped,
        )
    return limited


def add_context(
    user_prompt: str,
    context: list[ChunkSpan],
    config: RAGLiteConfig | None = None,
    *,
    rag_instruction_template: str = RAG_INSTRUCTION_TEMPLATE,
) -> dict[str, str]:
    """Render spans into a RAG user message."""
    config = config or RAGLiteConfig()
    limited = _limit_chunkspans({"_": context}, config, user_prompt=user_prompt)["_"]
    return {
        "role": "user",
        "content": rag_instruction_template.format(
            context="\n".join(span.to_xml(index=i + 1) for i, span in enumerate(limited)),
            user_prompt=user_prompt.strip(),
        ),
    }


def _clip(messages: list[dict[str, Any]], max_tokens: int) -> list[dict[str, Any]]:
    """Left-clip history, keeping the last system and user messages when
    possible."""
    counts = _token_counts(messages)
    cutoff = _cutoff_idx(counts, max_tokens, reverse=True)
    idx_user = _last_message_idx(messages, "user")
    if cutoff == len(messages) or (idx_user is not None and idx_user < cutoff):
        logger.warning("Context window of %d tokens exceeded while clipping.", max_tokens)
        idx_system = _last_message_idx(messages, "system")
        if (
            idx_user is not None
            and idx_system is not None
            and idx_system < idx_user
            and counts[idx_user] + counts[idx_system] <= max_tokens
        ):
            return [messages[idx_system], messages[idx_user]]
        if idx_user is not None and counts[idx_user] <= max_tokens:
            return [messages[idx_user]]
        return []
    return messages[cutoff:]


_SEARCH_TOOL = {
    "type": "function",
    "function": {
        "name": "search_knowledge_base",
        "description": (
            "Search the knowledge base.\n"
            "IMPORTANT: You MAY NOT use this function if the question can be answered with "
            "common knowledge or straightforward reasoning.\n"
            "For multi-faceted questions, call this function once for each facet."
        ),
        "parameters": {
            "type": "object",
            "properties": {
                "query": {
                    "type": "string",
                    "description": (
                        "The `query` string MUST be a precise single-faceted question in the "
                        "user's language.\n"
                        "The `query` string MUST resolve all pronouns to explicit nouns."
                    ),
                },
            },
            "required": ["query"],
            "additionalProperties": False,
        },
    },
}


def _require_messages(messages: list[dict[str, Any]]) -> None:
    if not messages:
        msg = "rag() requires at least one message"
        raise ValueError(msg)


def _get_tools(
    messages: list[dict[str, Any]], config: RAGLiteConfig
) -> tuple[list[dict[str, Any]] | None, Any]:
    """Inject the knowledge-base tool when the last message has no RAG
    context."""
    final = str(messages[-1].get("content", ""))
    has_context = any(s in final for s in ("<context>", "<document>", "from_chunk_id"))
    if not has_context and not llm_from_config(config).supports_function_calling:
        msg = (
            "You must either explicitly provide RAG context in the last message, "
            "or use an LLM that supports function calling."
        )
        raise ValueError(msg)
    tools = None if has_context else [_SEARCH_TOOL]
    return tools, ("auto" if tools else None)


def _run_tool(index: int, tool_call: ToolCall, config: RAGLiteConfig) -> tuple[int, list[ChunkSpan]]:
    if tool_call.name == "search_knowledge_base":
        kwargs = json.loads(tool_call.arguments)
        kwargs["config"] = config
        return index, retrieve_context(**kwargs)
    msg = f"Unknown function {tool_call.name}."
    raise ValueError(msg)


def _run_tools(
    tool_calls: list[ToolCall],
    on_retrieval: Callable[[list[ChunkSpan]], None] | None,
    config: RAGLiteConfig,
    *,
    messages: list[dict[str, Any]] | None,
    max_workers: int | None = None,
) -> list[dict[str, Any]]:
    """Execute tool calls in parallel, budget context, format tool messages.
    Results are keyed by position (servers may repeat or omit call ids)."""
    spans_by_call: dict[int, list[ChunkSpan]] = {}
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = [pool.submit(_run_tool, i, tc, config) for i, tc in enumerate(tool_calls)]
        try:
            for future in as_completed(futures):
                call_index, spans = future.result()
                spans_by_call[call_index] = spans
        except Exception as e:
            pool.shutdown(cancel_futures=True)
            msg = f"Error executing tool: {e}"
            raise ValueError(msg) from e
    spans_by_call = _limit_chunkspans(spans_by_call, config, messages=messages)
    tool_messages: list[dict[str, Any]] = []
    for call_index, tool_call in enumerate(tool_calls):
        spans = spans_by_call.get(call_index, [])
        tool_messages.append(
            {
                "role": "tool",
                "content": '{{"documents": [{elements}]}}'.format(
                    elements=", ".join(span.to_json(index=i + 1) for i, span in enumerate(spans))
                ),
                "tool_call_id": tool_call.id,
            }
        )
        if spans and callable(on_retrieval):
            on_retrieval(spans)
    return tool_messages


def rag(
    messages: list[dict[str, Any]],
    *,
    on_retrieval: Callable[[list[ChunkSpan]], None] | None = None,
    config: RAGLiteConfig | None = None,
) -> Iterator[str]:
    """Two-phase streamed RAG: a tool round (optional) then the answer round,
    appending all messages to the caller's list."""
    _require_messages(messages)
    config = config or RAGLiteConfig()
    llm = llm_from_config(config)
    max_tokens = get_context_size(config)
    tools, tool_choice = _get_tools(messages, config)
    content_parts: list[str] = []
    tool_calls: list[ToolCall] = []
    for item in llm.stream(_clip(messages, max_tokens), tools=tools, tool_choice=tool_choice):
        if isinstance(item, ToolCall):
            tool_calls.append(item)
        else:
            content_parts.append(item)
            yield item
    if tool_calls:
        messages.append(ChatResponse("".join(content_parts) or None, tool_calls).message_dict())
        messages.extend(_run_tools(tool_calls, on_retrieval, config, messages=messages))
        content_parts = []
        for item in llm.stream(_clip(messages, max_tokens)):
            if isinstance(item, str):
                content_parts.append(item)
                yield item
    messages.append({"role": "assistant", "content": "".join(content_parts)})


async def async_rag(
    messages: list[dict[str, Any]],
    *,
    on_retrieval: Callable[[list[ChunkSpan]], None] | None = None,
    config: RAGLiteConfig | None = None,
) -> AsyncIterator[str]:
    """Async mirror of :func:`rag`.

    A provider with an asyncio-native stream (``openai:``, whose socket is
    read on the event loop: models/llm.py:_async_sse_post) runs without a
    worker thread; only its tool round (a device search) goes to the
    executor.  A provider without one (``jax:``, ``echo``: the decoder
    blocks on its device steps) is driven on a worker thread, so the event
    loop stays responsive.
    """
    _require_messages(messages)
    config = config or RAGLiteConfig()
    llm = llm_from_config(config)
    tokens = (
        _async_rag_native(llm, messages, on_retrieval, config)
        if hasattr(llm, "astream")
        else _async_rag_bridge(messages, on_retrieval, config)
    )
    # Closing this generator closes the inner one at once (not when it is
    # collected), so an early exit stops the worker before aclose() returns.
    async with contextlib.aclosing(tokens):
        async for token in tokens:
            yield token


async def _async_rag_native(
    llm: Any,
    messages: list[dict[str, Any]],
    on_retrieval: Callable[[list[ChunkSpan]], None] | None,
    config: RAGLiteConfig,
) -> AsyncIterator[str]:
    """Two-phase RAG over the provider's own async stream: no thread is
    held for the life of the answer."""
    import asyncio
    from functools import partial

    max_tokens = get_context_size(config)
    tools, tool_choice = _get_tools(messages, config)
    content_parts: list[str] = []
    tool_calls: list[ToolCall] = []
    async for item in llm.astream(_clip(messages, max_tokens), tools=tools, tool_choice=tool_choice):
        if isinstance(item, ToolCall):
            tool_calls.append(item)
        else:
            content_parts.append(item)
            yield item
    if tool_calls:
        messages.append(ChatResponse("".join(content_parts) or None, tool_calls).message_dict())
        loop = asyncio.get_running_loop()
        # The tool round runs a device search: a short, bounded block, so it
        # goes to the executor rather than stalling every live stream.
        tool_messages = await loop.run_in_executor(
            None, partial(_run_tools, tool_calls, on_retrieval, config, messages=messages)
        )
        messages.extend(tool_messages)
        content_parts = []
        async for item in llm.astream(_clip(messages, max_tokens)):
            if isinstance(item, str):
                content_parts.append(item)
                yield item
    messages.append({"role": "assistant", "content": "".join(content_parts)})


async def _async_rag_bridge(
    messages: list[dict[str, Any]],
    on_retrieval: Callable[[list[ChunkSpan]], None] | None,
    config: RAGLiteConfig,
) -> AsyncIterator[str]:
    """``rag()`` on a worker thread, its tokens handed to the event loop.

    When the consumer walks away (breaks, closes the generator or is
    cancelled) the worker stops at its next token, before it asks the LLM
    for another, and the generator's close waits for it: once ``aclose()``
    returns, no decoder forward of this answer is still running and
    ``messages`` is no longer written to."""
    import asyncio
    import threading

    loop = asyncio.get_running_loop()
    queue: asyncio.Queue[str | None] = asyncio.Queue()
    abandoned = threading.Event()

    def worker() -> None:
        try:
            for token in rag(messages, on_retrieval=on_retrieval, config=config):
                if abandoned.is_set():
                    break
                loop.call_soon_threadsafe(queue.put_nowait, token)
        finally:
            if not abandoned.is_set():
                loop.call_soon_threadsafe(queue.put_nowait, None)

    task = loop.run_in_executor(None, worker)
    try:
        while True:
            token = await queue.get()
            if token is None:
                break
            yield token
        await task
    finally:
        abandoned.set()
        if not task.done():
            await asyncio.wait([task])
