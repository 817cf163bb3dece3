"""Structured extraction with LLMs (counterpart of raglite_tpu/extract.py).

``extract_with_llm`` (a pydantic model from text, schema-constrained),
``expand_document_metadata`` (metadata fields for many documents, with one
batched first pass through ``complete_batch``) and ``self_query_filter``
(a metadata filter from a query, for ``config.self_query``).  This is the
only module of the package that imports pydantic; the package root exports
the first two lazily, so ``import raglite_tpu_torch`` does not load it.
"""

from __future__ import annotations

import logging
import warnings
from collections.abc import Iterable, Iterator, Mapping
from typing import Any, ClassVar, TypeVar

from pydantic import BaseModel, ConfigDict, Field, ValidationError, create_model

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.documents import Document, adapt_metadata
from raglite_tpu_torch.models.llm import llm_from_config
from raglite_tpu_torch.types import MetadataFilter

logger = logging.getLogger(__name__)

T = TypeVar("T", bound=BaseModel)

__all__ = ["extract_with_llm", "expand_document_metadata", "self_query_filter"]


def _prompt_and_format(return_type, llm, strict):  # noqa: FBT001
    """System prompt + response_format for schema-constrained extraction
    (schema-in-prompt fallback when the LLM lacks constrained decoding)."""
    system_prompt = str(getattr(return_type, "system_prompt", "")).strip()
    if not llm.supports_response_format:
        system_prompt += (
            "\n\nFormat your response according to this JSON schema:\n"
            f"{return_type.model_json_schema()}"
        )
    response_format: dict[str, Any] | None = (
        {
            "type": "json_schema",
            "json_schema": {
                "name": return_type.__name__,
                "description": return_type.__doc__ or "",
                "schema": return_type.model_json_schema(),
                "strict": strict,
            },
        }
        if llm.supports_response_format
        else None
    )
    return system_prompt, response_format


def _extract_batch_first_pass(return_type, texts, strict, config, **kwargs):  # noqa: FBT001
    """One batched-decode attempt per text (None where validation failed,
    the caller retries those individually).  Returns None when the LLM has
    no batch API."""
    llm = llm_from_config(config)
    if not hasattr(llm, "complete_batch"):
        return None
    system_prompt, response_format = _prompt_and_format(return_type, llm, strict)
    responses = llm.complete_batch(
        [
            [
                {"role": "system", "content": system_prompt},
                {"role": "user", "content": text},
            ]
            for text in texts
        ],
        response_format=response_format,
        **kwargs,
    )
    out = []
    for response in responses:
        try:
            out.append(return_type.model_validate_json(response.content or ""))
        except (ValueError, ValidationError):
            out.append(None)
    return out


def extract_with_llm(
    return_type: type[T],
    user_prompt: str | list[str],
    strict: bool = False,  # noqa: FBT001, FBT002
    config: RAGLiteConfig | None = None,
    **kwargs: Any,
) -> T:
    """Extract an instance of a Pydantic model from unstructured text.

    ``return_type.system_prompt: ClassVar[str]`` provides the system prompt;
    the JSON schema constrains the response (falling back to schema-in-prompt
    when the LLM lacks a response-format parameter), with a retry loop of
    ``config.llm_max_tries`` validations.
    """
    config = config or RAGLiteConfig()
    llm = llm_from_config(config)
    system_prompt, response_format = _prompt_and_format(return_type, llm, strict)
    if isinstance(user_prompt, list):
        user_prompt = "\n\n".join(
            f'<context index="{i + 1}">\n{chunk.strip()}\n</context>'
            for i, chunk in enumerate(user_prompt)
        )
    last_exception: Exception = ValueError("no attempts made")
    for _ in range(config.llm_max_tries):
        response = llm.complete(
            [
                {"role": "system", "content": system_prompt},
                {"role": "user", "content": user_prompt},
            ],
            response_format=response_format,
            **kwargs,
        )
        try:
            return return_type.model_validate_json(response.content or "")
        except (ValueError, ValidationError) as e:
            last_exception = e
            continue
    msg = f"Failed to extract {return_type} from input {user_prompt}."
    raise ValueError(msg) from last_exception


def expand_document_metadata(  # noqa: PLR0913
    documents: Iterable[Document],
    metadata_fields: Mapping[str, type[Any]],
    *,
    max_context_size: int | None = None,
    source: str = "content",
    strict: bool = False,
    config: RAGLiteConfig | None = None,
    **kwargs: Any,
) -> Iterator[Document]:
    """Extract metadata fields for each document with an LLM.

    ``metadata_fields`` maps names to ``Annotated[type, Field(...)]`` specs;
    extraction failures warn and leave the document unchanged.
    """
    documents = list(documents)
    if not documents:
        return
    config = config or RAGLiteConfig()
    metadata_model = create_model(  # type: ignore[call-overload]
        "DocumentMetadata",
        __config__=ConfigDict(extra="forbid"),
        **metadata_fields,
    )
    metadata_model.system_prompt = (  # type: ignore[attr-defined]
        "Extract the requested metadata fields from the document below. "
        "Only use information stated in the document."
    )
    texts = []
    for document in documents:
        if source == "content":
            text = document.content or ""
        else:
            value = document.metadata_.get(source, "")
            text = str(value[0] if isinstance(value, list) and value else value)
        if max_context_size is not None:
            text = text[:max_context_size]
        texts.append(text)
    # First pass: ONE batched decode over all documents when the LLM
    # supports it (the decoder shares its prefill and every decode forward
    # across the batch); per-document retries handle validation failures.
    try:
        first_pass = _extract_batch_first_pass(metadata_model, texts, strict, config, **kwargs)
    except Exception as e:  # noqa: BLE001 — a batched [B, T] prefill can run
        # out of memory on large document sets; degrade to the per-document
        # loop below, so failures warn and leave the document unchanged.
        warnings.warn(f"Batched metadata extraction failed ({e}); retrying per document.",
                      stacklevel=2)
        first_pass = None
    for i, document in enumerate(documents):
        extracted = first_pass[i] if first_pass is not None else None
        try:
            if extracted is None:
                extracted = extract_with_llm(metadata_model, texts[i], strict, config, **kwargs)
            document.metadata_.update(adapt_metadata(extracted.model_dump(exclude_none=True)))
        except ValueError as e:
            warnings.warn(
                f"Failed to expand metadata for document {document.id}: {e}",
                stacklevel=2,
            )
        yield document


SELF_QUERY_PROMPT = """
You are an assistant that extracts metadata filters from user queries to help search a knowledge base.

Instructions:
1. For each metadata field, only populate it if the query explicitly and unambiguously mentions a specific allowed value.
2. If the query is general, ambiguous, or does not mention a field, set it to None.
3. Do NOT infer values from common knowledge or context.
4. For each field, return ONLY the numeric ID(s) from the allowed options below. Do NOT return labels or text.
5. Output your answer as a JSON object with field names as keys and lists of IDs or None as values.
""".strip()


def self_query_filter(
    query: str,
    *,
    system_prompt: str = SELF_QUERY_PROMPT,
    config: RAGLiteConfig | None = None,
) -> MetadataFilter:
    """Extract a metadata filter from a natural-language query.

    Allowed values come from the store's metadata table; each value gets a
    numeric ID so the LLM returns IDs rather than labels (avoiding encoding
    issues), mapped back afterwards.
    """
    from raglite_tpu_torch.store import store_from_config

    config = config or RAGLiteConfig()
    store = store_from_config(config)
    if not store.metadata:
        return {}
    field_ids: dict[str, dict[int, Any]] = {}
    field_definitions: dict[str, Any] = {
        "system_prompt": (ClassVar[str], system_prompt),
    }
    for name, values in store.metadata.items():
        field_ids[name] = dict(enumerate(values))
        description = (
            "Return ONLY IDs from this set (use IDs, not labels). "
            f"Allowed options: {field_ids[name]}"
        )
        field_definitions[name] = (
            list[int] | None,
            Field(default=None, description=description),
        )
    model = create_model("MetadataFilterModel", **field_definitions, __base__=BaseModel)
    try:
        result = extract_with_llm(model, query, config=config, temperature=0)
    except ValueError as e:
        logger.debug("Failed to extract metadata filter: %s", e)
        return {}
    out = result.model_dump(exclude_none=True)
    for name, ids in out.items():
        if name in field_ids:
            out[name] = [field_ids[name][i] for i in ids if i in field_ids[name]]
    return {k: v for k, v in out.items() if v}
