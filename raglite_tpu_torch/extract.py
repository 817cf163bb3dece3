"""Structured extraction with LLMs (counterpart of raglite_tpu/extract.py).

``extract_with_llm`` (a pydantic model from text, schema-constrained),
``expand_document_metadata`` (metadata fields for many documents, with one
batched first pass through ``complete_batch``) and ``self_query_filter``
(a metadata filter from a query, for ``config.self_query``).

Both extraction loops (the retry loop and the batched first pass) live in a
core that takes a plain JSON schema, a name, a system prompt and a validate
function (:func:`extract_json`, :func:`extract_json_batch_first_pass`,
:func:`schema_validator`), so callers without pydantic (evals.py, on a GPU
machine that may lack it) use them too.  The pydantic entry points are thin wrappers
that import pydantic when called: neither ``import raglite_tpu_torch`` nor
this module loads it.
"""

from __future__ import annotations

import json
import logging
import warnings
from collections.abc import Callable, Iterable, Iterator, Mapping
from typing import TYPE_CHECKING, Any, ClassVar, TypeVar

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.documents import Document, adapt_metadata
from raglite_tpu_torch.models.llm import llm_from_config
from raglite_tpu_torch.types import MetadataFilter

if TYPE_CHECKING:
    from pydantic import BaseModel

logger = logging.getLogger(__name__)

T = TypeVar("T", bound="BaseModel")
V = TypeVar("V")

__all__ = [
    "extract_with_llm",
    "expand_document_metadata",
    "self_query_filter",
    "extract_json",
    "extract_json_batch_first_pass",
    "schema_validator",
]


# --- The core: plain JSON schemas ------------------------------------------


def _prompt_and_format_json(schema, name, description, system_prompt, llm, strict):  # noqa: PLR0913, FBT001
    """System prompt + response_format for schema-constrained extraction
    (schema-in-prompt fallback when the LLM lacks constrained decoding)."""
    system_prompt = system_prompt.strip()
    if not llm.supports_response_format:
        system_prompt += f"\n\nFormat your response according to this JSON schema:\n{schema}"
    response_format: dict[str, Any] | None = (
        {
            "type": "json_schema",
            "json_schema": {"name": name, "description": description, "schema": schema, "strict": strict},
        }
        if llm.supports_response_format
        else None
    )
    return system_prompt, response_format


def _ordered(schema: Any, value: Any) -> Any:
    """``value`` with every object's keys in its schema's property order
    (keys the schema does not name follow, for the automaton to reject)."""
    if isinstance(value, dict) and isinstance(schema, dict) and "properties" in schema:
        props = schema["properties"]
        keys = [k for k in props if k in value] + [k for k in value if k not in props]
        return {k: _ordered(props.get(k), value[k]) for k in keys}
    if isinstance(value, list) and isinstance(schema, dict):
        return [_ordered(schema.get("items"), v) for v in value]
    return value


def _conforms(schema: dict[str, Any], value: Any) -> bool:
    """A fresh SchemaAutomaton (the constrained decoder's grammar) takes
    ``value`` rendered as JSON in the schema's key order; white space
    outside strings is insignificant and skipped where the grammar has
    none."""
    from raglite_tpu_torch.models.json_automaton import _WS
    from raglite_tpu_torch.models.schema_automaton import SchemaAutomaton

    automaton = SchemaAutomaton(schema)
    for byte in json.dumps(_ordered(schema, value), ensure_ascii=False).encode("utf-8"):
        allowed = automaton.allowed_bytes()
        if byte not in allowed:
            if byte in _WS:
                continue
            return False
        automaton.feed(byte)
    return automaton.done()


def schema_validator(
    schema: dict[str, Any], check: Callable[[dict[str, Any]], None] | None = None
) -> Callable[[str], dict[str, Any]]:
    """The validate function of a plain schema, in three steps: parse the
    JSON, check its conformance with the schema (:func:`_conforms`), then
    run ``check`` on the parsed dict (it raises ``ValueError`` to reject).
    The function returns the dict or raises ``ValueError``."""

    def validate(content: str) -> dict[str, Any]:
        value = json.loads(content)  # JSONDecodeError is a ValueError
        if not isinstance(value, dict) or not _conforms(schema, value):
            msg = f"response does not conform to the schema: {content[:200]!r}"
            raise ValueError(msg)
        if check is not None:
            check(value)
        return value

    return validate


def extract_json_batch_first_pass(  # noqa: PLR0913
    schema: dict[str, Any],
    name: str,
    system_prompt: str,
    validate: Callable[[str], V],
    texts: list[str],
    strict: bool,  # noqa: FBT001
    config: RAGLiteConfig,
    *,
    description: str = "",
    **kwargs: Any,
) -> list[V | None] | None:
    """One batched-decode attempt per text (None where validation failed,
    the caller retries those individually).  Returns None when the LLM has
    no batch API."""
    llm = llm_from_config(config)
    if not hasattr(llm, "complete_batch"):
        return None
    system_prompt, response_format = _prompt_and_format_json(schema, name, description, system_prompt, llm, strict)
    responses = llm.complete_batch(
        [[{"role": "system", "content": system_prompt}, {"role": "user", "content": text}] for text in texts],
        response_format=response_format,
        **kwargs,
    )
    out: list[V | None] = []
    for response in responses:
        try:
            out.append(validate(response.content or ""))
        except ValueError:
            out.append(None)
    return out


def extract_json(  # noqa: PLR0913
    schema: dict[str, Any],
    name: str,
    system_prompt: str,
    validate: Callable[[str], V],
    user_prompt: str | list[str],
    strict: bool = False,  # noqa: FBT001, FBT002
    config: RAGLiteConfig | None = None,
    *,
    description: str = "",
    **kwargs: Any,
) -> V:
    """Extract one JSON instance of ``schema`` from unstructured text.

    The schema constrains the response (schema-in-prompt when the LLM lacks
    a response-format parameter); ``validate`` returns the parsed result or
    raises ``ValueError``, and a rejected response is asked for again, up to
    ``config.llm_max_tries`` times.  A list of texts becomes numbered
    ``<context>`` blocks."""
    config = config or RAGLiteConfig()
    llm = llm_from_config(config)
    system_prompt, response_format = _prompt_and_format_json(schema, name, description, system_prompt, llm, strict)
    if isinstance(user_prompt, list):
        user_prompt = "\n\n".join(
            f'<context index="{i + 1}">\n{chunk.strip()}\n</context>' for i, chunk in enumerate(user_prompt)
        )
    last_exception: Exception = ValueError("no attempts made")
    for _ in range(config.llm_max_tries):
        response = llm.complete(
            [{"role": "system", "content": system_prompt}, {"role": "user", "content": user_prompt}],
            response_format=response_format,
            **kwargs,
        )
        try:
            return validate(response.content or "")
        except ValueError as e:
            last_exception = e
    msg = f"Failed to extract {name} from input {user_prompt}."
    raise ValueError(msg) from last_exception


# --- Pydantic wrappers --------------------------------------------------------


def _model_args(return_type) -> tuple[dict[str, Any], str, str, Callable[[str], Any], str]:
    """(schema, name, system prompt, validate, description) of a pydantic
    model, as the core takes them."""
    return (
        return_type.model_json_schema(),
        return_type.__name__,
        str(getattr(return_type, "system_prompt", "")),
        return_type.model_validate_json,  # its ValidationError is a ValueError
        return_type.__doc__ or "",
    )


def _extract_batch_first_pass(return_type, texts, strict, config, **kwargs):  # noqa: FBT001
    """:func:`extract_json_batch_first_pass` for a pydantic model."""
    schema, name, system_prompt, validate, description = _model_args(return_type)
    return extract_json_batch_first_pass(
        schema, name, system_prompt, validate, texts, strict, config, description=description, **kwargs
    )


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
    ``config.llm_max_tries`` validations (:func:`extract_json`).
    """
    schema, name, system_prompt, validate, description = _model_args(return_type)
    return extract_json(
        schema, name, system_prompt, validate, user_prompt, strict, config, description=description, **kwargs
    )


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
    from pydantic import ConfigDict, create_model

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
    from pydantic import BaseModel, Field, create_model

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
