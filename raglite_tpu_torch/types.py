"""Core type aliases and protocols.

Counterpart of raglite_tpu/types.py, the re-design of the reference's
``_typing.py`` (raglite/_typing.py:20-54). The reference's SQLAlchemy
column types (NumpyArray, Embedding, EmbeddingDistance) have no analogue here:
embeddings live in device memory as torch tensors and on disk as ``.npy`` shards,
so the entire per-dialect SQL machinery is replaced by typed array contracts.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import TYPE_CHECKING, Any, Literal, Protocol, Union

import numpy as np

if TYPE_CHECKING:
    from raglite_tpu_torch.config import RAGLiteConfig
    from raglite_tpu_torch.documents import Chunk, ChunkSpan

# --- Identifiers (reference: _typing.py:20-23) -------------------------------

DocumentId = str
ChunkId = str
EvalId = str

# --- Metrics & filters (reference: _typing.py:25-28) -------------------------

DistanceMetric = Literal["cosine", "dot", "l2"]

#: Mapping of metadata field name -> required value (or list of candidate
#: values, any of which matches).  Mirrors the reference's JSON-containment
#: semantics (_search.py:96-141, _delete.py:56-60).
MetadataFilter = dict[str, Any]

# --- Array aliases (reference: _typing.py:30-32) -----------------------------

FloatMatrix = np.ndarray  # shape (n, d)
FloatVector = np.ndarray  # shape (d,)
IntVector = np.ndarray  # shape (n,)

# --- Search-method protocols (reference: _typing.py:35-54) -------------------


class BasicSearchMethod(Protocol):
    """A search returning ranked chunk ids and scores."""

    def __call__(
        self,
        query: str,
        *,
        num_results: int,
        metadata_filter: MetadataFilter | None = None,
        config: "RAGLiteConfig | None" = None,
    ) -> tuple[list[ChunkId], list[float]]: ...


class SearchMethod(Protocol):
    """Any search: ranked ids+scores, chunks, or chunk spans."""

    def __call__(
        self,
        query: str,
        *,
        num_results: int,
        metadata_filter: MetadataFilter | None = None,
        config: "RAGLiteConfig | None" = None,
    ) -> Union[
        tuple[list[ChunkId], list[float]],
        "list[Chunk]",
        "list[ChunkSpan]",
    ]: ...


RerankerLike = Union[str, Callable[..., Any], dict[str, Union[str, Callable[..., Any]]]]
