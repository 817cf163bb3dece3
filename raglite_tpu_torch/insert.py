"""Insert documents into the store and device index.

Counterpart of raglite/_insert.py:88-272.  The SQL
session/flush machinery becomes store mutations + a device-index sync; the
DuckDB postlude (FTS rebuild, hnsw_compact, CHECKPOINT, _insert.py:260-272)
becomes a store save + keyword-postings refresh.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from raglite_tpu_torch.chunklets import split_chunklets
from raglite_tpu_torch.chunks import split_chunks
from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.documents import Chunk, Document
from raglite_tpu_torch.embed import embed_strings, embed_strings_without_late_chunking, embedding_type
from raglite_tpu_torch.sentences import split_sentences
from raglite_tpu_torch.store import Store, store_from_config
from raglite_tpu_torch.utils.trace import phase

__all__ = ["insert_documents"]

#: Metadata fields not aggregated into the self-query Metadata table
#: (reference: _insert.py:31).
METADATA_EXCLUDED_FIELDS = ("filename", "uri", "url", "size", "created", "modified")

#: Multivector blend weight (reference: _insert.py:132, "benchmark-optimised").
MULTIVECTOR_ALPHA = 0.15

MAX_WORKERS = 4  # reference: _insert.py:158-159


def _create_chunk_records(
    document: Document, config: RAGLiteConfig
) -> tuple[list[Chunk], list[np.ndarray]]:
    """Split, embed, and chunk one document (reference: _insert.py:88-155).

    Returns chunk records and one multi-vector embedding matrix per chunk.
    """
    assert document.content is not None
    with phase("insert.split_sentences"):
        sentences = split_sentences(
            document.content,
            max_len=config.chunk_max_size,
            base_probas=config.sentence_boundary_model,
            device=config.device,
        )
    with phase("insert.split_chunklets"):
        chunklets = split_chunklets(sentences, max_size=config.chunk_max_size)
    with phase("insert.embed"):
        chunklet_embeddings = embed_strings(chunklets, config=config)
    with phase("insert.split_chunks"):
        chunks, chunk_embeddings = split_chunks(
            chunklets=chunklets,
            chunklet_embeddings=chunklet_embeddings,
            max_size=config.chunk_max_size,
        )
    # Chunk records carry rolling contextual headings (reference: _insert.py:103-111).
    chunk_records: list[Chunk] = []
    headings = ""
    for i, body in enumerate(chunks):
        record = Chunk.from_body(
            document=document, index=i, body=body, headings=headings,
            metadata=document.metadata_,
        )
        chunk_records.append(record)
        headings = record.extract_headings()
    # Embedding matrices (reference: _insert.py:114-154).
    matrices: list[np.ndarray] = []
    if embedding_type(config=config) == "late_chunking":
        # One sub-vector per chunklet in the chunk.
        matrices = [np.asarray(m, dtype=np.float16) for m in chunk_embeddings]
    else:
        full = embed_strings_without_late_chunking(
            [record.content for record in chunk_records], config=config
        )
        for group, full_vec in zip(chunk_embeddings, full):
            if config.vector_search_multivector:
                blended = MULTIVECTOR_ALPHA * group + (1 - MULTIVECTOR_ALPHA) * full_vec[None, :]
                # L2-normalize the blended rows: the cosine scan scores by raw
                # dot product (index/dense.py treats cosine as dot over
                # normalized rows), so unnormalized blends (row norms ~0.7-1.0)
                # would skew rankings vs the reference's true-cosine SQL.
                norms = np.linalg.norm(blended, axis=1, keepdims=True)
                blended = blended / np.maximum(norms, 1e-12)
                matrices.append(np.asarray(blended, dtype=np.float16))
            else:
                matrices.append(np.asarray(full_vec[None, :], dtype=np.float16))
    return chunk_records, matrices


def _aggregate_metadata(documents: list[Document]) -> dict[str, set[Any]]:
    """Collect filterable metadata values (reference: _insert.py:45-61)."""
    out: dict[str, set[Any]] = {}
    for doc in documents:
        for key, value in doc.metadata_.items():
            if key in METADATA_EXCLUDED_FIELDS:
                continue
            values = value if isinstance(value, list) else [value]
            bucket = out.setdefault(key, set())
            for v in values:
                if v is None:
                    continue
                try:
                    bucket.add(v)
                except TypeError:
                    # Unhashable (nested dict/list) metadata values can't be
                    # offered as self-query filter choices; keep them on the
                    # document but don't let them abort the whole insert.
                    continue
    return out


def insert_documents(
    documents: list[Document],
    *,
    max_workers: int | None = None,
    config: RAGLiteConfig | None = None,
) -> None:
    """Insert documents idempotently (reference: _insert.py:162-272).

    Deduplicates by content-hash id, skips already-inserted documents,
    processes documents in a bounded thread pool, and persists the store
    afterwards (a no-op for ":memory:" stores).
    """
    config = config or RAGLiteConfig()
    store: Store = store_from_config(config)
    for document in documents:
        if document.content is None:
            msg = f"document {document.id} has no content"
            raise ValueError(msg)
    with store.write_lock():
        # Dedup within the batch and against the store UNDER the lock, after
        # absorbing any concurrent writer's committed state — otherwise two
        # processes inserting the same document both pass the check and
        # commit duplicate chunk rows (reference dedups inside its
        # transaction, _insert.py:190-204).
        store.absorb_concurrent()
        unique: dict[str, Document] = {}
        for document in documents:
            if document.id not in unique and not store.has_document(document.id):
                unique[document.id] = document
        todo = list(unique.values())
        if not todo:
            return
        workers = min(max_workers or MAX_WORKERS, MAX_WORKERS, max(len(todo), 1))
        if workers > 1 and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futures = [pool.submit(_create_chunk_records, d, config) for d in todo]
                results = [future.result() for future in futures]
        else:
            results = [_create_chunk_records(document, config) for document in todo]
        for document, (chunk_records, matrices) in zip(todo, results):
            store.add_document(document)
            store.add_chunks(chunk_records, matrices)
        store.update_metadata(_aggregate_metadata(todo))
        store.save()
    # The dense index syncs lazily on the next search (store.version bump).
