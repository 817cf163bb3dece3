"""Delete documents from the store and indexes (counterpart of
raglite_tpu/delete.py and of raglite/_delete.py:181-307).

The reference's Postgres-cascade vs DuckDB manual-multi-commit split disappears:
the store deletes atomically under the writer lock, and the device indexes
resync (tombstone/rebuild) on next use — replacing the FTS rebuild +
``hnsw_compact_index`` postlude (_delete.py:130-178).
"""

from __future__ import annotations

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.store import store_from_config
from raglite_tpu_torch.types import DocumentId, MetadataFilter

__all__ = ["delete_documents", "delete_documents_by_metadata"]


def delete_documents(
    document_ids: list[DocumentId],
    *,
    invalidate_query_adapter: bool = True,
    config: RAGLiteConfig | None = None,
) -> int:
    """Delete documents with their chunks, embeddings, and evals.

    Returns the number of documents deleted.  When any deleted document
    backed the trained query adapter's evals, the adapter is invalidated
    (reference: _delete.py:31-45).
    """
    config = config or RAGLiteConfig()
    store = store_from_config(config)
    present = [d for d in document_ids if d in store.documents]
    if not present:
        return 0
    with store.write_lock():
        present_set = set(present)
        affects_adapter = invalidate_query_adapter and any(
            ev.document_id in present_set for ev in store.evals.values()
        )
        store.delete_documents(present)
        store.prune_metadata()
        if affects_adapter and "query_adapter" in store.index_metadata:
            del store.index_metadata["query_adapter"]
            store.version += 1
        store.save()
    return len(present)


def delete_documents_by_metadata(
    metadata_filter: MetadataFilter,
    *,
    config: RAGLiteConfig | None = None,
) -> int:
    """Delete all documents whose metadata contains the filter values
    (reference: _delete.py:262-307, JSON-containment semantics)."""
    config = config or RAGLiteConfig()
    store = store_from_config(config)
    matching: list[DocumentId] = []
    for doc in store.documents.values():
        ok = True
        for key, wanted in metadata_filter.items():
            have = doc.metadata_.get(key)
            have_list = have if isinstance(have, list) else [have]
            wanted_list = wanted if isinstance(wanted, list) else [wanted]
            if not any(w in have_list for w in wanted_list):
                ok = False
                break
        if ok:
            matching.append(doc.id)
    return delete_documents(matching, config=config)
