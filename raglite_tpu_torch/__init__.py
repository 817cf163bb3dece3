"""raglite-tpu's retrieval and answer path in PyTorch, for NVIDIA Hopper GPUs.

The JAX package ``raglite_tpu`` beside this one is the reference; this
package imports neither JAX nor it (it reads only the packaged encoder's
data files by path).  This version covers ingestion and deletes, vector
search on the dense index (with hand-written CUDA C++ scan kernels in
``csrc/``), keyword (BM25) and hybrid search on the device over
first-party C++ postings (``native/``), the MaxSim rerank and ``rag()``
answers from the first-party decoder LLM (with hand-written CUDA C++
attention kernels); see ROADMAP.md for what is still to be ported.  Entry
points run on the card unless ``RAGLiteConfig(device="cpu")``.
"""

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.delete import delete_documents, delete_documents_by_metadata
from raglite_tpu_torch.documents import Chunk, ChunkSpan, Document
from raglite_tpu_torch.insert import insert_documents
from raglite_tpu_torch.rag import add_context, rag, retrieve_context
from raglite_tpu_torch.search import (
    hybrid_search,
    hybrid_search_batch,
    keyword_search,
    keyword_search_batch,
    reciprocal_rank_fusion,
    rerank_chunks,
    retrieve_chunk_spans,
    retrieve_chunks,
    search_and_rerank_chunk_spans,
    search_and_rerank_chunks,
    vector_search,
    vector_search_batch,
)

__all__ = [
    "RAGLiteConfig",
    "Chunk",
    "ChunkSpan",
    "Document",
    "insert_documents",
    "delete_documents",
    "delete_documents_by_metadata",
    "hybrid_search",
    "hybrid_search_batch",
    "keyword_search",
    "keyword_search_batch",
    "vector_search",
    "vector_search_batch",
    "reciprocal_rank_fusion",
    "retrieve_chunks",
    "retrieve_chunk_spans",
    "rerank_chunks",
    "search_and_rerank_chunks",
    "search_and_rerank_chunk_spans",
    "retrieve_context",
    "add_context",
    "rag",
]

__version__ = "0.1.0"
