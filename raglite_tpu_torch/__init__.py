"""raglite-tpu's retrieval and answer path in PyTorch, for NVIDIA Hopper GPUs.

The JAX package ``raglite_tpu`` beside this one is the reference; this
package imports neither JAX nor it (it reads only the packaged encoder's
data files by path).  This version covers ingestion and deletes, vector
search on the dense index (with hand-written CUDA C++ scan kernels in
``csrc/``), keyword (BM25) and hybrid search on the device over
first-party C++ postings (``native/``), the MaxSim rerank, ``rag()``
answers from the first-party decoder LLM (with hand-written CUDA C++
attention kernels), ``async_rag``, OpenAI-compatible endpoints (``openai:``
LLMs and embedders), schema-constrained, forced-tool and batched generation,
structured extraction (``extract_with_llm``, ``expand_document_metadata``
and self-query search), evals (``insert_evals``, ``answer_evals``,
``evaluate``), the query adapter (``update_query_adapter``), the
surfaces (CLI, MCP, web chat) and the IR benchmark (``irbench``, with its
C++ HNSW baseline): every module of the JAX package has a counterpart.
Entry points run on the card unless ``RAGLiteConfig(device="cpu")``.

``import raglite_tpu_torch`` loads neither pydantic, which the extraction
entry points import when called, nor pandas, which ``answer_evals`` and
``evaluate`` (and ``irbench.run_ir_benchmark``, where it can) import to
build their DataFrames: a GPU machine may have neither.
"""

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.delete import delete_documents, delete_documents_by_metadata
from raglite_tpu_torch.documents import Chunk, ChunkSpan, Document, Eval
from raglite_tpu_torch.evals import answer_evals, evaluate, insert_evals
from raglite_tpu_torch.extract import expand_document_metadata, extract_with_llm
from raglite_tpu_torch.insert import insert_documents
from raglite_tpu_torch.query_adapter import update_query_adapter
from raglite_tpu_torch.rag import add_context, async_rag, rag, retrieve_context
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
    "Eval",
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
    "async_rag",
    "extract_with_llm",
    "expand_document_metadata",
    "update_query_adapter",
    "insert_evals",
    "answer_evals",
    "evaluate",
]

__version__ = "0.1.0"
