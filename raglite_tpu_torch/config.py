"""Frozen configuration object threaded through every public call.

Counterpart of raglite_tpu/config.py with the same fields and checks, plus
``device``: the torch device the encoder and the dense index live on.
Entry points run on the card ("cuda", the default) unless the caller asks
for the CPU; asking for "cuda" where CUDA is not available raises.  Field
names keep the JAX package's, so configs map one to one: ``use_pallas``
switches the single-stage CUDA scan kernel on, and ``num_devices`` counts
the dense index's row shards (parallel/mesh.py:index_devices places them).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING

from raglite_tpu_torch.types import DistanceMetric, RerankerLike

if TYPE_CHECKING:
    import torch

    from raglite_tpu_torch.types import SearchMethod


def _default_store_path() -> str:
    """Default persistent store location (reference: _config.py:50-56 puts the
    default DuckDB file in the user-data dir)."""
    base = os.environ.get("RAGLITE_TPU_HOME", str(Path.home() / ".raglite_tpu_torch"))
    return str(Path(base) / "default")


def _vector_search(
    query, *, num_results: int = 8, metadata_filter=None, config=None
):
    """Lazily imported default search method (reference: _config.py:26-39)."""
    from raglite_tpu_torch.search import vector_search

    return vector_search(
        query, num_results=num_results, metadata_filter=metadata_filter, config=config
    )


def _default_search_method() -> "SearchMethod":
    return _vector_search


def _default_reranker() -> RerankerLike:
    """Per-language reranker mapping (reference: _config.py:73-79 defaults to
    FlashRank cross-encoders).  The default is token-level ColBERT-style
    MaxSim over the candidates' raw text, scored on the device for every
    language ("maxsim_chunklet" selects the cheaper
    stored-sub-vector variant; see search.rerank_chunks)."""
    return {"en": "maxsim", "other": "maxsim"}


@dataclass(frozen=True)
class RAGLiteConfig:
    """Immutable configuration (reference: _config.py:42-83).

    Fields are hashable so the config can key ``lru_cache``d singletons
    (engine/model factories), mirroring the reference's pattern
    (_database.py:518, _litellm.py:96-98).  ``reranker`` and
    ``search_method`` are excluded from comparison like the reference
    (_config.py:78,82).
    """

    # Storage (reference: db_url, _config.py:66)
    store_path: str = field(default_factory=_default_store_path)

    # Models (reference: llm/embedder strings, _config.py:50-64).  The
    # default embedder is the JAX package's packaged semantic encoder
    # (models/data/encoder/, 64M params, d=768 — trained by
    # scripts/train_encoder.py), mirroring the reference's real-semantic
    # default (bge-m3, _config.py:50-64) without downloads.  "hash:<dim>" is
    # the hermetic lexical featurizer, "openai:<base_url>#<model>" a remote
    # OpenAI-compatible endpoint.
    # The default LLM stays "echo" (deterministic, offline); "jax:<preset>"
    # is the port's own decoder on ``device`` (models/llm.py), the same
    # strings as the JAX package.
    llm: str = "echo"
    embedder: str = "flax:sem"

    # Chunking (reference: _config.py:67-68)
    chunk_max_size: int = 2048  # characters

    # Structured-extraction retry budget (reference: _config.py llm_max_tries)
    llm_max_tries: int = 4

    # Vector search (reference: _config.py:69-71)
    vector_search_distance_metric: DistanceMetric = "cosine"
    vector_search_multivector: bool = True
    vector_search_query_adapter: bool = True

    # Embedding mode: "auto" = late chunking when the encoder exposes
    # token-level embeddings, standard otherwise (the reference keys this
    # off llama-cpp vs API embedders, _embed.py:187-190).  "standard"
    # forces one pooled whole-chunk embedding even for token-capable
    # encoders (true single-vector stores, e.g. for A/B-ing the multivector
    # levers); "late_chunking" forces the contextual per-chunklet mode and
    # raises at embed time if the encoder cannot provide token embeddings.
    embedding_type: str = "auto"

    # Embedding storage dtype on device ("bfloat16" | "float16" | "float32"
    # | "int8").  The reference stores fp16 halfvec on Postgres
    # (_typing.py:145-175); bfloat16 keeps the same 2 bytes/val.  "int8"
    # stores symmetric per-row-quantized vectors
    # (ops/fused_scan.py:quantize_rows_int8): half the device memory of
    # bf16, scanned by the int8 kernel (csrc/bucket_scan.cu).
    embedding_dtype: str = "bfloat16"

    # Reranking (reference: _config.py:73-79)
    reranker: RerankerLike = field(default_factory=_default_reranker, compare=False)

    # Rank-fusion weight on the INCOMING retrieval order when reranking:
    # the final order is a reciprocal-rank fusion (k=60, same constant as
    # hybrid RRF) of the reranker's order with the candidates' retrieval
    # order.  0.0 = the reranker's order verbatim (reference semantics —
    # its cross-encoders replace the ordering outright, _search.py:364-397);
    # 1.0 = keep retrieval order (reranker becomes a no-op).  Intermediate
    # values hedge a weak late-interaction signal against a strong
    # retrieval signal instead of discarding the latter.
    reranker_blend: float = 0.0

    # Search method (reference: _config.py:82)
    search_method: "SearchMethod" = field(
        default_factory=_default_search_method, compare=False
    )

    # Self-query metadata filter extraction (reference: _config.py:83)
    self_query: bool = False

    #: Sentence-boundary probability model: "heuristic" (rule-based) or
    #: "learned" (models/boundary.py: the ~12k-parameter windowed MLP the
    #: JAX package ships, run as a torch module on ``device``; the SaT
    #: replacement).  Heuristic stays the default: it is tuned for
    #: English/Markdown prose, while the learned model leads on
    #: multilingual text (PARITY.md) — pick per corpus.
    sentence_boundary_model: str = "heuristic"

    # --- Device ---------------------------------------------------------
    #: Row shards of the dense index (0 = one per card): shard s on card s,
    #: round-robin over the cards there are when fewer exist (shards then
    #: share a card, as on the CPU, where they all share the one device).
    num_devices: int = 1
    #: Allow the single-stage CUDA scan kernel (ops/fused_scan.py:
    #: bucketed_max_scan) on the dense query path, for B <= 32 on indexes
    #: of at least 16 x 1024 rows.  It governs only the single-stage
    #: kernel; the two-stage int4 route has its own flag below.
    use_pallas: bool = False
    #: Two-stage int4 routing for small-batch (B <= 32) queries on large
    #: (> 131,072 rows) indexes: stage 1 scans an int4-packed copy of the
    #: rows with a CUDA kernel (half the bytes of int8), stage 2 exactly
    #: rescores the top max(256, 2 x hits) candidates against the
    #: full-precision rows.  Costs +d/2 bytes/row of device memory.
    use_int4_stage1: bool = True
    #: Torch device of the encoder and the dense index: "cuda" (default)
    #: or "cpu", where every kernel runs its plain PyTorch version.
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.vector_search_distance_metric not in ("cosine", "dot", "l2"):
            msg = f"unknown distance metric {self.vector_search_distance_metric!r}"
            raise ValueError(msg)
        if self.embedding_dtype not in ("bfloat16", "float16", "float32", "int8"):
            msg = f"unknown embedding dtype {self.embedding_dtype!r}"
            raise ValueError(msg)
        if self.sentence_boundary_model not in ("heuristic", "learned"):
            msg = f"unknown sentence boundary model {self.sentence_boundary_model!r}"
            raise ValueError(msg)
        if self.embedding_type not in ("auto", "late_chunking", "standard"):
            msg = f"unknown embedding type {self.embedding_type!r}"
            raise ValueError(msg)

    def torch_device(self) -> "torch.device":
        """The configured device, checked (see :func:`checked_device`)."""
        return checked_device(self.device)


def checked_device(name: str) -> "torch.device":
    """``torch.device(name)``, checked: "cuda" without a usable GPU raises
    instead of running on the CPU."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        msg = f"device={name!r} but CUDA is not available (pass device='cpu')"
        raise RuntimeError(msg)
    if device.type not in ("cuda", "cpu"):
        msg = f"unsupported device {name!r} (expected 'cuda' or 'cpu')"
        raise ValueError(msg)
    return device
