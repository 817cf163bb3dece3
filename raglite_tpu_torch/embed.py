"""String embedding with late chunking.

Behavioral counterpart of raglite/_embed.py:16-200.
Differences by design:

- Token counting is exact — the tokenizer is first-party, so the reference's
  sentinel-character workaround for llama.cpp tokenize overhead
  (_embed.py:21-36,72-93) is unnecessary.
- Token-level embedding runs on the card through the PyTorch encoder
  (models/encoder.py) rather than through llama.cpp's embed path.
- The golden-ratio segmentation (38.2% preamble context before each content
  window, _embed.py:94-110) and largest-remainder token→sentence allocation
  (_embed.py:122-129) are preserved exactly.
"""

from __future__ import annotations

import numpy as np

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.models.encoder import encoder_from_config
from raglite_tpu_torch.types import FloatMatrix

__all__ = [
    "embed_queries",
    "embed_strings",
    "embed_strings_with_late_chunking",
    "embedding_type",
]


def _segment_bounds(
    content_start: int, max_preamble: int, max_content: int, num_tokens: np.ndarray
) -> tuple[int, int]:
    """Pick [segment_start, segment_end) sentence indices so the preamble
    holds <= max_preamble tokens and the content <= max_content (plus any
    unused preamble budget) — reference: _embed.py:38-59."""
    backwards = np.cumsum(num_tokens[:content_start][::-1])
    preamble_len = int(np.searchsorted(backwards, max_preamble, side="right"))
    segment_start = content_start - preamble_len
    budget = max_content + (max_preamble - int(np.sum(num_tokens[segment_start:content_start])))
    forwards = np.cumsum(num_tokens[content_start:])
    content_len = max(1, int(np.searchsorted(forwards, budget, side="right")))
    return segment_start, content_start + content_len


def embed_strings_with_late_chunking(
    sentences: list[str], *, config: RAGLiteConfig | None = None
) -> FloatMatrix:
    """Embed sentences with late chunking (reference: _embed.py:16-141).

    Each sentence's embedding is the mean of its token embeddings computed
    in segment context: segments pack sentences up to the encoder window
    with a golden-ratio preamble of preceding context, and the segment's
    token embeddings are allocated to sentences by largest remainder.
    """
    config = config or RAGLiteConfig()
    if not sentences:
        return np.zeros((0, encoder_from_config(config).dim), dtype=np.float16)
    encoder = encoder_from_config(config)
    num_tokens = np.asarray(encoder.count_tokens(sentences), dtype=np.int64)
    max_tokens = encoder.max_tokens - 16
    max_preamble = round(0.382 * max_tokens)  # Golden ratio (reference: _embed.py:101-103).
    max_content = max_tokens - max_preamble
    # Build segments covering all sentences.
    segments: list[tuple[int, int, int]] = []
    content_start = 0
    while content_start < len(sentences):
        seg_start, seg_end = _segment_bounds(content_start, max_preamble, max_content, num_tokens)
        segments.append((seg_start, content_start, seg_end))
        content_start = seg_end
    # Token-level embed ALL segments (one bucketed batch program per shape
    # when the encoder supports it — the insert-throughput path),
    # then pool per sentence.
    segment_texts = ["".join(sentences[s:e]) for s, _, e in segments]
    if hasattr(encoder, "embed_token_level_batch"):
        token_embs = encoder.embed_token_level_batch(segment_texts)
    else:
        token_embs = [encoder.embed_token_level(t) for t in segment_texts]
    rows: list[np.ndarray] = []
    for (seg_start, cont_start, seg_end), token_emb in zip(segments, token_embs):
        seg_tokens = num_tokens[seg_start:seg_end]
        total = max(int(np.sum(seg_tokens)), 1)
        # Largest-remainder allocation of the actual token rows to sentences
        # (reference: _embed.py:122-129); the token count from context-free
        # tokenization can differ slightly from in-context tokenization.
        frac = token_emb.shape[0] * (seg_tokens / total)
        base = np.floor(frac).astype(np.int64)
        remainder = token_emb.shape[0] - int(np.sum(base))
        if remainder > 0:
            top = np.argsort(frac - base)[-remainder:]
            base[top] += 1
        splits = np.split(token_emb, np.cumsum(base)[:-1])
        for matrix in splits[cont_start - seg_start :]:
            if matrix.shape[0] == 0:
                rows.append(np.zeros((1, encoder.dim), dtype=np.float32))
            else:
                rows.append(matrix.mean(axis=0, keepdims=True))
    out = np.vstack(rows)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    out = out / np.maximum(norms, np.finfo(out.dtype).eps)
    return out.astype(np.float16)


def embed_strings_without_late_chunking(
    strings: list[str], *, config: RAGLiteConfig | None = None
) -> FloatMatrix:
    """Embed strings independently, mean-pooled (reference: _embed.py:144-184)."""
    config = config or RAGLiteConfig()
    encoder = encoder_from_config(config)
    if not strings:
        return np.zeros((0, encoder.dim), dtype=np.float16)
    out = encoder.embed(strings).astype(np.float64)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    out = out / np.maximum(norms, np.finfo(np.float32).eps)
    return out.astype(np.float16)


def embedding_type(*, config: RAGLiteConfig | None = None) -> str:
    """"late_chunking" when the encoder exposes token-level embeddings
    (reference keys this off llama-cpp vs API, _embed.py:187-190);
    ``config.embedding_type`` overrides ("standard" forces true
    single-vector stores, "late_chunking" requires token support)."""
    config = config or RAGLiteConfig()
    encoder = encoder_from_config(config)
    override = getattr(config, "embedding_type", "auto")
    if override == "standard":
        return "standard"
    if override == "late_chunking":
        if not encoder.supports_token_embeddings:
            msg = (
                f"embedding_type='late_chunking' requires a token-level "
                f"encoder; {config.embedder!r} has none"
            )
            raise ValueError(msg)
        return "late_chunking"
    return "late_chunking" if encoder.supports_token_embeddings else "standard"


def embed_strings(strings: list[str], *, config: RAGLiteConfig | None = None) -> FloatMatrix:
    """Embed the contiguous sentences of ONE document, choosing late chunking
    when supported (reference: _embed.py:193-200).

    The late-chunking path treats ``strings`` as consecutive sentences and
    packs them into shared encoder segments; for INDEPENDENT strings (a batch
    of queries) use :func:`embed_queries`, which never mixes contexts.
    """
    config = config or RAGLiteConfig()
    if embedding_type(config=config) == "late_chunking":
        return embed_strings_with_late_chunking(strings, config=config)
    return embed_strings_without_late_chunking(strings, config=config)


def embed_queries(strings: list[str], *, config: RAGLiteConfig | None = None) -> FloatMatrix:
    """Embed independent strings — each string is its own context.

    ``embed_strings`` assumes its input is one document's sentence stream
    (the reference only ever passes a single query through it,
    _search.py:54-56); pooling a *batch of unrelated queries* through shared
    late-chunking segments would contaminate (or zero out) their embeddings.
    For the built-in token-level encoders, late chunking of a single string
    degenerates to mean-pooled token embeddings, which is exactly the batched
    standard path — so this is numerically ``embed_strings([s])[0]`` per
    string, computed in one batched device program.
    """
    return embed_strings_without_late_chunking(strings, config=config)
