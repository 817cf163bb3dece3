"""Weighted reciprocal-rank fusion on the device (counterpart of
raglite_tpu/ops/rrf.py).

The reference fuses its vector and keyword rankings with a host-side Python
dict loop (``reciprocal_rank_fusion``, raglite/_search.py:233-254).  Here
the fusion is a few torch ops over the two candidate (ordinal, rank) sets,
so a hybrid batch costs one host fetch of the fused result.

Rank semantics match the host oracle exactly:

- the dense list arrives descending with -inf / -1 empty slots at the tail,
  so valid entries' positions are their ranks;
- the keyword list may arrive in any order and is sorted (score desc,
  ordinal asc) here, the same lexsort the host path applies, after which
  invalid (score <= 0) slots sink to the tail;
- fused score = w_d/(K+rank_d) + w_k/(K+rank_k), a chunk present in one
  list contributing only that term;
- the final top-k breaks ties toward the lower position, so dense-section
  entries precede keyword-only entries, matching the host dict's insertion
  order under Python's stable sort; slots out of range or empty come back
  as ordinal -1.

The JAX package passes packed [2, B, K] arrays (ordinals bitcast into f32);
the port passes (scores, int64 ordinals) pairs, which need no bitcast.
"""

from __future__ import annotations

import torch

__all__ = ["rrf_fuse_topk"]


def rrf_fuse_topk(
    dense: tuple[torch.Tensor, torch.Tensor],  # ([B, K1] f32, [B, K1] int) from search_chunks_device
    keyword: tuple[torch.Tensor, torch.Tensor],  # ([B, K2] f32, [B, K2] int) from bm25_topk_resident
    *,
    num_chunks: int,
    num_results: int,
    w_dense: float = 0.75,
    w_kw: float = 0.25,
    rrf_k: int = 60,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse two candidate sets with weighted RRF.  Returns (fused scores
    [B, R] f32, chunk ordinals [B, R] int64, -1 for empty slots)."""
    d_ord = dense[1].to(torch.int64)
    k_scores, k_ord = keyword[0], keyword[1].to(torch.int64)
    # Host-lexsort parity: score desc, ordinal asc (a stable sort on the
    # minor key, then on the major one); invalid slots sink.
    order = torch.sort(k_ord, dim=1, stable=True)[1]
    k_scores, k_ord = k_scores.gather(1, order), k_ord.gather(1, order)
    order = torch.sort(k_scores, dim=1, descending=True, stable=True)[1]
    k_scores, k_ord = k_scores.gather(1, order), k_ord.gather(1, order)
    # Both sides are guarded against out-of-range ordinals, not just -1
    # empties: an unguarded ordinal would be fused and then break the host's
    # id lookup.
    d_valid = (d_ord >= 0) & (d_ord < num_chunks)
    k_valid = (k_scores > 0.0) & (k_ord >= 0) & (k_ord < num_chunks)
    k1, k2 = d_ord.shape[1], k_ord.shape[1]
    device = k_scores.device
    d_contrib = torch.where(
        d_valid, (w_dense / (rrf_k + torch.arange(k1, dtype=torch.float32, device=device)))[None, :], 0.0
    )
    k_contrib = torch.where(
        k_valid, (w_kw / (rrf_k + torch.arange(k2, dtype=torch.float32, device=device)))[None, :], 0.0
    )
    # [B, K1, K2] candidate-set join: tiny (K <= ~64 per side).
    match = (d_ord[:, :, None] == k_ord[:, None, :]) & d_valid[:, :, None] & k_valid[:, None, :]
    dense_total = d_contrib + torch.where(match, k_contrib[:, None, :], 0.0).sum(dim=-1)
    k_matched = match.any(dim=1)  # [B, K2]
    fused_d = torch.where(d_valid, dense_total, float("-inf"))
    fused_k = torch.where(k_valid & ~k_matched, k_contrib, float("-inf"))
    scores_cat = torch.cat([fused_d, fused_k], dim=1)  # [B, K1+K2]
    ords_cat = torch.cat([d_ord, k_ord], dim=1)
    top_scores, pos = torch.sort(scores_cat, dim=1, descending=True, stable=True)
    r = min(num_results, k1 + k2)
    top_scores, pos = top_scores[:, :r], pos[:, :r]
    top_ords = ords_cat.gather(1, pos)
    top_ords = torch.where(torch.isneginf(top_scores), -1, top_ords)
    return top_scores, top_ords
