"""Sharded index search: per-shard top-k and a cross-shard merge
(counterpart of raglite_tpu/parallel/sharded.py).

The index rows split into contiguous row shards, one per device of a
device list (parallel/mesh.py); each shard runs the port's single-device
search over its rows, turns its local row ids into global ids, and only its
``[B, k]`` winners reach the merge on the first device, then, with a
process ``group``, cross between ranks.  Every route merges through
:func:`merge_winners`: a stable top-k over the winners side by side in
shard (and rank) order, so equal scores keep the lower global id first, as
``jax.lax.top_k`` over the JAX package's all-gather does.

Array arguments are lists with one tensor per shard, each on its shard's
device (:func:`raglite_tpu_torch.parallel.mesh.split_rows` makes them from
one tensor), where the JAX package takes one array sharded over its mesh.
Every shard of a call holds the same number of rows, as in the JAX
package; across ranks, rank r's global ids start at r times its own row
count.

With one shard and no process group, ``sharded_int4_two_stage`` and
``sharded_topk_search`` can be captured into a CUDA graph (index/dense.py
replays them): no host read, no copy between devices, and the merge of one
shard's winners returns them without a launch.

One difference from the JAX package: above 131,072 rows a shard,
``sharded_topk_search`` there takes ``approx_max_k``; PyTorch has none, so
the port's shard scan stays exact, as its single-device dense route does.
"""

from __future__ import annotations

import torch

from raglite_tpu_torch.ops.bm25 import bm25_topk_resident
from raglite_tpu_torch.ops.fused_scan import _topk_stable, int4_two_stage_block
from raglite_tpu_torch.parallel.mesh import gather_winners

__all__ = ["merge_winners", "sharded_bm25_topk", "sharded_int4_two_stage", "sharded_topk_search"]


def _rank_and_size(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def merge_winners(
    scores: list[torch.Tensor], ids: list[torch.Tensor], num_hits: int, group=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-``num_hits`` of the shards' winners (each [B, k], global
    ids, scores descending with the lower id first on ties): (scores [B,
    K], ids [B, K] int64) on the first shard's device.  The shards merge
    first; with ``group`` the ranks' merged [B, K] winners then merge.
    One shard's winners are already its merge (a stable top-k of sorted
    winners keeps them as they are) and return without another launch."""
    if len(scores) == 1 and group is None and scores[0].shape[1] <= num_hits:
        return scores[0], ids[0].to(torch.int64)
    s_all, i_all = gather_winners(scores, ids)
    s_best, pos = _topk_stable(s_all, min(num_hits, s_all.shape[1]))
    i_best = i_all.gather(1, pos)
    if group is None:
        return s_best, i_best
    s_all, i_all = gather_winners([s_best], [i_best], group)
    s_best, pos = _topk_stable(s_all, min(num_hits, s_all.shape[1]))
    return s_best, i_all.gather(1, pos)


def _as_shards(x, devices: list[torch.device]) -> list:
    """A list of per-shard tensors, checked against the device list; an
    absent operand (None) as None for every shard."""
    if x is None:
        return [None] * len(devices)
    if len(x) != len(devices):
        msg = f"{len(x)} shards for {len(devices)} devices"
        raise ValueError(msg)
    return list(x)


def sharded_topk_search(
    rows,  # [N, d] per shard, storage dtype
    row_sqnorm,  # [N] f32
    valid,  # [N] bool
    queries: torch.Tensor,  # [B, d] f32, on any device
    row_scale=None,  # [N] f32 (int8 rows)
    *,
    num_hits: int,
    metric: str,
    devices: list[torch.device],
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-``num_hits`` rows per query across every shard: each
    shard's exact scan (index/dense.py:_dense_search) and local top-k, then
    :func:`merge_winners`.  Returns (scores [B, K], global row ids [B, K])
    on the first device; masked rows score -inf."""
    from raglite_tpu_torch.index.dense import _dense_search

    rows, row_sqnorm, valid, row_scale = (
        _as_shards(x, devices) for x in (rows, row_sqnorm, valid, row_scale)
    )
    rank, _ = _rank_and_size(group)
    per_shard = rows[0].shape[0]
    base = rank * per_shard * len(devices)
    scores, ids = [], []
    for s, dev in enumerate(devices):  # every shard enqueued before any merge
        sc, idx = _dense_search(
            rows[s], row_sqnorm[s], valid[s], queries.to(dev), row_scale[s],
            num_hits=min(num_hits, per_shard), metric=metric,
        )
        scores.append(sc)
        ids.append(idx + (base + s * per_shard))
    return merge_winners(scores, ids, num_hits, group)


def sharded_int4_two_stage(
    packed,  # [Np, d//2] int4-packed rows per shard
    scale4,  # [Np] f32
    rows,  # [Np, d] full-precision rows (rescore)
    row_scale,  # [Np] f32 (int8 rows) or None
    row_sqnorm,  # [Np] f32 (l2)
    valid,  # [Np] bool
    queries: torch.Tensor,  # [B, d] f32 (adapter pre-applied)
    *,
    num_hits: int,
    candidates: int,
    metric: str,
    devices: list[torch.device],
    num_buckets: int = 4096,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 two-stage route on every shard: the int4 scan
    (``int4_bucket_scan``, the CUDA kernel on a card) and the exact rescore
    of its own ``candidates`` over the shard's rows, then
    :func:`merge_winners`.  Shard row counts must be multiples of
    ``num_buckets`` (DenseIndex rounds its capacity to ``INT4_NUM_BUCKETS``
    x the shard count); one shard's packed copy may pad past its rows to
    whole buckets, as ``int4_two_stage_block``'s may.  Returns (scores [B,
    K], global row ids [B, K])."""
    packed, scale4, rows, row_scale, row_sqnorm, valid = (
        _as_shards(x, devices) for x in (packed, scale4, rows, row_scale, row_sqnorm, valid)
    )
    per_shard = rows[0].shape[0]
    whole = packed[0].shape[0] == per_shard and per_shard % num_buckets == 0
    padded = len(devices) == 1 and packed[0].shape[0] % num_buckets == 0 and packed[0].shape[0] >= per_shard
    if not (whole or padded):
        msg = f"sharded_int4_two_stage: shards of {per_shard} rows must be whole {num_buckets}-row buckets"
        raise ValueError(msg)
    rank, _ = _rank_and_size(group)
    base = rank * per_shard * len(devices)
    scores, ids = [], []
    for s, dev in enumerate(devices):
        sc, idx = int4_two_stage_block(
            packed[s], scale4[s], rows[s], row_scale[s], row_sqnorm[s], valid[s], queries.to(dev),
            num_hits=num_hits, candidates=candidates, metric=metric, num_buckets=num_buckets,
        )
        scores.append(sc)
        ids.append(idx + (base + s * per_shard))
    return merge_winners(scores, ids, num_hits, group)


def sharded_bm25_topk(
    offsets,  # [V+1] int64 CSR offsets per shard
    post_chunk,  # [P+pad] int32 LOCAL chunk ordinals per shard
    post_w,  # [P+pad] f32 precomputed (global) Okapi weights per shard
    mask,  # [C] bool per-shard chunk mask, or a [1] dummy per shard
    term_ids: torch.Tensor,  # [B, T] query term ids (pad -1)
    *,
    chunks_per_shard: int,
    lcap: int,
    num_hits: int,
    devices: list[torch.device],
    masked: bool = False,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keyword BM25 over postings partitioned by chunk range: shard s owns
    chunks [s·C, (s+1)·C) and scores them with the resident program
    (ops/bm25.py:bm25_topk_resident); every posting carries its GLOBAL
    Okapi weight, so the merge equals the single-device program exactly.
    Returns (scores [B, K] f32, global ordinals [B, K] int64); slots with no
    positive score hold ordinal S·C (times the ranks)."""
    rank, world = _rank_and_size(group)
    c = chunks_per_shard
    base = rank * c * len(devices)
    total_pad = world * c * len(devices)
    scores, ids = [], []
    for s, dev in enumerate(devices):
        sc, ords = bm25_topk_resident(
            offsets[s], post_chunk[s], post_w[s], mask[s], term_ids.to(dev),
            num_chunks=c, lcap=lcap, num_hits=num_hits, masked=masked,
        )
        ok = (ords < c) & (sc > 0.0)
        scores.append(torch.where(ok, sc, -1.0))
        ids.append(torch.where(ok, ords + (base + s * c), total_pad))
    s_best, i_best = merge_winners(scores, ids, num_hits, group)
    return s_best, torch.where(s_best > 0.0, i_best, total_pad)
