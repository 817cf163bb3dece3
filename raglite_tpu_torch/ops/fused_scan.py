"""Bucketed max/argmax scans over the index rows: CUDA C++ kernels and
their plain PyTorch versions.

Counterpart of raglite_tpu/ops/fused_scan.py.  Row ``r`` belongs to bucket
``r mod L``; a scan returns, per query and bucket, the best score
``dot(q, row) * rscale[row] + bias[row]`` over the bucket's rows and that
row's id, the lowest row winning a tie.  An exact top-k over the ``[B, L]``
buckets then costs little.  Two kernels (``csrc/``):

- ``bucketed_max_scan``: int8 rows with int32 accumulation, or bf16/f32
  rows with f32 accumulation (replaces ``_scan_kernel``);
- ``int4_bucket_scan``: int4-packed rows, two nibbles a byte, half the
  bytes of int8 (replaces ``_scan_kernel_int4``).

A wrapper launches its kernel for CUDA tensors and its plain version for
CPU tensors, and nothing else: there is no fallback from the card to the
plain version.  The integer kernels are bit-exact against the plain
versions; bf16/f32 agree to a tolerance (summation order).

The routes built on them (``fused_scan_topk``, ``int4_two_stage_block``)
can be captured into a CUDA graph (index/dense.py replays them): no host
read, no upload from the host (constants are filled on the device), outputs
and kernel scratch allocated per call (in the graph's pool under a capture),
and every launch on the current stream.
"""

from __future__ import annotations

import torch

from raglite_tpu_torch.ops import cuda_build
from raglite_tpu_torch.ops.cuda_build import INT, LONG, VOID
from raglite_tpu_torch.utils.padding import round_up as _round_up
from raglite_tpu_torch.utils.precision import full_f32_matmul

__all__ = [
    "bucketed_max_scan",
    "bucketed_max_scan_plain",
    "fused_scan_topk",
    "int4_bucket_scan",
    "int4_bucket_scan_plain",
    "int4_two_stage_block",
    "launch_counts",
    "pack_rows_int4",
    "quantize_rows_int8",
    "reset_launch_counts",
    "unpack_rows_int4",
]

#: Rows per step == number of buckets of the single-stage scan.
DEFAULT_NUM_BUCKETS = 1024
#: Stage-2 candidate count of the two-stage route.
INT4_STAGE1_CANDIDATES = 256
#: Stage-1 bucket count (one survivor per bucket: expected loss ~k(k-1)/(2L)).
INT4_NUM_BUCKETS = 4096
#: Sentinel score of invalid rows and bucket padding (finite, so the merge
#: never compares infinities); outputs turn scores <= NEG/2 back into -inf.
NEG = -1e30

#: Launches of each hand-written kernel, counted by its wrapper where it
#: launches (never by the plain versions).
launch_counts = {"bucketed_max_scan": 0, "int4_bucket_scan": 0}

_KIND = {torch.int8: 0, torch.bfloat16: 2, torch.float32: 3}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def quantize_rows_int8(x) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: (q [N, d] int8, scale [N] f32)
    with ``x ≈ q * scale[:, None]``."""
    x = torch.as_tensor(x).to(torch.float32)
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _int_dot(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Exact int8 dot products [B, N] as f32.  Every product and partial
    sum is an integer below 127*127*d < 2^24 for d <= 1040, so an f32
    matmul without TF32 is exact in any summation order; wider rows go
    through f64."""
    dtype = torch.float32 if q.shape[1] * 127 * 127 < 2**24 else torch.float64
    with full_f32_matmul():
        return (q.to(dtype) @ rows.to(dtype).T).to(torch.float32)


def _bucket_argmax(sims: torch.Tensor, num_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    b, n = sims.shape
    folded = sims.view(b, n // num_buckets, num_buckets)
    step = folded.argmax(dim=1)  # first maximal step: the lowest row wins a tie
    scores = folded.gather(1, step[:, None, :])[:, 0]
    ids = step * num_buckets + torch.arange(num_buckets, device=sims.device)[None, :]
    return scores, ids.to(torch.int32)


def bucketed_max_scan_plain(
    queries: torch.Tensor,  # [B, d] int8 (pre-quantized) or float
    rows: torch.Tensor,  # [N, d] int8, bf16 or f32; N % num_buckets == 0
    bias: torch.Tensor,  # [N] f32
    row_scale: torch.Tensor | None = None,  # [N] f32
    *,
    num_buckets: int = DEFAULT_NUM_BUCKETS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bucketed_max_scan`."""
    if rows.dtype == torch.int8:
        sims = _int_dot(queries.to(torch.int8), rows)
    else:
        q = queries.to(rows.dtype).to(torch.float32)
        with full_f32_matmul():
            sims = q @ rows.to(torch.float32).T
    if row_scale is not None:
        sims = sims * row_scale[None, :]
    sims = sims + bias[None, :]
    return _bucket_argmax(sims, num_buckets)


def _check_scan_args(name, q, rows, rscale, bias, num_buckets) -> None:
    n = rows.shape[0]
    if n == 0 or n % num_buckets or num_buckets % 16:
        msg = f"{name}: need N % num_buckets == 0 and num_buckets % 16 == 0, got {n}, {num_buckets}"
        raise ValueError(msg)
    for t in (q, rows, rscale, bias):
        if t.device != rows.device or not t.is_contiguous():
            msg = f"{name}: every operand must be contiguous on {rows.device}"
            raise ValueError(msg)
    if rscale.dtype != torch.float32 or bias.dtype != torch.float32:
        msg = f"{name}: rscale and bias must be float32"
        raise ValueError(msg)
    if rscale.shape != (n,) or bias.shape != (n,):
        msg = f"{name}: rscale and bias must be [{n}]"
        raise ValueError(msg)


#: C signatures of the kernels' launchers (csrc/*.cu): operands and shapes,
#: then outputs, scratch and the CUDA stream.  The *_scratch functions take
#: the shape arguments and return the scratch size.
_SIGNATURES = {
    "rlt_bucketed_max_scan": [INT, *[VOID] * 4, *[INT] * 4, *[VOID] * 4],
    "rlt_int4_bucket_scan": [*[VOID] * 4, *[INT] * 4, *[VOID] * 4],
}


def _launch(name: str, source: str, symbol: str, args: list, shape: list, device, num_buckets: int):
    """Allocate the outputs and the kernel's scratch (per call, so a
    captured launch owns its scratch in the graph's pool), launch ``symbol``
    of ``csrc/<source>.cu`` on the current stream (:func:`cuda_build.launch`).  ``shape`` holds the
    launcher's shape arguments (those of ``args`` after the pointers:
    [kind,] B, d, N, L)."""
    fn = cuda_build.function(source, symbol, _SIGNATURES[symbol])
    size = cuda_build.function(source, symbol + "_scratch", [INT] * len(shape), LONG)
    batch = shape[-4]
    scores = torch.empty((batch, num_buckets), dtype=torch.float32, device=device)
    ids = torch.empty((batch, num_buckets), dtype=torch.int32, device=device)
    # Per-split partial maxima (f32 scores, then i32 ids) of the split scan.
    scratch = torch.empty(2 * max(size(*shape), 1), dtype=torch.float32, device=device)
    cuda_build.launch(
        launch_counts, name, fn, [*args, scores.data_ptr(), ids.data_ptr(), scratch.data_ptr()], device
    )
    return scores, ids


def bucketed_max_scan(
    queries: torch.Tensor,
    rows: torch.Tensor,
    bias: torch.Tensor,
    row_scale: torch.Tensor | None = None,
    *,
    num_buckets: int = DEFAULT_NUM_BUCKETS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming scan: per-bucket (max score [B, L] f32, argmax row [B, L]
    i32).  Queries are int8 (pre-quantized) for int8 rows and are cast to
    the rows' dtype otherwise.  CUDA tensors launch ``csrc/bucket_scan.cu``;
    CPU tensors take :func:`bucketed_max_scan_plain`."""
    if rows.device.type == "cpu":
        return bucketed_max_scan_plain(
            queries, rows, bias, row_scale, num_buckets=num_buckets
        )
    if rows.device.type != "cuda" or rows.dtype not in _KIND or rows.ndim != 2:
        msg = f"bucketed_max_scan: unsupported rows {rows.dtype} on {rows.device}"
        raise ValueError(msg)
    n, d = rows.shape
    if rows.dtype == torch.int8:
        if queries.dtype != torch.int8:
            msg = "bucketed_max_scan: int8 rows take pre-quantized int8 queries"
            raise ValueError(msg)
        q = queries.contiguous()
    else:
        q = queries.to(rows.dtype).to(torch.float32).contiguous()
    if q.shape[1] != d:
        msg = f"bucketed_max_scan: query width {q.shape[1]} != row width {d}"
        raise ValueError(msg)
    rscale = row_scale if row_scale is not None else torch.ones(n, device=rows.device)
    _check_scan_args("bucketed_max_scan", q, rows, rscale, bias, num_buckets)
    args = [
        _KIND[rows.dtype], q.data_ptr(), rows.data_ptr(), rscale.data_ptr(),
        bias.data_ptr(), q.shape[0], d, n, num_buckets,
    ]
    return _launch(
        "bucketed_max_scan", "bucket_scan", "rlt_bucketed_max_scan", args,
        [args[0], *args[5:]], rows.device, num_buckets,
    )


def fused_scan_topk(
    rows: torch.Tensor,  # [N, d] bf16/f32 or int8 (then row_scale required)
    row_sqnorm: torch.Tensor,  # [N] f32
    valid: torch.Tensor,  # [N] bool
    queries: torch.Tensor,  # [B, d] f32
    *,
    num_hits: int,
    metric: str,
    row_scale: torch.Tensor | None = None,
    num_buckets: int = DEFAULT_NUM_BUCKETS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-stage scan + exact top-k over the buckets: (scores [B, K],
    row ids [B, K]).  Invalid rows score -inf; l2 ranks by
    ``2*q.r - ||r||^2``."""
    n, _ = rows.shape
    L = num_buckets
    np_ = _round_up(max(n, L), L)
    if np_ != n:
        pad = np_ - n
        rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
        row_sqnorm = torch.cat([row_sqnorm, row_sqnorm.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
        if row_scale is not None:
            row_scale = torch.cat([row_scale, row_scale.new_zeros(pad)])
    alpha = 2.0 if metric == "l2" else 1.0
    neg = torch.full((), NEG, dtype=torch.float32, device=rows.device)
    base = -row_sqnorm if metric == "l2" else torch.zeros_like(row_sqnorm)
    bias = torch.where(valid, base, neg)
    if rows.dtype == torch.int8:
        if row_scale is None:
            msg = "int8 rows require row_scale"
            raise ValueError(msg)
        # One query scale shared across the batch, folded into the row scale.
        q_abs = queries.abs().amax()
        q_s = torch.where(q_abs > 0, q_abs / 127.0, torch.ones_like(q_abs))
        queries = torch.clamp(torch.round(queries / q_s), -127, 127).to(torch.int8)
        row_scale = (alpha * q_s) * row_scale
    else:
        row_scale = torch.full((np_,), alpha, device=rows.device) if alpha != 1.0 else None
    bucket_scores, bucket_ids = bucketed_max_scan(
        queries, rows, bias, row_scale, num_buckets=L
    )
    top_scores, top_buckets = _topk_stable(bucket_scores, min(num_hits, L))
    top_ids = bucket_ids.gather(1, top_buckets)
    top_scores = torch.where(top_scores <= NEG / 2, float("-inf"), top_scores)
    return top_scores, top_ids


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1 with the lower index first on ties (the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none)."""
    values, index = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


# --- int4-packed stage-1 scan (two-stage routing) ---------------------------


def pack_rows_int4(
    rows: torch.Tensor, row_scale: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack rows into int4 nibbles: (packed [N, d//2] int8, scale4 [N] f32)
    with ``dequant(row) ≈ nibble * scale4``.  Low nibbles hold dims
    [0, d/2), high nibbles [d/2, d).  ``rows`` may be int8 (with its
    per-row ``row_scale``) or float; d must be even."""
    if rows.dtype == torch.int8:
        nib = torch.clamp(torch.round(rows.to(torch.float32) * (7.0 / 127.0)), -7, 7)
        scale4 = (
            row_scale * (127.0 / 7.0)
            if row_scale is not None
            else torch.full((rows.shape[0],), 127.0 / 7.0, device=rows.device)
        )
    else:
        x = rows.to(torch.float32)
        absmax = x.abs().amax(dim=1)
        scale4 = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
        nib = torch.clamp(torch.round(x / scale4[:, None]), -7, 7)
    nib = nib.to(torch.int32)
    d = rows.shape[1]
    lo = nib[:, : d // 2] & 0xF
    hi = nib[:, d // 2 :] & 0xF
    # (hi << 4) | lo lies in [0, 255]: uint8 holds it exactly, and the int8
    # view reinterprets the bits, the two's-complement wrap of the JAX cast.
    return ((hi << 4) | lo).to(torch.uint8).view(torch.int8), scale4


def unpack_rows_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, d//2] packed nibbles -> [N, d] int8 (two arithmetic shifts)."""
    p = packed.to(torch.int32)
    lo = ((p << 28) >> 28).to(torch.int8)
    hi = ((p << 24) >> 28).to(torch.int8)
    return torch.cat([lo, hi], dim=1)


def int4_bucket_scan_plain(
    q_i8: torch.Tensor,
    packed: torch.Tensor,
    rscale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_buckets: int = DEFAULT_NUM_BUCKETS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`int4_bucket_scan`."""
    return bucketed_max_scan_plain(
        q_i8, unpack_rows_int4(packed), bias, rscale, num_buckets=num_buckets
    )


def int4_bucket_scan(
    q_i8: torch.Tensor,  # [B, d] int8 (pre-quantized queries)
    packed: torch.Tensor,  # [N, d//2] int8 nibbles; N % num_buckets == 0
    rscale: torch.Tensor,  # [N] f32 effective scale
    bias: torch.Tensor,  # [N] f32
    *,
    num_buckets: int = DEFAULT_NUM_BUCKETS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming int4 scan: per-bucket (max score [B, L], argmax row [B, L]).
    CUDA tensors launch ``csrc/int4_scan.cu``; CPU tensors take
    :func:`int4_bucket_scan_plain`."""
    if packed.device.type == "cpu":
        return int4_bucket_scan_plain(q_i8, packed, rscale, bias, num_buckets=num_buckets)
    if packed.device.type != "cuda" or packed.dtype != torch.int8 or q_i8.dtype != torch.int8:
        msg = f"int4_bucket_scan: need int8 operands on CUDA, got {q_i8.dtype}, {packed.dtype}"
        raise ValueError(msg)
    n, half = packed.shape
    d = q_i8.shape[1]
    if d != 2 * half or d % 8:
        msg = f"int4_bucket_scan: query width {d} must be 2 x {half} and a multiple of 8"
        raise ValueError(msg)
    q = q_i8.contiguous()
    _check_scan_args("int4_bucket_scan", q, packed, rscale, bias, num_buckets)
    args = [
        q.data_ptr(), packed.data_ptr(), rscale.data_ptr(), bias.data_ptr(),
        q.shape[0], d, n, num_buckets,
    ]
    return _launch(
        "int4_bucket_scan", "int4_scan", "rlt_int4_bucket_scan", args,
        args[4:], packed.device, num_buckets,
    )


def int4_two_stage_block(
    packed: torch.Tensor,  # [Np, d//2] int4-packed rows (may be bucket-padded)
    scale4: torch.Tensor,  # [Np] f32
    rows: torch.Tensor,  # [N, d] full-precision rows for the rescore (N <= Np)
    row_scale: torch.Tensor | None,  # [N] f32 (int8 rows)
    row_sqnorm: torch.Tensor,  # [N] f32 (l2)
    valid: torch.Tensor,  # [N] bool
    queries: torch.Tensor,  # [B, d] f32
    *,
    num_hits: int,
    candidates: int,
    metric: str,
    num_buckets: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage block: int4 stage-1 scan, top-``candidates`` buckets,
    exact full-precision rescore, -inf sentinel restore.  Returns (scores
    [B, K], row ids [B, K] into ``rows``); masked and padding slots carry
    -inf.  Rescore gathers of bucket-padding candidates (ids in [N, Np))
    clamp to the last row; their -1e30 bias keeps them out of every result."""
    alpha = 2.0 if metric == "l2" else 1.0
    neg = torch.full((), NEG, dtype=torch.float32, device=rows.device)
    base = -row_sqnorm if metric == "l2" else torch.zeros_like(row_sqnorm)
    bias = torch.where(valid, base, neg)
    np4 = packed.shape[0]
    if bias.shape[0] != np4:
        bias = torch.cat([bias, bias.new_full((np4 - bias.shape[0],), NEG)])
    if metric == "l2":
        # l2 adds -||r||^2 to the dot, so every query shares one scale.
        q_abs = queries.abs().amax()
        q_s = torch.where(q_abs > 0, q_abs / 127.0, torch.ones_like(q_abs)).reshape(1, 1)
        kernel_scale = (alpha * q_s[0, 0]) * scale4
    else:
        # Cosine/dot: a per-query positive factor cannot change a query's
        # ranking, so queries quantize per query.
        q_abs = queries.abs().amax(dim=1, keepdim=True)
        q_s = torch.where(q_abs > 0, q_abs / 127.0, torch.ones_like(q_abs))
        kernel_scale = alpha * scale4
    q_i8 = torch.clamp(torch.round(queries / q_s), -127, 127).to(torch.int8)
    bscores, bids = int4_bucket_scan(
        q_i8, packed, kernel_scale.contiguous(), bias.contiguous(), num_buckets=num_buckets
    )
    c = min(candidates, bscores.shape[1])
    _, bpos = _topk_stable(bscores, c)
    cand_ids = bids.gather(1, bpos).to(torch.int64)  # [B, C]
    gather_ids = cand_ids.clamp(max=rows.shape[0] - 1)
    sub = rows[gather_ids]  # [B, C, d]
    if rows.dtype == torch.int8:
        # Integer products and sums below 2^24 (d <= 1040): exact in f32.
        sims2 = (sub.to(torch.float32) * q_i8.to(torch.float32)[:, None, :]).sum(-1)
        sims2 = sims2 * (alpha * q_s.reshape(-1, 1)[: sims2.shape[0]] * row_scale[gather_ids])
    else:
        q = queries.to(sub.dtype).to(torch.float32)
        with full_f32_matmul():
            sims2 = alpha * torch.bmm(sub.to(torch.float32), q[:, :, None])[:, :, 0]
    # Re-apply the bias: l2's -sqnorm, and the sentinel for masked rows.
    sims2 = sims2 + bias[cand_ids]
    sc, pos = _topk_stable(sims2, min(num_hits, c))
    sc = torch.where(sc <= NEG / 2, float("-inf"), sc)
    return sc, cand_ids.gather(1, pos)

