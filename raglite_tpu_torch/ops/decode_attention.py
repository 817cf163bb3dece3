"""Grouped-query attention of a few query positions over the resident KV
cache: a CUDA C++ kernel and its plain PyTorch version.

Counterpart of raglite_tpu/ops/decode_attention.py.  The cache is the
decoder's storage layout ``[B, KVH, hd, S]`` (sequence minor-most); query
head ``h`` reads kv group ``h // REP``.  Key ``s`` is valid for a query at
position ``p`` iff ``s <= p`` and, with a window ``w > 0``, ``s > p - w``;
masked logits are -1e9 and the softmax runs over all of S.

- ``gqa_decode_attention``: one position per row (T = 1), at ``positions[b]``
  (replaces ``_decode_attn_kernel``);
- ``gqa_verify_attention``: a window of T <= 16 positions starting at
  ``positions[b]`` (replaces ``_verify_attn_kernel``).  Row t of a verify call
  equals the decode kernel at ``positions[b] + t`` bit for bit, so greedy
  speculation shares plain decode's attention numerics.

Both launch ``csrc/decode_attention.cu`` for CUDA tensors and take
:func:`gqa_attention_plain` for CPU tensors, and nothing else: there is no
fallback from the card to the plain version.  The kernel splits the sequence
into 128-key splits (both products on the tensor cores), merges them in the
same launch (eight splits to a chunk, then the chunks, in ascending order)
and rounds unnormalised probabilities to bf16, the plain version normalised
ones, so they agree to the limit of :func:`attention_tolerance`.  A call is
one kernel launch and one allocation (its output): the scratch and the
merge's ticket counters are kept per device and stream (:func:`_scratch_for`
says what that asks of a captured CUDA graph).
"""

from __future__ import annotations

import functools

import torch

from raglite_tpu_torch.ops import cuda_build
from raglite_tpu_torch.ops.cuda_build import FLOAT, INT, LONG, VOID
from raglite_tpu_torch.utils.precision import full_f32_matmul

__all__ = [
    "TOL_SIGMAS",
    "attention_tolerance",
    "gqa_attention_plain",
    "gqa_attention_probs_plain",
    "gqa_decode_attention",
    "gqa_verify_attention",
    "launch_counts",
    "reset_launch_counts",
]

#: Width of the statistical part of :func:`attention_tolerance`, in units of
#: ``2**-8 * sqrt(sum_s p_s**2 v_s**2)``.  With independent roundings the
#: difference has a standard deviation of about 0.6 units, so 8 units leave
#: room over millions of outputs, while dropping one live 128-key split moves
#: outputs by more (tests/test_torch_attention.py checks both on an emulation
#: of the split kernel).
TOL_SIGMAS = 8.0

#: Launches of each hand-written kernel, counted where it launches (never by
#: the plain versions).
launch_counts = {"gqa_decode_attention": 0, "gqa_verify_attention": 0}

_DECODE = ("decode_attention", "rlt_gqa_decode", [*[VOID] * 4, *[INT] * 6, FLOAT, FLOAT, INT, *[VOID] * 4])
_DECODE_SCRATCH = ("decode_attention", "rlt_gqa_decode_scratch", [INT] * 5, LONG)
_DECODE_COUNTERS = ("decode_attention", "rlt_gqa_decode_counters", [INT] * 3, LONG)
#: Head widths the kernel is built for (register-resident Q fragments, the
#: output dims split over the block's warps).
HEAD_DIMS = (32, 64, 128, 256)
#: Scratch and ticket counters per (device index, CUDA stream): the last pair
#: of a list is in use; the pairs it outgrew stay alive before it.
_scratch: dict[tuple[int, int], list[tuple[torch.Tensor, torch.Tensor]]] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def gqa_attention_probs_plain(
    q: torch.Tensor,  # [B, KVH, REP, T, hd]
    k_cache: torch.Tensor,  # [B, KVH, hd, S]
    offsets: torch.Tensor,  # [B] int: position of query 0 per row
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """The plain version's softmax probabilities [B, KVH, REP, T, S] f32
    (unrounded): q cast to the cache dtype, logits accumulated in f32 (TF32
    off), soft-capped, masked to -1e9."""
    t, s = q.shape[3], k_cache.shape[3]
    qc = q.to(k_cache.dtype).to(torch.float32)
    with full_f32_matmul():
        logits = torch.einsum("bgrtd,bgds->bgrts", qc, k_cache.to(torch.float32)) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    key = torch.arange(s, device=q.device)
    pos = offsets.to(device=q.device, dtype=torch.int64)[:, None] + torch.arange(t, device=q.device)
    mask = key[None, None, :] <= pos[:, :, None]  # [B, T, S]
    if window:
        mask &= key[None, None, :] > pos[:, :, None] - window
    logits = torch.where(mask[:, None, None], logits, -1e9)
    return torch.softmax(logits, dim=-1)


def gqa_attention_plain(
    q: torch.Tensor,  # [B, KVH, REP, T, hd]
    k_cache: torch.Tensor,  # [B, KVH, hd, S]
    v_cache: torch.Tensor,  # [B, KVH, hd, S]
    offsets: torch.Tensor,  # [B] int: position of query 0 per row
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the three attention kernels (the JAX
    decoder's einsum path): the probabilities of
    :func:`gqa_attention_probs_plain`, rounded to the cache dtype, times v
    with f32 accumulation.  Returns ctx [B, KVH, REP, T, hd] f32."""
    probs = gqa_attention_probs_plain(q, k_cache, offsets, scale=scale, softcap=softcap, window=window)
    probs = probs.to(v_cache.dtype).to(torch.float32)
    with full_f32_matmul():
        return torch.einsum("bgrts,bgds->bgrtd", probs, v_cache.to(torch.float32))


def attention_tolerance(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    offsets: torch.Tensor,
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """How far each output [B, KVH, REP, T, hd] of an attention kernel may lie
    from :func:`gqa_attention_plain` on the same inputs.

    Both round every probability p_s to bf16 (a relative error of at most
    2**-8), at different points: the kernels round unnormalised values per
    split or key tile, the plain version normalised ones.  An output then
    differs by at most ``2**-7 * sum_s p_s |v_s|``.  That bound is sound, but
    at long S it is as large as a typical output, so it could not tell a
    wrong kernel from a right one; the roundings of distinct probabilities
    are independent, and their sum stays within :data:`TOL_SIGMAS` units of
    ``2**-8 * sqrt(sum_s p_s**2 v_s**2)``.  The limit is the smaller of the
    two, plus ``1e-5 * sum_s p_s |v_s| + 1e-6`` for f32 summation order."""
    probs = gqa_attention_probs_plain(q, k_cache, offsets, scale=scale, softcap=softcap, window=window)
    v = v_cache.to(torch.float32)
    with full_f32_matmul():
        mean_abs = torch.einsum("bgrts,bgds->bgrtd", probs, v.abs())
        rms = torch.einsum("bgrts,bgds->bgrtd", probs.square_(), v.square()).sqrt_()
    return torch.minimum(2.0**-7 * mean_abs, TOL_SIGMAS * 2.0**-8 * rms) + 1e-5 * mean_abs + 1e-6


def check_operands(name, q, k_cache, v_cache, positions) -> tuple[torch.Tensor, torch.Tensor]:
    """The operands of an attention kernel, checked: a contiguous bf16 cache
    [B, KVH, hd, S] on CUDA for q [B, KVH, REP, T, hd] and positions [B] on
    its device.  Returns (q as contiguous bf16, positions as int32): the
    tensors themselves, without a copy, where they already are that."""
    if k_cache.device.type != "cuda" or k_cache.dtype != torch.bfloat16:
        msg = f"{name}: the kernel takes a bf16 cache on CUDA, got {k_cache.dtype} on {k_cache.device}"
        raise ValueError(msg)
    b, kvh, _, _, hd = q.shape
    s = k_cache.shape[3]
    if k_cache.shape != (b, kvh, hd, s) or v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        msg = f"{name}: cache shapes {tuple(k_cache.shape)}, {tuple(v_cache.shape)} do not fit q {tuple(q.shape)}"
        raise ValueError(msg)
    for x in (k_cache, v_cache):
        if x.device != k_cache.device or not x.is_contiguous():
            msg = f"{name}: the cache must be contiguous on {k_cache.device}"
            raise ValueError(msg)
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:  # the kernels copy q in 16-byte pieces
        qb = qb.clone()
    pos = positions.to(device=k_cache.device, dtype=torch.int32).contiguous()
    if qb.device != k_cache.device or pos.shape != (b,):
        msg = f"{name}: q and positions [{b}] must lie on {k_cache.device}"
        raise ValueError(msg)
    return qb, pos


@functools.lru_cache(maxsize=1024)
def _scratch_sizes(b: int, kvh: int, rows: int, hd: int, s: int) -> tuple[int, int]:
    """What one call needs: (scratch floats, ticket counters), asked of the
    library once per shape."""
    floats = cuda_build.function(*_DECODE_SCRATCH)(b, kvh, rows, hd, s)
    return floats, cuda_build.function(*_DECODE_COUNTERS)(b, kvh, s)


def _scratch_for(device: torch.device, floats: int, counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The scratch (f32, contents arbitrary) and the ticket counters (int32,
    zero between launches) of ``device``'s current stream, kept from call to
    call.  Launches of one stream run in order, so they may share both; the
    kernel leaves every counter zero.  A call that needs more gets a larger
    pair, and the pair it outgrew is kept, never freed: a CUDA graph captured
    earlier holds its addresses.  Such a graph owns the pair of its capture
    stream; it must not run at the same time as another graph captured on
    that stream or as eager calls on it (they would share the counters).
    Entries live as long as the process: a stream's handle is all that
    names it."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    pairs = _scratch.setdefault(key, [])
    if not pairs or pairs[-1][0].numel() < floats or pairs[-1][1].numel() < counters:
        held = pairs[-1] if pairs else None
        pairs.append((
            torch.empty(max(floats, held[0].numel() if held else 0), dtype=torch.float32, device=device),
            torch.zeros(max(counters, held[1].numel() if held else 0), dtype=torch.int32, device=device),
        ))
    return pairs[-1]


def _launch(name, q, k_cache, v_cache, positions, out, scale, softcap, window) -> torch.Tensor:
    """Launch ``rlt_gqa_decode`` (:func:`cuda_build.launch`) on checked
    operands into ``out`` (contiguous f32, [B, KVH, REP, T, hd] in memory
    order).  q: [B, KVH, REP, T, hd].  One kernel launch and no other device
    work: bf16 q and int32 positions on the cache's device are taken as they
    are, and the scratch is the stream's own."""
    qb, pos = check_operands(name, q, k_cache, v_cache, positions)
    b, kvh, rep, t, hd = q.shape
    s = k_cache.shape[3]
    if hd not in HEAD_DIMS:
        msg = f"{name}: head_dim {hd} not in {HEAD_DIMS}"
        raise ValueError(msg)
    rows = rep * t
    scratch, counters = _scratch_for(k_cache.device, *_scratch_sizes(b, kvh, rows, hd, s))
    args = [
        qb.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        b, kvh, rows, t, hd, s, float(scale), float(softcap), int(window),
        out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
    ]
    try:
        cuda_build.launch(launch_counts, name, cuda_build.function(*_DECODE), args, k_cache.device)
    except RuntimeError:
        counters.zero_()  # a launch that did not run to its end may leave tickets behind
        raise
    return out


def gqa_decode_attention(
    q: torch.Tensor,  # [B, KVH, REP, hd]
    k_cache: torch.Tensor,  # [B, KVH, hd, S]
    v_cache: torch.Tensor,  # [B, KVH, hd, S]
    positions: torch.Tensor,  # [B] int: this token's position per row
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """One-token grouped-query attention; returns ctx [B, KVH, REP, hd] f32.
    CUDA tensors launch ``csrc/decode_attention.cu``; CPU tensors take
    :func:`gqa_attention_plain`."""
    q5 = q[:, :, :, None, :]
    if k_cache.device.type == "cpu":
        return gqa_attention_plain(q5, k_cache, v_cache, positions, scale=scale, softcap=softcap, window=window)[:, :, :, 0, :]
    out = torch.empty(q.shape, dtype=torch.float32, device=k_cache.device)  # the call's one allocation
    return _launch("gqa_decode_attention", q5, k_cache, v_cache, positions, out, scale, softcap, window)


def gqa_verify_attention(
    q: torch.Tensor,  # [B, KVH, REP, T, hd]
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # [B] int: FIRST window position per row
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Small-T grouped-query attention for speculative verify windows:
    per window position t, exactly the decode kernel's arithmetic at
    position ``positions[b] + t``.  Returns ctx [B, KVH, REP, T, hd] f32.
    CUDA tensors launch ``csrc/decode_attention.cu``; CPU tensors take
    :func:`gqa_attention_plain`."""
    if k_cache.device.type == "cpu":
        return gqa_attention_plain(q, k_cache, v_cache, positions, scale=scale, softcap=softcap, window=window)
    out = torch.empty(q.shape, dtype=torch.float32, device=k_cache.device)  # the call's one allocation
    return _launch("gqa_verify_attention", q, k_cache, v_cache, positions, out, scale, softcap, window)
