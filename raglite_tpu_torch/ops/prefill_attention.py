"""Grouped-query PREFILL attention (many query positions) over the resident
KV cache: a CUDA C++ kernel and its plain PyTorch version.

Counterpart of raglite_tpu/ops/prefill_attention.py (replaces
``_prefill_attn_kernel``).  Query ``t`` of row ``b`` sits at position
``offsets[b] + t`` and attends key ``s`` iff ``s <= offsets[b] + t`` and,
with a window ``w > 0``, ``s > offsets[b] + t - w``; logit soft-capping as in
the decode kernels.  The TPU version gates on a VMEM budget
(``prefill_kernel_viable``) and the JAX decoder takes its einsum where the
gate says no; the Hopper kernel runs a flash (online) softmax over key tiles
and takes every S, every REP (the heads of a group are packed into its
128-row tiles) and the head widths of :data:`HEAD_DIMS`, so there is no gate.

``gqa_prefill_attention`` launches ``csrc/prefill_attention.cu`` for CUDA
tensors and takes the plain version (:func:`~raglite_tpu_torch.ops.
decode_attention.gqa_attention_plain`) for CPU tensors, and nothing else.
The kernel forms both products with ``wgmma``; its K/V tiles come by TMA
where ``S % 8 == 0`` (what TMA asks of the cache's rows) and are staged by
the producer warpgroup's threads for any other S: one kernel, one count.  It
rounds unnormalised probabilities to bf16 and rescales as it goes, so it
agrees with the plain version to the limit of
:func:`~raglite_tpu_torch.ops.decode_attention.attention_tolerance`.
"""

from __future__ import annotations

import torch

from raglite_tpu_torch.ops import cuda_build
from raglite_tpu_torch.ops.cuda_build import FLOAT, INT, VOID
from raglite_tpu_torch.ops.decode_attention import check_operands, gqa_attention_plain

__all__ = ["gqa_prefill_attention", "launch_counts", "reset_launch_counts"]

#: Launches of the kernel, counted where it launches.
launch_counts = {"gqa_prefill_attention": 0}

_PREFILL = ("prefill_attention", "rlt_gqa_prefill", [*[VOID] * 4, *[INT] * 6, FLOAT, FLOAT, INT, VOID, VOID])
#: Head widths the kernel is built for (the output tile lives in registers).
HEAD_DIMS = (32, 64, 128, 256)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def gqa_prefill_attention(
    q: torch.Tensor,  # [B, KVH, REP, T, hd]
    k_cache: torch.Tensor,  # [B, KVH, hd, S]
    v_cache: torch.Tensor,  # [B, KVH, hd, S]
    offsets: torch.Tensor,  # [B] int: each row's cache offset (query 0)
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Multi-token grouped-query attention; returns ctx [B, KVH, REP, T, hd]
    f32.  CUDA tensors launch ``csrc/prefill_attention.cu``; CPU tensors
    take the plain version."""
    if k_cache.device.type == "cpu":
        return gqa_attention_plain(q, k_cache, v_cache, offsets, scale=scale, softcap=softcap, window=window)
    name = "gqa_prefill_attention"
    qb, off = check_operands(name, q, k_cache, v_cache, offsets)
    b, kvh, rep, t, hd = q.shape
    if hd not in HEAD_DIMS:
        msg = f"{name}: head_dim {hd} not in {HEAD_DIMS}"
        raise ValueError(msg)
    out = torch.empty((b, kvh, rep, t, hd), dtype=torch.float32, device=k_cache.device)
    args = [
        qb.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), off.data_ptr(),
        b, kvh, rep, t, hd, k_cache.shape[3], float(scale), float(softcap), int(window),
        out.data_ptr(),
    ]
    cuda_build.launch(launch_counts, name, cuda_build.function(*_PREFILL), args, k_cache.device)
    return out
