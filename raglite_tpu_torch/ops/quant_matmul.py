"""int8 weights for the decode loop (counterpart of
raglite_tpu/ops/quant_matmul.py, whose two matmuls are XLA programs, not
Pallas kernels: they are torch ops here).

Decode at B = 1 reads every weight once a token; int8 weights with one f32
scale per output channel halve those bytes.  Weights are ``[K, N]`` (``x @
w``), padded K to 32 and N to 128 as in the JAX package, so a JAX int8 tree
carries across unchanged.

- ``int8_matmul_w8a8``: activations quantized per row, int8 x int8 with
  int32 accumulation, rescaled ``acc * sx * s8`` in f32 (that order, as the
  JAX package).  On the card ``torch._int_mm`` takes it; it wants more than
  16 rows, so the rows are padded to a multiple of 32 with zero rows (the
  weight's bytes are read once either way), and cuBLAS's int8 GEMM wants
  the weight's reduction axis contiguous, so every ``QuantLinear`` keeps
  its ``[Kp, Np]`` blocks column-major (a transposed view of ``[Np, Kp]``
  storage; the values are the JAX package's).
- ``int8_matmul_xla`` (W8A16): the weight cast to the activations' dtype,
  one matmul, then ``* s8``.
- ``_routed_matmul``: on the card, 32 rows or fewer (decode, verify) take
  W8A8 and more (prefill) W8A16; on the CPU W8A16, as the JAX package does
  off the TPU.  ``RAGLITE_TPU_W8A8=1`` or ``=0`` forces either.
"""

from __future__ import annotations

import os

import torch

__all__ = [
    "QuantLinear",
    "QuantLinearFused",
    "dequantize_linear",
    "int8_matmul_w8a8",
    "int8_matmul_xla",
    "quant_linear_apply",
    "quant_linear_apply_fused",
    "quantize_linear_int8",
    "quantize_rows_int8",
]

#: int32 accumulation overflows past K * 127 * 127 = 2^31.
_MAX_K = (2**31) // (127 * 127)
#: Row counts up to this take W8A8 on the card (decode and verify windows).
_W8A8_MAX_ROWS = 32


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def quantize_linear_int8(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a [K, N] weight:
    ``{"q8": int8 [Kp, Np], "s8": f32 [1, Np]}`` with ``w ~ q8[:K, :N] *
    s8[0, :N]``, K padded to 32 and N to 128 (zero weights, unit scales).
    Bit-equal to the JAX package's: f32 absmax / 127, round half to even."""
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=0)
    s = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    k, n = q.shape
    if k > _MAX_K:
        msg = f"int8 matmul reduction dim {k} would overflow int32 accumulation"
        raise ValueError(msg)
    kp, np_ = _round_up(k, 32), _round_up(n, 128)
    if (kp, np_) != (k, n):
        q = torch.nn.functional.pad(q, (0, np_ - n, 0, kp - k))
        s = torch.nn.functional.pad(s, (0, np_ - n), value=1.0)
    return {"q8": q, "s8": s[None, :]}


def dequantize_linear(wq: dict, n_out: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The logical [Kp, n_out] weight (tests, interop)."""
    return (wq["q8"].to(torch.float32) * wq["s8"])[:, :n_out].to(dtype)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of activations [M, K]: ``(xq int8
    [M, K], sx f32 [M, 1])`` with ``x ~ xq * sx``."""
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax(dim=1, keepdim=True)
    sx = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def _column_major(q8: torch.Tensor) -> torch.Tensor:
    """``q8`` [Kp, Np] with its K axis contiguous (copied once if not)."""
    return q8 if q8.stride(0) == 1 else q8.T.contiguous().T


def _pad_k(x: torch.Tensor, kp: int) -> torch.Tensor:
    k = x.shape[1]
    return x if k == kp else torch.nn.functional.pad(x, (0, kp - k))


def _int8_dot(xq: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N], exact."""
    if xq.is_cuda:
        m = xq.shape[0]
        mp = _round_up(max(m, _W8A8_MAX_ROWS), _W8A8_MAX_ROWS)  # _int_mm: > 16 rows
        if mp != m:
            xq = torch.nn.functional.pad(xq, (0, 0, 0, mp - m))
        return torch._int_mm(xq, q8)[:m]
    # The CPU: an int32 product (exact, and the order of an integer sum does
    # not change it).
    return xq.to(torch.int32) @ q8.to(torch.int32)


def int8_matmul_w8a8(x: torch.Tensor, q8: torch.Tensor, s8: torch.Tensor) -> torch.Tensor:
    """``x @ (q8 * s8)`` through an int8 dot; [M, Np] f32."""
    xq, sx = quantize_rows_int8(_pad_k(x, q8.shape[0]))
    return _int8_dot(xq, q8).to(torch.float32) * sx * s8


def int8_matmul_xla(x: torch.Tensor, q8: torch.Tensor, s8: torch.Tensor) -> torch.Tensor:
    """W8A16: the weight cast to ``x``'s dtype (int8 values are exact in
    bf16), one matmul accumulated in f32, then ``* s8``; [M, Np] f32.  A
    bf16 ``x`` gets a bf16 product (rounded once, before the scale), where
    the JAX package keeps the f32 accumulator: the tests state the
    difference as a tolerance."""
    x = _pad_k(x, q8.shape[0])
    return (x @ q8.to(x.dtype)).to(torch.float32) * s8


class QuantLinear:
    """An int8 weight standing for a dense ``[K, n_out]`` matrix of the
    decoder's parameters."""

    def __init__(self, q8: torch.Tensor, s8: torch.Tensor, n_out: int) -> None:
        self.q8, self.s8, self.n_out = _column_major(q8), s8, int(n_out)

    @classmethod
    def from_dense(cls, w: torch.Tensor) -> "QuantLinear":
        wq = quantize_linear_int8(w)
        return cls(wq["q8"], wq["s8"], w.shape[1])

    def dense(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return dequantize_linear({"q8": self.q8, "s8": self.s8}, self.n_out, dtype)


class QuantLinearFused:
    """Same-input weights (q/k/v; gate/up) concatenated on the output axis
    into one int8 matmul; per-channel scales make it bit-equal to quantizing
    each part alone.  ``n_outs`` are the parts' widths."""

    def __init__(self, q8: torch.Tensor, s8: torch.Tensor, n_outs) -> None:
        self.q8, self.s8, self.n_outs = _column_major(q8), s8, tuple(int(n) for n in n_outs)

    @classmethod
    def from_dense(cls, ws: list[torch.Tensor]) -> "QuantLinearFused":
        wq = quantize_linear_int8(torch.cat(ws, dim=1))
        return cls(wq["q8"], wq["s8"], [w.shape[1] for w in ws])


def _routed_matmul(x2: torch.Tensor, q8: torch.Tensor, s8: torch.Tensor) -> torch.Tensor:
    mode = os.environ.get("RAGLITE_TPU_W8A8", "auto")
    use_w8a8 = mode == "1" or (mode != "0" and x2.is_cuda and x2.shape[0] <= _W8A8_MAX_ROWS)
    return int8_matmul_w8a8(x2, q8, s8) if use_w8a8 else int8_matmul_xla(x2, q8, s8)


def quant_linear_apply(x: torch.Tensor, w: QuantLinear) -> torch.Tensor:
    """``x @ w`` for ``x`` [..., K]; the result takes ``x``'s dtype."""
    lead = x.shape[:-1]
    y = _routed_matmul(x.reshape(-1, x.shape[-1]), w.q8, w.s8)
    return y[:, : w.n_out].reshape(*lead, w.n_out).to(x.dtype)


def quant_linear_apply_fused(x: torch.Tensor, w: QuantLinearFused) -> tuple[torch.Tensor, ...]:
    """One quantize and one int8 matmul, sliced into the parts (each [...,
    n_i] in ``x``'s dtype)."""
    lead = x.shape[:-1]
    y = _routed_matmul(x.reshape(-1, x.shape[-1]), w.q8, w.s8).to(x.dtype)
    outs, off = [], 0
    for n in w.n_outs:
        outs.append(y[:, off : off + n].reshape(*lead, n))
        off += n
    return tuple(outs)
