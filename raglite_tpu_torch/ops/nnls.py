"""Batched nonnegative least squares on the device (counterpart of
raglite_tpu/ops/nnls.py).

For each eval the query adapter needs the dual NNLS problem
``min_mu 0.5 ||q + D^T mu||^2 s.t. mu >= 0`` and its primal target
``t* = q + D^T mu*``.  It is solved as in the JAX package: FISTA (projected
gradient with momentum onto the nonnegative orthant) for a fixed 200
iterations, the step 1 / ||D D^T||_2 from 16 power iterations, over a batch
of evals whose constraint rows are padded with zero rows.  Where the JAX
package vmaps one XLA program, this is a chain of torch ops on the
batch: every product is a ``torch.bmm`` over the [B, m, d] pair matrices,
in full f32 (TF32 off: it would change the iterates).  On the CPU the same
ops run, so the function is its own plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from raglite_tpu_torch.utils.precision import full_f32_matmul

__all__ = ["NNLS_ITERS", "batched_query_targets", "nnls_dual_target", "query_targets_from_rows"]

#: FISTA iterations of the adapter's solve (the JAX package's default).
NNLS_ITERS = 200


def _power_iter_sq_norm(D: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """||D D^T||_2 per batch entry [B] (the gradient's Lipschitz constant)
    by power iteration on D^T D, floored at 1e-9."""
    d = D.shape[2]
    v = torch.full((D.shape[0], d, 1), 1.0 / np.sqrt(np.float32(d)), dtype=D.dtype, device=D.device)
    for _ in range(iters):
        w = torch.bmm(D.transpose(1, 2), torch.bmm(D, v))
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True), min=1e-12)
    return torch.clamp(torch.linalg.vector_norm(torch.bmm(D, v), dim=1)[:, 0] ** 2, min=1e-9)


def nnls_dual_target(q: torch.Tensor, D: torch.Tensor, *, iters: int = NNLS_ITERS) -> torch.Tensor:
    """Targets ``q + D^T mu*`` [B, d] for queries q [B, d] and constraint rows
    D [B, m, d] (zero rows are padding: their gradients vanish, so their
    multipliers stay at zero)."""
    with full_f32_matmul():
        step = (1.0 / _power_iter_sq_norm(D))[:, None, None]
        q3 = q[:, None, :]  # [B, 1, d]
        mu = torch.zeros((D.shape[0], D.shape[1], 1), dtype=q.dtype, device=q.device)
        y = mu
        # The momentum weights are the same for every eval: f32 scalars on
        # the host, computed as the JAX program computes them.
        t_k = np.float32(1.0)
        for _ in range(iters):
            grad = torch.bmm(D, (q3 + torch.bmm(y.transpose(1, 2), D)).transpose(1, 2))
            mu_next = torch.clamp(y - step * grad, min=0.0)
            t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t_k * t_k))
            y = mu_next + float((t_k - np.float32(1.0)) / t_next) * (mu_next - mu)
            mu, t_k = mu_next, t_next
        return q + torch.bmm(mu.transpose(1, 2), D)[:, 0, :]


def batched_query_targets(
    qs: torch.Tensor,  # [B, d] query embeddings
    pos: torch.Tensor,  # [B, Pmax, d] positive chunk embeddings (zero rows = pad)
    neg: torch.Tensor,  # [B, Nmax, d] negative chunk embeddings (zero rows = pad)
    pos_mask: torch.Tensor,  # [B, Pmax] bool
    neg_mask: torch.Tensor,  # [B, Nmax] bool
    *,
    alpha: float = 0.05,
    iters: int = NNLS_ITERS,
) -> torch.Tensor:
    """Optimal target vectors [B, d] for a batch of evals.

    The constraint rows are all (positive, negative) pairs
    ``D[b, m, n] = p_m - (1 + alpha) * n_n``, zero where either side is
    padding; D is [B, Pmax * Nmax, d] f32 (315 MB at B = 64, P = N = 40,
    d = 768), read twice an iteration."""
    b, p, d = pos.shape
    D = pos[:, :, None, :] - (1.0 + alpha) * neg[:, None, :, :]  # [B, P, N, d]
    pair_mask = (pos_mask[:, :, None] & neg_mask[:, None, :]).to(qs.dtype)
    D = (D * pair_mask[..., None]).reshape(b, -1, d)
    return nnls_dual_target(qs, D, iters=iters)


def query_targets_from_rows(
    qs: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor, *, alpha: float = 0.05, iters: int = NNLS_ITERS
) -> torch.Tensor:
    """:func:`batched_query_targets` with each side's mask read from its
    zero rows (padding) on the device: the adapter's program, three tensors
    in (query_adapter.py:_nnls_targets)."""
    return batched_query_targets(
        qs, pos, neg, (pos != 0.0).any(dim=-1), (neg != 0.0).any(dim=-1), alpha=alpha, iters=iters
    )
