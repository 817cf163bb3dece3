"""Late-interaction (ColBERT-style MaxSim) scoring on the device.

Counterpart of raglite_tpu/ops/maxsim.py (plain XLA there, plain PyTorch
here; no kernel): for each candidate, score = sum over query vectors of the
max similarity to any candidate vector.  Zero rows are padding.  The
similarities run at full f32 precision (TF32 off), as the JAX package's
``Precision.HIGHEST``.

``maxsim_rank`` (the chunklet rerank, search.py:_rank_with_chunklet_maxsim)
runs :func:`maxsim_scores` from a CUDA graph on the card, keyed
``("chunklet", qm, C, m, d)`` with every axis but d rounded up to a
multiple of 8, through the device's shared ProgramGraphs
(utils/graphs.py:shared_programs; it has no owner object): the query and
candidate matrices are its inputs, copied into the key's static buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from raglite_tpu_torch.utils.graphs import shared_programs
from raglite_tpu_torch.utils.padding import round_up as _round_up
from raglite_tpu_torch.utils.precision import full_f32_matmul

__all__ = ["maxsim_rank", "maxsim_scores"]


def maxsim_scores(query_vectors: torch.Tensor, cand_vectors: torch.Tensor) -> torch.Tensor:
    """query_vectors [qm, d] f32, cand_vectors [C, m, d] f32 -> scores [C]."""
    with full_f32_matmul():
        sims = torch.einsum("qd,cmd->cqm", query_vectors, cand_vectors)
    cand_mask = (cand_vectors != 0.0).any(dim=-1)  # [C, m]
    sims = sims.masked_fill(~cand_mask[:, None, :], float("-inf"))
    best = sims.amax(dim=-1)  # [C, qm]
    best = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
    query_mask = (query_vectors != 0.0).any(dim=-1)  # [qm]
    return (best * query_mask[None, :]).sum(dim=-1)


def maxsim_rank(
    query_matrix: np.ndarray,
    candidate_matrices: list[np.ndarray],
    *,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Rank candidates by MaxSim on ``device``; returns (order, scores)
    descending, ties in input order."""
    if not candidate_matrices:
        return np.zeros(0, dtype=np.int64), np.zeros(0)
    d = query_matrix.shape[1]
    m_max = _round_up(max(m.shape[0] for m in candidate_matrices), 8)
    cands = np.zeros((_round_up(len(candidate_matrices), 8), m_max, d), dtype=np.float32)
    for i, matrix in enumerate(candidate_matrices):
        cands[i, : matrix.shape[0]] = matrix.astype(np.float32)
    q = np.zeros((_round_up(query_matrix.shape[0], 8), d), dtype=np.float32)
    q[: query_matrix.shape[0]] = query_matrix.astype(np.float32)
    key = ("chunklet", q.shape[0], cands.shape[0], m_max, d)
    scores = shared_programs(device)(key, maxsim_scores, q, cands)
    scores = scores.cpu().numpy()[: len(candidate_matrices)]
    order = np.argsort(-scores, kind="stable")
    return order, scores[order]
