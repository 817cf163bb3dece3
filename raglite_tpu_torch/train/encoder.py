"""Train the semantic text encoder on the card (counterpart of
scripts/train_encoder.py).

The same phases, losses, optimizers and host batch draws as the script,
over the port's ``EncoderModel``:

  tokenizer    train a byte-level BPE tokenizer of the size's vocabulary on
               ``--corpus/train.jsonl`` into ``--workdir/tokenizer.json``
               when that file is absent (train/bpe.py: the file
               ``tokenizers``' BpeTrainer writes);
  tokens       tokenize ``--corpus/train.jsonl`` into ``tokens.npz``
               (train/corpus.py; ``python -m raglite_tpu_torch.train.corpus``
               builds the corpus);
  mlm          masked-language-model pretraining, 15 % masking with the
               80/10/10 corruption split, tied f32 logits over all
               positions, the collapse guard before each save;
  contrastive  Contriever-style independent crops (a passage-like and a
               query-like span of one document), in-batch negatives,
               symmetric InfoNCE at temperature 0.05, each tower
               rematerialised (``torch.utils.checkpoint``);
  hardneg      InfoNCE over [B, 2B] with one mined near-miss passage per
               anchor (mining: one crop a document embedded by the current
               model, [512, n] similarity tiles, top 8 with self excluded);
  maxsim       the mean-pool head and token-level MaxSim trained jointly
               (``dense_weight * dense + tok``) against mined negatives;
  export       ``encoder.npz`` (f16 matrices), ``tokenizer.json`` and
               ``config.json`` into ``--out``, which loads as
               ``embedder="flax:<out>"``.

The tokenizer of the token cache and the export: ``--tokenizer`` where it
is given, else the workdir's trained ``tokenizer.json`` where it exists,
else the packaged encoder's.  ``--phase all`` runs tokenizer, tokens, mlm,
contrastive, hardneg, maxsim and export in that order.

Phases chain through ``--workdir`` files (``mlm.npz`` -> ``contrastive.npz``
-> ``hardneg.npz`` -> ``maxsim.npz``) in the JAX package's npz layout, so
either package reads the other's.  The loss casts every >= 2-D master
tensor to bf16 and keeps vectors in f32; every linear layer and the tied
logits multiply bf16 x bf16 -> f32 on tensor cores (``matmul_f32``), the
f32 Adam state stays in f32 (train/optim.py).  The loop reads the loss
only at its print interval: the card runs ahead of the host.  The train
steps run eagerly (no CUDA graph).

Usage:
  python -m raglite_tpu_torch.train.encoder --phase all
  python -m raglite_tpu_torch.train.encoder --phase mlm --steps 20000
  python -m raglite_tpu_torch.train.encoder --phase contrastive --device cpu --steps 10 --batch 8
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from collections.abc import Callable
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from raglite_tpu_torch.models.encoder import PACKAGED_ENCODER_DIR
from raglite_tpu_torch.models.transformer import (
    EncoderModel, load_npz_encoder, matmul_f32, params_from_jax, save_npz_encoder, state_to_jax,
)
from raglite_tpu_torch.train import bpe, optim
from raglite_tpu_torch.train.corpus import DATA, DEFAULT_CORPUS, build_token_cache, load_tokens
from raglite_tpu_torch.utils.precision import full_f32_matmul

__all__ = [
    "SIZES", "CropBatches", "MLMBatches", "NegativeBatches", "Run", "Trainable", "contrastive_loss",
    "hardneg_loss", "init_params", "main", "maxsim_loss", "mine_hard_negatives", "mlm_loss", "nearest",
    "run_contrastive", "run_export", "run_hardneg", "run_maxsim", "run_mlm", "step_flops", "train_step",
]

#: The script's model sizes (``base`` is the packaged ``flax:sem``).
SIZES = {
    "small": dict(layers=4, d_model=512, heads=8, d_ff=2048, vocab=8192, max_len=512),
    "base": dict(layers=8, d_model=768, heads=12, d_ff=3072, vocab=16384, max_len=512),
    # The post-LN stack is unstable at this depth at the base recipe's 4e-4
    # peak, so `large` carries its own MLM optimizer knobs.
    "large": dict(
        layers=12, d_model=1024, heads=16, d_ff=4096, vocab=16384, max_len=512,
        mlm_lr=1.5e-4, mlm_warmup=2500, clip=0.5,
    ),
}
PAD, BOS, EOS, MASK = 0, 1, 2, 3
#: Training sequence length (``--seq``) and the query towers' padded length.
SEQ, QSEQ = 128, 64
TEMP = 0.05
#: Mined neighbours a document (hard negatives are drawn from them).
MINE_K = 8
#: The packaged tokenizer (its ids are the ones ``tokenizers`` gives).
PACKAGED_TOKENIZER = PACKAGED_ENCODER_DIR / "tokenizer.json"


@dataclass
class Run:
    """What every phase shares: the model size, the files and the device."""

    cfg: dict
    workdir: Path
    device: torch.device
    corpus: Path = DEFAULT_CORPUS
    tokenizer: Path = PACKAGED_TOKENIZER
    seq: int = SEQ
    qseq: int = QSEQ
    compute_dtype: torch.dtype = torch.bfloat16
    log: Callable[[str], None] = field(default=lambda line: print(line, flush=True))  # noqa: T201

    def tokens(self) -> tuple[np.ndarray, np.ndarray]:
        return load_tokens(self.workdir / "tokens.npz")


# --- Parameters ---------------------------------------------------------------


def init_params(cfg: dict, *, seed: int = 0) -> dict[str, torch.Tensor]:
    """A seeded f32 init of the port's state (the JAX package's
    ``init_encoder_params`` distributions from a ``torch.Generator``: 0.02
    normal embeddings, normal / sqrt(fan_in) matrices, unit LayerNorms, zero
    biases, a final LayerNorm)."""
    g = torch.Generator().manual_seed(seed)
    d, ff = cfg["d_model"], cfg["d_ff"]

    def normal(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=g)

    state = {
        "tok_emb.weight": normal(cfg["vocab"], d) * 0.02,
        "pos_emb.weight": normal(cfg["max_len"], d) * 0.02,
        "emb_ln.weight": torch.ones(d), "emb_ln.bias": torch.zeros(d),
    }
    for i in range(cfg["layers"]):
        for name, (d_in, d_out) in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)),
                                    ("ff1", (d, ff)), ("ff2", (ff, d))):
            state[f"layers.{i}.{name}.weight"] = normal(d_out, d_in) / np.sqrt(d_in)
            state[f"layers.{i}.{name}.bias"] = torch.zeros(d_out)
        for name in ("attn_ln", "mlp_ln"):
            state[f"layers.{i}.{name}.weight"] = torch.ones(d)
            state[f"layers.{i}.{name}.bias"] = torch.zeros(d)
    state["final_ln.weight"] = torch.ones(d)
    state["final_ln.bias"] = torch.zeros(d)
    return state


def load_params(path: Path) -> tuple[dict, dict[str, torch.Tensor]]:
    """(cfg, f32 state) of an ``encoder.npz`` of either package."""
    cfg, params, _ = load_npz_encoder(str(path))
    return cfg, params_from_jax(params, dtype=torch.float32)


def save_params(path: Path, state: dict[str, torch.Tensor], cfg: dict) -> None:
    """A phase's f32 checkpoint in the workdir (members stored, not deflated)."""
    save_npz_encoder(str(path), state_to_jax(state), cfg, compress=False)


class Trainable:
    """f32 master tensors (leaves that require grad) on the device, and the
    training forward over their casts: ``model(p, ids)`` runs
    ``EncoderModel(trainable=True)`` through ``torch.func.functional_call``
    with ``p = self.cast()`` (>= 2-D tensors in the compute dtype, vectors
    f32)."""

    def __init__(self, cfg: dict, state: dict[str, torch.Tensor], device: torch.device, compute_dtype: torch.dtype):
        self.compute_dtype = compute_dtype
        self.masters = {
            k: v.detach().to(device=device, dtype=torch.float32, copy=True).requires_grad_(True) for k, v in state.items()
        }
        with torch.device("meta"):
            self.model = EncoderModel(cfg, dtype=compute_dtype, final_ln="final_ln.weight" in state, trainable=True)

    @property
    def leaves(self) -> list[torch.Tensor]:
        return list(self.masters.values())

    def cast(self) -> dict[str, torch.Tensor]:
        return {k: v.to(self.compute_dtype) if v.ndim >= 2 else v for k, v in self.masters.items()}

    def hidden(self, p: dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
        """[B, T] ids -> [B, T, d] f32 hidden states (``apply_tokens``)."""
        return torch.func.functional_call(self.model, p, (ids, ids != PAD))

    def state(self) -> dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.masters.items()}


# --- Losses (the script's loss_fn of each phase, line for line) ----------------


def _pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over tokens, L2-normalised ([B, d] f32)."""
    pooled = (hidden * mask[:, :, None]).sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp(min=1)
    return pooled / torch.linalg.vector_norm(pooled, dim=1, keepdim=True).clamp(min=1e-6)


def _embed(net: Trainable, p: dict, ids: torch.Tensor) -> torch.Tensor:
    return _pool(net.hidden(p, ids), ids != PAD)


def _tower(fn, *args):
    """``jax.checkpoint`` of one tower: keep only its outputs between
    towers and recompute its activations in the backward."""
    return checkpoint(fn, *args, use_reentrant=False)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return optim.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


def mlm_loss(net: Trainable, p: dict, ids: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor):
    hidden = net.hidden(p, ids)
    emb = p["tok_emb.weight"]
    logits = matmul_f32(hidden.to(emb.dtype), emb)  # [B, T, V] f32
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None].to(torch.int64))[..., 0]
    return (nll * weights).sum() / weights.sum().clamp(min=1.0)


def contrastive_loss(net: Trainable, p: dict, a_ids: torch.Tensor, b_ids: torch.Tensor):
    za = _tower(_embed, net, p, a_ids)
    zb = _tower(_embed, net, p, b_ids)
    logits = za @ zb.T / TEMP
    labels = torch.arange(za.shape[0], device=za.device)
    return 0.5 * (_ce(logits, labels) + _ce(logits.T, labels))


def hardneg_loss(net: Trainable, p: dict, q_ids, pos_ids, neg_ids):
    zq = _tower(_embed, net, p, q_ids)  # [B, d]
    zp = _tower(_embed, net, p, pos_ids)  # [B, d]
    zn = _tower(_embed, net, p, neg_ids)  # [B, d] mined hard negatives
    logits = zq @ torch.cat([zp, zn]).T / TEMP  # [B, 2B]
    labels = torch.arange(zq.shape[0], device=zq.device)
    # The reverse direction over the positive block keeps phase 2's
    # symmetric objective.
    return 0.5 * (_ce(logits, labels) + _ce((zp @ zq.T) / TEMP, labels))


def _tokens_and_pool(net: Trainable, p: dict, ids: torch.Tensor):
    """L2-normalised token states [B, T, d] (bf16) and the L2 mean pool."""
    mask = ids != PAD
    hidden = net.hidden(p, ids)
    pooled = _pool(hidden, mask)
    tok = hidden / torch.linalg.vector_norm(hidden, dim=-1, keepdim=True).clamp(min=1e-6)
    tok = tok * mask[:, :, None]
    return tok.to(torch.bfloat16), pooled


def maxsim_matrix(qt: torch.Tensor, q_mask: torch.Tensor, dt: torch.Tensor, d_mask: torch.Tensor) -> torch.Tensor:
    """[B, C] mean-over-query-token MaxSim of query tokens [B, Tq, d] and
    candidate tokens [C, Td, d] (the inference scoring rule up to a
    per-query positive scale, which ranking is invariant to)."""
    b, tq, d = qt.shape
    c, td, _ = dt.shape
    sims = matmul_f32(qt.reshape(-1, d), dt.reshape(-1, d)).view(b, tq, c, td).permute(0, 2, 1, 3)
    sims = sims.masked_fill(~d_mask[None, :, None, :], float("-inf"))
    best = sims.amax(dim=-1)  # [B, C, Tq]
    best = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
    denom = q_mask.sum(dim=1).clamp(min=1.0)  # [B]
    return torch.einsum("bcq,bq->bc", best, q_mask) / denom[:, None]


def maxsim_loss(net: Trainable, p: dict, q_ids, pos_ids, neg_ids, *, dense_weight: float = 1.0):
    """``dense_weight * dense + tok`` and the two parts."""
    qt, zq = _tower(_tokens_and_pool, net, p, q_ids)
    pt, zp = _tower(_tokens_and_pool, net, p, pos_ids)
    nt, zn = _tower(_tokens_and_pool, net, p, neg_ids)
    labels = torch.arange(zq.shape[0], device=zq.device)
    # Dense head: phase 3's objective (keeps retrieval quality).
    dense_logits = zq @ torch.cat([zp, zn]).T / TEMP
    loss_dense = 0.5 * (_ce(dense_logits, labels) + _ce((zp @ zq.T) / TEMP, labels))
    # Token head: InfoNCE over the MaxSim score against the same positives
    # and mined hard negatives.
    q_mask = (q_ids != PAD).to(torch.float32)
    d_mask = torch.cat([pos_ids, neg_ids]) != PAD
    ms_logits = maxsim_matrix(qt, q_mask, torch.cat([pt, nt]), d_mask) / TEMP
    loss_tok = _ce(ms_logits, labels)
    return dense_weight * loss_dense + loss_tok, (loss_dense, loss_tok)


# --- Host batch makers (the script's draws, number for number) -----------------


def _doc_sampler(flat, offsets, rng, min_len=24):
    """Yield random document (start, length) with at least min_len tokens."""
    lengths = np.diff(offsets)
    ok = np.flatnonzero(lengths >= min_len)
    while True:
        idx = ok[rng.integers(0, ok.size)]
        yield offsets[idx], lengths[idx]


class MLMBatches:
    """``run_mlm``'s ``make_batch``: (ids, labels, weights) [B, SEQ]."""

    def __init__(self, flat, offsets, batch: int, seq: int, vocab: int, seed: int = 0) -> None:
        self.flat, self.batch, self.seq, self.vocab = flat, batch, seq, vocab
        self.rng = np.random.default_rng(seed)
        self.sampler = _doc_sampler(flat, offsets, self.rng, min_len=seq // 2)

    def __call__(self):
        rng, seq = self.rng, self.seq
        ids = np.full((self.batch, seq), PAD, np.int32)
        labels = np.zeros((self.batch, seq), np.int32)
        weights = np.zeros((self.batch, seq), np.float32)
        for b in range(self.batch):
            start, length = next(self.sampler)
            take = min(length, seq)
            off = start + (rng.integers(0, length - take + 1) if length > take else 0)
            row = self.flat[off : off + take].astype(np.int32)
            # 15% masking, 80/10/10 corruption.
            n_mask = max(1, int(0.15 * take))
            pos = rng.choice(take, size=n_mask, replace=False)
            labels[b, pos] = row[pos]
            weights[b, pos] = 1.0
            corrupted = row.copy()
            split = rng.random(n_mask)
            corrupted[pos[split < 0.8]] = MASK
            rand_pos = pos[(split >= 0.8) & (split < 0.9)]
            corrupted[rand_pos] = rng.integers(4, self.vocab, rand_pos.size)
            ids[b, :take] = corrupted
        return ids, labels, weights


class CropBatches:
    """``run_contrastive``'s ``make_batch``: a passage-like crop [B, SEQ]
    and a query-like crop [B, QSEQ] of each sampled document."""

    def __init__(self, flat, offsets, batch: int, seq: int, qseq: int, seed: int = 1) -> None:
        self.flat, self.batch, self.seq, self.qseq = flat, batch, seq, qseq
        self.rng = np.random.default_rng(seed)
        self.sampler = _doc_sampler(flat, offsets, self.rng, min_len=48)

    def crop(self, start, length, lo, hi):
        size = int(self.rng.integers(lo, min(hi, length) + 1))
        off = int(self.rng.integers(0, length - size + 1))
        return self.flat[start + off : start + off + size].astype(np.int32)

    def __call__(self):
        a = np.full((self.batch, self.seq), PAD, np.int32)
        b = np.full((self.batch, self.qseq), PAD, np.int32)
        for i in range(self.batch):
            start, length = next(self.sampler)
            ca = self.crop(start, length, 32, self.seq)
            cb = self.crop(start, length, 8, min(48, self.qseq))
            a[i, : ca.size] = ca
            b[i, : cb.size] = cb
        return a, b


class NegativeBatches:
    """``run_hardneg``'s and ``run_maxsim``'s ``make_batch`` (seeds 2 and
    3): a query crop [B, QSEQ], a passage crop of the same document and a
    passage crop of one of its mined neighbours [B, SEQ]."""

    def __init__(self, flat, offsets, ok_docs, neighbors, batch: int, seq: int, qseq: int, seed: int) -> None:
        self.flat, self.offsets, self.lengths = flat, offsets, np.diff(offsets)
        self.ok_docs, self.neighbors = ok_docs, neighbors
        self.doc_row = {int(d): i for i, d in enumerate(ok_docs)}
        self.batch, self.seq, self.qseq = batch, seq, qseq
        self.rng = np.random.default_rng(seed)

    def crop(self, doc_idx, lo, hi):
        start, length = int(self.offsets[doc_idx]), int(self.lengths[doc_idx])
        size = int(self.rng.integers(lo, min(hi, length) + 1))
        off = int(self.rng.integers(0, length - size + 1))
        return self.flat[start + off : start + off + size].astype(np.int32)

    def __call__(self):
        rng = self.rng
        q = np.full((self.batch, self.qseq), PAD, np.int32)
        p_ = np.full((self.batch, self.seq), PAD, np.int32)
        n_ = np.full((self.batch, self.seq), PAD, np.int32)
        for i in range(self.batch):
            di = int(self.ok_docs[rng.integers(0, self.ok_docs.size)])
            cq = self.crop(di, 8, min(48, self.qseq))
            cp = self.crop(di, 32, self.seq)
            # A random one of the anchor's mined neighbors, passage crop.
            ni = int(self.neighbors[self.doc_row[di], rng.integers(0, self.neighbors.shape[1])])
            cn = self.crop(ni, 32, self.seq)
            q[i, : cq.size] = cq
            p_[i, : cp.size] = cp
            n_[i, : cn.size] = cn
        return q, p_, n_


# --- Hard-negative mining -------------------------------------------------------


def nearest(embs: torch.Tensor, k: int, tile: int = 512) -> np.ndarray:
    """Each row's top-``k`` other rows by ``embs @ embs.T`` (bf16 products,
    compared in f32), in [tile, n] tiles; [n, k] row indices."""
    n = embs.shape[0]
    neigh = np.empty((n, k), np.int64)
    cols = torch.arange(n, device=embs.device)[None, :]
    for i in range(0, n, tile):
        rows = embs[i : i + tile]
        sims = (rows @ embs.T).to(torch.float32)  # [tile, n]
        own = torch.arange(i, i + rows.shape[0], device=embs.device)[:, None]
        sims = sims.masked_fill(cols == own, float("-inf"))  # drop self
        neigh[i : i + rows.shape[0]] = torch.topk(sims, k, dim=1).indices.cpu().numpy()
    return neigh


@torch.no_grad()
def mine_hard_negatives(net: Trainable, flat, offsets, seq: int, log=None):
    """Embed one representative crop (the first ``seq`` tokens) of every
    document of >= 48 tokens with the current model and return
    ``(ok_docs, neighbours)``: the documents and each one's MINE_K
    nearest other documents (document indices, [n, MINE_K])."""
    lengths = np.diff(offsets)
    ok = np.flatnonzero(lengths >= 48)
    n = ok.size
    p = net.cast()
    device = next(iter(net.masters.values())).device
    batch = 512
    embs = []
    t0 = time.time()
    for i in range(0, n, batch):
        batch_idx = ok[i : i + batch]
        ids = np.full((batch, seq), PAD, np.int32)
        for r, di in enumerate(batch_idx):
            take = min(int(lengths[di]), seq)
            ids[r, :take] = flat[offsets[di] : offsets[di] + take].astype(np.int32)
        ids[len(batch_idx) :, 0] = BOS  # avoid all-PAD rows
        embs.append(_embed(net, p, _to_device(ids, device)).to(torch.bfloat16)[: len(batch_idx)])
    embs = torch.cat(embs)  # [n, d] bf16, on the device
    if log:
        log(f"hardneg: embedded {n} docs in {time.time() - t0:.1f}s")
    t0 = time.time()
    neigh = nearest(embs, MINE_K)
    if log:
        log(f"hardneg: mined top-{MINE_K} neighbors in {time.time() - t0:.1f}s")
    return ok, ok[neigh]


# --- The loop --------------------------------------------------------------------


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on the device: staged through pinned memory on the card,
    so the copy is queued behind the running step instead of waiting for it."""
    t = torch.from_numpy(array)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def train_step(net: Trainable, opt: optim.Adam, loss_fn, batch: list[torch.Tensor]):
    """One step: ``loss_fn(net, net.cast(), *batch)`` (a loss, or a loss and
    its parts), its gradients into the f32 masters, the update.  Returns the
    loss function's output; nothing is read to the host."""
    with full_f32_matmul():
        out = loss_fn(net, net.cast(), *batch)
        loss = out[0] if isinstance(out, tuple) else out
        grads = list(torch.autograd.grad(loss, net.leaves))
    opt.step(grads)
    return out


def step_flops(cfg: dict, towers: list[tuple[int, int]], *, logits: int = 0, maxsim: tuple[int, ...] = ()) -> float:
    """Model FLOPs of one training step from the shapes: forward and
    backward (3x the forward) of each tower ``(rows, T)`` (layer GEMMs and
    attention), the tied logits over ``logits`` positions and the MaxSim
    GEMM ``(B, Tq, C, Td)``; remat's recompute is not counted."""
    d, ff, layers = cfg["d_model"], cfg["d_ff"], cfg["layers"]
    fwd = 0.0
    for rows, t in towers:
        fwd += rows * t * layers * (2 * (4 * d * d + 2 * d * ff) + 4 * t * d)
    fwd += logits * 2 * d * cfg["vocab"]
    if maxsim:
        b, tq, c, td = maxsim
        fwd += 2 * b * tq * c * td * d
    return 3 * fwd


def _train(run: Run, net: Trainable, opt: optim.Adam, name: str, steps: int, make_batch, loss_fn, *,
           flops: float, tokens: int, print_every: int, save_every: int, save, aux: bool = False) -> dict:
    """Run ``steps`` steps; returns the phase's figures (losses read once,
    at the end and at the print interval, never per step).  Of the steady
    steps' wall time, ``host_share`` is the host making batches and
    ``enqueue_share`` the host inside ``train_step`` queueing the step's
    work: the host's own time, unless a full launch queue held it back
    (the card runs behind it; a share near 1 leaves the host no slack)."""
    device = run.device
    losses = torch.zeros(steps, device=device)
    parts = torch.zeros((steps, 2), device=device) if aux else None
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    host = enqueue = 0.0
    t_start = t0 = time.perf_counter()
    t_first = 0.0
    for step in range(steps):
        th = time.perf_counter()
        batch = [_to_device(a, device) for a in make_batch()]
        t_enq = time.perf_counter()
        out = train_step(net, opt, loss_fn, batch)
        host += t_enq - th
        enqueue += time.perf_counter() - t_enq
        loss, extra = out if aux else (out, None)
        losses[step] = loss.detach()
        if aux:
            parts[step] = torch.stack([extra[0].detach(), extra[1].detach()])
        if step == 0:
            # The first step (cuBLAS handles, the allocator's first blocks)
            # is timed apart from the steady ones.
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            t_first, host, enqueue = t0 - t_start, 0.0, 0.0
        if (step + 1) % print_every == 0:
            recent = float(losses[max(0, step - 49) : step + 1].mean())
            rate = (step + 1) / (time.perf_counter() - t_start)
            run.log(f"{name} step {step + 1}/{steps} loss {recent:.3f} ({rate:.1f} steps/s)")
        if (step + 1) % save_every == 0:
            save(losses[max(0, step - 49) : step + 1])
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    save(losses[max(0, steps - 50) :])
    curve = losses.cpu().numpy()
    steady = max(steps - 1, 1)
    out = {
        "phase": name, "steps": steps, "first_step_s": t_first, "steady_s": wall,
        "steps_per_s": steady / wall if wall else float("nan"),
        "tokens_per_s": tokens * steady / wall if wall else float("nan"),
        "tflops": flops * steady / wall / 1e12 if wall else float("nan"),
        "host_share": host / wall if wall else float("nan"),
        "enqueue_share": enqueue / wall if wall else float("nan"),
        "loss_first": float(curve[0]), "loss_last": float(curve[-1]),
        "loss_first20": float(curve[:20].mean()), "loss_last20": float(curve[-20:].mean()),
        "losses": curve.tolist(), "device": str(device),
    }
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if aux:
        dense, tok = parts.mean(dim=0).tolist()
        out.update(dense_mean=dense, tok_mean=tok)
    run.log(f"{name} done: final loss {float(curve[-50:].mean()):.3f}")
    return out


def _adamw(run: Run, net: Trainable, schedule) -> optim.Adam:
    return optim.adamw(net.leaves, schedule, b1=0.9, b2=0.98, eps=1e-6, weight_decay=0.01, clip=run.cfg.get("clip", 1.0))


def _resume(run: Run, name: str) -> dict[str, torch.Tensor]:
    return load_params(run.workdir / name)[1]


def run_mlm(run: Run, steps: int, batch: int, resume: bool = False) -> dict:
    """Phase 1 from the seeded init (or ``mlm.npz`` with ``resume``)."""
    cfg = run.cfg
    flat, offsets = run.tokens()
    if resume and (run.workdir / "mlm.npz").exists():
        state = _resume(run, "mlm.npz")
        run.log("resumed params from mlm.npz")
    else:
        state = init_params(cfg)
    net = Trainable(cfg, state, run.device, run.compute_dtype)
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, peak_value=cfg.get("mlm_lr", 4e-4), warmup_steps=min(cfg.get("mlm_warmup", 1000), steps // 4),
        decay_steps=steps, end_value=2e-5,
    )
    best_saved = [float("inf")]

    def save(recent_losses: torch.Tensor) -> None:
        # Collapse guard: a post-LN spike-collapse (the loss jumps and
        # flattens at the unigram solution) must not clobber the last good
        # checkpoint: save only while the recent loss is no worse than the
        # best saved one plus slack.
        recent = float(recent_losses.mean())
        if recent < best_saved[0] + 0.05:
            best_saved[0] = min(best_saved[0], recent)
            save_params(run.workdir / "mlm.npz", net.state(), cfg)
        else:
            run.log(f"mlm: loss {recent:.3f} regressed past best saved {best_saved[0]:.3f}; checkpoint NOT overwritten")

    return _train(
        run, net, _adamw(run, net, schedule), "mlm", steps,
        MLMBatches(flat, offsets, batch, run.seq, cfg["vocab"]), mlm_loss,
        flops=step_flops(cfg, [(batch, run.seq)], logits=batch * run.seq), tokens=batch * run.seq,
        print_every=200, save_every=2000, save=save,
    )


def _phase_saver(run: Run, net: Trainable, name: str):
    return lambda _recent: save_params(run.workdir / name, net.state(), run.cfg)


def run_contrastive(run: Run, steps: int, batch: int) -> dict:
    """Phase 2 from ``mlm.npz``."""
    flat, offsets = run.tokens()
    net = Trainable(run.cfg, _resume(run, "mlm.npz"), run.device, run.compute_dtype)
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, peak_value=1e-4, warmup_steps=min(500, steps // 10), decay_steps=steps, end_value=1e-5,
    )
    return _train(
        run, net, _adamw(run, net, schedule), "contrastive", steps,
        CropBatches(flat, offsets, batch, run.seq, run.qseq), contrastive_loss,
        flops=step_flops(run.cfg, [(batch, run.seq), (batch, run.qseq)]), tokens=batch * (run.seq + run.qseq),
        print_every=100, save_every=1000, save=_phase_saver(run, net, "contrastive.npz"),
    )


def run_hardneg(run: Run, steps: int, batch: int) -> dict:
    """Phase 3 from ``contrastive.npz``: mine, then InfoNCE over [B, 2B]."""
    flat, offsets = run.tokens()
    net = Trainable(run.cfg, _resume(run, "contrastive.npz"), run.device, run.compute_dtype)
    t0 = time.perf_counter()
    ok_docs, neighbors = mine_hard_negatives(net, flat, offsets, run.seq, log=run.log)
    mine_s = time.perf_counter() - t0
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, peak_value=5e-5, warmup_steps=min(300, steps // 10), decay_steps=steps, end_value=5e-6,
    )
    out = _train(
        run, net, _adamw(run, net, schedule), "hardneg", steps,
        NegativeBatches(flat, offsets, ok_docs, neighbors, batch, run.seq, run.qseq, seed=2), hardneg_loss,
        flops=step_flops(run.cfg, [(batch, run.qseq), (batch, run.seq), (batch, run.seq)]),
        tokens=batch * (run.qseq + 2 * run.seq),
        print_every=100, save_every=1000, save=_phase_saver(run, net, "hardneg.npz"),
    )
    return {**out, "mine_s": mine_s, "mined_docs": int(ok_docs.size)}


def run_maxsim(run: Run, steps: int, batch: int, lr: float = 3e-5, dense_weight: float = 1.0) -> dict:
    """Phase 4 from ``hardneg.npz``: mine again, then the joint loss."""
    flat, offsets = run.tokens()
    net = Trainable(run.cfg, _resume(run, "hardneg.npz"), run.device, run.compute_dtype)
    t0 = time.perf_counter()
    ok_docs, neighbors = mine_hard_negatives(net, flat, offsets, run.seq, log=run.log)
    mine_s = time.perf_counter() - t0
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, peak_value=lr, warmup_steps=min(200, steps // 10), decay_steps=steps, end_value=lr / 10,
    )

    def loss_fn(net, p, q, pos, neg):
        return maxsim_loss(net, p, q, pos, neg, dense_weight=dense_weight)

    out = _train(
        run, net, _adamw(run, net, schedule), "maxsim", steps,
        NegativeBatches(flat, offsets, ok_docs, neighbors, batch, run.seq, run.qseq, seed=3), loss_fn,
        flops=step_flops(run.cfg, [(batch, run.qseq), (batch, run.seq), (batch, run.seq)],
                         maxsim=(batch, run.qseq, 2 * batch, run.seq)),
        tokens=batch * (run.qseq + 2 * run.seq),
        print_every=100, save_every=500, save=_phase_saver(run, net, "maxsim.npz"), aux=True,
    )
    return {**out, "mine_s": mine_s, "mined_docs": int(ok_docs.size)}


def run_export(run: Run, out: Path) -> Path:
    """The newest phase file as ``out/encoder.npz`` (f16 matrices, f32
    LayerNorms and biases), ``out/tokenizer.json`` and ``out/config.json``."""
    out.mkdir(parents=True, exist_ok=True)
    src = next(
        run.workdir / name
        for name in ("maxsim.npz", "hardneg.npz", "contrastive.npz", "mlm.npz")
        if (run.workdir / name).exists()
    )
    cfg, params, _ = load_npz_encoder(str(src))
    save_npz_encoder(str(out / "encoder.npz"), params, cfg, dtype=np.float16)
    shutil.copyfile(run.tokenizer, out / "tokenizer.json")
    (out / "config.json").write_text(json.dumps({**cfg, "pad_token_id": PAD, "bos_token_id": BOS, "eos_token_id": EOS}))
    size = (out / "encoder.npz").stat().st_size / 1e6
    run.log(f"exported {src.name} -> {out} ({size:.1f} MB)")
    return src


def main(argv: list[str] | None = None) -> dict:
    """The script's command line, plus ``--device`` (``cuda`` unless asked
    for the CPU), ``--workdir``, ``--out``, ``--corpus`` and
    ``--tokenizer``; returns each phase's figures."""
    from raglite_tpu_torch.config import checked_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", default="all", choices=["tokenizer", "tokens", "mlm", "contrastive", "hardneg", "maxsim", "export", "all"])
    parser.add_argument("--size", default="base", choices=sorted(SIZES))
    parser.add_argument("--steps", type=int, default=0)
    parser.add_argument("--batch", type=int, default=0)
    parser.add_argument("--seq", type=int, default=0,
                        help="training sequence length (default 128; a final MLM stage at 512 trains the full position table)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--lr", type=float, default=3e-5, help="maxsim-phase peak learning rate")
    parser.add_argument("--dense-weight", type=float, default=1.0, help="maxsim-phase dense-loss weight (tok loss = 1)")
    parser.add_argument("--device", default="cuda", help="'cuda' (default; raises without a GPU) or 'cpu'")
    parser.add_argument("--workdir", type=Path, help="phase files and the token cache (default data/encoder_train_<size>)")
    parser.add_argument("--out", type=Path, help="export directory (default data/encoder_<size>), loads as flax:<out>")
    parser.add_argument("--corpus", type=Path, default=DEFAULT_CORPUS, help="train.corpus's output directory")
    parser.add_argument("--tokenizer", type=Path,
                        help="tokenizer.json (default: the workdir's trained one if it exists, else the packaged one)")
    args = parser.parse_args(argv)
    cfg = SIZES[args.size]
    run = Run(
        cfg=cfg, workdir=args.workdir or DATA / f"encoder_train_{args.size}", device=checked_device(args.device),
        corpus=args.corpus, seq=min(args.seq, cfg["max_len"]) if args.seq else SEQ,
    )
    run.workdir.mkdir(parents=True, exist_ok=True)
    results: dict = {}
    trained = run.workdir / "tokenizer.json"
    if args.phase in ("tokenizer", "all") and not trained.exists():
        t0 = time.perf_counter()
        spec = bpe.train_tokenizer(bpe.corpus_texts(run.corpus / "train.jsonl"), cfg["vocab"])
        bpe.write_tokenizer(spec, trained)
        results["tokenizer"] = {"vocab": len(spec["model"]["vocab"]), "merges": len(spec["model"]["merges"]),
                                "s": time.perf_counter() - t0}
        run.log(f"tokenizer: {results['tokenizer']}")
    run.tokenizer = args.tokenizer or (trained if trained.exists() else PACKAGED_TOKENIZER)
    if args.phase in ("tokens", "all") and not (run.workdir / "tokens.npz").exists():
        results["tokens"] = build_token_cache(run.corpus, run.workdir / "tokens.npz", str(run.tokenizer))
        run.log(f"token cache: {results['tokens']}")
    if args.phase in ("mlm", "all"):
        results["mlm"] = run_mlm(run, args.steps or 20000, args.batch or 256, args.resume)
    if args.phase in ("contrastive", "all"):
        results["contrastive"] = run_contrastive(run, args.steps or 4000, args.batch or 512)
    if args.phase in ("hardneg", "all"):
        results["hardneg"] = run_hardneg(run, args.steps or 2000, args.batch or 256)
    if args.phase in ("maxsim", "all"):
        results["maxsim"] = run_maxsim(run, args.steps or 1200, args.batch or 64, lr=args.lr, dense_weight=args.dense_weight)
    if args.phase in ("export", "all"):
        results["export"] = str(run_export(run, args.out or DATA / f"encoder_{args.size}"))
    return results


if __name__ == "__main__":
    main()
