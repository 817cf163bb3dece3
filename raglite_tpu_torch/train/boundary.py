"""Train the learned sentence-boundary model on the card (counterpart of
scripts/train_boundary.py).

The script's recipe: 800 synthetic multilingual documents at seed 1000
(models/boundary_data.py; the held-out documents use seed 2000), every
gold boundary, every punctuation-adjacent position and 5 % of the rest as
examples (positives weighted 3), a seeded init, a weighted BCE, Adam at
3e-3 over batches of 1,024 for 40 epochs, then the held-out boundary F1
of the heuristic and of the trained model.  The model is the port's
``BoundaryModel`` (its forward, in f32 with TF32 off); the examples live
on the device and each epoch's permutation (numpy, the script's draws)
indexes them there, so a step makes no host copy and no host read.  The
weights go to ``--out`` through ``BoundaryModel.save``, never into the JAX
package's data directory.

Usage:  python -m raglite_tpu_torch.train.boundary [--device cuda] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from raglite_tpu_torch.models.boundary import VOCAB_SIZE, WINDOW, BoundaryModel, boundary_f1, char_class_ids, windows_for
from raglite_tpu_torch.models.boundary_data import make_corpus
from raglite_tpu_torch.train import optim
from raglite_tpu_torch.train.corpus import DATA
from raglite_tpu_torch.utils.precision import full_f32_matmul

__all__ = ["build_examples", "bce_loss", "init_params", "main", "train"]

TRAIN_SEED, EVAL_SEED = 1000, 2000  # tests evaluate on EVAL_SEED documents
NUM_TRAIN_DOCS, NUM_EVAL_DOCS = 800, 60
EPOCHS, BATCH, LR = 40, 1024, 3e-3


def build_examples(corpus) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(windows [N, 2W+1], labels [N], weights [N]) — all gold positives,
    all punctuation-adjacent negatives (the hard ones), and a 5% sample of
    the rest."""
    rng = np.random.default_rng(0)
    xs, ys, ws = [], [], []
    punct = set(".!?;。！？…\n")
    for doc, gold in corpus:
        ids = char_class_ids(doc)
        wins = windows_for(ids)
        labels = np.zeros(len(doc), dtype=np.float32)
        labels[list(gold)] = 1.0
        near_punct = np.array([c in punct for c in doc], dtype=bool)
        keep = labels.astype(bool) | near_punct | (rng.random(len(doc)) < 0.05)
        xs.append(wins[keep])
        ys.append(labels[keep])
        # Up-weight positives: negatives dominate the sample.
        ws.append(np.where(labels[keep] > 0, 3.0, 1.0).astype(np.float32))
    return np.concatenate(xs), np.concatenate(ys), np.concatenate(ws)


def init_params(*, seed: int = 0, emb: int = 12, hidden: int = 64) -> dict[str, np.ndarray]:
    """The JAX package's ``init_params`` distributions (JAX layout) from an
    explicit ``torch.Generator``: 0.1 normal embeddings, normal / sqrt(fan_in)
    matrices, zero biases."""
    g = torch.Generator().manual_seed(seed)
    width = (2 * WINDOW + 1) * emb
    return {
        "emb": (0.1 * torch.randn(VOCAB_SIZE, emb, generator=g)).numpy(),
        "w1": (torch.randn(width, hidden, generator=g) / np.sqrt(width)).numpy(),
        "b1": np.zeros(hidden, np.float32),
        "w2": (torch.randn(hidden, 1, generator=g) / np.sqrt(hidden)).numpy(),
        "b2": np.zeros(1, np.float32),
    }


def bce_loss(model: BoundaryModel, windows: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The script's weighted binary cross-entropy of ``model(windows)``."""
    probs = model(windows)
    eps = 1e-7
    bce = -(labels * torch.log(probs + eps) + (1 - labels) * torch.log(1 - probs + eps))
    return torch.mean(weights * bce)


def train(device: torch.device) -> tuple[BoundaryModel, dict]:
    """The script's recipe on ``device``; returns the model and the run's
    figures (examples, steps, seconds, losses at the report epochs)."""
    t0 = time.perf_counter()
    corpus = make_corpus(num_documents=NUM_TRAIN_DOCS, seed=TRAIN_SEED)
    windows, labels, weights = build_examples(corpus)
    data_s = time.perf_counter() - t0
    print(f"{len(corpus)} docs -> {len(labels)} examples ({int(labels.sum())} positives)")  # noqa: T201
    model = BoundaryModel.from_params(init_params(seed=0), device=device)
    params = list(model.parameters())
    opt = optim.adam(params, LR)
    x = torch.from_numpy(windows).to(device)
    y = torch.from_numpy(labels).to(device)
    w = torch.from_numpy(weights).to(device)
    rng = np.random.default_rng(1)
    per_epoch = (len(labels) - BATCH) // BATCH + 1
    losses = torch.zeros((EPOCHS, per_epoch), device=device)
    report: dict[int, float] = {}
    t0 = time.perf_counter()
    for epoch in range(EPOCHS):
        order = torch.from_numpy(rng.permutation(len(labels))).to(device)
        for i, start in enumerate(range(0, len(labels) - BATCH + 1, BATCH)):
            sel = order[start : start + BATCH]
            with full_f32_matmul():
                loss = bce_loss(model, x[sel], y[sel], w[sel])
                opt.step(list(torch.autograd.grad(loss, params)))
            losses[epoch, i] = loss.detach()
        if epoch % 8 == 0 or epoch == EPOCHS - 1:
            report[epoch] = float(losses[epoch].mean())
            print(f"epoch {epoch}: loss {report[epoch]:.4f} ({time.perf_counter() - t0:.0f}s)")  # noqa: T201
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    stats = {
        "docs": len(corpus), "examples": int(len(labels)), "positives": int(labels.sum()), "data_s": data_s,
        "steps": EPOCHS * per_epoch, "s": seconds, "steps_per_s": EPOCHS * per_epoch / seconds,
        "loss_by_epoch": report, "device": str(device),
    }
    return model, stats


def held_out_f1(probas_fn) -> float:
    """Mean boundary F1 over the 60 held-out documents (seed 2000)."""
    eval_corpus = make_corpus(num_documents=NUM_EVAL_DOCS, seed=EVAL_SEED)
    return float(np.mean([boundary_f1(probas_fn(doc), gold)[0] for doc, gold in eval_corpus]))


def main(argv: list[str] | None = None) -> tuple[BoundaryModel, dict]:
    """Train, save to ``--out``, report the held-out F1; returns the
    trained model and the figures."""
    from raglite_tpu_torch.config import checked_device
    from raglite_tpu_torch.sentences import heuristic_sentence_boundaries

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="'cuda' (default; raises without a GPU) or 'cpu'")
    parser.add_argument("--out", type=Path, default=DATA / "boundary_model.npz")
    args = parser.parse_args(argv)
    model, stats = train(checked_device(args.device))
    model.save(args.out)
    print(f"saved {args.out}")  # noqa: T201
    # Held-out report (the same protocol tests/PARITY.md use).
    for name, fn in (("heuristic", heuristic_sentence_boundaries), ("learned", model)):
        stats[f"f1_{name}"] = held_out_f1(fn)
        print(f"{name}: held-out boundary-F1 {stats[f'f1_{name}']:.4f}")  # noqa: T201
    stats["out"] = str(args.out)
    print(json.dumps({k: v for k, v in stats.items() if k != "loss_by_epoch"}))  # noqa: T201
    return model, stats


if __name__ == "__main__":
    main()
