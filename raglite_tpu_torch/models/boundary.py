"""Tiny learned sentence-boundary model (counterpart of
raglite_tpu/models/boundary.py).

A character-class windowed MLP (the SaT replacement): each position's
window of 2W+1 = 13 character classes is embedded (187 x 12), flattened to
156 values, and mapped through Linear(156, 64), tanh-approximated GELU,
Linear(64, 1) and a sigmoid to the probability that a sentence ends there.
The ~12k parameters are the JAX package's packaged
``raglite_tpu/models/data/boundary_model.npz``, read by path (no JAX).

The module lives on the configured device ("cuda" unless the caller asks
for the CPU).  Its f32 matmuls run with TF32 off: the probabilities feed an
exact DP (sentences.py:_solve_boundaries), where a near-tie can flip a cut.
The positions run in blocks of ``_BLOCK`` = 65,536 (bounding the [block,
156] f32 activations); the last block is padded with PAD windows to the
JAX package's ``jit`` bucket (a power of two from 512) and the padding's
probabilities sliced off, so a program's shape is a bucket and not a
document length.  Each block's forward is one program, replayed from a
CUDA graph on the card keyed ``("boundary", rows)`` (``self.programs``,
utils/graphs.py): at most 8 keys (512 to 65,536 rows), each holding its
block's activations (~60 MB at 65,536).  The weights are closed over and
never replaced (``load_state_dict`` copies into them).

``boundary_f1`` scores any proba function against gold boundaries
(tests/test_torch_boundary.py, chip_smoke.py phase 11).
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from raglite_tpu_torch.utils.graphs import ProgramGraphs
from raglite_tpu_torch.utils.padding import bucket

__all__ = [
    "char_class_ids",
    "BoundaryModel",
    "learned_sentence_boundaries",
    "boundary_f1",
    "default_model",
    "windows_for",
    "VOCAB_SIZE",
    "WINDOW",
]

#: Half-window of context on each side of a candidate position.
WINDOW = 6
#: ASCII (0-127) + dedicated multilingual punctuation + category buckets.
_SPECIAL = "。！？…‥«»„“”‘’『』「」【】（）；：、，．¿¡·  —–‒"
_CATEGORIES = [
    "Lu", "Ll", "Lt", "Lm", "Lo", "Nd", "Nl", "No",
    "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So",
    "Zs", "Zl", "Zp", "Cc", "Cf",
]
_SPECIAL_BASE = 128
_CAT_BASE = _SPECIAL_BASE + len(_SPECIAL)
VOCAB_SIZE = _CAT_BASE + len(_CATEGORIES) + 2  # + other + pad
_PAD_ID = VOCAB_SIZE - 1
#: Positions per forward: bounds the [block, 156] f32 activations (~40 MB).
_BLOCK = 1 << 16

_DEFAULT_WEIGHTS = (
    Path(__file__).resolve().parents[2] / "raglite_tpu" / "models" / "data" / "boundary_model.npz"
)


def _checked(device: torch.device | str) -> torch.device:
    from raglite_tpu_torch.config import checked_device

    return checked_device(str(device))


@lru_cache(maxsize=1)
def _class_table() -> dict[str, int]:
    return {c: _SPECIAL_BASE + i for i, c in enumerate(_SPECIAL)}


@lru_cache(maxsize=4096)
def _class_of(char: str) -> int:
    code = ord(char)
    if code < 128:
        return code
    special = _class_table().get(char)
    if special is not None:
        return special
    category = unicodedata.category(char)
    try:
        return _CAT_BASE + _CATEGORIES.index(category)
    except ValueError:
        return _CAT_BASE + len(_CATEGORIES)  # other


def char_class_ids(doc: str) -> np.ndarray:
    """Map characters to model input classes (ASCII direct, key CJK and
    European punctuation dedicated, the long tail bucketed by Unicode
    category)."""
    return np.fromiter((_class_of(c) for c in doc), dtype=np.int32, count=len(doc))


def windows_for(ids: np.ndarray) -> np.ndarray:
    """All sliding windows [N, 2W+1], PAD-extended at the edges."""
    n = len(ids)
    if n == 0:
        return np.zeros((0, 2 * WINDOW + 1), dtype=np.int32)
    padded = np.full(n + 2 * WINDOW, _PAD_ID, dtype=np.int32)
    padded[WINDOW : WINDOW + n] = ids
    stride = padded.strides[0]
    return np.lib.stride_tricks.as_strided(
        padded, shape=(n, 2 * WINDOW + 1), strides=(stride, stride)
    ).copy()


class BoundaryModel(nn.Module):
    """Embedding(187, 12) -> Linear(156, 64) -> GELU (tanh) -> Linear(64, 1)
    -> sigmoid over [N, 13] windows.  ``model(doc)`` with a string returns
    the per-character probabilities as float64, as the JAX model does."""

    def __init__(self, *, emb: int = 12, hidden: int = 64, device: torch.device | str = "cuda") -> None:
        super().__init__()
        device = _checked(device)
        width = 2 * WINDOW + 1
        self.emb = nn.Embedding(VOCAB_SIZE, emb, device=device)
        self.fc1 = nn.Linear(width * emb, hidden, device=device)
        self.fc2 = nn.Linear(hidden, 1, device=device)
        #: The block forwards, replayed from CUDA graphs on the card.
        self.programs = ProgramGraphs(device)

    @property
    def device(self) -> torch.device:
        return self.emb.weight.device

    @classmethod
    def from_params(cls, params: dict, *, device: torch.device | str = "cuda") -> "BoundaryModel":
        """Build from the JAX package's parameters (numpy or array-likes:
        emb [V, E], w1 [13E, H], b1 [H], w2 [H, 1], b2 [1])."""
        arrays = {k: np.array(v, dtype=np.float32) for k, v in params.items()}
        model = cls(emb=arrays["emb"].shape[1], hidden=arrays["w1"].shape[1], device=device)
        state = {
            "emb.weight": arrays["emb"],
            "fc1.weight": arrays["w1"].T,
            "fc1.bias": arrays["b1"],
            "fc2.weight": arrays["w2"].T,
            "fc2.bias": arrays["b2"],
        }
        model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()})
        return model.eval()

    def params(self) -> dict[str, np.ndarray]:
        """The JAX package's parameter layout, as numpy arrays."""
        return {
            "emb": self.emb.weight.detach().cpu().numpy(),
            "w1": self.fc1.weight.detach().cpu().numpy().T.copy(),
            "b1": self.fc1.bias.detach().cpu().numpy(),
            "w2": self.fc2.weight.detach().cpu().numpy().T.copy(),
            "b2": self.fc2.bias.detach().cpu().numpy(),
        }

    @classmethod
    def load(cls, path: str | Path = _DEFAULT_WEIGHTS, *, device: torch.device | str = "cuda") -> "BoundaryModel":
        if not Path(path).exists():
            msg = f"boundary model weights not found: {path}"
            raise FileNotFoundError(msg)
        with np.load(path, allow_pickle=False) as data:
            params = {k: data[k] for k in data.files}
        return cls.from_params(params, device=device)

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **self.params())

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        """windows [N, 2W+1] integer class ids -> probabilities [N] f32."""
        from raglite_tpu_torch.utils.precision import full_f32_matmul

        x = self.emb(windows.to(torch.int64)).reshape(windows.shape[0], -1)
        with full_f32_matmul():
            h = F.gelu(self.fc1(x), approximate="tanh")  # jax.nn.gelu's default
            return torch.sigmoid(self.fc2(h)[:, 0])

    def __call__(self, doc, *args, **kwargs):
        if isinstance(doc, str):
            return self.probas(doc)
        return super().__call__(doc, *args, **kwargs)

    @torch.inference_mode()
    def probas(self, doc: str) -> np.ndarray:
        """Per-character boundary probabilities [len(doc)] float64."""
        if not doc:
            return np.zeros(0, dtype=np.float64)
        windows = windows_for(char_class_ids(doc))
        n = windows.shape[0]
        out = []
        for start in range(0, n, _BLOCK):
            block = windows[start : start + _BLOCK]
            rows = bucket(block.shape[0], 512)
            if rows != block.shape[0]:
                block = np.concatenate([block, np.full((rows - block.shape[0], block.shape[1]), _PAD_ID, np.int32)])
            out.append(self.programs(("boundary", rows), self.forward, block))
        return torch.cat(out)[:n].cpu().numpy().astype(np.float64)


@lru_cache(maxsize=4)
def _default_model(device: str) -> BoundaryModel:
    return BoundaryModel.load(device=device)


def default_model(device: str = "cuda") -> BoundaryModel:
    """The packaged model on ``device`` (cached); "cuda" without a usable
    GPU raises instead of running on the CPU, and absent weights raise
    ``FileNotFoundError`` instead of swapping in the heuristic."""
    return _default_model(str(_checked(device)))


def learned_sentence_boundaries(doc: str, *, device: str = "cuda") -> np.ndarray:
    """Drop-in replacement for heuristic_sentence_boundaries using the
    packaged learned model on ``device``."""
    return default_model(device)(doc)


def boundary_f1(
    probas: np.ndarray, gold: set[int], *, threshold: float = 0.25
) -> tuple[float, float, float]:
    """(F1, precision, recall) of ``probas >= threshold`` against gold
    boundary indices."""
    predicted = set(np.flatnonzero(probas >= threshold).tolist())
    tp = len(predicted & gold)
    precision = tp / len(predicted) if predicted else 0.0
    recall = tp / len(gold) if gold else 1.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return f1, precision, recall
