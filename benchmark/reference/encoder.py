"""The query encoder in plain PyTorch, float32, with TF32 off.

A post-LayerNorm bidirectional transformer (XLM-RoBERTa's layer: attention,
add and LayerNorm, an erf-GELU feed-forward, add and LayerNorm), token and
absolute position embeddings with a LayerNorm over their sum, an optional
final LayerNorm, and the masked mean of the last states, L2-normalised.
Every weight matrix holds the values the configuration serves (bfloat16)
and every operation runs in float32: the reference rounds nothing else.

Weights come from one of two sources, each a procedure of this file:

- ``npz``: the packaged encoder's raw ``encoder.npz`` (keys ``tok_emb``,
  ``pos_emb``, ``emb_ln_*``, ``layers.<i>.<w|b>*``, ``final_ln_*``; matrices
  ``[d_in, d_out]``), read with numpy.
- ``preset``: the seeded draw of a preset encoder, frozen here from the
  program's preset draw (``_random_encoder`` in the port's
  ``models/encoder.py`` as of this benchmark's first version): one CPU
  ``torch.Generator`` seeded with the preset's seed draws, in module order,
  ``randn * 0.02`` for the token and position embeddings and
  ``randn / sqrt(d_in)`` for every linear weight ``[d_out, d_in]``; biases
  are zero and LayerNorms one and zero.

``weights="fp8"`` is the control: every linear weight rounded to
float8 e4m3 with a scale per output row (the step below bfloat16).
"""

from __future__ import annotations

import contextlib
import json
import math
from pathlib import Path

import numpy as np
import torch

__all__ = ["ReferenceEncoder", "fp8_rows"]

_LINEARS = ("q", "k", "v", "o", "ff1", "ff2")
#: The npz's layer keys per linear layer: (weight, bias).
_NPZ_LINEARS = {"q": ("wq", "bq"), "k": ("wk", "bk"), "v": ("wv", "bv"), "o": ("wo", "bo"),
                "ff1": ("w1", "b1"), "ff2": ("w2", "b2")}


def fp8_rows(w: torch.Tensor) -> torch.Tensor:
    """``w`` [d_out, d_in] rounded to float8 e4m3 with one scale per output
    row (its absolute maximum maps to 448), back in float32."""
    scale = w.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class ReferenceEncoder:
    """Weights as float32 tensors on ``device``; :meth:`embed` runs texts'
    token ids through the forward."""

    def __init__(self, spec: dict, root: Path, *, device: str, weights: str = "served") -> None:
        self.device = torch.device(device)
        self.eps = float(spec.get("ln_eps", 1e-5))
        if spec["source"] == "npz":
            cfg, state = _npz_state(root / spec["file"], root / spec["config"])
        elif spec["source"] == "preset":
            cfg = {k: int(spec[k]) for k in ("layers", "d_model", "heads", "d_ff", "vocab", "max_len")}
            state = _preset_state(cfg, int(spec["seed"]), final_ln=bool(spec.get("final_ln", True)))
        else:
            msg = f"unknown reference encoder source {spec['source']!r}"
            raise ValueError(msg)
        self.cfg = cfg
        served = getattr(torch, spec.get("weights_dtype", "bfloat16"))
        self.w: dict[str, torch.Tensor] = {}
        for name, t in state.items():
            t = t.to(served).to(torch.float32) if t.ndim == 2 else t.to(torch.float32)
            if weights == "fp8" and t.ndim == 2 and name.split(".")[-2] in _LINEARS:
                t = fp8_rows(t)
            elif weights not in ("served", "fp8"):
                msg = f"unknown weights {weights!r}"
                raise ValueError(msg)
            self.w[name] = t.to(self.device)

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return torch.nn.functional.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"], self.eps)

    def _linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x @ self.w[f"{name}.weight"].T + self.w[f"{name}.bias"]

    @torch.inference_mode()
    def embed(self, ids: list[list[int]], *, batch: int = 64) -> np.ndarray:
        """L2-normalised mean-pooled embeddings [len(ids), d] float64 of
        token id lists (each truncated to the positions there are)."""
        out = np.zeros((len(ids), self.cfg["d_model"]), np.float64)
        order = sorted(range(len(ids)), key=lambda i: len(ids[i]))
        with full_f32():
            for start in range(0, len(order), batch):
                group = order[start : start + batch]
                seqs = [ids[i][: self.cfg["max_len"]] for i in group]
                pooled = self._forward(seqs)
                out[group] = pooled.double().cpu().numpy()
        return out / np.linalg.norm(out, axis=1, keepdims=True)

    def _forward(self, seqs: list[list[int]]) -> torch.Tensor:
        b, t = len(seqs), max(len(s) for s in seqs)
        ids = torch.zeros((b, t), dtype=torch.int64)
        mask = torch.zeros((b, t), dtype=torch.bool)
        for row, s in enumerate(seqs):
            ids[row, : len(s)] = torch.tensor(s)
            mask[row, : len(s)] = True
        ids, mask = ids.to(self.device), mask.to(self.device)
        d, heads = self.cfg["d_model"], self.cfg["heads"]
        hd = d // heads
        x = self.w["tok_emb.weight"][ids] + self.w["pos_emb.weight"][:t][None]
        x = self._ln(x, "emb_ln")
        bias = torch.where(mask[:, None, None, :], 0.0, -math.inf)
        for i in range(self.cfg["layers"]):
            p = f"layers.{i}"

            def split(y: torch.Tensor) -> torch.Tensor:
                return y.view(b, t, heads, hd).transpose(1, 2)

            q, k, v = (split(self._linear(x, f"{p}.{n}")) for n in ("q", "k", "v"))
            probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + bias, dim=-1)
            ctx = (probs @ v).transpose(1, 2).reshape(b, t, d)
            x = self._ln(x + self._linear(ctx, f"{p}.o"), f"{p}.attn_ln")
            h = torch.nn.functional.gelu(self._linear(x, f"{p}.ff1"))
            x = self._ln(x + self._linear(h, f"{p}.ff2"), f"{p}.mlp_ln")
        if "final_ln.weight" in self.w:
            x = self._ln(x, "final_ln")
        m = mask[:, :, None].to(x.dtype)
        return (x * m).sum(dim=1) / m.sum(dim=1)


def _npz_state(npz: Path, config: Path) -> tuple[dict, dict[str, torch.Tensor]]:
    """(config, state) of a raw ``encoder.npz``: matrices as ``[d_out, d_in]``."""
    cfg = json.loads(config.read_text())
    state: dict[str, torch.Tensor] = {}

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))

    with np.load(npz) as z:
        state["tok_emb.weight"] = tensor(z["tok_emb"])
        state["pos_emb.weight"] = tensor(z["pos_emb"])
        for ln in ("emb_ln", "final_ln"):
            if f"{ln}_scale" in z.files:
                state[f"{ln}.weight"] = tensor(z[f"{ln}_scale"])
                state[f"{ln}.bias"] = tensor(z[f"{ln}_bias"])
        for i in range(cfg["layers"]):
            for name, (w, b) in _NPZ_LINEARS.items():
                state[f"layers.{i}.{name}.weight"] = tensor(z[f"layers.{i}.{w}"].T)
                state[f"layers.{i}.{name}.bias"] = tensor(z[f"layers.{i}.{b}"])
            for ln in ("attn_ln", "mlp_ln"):
                state[f"layers.{i}.{ln}.weight"] = tensor(z[f"layers.{i}.{ln}_scale"])
                state[f"layers.{i}.{ln}.bias"] = tensor(z[f"layers.{i}.{ln}_bias"])
    return cfg, state


def _preset_state(cfg: dict, seed: int, *, final_ln: bool) -> dict[str, torch.Tensor]:
    """The preset draw (module docstring), in the program's module order."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    g = torch.Generator().manual_seed(seed)
    state = {
        "tok_emb.weight": torch.randn((cfg["vocab"], d), generator=g) * 0.02,
        "pos_emb.weight": torch.randn((cfg["max_len"], d), generator=g) * 0.02,
        "emb_ln.weight": torch.ones(d), "emb_ln.bias": torch.zeros(d),
    }
    shapes = {"q": (d, d), "k": (d, d), "v": (d, d), "o": (d, d), "ff1": (ff, d), "ff2": (d, ff)}
    for i in range(cfg["layers"]):
        for name in _LINEARS:
            shape = shapes[name]
            # bfloat16 at once: the program copies the draw into bf16 tensors.
            state[f"layers.{i}.{name}.weight"] = (torch.randn(shape, generator=g) / shape[1] ** 0.5).to(torch.bfloat16)
            state[f"layers.{i}.{name}.bias"] = torch.zeros(shape[0])
            if name == "o":
                state[f"layers.{i}.attn_ln.weight"], state[f"layers.{i}.attn_ln.bias"] = torch.ones(d), torch.zeros(d)
        state[f"layers.{i}.mlp_ln.weight"], state[f"layers.{i}.mlp_ln.bias"] = torch.ones(d), torch.zeros(d)
    if final_ln:
        state["final_ln.weight"], state["final_ln.bias"] = torch.ones(d), torch.zeros(d)
    return state
