"""PyTorch transformer encoder (XLM-RoBERTa family, e.g. bge-m3).

Counterpart of raglite_tpu/models/transformer.py: the same post-LN
bidirectional encoder as an ``nn.Module``, with the same numerics.

- LayerNorm runs in f32 and casts back to the parameter dtype.
- Every linear layer accumulates in f32 and adds its f32 bias in f32
  (``[d_in, d_out]`` weights of the JAX tree are stored transposed, as
  ``nn.Linear`` does); the residual sums run in the parameter dtype.
- Attention logits are f32, the mask bias is -1e9, and the softmax
  probabilities are cast to the parameter dtype before ``probs @ v``.
- GELU is the exact erf form unless ``hidden_act`` names the tanh form.

The encoder's attention is plain PyTorch here, as it is plain XLA in the
JAX package (no Pallas kernel to port).  Weights come from the packaged
``encoder.npz`` (read with numpy alone, :func:`load_npz_encoder`) or from a
JAX parameter tree (:func:`params_from_jax`).
"""

from __future__ import annotations

import json
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["EncoderModel", "load_npz_encoder", "params_from_jax"]

#: JAX layer parameter name -> (port module, port parameter, transpose).
_LAYER_NAMES = {
    "wq": ("q", "weight", True), "bq": ("q", "bias", False),
    "wk": ("k", "weight", True), "bk": ("k", "bias", False),
    "wv": ("v", "weight", True), "bv": ("v", "bias", False),
    "wo": ("o", "weight", True), "bo": ("o", "bias", False),
    "w1": ("ff1", "weight", True), "b1": ("ff1", "bias", False),
    "w2": ("ff2", "weight", True), "b2": ("ff2", "bias", False),
    "attn_ln_scale": ("attn_ln", "weight", False), "attn_ln_bias": ("attn_ln", "bias", False),
    "mlp_ln_scale": ("mlp_ln", "weight", False), "mlp_ln_bias": ("mlp_ln", "bias", False),
}
_TOP_NAMES = {
    "tok_emb": "tok_emb.weight", "pos_emb": "pos_emb.weight",
    "emb_ln_scale": "emb_ln.weight", "emb_ln_bias": "emb_ln.bias",
    "final_ln_scale": "final_ln.weight", "final_ln_bias": "final_ln.bias",
}


class LayerNorm(nn.Module):
    """LayerNorm in f32 with f32 parameters; the result takes the input's dtype."""

    def __init__(self, d: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias).to(x.dtype)


class Linear(nn.Module):
    """``x @ W.T + b`` with f32 accumulation and an f32 result; ``W``
    [d_out, d_in] in the parameter dtype, ``b`` in f32."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d_out), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(torch.float32), self.weight.to(torch.float32), self.bias)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: dict, dtype: torch.dtype, eps: float, gelu: str) -> None:
        super().__init__()
        d, ff = cfg["d_model"], cfg["d_ff"]
        self.heads = cfg["heads"]
        self.gelu = gelu
        self.q, self.k, self.v, self.o = (Linear(d, d, dtype) for _ in range(4))
        self.attn_ln = LayerNorm(d, eps)
        self.ff1 = Linear(d, ff, dtype)
        self.ff2 = Linear(ff, d, dtype)
        self.mlp_ln = LayerNorm(d, eps)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads

        def heads(y: torch.Tensor) -> torch.Tensor:
            return y.view(b, t, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = q @ k.transpose(-1, -2) / math.sqrt(hd) + attn_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = (probs @ v.to(x.dtype)).transpose(1, 2).reshape(b, t, d)
        x = self.attn_ln(x + self.o(ctx).to(x.dtype))
        h = F.gelu(self.ff1(x), approximate=self.gelu).to(x.dtype)
        return self.mlp_ln(x + self.ff2(h).to(x.dtype))


class EncoderModel(nn.Module):
    """Post-LN bidirectional transformer encoder: ids [B, T] and mask
    [B, T] bool -> hidden states [B, T, d] f32."""

    def __init__(self, cfg: dict, *, dtype: torch.dtype = torch.bfloat16, final_ln: bool = True) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg["d_model"]
        eps = float(cfg.get("ln_eps", 1e-5))
        # HF "gelu" is the exact erf form; "gelu_new"/"gelu_pytorch_tanh" tanh.
        gelu = "tanh" if cfg.get("hidden_act", "gelu") in ("gelu_new", "gelu_pytorch_tanh") else "none"
        self.tok_emb = nn.Embedding(cfg["vocab"], d, dtype=dtype)
        self.pos_emb = nn.Embedding(cfg["max_len"], d, dtype=dtype)
        self.emb_ln = LayerNorm(d, eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype, eps, gelu) for _ in range(cfg["layers"]))
        # Checkpoints of the XLM-R/BERT family have no final LN; a
        # scale-1/bias-0 LN would still re-standardize every token.
        self.final_ln = LayerNorm(d, eps) if final_ln else None
        self.requires_grad_(False)

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_emb.weight.dtype

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        t = ids.shape[1]
        x = self.tok_emb(ids) + self.pos_emb.weight[:t][None]
        x = self.emb_ln(x)
        zero = torch.zeros((), dtype=torch.float32, device=ids.device)
        attn_bias = torch.where(mask[:, None, None, :], zero, zero - 1e9)
        for layer in self.layers:
            x = layer(x, attn_bias)
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x.to(torch.float32)

    @classmethod
    def from_params(
        cls, cfg: dict, params: dict[str, Any], *, dtype: torch.dtype, device: torch.device | str
    ) -> "EncoderModel":
        """Build the model from a JAX-layout parameter tree of arrays."""
        model = cls(cfg, dtype=dtype, final_ln="final_ln_scale" in params)
        model.load_state_dict(params_from_jax(params, dtype=dtype), strict=True)
        return model.to(device).eval()


def params_from_jax(params: dict[str, Any], *, dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """The JAX package's encoder parameter tree (``tok_emb``, ``pos_emb``,
    ``emb_ln_*``, ``layers[i].{wq, bq, ...}``, optional ``final_ln_*``; any
    array type numpy can read) -> this module's state dict.  Matrices take
    ``dtype`` (rounded to nearest even, as ``jnp.asarray`` does), vectors
    stay f32, and linear weights are transposed to ``[d_out, d_in]``."""

    def tensor(value: Any, *, transpose: bool = False) -> torch.Tensor:
        arr = np.asarray(value, dtype=np.float32)
        t = torch.from_numpy(np.array(arr.T if transpose else arr, order="C"))
        return t.to(dtype) if arr.ndim >= 2 else t

    state: dict[str, torch.Tensor] = {}
    for key, value in params.items():
        if key == "layers":
            for i, layer in enumerate(value):
                for name, arr in layer.items():
                    module, param, transpose = _LAYER_NAMES[name]
                    state[f"layers.{i}.{module}.{param}"] = tensor(arr, transpose=transpose)
        else:
            state[_TOP_NAMES[key]] = tensor(value)
    return state


def load_npz_encoder(path: str) -> tuple[dict, dict[str, Any], None]:
    """Read an ``encoder.npz`` of the JAX package (keys: top-level names,
    ``layers.<i>.<name>``, ``__config__``) with numpy alone.

    Returns ``(cfg, params, None)`` with ``params`` a JAX-layout tree of
    numpy arrays for :meth:`EncoderModel.from_params`; the tokenizer lives
    beside the npz as ``tokenizer.json``."""
    with np.load(path) as z:
        cfg = json.loads(bytes(z["__config__"]).decode())
        params: dict[str, Any] = {"layers": [{} for _ in range(cfg["layers"])]}
        for key in z.files:
            if key == "__config__":
                continue
            if key.startswith("layers."):
                _, idx, name = key.split(".", 2)
                params["layers"][int(idx)][name] = z[key]
            else:
                params[key] = z[key]
    return cfg, params, None
