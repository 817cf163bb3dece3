"""Decoder-only LLM over an explicit KV cache (counterpart of
raglite_tpu/models/decoder.py).

- ``init_decoder_params``: seeded random weights at a preset's shapes (the
  same distributions as the JAX package, not the same bits), or
  ``params_from_jax`` for a JAX parameter tree (dense or ``@int8``);
  ``load_safetensors_decoder`` reads a HuggingFace checkpoint of the eight
  families the JAX package loads (Qwen2, Qwen3, Llama, Mistral, Gemma 1-3,
  Phi-3) with the port's own safetensors and ``tokenizer.json`` readers;
  ``quantize_decoder_params`` and ``init_decoder_params_quantized`` give the
  ``@int8`` layout (ops/quant_matmul.py);
- ``DecoderModel.forward``: prefill and decode over per-layer ``[B, KVH, hd,
  S]`` caches, with the JAX forward's family knobs and dtypes; attention goes
  through the hand-written CUDA kernels on the card (ops/decode_attention.py,
  ops/prefill_attention.py) and their plain versions on the CPU;
- ``TorchChatLLM``: the ``jax:<preset>``, ``jax:hf:<dir>`` and
  ``jax:ckpt:<dir>`` providers of models/llm.py (``@int8`` after any of
  them): ChatML prompts, unconstrained streamed generation with
  prompt-lookup speculation for greedy decode (models/speculative.py), the
  tool-tag filter, and batched generation (``complete_batch``: one ragged
  [B, T] prefill, then the device chunk loop or batched speculation, or the
  constrained host loop over [B, 1] forwards).  Byte-tokenizer models
  constrain ``response_format`` and forced tool calls with the byte
  automata (models/json_automaton.py, models/schema_automaton.py: a host
  loop, one forward and one logits fetch a token); a checkpoint's BPE
  tokenizer cannot, so it puts the schema or the tool call in the prompt,
  as the JAX package does.
"""

from __future__ import annotations

import codecs
import json
import math
import os
import re
import uuid
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from raglite_tpu_torch.models.speculative import (
    _NO_TOKEN,
    _categorical,
    _filtered_probs,
    speculate_chunk_device,
)
from raglite_tpu_torch.models.json_automaton import JsonAutomaton
from raglite_tpu_torch.models.schema_automaton import SchemaAutomaton
from raglite_tpu_torch.models.tokenizer import ByteTokenizer
from raglite_tpu_torch.ops.decode_attention import gqa_decode_attention, gqa_verify_attention
from raglite_tpu_torch.ops.prefill_attention import gqa_prefill_attention
from raglite_tpu_torch.ops.quant_matmul import (
    QuantLinear,
    QuantLinearFused,
    quant_linear_apply,
    quant_linear_apply_fused,
)
from raglite_tpu_torch.utils.padding import bucket as _bucket_any
from raglite_tpu_torch.utils.padding import round_up

__all__ = [
    "DECODE_CHUNK",
    "DecoderModel",
    "SPEC_DRAFT_LEN",
    "TorchChatLLM",
    "compute_inv_freq",
    "init_decoder_params",
    "init_decoder_params_quantized",
    "load_safetensors_decoder",
    "params_from_jax",
    "quantize_decoder_params",
]

Params = dict[str, Any]

#: Widest window routed to the verify kernel (speculative drafts are K + 1 <=
#: ~9 tokens); wider windows are prefill and take the prefill kernel.
_VERIFY_KERNEL_MAX_T = 16

#: Tokens emitted per decode chunk: one host fetch per chunk.  Must divide
#: the cache-length buckets (64-multiples).
DECODE_CHUNK = 32

#: Draft tokens verified per speculative forward (window = draft + 1).
SPEC_DRAFT_LEN = int(os.environ.get("RAGLITE_TPU_SPEC_K", "7"))
if not 1 <= SPEC_DRAFT_LEN <= DECODE_CHUNK - 1:
    msg = (
        f"RAGLITE_TPU_SPEC_K={SPEC_DRAFT_LEN} is invalid: speculative draft "
        f"length must be in [1, {DECODE_CHUNK - 1}] (window of draft+1 "
        f"tokens must fit a {DECODE_CHUNK}-token decode chunk)"
    )
    raise ValueError(msg)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with f32 scales; the result takes the input's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotary embedding in f32.  x: [B, H, T, Dh], positions: [B, T],
    inv_freq: [Dh/2] (carries any rope_scaling)."""
    angles = positions[:, None, :, None].to(torch.float32) * inv_freq  # [B, 1, T, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def compute_inv_freq(cfg: dict) -> np.ndarray:
    """RoPE inverse frequencies [head_dim/2] with the checkpoint's
    rope_scaling ("llama3" frequency-dependent scaling, "linear" position
    interpolation)."""
    head_dim = cfg.get("head_dim") or cfg["d_model"] // cfg["heads"]
    base = float(cfg.get("rope_base", 10000.0))
    half = head_dim // 2
    inv_freq = base ** (-np.arange(half, dtype=np.float64) / half)
    scaling = cfg.get("rope_scaling") or {}
    rope_type = scaling.get("rope_type") or scaling.get("type")
    if rope_type == "llama3":
        factor = float(scaling["factor"])
        low = float(scaling.get("low_freq_factor", 1.0))
        high = float(scaling.get("high_freq_factor", 4.0))
        original = float(scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * np.pi / inv_freq
        smooth = np.clip((original / wavelen - low) / max(high - low, 1e-9), 0.0, 1.0)
        scaled = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = np.where(
            wavelen < original / high, inv_freq,
            np.where(wavelen > original / low, inv_freq / factor, scaled),
        )
    elif rope_type == "linear":
        inv_freq = inv_freq / float(scaling["factor"])
    elif rope_type is not None:
        import warnings

        warnings.warn(f"unsupported rope_scaling type {rope_type!r}: using unscaled RoPE", stacklevel=2)
    return inv_freq.astype(np.float32)


def _linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a dense matrix or a QuantLinear (int8 weights)."""
    if isinstance(w, QuantLinear):
        return quant_linear_apply(x, w)
    return x @ w


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` returned in f32, its products summed in f32 and rounded
    once (a row-parallel shard's partial, which the tensor-parallel reduce
    adds in f32 before the one rounding a single device makes): cuBLAS's
    matmul with an f32 output for bf16/f16 CUDA tensors, the f32 matmul of
    the same values otherwise."""
    if x.is_cuda and x.dtype != torch.float32:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[1])
    return x.to(torch.float32) @ w.to(torch.float32)


#: Per-layer matrices, in the order they are drawn.
_LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_layer(layer: dict) -> dict:
    """One layer's matmul weights in the int8 decode layout: q/k/v fused
    into ``wqkv``, gate/up into ``w_gate_up``, ``wo`` and ``w_down`` alone;
    norms and biases kept."""
    out = {k: v for k, v in layer.items() if k not in _LAYER_MATRICES}
    out["wqkv"] = QuantLinearFused.from_dense([layer["wq"], layer["wk"], layer["wv"]])
    out["w_gate_up"] = QuantLinearFused.from_dense([layer["w_gate"], layer["w_up"]])
    out["wo"] = QuantLinear.from_dense(layer["wo"])
    out["w_down"] = QuantLinear.from_dense(layer["w_down"])
    return out


def quantize_decoder_params(params: Params) -> Params:
    """Every decode matmul weight in int8 with per-output-channel scales:
    attention q/k/v (fused) and o, MLP gate/up (fused) and down, and the
    lm_head.  The embedding (a gather), norms and biases keep their dtype."""
    out = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
    out["lm_head"] = QuantLinear.from_dense(params["lm_head"])
    out["layers"] = [_quantize_layer(layer) for layer in params["layers"]]
    return out


def _draw_params(cfg: dict, *, seed: int, dtype: torch.dtype, device, quantize: bool = False) -> Params:
    """Seeded random weights drawn on ``device`` from one ``torch.Generator``
    in a fixed order; with ``quantize`` the lm_head and each layer go to the
    int8 layout as soon as they are drawn (one ``dtype`` layer at a time)."""
    d, ff, vocab = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    heads, kv_heads = cfg["heads"], cfg["kv_heads"]
    head_dim = d // heads
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(std).to(dtype)

    def dense(shape) -> torch.Tensor:
        return normal(shape, 1.0 / math.sqrt(shape[0]))

    def ones() -> torch.Tensor:
        return torch.ones(d, dtype=torch.float32, device=device)

    params: Params = {"tok_emb": normal((vocab, d), 0.02), "final_norm": ones()}
    lm_head = dense((d, vocab))
    params["lm_head"] = QuantLinear.from_dense(lm_head) if quantize else lm_head
    del lm_head
    params["layers"] = []
    for _ in range(cfg["layers"]):
        layer = {"attn_norm": ones()}
        for name, shape in zip(_LAYER_MATRICES, [
            (d, heads * head_dim), (d, kv_heads * head_dim), (d, kv_heads * head_dim), (heads * head_dim, d),
            (d, ff), (d, ff), (ff, d),
        ]):
            layer[name] = dense(shape)
        layer["mlp_norm"] = ones()
        params["layers"].append(_quantize_layer(layer) if quantize else layer)
    return params


def init_decoder_params(
    cfg: dict,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> Params:
    """Seeded random weights at ``cfg``'s shapes, drawn on ``device`` from a
    ``torch.Generator``: the JAX package's distributions (matrices N(0, 1) /
    sqrt(fan_in) drawn in f32 then cast, embeddings N(0, 0.02^2), unit
    norms), not its bits.  Matrices keep the JAX layout [in, out]."""
    return _draw_params(cfg, seed=seed, dtype=dtype, device=device)


def init_decoder_params_quantized(
    cfg: dict,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> Params:
    """The same weights straight into the ``@int8`` layout, one layer at a
    time: each layer is quantized as soon as it is drawn and its ``dtype``
    matrices dropped, so the peak is the int8 total plus one layer (and the
    embedding), not both totals.  Equal to
    ``quantize_decoder_params(init_decoder_params(cfg, seed=seed))``."""
    return _draw_params(cfg, seed=seed, dtype=dtype, device=device, quantize=True)


#: Parameters that stay f32 whatever the matrices' dtype (norm scales and
#: attention biases, as the JAX package stores them).
_F32_LEAVES = frozenset({
    "final_norm", "attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
    "q_norm", "k_norm", "bq", "bk", "bv",
})


def _host_tensor(x) -> torch.Tensor:
    """A torch tensor of a tensor (as ``load_checkpoint`` returns them) or of
    any array numpy can read; bf16 arrays (JAX's) through their 2-byte
    words."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def params_from_jax(
    params: Params, *, dtype: torch.dtype = torch.bfloat16, device: str | torch.device = "cpu"
) -> Params:
    """A ``JaxChatLLM.params`` tree (arrays numpy can read; ``@int8``
    QuantLinear / QuantLinearFused leaves carried as they are: int8 blocks
    and f32 scales) -> this module's parameter dict: the same names and
    layouts, matrices in ``dtype``, norms and biases in f32."""

    def leaf(name: str, x):
        if hasattr(x, "n_outs"):
            return QuantLinearFused(_host_tensor(x.q8).to(device), _host_tensor(x.s8).to(device, torch.float32), x.n_outs)
        if hasattr(x, "n_out"):
            return QuantLinear(_host_tensor(x.q8).to(device), _host_tensor(x.s8).to(device, torch.float32), x.n_out)
        return _host_tensor(x).to(device=device, dtype=torch.float32 if name in _F32_LEAVES else dtype)

    out: Params = {k: leaf(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: leaf(k, v) for k, v in layer.items()} for layer in params["layers"]]
    return out


def _hf_config(hf: dict) -> dict:
    """The decoder config of a HuggingFace ``config.json`` (the JAX
    package's mapping, family knobs included)."""
    model_type = hf.get("model_type", "")
    is_gemma = model_type.startswith("gemma")
    num_layers = hf["num_hidden_layers"]
    # Per-layer local (sliding-window) attention: modern configs list
    # layer_types; older ones imply the pattern from the family.
    layer_types = hf.get("layer_types")
    if layer_types:
        layer_sliding = [t == "sliding_attention" for t in layer_types]
    elif hf.get("sliding_window") and hf.get("use_sliding_window", True):
        # Qwen2/2.5 ship a sliding_window with use_sliding_window=false and
        # attend globally: the window size alone would mask long prompts.
        if model_type == "gemma2":  # alternating, sliding on even layers
            layer_sliding = [i % 2 == 0 for i in range(num_layers)]
        elif model_type == "gemma3_text":  # 5 local : 1 global
            pattern = hf.get("sliding_window_pattern", 6)
            layer_sliding = [(i + 1) % pattern != 0 for i in range(num_layers)]
        elif model_type == "qwen2":  # the window only above max_window_layers
            mwl = hf.get("max_window_layers", 0)
            layer_sliding = [i >= mwl for i in range(num_layers)]
        else:  # Mistral, Phi-3: every layer
            layer_sliding = [True] * num_layers
    else:
        layer_sliding = None
    act = hf.get("hidden_activation") or hf.get("hidden_act")
    return dict(
        layers=num_layers,
        d_model=hf["hidden_size"],
        heads=hf["num_attention_heads"],
        kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        d_ff=hf["intermediate_size"],
        vocab=hf["vocab_size"],
        max_len=hf.get("max_position_embeddings", 32768),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
        rope_base=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        rope_scaling=hf.get("rope_scaling"),
        hidden_act=(
            "gelu_pytorch_tanh"
            if is_gemma and act in (None, "gelu", "gelu_pytorch_tanh")
            else act or "silu"
        ),
        emb_scale=hf["hidden_size"] ** 0.5 if is_gemma else 1.0,
        attn_scale=float(hf["query_pre_attn_scalar"]) ** -0.5 if hf.get("query_pre_attn_scalar") else None,
        attn_softcap=hf.get("attn_logit_softcapping"),
        final_softcap=hf.get("final_logit_softcapping"),
        sliding_window=hf.get("sliding_window"),
        layer_sliding=layer_sliding,
        rope_local_base=hf.get("rope_local_base_freq"),
    )


def load_safetensors_decoder(
    path: str,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
    quantize: bool = False,
):
    """A HuggingFace decoder checkpoint directory (``config.json``, one or
    more ``*.safetensors`` shards, ``tokenizer.json``) in this module's
    layout; returns ``(cfg, params, tokenizer)``.  Families: Qwen2 (q/k/v
    biases), Qwen3 and Gemma3 (per-head q/k norms), Llama, Mistral, Gemma
    1-3 (``1 + w`` norms, sqrt(d) embedding scale, GeGLU, sandwich norms,
    soft-caps, sliding layers, a local RoPE base) and Phi-3 (packed qkv and
    gate_up, split here).

    Tensors go from the mapped files to ``device`` one at a time (the port's
    own reader: no ``safetensors`` package, BF16 included); HF's ``[out,
    in]`` matrices become ``[in, out]`` as transposed views on the device,
    not copies, and a tied lm_head is a view of the embedding.  With
    ``quantize`` each layer goes to the ``@int8`` layout as soon as it is
    read, so the peak is the int8 total plus one layer and the embedding.
    A missing ``tokenizer.json`` warns and falls back to the byte
    tokenizer (numerics-only use), as in the JAX package."""
    from raglite_tpu_torch.models.safetensors_io import SafetensorsReader
    from raglite_tpu_torch.models.tokenizer import load_tokenizer

    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = _hf_config(hf)
    is_gemma = hf.get("model_type", "").startswith("gemma")
    q_size = cfg["heads"] * cfg["head_dim"]
    kv_size = cfg["kv_heads"] * cfg["head_dim"]
    with SafetensorsReader(path) as r:

        def mat(name: str) -> torch.Tensor:  # HF [out, in] -> [in, out]
            return r.get(name, device=device, dtype=dtype).T

        def vec(name: str) -> torch.Tensor:
            return r.get(name, device=device, dtype=torch.float32)

        def norm(name: str) -> torch.Tensor:
            # Gemma's RMSNorms scale by (1 + w): folded here, so one
            # _rms_norm serves every family.
            w = vec(name)
            return w + 1.0 if is_gemma else w

        params: Params = {
            "tok_emb": r.get("model.embed_tokens.weight", device=device, dtype=dtype),
            "final_norm": norm("model.norm.weight"),
        }
        lm_head = mat("lm_head.weight") if "lm_head.weight" in r else params["tok_emb"].T  # tied
        params["lm_head"] = QuantLinear.from_dense(lm_head) if quantize else lm_head
        del lm_head
        params["layers"] = []
        for i in range(cfg["layers"]):
            b = f"model.layers.{i}."
            layer: dict[str, torch.Tensor] = {
                "attn_norm": norm(b + "input_layernorm.weight"),
                "wo": mat(b + "self_attn.o_proj.weight"),
                "w_down": mat(b + "mlp.down_proj.weight"),
            }
            if b + "self_attn.qkv_proj.weight" in r:  # Phi-3: packed [q + 2 kv, d]
                qkv = mat(b + "self_attn.qkv_proj.weight")
                layer["wq"], layer["wk"], layer["wv"] = qkv.split([q_size, kv_size, kv_size], dim=1)
            else:
                layer["wq"] = mat(b + "self_attn.q_proj.weight")
                layer["wk"] = mat(b + "self_attn.k_proj.weight")
                layer["wv"] = mat(b + "self_attn.v_proj.weight")
            if b + "mlp.gate_up_proj.weight" in r:  # Phi-3: packed [2 ff, d]
                layer["w_gate"], layer["w_up"] = mat(b + "mlp.gate_up_proj.weight").split(cfg["d_ff"], dim=1)
            else:
                layer["w_gate"] = mat(b + "mlp.gate_proj.weight")
                layer["w_up"] = mat(b + "mlp.up_proj.weight")
            if b + "pre_feedforward_layernorm.weight" in r:  # Gemma2/3 sandwich norms
                layer["post_attn_norm"] = norm(b + "post_attention_layernorm.weight")
                layer["mlp_norm"] = norm(b + "pre_feedforward_layernorm.weight")
                layer["post_mlp_norm"] = norm(b + "post_feedforward_layernorm.weight")
            else:  # Llama family: post_attention_layernorm is the pre-MLP norm
                layer["mlp_norm"] = norm(b + "post_attention_layernorm.weight")
            if b + "self_attn.q_proj.bias" in r:  # Qwen2
                layer["bq"] = vec(b + "self_attn.q_proj.bias")
                layer["bk"] = vec(b + "self_attn.k_proj.bias")
                layer["bv"] = vec(b + "self_attn.v_proj.bias")
            if b + "self_attn.q_norm.weight" in r:  # Qwen3, Gemma3
                layer["q_norm"] = norm(b + "self_attn.q_norm.weight")
                layer["k_norm"] = norm(b + "self_attn.k_norm.weight")
            params["layers"].append(_quantize_layer(layer) if quantize else layer)
    tokenizer = load_tokenizer(os.path.join(path, "tokenizer.json"), required=False)
    return cfg, params, tokenizer


class DecoderModel:
    """Forward passes over an explicit KV cache; the family knobs of the JAX
    ``DecoderModel``: ``head_dim``, ``rope_base``, ``rms_eps``, ``emb_scale``,
    ``hidden_act`` (SwiGLU or GeGLU), ``attn_scale``, ``attn_softcap`` /
    ``final_softcap``, ``sliding_window`` + ``layer_sliding``,
    ``rope_local_base``; layer params optionally carry q/k/v biases, q/k
    norms and sandwich norms."""

    def __init__(self, cfg: dict) -> None:
        self.cfg = cfg
        self.head_dim = cfg.get("head_dim") or cfg["d_model"] // cfg["heads"]
        self.rms_eps = float(cfg.get("rms_eps", 1e-6))
        self.attn_scale = float(cfg.get("attn_scale") or self.head_dim**-0.5)
        self.emb_scale = float(cfg.get("emb_scale") or 1.0)
        self.attn_softcap = cfg.get("attn_softcap")
        self.final_softcap = cfg.get("final_softcap")
        self.hidden_act = cfg.get("hidden_act", "silu")
        self.sliding_window = cfg.get("sliding_window")
        self.layer_sliding = cfg.get("layer_sliding") or [False] * cfg["layers"]
        self._inv_freq = torch.from_numpy(compute_inv_freq(cfg))
        if cfg.get("rope_local_base"):
            local_cfg = {**cfg, "rope_base": cfg["rope_local_base"], "rope_scaling": None}
            self._inv_freq_local = torch.from_numpy(compute_inv_freq(local_cfg))
        else:
            self._inv_freq_local = self._inv_freq
        self._tables: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def _freqs(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        if device not in self._tables:
            self._tables[device] = (self._inv_freq.to(device), self._inv_freq_local.to(device))
        return self._tables[device]

    def init_cache(
        self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16, device: str | torch.device = "cpu"
    ) -> dict:
        """Per-layer K and V buffers ``[B, KVH, hd, S]``, sequence minor-most
        (the layout both attention contractions read).  ``forward`` writes
        them IN PLACE: a cache passed to it is updated, not copied (the JAX
        package gets the same effect by donating the buffers)."""
        shape = (batch, self.cfg["kv_heads"], self.head_dim, max_len)
        layers = self.cfg["layers"]
        return {
            "k": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)],
        }

    def forward(
        self,
        params: Params,
        ids: torch.Tensor,  # [B, T] integer
        cache: dict,
        cache_len: int | torch.Tensor,  # tokens already in the cache: scalar or [B]
        last_positions: torch.Tensor | None = None,  # [B]: emit logits only there
    ) -> tuple[torch.Tensor, dict]:
        """Run T tokens starting at ``cache_len``; returns logits [B, T, V]
        f32 (or [B, V] at ``last_positions``) and the cache, updated in
        place.  Row b writes its keys and values at ``min(cache_len[b], S -
        T)``, the clamp of JAX's ``dynamic_update_slice``.  Attention takes
        the decode kernel at T = 1, the verify kernel at T <= 16 and the
        prefill kernel above; on CPU tensors each is its plain version."""
        b, t = ids.shape
        device = ids.device
        s = self._cache_seq(cache)
        row_offsets = torch.as_tensor(cache_len, device=device).to(torch.int64)
        if row_offsets.ndim == 0:
            row_offsets = row_offsets.expand(b)
        steps = torch.arange(t, device=device)
        inv_freq_global, inv_freq_local = self._freqs(device)
        pos = {
            "positions": row_offsets[:, None] + steps[None, :],  # [B, T]
            # KV write columns: the clamped start per row, then T
            # consecutive slots.
            "write_cols": torch.clamp(row_offsets, max=s - t)[:, None] + steps[None, :],  # [B, T]
            # The attention kernels read int32 positions: made once a
            # forward, not once a layer.
            "offsets": row_offsets.to(torch.int32).contiguous(),
        }
        x = params["tok_emb"][ids]
        if self.emb_scale != 1.0:
            x = x * torch.tensor(self.emb_scale, dtype=x.dtype)
        for li, layer in enumerate(params["layers"]):
            sliding = self.layer_sliding[li] and self.sliding_window
            pos["inv_freq"] = inv_freq_local if self.layer_sliding[li] else inv_freq_global
            pos["window"] = int(self.sliding_window if sliding else 0)
            h = _rms_norm(x, layer["attn_norm"], self.rms_eps)
            attn_out = self._attention(li, layer, h, cache, pos)
            if "post_attn_norm" in layer:
                attn_out = _rms_norm(attn_out, layer["post_attn_norm"], self.rms_eps)
            x = x + attn_out
            h = _rms_norm(x, layer["mlp_norm"], self.rms_eps)
            mlp_out = self._mlp(layer, h)
            if "post_mlp_norm" in layer:
                mlp_out = _rms_norm(mlp_out, layer["post_mlp_norm"], self.rms_eps)
            x = x + mlp_out
        x = _rms_norm(x, params["final_norm"], self.rms_eps)
        if last_positions is not None:
            x = x[torch.arange(b, device=device), last_positions.to(device)]  # [B, d]
        logits = self._lm_head(params, x).to(torch.float32)
        if self.final_softcap:
            logits = self.final_softcap * torch.tanh(logits / self.final_softcap)
        return logits, cache

    # The three sublayers a tensor-parallel model runs per shard
    # (parallel/tp_decoder.py:TPDecoderModel overrides the first four).

    def _cache_seq(self, cache: dict) -> int:
        """The caches' sequence capacity S."""
        return cache["k"][0].shape[3]

    def _attention(self, li: int, layer: dict, h: torch.Tensor, cache: dict, pos: dict) -> torch.Tensor:
        return self._attend(layer, h, cache["k"][li], cache["v"][li], pos, self.cfg["heads"], self.cfg["kv_heads"])

    def _mlp(self, layer: dict, h: torch.Tensor) -> torch.Tensor:
        return self._gated_mlp(layer, h)

    def _lm_head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, params["lm_head"])

    def _attend(
        self, layer: dict, h: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: dict,
        heads: int, kv_heads: int, *, partial: bool = False,
    ) -> torch.Tensor:
        """Self-attention of ``heads`` query heads over ``kv_heads`` KV
        groups (all of them, or one tensor-parallel shard's): q/k/v
        projections, biases, q/k norms, RoPE, the KV write at
        ``pos["write_cols"]``, the attention kernel, the output
        projection.  Returns [B, T, d]; with ``partial`` (a TP shard's
        partial sum) in f32 (:func:`_matmul_f32`)."""
        hd = self.head_dim
        rep = heads // kv_heads
        b, t, _ = h.shape
        if "wqkv" in layer:  # int8: one matmul for q, k and v
            q, k, v = quant_linear_apply_fused(h, layer["wqkv"])
        else:
            q = h @ layer["wq"]
            k = h @ layer["wk"]
            v = h @ layer["wv"]
        if "bq" in layer:
            q = q + layer["bq"]
            k = k + layer["bk"]
            v = v + layer["bv"]
        q = q.reshape(b, t, heads, hd).transpose(1, 2)
        k = k.reshape(b, t, kv_heads, hd).transpose(1, 2)
        v = v.reshape(b, t, kv_heads, hd).transpose(1, 2)
        if "q_norm" in layer:
            q = _rms_norm(q, layer["q_norm"], self.rms_eps)
            k = _rms_norm(k, layer["k_norm"], self.rms_eps)
        q = _rope(q, pos["positions"], pos["inv_freq"])
        k = _rope(k, pos["positions"], pos["inv_freq"])
        write_cols = pos["write_cols"][:, None, None, :].expand(b, kv_heads, hd, t)
        k_cache.scatter_(3, write_cols, k.transpose(2, 3).to(k_cache.dtype))
        v_cache.scatter_(3, write_cols, v.transpose(2, 3).to(v_cache.dtype))
        qg = q.reshape(b, kv_heads, rep, t, hd).to(k_cache.dtype)
        kw = dict(scale=self.attn_scale, softcap=float(self.attn_softcap or 0.0), window=pos["window"])
        offsets = pos["offsets"]
        if t == 1:
            ctx = gqa_decode_attention(qg[:, :, :, 0], k_cache, v_cache, offsets, **kw)[:, :, :, None]
        elif t <= _VERIFY_KERNEL_MAX_T:
            ctx = gqa_verify_attention(qg, k_cache, v_cache, offsets, **kw)
        else:
            ctx = gqa_prefill_attention(qg, k_cache, v_cache, offsets, **kw)
        ctx = ctx.reshape(b, heads, t, hd).transpose(1, 2).reshape(b, t, heads * hd).to(h.dtype)
        return _matmul_f32(ctx, layer["wo"]) if partial else _linear(ctx, layer["wo"])

    def _gated_mlp(self, layer: dict, h: torch.Tensor, *, partial: bool = False) -> torch.Tensor:
        """Gated MLP, gate and up in f32: SwiGLU or GeGLU.  Returns [B, T, d];
        with ``partial`` (a TP shard's partial sum) in f32."""
        if "w_gate_up" in layer:  # int8: one matmul for gate and up
            gate_pre, up = quant_linear_apply_fused(h, layer["w_gate_up"])
            gate_pre, up = gate_pre.to(torch.float32), up.to(torch.float32)
        else:
            gate_pre = (h @ layer["w_gate"]).to(torch.float32)
            up = (h @ layer["w_up"]).to(torch.float32)
        gate = (
            F.gelu(gate_pre, approximate="tanh")
            if self.hidden_act == "gelu_pytorch_tanh"
            else F.silu(gate_pre)
        )
        act = (gate * up).to(h.dtype)
        return _matmul_f32(act, layer["w_down"]) if partial else _linear(act, layer["w_down"])


def _prefill_last(model: DecoderModel, params: Params, ids, cache, lens):
    """Prefill emitting only each row's last-prompt-position logits [B, V]:
    the rows before are gathered away ahead of the lm_head (a [1, 8192,
    151936] f32 logits tensor would be 5 GB)."""
    return model.forward(params, ids, cache, 0, last_positions=lens - 1)


def _bucket(n: int, minimum: int = 64) -> int:  # prompt buckets start small
    return _bucket_any(n, minimum)


def _max_new(sampling: dict, default: int) -> int:
    """Generation budget: ``max_tokens`` (OpenAI-style), ``max_new_tokens``
    accepted as an alias."""
    return int(sampling.get("max_tokens", sampling.get("max_new_tokens", default)))


def _decode_chunk_device(  # noqa: PLR0913
    model: DecoderModel,
    cache,
    params,
    cache_lens: torch.Tensor,  # [B] int64
    last_logits: torch.Tensor,  # [B, V] f32: logits the next token is sampled from
    logits_mask: torch.Tensor,  # [V] f32 additive mask (0 / -inf), applied every step
    done: torch.Tensor,  # [B] bool
    stop_ids: torch.Tensor,  # [K] int64 (padded with -7)
    gen: torch.Generator,
    *,
    num_steps: int,
    temperature: float,
    top_p: float,
    top_k: int,
    min_p: float,
):
    """``num_steps`` decode iterations: sample (the host sampler's
    temperature/top-k/top-p/min-p semantics), stop check, KV append, next
    forward.  The JAX version is a ``lax.while_loop`` that also ends once
    every row is done; this host loop runs a FIXED trip count instead and
    lets done rows idle (feed 0, no cache advance, ``_NO_TOKEN`` out), so
    the chunk needs no host read until its one fetch of the tokens.  Returns
    (tokens [B, num_steps], cache, cache_lens, last_logits, done)."""
    b = last_logits.shape[0]
    out = torch.full((b, num_steps), _NO_TOKEN, dtype=torch.int64, device=last_logits.device)
    logits = last_logits
    for step in range(num_steps):
        masked = logits + logits_mask[None, :]
        if temperature == 0.0:
            token = torch.argmax(masked, dim=-1)
        else:
            probs = _filtered_probs(masked, temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p)
            token = _categorical(probs, gen)
        is_stop = (token[:, None] == stop_ids[None, :]).any(dim=1)
        done = done | is_stop
        out[:, step] = torch.where(done, _NO_TOKEN, token)
        feed = torch.where(done, 0, token)
        new_logits, cache = model.forward(params, feed[:, None], cache, cache_lens)
        cache_lens = cache_lens + (~done).to(cache_lens.dtype)
        logits = new_logits[:, -1]
    return out, cache, cache_lens, logits, done


def _forward_one(model: DecoderModel, params, token: int, cache, cache_len: int) -> torch.Tensor:
    """One-token decode forward at ``cache_len``; returns the logits [V]."""
    device = params["tok_emb"].device
    ids = torch.tensor([[token]], dtype=torch.int64, device=device)
    logits, _ = model.forward(params, ids, cache, cache_len)
    return logits[0, -1]


def _forward_step_batch(model: DecoderModel, params, tokens: torch.Tensor, cache, cache_lens: torch.Tensor) -> torch.Tensor:
    """One decode step for a batch at per-row offsets; returns the logits
    [B, V]."""
    logits, _ = model.forward(params, tokens[:, None], cache, cache_lens)
    return logits[:, -1]


def _automaton_for(response_format: dict | None):
    """The byte automaton a response format asks for: a SchemaAutomaton for
    a ``json_schema`` with a schema, a JsonAutomaton for any other JSON
    format, None for none."""
    if not response_format:
        return None
    schema = (response_format.get("json_schema") or {}).get("schema")
    if schema:
        return SchemaAutomaton(schema)
    if response_format.get("type") in ("json_object", "json_schema"):
        return JsonAutomaton()
    return None


class TorchChatLLM:
    """Chat LLM over the port's decoder: the ``jax:<spec>`` provider
    (ChatML prompts, streamed generation, the ``<tool_call>{json}</tool_call>``
    tool protocol, JSON response formats and forced tool calls, batched
    completion).

    ``spec``: a preset (seeded random weights at its shapes; an unknown name
    is ``tiny``, as in the JAX package), ``hf:<dir>`` (a HuggingFace
    safetensors checkpoint with its ``tokenizer.json``) or ``ckpt:<dir>``
    (an orbax checkpoint of the JAX package's layout, in its saved dtype,
    byte tokenizer), each
    optionally followed by ``@int8`` (int8 matmul weights, per-output-channel
    scales; presets and ``hf:`` quantize layer by layer as they are made)."""

    supports_function_calling = True

    _PRESETS = {
        "tiny": dict(layers=2, d_model=128, heads=4, kv_heads=2, d_ff=256, vocab=512, max_len=1024),
        "small": dict(layers=8, d_model=512, heads=8, kv_heads=4, d_ff=1408, vocab=32768, max_len=4096),
        "base": dict(layers=24, d_model=1024, heads=16, kv_heads=8, d_ff=2816, vocab=151936, max_len=8192),
        # 4B-class (the reference's default local LLM is a Qwen3-4B-class
        # model): 36 layers x d2560, GQA 20q/4kv (head_dim 128), SwiGLU ff
        # 9728, untied 151936 lm_head; 8.06 GB of bf16 weights.
        "large": dict(layers=36, d_model=2560, heads=20, kv_heads=4, d_ff=9728, vocab=151936, max_len=8192),
    }

    #: Recommended sampling for Qwen-class models; not applied implicitly
    #: (generation defaults to greedy).
    RECOMMENDED_SAMPLING = {"temperature": 0.7, "top_p": 0.8, "top_k": 20, "min_p": 0.0}

    def __init__(
        self,
        spec: str = "tiny",
        *,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            msg = f"device={str(device)!r} but CUDA is not available (pass device='cpu')"
            raise RuntimeError(msg)
        self.quantized = spec.endswith("@int8")
        if self.quantized:
            spec = spec.removesuffix("@int8")
        if spec.startswith("ckpt:"):
            from raglite_tpu_torch.models.checkpoint import load_checkpoint

            tree, cfg = load_checkpoint(spec.removeprefix("ckpt:"), device=self.device)
            # The weights keep the dtype they were saved in, as in the JAX
            # package.
            params = params_from_jax(tree, dtype=_host_tensor(tree["tok_emb"]).dtype, device=self.device)
            del tree
            tokenizer = ByteTokenizer(vocab_size=cfg["vocab"])
        elif spec.startswith("hf:"):
            cfg, params, tokenizer = load_safetensors_decoder(
                spec.removeprefix("hf:"), dtype=dtype, device=self.device, quantize=self.quantized
            )
        else:
            cfg = dict(self._PRESETS.get(spec, self._PRESETS["tiny"]))
            init = init_decoder_params_quantized if self.quantized else init_decoder_params
            params = init(cfg, seed=seed, dtype=dtype, device=self.device)
            tokenizer = ByteTokenizer(vocab_size=cfg["vocab"])
        if self.quantized and not isinstance(params["lm_head"], QuantLinear):
            params = quantize_decoder_params(params)
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.model = DecoderModel(cfg)
        self.context_size = cfg["max_len"]
        # The byte automata (JSON response formats, forced tool calls) need
        # the byte tokenizer; a checkpoint's BPE puts the schema or the call
        # in the prompt instead.
        self._byte_level = isinstance(tokenizer, ByteTokenizer)
        self.supports_response_format = self._byte_level
        # Every eos id of the checkpoint (Llama-3 instruct lists two), plus
        # the chat end markers its vocabulary has.
        self._stop_ids = {tokenizer.EOS, *tokenizer.EOS_IDS}
        if not self._byte_level:
            for name in ("<|im_end|>", "<|endoftext|>", "<|eot_id|>", "<end_of_turn>"):
                tid = tokenizer.token_id(name)
                if tid is not None:
                    self._stop_ids.add(tid)
        self.spec_stats: dict | None = None

    def save_checkpoint(self, path: str) -> None:
        """Write an orbax checkpoint of the JAX package's layout, loadable
        as ``ckpt:<path>`` by either package."""
        from raglite_tpu_torch.models.checkpoint import save_checkpoint

        if self.quantized:
            msg = "save_checkpoint on an @int8-quantized model; save the full-precision model instead"
            raise ValueError(msg)
        save_checkpoint(path, self.params, self.cfg)

    # --- Prompting --------------------------------------------------------

    def _format_messages(self, messages: list[dict[str, Any]], tools: list[dict[str, Any]] | None) -> str:
        """ChatML with an embedded tool manifest."""
        parts = []
        if tools:
            manifest = "\n".join(
                f"- {t['function']['name']}: {t['function'].get('description', '')}" for t in tools
            )
            parts.append(
                "<|im_start|>system\nYou may call tools by emitting "
                '<tool_call>{"name": ..., "arguments": {...}}</tool_call>.\n'
                f"Available tools:\n{manifest}<|im_end|>\n"
            )
        for m in messages:
            role = m.get("role", "user")
            content = m.get("content") or ""
            parts.append(f"<|im_start|>{role}\n{content}<|im_end|>\n")
        parts.append("<|im_start|>assistant\n")
        return "".join(parts)

    # --- Generation -------------------------------------------------------

    def _stop_ids_device(self) -> torch.Tensor:
        stops = torch.full((8,), -7, dtype=torch.int64)  # -7 matches no sampled token
        for i, sid in enumerate(sorted(self._stop_ids)[:8]):
            stops[i] = sid
        return stops.to(self.device)

    def _device_token_stream(  # noqa: PLR0913
        self,
        cache,
        cache_lens: torch.Tensor,
        first_logits: torch.Tensor,  # [1, V]
        done: torch.Tensor,
        *,
        max_new_tokens: int,
        logits_mask: torch.Tensor,
        temperature: float,
        top_p: float,
        top_k: int,
        min_p: float,
        seed: int,
        hist: np.ndarray | None = None,
        hist_len: int = 0,
        speculate: bool = False,
    ) -> Iterator[int]:
        """Stream tokens from the decode loop, one fetch per DECODE_CHUNK
        tokens; with ``speculate`` (and ``hist``, the prompt history) each
        chunk runs prompt-lookup speculative decoding."""
        stops = self._stop_ids_device()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        last = first_logits
        emitted = 0
        if speculate and hist is not None:
            hist_dev = torch.as_tensor(hist, dtype=torch.int64, device=self.device)[None, :]
            hl = torch.tensor([hist_len], dtype=torch.int64, device=self.device)
            reject = torch.full((1,), -1, dtype=torch.int64, device=self.device)
            tot_iters = 0
            while emitted < max_new_tokens:
                out, cache, cache_lens, last, reject, done, hist_dev, hl, n_iters = speculate_chunk_device(
                    self.model, cache, self.params, cache_lens, last, reject, logits_mask, done,
                    stops, gen, hist_dev, hl,
                    num_tokens=DECODE_CHUNK, draft_len=SPEC_DRAFT_LEN, pad_id=int(self.tokenizer.PAD),
                    temperature=float(temperature), top_p=float(top_p), top_k=int(top_k), min_p=float(min_p),
                )
                fetched = torch.cat([out[0], done[:1].to(out.dtype)]).tolist()
                tokens, row_done = fetched[:-1], bool(fetched[-1])
                tot_iters += n_iters
                for token in tokens:
                    if token == _NO_TOKEN or emitted >= max_new_tokens:
                        break
                    yield int(token)
                    emitted += 1
                # Verified tokens per forward, for benchmarks and tests.
                self.spec_stats = {"tokens": emitted, "verify_iters": tot_iters}
                if emitted >= max_new_tokens or row_done:
                    return
                if all(token == _NO_TOKEN for token in tokens):
                    return  # budget-capped chunk emitted nothing new
            return
        while emitted < max_new_tokens:
            out, cache, cache_lens, last, done = _decode_chunk_device(
                self.model, cache, self.params, cache_lens, last, logits_mask, done, stops, gen,
                num_steps=DECODE_CHUNK, temperature=float(temperature), top_p=float(top_p),
                top_k=int(top_k), min_p=float(min_p),
            )
            fetched = torch.cat([out[0], done[:1].to(out.dtype)]).tolist()
            for token in fetched[:-1]:
                if token == _NO_TOKEN or emitted >= max_new_tokens:
                    return
                yield int(token)
                emitted += 1
            if fetched[-1]:
                return

    @staticmethod
    def _sample_host(
        logits: np.ndarray,
        *,
        temperature: float,
        top_p: float,
        top_k: int,
        min_p: float,
        rng: np.random.Generator,
    ) -> int:
        """Temperature, top-k, min-p and nucleus (top-p) sampling over one
        logit vector on the host (the constrained loops' sampler; the JAX
        package's, so equal logits and seed give equal tokens)."""
        if temperature <= 0.0:
            return int(np.argmax(logits))
        finite = np.isfinite(logits)
        scaled = np.where(finite, logits / max(temperature, 1e-4), -np.inf)
        probs = np.exp(scaled - np.max(scaled[finite]))
        probs = np.where(finite, probs, 0.0)
        probs /= probs.sum()
        if top_k and top_k > 0:
            cutoff = np.partition(probs, -top_k)[-top_k]
            probs = np.where(probs >= cutoff, probs, 0.0)
        if min_p and min_p > 0.0:
            probs = np.where(probs >= min_p * probs.max(), probs, 0.0)
        if top_p and top_p < 1.0:
            probs /= probs.sum()  # renormalize after top-k/min-p zeroing
            order = np.argsort(probs)[::-1]
            sorted_probs = probs[order]
            csum = np.cumsum(sorted_probs)
            # Keep every token whose PRECEDING mass is below top_p (the
            # threshold-crossing token stays in the set).
            keep = (csum - sorted_probs) < top_p
            mask = np.zeros_like(probs, dtype=bool)
            mask[order[keep]] = True
            probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
        return int(rng.choice(len(probs), p=probs))

    def _base_mask(self) -> np.ndarray:
        """Additive logits mask [V] f32: only byte tokens and EOS are valid
        outputs of the byte tokenizer; a BPE model may emit any id."""
        if not self._byte_level:
            return np.zeros((self.cfg["vocab"],), dtype=np.float32)
        mask = np.full((self.cfg["vocab"],), -np.inf, dtype=np.float32)
        mask[ByteTokenizer._OFFSET : ByteTokenizer._OFFSET + 256] = 0.0
        mask[self.tokenizer.EOS] = 0.0
        return mask

    def _byte_mask(self, automaton) -> np.ndarray:
        """Additive logits mask [V] f32 of the bytes ``automaton`` allows
        next (and EOS where it may end)."""
        mask = np.full((self.cfg["vocab"],), -np.inf, dtype=np.float32)
        idx = np.fromiter((b + ByteTokenizer._OFFSET for b in automaton.allowed_bytes()), dtype=np.int64)
        if idx.size:
            mask[idx] = 0.0
        if automaton.can_end():
            mask[self.tokenizer.EOS] = 0.0
        return mask

    @staticmethod
    def _speculate(temperature: float) -> bool:
        """Greedy decode speculates unless ``RAGLITE_TPU_SPECULATE=0``;
        sampled decode only with ``=always``/``=1``."""
        spec_mode = os.environ.get("RAGLITE_TPU_SPECULATE", "auto")
        return spec_mode != "0" and (temperature == 0.0 or spec_mode in ("1", "always"))

    def _generate_tokens(
        self,
        prompt: str,
        *,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        min_p: float = 0.0,
        json_constrained: bool = False,
        automaton=None,
        seed: int = 0,
    ) -> Iterator[int]:
        """Generation of ``prompt``'s continuation.  ``automaton`` (a
        JsonAutomaton or SchemaAutomaton) constrains the byte stream, and
        ``json_constrained`` is the schema-less shorthand: then each token is
        sampled on the host under the automaton's mask, one forward and one
        logits fetch a token, and a budget that runs out mid-document ends
        with the automaton's closing bytes.  Unconstrained decode runs in
        device chunks (greedy speculates; see :meth:`_speculate`).  A BPE
        model puts no BOS before the prompt and takes no automaton."""
        tok = self.tokenizer
        # Clamp the budget to the window, then keep the newest prompt tokens
        # that fit.
        max_new_tokens = max(1, min(max_new_tokens, self.context_size - 32))
        budget = max(self.context_size - max_new_tokens - 1, 16)
        ids = tok.encode(prompt)[-budget:]
        if self._byte_level:
            ids = [tok.BOS, *ids]
        pad = _bucket(len(ids))
        batch_ids = torch.full((1, pad), tok.PAD, dtype=torch.int64)
        batch_ids[0, : len(ids)] = torch.tensor(ids)
        # DECODE_CHUNK headroom: a speculative chunk commits up to
        # DECODE_CHUNK tokens of KV before the host sees the budget spent.
        max_total = pad + _bucket(max_new_tokens) + DECODE_CHUNK
        cache = self.model.init_cache(1, max_total, device=self.device)  # bf16, as the JAX package's
        lens = torch.tensor([len(ids)], dtype=torch.int64, device=self.device)
        last, cache = _prefill_last(self.model, self.params, batch_ids.to(self.device), cache, lens)
        if not self._byte_level:
            automaton = None  # the automata are byte-level
        elif automaton is None and json_constrained:
            automaton = JsonAutomaton()
        if automaton is None:
            speculate = self._speculate(temperature)
            hist0 = None
            if speculate:
                hist0 = np.full((max_total,), tok.PAD, dtype=np.int64)
                hist0[: len(ids)] = ids
            yield from self._device_token_stream(
                cache, lens, last, torch.zeros((1,), dtype=torch.bool, device=self.device),
                max_new_tokens=max_new_tokens, logits_mask=torch.from_numpy(self._base_mask()).to(self.device),
                temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p, seed=seed,
                hist=hist0, hist_len=len(ids), speculate=speculate,
            )
            return
        # Constrained: the first token from the prefill logits, then one
        # forward and one fetch a token.
        last_logits = last[0].cpu().numpy()
        cache_len = len(ids)
        rng = np.random.default_rng(seed)
        for _ in range(max_new_tokens):
            token = self._sample_host(
                last_logits + self._byte_mask(automaton), temperature=temperature, top_p=top_p,
                top_k=top_k, min_p=min_p, rng=rng,
            )
            if token in self._stop_ids:
                break
            yield token
            if token >= ByteTokenizer._OFFSET:
                automaton.feed(token - ByteTokenizer._OFFSET)
                if automaton.done():
                    return
            last_logits = _forward_one(self.model, self.params, token, cache, cache_len).cpu().numpy()
            cache_len += 1
        # Budget exhausted (or EOS) mid-document: the closing suffix keeps
        # constrained output valid JSON.
        if not automaton.done():
            for byte in automaton.completion_bytes():
                yield byte + ByteTokenizer._OFFSET

    def _generate_batch(
        self,
        prompts: list[str],
        *,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        min_p: float = 0.0,
        automatons: list | None = None,
        seed: int = 0,
    ) -> list[list[int]]:
        """Generate for many prompts at once: one ragged [B, T] prefill
        (rows of different lengths, each row's logits at its own last
        position), then each row decodes at its own cache offset.  B is
        padded to a multiple of 8 with rows that start done.  Unconstrained
        batches decode on the device (:meth:`_generate_batch_device`);
        constrained ones sample on the host row by row (one shared numpy
        Generator, rows in order) over one [B, 1] forward a step.  Returns
        one token list per prompt, automaton closing bytes included."""
        tok = self.tokenizer
        n = len(prompts)
        if n == 0:
            return []
        max_new_tokens = max(1, min(max_new_tokens, self.context_size - 32))
        budget = max(self.context_size - max_new_tokens - 1, 16)
        encoded = [tok.encode(p)[-budget:] for p in prompts]
        if self._byte_level:
            encoded = [[tok.BOS, *ids] for ids in encoded]
        encoded = [ids or [tok.BOS] for ids in encoded]
        bpad = round_up(n, 8)
        pad = _bucket(max(len(ids) for ids in encoded))
        batch_ids = torch.full((bpad, pad), tok.PAD, dtype=torch.int64)
        lens = torch.ones((bpad,), dtype=torch.int64)
        for i, ids in enumerate(encoded):
            batch_ids[i, : len(ids)] = torch.tensor(ids)
            lens[i] = len(ids)
        # DECODE_CHUNK headroom for speculative over-commit, as in the
        # single-prompt path.
        max_total = pad + _bucket(max_new_tokens) + DECODE_CHUNK
        cache = self.model.init_cache(bpad, max_total, device=self.device)
        cache_lens = lens.to(self.device)
        last, cache = _prefill_last(self.model, self.params, batch_ids.to(self.device), cache, cache_lens)
        if automatons is None or not self._byte_level or all(a is None for a in automatons):
            speculate = self._speculate(temperature)
            hist0 = None
            if speculate:
                hist0 = torch.full((bpad, max_total), tok.PAD, dtype=torch.int64)
                hist0[:, :pad] = batch_ids
            return self._generate_batch_device(
                cache, cache_lens, last, n, bpad, max_new_tokens=max_new_tokens,
                logits_mask=torch.from_numpy(self._base_mask()).to(self.device),
                temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p, seed=seed,
                hist=hist0, hist_lens=lens if speculate else None, speculate=speculate,
            )
        base_mask = self._base_mask()
        last_logits = last.cpu().numpy()
        rng = np.random.default_rng(seed)
        outputs: list[list[int]] = [[] for _ in range(n)]
        done = np.zeros(bpad, dtype=bool)
        done[n:] = True  # padding rows never generate
        step_tokens = torch.full((bpad,), tok.PAD, dtype=torch.int64)
        for _ in range(max_new_tokens):
            for i in range(n):
                if done[i]:
                    continue
                automaton = automatons[i]
                mask = self._byte_mask(automaton) if automaton is not None else base_mask
                token = self._sample_host(
                    last_logits[i] + mask, temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p, rng=rng,
                )
                if token in self._stop_ids:
                    done[i] = True
                    continue
                outputs[i].append(token)
                step_tokens[i] = token
                if automaton is not None and token >= ByteTokenizer._OFFSET:
                    automaton.feed(token - ByteTokenizer._OFFSET)
                    if automaton.done():
                        done[i] = True
            if done.all():
                break
            logits = _forward_step_batch(self.model, self.params, step_tokens.to(self.device), cache, cache_lens)
            last_logits = logits.cpu().numpy()
            cache_lens = cache_lens + 1
        for i, automaton in enumerate(automatons):
            if automaton is not None and not automaton.done():
                outputs[i].extend(byte + ByteTokenizer._OFFSET for byte in automaton.completion_bytes())
        return outputs

    def _generate_batch_device(  # noqa: PLR0913
        self,
        cache,
        cache_lens: torch.Tensor,
        first_logits: torch.Tensor,
        n: int,
        bpad: int,
        *,
        max_new_tokens: int,
        logits_mask: torch.Tensor,
        temperature: float,
        top_p: float,
        top_k: int,
        min_p: float,
        seed: int,
        hist: torch.Tensor | None = None,
        hist_lens: torch.Tensor | None = None,
        speculate: bool = False,
    ) -> list[list[int]]:
        """Batched decode on the device in DECODE_CHUNK chunks, one fetch a
        chunk for the whole batch; padding rows start done.  With
        ``speculate`` each chunk runs batched prompt-lookup speculation: rows
        accept drafts at their own rates, freeze on their own and emit
        different counts a chunk, so budgets are kept on the host and rows
        at their budget are marked done on the device."""
        stops = self._stop_ids_device()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        done = torch.arange(bpad, device=self.device) >= n
        outputs: list[list[int]] = [[] for _ in range(n)]
        finished = np.zeros(n, dtype=bool)
        last = first_logits

        def fetch(out: torch.Tensor, done: torch.Tensor) -> tuple[list[list[int]], list[int]]:
            rows = torch.cat([out[:n], done[:n, None].to(out.dtype)], dim=1).tolist()  # the chunk's one fetch
            return [r[:-1] for r in rows], [r[-1] for r in rows]

        if speculate and hist is not None:
            hist_dev = hist.to(self.device)
            hl = hist_lens.to(self.device)
            reject = torch.full((bpad,), -1, dtype=torch.int64, device=self.device)
            while not finished.all():
                out, cache, cache_lens, last, reject, done, hist_dev, hl, _ = speculate_chunk_device(
                    self.model, cache, self.params, cache_lens, last, reject, logits_mask, done,
                    stops, gen, hist_dev, hl,
                    num_tokens=DECODE_CHUNK, draft_len=SPEC_DRAFT_LEN, pad_id=int(self.tokenizer.PAD),
                    temperature=float(temperature), top_p=float(top_p), top_k=int(top_k), min_p=float(min_p),
                )
                tokens, done_rows = fetch(out, done)
                progressed = False
                for i in range(n):
                    if finished[i]:
                        continue
                    room = max_new_tokens - len(outputs[i])
                    for token in tokens[i][:room]:
                        if token == _NO_TOKEN:
                            break
                        outputs[i].append(int(token))
                        progressed = True
                    if done_rows[i] or len(outputs[i]) >= max_new_tokens:
                        finished[i] = True
                if not progressed or finished.all():  # nothing new: every live row is stuck
                    break
                # Rows at their budget stop verifying.
                done = done | torch.from_numpy(np.concatenate([finished, np.ones(bpad - n, bool)])).to(self.device)
            return outputs
        emitted = 0
        while emitted < max_new_tokens and not finished.all():
            out, cache, cache_lens, last, done = _decode_chunk_device(
                self.model, cache, self.params, cache_lens, last, logits_mask, done, stops, gen,
                num_steps=DECODE_CHUNK, temperature=float(temperature), top_p=float(top_p),
                top_k=int(top_k), min_p=float(min_p),
            )
            tokens, done_rows = fetch(out, done)
            room = max_new_tokens - emitted
            for i in range(n):
                if finished[i]:
                    continue
                for token in tokens[i][:room]:
                    if token == _NO_TOKEN:
                        finished[i] = True
                        break
                    outputs[i].append(int(token))
            emitted += min(DECODE_CHUNK, room)
            finished |= np.asarray(done_rows, dtype=bool)
        return outputs

    def complete_batch(
        self,
        messages_batch: list[list[dict[str, Any]]],
        *,
        response_format: dict[str, Any] | None = None,
        **sampling: Any,
    ):
        """Batched :meth:`complete` (no tools): B conversations share one
        prefill and one forward a decode step.  A JSON ``response_format``
        gives every row its own automaton."""
        from raglite_tpu_torch.models.llm import ChatResponse

        prompts = [self._format_messages(m, None) for m in messages_batch]
        automatons = [_automaton_for(response_format) for _ in prompts]
        token_lists = self._generate_batch(
            prompts,
            max_new_tokens=_max_new(sampling, 512),
            temperature=float(sampling.get("temperature", 0.0)),
            top_p=float(sampling.get("top_p", 1.0)),
            top_k=int(sampling.get("top_k", 0)),
            min_p=float(sampling.get("min_p", 0.0)),
            automatons=automatons,
            seed=int(sampling.get("seed", 0)),
        )
        return [ChatResponse(content="".join(self._decode_pieces(iter(tokens))) or None) for tokens in token_lists]

    # --- LLM protocol -----------------------------------------------------

    def _decode_stream(self, tokens: Iterator[int]) -> Iterator[str]:
        """Incremental UTF-8 decode of generated byte tokens: each character
        as soon as its bytes are in, an invalid sequence as U+FFFD as soon as
        it is known to be one.  The pieces join to the text the JAX package
        streams, which holds back every byte after an invalid one until the
        end (a random model's answer then streams as one piece)."""
        decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        for token in tokens:
            if token >= ByteTokenizer._OFFSET:
                piece = decoder.decode(bytes([token - ByteTokenizer._OFFSET]))
                if piece:
                    yield piece
        tail = decoder.decode(b"", final=True)
        if tail:
            yield tail

    def _decode_stream_bpe(self, tokens: Iterator[int]) -> Iterator[str]:
        """Incremental decode of a BPE model's tokens: the growing id list
        decoded again at each token and the text's growth emitted, held back
        while it ends in U+FFFD (an incomplete UTF-8 sequence).  A generation
        that ends inside such a sequence emits its replacement character at
        the end; the JAX package drops it."""
        ids: list[int] = []
        emitted = text = ""
        for token in tokens:
            ids.append(token)
            text = self.tokenizer.decode(ids)
            if text.endswith("\ufffd"):
                continue
            if len(text) > len(emitted):
                yield text[len(emitted) :]
                emitted = text
        if text.endswith("\ufffd") and len(text) > len(emitted):
            yield text[len(emitted) :]

    def _decode_pieces(self, tokens: Iterator[int]) -> Iterator[str]:
        """Text pieces of generated tokens, by the model's tokenizer."""
        return self._decode_stream(tokens) if self._byte_level else self._decode_stream_bpe(tokens)

    def _forced_tool_call(self, messages, tools, tool_choice, sampling):
        """A tool call forced in two constrained phases: the tool's name (an
        enum automaton, skipped when ``tool_choice`` names it or one tool is
        offered), then its arguments under the tool's parameter schema.  A
        BPE model is forced through the prompt instead: the call's opening
        and the tool's name are written after the assistant's turn, and the
        generated arguments are kept where they parse as JSON (else ``{}``)."""
        from raglite_tpu_torch.models.llm import ToolCall

        by_name = {t["function"]["name"]: t for t in tools}
        if not self._byte_level:
            first = tool_choice.get("function", {}).get("name") if isinstance(tool_choice, dict) else next(iter(by_name))
            tool = by_name.get(first) or next(iter(by_name.values()))
            prompt = self._format_messages(messages, tools) + (
                f'<tool_call>{{"name": "{tool["function"]["name"]}", "arguments": '
            )
            tokens = self._generate_tokens(
                prompt, max_new_tokens=_max_new(sampling, 128), temperature=float(sampling.get("temperature", 0.0))
            )
            raw = "".join(self._decode_pieces(tokens)).split("</tool_call>")[0].strip()
            try:
                json.loads(raw)
                arguments = raw
            except ValueError:
                arguments = "{}"
            return ToolCall(id=f"call_{uuid.uuid4().hex[:8]}", name=tool["function"]["name"], arguments=arguments)
        if isinstance(tool_choice, dict):
            name = tool_choice.get("function", {}).get("name") or next(iter(by_name))
        elif len(by_name) == 1:
            name = next(iter(by_name))
        else:
            prompt = self._format_messages(messages, tools) + "Choose a tool.\n"
            chooser = SchemaAutomaton({"type": "object", "properties": {"name": {"enum": list(by_name)}}})
            tokens = self._generate_tokens(prompt, max_new_tokens=64, temperature=0.0, automaton=chooser)
            name = json.loads("".join(self._decode_pieces(tokens))).get("name", next(iter(by_name)))
        tool = by_name.get(name) or next(iter(by_name.values()))
        schema = tool["function"].get("parameters") or {"type": "object"}
        prompt = self._format_messages(messages, tools) + f"Arguments for {name}:\n"
        tokens = self._generate_tokens(
            prompt,
            max_new_tokens=_max_new(sampling, 128),
            temperature=float(sampling.get("temperature", 0.0)),
            json_constrained=True,
            automaton=SchemaAutomaton(schema),
        )
        arguments = "".join(self._decode_pieces(tokens))
        return ToolCall(id=f"call_{uuid.uuid4().hex[:8]}", name=name, arguments=arguments)

    def stream(self, messages, *, tools=None, tool_choice=None, **sampling):
        from raglite_tpu_torch.models.llm import ToolCall

        if tool_choice == "none":
            tools = None  # "none" produces no tool calls: no manifest, no parsing
        if tools and (tool_choice == "required" or isinstance(tool_choice, dict)):
            yield self._forced_tool_call(messages, tools, tool_choice, sampling)
            return
        prompt = self._format_messages(messages, tools)
        text_parts: list[str] = []
        # Incremental tool-tag filter: text inside <tool_call>...</tool_call>
        # never reaches the stream (it becomes ToolCall items), all text
        # outside it does, and a partial "<tool_call" at the tail is held
        # back until it completes or turns out to be plain text.
        OPEN, CLOSE = "<tool_call>", "</tool_call>"
        pending = ""
        in_tool = False

        def drain(pending: str, in_tool: bool, final: bool):
            emit = []
            while True:
                if in_tool:
                    end = pending.find(CLOSE)
                    if end < 0:
                        if final:
                            pending = ""
                        break
                    pending = pending[end + len(CLOSE) :]
                    in_tool = False
                    continue
                start = pending.find(OPEN)
                if start >= 0:
                    emit.append(pending[:start])
                    pending = pending[start + len(OPEN) :]
                    in_tool = True
                    continue
                hold = 0
                if not final:
                    for k in range(min(len(OPEN) - 1, len(pending)), 0, -1):
                        if pending.endswith(OPEN[:k]):
                            hold = k
                            break
                cut = len(pending) - hold
                emit.append(pending[:cut])
                pending = pending[cut:]
                break
            return "".join(emit), pending, in_tool

        for piece in self._decode_pieces(
            self._generate_tokens(
                prompt,
                max_new_tokens=_max_new(sampling, 128),
                temperature=float(sampling.get("temperature", 0.0)),
                top_p=float(sampling.get("top_p", 1.0)),
                top_k=int(sampling.get("top_k", 0)),
                min_p=float(sampling.get("min_p", 0.0)),
                seed=int(sampling.get("seed", 0)),
            )
        ):
            text_parts.append(piece)
            if tools:
                pending += piece
                emit, pending, in_tool = drain(pending, in_tool, final=False)
                if emit:
                    yield emit
            else:
                yield piece
        if not tools:
            return
        emit, pending, in_tool = drain(pending, in_tool, final=True)
        if emit:
            yield emit
        for m in re.finditer(r"<tool_call>(.*?)</tool_call>", "".join(text_parts), flags=re.S):
            try:
                call = json.loads(m.group(1))
                yield ToolCall(
                    id=f"call_{uuid.uuid4().hex[:8]}",
                    name=str(call.get("name", "")),
                    arguments=json.dumps(call.get("arguments", {})),
                )
            except (ValueError, TypeError, AttributeError):
                continue

    def complete(self, messages, *, tools=None, tool_choice=None, response_format=None, **sampling):
        from raglite_tpu_torch.models.llm import ChatResponse, ToolCall

        if response_format is not None and not self._byte_level:
            # A BPE model: the schema in the prompt, decoded unconstrained
            # (the extract layer validates, as with the JAX package).
            schema = (response_format.get("json_schema") or {}).get("schema")
            prompt = self._format_messages(messages, tools) + (
                "Respond ONLY with a JSON object"
                + (f" matching this schema:\n{json.dumps(schema)}" if schema else "")
                + "\n"
            )
            tokens = self._generate_tokens(
                prompt, max_new_tokens=_max_new(sampling, 256), temperature=float(sampling.get("temperature", 0.0))
            )
            return ChatResponse(content="".join(self._decode_pieces(tokens)))
        if response_format is not None:
            # Any response format constrains to JSON; a json_schema with a
            # schema, to that schema.
            prompt = self._format_messages(messages, tools) + "Respond with a JSON object.\n"
            tokens = self._generate_tokens(
                prompt,
                max_new_tokens=_max_new(sampling, 256),
                temperature=float(sampling.get("temperature", 0.0)),
                json_constrained=True,
                automaton=_automaton_for(response_format),
            )
            return ChatResponse(content="".join(self._decode_pieces(tokens)))
        parts: list[str] = []
        tool_calls: list[ToolCall] = []
        for item in self.stream(messages, tools=tools, tool_choice=tool_choice, **sampling):
            if isinstance(item, ToolCall):
                tool_calls.append(item)
            else:
                parts.append(item)
        return ChatResponse(content="".join(parts) or None, tool_calls=tool_calls)
