"""Tensor-parallel generation: the decoder's weights split Megatron-style
over a device list (counterpart of raglite_tpu/parallel/tp_decoder.py).

The placement is the JAX package's (:func:`decoder_param_specs`):

- ``wq``/``wk``/``wv`` and their biases split by columns: shard s owns
  ``heads/tp`` query heads and ``kv_heads/tp`` KV groups, and its KV cache
  ``[B, KVH/tp, hd, S]`` lives on its own device, so cache reads and writes
  stay local;
- ``wo`` splits by rows (row-parallel), and the shards' partial sums are
  reduced (parallel/mesh.py:reduce_sum).  Each partial leaves its matmul in
  f32 and the reduce rounds their f32 sum once, as a single device rounds
  its one matmul's sum: the TP forward then differs from the single-device
  one only by f32 re-association (rounding each partial to bf16 first put
  2,048-token `large` logits 0.0216 of the largest |logit| apart on an
  H100, above the JAX test's 0.02);
- ``w_gate``/``w_up`` split by columns, ``w_down`` by rows, then the reduce;
- ``lm_head`` splits by columns, and the logits' vocab slices are gathered
  on the first device for the sampler;
- embeddings and norms are replicated: the residual stream lives on the
  first device, where the reduces land, and each shard gets a copy of what
  it reads itself (the q/k norms) and the normed activations it projects.

The JAX package turns its Pallas decode attention off under TP only because
GSPMD cannot partition a ``pallas_call``.  Here each shard's attention is
local, over its own KV groups, so every shard calls the same attention
kernels (``gqa_decode_attention``, ``gqa_verify_attention``,
``gqa_prefill_attention``) at KVH/tp groups: the same function on other
shapes.  One process enqueues every shard's work before a reduce reads it,
so shards on separate cards run at once; shards that share a card (as on
the CPU and on a one-card machine) run one after another.

``complete``, ``stream``, ``complete_batch``, speculation and ``rag()`` then
run tensor-parallel unchanged: they reach the weights only through
``DecoderModel.forward`` and ``init_cache``.  The ``@int8`` layout fuses
q/k/v columns, which a contiguous split would cut at the wrong boundaries:
a quantized model refuses to shard.
"""

from __future__ import annotations

import torch

from raglite_tpu_torch.models.decoder import DecoderModel, Params, _linear
from raglite_tpu_torch.parallel.mesh import reduce_sum, tp_devices

__all__ = ["TPDecoderModel", "decoder_param_specs", "shard_chat_llm", "tp_devices"]

#: PartitionSpec-like placements (tuples, comparable with ``tuple(P(...))``):
#: split the columns, split the rows, split a vector, replicate.
_COL, _ROW, _VEC, _REP = (None, "model"), ("model", None), ("model",), ()
_BY_NAME = {
    "wq": _COL, "wk": _COL, "wv": _COL,
    "bq": _VEC, "bk": _VEC, "bv": _VEC,
    "wo": _ROW,
    "w_gate": _COL, "w_up": _COL, "w_down": _ROW,
}
#: Replicated layer leaves that a shard reads itself (per-head q/k norms).
_SHARD_COPIES = ("q_norm", "k_norm")


def decoder_param_specs(params: Params) -> dict:
    """The placement of every leaf of a decoder parameter dict, as tuples
    of a ``PartitionSpec`` over the ``"model"`` axis (see the module
    docstring).  Unknown leaves replicate."""
    specs: dict = {}
    for key, value in params.items():
        if key == "layers":
            specs["layers"] = [{k: _BY_NAME.get(k, _REP) for k in layer} for layer in value]
        elif key == "lm_head":
            specs[key] = _COL
        else:
            specs[key] = _REP
    return specs


def _check_divisible(cfg: dict, tp: int) -> None:
    for field in ("heads", "kv_heads"):
        if cfg[field] % tp:
            msg = (
                f"tensor parallelism {tp} must divide {field}={cfg[field]} "
                "(each device owns whole attention groups)"
            )
            raise ValueError(msg)
    if cfg["d_ff"] % tp:
        msg = f"tensor parallelism {tp} must divide d_ff={cfg['d_ff']}"
        raise ValueError(msg)


def _split(x: torch.Tensor, spec: tuple, devices: list[torch.device]) -> list[torch.Tensor]:
    """``x`` cut along the axis its spec names, shard s on ``devices[s]``
    (contiguous; a row cut on the tensor's own device stays a view)."""
    axis = spec.index("model")
    return [p.to(dev).contiguous() for p, dev in zip(torch.tensor_split(x, len(devices), dim=axis), devices)]


class TPDecoderModel(DecoderModel):
    """``DecoderModel`` over tensor-parallel parameters (:func:`shard_chat_llm`):
    per layer, every shard's attention and MLP on its own device, each
    followed by the reduce of their partial sums onto the first device."""

    #: Its steps run eagerly: a forward that spans devices is not captured
    #: as a CUDA graph (utils/graphs.py).
    captures = False

    def __init__(self, cfg: dict, devices: list[torch.device]) -> None:
        super().__init__(cfg)
        self.devices = list(devices)
        self.tp = len(self.devices)

    def init_cache(
        self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16, device: str | torch.device = "cpu"
    ) -> dict:
        """Per layer, one ``[B, KVH/tp, hd, S]`` K and V buffer per shard, on
        the shard's device (``device`` is ignored: the shards place them)."""
        shape = (batch, self.cfg["kv_heads"] // self.tp, self.head_dim, max_len)
        layers = self.cfg["layers"]
        return {
            name: [[torch.zeros(shape, dtype=dtype, device=dev) for dev in self.devices] for _ in range(layers)]
            for name in ("k", "v")
        }

    def _cache_seq(self, cache: dict) -> int:
        return cache["k"][0][0].shape[3]

    def _attention(self, li: int, layer: dict, h: torch.Tensor, cache: dict, pos: dict) -> torch.Tensor:
        heads, kv_heads = self.cfg["heads"] // self.tp, self.cfg["kv_heads"] // self.tp
        parts = []
        for s, dev in enumerate(self.devices):
            shard_pos = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in pos.items()}
            parts.append(self._attend(
                layer["shards"][s], h.to(dev), cache["k"][li][s], cache["v"][li][s], shard_pos, heads, kv_heads,
                partial=True,
            ))
        return reduce_sum(parts, dtype=h.dtype)

    def _mlp(self, layer: dict, h: torch.Tensor) -> torch.Tensor:
        parts = [self._gated_mlp(shard, h.to(dev), partial=True) for shard, dev in zip(layer["shards"], self.devices)]
        return reduce_sum(parts, dtype=h.dtype)

    def _lm_head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        first = self.devices[0]
        return torch.cat([_linear(x.to(dev), w).to(first) for w, dev in zip(params["lm_head"], self.devices)], dim=-1)


def shard_chat_llm(llm, devices: list[torch.device] | None = None, *, tp: int = 0):
    """Split a :class:`TorchChatLLM`'s weights for tensor-parallel
    generation over ``devices`` (default: ``tp_devices(tp, llm.device)``).
    Returns ``llm``, changed in place: ``params`` replaced by the sharded
    tree (split tensors are fresh copies or views; replicated ones are the
    same tensors on the first device), ``model`` by a
    :class:`TPDecoderModel`, whose caches are created per shard.  Every
    public generation API then runs tensor-parallel."""
    if getattr(llm, "quantized", False):
        msg = "@int8 fused weights cannot TP-shard (fused q/k/v column split); shard the full-precision model"
        raise ValueError(msg)
    devices = list(devices) if devices is not None else tp_devices(tp, llm.device)
    _check_divisible(llm.cfg, len(devices))
    first = devices[0]
    specs = decoder_param_specs(llm.params)
    params: Params = {k: v.to(first) for k, v in llm.params.items() if k not in ("layers", "lm_head")}
    params["lm_head"] = _split(llm.params["lm_head"], specs["lm_head"], devices)
    params["layers"] = []
    for layer, layer_specs in zip(llm.params["layers"], specs["layers"]):
        out = {k: v.to(first) for k, v in layer.items() if layer_specs[k] == _REP}
        shards: list[dict] = [{} for _ in devices]
        for key, spec in layer_specs.items():
            if spec != _REP:
                parts = _split(layer[key], spec, devices)
            elif key in _SHARD_COPIES:
                parts = [layer[key].to(dev) for dev in devices]
            else:
                continue
            for shard, part in zip(shards, parts):
                shard[key] = part
        out["shards"] = shards
        params["layers"].append(out)
    llm.params = params
    llm.model = TPDecoderModel(llm.cfg, devices)
    llm.device = first
    llm.tp_devices = devices
    return llm
