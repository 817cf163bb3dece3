"""Tensor-parallel generation (raglite_tpu_torch/parallel/tp_decoder.py)
against the JAX package's ``shard_chat_llm``, one counterpart per test of
tests/test_tp_decoder.py.

JAX shards ``tiny`` over two virtual CPU devices under GSPMD; the port over
two logical shards of the one CPU device, each shard's attention taking the
kernels' plain versions.  Tolerances: the port's TP forward agrees with
JAX's within 0.02 of the largest |logit| (the bound of the JAX test: bf16
partial sums re-associate across shards), with the weights carried across
by ``params_from_jax``; in f32 it agrees with the port's single-device
forward within 1e-4 of the largest |logit| (only the order of the f32 sums
in the two reduces differs), and its greedy tokens are equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.models import decoder as jdec
from raglite_tpu.parallel import tp_decoder as jtp
from raglite_tpu_torch.models import decoder as tdec
from raglite_tpu_torch.parallel import mesh as tmesh
from raglite_tpu_torch.parallel import tp_decoder as ttp

CPU2 = [torch.device("cpu")] * 2
IDS = [[3, 7, 11, 201, 5, 9, 42, 77]]


def _torch_llm(jax_llm, dtype: torch.dtype) -> tdec.TorchChatLLM:
    llm = tdec.TorchChatLLM("tiny", device="cpu", dtype=dtype)
    llm.params = tdec.params_from_jax(jax_llm.params, dtype=dtype)
    return llm


def _forward(llm, ids, s: int = 64, dtype=torch.bfloat16):
    cache = llm.model.init_cache(len(ids), s, dtype=dtype)
    logits, cache = llm.model.forward(llm.params, torch.tensor(ids), cache, 0)
    return logits, cache


def test_param_specs_placement() -> None:
    """The JAX package's placement, leaf for leaf (the port's specs are the
    tuples of JAX's PartitionSpecs)."""
    jllm = jdec.JaxChatLLM("tiny")
    jspecs = jtp.decoder_param_specs(jllm.params)
    specs = ttp.decoder_param_specs(tdec.params_from_jax(jllm.params))
    assert specs["lm_head"] == tuple(jspecs["lm_head"]) == (None, "model")
    assert specs["tok_emb"] == tuple(jspecs["tok_emb"]) == ()
    for layer, jlayer in zip(specs["layers"], jspecs["layers"]):
        assert layer == {k: tuple(v) for k, v in jlayer.items()}
    layer = specs["layers"][0]
    assert layer["wq"] == (None, "model") and layer["wo"] == ("model", None)
    assert layer["w_down"] == ("model", None) and layer["attn_norm"] == ()


@pytest.mark.parametrize("which", ["tiny", "knobs"])
def test_sharded_forward_matches_single_device(which: str) -> None:
    """tp = 2: the forward (prefill, then verify and decode at offsets) with
    every attention sublayer per shard, against the single-device port (f32,
    1e-4) and, on ``tiny``, JAX's GSPMD forward (bf16, 0.02).  The KV cache
    lives per shard at KVH/tp heads."""
    from tests.test_torch_decoder import KNOBS_CFG, _knob_params

    if which == "tiny":
        jllm = jdec.JaxChatLLM("tiny", seed=11)
        jsharded = jtp.shard_chat_llm(jdec.JaxChatLLM("tiny", seed=11), tp=2)
        jl, _ = jsharded.model.forward(
            jsharded.params, jnp.asarray(IDS, jnp.int32), jsharded.model.init_cache(1, 64), jnp.asarray(0, jnp.int32)
        )
        sharded = ttp.shard_chat_llm(_torch_llm(jllm, torch.bfloat16), CPU2)
        tl, cache = _forward(sharded, IDS)
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() / (np.abs(jl).max() + 1e-6) < 0.02
        cfg, jparams = jllm.cfg, jdec.JaxChatLLM("tiny", seed=11, dtype=jnp.float32).params
    else:
        cfg, jparams = KNOBS_CFG, _knob_params()
    single = tdec.TorchChatLLM("tiny", device="cpu", dtype=torch.float32)
    single.cfg, single.model = cfg, tdec.DecoderModel(cfg)
    single.params = tdec.params_from_jax(jparams, dtype=torch.float32)
    sharded = ttp.shard_chat_llm(copy.copy(single), CPU2)
    assert isinstance(sharded.model, ttp.TPDecoderModel) and sharded.tp_devices == CPU2
    assert sharded.params["layers"][0]["shards"][0]["wq"].shape[1] == single.params["layers"][0]["wq"].shape[1] // 2
    rng = np.random.default_rng(2)
    b, s = 2, 48
    caches = [m.model.init_cache(b, s, dtype=torch.float32) for m in (single, sharded)]
    assert caches[1]["k"][0][1].shape == (b, cfg["kv_heads"] // 2, single.model.head_dim, s)
    for ids, offsets in [
        (rng.integers(3, cfg["vocab"], (b, 24)), 0),  # prefill
        (rng.integers(3, cfg["vocab"], (b, 8)), np.array([24, 20])),  # verify window
        (rng.integers(3, cfg["vocab"], (b, 1)), np.array([32, 28])),  # decode
    ]:
        lf, _ = single.model.forward(single.params, torch.from_numpy(ids), caches[0], torch.as_tensor(offsets))
        ls, _ = sharded.model.forward(sharded.params, torch.from_numpy(ids), caches[1], torch.as_tensor(offsets))
        assert (ls - lf).abs().max() / lf.abs().max() < 1e-4
    for name in ("k", "v"):  # the shards' caches are the single cache's KV groups
        for whole, parts in zip(caches[0][name], caches[1][name]):
            torch.testing.assert_close(torch.cat(parts, dim=1), whole, rtol=1e-4, atol=1e-5)


def test_sharded_generation_end_to_end() -> None:
    """complete (greedy: speculation, then plain decode) and complete_batch
    through the TP model equal the single-device port's tokens (f32)."""
    import os

    jllm = jdec.JaxChatLLM("tiny", seed=3, dtype=jnp.float32)
    single = _torch_llm(jllm, torch.float32)
    sharded = ttp.shard_chat_llm(_torch_llm(jllm, torch.float32), CPU2)
    msgs = [{"role": "user", "content": "Say something."}]
    for spec in ("auto", "0"):
        os.environ["RAGLITE_TPU_SPECULATE"] = spec
        try:
            want = single.complete(msgs, temperature=0.0, max_tokens=16).content
            got = sharded.complete(msgs, temperature=0.0, max_tokens=16).content
        finally:
            del os.environ["RAGLITE_TPU_SPECULATE"]
        assert isinstance(got, str) and got == want
    batch = [[{"role": "user", "content": "a"}], [{"role": "user", "content": "bb"}]]
    outs = sharded.complete_batch(batch, temperature=0.0, max_tokens=8)
    assert len(outs) == 2 and all(isinstance(o.content, str) for o in outs)
    assert [o.content for o in outs] == [o.content for o in single.complete_batch(batch, temperature=0.0, max_tokens=8)]


def test_gqa_divisibility_guard() -> None:
    # tiny has heads=4, kv_heads=2: tp=8 divides neither
    with pytest.raises(ValueError, match="must divide"):
        jtp.shard_chat_llm(jdec.JaxChatLLM("tiny"), tp=8)
    with pytest.raises(ValueError, match="must divide"):
        ttp.shard_chat_llm(tdec.TorchChatLLM("tiny", device="cpu"), [torch.device("cpu")] * 8)


def test_quantized_model_refuses_tp() -> None:
    with pytest.raises(ValueError, match="int8") as jerr:
        jtp.shard_chat_llm(jdec.JaxChatLLM("tiny@int8"), tp=2)
    with pytest.raises(ValueError, match="int8") as terr:
        ttp.shard_chat_llm(tdec.TorchChatLLM("tiny@int8", device="cpu"), CPU2)
    assert str(terr.value) == str(jerr.value)


def test_tp_mesh_axis() -> None:
    """``tp_devices`` is ``tp_mesh``'s counterpart: tp shards on the CPU;
    the reduce sums the shards' partials in f32 in shard order."""
    mesh = jtp.tp_mesh(4)
    assert mesh.axis_names == ("model",) and mesh.shape["model"] == 4
    assert ttp.tp_devices(4, "cpu") == [torch.device("cpu")] * 4 == tmesh.tp_devices(4, "cpu")
    parts = [torch.full((2, 3), v, dtype=torch.bfloat16) for v in (1.0, 2.0**-8, 2.0**-8)]
    total = tmesh.reduce_sum(parts)
    # One rounding of the f32 sum (a bf16 chain would round 1 + 2^-8 to 1).
    assert total.dtype == torch.bfloat16 and total[0, 0].item() == 1.0 + 2.0**-7
    assert jax.devices()[0].platform == "cpu"
