"""The port's int8 weights (ops/quant_matmul.py and the ``@int8`` decoder)
against the JAX package's, on the CPU.

Tolerances: ``quantize_linear_int8`` and ``quantize_rows_int8`` bit-equal
(f32 absmax / 127, round half to even, the same padding); W8A8 bit-equal
in f32 (an exact int32 sum, then ``acc * sx * s8`` in the same order);
W8A16 within 2e-6 of the sum of the terms' magnitudes (``|x| @ |q8| * s8``:
the summation order of two f32 matmuls) for f32 activations, and within
that plus 2^-8 of the result for bf16 activations, whose product the port
rounds to bf16 once before the scale where the JAX package keeps f32.  ``@int8`` decoder logits from the
JAX tree carried across within 1e-4 (f32), greedy tokens equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.models import decoder as jdec
from raglite_tpu.ops import quant_matmul as jq
from raglite_tpu_torch.models import decoder as tdec
from raglite_tpu_torch.ops import quant_matmul as tq

TOL = 1e-4
SHAPES = [(64, 128), (100, 300), (2560, 128), (33, 7)]


def _assert_w8a16_close(got, want, x, q8, s8, *, bf16: bool = False) -> None:
    k = x.shape[1]
    mag = np.abs(np.asarray(x, np.float64)) @ np.abs(np.asarray(q8, np.float64)[:k]) * np.asarray(s8, np.float64)
    limit = 2e-6 * mag[:, : want.shape[1]] + (2**-8 * np.abs(want) if bf16 else 0.0)
    assert (np.abs(got.astype(np.float64) - want) <= limit).all(), np.abs(got - want).max()


def _weight(shape, seed: int, dtype=np.float32) -> np.ndarray:
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero output channel takes the unit scale
    return w.astype(dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_quantize_linear_is_bit_equal(shape, bf16: bool) -> None:
    w = _weight(shape, 0)
    jw = jnp.asarray(w, jnp.bfloat16 if bf16 else jnp.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16 if bf16 else torch.float32)
    want, got = jq.quantize_linear_int8(jw), tq.quantize_linear_int8(tw)
    assert got["q8"].shape == want["q8"].shape and got["q8"].shape[0] % 32 == 0 and got["q8"].shape[1] % 128 == 0
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(got["s8"].numpy(), np.asarray(want["s8"]))
    np.testing.assert_array_equal(
        tq.dequantize_linear(got, shape[1], torch.float32).numpy(),
        np.asarray(jq.dequantize_linear(want, shape[1], jnp.float32)),
    )


def test_quantize_rows_is_bit_equal() -> None:
    x = np.random.default_rng(1).standard_normal((9, 200)).astype(np.float32) * 3
    x[4] = 0.0
    jxq, jsx = jq.quantize_rows_int8(jnp.asarray(x))
    txq, tsx = tq.quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rows", [1, 8, 40])
def test_w8a8_is_bit_equal_and_w8a16_within_tolerance(shape, rows: int) -> None:
    k, n = shape
    wq = jq.quantize_linear_int8(jnp.asarray(_weight(shape, 2)))
    q8, s8 = torch.from_numpy(np.asarray(wq["q8"])), torch.from_numpy(np.asarray(wq["s8"]))
    x = np.random.default_rng(3).standard_normal((rows, k)).astype(np.float32)
    want = np.asarray(jq.int8_matmul_w8a8(jnp.asarray(x), wq["q8"], wq["s8"]))
    np.testing.assert_array_equal(tq.int8_matmul_w8a8(torch.from_numpy(x), q8, s8).numpy(), want)
    want16 = np.asarray(jq.int8_matmul_xla(jnp.asarray(x), wq["q8"], wq["s8"]))
    _assert_w8a16_close(tq.int8_matmul_xla(torch.from_numpy(x), q8, s8).numpy(), want16, x, q8, s8)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want_b = np.asarray(jq.int8_matmul_xla(jnp.asarray(xb, jnp.bfloat16), wq["q8"], wq["s8"]))
    got_b = tq.int8_matmul_xla(torch.from_numpy(xb).bfloat16(), q8, s8).numpy()
    _assert_w8a16_close(got_b, want_b, xb, q8, s8, bf16=True)


@pytest.mark.parametrize("mode", ["0", "1", "auto"])
def test_routing_follows_the_jax_packages(monkeypatch, mode: str) -> None:
    """On the CPU ``auto`` takes W8A16, as the JAX package off the TPU;
    ``RAGLITE_TPU_W8A8=1``/``=0`` force either, in both packages."""
    monkeypatch.setenv("RAGLITE_TPU_W8A8", mode)
    w = _weight((96, 200), 4)
    x = np.random.default_rng(5).standard_normal((3, 96)).astype(np.float32)
    jw = jq.QuantLinear.from_dense(jnp.asarray(w))
    tw = tq.QuantLinear.from_dense(torch.from_numpy(w))
    want = np.asarray(jq.quant_linear_apply(jnp.asarray(x), jw))
    got = tq.quant_linear_apply(torch.from_numpy(x), tw).numpy()
    assert got.shape == (3, 200)
    if mode == "1":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_w8a16_close(got, want, x, tw.q8, tw.s8)
    jf = jq.QuantLinearFused.from_dense([jnp.asarray(w[:, :64]), jnp.asarray(w[:, 64:])])
    tf = tq.QuantLinearFused.from_dense([torch.from_numpy(w[:, :64]), torch.from_numpy(w[:, 64:])])
    got = torch.cat(tq.quant_linear_apply_fused(torch.from_numpy(x), tf), dim=1).numpy()
    want = np.concatenate([np.asarray(b) for b in jq.quant_linear_apply_fused(jnp.asarray(x), jf)], axis=1)
    if mode == "1":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_w8a16_close(got, want, x, tf.q8, tf.s8)


@pytest.fixture(scope="module")
def int8_llms():
    j_llm = jdec.JaxChatLLM("tiny@int8", seed=3, dtype=jnp.float32)
    t_llm = tdec.TorchChatLLM("tiny@int8", device="cpu", dtype=torch.float32)
    t_llm.params = tdec.params_from_jax(j_llm.params, dtype=torch.float32)
    return j_llm, t_llm


def test_int8_tree_carries_across(int8_llms) -> None:
    j_llm, t_llm = int8_llms
    for jl, tl in zip(j_llm.params["layers"], t_llm.params["layers"]):
        assert isinstance(tl["wqkv"], tq.QuantLinearFused) and tl["wqkv"].n_outs == jl["wqkv"].n_outs
        np.testing.assert_array_equal(tl["w_down"].q8.numpy(), np.asarray(jl["w_down"].q8))
    assert isinstance(t_llm.params["lm_head"], tq.QuantLinear) and t_llm.params["lm_head"].n_out == 512


def test_int8_logits_equal_jax(int8_llms) -> None:
    """Prefill (T = 24), a verify window and a decode step of the ``@int8``
    tiny model on the CPU's route (W8A16).  W8A8 is held bit-equal per call
    above; through a model it is not compared, since a last-bit difference
    in an activation can move its int8 rounding."""
    j_llm, t_llm = int8_llms
    jm, tm, b = j_llm.model, t_llm.model, 2
    jcache, tcache = jm.init_cache(b, 48, dtype=jnp.float32), tm.init_cache(b, 48, dtype=torch.float32)
    rng = np.random.default_rng(6)
    for t, off in ((24, 0), (8, np.array([24, 20])[:b]), (1, np.array([32, 28])[:b])):
        ids = rng.integers(3, 259, (b, t))
        jl, jcache = jm.forward(j_llm.params, jnp.asarray(ids, jnp.int32), jcache, jnp.asarray(off, jnp.int32))
        tl, _ = tm.forward(t_llm.params, torch.from_numpy(ids), tcache, torch.as_tensor(off))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


def test_int8_greedy_tokens_equal_jax(int8_llms, monkeypatch) -> None:
    monkeypatch.setenv("RAGLITE_TPU_SPECULATE", "0")
    j_llm, t_llm = int8_llms
    prompt = "the cat sat on the mat. the cat sat"
    want = list(j_llm._generate_tokens(prompt, max_new_tokens=24))
    assert list(t_llm._generate_tokens(prompt, max_new_tokens=24)) == want and want


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_layer_streaming_init_equals_quantizing_the_full_init(preset: str) -> None:
    cfg = tdec.TorchChatLLM._PRESETS[preset]
    if preset == "small":
        cfg = {**cfg, "layers": 2}
    full = tdec.quantize_decoder_params(tdec.init_decoder_params(cfg, seed=5))
    streamed = tdec.init_decoder_params_quantized(cfg, seed=5)
    assert torch.equal(full["tok_emb"], streamed["tok_emb"])
    assert torch.equal(full["lm_head"].q8, streamed["lm_head"].q8)
    for a, b in zip(full["layers"], streamed["layers"]):
        assert a.keys() == b.keys()
        for name in ("wqkv", "w_gate_up", "wo", "w_down"):
            assert torch.equal(a[name].q8, b[name].q8) and torch.equal(a[name].s8, b[name].s8), name


def test_quantized_hf_load_equals_quantizing_the_load(tmp_path) -> None:
    """``hf:<dir>@int8`` quantizes each layer as it is read: the same int8
    weights as quantizing the whole bf16 load, tied lm_head included."""
    transformers = pytest.importorskip("transformers")
    config = transformers.Qwen3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=32, tie_word_embeddings=True,
    )
    transformers.Qwen3ForCausalLM(config).save_pretrained(tmp_path, safe_serialization=True)
    with pytest.warns(UserWarning, match="tokenizer.json"):
        _, dense, _ = tdec.load_safetensors_decoder(str(tmp_path))
        _, streamed, _ = tdec.load_safetensors_decoder(str(tmp_path), quantize=True)
    full = tdec.quantize_decoder_params(dense)
    assert torch.equal(full["lm_head"].q8, streamed["lm_head"].q8)
    for a, b in zip(full["layers"], streamed["layers"]):
        assert a.keys() == b.keys() and torch.equal(a["q_norm"], b["q_norm"])
        for name in ("wqkv", "w_gate_up", "wo", "w_down"):
            assert torch.equal(a[name].q8, b[name].q8) and torch.equal(a[name].s8, b[name].s8), name
