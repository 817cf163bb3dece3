"""The port's HuggingFace checkpoint loaders and ``hf:`` chat models
(models/decoder.py:load_safetensors_decoder, models/transformer.py:
load_safetensors_encoder and save_hf_encoder, TorchChatLLM("hf:<dir>"))
against the JAX package's and against ``transformers``, on tiny seeded
checkpoints written by ``transformers`` in ``tmp_path``.

Tolerances: loaded parameters equal the JAX loader's exactly (both read the
same f32 file); decoder logits within 1e-4 of the JAX package's (summation
order of two frameworks' f32 CPU matmuls) and within 2e-3 of
``transformers`` (tests/test_pretrained_loaders.py's); encoder states
within 1e-4 of the JAX package's and within that file's 2e-3 (XLM-R) and
2e-4 (BERT) of ``transformers``.  A BF16 checkpoint loads into the port
equal to its f32 source rounded to bf16 (the JAX loader reads through
``safe_open(framework="np")``, which has no bfloat16: it raises on such a
file).  The ``hf:`` chat model's generated text equals the JAX package's
(greedy, the same f32 weights on both sides, bf16 KV caches), apart from one
known difference: the JAX package's BPE stream drops a trailing U+FFFD (an
answer ending inside a UTF-8 sequence), the port's emits it.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402
from pydantic import BaseModel, Field  # noqa: E402

import raglite_tpu.models.llm as jllm  # noqa: E402
import raglite_tpu_torch.models.llm as tllm  # noqa: E402
from raglite_tpu import RAGLiteConfig as JConfig  # noqa: E402
from raglite_tpu.documents import Document as JDocument  # noqa: E402
from raglite_tpu.extract import extract_with_llm as j_extract  # noqa: E402
from raglite_tpu.insert import insert_documents as jinsert  # noqa: E402
from raglite_tpu.models import decoder as jdec  # noqa: E402
from raglite_tpu.models import transformer as jt  # noqa: E402

from raglite_tpu_torch import RAGLiteConfig as TConfig  # noqa: E402
from raglite_tpu_torch.documents import Document as TDocument  # noqa: E402
from raglite_tpu_torch.extract import extract_with_llm as t_extract  # noqa: E402
from raglite_tpu_torch.insert import insert_documents as tinsert  # noqa: E402
from raglite_tpu_torch.models import decoder as tdec  # noqa: E402
from raglite_tpu_torch.models import transformer as tt  # noqa: E402
from raglite_tpu_torch.models.encoder import TransformerEncoder  # noqa: E402

from tests.test_torch_hf_tokenizer import write_tokenizer  # noqa: E402

jrag = importlib.import_module("raglite_tpu.rag")
trag = importlib.import_module("raglite_tpu_torch.rag")
ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4
GOLD_TOL = 2e-3
FAMILIES = ["qwen2", "qwen3", "llama", "mistral", "gemma", "gemma2", "gemma3", "phi3"]
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


def _gold(family: str):
    """tests/test_pretrained_loaders.py's tiny configuration of ``family``."""
    if family in ("llama", "mistral"):
        cls = transformers.LlamaConfig if family == "llama" else transformers.MistralConfig
        config = cls(**SMALL, rope_theta=5e5, rms_norm_eps=1e-5, tie_word_embeddings=False)
        model = (transformers.LlamaForCausalLM if family == "llama" else transformers.MistralForCausalLM)(config)
    elif family == "qwen2":
        config = transformers.Qwen2Config(**SMALL, rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=False)
        model = transformers.Qwen2ForCausalLM(config)
    elif family == "qwen3":
        config = transformers.Qwen3Config(**SMALL, head_dim=32, rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=True)
        model = transformers.Qwen3ForCausalLM(config)
    elif family == "gemma":
        config = transformers.GemmaConfig(**SMALL, head_dim=16, rope_theta=10000.0, rms_norm_eps=1e-6,
                                          hidden_activation="gelu_pytorch_tanh")
        model = transformers.GemmaForCausalLM(config)
    elif family == "gemma2":
        config = transformers.Gemma2Config(**SMALL, head_dim=16, rope_theta=10000.0, rms_norm_eps=1e-6,
                                           query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
                                           final_logit_softcapping=30.0, sliding_window=4)
        model = transformers.Gemma2ForCausalLM(config)
    elif family == "gemma3":
        config = transformers.Gemma3TextConfig(**SMALL, head_dim=16, rope_theta=1_000_000.0,
                                               rope_local_base_freq=10_000.0, rms_norm_eps=1e-6,
                                               query_pre_attn_scalar=16, sliding_window=4, sliding_window_pattern=2)
        model = transformers.Gemma3ForCausalLM(config)
    else:
        config = transformers.Phi3Config(**SMALL, rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=4,
                                         tie_word_embeddings=False, pad_token_id=0, bos_token_id=1, eos_token_id=2)
        model = transformers.Phi3ForCausalLM(config)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():  # nonzero biases, so a loader that drops them fails
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return model.eval(), config


def _save(model, config, path: Path) -> str:
    model.save_pretrained(path, safe_serialization=True)
    config.save_pretrained(path)
    return str(path)


def _flat(params) -> dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        if k == "layers":
            for i, layer in enumerate(v):
                out.update({f"layers.{i}.{n}": np.asarray(x, np.float32) for n, x in layer.items()})
        else:
            out[k] = np.asarray(v, np.float32)
    return out


@pytest.mark.filterwarnings("ignore:tokenizer.json not found")
@pytest.mark.parametrize("family", FAMILIES)
def test_decoder_loader_matches_jax_and_transformers(tmp_path, family: str) -> None:
    gold, config = _gold(family)
    path = _save(gold, config, tmp_path / family)
    cfg, jparams, _ = jdec.load_safetensors_decoder(path, dtype=jnp.float32)
    tcfg, tparams, _ = tdec.load_safetensors_decoder(path, dtype=torch.float32)
    assert tcfg == cfg
    want, got = _flat(jparams), {k: v.numpy() for k, v in _flat_torch(tparams).items()}
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ids = np.random.default_rng(0).integers(0, 256, size=(2, 12))
    jmodel, tmodel = jdec.DecoderModel(cfg), tdec.DecoderModel(tcfg)
    jl, _ = jmodel.forward(jparams, jnp.asarray(ids, jnp.int32), jmodel.init_cache(2, 16, dtype=jnp.float32),
                           jnp.asarray(0, jnp.int32))
    tl, _ = tmodel.forward(tparams, torch.from_numpy(ids), tmodel.init_cache(2, 16, dtype=torch.float32), 0)
    with torch.no_grad():
        gl = gold(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), gl, rtol=GOLD_TOL, atol=GOLD_TOL)


def _flat_torch(params) -> dict[str, torch.Tensor]:
    out = {}
    for k, v in params.items():
        if k == "layers":
            for i, layer in enumerate(v):
                out.update({f"layers.{i}.{n}": x for n, x in layer.items()})
        else:
            out[k] = v
    return out


@pytest.mark.filterwarnings("ignore:tokenizer.json not found")
@pytest.mark.parametrize("family", ["qwen3", "gemma2", "phi3"])
def test_bf16_checkpoint_loads_as_its_rounded_source(tmp_path, family: str) -> None:
    """A BF16 file (how Qwen3, Llama and Gemma ship) read on the port: every
    parameter equals the f32 checkpoint's rounded to bf16 (norms and biases
    read to f32 from their bf16 values), and the shards of a split file read
    as one."""
    gold, config = _gold(family)
    f32 = _save(gold, config, tmp_path / "f32")
    gold.to(torch.bfloat16).save_pretrained(tmp_path / "bf16", safe_serialization=True, max_shard_size="40KB")
    config.save_pretrained(tmp_path / "bf16")
    assert len(list((tmp_path / "bf16").glob("*.safetensors"))) > 1
    _, ref, _ = tdec.load_safetensors_decoder(f32, dtype=torch.float32)
    cfg, params, _ = tdec.load_safetensors_decoder(str(tmp_path / "bf16"), dtype=torch.bfloat16)
    ref, got = _flat_torch(ref), _flat_torch(params)
    for name, want in ref.items():
        # Gemma's folded ``1 + w`` norms are added after the rounding.
        if want.dtype == torch.float32 and got[name].dtype == torch.float32:
            offset = 1.0 if family.startswith("gemma") and "norm" in name else 0.0
            want = (want - offset).to(torch.bfloat16).float() + offset
        assert torch.equal(got[name], want.to(got[name].dtype)), name
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(1, 10)))
    model = tdec.DecoderModel(cfg)
    logits, _ = model.forward(params, ids, model.init_cache(1, 16), 0)
    assert logits.shape == (1, 10, 256) and torch.isfinite(logits).all()


def _encoder_gold(family: str):
    if family == "bert":
        config = transformers.BertConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                         num_attention_heads=4, max_position_embeddings=64, pad_token_id=0,
                                         type_vocab_size=2, layer_norm_eps=1e-12)
        model = transformers.BertModel(config)
    else:
        config = transformers.XLMRobertaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                                               num_hidden_layers=2, num_attention_heads=4,
                                               max_position_embeddings=66, pad_token_id=1, type_vocab_size=1,
                                               layer_norm_eps=1e-5)
        model = transformers.XLMRobertaModel(config)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return model.eval(), config


@pytest.mark.parametrize(("family", "gold_tol"), [("xlmr", 2e-3), ("bert", 2e-4)])
def test_encoder_loader_matches_jax_and_transformers(tmp_path, family: str, gold_tol: float) -> None:
    gold, config = _encoder_gold(family)
    path = _save(gold, config, tmp_path / family)
    write_tokenizer("jax_tests_bpe", tmp_path / family)
    cfg, jparams, _ = jt.load_safetensors_encoder(path, dtype=jnp.float32)
    tcfg, model, tok = tt.load_safetensors_encoder(path, dtype=torch.float32)
    assert tcfg == cfg and tok.encode("abc") == [0, 1, 2]
    ids = np.random.default_rng(1).integers(2, 128, size=(2, 10))
    mask = np.ones((2, 10), dtype=bool)
    want = np.asarray(jt.EncoderModel(cfg).apply_tokens(jparams, jnp.asarray(ids, jnp.int32), jnp.asarray(mask)))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        ref = gold(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask).long()).last_hidden_state
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref.numpy(), rtol=gold_tol, atol=gold_tol)


def test_chip_smokes_bert_checkpoint_loads_in_both_packages(tmp_path) -> None:
    """The bge-base-shaped checkpoint chip_smoke's phase 13 writes (its
    WordPiece tokenizer.json and BERT layout; here at 2 layers, d 32, in
    f32, which the JAX loader reads) loads in both packages: the same ids
    from both tokenizers and the same states within TOL."""
    chip_smoke = importlib.import_module("chip_smoke")
    config = {**chip_smoke.BGE_BASE_CONFIG, "num_hidden_layers": 2, "hidden_size": 32, "num_attention_heads": 4,
              "intermediate_size": 64}
    root = tmp_path / "bge-base"
    root.mkdir()
    (root / "tokenizer.json").write_text(json.dumps(chip_smoke.wordpiece_tokenizer_json(chip_smoke._markdown_texts())))
    chip_smoke.write_bge_m3_checkpoint(root, 13, config=config, device="cpu", dtype=torch.float32)
    cfg, jparams, jtok = jt.load_safetensors_encoder(str(root), dtype=jnp.float32)
    tcfg, model, ttok = tt.load_safetensors_encoder(str(root), dtype=torch.float32)
    assert tcfg == cfg and cfg["vocab"] == 30_522 and cfg["max_len"] == 512
    text = "How does the glacier interact with the volcano in specimen 12? Café, naïve — 日本語."
    ids = ttok.encode(text)
    assert ids == jtok.encode(text) and 100 not in ids[:12]
    ids_np = np.asarray([ids])
    mask = np.ones_like(ids_np, dtype=bool)
    want = np.asarray(jt.EncoderModel(cfg).apply_tokens(jparams, jnp.asarray(ids_np, jnp.int32), jnp.asarray(mask)))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids_np), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    vecs = TransformerEncoder(str(root), device="cpu", dtype=torch.float32).embed_token_level(text)
    assert vecs.shape == (len(ids), 32) and np.isfinite(vecs).all()


def test_save_hf_encoder_round_trips_through_jax(tmp_path) -> None:
    """The port's writer -> the JAX package's reader is exact (f16 matrices,
    as its own writer stores them; the final LayerNorm kept), and the
    exported directory serves ``TransformerEncoder("<dir>")`` and the
    ``.safetensors`` file alone."""
    cfg = dict(layers=2, d_model=32, heads=4, d_ff=64, vocab=128, max_len=128)
    params = jt.init_encoder_params(cfg, seed=3, dtype=jnp.float32)
    params = {
        k: ([{n: np.asarray(x) for n, x in layer.items()} for layer in v] if k == "layers" else np.asarray(v))
        for k, v in params.items()
    }
    rounded = {
        k: ([{n: x.astype(np.float16).astype(np.float32) if x.ndim == 2 else x for n, x in layer.items()} for layer in v]
            if k == "layers" else (v.astype(np.float16).astype(np.float32) if v.ndim == 2 else v))
        for k, v in params.items()
    }
    model = tt.EncoderModel.from_params(cfg, params, dtype=torch.float32, device="cpu")
    out = tmp_path / "export"
    tok = write_tokenizer("jax_tests_bpe", tmp_path / "tok")
    tt.save_hf_encoder(str(out), model, tokenizer_json=str(tok))
    cfg2, params2, _ = jt.load_safetensors_encoder(str(out), dtype=jnp.float32)
    assert cfg2 == {**cfg, "ln_eps": 1e-5, "hidden_act": "gelu"} and "final_ln_scale" in params2
    ids = jnp.asarray(np.random.default_rng(5).integers(1, 128, size=(2, 12)), jnp.int32)
    mask = jnp.ones((2, 12), dtype=bool)
    want = np.asarray(jt.EncoderModel(cfg).apply_tokens(rounded, ids, mask))
    got = np.asarray(jt.EncoderModel(cfg2).apply_tokens(params2, ids, mask))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for spec in (str(out), str(out / "model.safetensors")):
        enc = TransformerEncoder(spec, device="cpu", dtype=torch.float32)
        vecs = enc.embed_token_level("abc")
        assert vecs.shape == (3, 32) and np.isfinite(vecs).all()


# --- the slice as a whole: a tiny ``hf:`` chat model --------------------------


@pytest.fixture(scope="module")
def chat_dir(tmp_path_factory) -> str:
    """A tiny Qwen2 checkpoint beside a Qwen2-style tokenizer.json (ChatML
    specials, two eos ids in config.json)."""
    root = tmp_path_factory.mktemp("hf_chat")
    probe = write_tokenizer("qwen2", root / "probe")
    tok = json.loads(probe.read_text())
    ids = {t["content"]: t["id"] for t in tok["added_tokens"]}
    vocab = max(ids.values()) + 1
    config = transformers.Qwen2Config(
        vocab_size=vocab, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=4096, tie_word_embeddings=False, initializer_range=0.3,
        bos_token_id=None, pad_token_id=ids["<|endoftext|>"], eos_token_id=[ids["<|endoftext|>"], ids["<|im_end|>"]],
    )
    torch.manual_seed(11)
    model = transformers.Qwen2ForCausalLM(config).eval()
    path = _save(model, config, root / "model")
    write_tokenizer("qwen2", root / "model")
    return path


@pytest.fixture(scope="module")
def chat_llms(chat_dir):
    """Both packages' ``hf:`` model over the same f32 weights, also as both
    factories' ``jax:hf:<dir>``."""
    j_llm = jdec.JaxChatLLM(f"hf:{chat_dir}", dtype=jnp.float32)
    t_llm = tdec.TorchChatLLM(f"hf:{chat_dir}", device="cpu", dtype=torch.float32)
    spec = f"jax:hf:{chat_dir}"
    patch = pytest.MonkeyPatch()
    j_make, t_make = jllm._make_llm, tllm._make_llm
    patch.setattr(jllm, "_make_llm", lambda llm: j_llm if llm == spec else j_make(llm))
    patch.setattr(tllm, "_make_llm", lambda llm, device: t_llm if llm == spec else t_make(llm, device))
    yield j_llm, t_llm
    patch.undo()


def _same_text(got: str, want: str) -> None:
    """Equal, or the port's text goes on with the U+FFFD the JAX package's
    BPE stream drops at the end."""
    assert got == want or (got.startswith(want) and set(got[len(want):]) == {"�"}), (got, want)


MESSAGES = [{"role": "user", "content": "Hello, what does the dense index hold? 🙂"}]


def test_hf_chat_model_tokens_and_stops_equal_jax(chat_dir, chat_llms) -> None:
    j_llm, t_llm = chat_llms
    assert not t_llm.supports_response_format and not j_llm.supports_response_format
    assert t_llm._stop_ids == j_llm._stop_ids and len(t_llm._stop_ids) >= 2
    assert t_llm.tokenizer.encode(t_llm._format_messages(MESSAGES, None)) == j_llm.tokenizer.encode(
        j_llm._format_messages(MESSAGES, None)
    )
    assert t_llm.context_size == j_llm.context_size == 4096
    # The factory's own build of "jax:hf:<dir>@int8" (bf16 embedding, int8
    # matmul weights), answering.
    built = tllm.llm_from_config(TConfig(llm=f"jax:hf:{chat_dir}@int8", device="cpu"))
    assert built.quantized and built.params["tok_emb"].dtype == torch.bfloat16 and built.cfg == t_llm.cfg
    assert isinstance(built.complete(MESSAGES, max_tokens=4).content, str)


@pytest.mark.parametrize("speculate", ["0", "auto"])
def test_hf_greedy_text_and_stream_equal_jax(chat_llms, monkeypatch, speculate: str) -> None:
    j_llm, t_llm = chat_llms
    monkeypatch.setenv("RAGLITE_TPU_SPECULATE", speculate)
    jtokens = list(j_llm._generate_tokens(j_llm._format_messages(MESSAGES, None), max_new_tokens=32))
    ttokens = list(t_llm._generate_tokens(t_llm._format_messages(MESSAGES, None), max_new_tokens=32))
    assert ttokens == jtokens and len(ttokens) > 0
    pieces = list(t_llm.stream(MESSAGES, max_tokens=32))
    _same_text("".join(pieces), "".join(j_llm.stream(MESSAGES, max_tokens=32)))
    assert "".join(t_llm._decode_pieces(iter(ttokens))) == "".join(pieces)


def test_bpe_stream_keeps_a_trailing_replacement_character(chat_llms) -> None:
    """An answer that ends inside a UTF-8 sequence: the port's last piece is
    U+FFFD, the JAX package's stream ends before it."""
    j_llm, t_llm = chat_llms
    ids = t_llm.tokenizer.encode("ok é")
    cut = ids[:-1] + [t_llm.tokenizer.token_id("Ã")]  # the first byte of "é" alone
    assert "".join(j_llm._decode_stream(iter(cut))) == "ok "
    assert list(t_llm._decode_stream_bpe(iter(cut)))[-1].endswith("�")
    assert "".join(t_llm._decode_stream_bpe(iter(ids))) == "".join(j_llm._decode_stream(iter(ids))) == "ok é"


@pytest.mark.parametrize("response_format", [
    {"type": "json_object"},
    {"type": "json_schema", "json_schema": {"name": "X", "schema": {"type": "object", "properties": {"a": {"type": "integer"}}}}},
])
def test_hf_response_format_puts_the_schema_in_the_prompt_like_jax(chat_llms, response_format) -> None:
    j_llm, t_llm = chat_llms
    want = j_llm.complete(MESSAGES, response_format=response_format, max_tokens=32).content
    _same_text(t_llm.complete(MESSAGES, response_format=response_format, max_tokens=32).content, want)


@pytest.mark.parametrize("tool_choice", ["required", {"type": "function", "function": {"name": "lookup"}}])
def test_hf_forced_tool_call_equals_jax(chat_llms, tool_choice) -> None:
    j_llm, t_llm = chat_llms
    tools = [
        {"type": "function", "function": {"name": name, "description": "d", "parameters": {"type": "object"}}}
        for name in ("search", "lookup")
    ]
    want = j_llm._forced_tool_call(MESSAGES, tools, tool_choice, {"max_tokens": 24})
    got = t_llm._forced_tool_call(MESSAGES, tools, tool_choice, {"max_tokens": 24})
    assert (got.name, got.arguments) == (want.name, want.arguments)


class Answer(BaseModel):
    """A short answer."""

    answer: str = Field(..., description="The answer.")


@pytest.fixture(scope="module")
def stores(tmp_path_factory, chat_dir, chat_llms):
    root = tmp_path_factory.mktemp("hf_store")
    spec = f"jax:hf:{chat_dir}"
    jcfg = JConfig(store_path=str(root / "jax"), embedder="hash:256", chunk_max_size=1024, llm=spec, llm_max_tries=2)
    tcfg = TConfig(store_path=str(root / "torch"), embedder="hash:256", chunk_max_size=1024, llm=spec,
                   llm_max_tries=2, device="cpu")
    texts = {f: (ROOT / f).read_text(encoding="utf-8") for f in ("MIGRATION.md", "BASELINE.md")}
    jinsert([JDocument.from_text(t, id=f) for f, t in texts.items()], config=jcfg)
    tinsert([TDocument.from_text(t, id=f) for f, t in texts.items()], config=tcfg)
    return jcfg, tcfg


def test_hf_extract_with_llm_equals_jax(stores) -> None:
    """The schema goes in the prompt (no response format); a random model's
    answer fails validation the same way in both packages, or parses to the
    same model."""
    jcfg, tcfg = stores
    outcomes = []
    for extract, cfg in ((j_extract, jcfg), (t_extract, tcfg)):
        try:
            outcomes.append(("ok", extract(Answer, "What is the baseline?", config=cfg, max_tokens=24)))
        except ValueError as e:
            # The messages name the model differently; the validation
            # error, which quotes the answer, is compared.
            outcomes.append(("error", str(e.__cause__)[:160]))
    assert outcomes[0] == outcomes[1]


def test_hf_rag_answers_equal_jax(stores) -> None:
    jcfg, tcfg = stores
    question = "What does the baseline measure?"
    jspans = jrag.retrieve_context(question, num_chunks=1, config=jcfg)
    tspans = trag.retrieve_context(question, num_chunks=1, config=tcfg)
    jmsgs = [jrag.add_context(question, jspans, jcfg)]
    tmsgs = [trag.add_context(question, tspans, tcfg)]
    assert tmsgs == jmsgs
    want = "".join(jrag.rag(jmsgs, config=replace(jcfg)))
    got = "".join(trag.rag(tmsgs, config=replace(tcfg)))
    _same_text(got, want)
    assert len(got) > 0


@pytest.mark.filterwarnings("ignore:tokenizer.json not found")
def test_chip_smokes_checkpoint_writers_read_like_transformers(tmp_path) -> None:
    """chip_smoke.py's Qwen3-4B-shaped and bge-m3-shaped BF16 writers (the
    port's safetensors writer, 3 shards and an index; the XLM-R layout with
    a pooler), at small widths on the CPU: ``transformers`` reads both, and
    the port's loaders give its logits and states (f32 compute on both
    sides; the gold tolerances)."""
    chip_smoke = importlib.import_module("chip_smoke")
    qwen = {**chip_smoke.QWEN3_4B_CONFIG, "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 32, "intermediate_size": 128, "vocab_size": 512,
            "bos_token_id": 1, "eos_token_id": 2}
    chip_smoke.write_qwen3_checkpoint(tmp_path / "qwen", 0, config=qwen, device="cpu")
    assert len(list((tmp_path / "qwen").glob("model-*-of-00003.safetensors"))) == 3
    gold = transformers.Qwen3ForCausalLM.from_pretrained(tmp_path / "qwen", torch_dtype=torch.float32).eval()
    tcfg, params, _ = tdec.load_safetensors_decoder(str(tmp_path / "qwen"), dtype=torch.float32)
    ids = np.random.default_rng(2).integers(0, 512, size=(1, 16))
    model = tdec.DecoderModel(tcfg)
    got, _ = model.forward(params, torch.from_numpy(ids), model.init_cache(1, 16, dtype=torch.float32), 0)
    with torch.no_grad():
        want = gold(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=GOLD_TOL, atol=GOLD_TOL)

    bge = {**chip_smoke.BGE_M3_CONFIG, "num_hidden_layers": 2, "hidden_size": 32, "num_attention_heads": 4,
           "intermediate_size": 64, "vocab_size": 128, "max_position_embeddings": 66}
    chip_smoke.write_bge_m3_checkpoint(tmp_path / "bge", 0, config=bge, device="cpu")
    gold = transformers.XLMRobertaModel.from_pretrained(tmp_path / "bge", torch_dtype=torch.float32).eval()
    cfg, enc, _ = tt.load_safetensors_encoder(str(tmp_path / "bge"), dtype=torch.float32)
    assert cfg["max_len"] == 64
    ids = np.random.default_rng(3).integers(2, 128, size=(2, 10))
    mask = np.ones((2, 10), dtype=bool)
    with torch.inference_mode():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        want = gold(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask).long()).last_hidden_state
    np.testing.assert_allclose(got, want.numpy(), rtol=GOLD_TOL, atol=GOLD_TOL)


@pytest.mark.parametrize(("response_format", "speculate"), [(None, "0"), ({"type": "json_object"}, "auto")])
def test_hf_complete_batch_equals_jax(chat_llms, monkeypatch, response_format, speculate: str) -> None:
    """Batched generation of a BPE model (no automaton even with a response
    format: the rows decode unconstrained, no BOS before each prompt):
    ragged rows give the JAX package's texts, speculation off and on."""
    j_llm, t_llm = chat_llms
    batch = [MESSAGES, [{"role": "user", "content": "Name three colours."}], [{"role": "user", "content": "x"}]]
    monkeypatch.setenv("RAGLITE_TPU_SPECULATE", speculate)
    want = [r.content for r in j_llm.complete_batch(batch, response_format=response_format, max_tokens=16)]
    got = [r.content for r in t_llm.complete_batch(batch, response_format=response_format, max_tokens=16)]
    assert len(got) == 3
    for g, w in zip(got, want):
        _same_text(g or "", w or "")

