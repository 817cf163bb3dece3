"""The port's decoder LLM, speculation, LLM factory and RAG layer
(models/decoder.py, models/speculative.py, models/llm.py, rag.py) against
the JAX package's, on the CPU.

Tolerances: logits in f32 within 1e-4 absolute and relative (summation
order of the two frameworks' CPU matmuls).  Greedy tokens are compared
exactly: both run the same weights (carried across with
``params_from_jax``) with a bf16 KV cache.  Sampled tokens are never
compared (torch.Generator and jax.random give other bits); the sampling
filter is compared on the same logits instead.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.config import RAGLiteConfig as JaxConfig
from raglite_tpu.documents import Chunk as JaxChunk
from raglite_tpu.documents import ChunkSpan as JaxChunkSpan
from raglite_tpu.documents import Document as JaxDocument
from raglite_tpu.models import decoder as jdec
from raglite_tpu.models import speculative as jspec
from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.documents import Chunk, ChunkSpan, Document
from raglite_tpu_torch.models import decoder as tdec
from raglite_tpu_torch.models import speculative as tspec
from raglite_tpu_torch.models.llm import _make_llm

# The packages export a function named ``rag`` too: take the modules.
jrag = importlib.import_module("raglite_tpu.rag")
trag = importlib.import_module("raglite_tpu_torch.rag")
TOL = 1e-4
#: The prompts of tests/test_speculative.py's exactness test.
PROMPTS = [
    "the cat sat on the mat. the cat sat on the mat. the cat sat",
    "q9 zp! & unique tokens only here",
    "ab",
]
#: A hand-made 2-layer config with every family knob the forward reads.
KNOBS_CFG = dict(
    layers=2, d_model=64, heads=4, kv_heads=2, d_ff=96, vocab=300, max_len=256,
    rope_base=10000.0, rope_scaling={"rope_type": "linear", "factor": 2.0},
    rope_local_base=1000.0, rms_eps=1e-5, attn_scale=0.2, emb_scale=8.0,
    hidden_act="gelu_pytorch_tanh", attn_softcap=30.0, final_softcap=20.0,
    sliding_window=6, layer_sliding=[True, False],
)


@pytest.fixture(scope="module")
def jax_llm() -> jdec.JaxChatLLM:
    return jdec.JaxChatLLM("tiny", seed=3, dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_llm(jax_llm) -> tdec.TorchChatLLM:
    llm = tdec.TorchChatLLM("tiny", device="cpu", dtype=torch.float32)
    llm.params = tdec.params_from_jax(jax_llm.params, dtype=torch.float32)
    return llm


def _knob_params(seed: int = 1) -> dict:
    """JAX-layout f32 params for KNOBS_CFG, with q/k/v biases, q/k norms and
    sandwich norms added."""
    cfg = KNOBS_CFG
    params = jdec.init_decoder_params(cfg, seed=seed, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    hd, d = cfg["d_model"] // cfg["heads"], cfg["d_model"]
    params = {k: np.asarray(v) for k, v in params.items() if k != "layers"} | {"layers": [
        {k: np.asarray(v) for k, v in layer.items()} for layer in params["layers"]
    ]}
    for layer in params["layers"]:
        layer["bq"] = rng.normal(0, 0.1, cfg["heads"] * hd).astype(np.float32)
        layer["bk"] = rng.normal(0, 0.1, cfg["kv_heads"] * hd).astype(np.float32)
        layer["bv"] = rng.normal(0, 0.1, cfg["kv_heads"] * hd).astype(np.float32)
        layer["q_norm"] = (1 + rng.normal(0, 0.1, hd)).astype(np.float32)
        layer["k_norm"] = (1 + rng.normal(0, 0.1, hd)).astype(np.float32)
        layer["post_attn_norm"] = (1 + rng.normal(0, 0.1, d)).astype(np.float32)
        layer["post_mlp_norm"] = (1 + rng.normal(0, 0.1, d)).astype(np.float32)
    return params


@pytest.mark.parametrize("which", ["tiny", "knobs"])
def test_forward_logits_match_jax(which: str, jax_llm) -> None:
    """Prefill (T = 24: the prefill route), a verify window (T = 8) and
    decode steps (T = 1) at per-row offsets, then a window written past the
    cache end (the dynamic_update_slice clamp): logits and caches agree."""
    if which == "tiny":
        cfg, jparams = jax_llm.cfg, jax_llm.params
    else:
        cfg = KNOBS_CFG
        jparams = _knob_params()
    jmodel, tmodel = jdec.DecoderModel(cfg), tdec.DecoderModel(cfg)
    jforward = jax.jit(jmodel.forward)
    tparams = tdec.params_from_jax(jparams, dtype=torch.float32)
    b, s = 2, 48
    jcache = jmodel.init_cache(b, s, dtype=jnp.float32)
    tcache = tmodel.init_cache(b, s, dtype=torch.float32)
    rng = np.random.default_rng(4)

    def step(ids: np.ndarray, offsets) -> None:
        nonlocal jcache
        jl, jcache = jforward(jparams, jnp.asarray(ids), jcache, jnp.asarray(offsets, jnp.int32))
        tl, _ = tmodel.forward(tparams, torch.from_numpy(ids).long(), tcache, torch.as_tensor(offsets))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)

    step(rng.integers(3, cfg["vocab"], (b, 24)), 0)  # prefill, scalar offset
    step(rng.integers(3, cfg["vocab"], (b, 8)), np.array([24, 20]))  # verify window
    for i in range(3):  # decode steps
        step(rng.integers(3, cfg["vocab"], (b, 1)), np.array([32 + i, 28 + i]))
    step(rng.integers(3, cfg["vocab"], (b, 8)), np.array([s - 3, s - 8]))  # clamped write
    for name in ("k", "v"):
        for jc, tc in zip(jcache[name], tcache[name]):
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [1, 8, 24])
def test_forward_takes_int32_and_int64_offsets_alike(t: int, torch_llm) -> None:
    """The forward makes the attention kernels' int32 positions itself, once:
    int32 and int64 ``cache_len`` give the same logits and the same cache, at
    T = 1 (decode), 8 (verify) and 24 (prefill)."""
    model, params = torch_llm.model, torch_llm.params
    rng = np.random.default_rng(t)
    ids = torch.from_numpy(rng.integers(3, 259, (2, t)))
    offsets = np.array([5, 17])
    logits, caches = [], []
    for dtype in (torch.int32, torch.int64):
        cache = model.init_cache(2, 48, dtype=torch.float32)
        for name in ("k", "v"):
            for layer in cache[name]:
                layer.copy_(torch.from_numpy(np.random.default_rng(7).standard_normal(layer.shape).astype(np.float32)))
        out, cache = model.forward(params, ids, cache, torch.as_tensor(offsets, dtype=dtype))
        logits.append(out)
        caches.append(cache)
    assert torch.equal(logits[0], logits[1])
    for name in ("k", "v"):
        for a, b in zip(caches[0][name], caches[1][name]):
            assert torch.equal(a, b)


def test_prefill_last_matches_jax(jax_llm, torch_llm) -> None:
    """The generation prefill (bf16 cache, last-position logits only).
    Tolerance 2e-3: keys, values and probabilities are rounded to bf16 (a
    relative 2^-8) from f32 values that differ in their last bits between
    the frameworks, so a rounding can land on either side."""
    ids = np.zeros((1, 64), np.int32)
    ids[0, :40] = np.random.default_rng(0).integers(3, 259, 40)
    lens = np.array([40], np.int32)
    jl, _ = jdec._prefill_last(
        jax_llm.model, jax_llm.params, jnp.asarray(ids), jax_llm.model.init_cache(1, 256), jnp.asarray(lens)
    )
    tl, _ = tdec._prefill_last(
        torch_llm.model, torch_llm.params, torch.from_numpy(ids).long(),
        torch_llm.model.init_cache(1, 256), torch.from_numpy(lens).long(),
    )
    assert tl.shape == (1, jax_llm.cfg["vocab"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)


def _tokens(llm, prompt, monkeypatch, *, speculate: bool, max_new: int = 90, **sampling) -> list[int]:
    monkeypatch.setenv("RAGLITE_TPU_SPECULATE", "always" if speculate else "0")
    return list(llm._generate_tokens(prompt, max_new_tokens=max_new, **sampling))


@pytest.mark.parametrize("prompt", PROMPTS)
def test_greedy_tokens_match_jax(prompt, jax_llm, torch_llm, monkeypatch) -> None:
    want = _tokens(jax_llm, prompt, monkeypatch, speculate=False)
    got = _tokens(torch_llm, prompt, monkeypatch, speculate=False)
    assert got == want and len(got) > 0
    assert torch_llm.tokenizer.decode(got) == jax_llm.tokenizer.decode(want)


@pytest.mark.parametrize(("prompt", "max_new"), [(p, 90) for p in PROMPTS] + [
    ("alpha beta gamma. alpha beta gamma. alpha beta", 200),  # across chunks
    (("ab cd. " * 9 + "ab cd.")[:63], 64),  # prompt fills its bucket, no slack
])
def test_greedy_speculation_is_exact(prompt, max_new, torch_llm, monkeypatch) -> None:
    """The port's speculative greedy decode emits its plain greedy tokens."""
    plain = _tokens(torch_llm, prompt, monkeypatch, speculate=False, max_new=max_new)
    spec = _tokens(torch_llm, prompt, monkeypatch, speculate=True, max_new=max_new)
    assert spec == plain and len(plain) > 0


def test_speculation_accepts_and_defaults(torch_llm, monkeypatch) -> None:
    """Copy-heavy text commits more than one token per verify forward;
    by default greedy decode speculates and sampled decode does not."""
    spec = _tokens(torch_llm, "one two three four. " * 8, monkeypatch, speculate=True, max_new=120)
    stats = torch_llm.spec_stats
    assert stats["tokens"] == len(spec)
    assert stats["tokens"] / max(stats["verify_iters"], 1) > 1.3
    monkeypatch.delenv("RAGLITE_TPU_SPECULATE", raising=False)
    torch_llm.spec_stats = None
    list(torch_llm._generate_tokens("x y. x y. x", max_new_tokens=40))
    assert torch_llm.spec_stats is not None
    torch_llm.spec_stats = None
    out = list(torch_llm._generate_tokens("x y. x y. x", max_new_tokens=24, temperature=0.7, top_k=20, top_p=0.8))
    assert torch_llm.spec_stats is None and 0 < len(out) <= 24


@pytest.mark.parametrize("speculate", [False, True])
def test_sampled_decode_runs_and_terminates(speculate, torch_llm, monkeypatch) -> None:
    out = _tokens(
        torch_llm, "the rain in spain stays mainly on the plain. the rain in", monkeypatch,
        speculate=speculate, temperature=0.8, top_p=0.9, top_k=40, max_new=64,
    )
    assert 0 < len(out) <= 64
    assert all(0 <= t < torch_llm.cfg["vocab"] and t not in torch_llm._stop_ids for t in out)


def test_speculate_chunk_freezes_at_kv_capacity(torch_llm) -> None:
    """With an undersized cache (no headroom) the loop freezes the row before
    its verify window could overflow the KV buffer: no tokens, no writes."""
    tok = torch_llm.tokenizer
    ids = [tok.BOS, *tok.encode("xy. xy. xy. xy.")]
    kv_cap = len(ids) + tdec.SPEC_DRAFT_LEN  # < one full window of free space
    model, params = torch_llm.model, torch_llm.params
    cache = model.init_cache(1, kv_cap)
    lens = torch.tensor([len(ids)])
    last, cache = tdec._prefill_last(model, params, torch.tensor([ids]), cache, lens)
    before = [c.clone() for c in cache["k"]]
    hist = torch.full((1, kv_cap), tok.PAD)
    hist[0, : len(ids)] = torch.tensor(ids)
    out, _, cache_lens, *_ = tspec.speculate_chunk_device(
        model, cache, params, lens, last, torch.full((1,), -1),
        torch.zeros(torch_llm.cfg["vocab"]), torch.zeros(1, dtype=torch.bool),
        torch_llm._stop_ids_device(), torch.Generator().manual_seed(0), hist, lens.clone(),
        num_tokens=32, draft_len=tdec.SPEC_DRAFT_LEN, pad_id=tok.PAD,
        temperature=0.0, top_p=1.0, top_k=0, min_p=0.0,
    )
    assert int(cache_lens[0]) == len(ids)
    assert (out == -1).all()
    assert all(torch.equal(a, c) for a, c in zip(before, cache["k"]))


def test_filtered_probs_match_jax() -> None:
    logits = np.random.default_rng(2).normal(0, 3, (3, 257)).astype(np.float32)
    for kw in (
        dict(temperature=0.7, top_p=0.8, top_k=20, min_p=0.0),
        dict(temperature=1.3, top_p=1.0, top_k=0, min_p=0.05),
        dict(temperature=0.5, top_p=0.5, top_k=0, min_p=0.0),
    ):
        want = np.asarray(jspec._filtered_probs(jnp.asarray(logits), **kw))
        got = tspec._filtered_probs(torch.from_numpy(logits), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ngram_draft_matches_jax() -> None:
    """Seeded histories over a small alphabet (many n-gram matches), drafts
    that run off the end of the buffer, and empty histories."""
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 4, (64, 24)).astype(np.int32)
    lens = rng.integers(0, 25, 64).astype(np.int32)
    lens[:3] = [0, 1, 24]
    t = rng.integers(0, 4, 64).astype(np.int32)
    got = tspec._ngram_draft(*(torch.from_numpy(x).long() for x in (hist, lens, t)), 5, 9).numpy()
    draft = jax.jit(jspec._ngram_draft, static_argnums=(3, 4))
    for i in range(64):
        want = np.asarray(draft(jnp.asarray(hist[i]), jnp.asarray(lens[i]), jnp.asarray(t[i]), 5, 9))
        assert got[i].tolist() == want.tolist(), i


def test_unported_specs_raise() -> None:
    for spec in ("hf:/nowhere", "ckpt:/nowhere", "tiny@int8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdec.TorchChatLLM(spec, device="cpu")
    # openai: is ported (no request is made until the LLM is called).
    remote = _make_llm("openai:http://localhost:1#m", "cpu")
    assert remote.base_url == "http://localhost:1" and remote.model == "m"
    llm = _make_llm("jax:tiny", "cpu")
    assert isinstance(llm, tdec.TorchChatLLM) and llm is _make_llm("jax:tiny", "cpu")


def _spans(pkg: str, n: int = 12, size: int = 2500) -> list:
    """``n`` one-chunk spans of ``size`` characters, in either package."""
    doc_cls, chunk_cls, span_cls = (
        (Document, Chunk, ChunkSpan) if pkg == "torch" else (JaxDocument, JaxChunk, JaxChunkSpan)
    )
    rng = np.random.default_rng(7)
    spans = []
    for i in range(n):
        words = " ".join(f"w{x}" for x in rng.integers(0, 1000, size // 4))[:size]
        doc = doc_cls.from_text(f"# Doc {i}\n\n{words}\n", id=f"doc{i}", filename=f"doc{i}.md")
        chunk = chunk_cls.from_body(doc, 0, words + "\n", headings=f"# Doc {i}")
        chunk.document = doc
        spans.append(span_cls([chunk]))
    return spans


@pytest.mark.parametrize("n", [3, 12])
def test_add_context_and_limits_match_jax(n: int) -> None:
    """add_context, _limit_chunkspans and _clip render and cut the same
    spans and messages as the JAX package (n = 12 exceeds the 8192-token
    window of the echo LLM, so spans are dropped)."""
    cfg, jcfg = RAGLiteConfig(llm="echo", device="cpu"), JaxConfig(llm="echo")
    tspans, jspans = _spans("torch", n), _spans("jax", n)
    question = "What do the documents say about w42?"
    assert trag.add_context(question, tspans, cfg) == jrag.add_context(question, jspans, jcfg)
    got = trag._limit_chunkspans({0: tspans, 1: tspans[:2]}, cfg, messages=[{"role": "user", "content": question}])
    want = jrag._limit_chunkspans({0: jspans, 1: jspans[:2]}, jcfg, messages=[{"role": "user", "content": question}])
    assert {k: [s.to_xml() for s in v] for k, v in got.items()} == {
        k: [s.to_xml() for s in v] for k, v in want.items()
    }
    messages = [{"role": "system", "content": "Be brief."}]
    for i in range(n):
        messages += [{"role": "user", "content": f"q{i} " * 400}, {"role": "assistant", "content": "a " * 300}]
    messages.append({"role": "user", "content": question})
    for max_tokens in (50, 2000, 20000):
        assert trag._clip(messages, max_tokens) == jrag._clip(messages, max_tokens)


def test_rag_with_echo_streams_like_jax() -> None:
    """rag() with the echo LLM and a message that carries context: the same
    streamed pieces and the same appended answer as the JAX rag()."""
    cfg, jcfg = RAGLiteConfig(llm="echo", device="cpu"), JaxConfig(llm="echo")
    question = "What is w7 about?"
    tmsgs = [trag.add_context(question, _spans("torch", 3), cfg)]
    jmsgs = [jrag.add_context(question, _spans("jax", 3), jcfg)]
    assert list(trag.rag(tmsgs, config=cfg)) == list(jrag.rag(jmsgs, config=jcfg))
    assert tmsgs == jmsgs and tmsgs[-1]["role"] == "assistant"


def test_rag_answers_from_the_decoder_on_cpu() -> None:
    """The slice's path end to end at the tiny preset: a context message
    answered by rag() through TorchChatLLM (speculative greedy)."""
    cfg = RAGLiteConfig(llm="jax:tiny", device="cpu")
    messages = [trag.add_context("What is w7 about?", _spans("torch", 2, 300), cfg)]
    pieces = list(trag.rag(messages, config=cfg))
    assert all(isinstance(p, str) for p in pieces)
    assert messages[-1] == {"role": "assistant", "content": "".join(pieces)}
    assert _make_llm("jax:tiny", "cpu").spec_stats is not None


#: Shapes the JAX decoder prefills (its einsum where its kernel is not viable)
#: and the port's prefill kernel is built for: a 256-wide head, and 18 query
#: heads on 2 KV heads (REP 9).
WIDE_CFGS = {
    "head_dim_256": dict(
        layers=2, d_model=512, heads=2, kv_heads=1, head_dim=256, d_ff=96, vocab=300, max_len=128,
        rope_base=10000.0, rms_eps=1e-5,
    ),
    "rep_9": dict(
        layers=2, d_model=288, heads=18, kv_heads=2, d_ff=96, vocab=300, max_len=128,
        rope_base=10000.0, rms_eps=1e-5,
    ),
}


@pytest.mark.parametrize("which", list(WIDE_CFGS))
def test_prefill_logits_match_jax_at_wide_heads_and_groups(which: str) -> None:
    """The port takes what the JAX decoder takes: a T = 24 prefill (the
    prefill attention route) at head_dim 256 and at REP 9, then a T = 24
    window at per-row offsets over that cache; logits agree."""
    cfg = WIDE_CFGS[which]
    jparams = jdec.init_decoder_params(cfg, seed=2, dtype=jnp.float32)
    jmodel, tmodel = jdec.DecoderModel(cfg), tdec.DecoderModel(cfg)
    assert tmodel.head_dim == jmodel.head_dim and cfg["heads"] // cfg["kv_heads"] in (2, 9)
    tparams = tdec.params_from_jax(jparams, dtype=torch.float32)
    b, s, t = 2, 64, 24
    jcache = jmodel.init_cache(b, s, dtype=jnp.float32)
    tcache = tmodel.init_cache(b, s, dtype=torch.float32)
    rng = np.random.default_rng(6)
    for offsets in (0, np.array([24, 17])):
        ids = rng.integers(3, cfg["vocab"], (b, t))
        jl, jcache = jax.jit(jmodel.forward)(jparams, jnp.asarray(ids), jcache, jnp.asarray(offsets, jnp.int32))
        tl, _ = tmodel.forward(tparams, torch.from_numpy(ids).long(), tcache, torch.as_tensor(offsets))
        assert tl.shape == (b, t, cfg["vocab"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_stream_joins_to_jax_text(seed: int) -> None:
    """The byte decoder's pieces join to the JAX package's text on random
    bytes (invalid UTF-8 included) and on valid multibyte text, where the
    pieces are the JAX package's too; after an invalid byte the port goes
    on streaming (one piece a character) where the JAX package holds the
    rest back."""
    import types

    off = tdec.ByteTokenizer._OFFSET
    jax_self = types.SimpleNamespace(_byte_level=True)
    rng = np.random.default_rng(seed)
    valid = [b + off for b in "héllo wörld, 数据 ✓ ok".encode()]
    random_bytes = [int(b) + off for b in rng.integers(0, 256, size=200)] + [0, 1]
    for tokens in (valid, random_bytes, valid + random_bytes + valid):
        got = list(tdec.TorchChatLLM._decode_stream(None, iter(tokens)))
        want = list(jdec.JaxChatLLM._decode_stream(jax_self, iter(tokens)))
        assert "".join(got) == "".join(want)
        if tokens is valid:
            assert got == want
    stray = [0x80 + off] + [b + off for b in b"abc"]
    assert list(tdec.TorchChatLLM._decode_stream(None, iter(stray))) == ["\ufffd", "a", "b", "c"]
    assert list(jdec.JaxChatLLM._decode_stream(jax_self, iter(stray))) == ["\ufffdabc"]
