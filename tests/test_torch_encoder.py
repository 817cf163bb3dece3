"""The port's encoder stack (tokenizer, Markdown parse, EncoderModel,
TransformerEncoder) against the JAX package's, on the CPU.

Tolerances: f32 hidden states within 1e-4 absolute (summation order of
PyTorch's and XLA's CPU matmuls); bf16 hidden states with a cosine of at
least 0.999 per token (bf16 rounds at the same places in both, but each
rounding can land on either side after a differently ordered f32 sum); the
packaged 8-layer encoder in f32 within 1e-3 absolute.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.models import encoder as jenc
from raglite_tpu.models import transformer as jt
from raglite_tpu_torch.models import encoder as tenc
from raglite_tpu_torch.models import transformer as tt

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(layers=2, d_model=256, heads=4, d_ff=512, vocab=8192, max_len=512)
ENCODER_DIR = ROOT / "raglite_tpu" / "models" / "data" / "encoder"


def _inputs(rng, cfg, B=3, T=40):
    ids = rng.integers(3, cfg["vocab"], size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[1, 25:] = False  # padding keys
    mask[2, 7:] = False
    return ids, mask


def _hidden(params, cfg, ids, mask, dtype):
    jax_out = np.asarray(
        jt.EncoderModel(cfg).apply_tokens(params, jnp.asarray(ids), jnp.asarray(mask)), np.float32
    )
    model = tt.EncoderModel.from_params(cfg, params, dtype=dtype, device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    return out, jax_out


@pytest.mark.parametrize("hidden_act", ["gelu", "gelu_new"])
def test_encoder_model_f32_matches_jax(hidden_act: str) -> None:
    cfg = {**TINY, "hidden_act": hidden_act}
    params = jt.init_encoder_params(cfg, seed=1, dtype=jnp.float32)
    # Nonzero biases and LN parameters, so every term of the layer counts.
    rng = np.random.default_rng(0)
    for layer in params["layers"]:
        for name in list(layer):
            if name.startswith("b") or name.endswith("_bias"):
                layer[name] = jnp.asarray(rng.normal(scale=0.1, size=layer[name].shape), jnp.float32)
    ids, mask = _inputs(rng, cfg)
    out, ref = _hidden(params, cfg, ids, mask, torch.float32)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_encoder_model_bf16_matches_jax() -> None:
    params = jt.init_encoder_params(TINY, seed=2, dtype=jnp.bfloat16)
    ids, mask = _inputs(np.random.default_rng(1), TINY)
    out, ref = _hidden(params, TINY, ids, mask, torch.bfloat16)
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.999, cos.min()


def test_encoder_model_without_final_ln() -> None:
    params = jt.init_encoder_params(TINY, seed=3, dtype=jnp.float32)
    del params["final_ln_scale"], params["final_ln_bias"]
    ids, mask = _inputs(np.random.default_rng(2), TINY)
    out, ref = _hidden(params, TINY, ids, mask, torch.float32)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_packaged_encoder_f32_matches_jax() -> None:
    cfg, jparams, _ = jt.load_npz_encoder(str(ENCODER_DIR / "encoder.npz"), dtype=jnp.float32)
    tcfg, tparams, _ = tt.load_npz_encoder(str(ENCODER_DIR / "encoder.npz"))
    assert tcfg == cfg and set(tparams) == set(jparams)
    from raglite_tpu_torch.models.tokenizer import load_tokenizer

    tok = load_tokenizer(str(ENCODER_DIR / "tokenizer.json"))
    ids = np.asarray([tok.encode("How is the dense index searched on the card?")], np.int32)
    mask = np.ones_like(ids, bool)
    ref = np.asarray(jt.EncoderModel(cfg).apply_tokens(jparams, jnp.asarray(ids), jnp.asarray(mask)))
    model = tt.EncoderModel.from_params(tcfg, tparams, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


_MD_EXTRA = (
    "Title\n=====\n\n```py\n# not a heading\n```\n\n- a\n  - b\n    1. c\n\n> quote\n> > nested\n"
    "lazy line\n\nSub\n---\n    indented code\n<div>\n# html\n</div>\n\n[ref]: http://x.y 'title'\n"
    "para\n1. interrupts\n* * *\n<!-- c\n# in comment -->\n\ttab\r\nwindows\r\n"
)
_TOKENIZER_EXTRA = (
    "", " ", "<s>specials</s> split<mask><pad>x", "don't I'll we've", "ümlaut 日本語 ١٢٣ x²",
    "emoji 🙂 and a\x1ccontrol", "trailing   ", "\n\n\tindent",
)
_MD_KEEP = {"heading_open", "blockquote_open", "paragraph_open", "bullet_list_open", "ordered_list_open"}


def _markdown_texts() -> list[str]:
    return [p.read_text(encoding="utf-8") for p in sorted(ROOT.glob("*.md"))]


def test_bpe_tokenizer_matches_tokenizers() -> None:
    """The pure-Python BPE gives the ``tokenizers`` package's ids for the
    packaged tokenizer.json on every Markdown file of the repository and on
    edge cases (added specials, contractions, scripts, bytes outside the
    vocabulary)."""
    tokenizers = pytest.importorskip("tokenizers")
    from raglite_tpu_torch.models.tokenizer import load_tokenizer

    ref = tokenizers.Tokenizer.from_file(str(ENCODER_DIR / "tokenizer.json"))
    tok = load_tokenizer(str(ENCODER_DIR / "tokenizer.json"))
    for text in [*_markdown_texts(), *_TOKENIZER_EXTRA]:
        assert tok.encode(text) == ref.encode(text, add_special_tokens=False).ids, text[:80]


def test_markdown_block_tokens_match_markdown_it() -> None:
    """The block scanner's opening tokens (type and line map) equal
    markdown-it's on every Markdown file of the repository, plus setext
    headings, fenced and indented code, nested lists and blockquotes, lazy
    continuation, HTML blocks, reference definitions and \\r\\n lines."""
    markdown_it = pytest.importorskip("markdown_it")
    from raglite_tpu_torch.utils.mdparse import parse_markdown

    md = markdown_it.MarkdownIt()
    for text in [*_markdown_texts(), _MD_EXTRA]:
        want = [(t.type, t.map) for t in md.parse(text) if t.type in _MD_KEEP]
        assert [(t.type, t.map) for t in parse_markdown(text)] == want


_MD_LINES = (
    "# h", "## h ##", "#nope", "####### x", "Title", "=====", "---", "***", "- a", "* b", "+ c",
    "1. one", "2) two", "10. ten", "  - nested", "    - deep", "     code", "\tcode", "> q", ">q",
    "> > qq", ">", "```", "```py", "~~~", "````", "", "", "text line", "lazy", "<div>", "</div>",
    "<!-- c -->", "<!--", "-->", "<span>", "<script>", "</script>", '[ref]: http://x.y "t"',
    "[ref]:", "  <http://a>", "'title'", "[x]: javascript:alert(1)", "| a | b |", "|---|---|",
    "1.", "-", "* * *", "  > quoted", "   # h3", "\\# esc", "<?php", "?>", "<![CDATA[", "]]>",
    "<!DOCTYPE html>", " \t- tab", "\t> t", "[a]: <b> (c)", "(multi", "line)",
)


def test_markdown_block_tokens_match_markdown_it_fuzzed() -> None:
    """The same on 2,000 seeded random documents built from lines that
    exercise every block rule, with random indentation."""
    markdown_it = pytest.importorskip("markdown_it")
    from raglite_tpu_torch.utils.mdparse import parse_markdown

    md = markdown_it.MarkdownIt()
    rng = np.random.default_rng(0)
    for _ in range(2000):
        lines = [
            " " * int(rng.choice([0, 0, 0, 1, 2, 3, 4, 6])) + _MD_LINES[int(i)]
            for i in rng.integers(0, len(_MD_LINES), size=int(rng.integers(1, 15)))
        ]
        text = "\n".join(lines) + ("\n" if rng.random() < 0.3 else "")
        want = [(t.type, t.map) for t in md.parse(text) if t.type in _MD_KEEP]
        assert [(t.type, t.map) for t in parse_markdown(text)] == want, text


def _encoders(dtype_j=jnp.float32, dtype_t=torch.float32):
    """The JAX tiny preset (f32) and the port's encoder on its weights."""
    from raglite_tpu.models.tokenizer import ByteTokenizer as JByte
    from raglite_tpu_torch.models.tokenizer import ByteTokenizer as TByte

    j = jenc.TransformerEncoder("tiny", dtype=dtype_j)
    assert isinstance(j._tokenizer, JByte)
    model = tt.EncoderModel.from_params(j._cfg, j._params, dtype=dtype_t, device="cpu")
    return j, tenc.TransformerEncoder.from_model(model, TByte(vocab_size=j._cfg["vocab"]))


def test_transformer_encoder_matches_jax() -> None:
    j, t = _encoders()
    texts = ["late chunking keeps context", "", "a longer text " * 30, "short"]
    assert t.count_tokens(texts) == j.count_tokens(texts)
    np.testing.assert_allclose(t.embed(texts), j.embed(texts), atol=1e-4, rtol=0)
    for a, b in zip(t.embed_token_level_batch(texts), j.embed_token_level_batch(texts)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        t.embed_token_level(texts[0]), j.embed_token_level(texts[0]), atol=1e-4, rtol=0
    )


def test_rerank_maxsim_matches_jax() -> None:
    j, t = _encoders()
    cands = [f"candidate {i} about {'dense ' * i}search" for i in range(11)] + ["", "x" * 300]
    query = "dense search"
    ref = j.rerank_maxsim(query, cands)
    np.testing.assert_allclose(t.rerank_maxsim(query, cands), ref, atol=1e-4, rtol=0)
    # Warm call: the candidates' states come from the device-resident cache.
    assert all(c in t._rerank_cache for c in cands if c)
    np.testing.assert_allclose(t.rerank_maxsim(query, cands), ref, atol=1e-4, rtol=0)
    assert t.rerank_maxsim("", cands).tolist() == [0.0] * len(cands)
