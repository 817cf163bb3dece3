"""The port's three attention wrappers (ops/decode_attention.py,
ops/prefill_attention.py) against the JAX package's Pallas kernels, run in
interpret mode on the CPU.

CPU tensors take the plain PyTorch versions; the CUDA kernels are checked
against those on the card by ``chip_smoke.py``.  Tolerance: 2e-5 absolute
and relative in f32, as the JAX kernel tests use (summation order of the
two frameworks' CPU contractions).  Inputs are seeded numpy arrays with
soft-capping, sliding windows, a ragged S and per-row positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.ops.decode_attention import gqa_decode_attention as jax_decode
from raglite_tpu.ops.decode_attention import gqa_verify_attention as jax_verify
from raglite_tpu.ops.prefill_attention import gqa_prefill_attention as jax_prefill
from raglite_tpu_torch.ops import decode_attention as da
from raglite_tpu_torch.ops import prefill_attention as pa

TOL = 2e-5
KNOBS = [(0.0, 0), (50.0, 0), (0.0, 7), (30.0, 5)]


def _cache(rng, b, g, hd, s):
    k = rng.standard_normal((b, g, hd, s)).astype(np.float32)
    v = rng.standard_normal((b, g, hd, s)).astype(np.float32)
    return k, v


def _both(jax_fn, torch_fn, arrays, scale, softcap, window):
    want = np.asarray(
        jax_fn(*map(jnp.asarray, arrays), scale=scale, softcap=softcap, window=window, interpret=True)
    )
    got = torch_fn(*map(torch.from_numpy, arrays), scale=scale, softcap=softcap, window=window).numpy()
    return got, want


@pytest.mark.parametrize(("softcap", "window"), KNOBS)
def test_decode_matches_jax_kernel(softcap: float, window: int) -> None:
    rng = np.random.default_rng(0)
    b, g, r, hd, s = 3, 2, 3, 16, 37  # ragged S
    q = rng.standard_normal((b, g, r, hd)).astype(np.float32)
    k, v = _cache(rng, b, g, hd, s)
    pos = np.array([0, 20, 36], np.int32)  # first, middle and last key
    got, want = _both(jax_decode, da.gqa_decode_attention, (q, k, v, pos), 0.25, softcap, window)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [2, 5, 8])
@pytest.mark.parametrize(("softcap", "window"), KNOBS)
def test_verify_matches_jax_kernel(t: int, softcap: float, window: int) -> None:
    rng = np.random.default_rng(t)
    b, g, r, hd, s = 2, 2, 2, 16, 45
    q = rng.standard_normal((b, g, r, t, hd)).astype(np.float32)
    k, v = _cache(rng, b, g, hd, s)
    pos = np.array([3, s - t], np.int32)
    got, want = _both(jax_verify, da.gqa_verify_attention, (q, k, v, pos), 0.3, softcap, window)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # Row t of a verify window is the decode step at pos0 + t (the plain
    # versions share one code path, so exactly).
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    for i in range(t):
        one = da.gqa_decode_attention(
            qt[:, :, :, i], kt, vt, torch.from_numpy(pos) + i, scale=0.3, softcap=softcap, window=window
        )
        assert torch.equal(one, torch.from_numpy(got)[:, :, :, i])


@pytest.mark.parametrize(("softcap", "window"), KNOBS)
def test_prefill_matches_jax_kernel(softcap: float, window: int) -> None:
    rng = np.random.default_rng(5)
    b, g, r, t, hd, s = 2, 2, 2, 24, 16, 50
    q = rng.standard_normal((b, g, r, t, hd)).astype(np.float32)
    k, v = _cache(rng, b, g, hd, s)
    off = np.array([0, 19], np.int32)  # prompt prefill, and a window at an offset
    got, want = _both(jax_prefill, pa.gqa_prefill_attention, (q, k, v, off), 0.25, softcap, window)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bf16_cache_matches_jax_kernel() -> None:
    """The decoder's cache dtype: q is cast to bf16 and the probabilities
    are rounded to bf16 before the PV product, in both."""
    rng = np.random.default_rng(9)
    b, g, r, hd, s = 2, 2, 5, 32, 40
    q = rng.standard_normal((b, g, r, hd)).astype(np.float32)
    k, v = _cache(rng, b, g, hd, s)
    pos = np.array([7, 39], np.int32)
    want = np.asarray(jax_decode(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        jnp.asarray(pos), scale=hd**-0.5, interpret=True,
    ))
    kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    got = da.gqa_decode_attention(torch.from_numpy(q), kb, vb, torch.from_numpy(pos), scale=hd**-0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["decode", "verify", "prefill"])
def test_wrappers_refuse_other_devices(which: str) -> None:
    """Only CPU tensors take the plain version: anything else that is not a
    CUDA tensor raises instead of computing."""
    q = torch.zeros((1, 1, 1, 2, 8), device="meta")
    k = torch.zeros((1, 1, 8, 16), device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    fn = {
        "decode": lambda: da.gqa_decode_attention(q[:, :, :, 0], k, k, pos, scale=1.0),
        "verify": lambda: da.gqa_verify_attention(q, k, k, pos, scale=1.0),
        "prefill": lambda: pa.gqa_prefill_attention(q, k, k, pos, scale=1.0),
    }[which]
    with pytest.raises(ValueError, match="CUDA"):
        fn()


def _split_rounding(q, k, v, pos, *, scale, softcap, split=128, drop=None):
    """The CUDA decode kernel's arithmetic on the CPU (f32, bf16 caches):
    per 128-key split, bf16(exp(logit - m_split)) @ v and its sum of
    exp, merged with weights exp(m_split - M); ``drop`` zeroes one split's
    weight, a fault the tolerance must catch."""
    probs_args = dict(scale=scale, softcap=softcap)
    # log-probabilities are the logits less a constant per row; masked keys
    # return to -1e9, as the kernel masks them.
    logits = torch.log(da.gqa_attention_probs_plain(q, k, pos, **probs_args)).clamp(min=-1e9)
    vf = v.to(torch.float32)
    ms, ls, accs = [], [], []
    for s0 in range(0, k.shape[3], split):
        x = logits[..., s0 : s0 + split]
        m = x.amax(dim=-1, keepdim=True)
        e = torch.exp(x - m)
        ms.append(m[..., 0])
        ls.append(e.sum(dim=-1))
        accs.append(torch.einsum("bgrts,bgds->bgrtd", e.to(torch.bfloat16).float(), vf[..., s0 : s0 + split]))
    m = torch.stack(ms, -1)
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    if drop is not None:
        w[..., drop] = 0.0
    total = (w * torch.stack(ls, -1)).sum(dim=-1)
    return (w[..., None] * torch.stack(accs, -2)).sum(dim=-2) / total[..., None]


@pytest.mark.parametrize(("s", "pos", "softcap"), [(2208, 1234, 0.0), (2208, 2000, 30.0), (1003, 700, 50.0)])
def test_tolerance_separates_split_rounding_from_a_dropped_split(s: int, pos: int, softcap: float) -> None:
    """attention_tolerance holds the split kernel's rounding against the
    plain version, and is exceeded once a live split is dropped."""
    rng = np.random.default_rng(s + pos)
    b, g, r, hd = 1, 2, 5, 128
    q = torch.from_numpy(rng.standard_normal((b, g, r, 1, hd)).astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _cache(rng, b, g, hd, s))
    p = torch.tensor([pos], dtype=torch.int32)
    kw = dict(scale=hd**-0.5, softcap=softcap)
    want = da.gqa_attention_plain(q, k, v, p, **kw)
    limit = da.attention_tolerance(q, k, v, p, **kw)
    assert ((_split_rounding(q, k, v, p, **kw) - want).abs() <= limit).all()
    dropped = _split_rounding(q, k, v, p, **kw, drop=0)
    assert not ((dropped - want).abs() <= limit).all()
