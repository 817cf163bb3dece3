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


#: (REP, hd) beside the knobs: the first four cases keep their names; REP 9
#: and hd 256 are shapes the JAX function takes and the port's kernel now
#: takes too.
PREFILL_CASES = [
    *(pytest.param(softcap, window, 2, 16, id=f"{softcap}-{window}") for softcap, window in KNOBS),
    *(pytest.param(softcap, window, 9, 16, id=f"rep9-{softcap}-{window}") for softcap, window in KNOBS[::3]),
    *(pytest.param(softcap, window, 2, 256, id=f"hd256-{softcap}-{window}") for softcap, window in KNOBS[::3]),
]


@pytest.mark.parametrize(("softcap", "window", "r", "hd"), PREFILL_CASES)
def test_prefill_matches_jax_kernel(softcap: float, window: int, r: int, hd: int) -> None:
    rng = np.random.default_rng(5)
    b, g, t, s = 2, 2, 24, 50
    q = rng.standard_normal((b, g, r, t, hd)).astype(np.float32)
    k, v = _cache(rng, b, g, hd, s)
    off = np.array([0, 19], np.int32)  # prompt prefill, and a window at an offset
    got, want = _both(jax_prefill, pa.gqa_prefill_attention, (q, k, v, off), 0.25 * (16 / hd) ** 0.5, softcap, window)
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


def _f32_of_f64(fn, x):
    """An f32 function evaluated in f64 and rounded: the result of an element
    then does not depend on where it sits in the tensor (vectorised CPU loops
    may round a tail element otherwise)."""
    return fn(x.double()).float()


def _merge(ms, ls, accs, live, drop=None):
    """One level of the kernel's merge tree, in ascending entry order: the
    entries' (m, l, unnormalised context) with weights exp(m - M) over the
    live entries; returns the merged (M, L, context).  ``drop`` zeroes one
    entry's weight, a fault the tolerance must catch."""
    m = torch.stack([torch.where(lv, x, -torch.inf) for x, lv in zip(ms, live)], -1)
    big = m.amax(dim=-1)
    total, acc = torch.zeros_like(big), torch.zeros_like(accs[0])
    for j, (l, a) in enumerate(zip(ls, accs)):
        w = torch.where(live[j], _f32_of_f64(torch.exp, m[..., j] - big), 0.0)
        if j == drop:
            w = torch.zeros_like(w)
        total = total + w * l
        acc = acc + w[..., None] * torch.where(live[j][..., None], a, 0.0)
    return big, total, acc


def _split_rounding(q, k, v, pos, *, scale, softcap, window=0, split=128, chunk=8, drop=None, drop_chunk=None):
    """The CUDA decode/verify kernel's arithmetic on the CPU (bf16 caches):
    per 128-key split, f32 logits, bf16(exp(logit - m_split)) @ v and the f32
    sum of exp; the splits of a chunk of 8 merged in ascending order with
    weights exp(m_split - M_chunk), then the chunks likewise, then one
    division.  A row skips the splits and chunks none of whose keys it can
    see.  Products are taken in f64 and rounded to f32 (the tensor cores'
    f32 accumulation, up to summation order).  q: [B, G, R, T, hd]."""
    t, s = q.shape[3], k.shape[3]
    qf, kf, vf = (x.to(torch.bfloat16).double() for x in (q, k, v))
    logits = torch.einsum("bgrtd,bgds->bgrts", qf, kf).float() * scale
    if softcap:
        logits = softcap * _f32_of_f64(torch.tanh, logits / softcap)
    key = torch.arange(s)
    p = (pos.to(torch.int64)[:, None] + torch.arange(t))[:, None, None, :, None]  # [B, 1, 1, T, 1]
    ok = key <= p
    lo = torch.zeros_like(p)
    if window:
        ok = ok & (key > p - window)
        lo = (p - window + 1).clamp(min=0)
    hi = p.clamp(max=s - 1)
    logits = torch.where(ok, logits, -1e9)

    def live(k0, k1):  # [B, 1, 1, T] -> broadcast over groups and heads
        return ((lo > hi) | ((k0 <= hi) & (k1 >= lo)))[..., 0].expand(logits.shape[:-1])

    parts = []
    for s0 in range(0, s, split):
        x = logits[..., s0 : s0 + split]
        m = x.amax(dim=-1)
        e = _f32_of_f64(torch.exp, x - m[..., None])
        acc = torch.einsum("bgrts,bgds->bgrtd", e.to(torch.bfloat16).double(), vf[..., s0 : s0 + split]).float()
        parts.append((m, e.double().sum(dim=-1).float(), acc, live(s0, min(s0 + split, s) - 1)))
    chunks = []
    for c0 in range(0, len(parts), chunk):
        group = parts[c0 : c0 + chunk]
        ms, ls, accs, lives = zip(*group)
        inner = drop - c0 if drop is not None and c0 <= drop < c0 + chunk else None
        k0, k1 = c0 * split, min((c0 + len(group)) * split, s) - 1
        chunks.append((*_merge(ms, ls, accs, lives, inner), live(k0, k1)))
    ms, ls, accs, lives = zip(*chunks)
    _, total, acc = _merge(ms, ls, accs, lives, drop_chunk)
    return acc / total[..., None]


@pytest.mark.parametrize(("s", "pos", "softcap"), [(2208, 1234, 0.0), (2208, 2000, 30.0), (1003, 700, 50.0)])
@pytest.mark.parametrize("fault", ["split", "chunk"])
def test_tolerance_separates_split_rounding_from_a_dropped_split(s: int, pos: int, softcap: float, fault: str) -> None:
    """attention_tolerance holds the split kernel's rounding and two-level
    merge against the plain version, and is exceeded once a live split, or a
    live chunk's partial, is dropped."""
    rng = np.random.default_rng(s + pos)
    b, g, r, hd = 1, 2, 5, 128
    q = torch.from_numpy(rng.standard_normal((b, g, r, 1, hd)).astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _cache(rng, b, g, hd, s))
    p = torch.tensor([pos], dtype=torch.int32)
    kw = dict(scale=hd**-0.5, softcap=softcap)
    want = da.gqa_attention_plain(q, k, v, p, **kw)
    limit = da.attention_tolerance(q, k, v, p, **kw)
    assert ((_split_rounding(q, k, v, p, **kw) - want).abs() <= limit).all()
    dropped = _split_rounding(q, k, v, p, **kw, **({"drop": 0} if fault == "split" else {"drop_chunk": 0}))
    assert not ((dropped - want).abs() <= limit).all()


@pytest.mark.parametrize(("softcap", "window"), [(0.0, 0), (50.0, 0), (0.0, 300), (30.0, 40)])
@pytest.mark.parametrize(("s", "pos0"), [(1100, 1000), (1100, 0), (300, 292)])
def test_emulated_verify_window_equals_decode_steps(softcap: float, window: int, s: int, pos0: int) -> None:
    """The property the kernel's design must keep: a T = 8 window computed
    together equals eight T = 1 calls at pos0 + t exactly, because split and
    chunk boundaries depend on S only and a row's mask, max, sum and merge
    weights on its own position only.  It also stays within the tolerance of
    the plain version, windows and rows near position 0 included."""
    rng = np.random.default_rng(s + pos0 + window)
    b, g, r, t, hd = 2, 2, 3, 8, 32
    q = torch.from_numpy(rng.standard_normal((b, g, r, t, hd)).astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _cache(rng, b, g, hd, s))
    p = torch.tensor([pos0, max(pos0 - 5, 0)], dtype=torch.int32)
    kw = dict(scale=hd**-0.5, softcap=softcap, window=window)
    got = _split_rounding(q, k, v, p, **kw)
    for i in range(t):
        one = _split_rounding(q[:, :, :, i : i + 1], k, v, p + i, **kw)
        assert torch.equal(got[:, :, :, i : i + 1], one), i
    want = da.gqa_attention_plain(q, k, v, p, **kw)
    assert ((got - want).abs() <= da.attention_tolerance(q, k, v, p, **kw)).all()


def test_outgrown_scratch_stays_alive(monkeypatch: pytest.MonkeyPatch) -> None:
    """A call that needs more scratch gets a larger pair, and the pair it
    outgrew is kept (a CUDA graph captured earlier holds its addresses); a
    smaller call reuses the larger pair, and another stream has its own."""

    class _Stream:
        def __init__(self, handle: int) -> None:
            self.cuda_stream = handle

    cpu = torch.device("cpu")
    monkeypatch.setattr(da, "_scratch", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream(7))
    small = da._scratch_for(cpu, 10, 2)
    addresses = (small[0].data_ptr(), small[1].data_ptr())
    large = da._scratch_for(cpu, 100, 1)
    assert large[0].numel() == 100 and large[1].numel() == 2 and not large[1].any()
    assert da._scratch_for(cpu, 10, 2) is large
    (kept, current), = da._scratch.values()
    assert (kept[0].data_ptr(), kept[1].data_ptr()) == addresses and current is large
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream(8))
    assert da._scratch_for(cpu, 10, 2) is not large and len(da._scratch) == 2


LOG2E = 1.4426950408889634
ROWS = 128  # packed rows a block of the prefill kernel owns


def _tile_rounding(q, k, v, off, *, scale, softcap=0.0, window=0, bk=128, drop_tile=None):
    """The CUDA prefill kernel's arithmetic on the CPU (bf16 caches), block by
    block.  A block owns 128 packed rows of one (b, g): row r is head r % HC
    of position tq0 + r // HC (HC = min(REP, 128) heads, P = 128 // HC
    positions; the other rows are zero queries and are not written).  It walks
    the key tiles of ``bk`` keys that some row of it can see (every tile if a
    row has no valid key), keys past S zero-filled and masked to -inf; on a
    tile no row's causal limit, window edge or the end of S crosses, the mask
    is skipped and the scale folded into the exponent (exp2(fma(x, scale *
    log2 e, -m))); probabilities are rounded to bf16 unnormalised against the
    running max, and sums and context rescaled by exp2(m_old - m_new) tile by
    tile.  Products are taken in f64 and rounded to f32.  ``drop_tile`` leaves
    out the block's tile of that index, a fault the tolerance must catch."""
    b_, g_, rep, t, hd = q.shape
    s = k.shape[3]
    hc = min(rep, ROWS)
    npos, nhc = ROWS // hc, -(-rep // hc)
    qf, kf, vf = (x.to(torch.bfloat16).double() for x in (q, k, v))
    pad = -(-s // bk) * bk - s
    kf, vf = (torch.nn.functional.pad(x, (0, pad)) for x in (kf, vf))  # zero-filled past S
    sl2 = float(np.float32(scale) * np.float32(LOG2E))
    masked = float(np.float32(-1e9) * np.float32(LOG2E))
    out = torch.full((b_, g_, rep, t, hd), float("nan"))
    r = torch.arange(ROWS)
    for b in range(b_):
        o = int(off[b])
        for qt in reversed(range(-(-t // npos))):  # heaviest query tiles first, as the grid runs
            for hci in range(nhc):
                tq0 = qt * npos
                head, pl = hci * hc + r % hc, r // hc
                valid = (pl < npos) & (head < rep) & (tq0 + pl < t)
                pos = o + tq0 + pl  # the mask needs each row's position only
                pos_min, pos_max = o + tq0, o + min(tq0 + npos, t) - 1
                every = o < 0 or (window > 0 and pos_max - window + 1 > s - 1)
                hi_key = s - 1 if every else min(pos_max, s - 1)
                lo_key = 0 if every or window <= 0 else max(0, pos_min - window + 1)
                first = lo_key // bk * bk
                ntiles = (hi_key - first) // bk + 1 if hi_key >= first else 0
                qrows = torch.zeros((g_, ROWS, hd), dtype=torch.float64)
                qrows[:, valid] = qf[b][:, head[valid], tq0 + pl[valid]]
                m = torch.full((g_, ROWS), -torch.inf)
                l = torch.zeros((g_, ROWS))
                acc = torch.zeros((g_, ROWS, hd))
                for j in range(ntiles):
                    kt0 = first + j * bk
                    if j == drop_tile:
                        continue
                    x = torch.einsum("grd,gds->grs", qrows, kf[b][:, :, kt0 : kt0 + bk]).float()
                    crossing = every or kt0 + bk - 1 > pos_min or kt0 + bk > s or (window > 0 and kt0 <= pos_max - window)
                    folded = not crossing and not softcap and sl2 > 0
                    if folded:
                        mx = x.amax(dim=-1) * sl2
                    else:
                        x = (softcap * LOG2E) * _f32_of_f64(torch.tanh, x * (scale / softcap)) if softcap else x * sl2
                        if crossing:
                            key = kt0 + torch.arange(bk)
                            ok = key[None, :] <= pos[:, None]
                            if window > 0:
                                ok &= key[None, :] > pos[:, None] - window
                            x = torch.where(ok, x, masked)
                            x = torch.where(key < s, x, -torch.inf)
                        mx = x.amax(dim=-1)
                    m_new = torch.maximum(m, mx)
                    corr = _f32_of_f64(torch.exp2, m - m_new)
                    if folded:
                        e = torch.exp2((x.double() * sl2 - m_new[..., None].double()).float().double()).float()
                    else:
                        e = _f32_of_f64(torch.exp2, x - m_new[..., None])
                    l = l * corr + e.double().sum(dim=-1).float()
                    pv = torch.einsum("grs,gds->grd", e.to(torch.bfloat16).double(), vf[b][:, :, kt0 : kt0 + bk]).float()
                    acc = acc * corr[..., None] + pv
                    m = m_new
                ctx = acc * (1.0 / l)[..., None]
                out[b][:, head[valid], tq0 + pl[valid]] = ctx[:, valid]
    assert not out.isnan().any(), "a row was left unwritten"
    return out


def _prefill_case(rng, rep, t, hd, offsets, s):
    b, g = len(offsets), 2
    q = torch.from_numpy(rng.standard_normal((b, g, rep, t, hd)).astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _cache(rng, b, g, hd, s))
    return q, k, v, torch.tensor(offsets, dtype=torch.int32)


@pytest.mark.parametrize(("softcap", "window"), [(0.0, 0), (50.0, 0), (0.0, 150), (30.0, 40)])
@pytest.mark.parametrize("t", [24, 64, 200])
@pytest.mark.parametrize("rep", [1, 4, 5, 9])
def test_emulated_prefill_tiles_within_tolerance(rep: int, t: int, softcap: float, window: int) -> None:
    """The prefill kernel's order of operations (packed rows, 128-key tiles,
    folded exp2, unnormalised bf16 probabilities, online rescaling, masks on
    crossing tiles only, skipped tiles, zero-filled keys past S) stays within
    attention_tolerance of the plain version, per output: offsets 0 and
    per-row, T below, at and above a tile's positions, S no multiple of a tile."""
    rng = np.random.default_rng(1000 * rep + t + window)
    q, k, v, off = _prefill_case(rng, rep, t, 32, [0, 301], 301 + t + 9)
    kw = dict(scale=32**-0.5, softcap=softcap, window=window)
    got = _tile_rounding(q, k, v, off, **kw)
    want = da.gqa_attention_plain(q, k, v, off, **kw)
    assert ((got - want).abs() <= da.attention_tolerance(q, k, v, off, **kw)).all()


@pytest.mark.parametrize(("softcap", "window"), [(0.0, 0), (30.0, 100)])
@pytest.mark.parametrize(("rep", "t"), [(2, 64), (9, 24)])
def test_emulated_prefill_wide_heads_take_64_key_tiles(rep: int, t: int, softcap: float, window: int) -> None:
    """hd = 256 walks 64-key tiles (two stages of them fit shared memory)."""
    rng = np.random.default_rng(rep + t)
    q, k, v, off = _prefill_case(rng, rep, t, 256, [130, 0], 130 + t + 3)
    kw = dict(scale=256**-0.5, softcap=softcap, window=window)
    got = _tile_rounding(q, k, v, off, bk=64, **kw)
    want = da.gqa_attention_plain(q, k, v, off, **kw)
    assert ((got - want).abs() <= da.attention_tolerance(q, k, v, off, **kw)).all()


@pytest.mark.parametrize(("softcap", "window"), [(0.0, 0), (30.0, 20)])
def test_emulated_prefill_splits_more_than_128_heads_over_tiles(softcap: float, window: int) -> None:
    """REP = 130: a tile holds 128 heads of one position, a second head chunk
    the other two (126 rows of it unused)."""
    rng = np.random.default_rng(130 + window)
    q, k, v, off = _prefill_case(rng, 130, 24, 16, [0, 70], 70 + 24 + 5)
    kw = dict(scale=0.25, softcap=softcap, window=window)
    got = _tile_rounding(q, k, v, off, **kw)
    want = da.gqa_attention_plain(q, k, v, off, **kw)
    assert ((got - want).abs() <= da.attention_tolerance(q, k, v, off, **kw)).all()


@pytest.mark.parametrize("window", [0, 50])
@pytest.mark.parametrize(("offsets", "s"), [([-5, 40], 120), ([-70, 123], 187), ([150, 10], 160)])
def test_emulated_prefill_rows_without_a_valid_key(offsets: list[int], s: int, window: int) -> None:
    """Rows at negative positions, or (with a window) past S + w - 1, have no
    valid key and get the uniform softmax over every key, as in the plain
    version: their block walks every tile and masks each, beside a batch row
    whose blocks skip tiles."""
    rng = np.random.default_rng(s + window)
    q, k, v, off = _prefill_case(rng, 5, 64, 32, offsets, s)
    kw = dict(scale=32**-0.5, window=window)
    got = _tile_rounding(q, k, v, off, **kw)
    want = da.gqa_attention_plain(q, k, v, off, **kw)
    assert ((got - want).abs() <= da.attention_tolerance(q, k, v, off, **kw)).all()
    if offsets[0] < 0:  # the rows before position 0: the mean of v over all S keys
        rows = got[0, :, :, : -offsets[0]]
        mean = v[0].float().mean(dim=-1)[:, None, None, :].expand_as(rows)
        assert ((rows - mean).abs() <= 2.0**-7 * v[0].float().abs().mean(dim=-1)[:, None, None, :] + 1e-5).all()


@pytest.mark.parametrize(("rep", "bk", "hd"), [(5, 128, 32), (1, 128, 32), (9, 64, 256)])
@pytest.mark.parametrize("drop_tile", [0, 2])
def test_tolerance_separates_tile_rounding_from_a_dropped_tile(rep: int, bk: int, hd: int, drop_tile: int) -> None:
    """attention_tolerance still tells the tile kernel's rounding from a key
    tile left out of every block that walks at least that many."""
    rng = np.random.default_rng(rep + bk + drop_tile)
    t = 100
    q, k, v, off = _prefill_case(rng, rep, t, hd, [3 * bk, 4 * bk + 17], 5 * bk + t + 20)
    kw = dict(scale=hd**-0.5)
    want = da.gqa_attention_plain(q, k, v, off, **kw)
    limit = da.attention_tolerance(q, k, v, off, **kw)
    assert ((_tile_rounding(q, k, v, off, bk=bk, **kw) - want).abs() <= limit).all()
    dropped = _tile_rounding(q, k, v, off, bk=bk, drop_tile=drop_tile, **kw)
    assert not ((dropped - want).abs() <= limit).all()
