"""The port's scans (raglite_tpu_torch/ops/fused_scan.py) against the JAX
package's Pallas scans run in interpret mode, on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py.  Integer paths must agree exactly; f32 and bf16 paths to
1e-5 relative (summation order), with ids compared wherever a bucket's
best score leads its runner-up by more than that.  One exception: XLA on
the CPU contracts the scan's ``sims * rscale + bias`` into a fused
multiply-add, while the port (kernel and plain version alike) rounds the
product and the sum separately; with a nonzero bias (l2) integer scores
may then differ by one unit in the last place, and are compared so.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.ops import fused_scan as jfs
from raglite_tpu_torch.ops import fused_scan as tfs

RTOL = 1e-5
TORCH_DTYPE = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}
JAX_DTYPE = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}


def _rows(rng, n, d, *, dup: bool = True) -> np.ndarray:
    rows = rng.normal(size=(n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    if dup:  # rows equal to rows of other steps of the same bucket: ties
        rows[n // 2 : n // 2 + 8] = rows[:8]
    return rows


def _t(x: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _j(x: np.ndarray, dtype=None):
    return jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype=dtype)


def _separated(sims: np.ndarray, num_buckets: int, tol: float) -> np.ndarray:
    """[B, L] mask of buckets whose best score leads the runner-up by > tol."""
    b, n = sims.shape
    folded = np.sort(sims.reshape(b, n // num_buckets, num_buckets), axis=1)
    return (folded[:, -1] - folded[:, -2]) > tol * np.maximum(np.abs(folded[:, -1]), 1.0)


def test_quantize_rows_int8_matches_jax() -> None:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 48)).astype(np.float32)
    x[3] = 0.0  # zero row keeps scale 1
    jq, js = jfs.quantize_rows_int8(x)
    tq, ts = tfs.quantize_rows_int8(_t(x))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("source", ["int8", "float32", "int8_no_scale"])
def test_pack_rows_int4_matches_jax(source: str) -> None:
    rng = np.random.default_rng(1)
    x = _rows(rng, 64, 32, dup=False)
    if source.startswith("int8"):
        q, scale = jfs.quantize_rows_int8(x)
        js_arg = None if source == "int8_no_scale" else scale
        jp, j4 = jfs.pack_rows_int4(_j(q), None if js_arg is None else _j(js_arg))
        tp, t4 = tfs.pack_rows_int4(_t(q), None if js_arg is None else _t(js_arg))
    else:
        jp, j4 = jfs.pack_rows_int4(_j(x))
        tp, t4 = tfs.pack_rows_int4(_t(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(t4.numpy(), np.asarray(j4))
    np.testing.assert_array_equal(
        tfs.unpack_rows_int4(tp).numpy(), jfs.unpack_rows_int4(np.asarray(jp))
    )


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_bucketed_max_scan_matches_jax(dtype: str) -> None:
    rng = np.random.default_rng(2)
    B, N, d, L = 5, 1024, 64, 256
    rows = _rows(rng, N, d)
    bias = np.zeros(N, np.float32)
    bias[rng.choice(N, 40, replace=False)] = -1e30  # invalid rows
    bias[-L:] = -1e30  # a whole step of padding
    q = rng.normal(size=(B, d)).astype(np.float32)
    if dtype == "int8":
        rows_s, scale = jfs.quantize_rows_int8(rows)
        q_s = np.clip(np.rint(q / (np.abs(q).max() / 127.0)), -127, 127).astype(np.int8)
        args_j = (_j(q_s), _j(rows_s), _j(bias), _j(scale))
        args_t = (_t(q_s), _t(rows_s), _t(bias), _t(scale))
    else:
        scale = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
        args_j = (_j(q), _j(rows, JAX_DTYPE[dtype]), _j(bias), _j(scale))
        args_t = (_t(q), _t(rows, TORCH_DTYPE[dtype]), _t(bias), _t(scale))
    js, ji = jfs.bucketed_max_scan(*args_j, num_buckets=L, batch_tile=8, interpret=True)
    ts, ti = tfs.bucketed_max_scan(*args_t, num_buckets=L)
    js, ji = np.asarray(js), np.asarray(ji)
    assert ti.dtype == torch.int32 and ts.dtype == torch.float32
    if dtype == "int8":
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(ti.numpy(), ji)
        # Ties: the duplicated rows' bucket keeps the lower row.
        assert (ti.numpy()[:, :8] < N // 2).all()
    else:
        np.testing.assert_allclose(ts.numpy(), js, rtol=RTOL)
        r32 = rows if dtype == "float32" else np.asarray(_j(rows, jnp.bfloat16), np.float32)
        q32 = q if dtype == "float32" else np.asarray(_j(q, jnp.bfloat16), np.float32)
        sims = (q32 @ r32.T) * scale[None] + bias[None]
        sep = _separated(sims, L, RTOL)
        np.testing.assert_array_equal(ti.numpy()[sep], ji[sep])


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_plain_scans_match_numpy_oracle(kind: str) -> None:
    """The plain versions equal the JAX package's numpy bucket oracle
    ``reference_bucketed_max`` (integer dots: exact in f32) bit for bit,
    ties and invalid rows included."""
    rng = np.random.default_rng(7)
    B, N, d, L = 4, 2048, 96, 256
    rows = _rows(rng, N, d)
    bias = np.where(rng.random(N) < 0.05, np.float32(-1e30), np.float32(0.0))
    q = np.clip(rng.normal(scale=40, size=(B, d)).round(), -127, 127).astype(np.int8)
    if kind == "int8":
        rows_i, scale = jfs.quantize_rows_int8(rows)
        ts, ti = tfs.bucketed_max_scan_plain(_t(q), _t(rows_i), _t(bias), _t(scale), num_buckets=L)
    else:
        packed, scale = tfs.pack_rows_int4(_t(rows))
        rows_i, scale = tfs.unpack_rows_int4(packed).numpy(), scale.numpy()
        ts, ti = tfs.int4_bucket_scan_plain(_t(q), packed, _t(scale), _t(bias), num_buckets=L)
    ws, wi = jfs.reference_bucketed_max(q, rows_i, bias, num_buckets=L, row_scale=scale)
    np.testing.assert_array_equal(ts.numpy(), ws)
    np.testing.assert_array_equal(ti.numpy(), wi)


def test_int4_bucket_scan_matches_jax() -> None:
    rng = np.random.default_rng(3)
    B, N, d, L = 6, 2048, 64, 512
    rows = _rows(rng, N, d)
    packed, scale4 = jfs.pack_rows_int4(_j(rows))
    packed = np.asarray(packed)
    rscale = np.asarray(scale4) * np.float32(0.01)
    bias = np.where(rng.random(N) < 0.05, np.float32(-1e30), np.float32(0.0))
    q = np.clip(rng.normal(scale=40, size=(B, d)).round(), -127, 127).astype(np.int8)
    js, ji = jfs.int4_bucket_scan(
        _j(q), _j(packed), _j(rscale), _j(bias), num_buckets=L, batch_tile=8, interpret=True
    )
    ts, ti = tfs.int4_bucket_scan(_t(q), _t(packed), _t(rscale), _t(bias), num_buckets=L)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_fused_scan_topk_matches_jax(metric: str, dtype: str) -> None:
    rng = np.random.default_rng(4)
    B, N, d, L, k = 4, 1000, 64, 256, 12  # N not a bucket multiple: padding
    rows = _rows(rng, N, d)
    valid = rng.random(N) > 0.1
    q = rng.normal(size=(B, d)).astype(np.float32)
    if dtype == "int8":
        rows_s, scale = jfs.quantize_rows_int8(rows)
        deq = rows_s.astype(np.float32) * scale[:, None]
        j_rows, t_rows, j_scale, t_scale = _j(rows_s), _t(rows_s), _j(scale), _t(scale)
    else:
        deq = rows
        j_rows, t_rows = _j(rows, JAX_DTYPE[dtype]), _t(rows, TORCH_DTYPE[dtype])
        j_scale = t_scale = None
    sq = (deq**2).sum(axis=1).astype(np.float32)
    js, ji = jfs.fused_scan_topk(
        j_rows, _j(sq), _j(valid), _j(q), num_hits=k, metric=metric,
        row_scale=j_scale, num_buckets=L, interpret=True,
    )
    ts, ti = tfs.fused_scan_topk(
        t_rows, _t(sq), _t(valid), _t(q), num_hits=k, metric=metric,
        row_scale=t_scale, num_buckets=L,
    )
    js, ji = np.asarray(js), np.asarray(ji)
    if dtype == "int8":
        if metric == "l2":  # XLA's fused multiply-add (module docstring)
            np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=1)
        else:
            np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(ti.numpy(), ji)
    else:
        np.testing.assert_allclose(ts.numpy(), js, rtol=RTOL)
        gaps = np.abs(np.diff(js, axis=1)) > RTOL * np.abs(js[:, 1:])
        sep = np.concatenate([gaps[:, :1], gaps[:, :-1] & gaps[:, 1:], gaps[:, -1:]], axis=1)
        np.testing.assert_array_equal(ti.numpy()[sep], ji[sep])


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_int4_two_stage_block_matches_jax(metric: str, dtype: str) -> None:
    rng = np.random.default_rng(5)
    N, Np, d, L, B, k, C = 900, 1024, 64, 256, 3, 10, 64
    rows = _rows(rng, N, d)
    valid = rng.random(N) > 0.1
    q = rng.normal(size=(B, d)).astype(np.float32)
    if dtype == "int8":
        rows_s, scale = jfs.quantize_rows_int8(rows)
        deq = rows_s.astype(np.float32) * scale[:, None]
        j_rows, t_rows, j_scale, t_scale = _j(rows_s), _t(rows_s), _j(scale), _t(scale)
    else:
        deq = rows
        j_rows, t_rows = _j(rows, JAX_DTYPE[dtype]), _t(rows, TORCH_DTYPE[dtype])
        j_scale = t_scale = None
    sq = (deq**2).sum(axis=1).astype(np.float32)
    packed, scale4 = jfs.pack_rows_int4(j_rows, j_scale)
    packed = np.pad(np.asarray(packed), ((0, Np - N), (0, 0)))
    scale4 = np.pad(np.asarray(scale4), (0, Np - N), constant_values=1.0)
    kw = dict(num_hits=k, candidates=C, metric=metric, num_buckets=L)
    js, ji = jfs.int4_two_stage_block(
        _j(packed), _j(scale4), j_rows, j_scale, _j(sq), _j(valid), _j(q), interpret=True, **kw
    )
    ts, ti = tfs.int4_two_stage_block(
        _t(packed), _t(scale4), t_rows, t_scale, _t(sq), _t(valid), _t(q), **kw
    )
    js, ji = np.asarray(js), np.asarray(ji)
    assert np.isfinite(ts.numpy()).all() and (ti.numpy() < N).all()
    if dtype == "int8":
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(ti.numpy(), ji)
    else:
        np.testing.assert_allclose(ts.numpy(), js, rtol=RTOL, atol=1e-6)
        np.testing.assert_array_equal(ti.numpy(), ji)


def test_two_stage_masks_everything_but_few_rows() -> None:
    """Fewer alive rows than hits: the empty slots come back as -inf."""
    rng = np.random.default_rng(6)
    N, d, L = 512, 32, 256
    rows = _rows(rng, N, d, dup=False)
    valid = np.zeros(N, bool)
    valid[[3, 300]] = True
    packed, scale4 = tfs.pack_rows_int4(_t(rows))
    sc, ids = tfs.int4_two_stage_block(
        packed, scale4, _t(rows), None, torch.zeros(N), _t(valid),
        _t(rng.normal(size=(2, d)).astype(np.float32)),
        num_hits=5, candidates=16, metric="cosine", num_buckets=L,
    )
    assert torch.isfinite(sc).sum(dim=1).tolist() == [2, 2]
    assert set(ids[0, :2].tolist()) == {3, 300}
    assert torch.isneginf(sc[:, 2:]).all()


def test_kernel_wrappers_refuse_other_devices() -> None:
    """A non-CPU tensor never takes the plain version: the meta device
    (standing in for a device with no kernel) raises."""
    rows = torch.zeros((256, 32), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tfs.bucketed_max_scan(
            rows[:1], rows, torch.zeros(256, device="meta"), num_buckets=256
        )
