"""The port's dense index (raglite_tpu_torch/index/dense.py) against the JAX
package's, on the CPU, on the same numpy inputs.

Integer (int8) paths agree exactly; f32 scores to 1e-5 relative.  The JAX
group-max packs ordinals into f32 (< 2^24 here, so exact); the port returns
them as int64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.documents import Chunk as JChunk
from raglite_tpu.index import dense as jd
from raglite_tpu.ops import fused_scan as jfs
from raglite_tpu.store import Store as JStore
from raglite_tpu_torch.documents import Chunk as TChunk
from raglite_tpu_torch.index import dense as td
from raglite_tpu_torch.parallel.sharded import sharded_int4_two_stage
from raglite_tpu_torch.store import Store as TStore

RTOL = 1e-5


def _unit(rng, n, d) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("num_results", [3, 12])
def test_group_max_topk_matches_jax(num_results: int) -> None:
    rng = np.random.default_rng(0)
    B, K, cap = 4, 10, 64
    scores = -np.sort(-rng.normal(size=(B, K)).astype(np.float32), axis=1)
    scores[1, 6:] = -np.inf  # invalid rows: empty slots
    row_ids = rng.integers(0, cap, size=(B, K)).astype(np.int32)
    row_chunk = np.repeat(np.arange(cap // 4), 4).astype(np.int32)  # 4 rows per chunk
    row_chunk[-4:] = -1  # padding
    packed = np.asarray(
        jd._group_max_topk(
            jnp.asarray(scores), jnp.asarray(row_ids), jnp.asarray(row_chunk), num_results=num_results
        )
    )
    ts, tc = td._group_max_topk(
        torch.from_numpy(scores), torch.from_numpy(row_ids), torch.from_numpy(row_chunk),
        num_results=num_results,
    )
    assert tc.dtype == torch.int64
    np.testing.assert_array_equal(ts.numpy(), packed[0])
    np.testing.assert_array_equal(tc.numpy(), packed[1].astype(np.int64))
    assert (tc.numpy()[np.isneginf(ts.numpy())] == -1).all()
    if num_results > 6:  # more results than row 1 has valid rows: empty slots
        assert (tc.numpy()[1] == -1).any()


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_int4_two_stage_chunks_matches_jax(metric: str, dtype: str) -> None:
    """JAX's two-stage program against the port's route for it: the int4
    scan and rescore of one shard (``sharded_int4_two_stage``), then the
    group-max."""
    rng = np.random.default_rng(1)
    Np, d, L, B = 2048, 64, 256, 3
    rows = _unit(rng, Np, d)
    valid = rng.random(Np) > 0.05
    valid[-100:] = False  # capacity padding
    row_chunk = (np.arange(Np) // 3).astype(np.int32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    adapter = (np.eye(d) + 0.01 * rng.normal(size=(d, d))).astype(np.float32)
    if dtype == "int8":
        rows_s, scale = jfs.quantize_rows_int8(rows)
        deq = rows_s.astype(np.float32) * scale[:, None]
    else:
        rows_s, scale, deq = rows, None, rows
    sq = (deq**2).sum(axis=1).astype(np.float32)
    jp, j4 = jfs.pack_rows_int4(jnp.asarray(rows_s), None if scale is None else jnp.asarray(scale))
    kw = dict(num_hits=20, num_results=8, candidates=64, metric=metric, num_buckets=L)
    jpacked = np.asarray(
        jd._int4_two_stage_chunks(
            jp, j4, jnp.asarray(rows_s), None if scale is None else jnp.asarray(scale),
            jnp.asarray(sq), jnp.asarray(valid), jnp.asarray(row_chunk), jnp.asarray(q),
            jnp.asarray(adapter), interpret=True, **kw,
        )
    )
    one = lambda x: None if x is None else [torch.from_numpy(np.array(x))]  # noqa: E731
    num_results = kw.pop("num_results")
    sc, ridx = sharded_int4_two_stage(
        one(jp), one(j4), one(rows_s), one(scale), one(sq), one(valid),
        torch.from_numpy(q) @ torch.from_numpy(adapter).T, devices=[torch.device("cpu")], **kw,
    )
    ts, tc = td._group_max_topk(sc, ridx, torch.from_numpy(row_chunk), num_results=num_results)
    np.testing.assert_allclose(ts.numpy(), jpacked[0], rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), jpacked[1].astype(np.int64))


def _stores(matrices, ids):
    js, ts = JStore(":memory:"), TStore(":memory:")
    for store, chunk_cls in ((js, JChunk), (ts, TChunk)):
        chunks = [
            chunk_cls(id=cid, document_id="doc", index=i, headings="", body=cid)
            for i, cid in enumerate(ids)
        ]
        store.add_chunks(chunks, matrices)
    return js, ts


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_dense_index_search_chunks_matches_jax(metric: str, dtype: str) -> None:
    """Sync, append and tombstones through both indexes; every step's
    search_chunks agrees."""
    rng = np.random.default_rng(2)
    d = 32
    counts = rng.integers(1, 5, size=60)
    matrices = [_unit(rng, int(c), d).astype(np.float16) for c in counts]
    ids = [f"c{i}" for i in range(len(matrices))]
    js, ts = _stores(matrices[:40], ids[:40])
    kw = dict(dim=d, dtype=dtype, metric=metric, use_pallas=False, use_int4_stage1=True)
    jidx = jd.DenseIndex(**kw)
    tidx = td.DenseIndex(**kw, device="cpu")
    q = rng.normal(size=(3, d)).astype(np.float32)

    def check() -> None:
        jidx.sync(js)
        tidx.sync(ts)
        jsc, jord = jidx.search_chunks(q, num_hits=24, num_results=6)
        tsc, tord = tidx.search_chunks(q, num_hits=24, num_results=6)
        if dtype == "int8" and metric != "l2":
            np.testing.assert_array_equal(tsc, jsc)
        else:
            np.testing.assert_allclose(tsc, jsc, rtol=RTOL, atol=1e-6)
        np.testing.assert_array_equal(tord, jord)
        assert tidx.last_route == "dense"

    check()
    # Append (within capacity: an in-place device write in the port).
    for store, chunk_cls in ((js, JChunk), (ts, TChunk)):
        store.add_chunks(
            [chunk_cls(id=cid, document_id="doc", index=40 + i, headings="", body=cid)
             for i, cid in enumerate(ids[40:])],
            matrices[40:],
        )
    check()
    # Tombstones: delete the current top hits of the first query.
    _, tord = tidx.search_chunks(q, num_hits=24, num_results=6)
    doomed = {tidx.chunk_ids[o] for o in tord[0][:2]}
    for store in (js, ts):
        store.deleted_chunks |= doomed
        store.version += 1
    check()
    _, tord = tidx.search_chunks(q, num_hits=24, num_results=6)
    assert not doomed & {tidx.chunk_ids[o] for o in tord[0] if o >= 0}


def test_dense_index_row_mask_and_empty_slots() -> None:
    rng = np.random.default_rng(3)
    d = 16
    matrices = [_unit(rng, 2, d).astype(np.float16) for _ in range(5)]
    _, ts = _stores(matrices, [f"c{i}" for i in range(5)])
    idx = td.DenseIndex(dim=d, dtype="float32", device="cpu")
    idx.sync(ts)
    mask = np.zeros(idx.num_rows, bool)
    mask[idx.row_chunk == 3] = True
    sc, ords = idx.search_chunks(rng.normal(size=(1, d)).astype(np.float32), num_hits=6,
                                 num_results=4, row_mask=mask)
    assert ords[0].tolist() == [3, -1, -1, -1]
    assert np.isfinite(sc[0, 0]) and np.isneginf(sc[0, 1:]).all()


def test_routes_need_cuda() -> None:
    """On the CPU neither kernel route is taken, whatever the size."""
    idx = td.DenseIndex(dim=256, dtype="int8", use_pallas=True, device="cpu")
    idx.num_rows = 200_000
    assert not idx._use_int4_stage1(1, exact=False)
    assert not idx._use_fused_kernel(1)
    idx.device = torch.device("cuda")
    assert idx._use_int4_stage1(1, exact=False) and idx._use_fused_kernel(1)
    assert not idx._use_int4_stage1(33, exact=False) and not idx._use_fused_kernel(33)
    assert not idx._use_int4_stage1(1, exact=True)
