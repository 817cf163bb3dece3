"""The port's row-sharded index, sharded searches and sharded BM25
(raglite_tpu_torch/parallel/, index/dense.py and index/keyword.py at
``num_devices > 1``) against the JAX package's, one counterpart per test of
tests/test_parallel.py.

JAX runs on the virtual 8-device CPU mesh of tests/conftest.py (the int4
Pallas scan in interpret mode); the port on 8 logical shards of the one CPU
device, its kernels taking their plain versions.  Tolerances: the sharded
exact search equals the single-device port and JAX's ``sharded_topk_search``
with ids equal and scores within rtol 1e-5 (f32 sums of the same products;
for l2, of the |r|^2 term the score is a difference with);
``sharded_int4_two_stage`` equals JAX's with ids equal and rtol 1e-5, and
returns no masked row; sharded BM25 equals both exactly (the same f32
weights summed in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.index import dense as jd
from raglite_tpu.index.keyword import KeywordIndex as JKeywordIndex
from raglite_tpu.parallel import mesh as jmesh
from raglite_tpu_torch.index import dense as td
from raglite_tpu_torch.index.keyword import KeywordIndex as TKeywordIndex
from raglite_tpu_torch.parallel import mesh as tmesh
from raglite_tpu_torch.parallel import sharded as tsh

RTOL = 1e-5
CPU8 = [torch.device("cpu")] * 8


def test_virtual_devices_present() -> None:
    """Eight shards on the one CPU (the JAX tests' eight virtual devices),
    a shard list of each size, and no CUDA device where there is none."""
    assert len(jax.devices()) == 8
    assert tmesh.index_devices(8, "cpu") == CPU8
    assert tmesh.index_devices(0, "cpu") == [torch.device("cpu")]
    assert tmesh.tp_devices(2, "cpu") == CPU8[:2]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.index_devices(4, "cuda")


def _pair(num_devices: int, **kw):
    return (
        jd.DenseIndex(num_devices=num_devices, **kw),
        td.DenseIndex(num_devices=num_devices, device="cpu", **kw),
    )


def test_sharded_search_matches_single_device() -> None:
    """Per-shard top-k and the merge are exact: the 8-shard search equals
    the single-device search and JAX's 8-device one.  40,000 rows fill 5
    of the 8 shards of the 65,536-row capacity; an index over device arrays
    fills all 8."""
    rng = np.random.default_rng(0)
    n, d = 40_000, 64
    matrices = list(rng.normal(size=(n, 1, d)).astype(np.float16))
    ids = [f"c{i}" for i in range(n)]
    queries = rng.normal(size=(3, d)).astype(np.float32)
    _, single = _pair(1, dim=d, metric="dot")
    j8, t8 = _pair(8, dim=d, metric="dot")
    for index in (single, j8, t8):
        index.append_chunks(matrices, ids)
    assert t8.num_devices == 8 and len(t8.devices) == 8 and t8.capacity % (8 * 4096) == 0
    s1, i1 = single.search(queries, num_hits=10)
    sj, ij = j8.search(queries, num_hits=10)
    s8, i8 = t8.search(queries, num_hits=10)
    assert t8._rows is not None and len(t8._rows) == 8 and t8._rows[0].shape[0] == t8.capacity // 8
    assert len(set(i8.ravel() // t8.shard_rows)) > 1  # the winners come from several shards
    np.testing.assert_array_equal(i8, i1)
    np.testing.assert_array_equal(i8, ij)
    np.testing.assert_allclose(s8, s1, rtol=RTOL)
    np.testing.assert_allclose(s8, sj, rtol=RTOL)
    rows = torch.from_numpy(np.concatenate(matrices[:2048])).to(torch.bfloat16)
    whole = td.DenseIndex.from_device_arrays(rows, torch.arange(2048))
    split = td.DenseIndex.from_device_arrays(rows, torch.arange(2048), num_devices=8)
    assert [r.shape[0] for r in split._rows] == [256] * 8
    np.testing.assert_array_equal(split.search(queries, num_hits=10)[1], whole.search(queries, num_hits=10)[1])


def test_sharded_search_l2_and_mask() -> None:
    rng = np.random.default_rng(1)
    n, d = 40_000, 32
    matrices = list(rng.normal(size=(n // 2, 2, d)).astype(np.float16))
    ids = [f"c{i}" for i in range(n // 2)]
    queries = rng.normal(size=(2, d)).astype(np.float32)
    mask = rng.random(n) > 0.5
    _, single = _pair(1, dim=d, metric="l2")
    j8, t8 = _pair(8, dim=d, metric="l2")
    for index in (single, j8, t8):
        index.append_chunks(matrices, ids)
    s1, i1 = single.search(queries, num_hits=7, row_mask=mask)
    sj, ij = j8.search(queries, num_hits=7, row_mask=mask)
    s8, i8 = t8.search(queries, num_hits=7, row_mask=mask)
    assert mask[i8].all()
    np.testing.assert_array_equal(i8, i1)
    np.testing.assert_array_equal(i8, ij)
    # An l2 score is 2 q.r - |r|^2 with |r|^2 ~ d: f32 sums over blocks of
    # another size round at that magnitude, so rtol applies to it.
    atol = RTOL * float(np.square(np.concatenate(matrices).astype(np.float32)).sum(axis=1).max())
    np.testing.assert_allclose(s8, s1, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(s8, sj, rtol=RTOL, atol=atol)
    # The chunk route (group-max after the merge, on the first device).
    c1 = single.search_chunks(queries, num_hits=16, num_results=5, row_mask=mask)
    c8 = t8.search_chunks(queries, num_hits=16, num_results=5, row_mask=mask)
    np.testing.assert_array_equal(c8[1], c1[1])
    np.testing.assert_allclose(c8[0], c1[0], rtol=RTOL, atol=atol)


def test_end_to_end_sharded_config(tmp_path) -> None:
    """The full search stack with a sharded index config, as the JAX
    package's: the same chunks and scores from ``vector_search``."""
    from raglite_tpu import Document as JDocument
    from raglite_tpu import RAGLiteConfig as JConfig
    from raglite_tpu import insert_documents as jinsert
    from raglite_tpu import vector_search as jsearch
    from raglite_tpu_torch import Document, RAGLiteConfig, insert_documents, vector_search
    from raglite_tpu_torch.index.dense import dense_index_from_config

    text = "Katydids sing at night. They are relatives of crickets. "
    question = "which insects sing at night?"
    jcfg = JConfig(store_path=str(tmp_path / "jax"), embedder="hash:256", num_devices=8)
    jinsert([JDocument.from_text(text, filename="k.md")], config=jcfg)
    config = RAGLiteConfig(store_path=str(tmp_path / "torch"), embedder="hash:256", num_devices=8, device="cpu")
    insert_documents([Document.from_text(text, filename="k.md")], config=config)
    ids, scores = vector_search(question, num_results=3, config=config)
    jids, jscores = jsearch(question, num_results=3, config=jcfg)
    assert ids and scores
    assert dense_index_from_config(config).num_devices == 8
    assert len(ids) == len(jids)
    np.testing.assert_allclose(scores, jscores, rtol=RTOL)


def test_dense_index_save_load_roundtrip(tmp_path) -> None:
    """A 4-shard index saves its shard count; ``load`` honours it (and an
    override), and every reload, the JAX package's included, searches the
    same."""
    rng = np.random.default_rng(11)
    index = td.DenseIndex(dim=32, dtype="int8", metric="cosine", num_devices=4, device="cpu")
    mats = [rng.normal(size=(2, 32)).astype(np.float32) for _ in range(20)]
    index.append_chunks(mats, [f"c{i}" for i in range(20)])
    q = rng.normal(size=(2, 32)).astype(np.float32)
    scores_a, rows_a = index.search(q, num_hits=5)

    index.save(str(tmp_path / "idx"))
    restored = td.DenseIndex.load(str(tmp_path / "idx"), device="cpu")
    one = td.DenseIndex.load(str(tmp_path / "idx"), num_devices=1, device="cpu")
    jax_restored = jd.DenseIndex.load(str(tmp_path / "idx"))
    assert restored.num_devices == jax_restored.num_devices == 4 and one.num_devices == 1
    assert restored.chunk_ids == index.chunk_ids
    assert restored.num_rows == index.num_rows
    for other in (restored, one, jax_restored):
        scores_b, rows_b = other.search(q, num_hits=5)
        np.testing.assert_array_equal(rows_a, rows_b)
        np.testing.assert_allclose(scores_a, scores_b, rtol=RTOL)


def test_distributed_init_is_safe_locally(monkeypatch) -> None:
    """No cluster in the environment: a quiet no-op, as the JAX package's
    auto-detection.  An incomplete explicit request raises; a second call
    after a real (one-rank, gloo) init is a no-op."""
    import socket

    import torch.distributed as dist

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    tmesh.distributed_init()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        tmesh.distributed_init(coordinator_address="127.0.0.1:1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmesh.distributed_init(f"127.0.0.1:{port}", 1, 0, backend="gloo")
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        tmesh.distributed_init(f"127.0.0.1:{port}", 2, 1)  # already joined: a no-op
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_multi_device_incremental_append(monkeypatch) -> None:
    """Appends into a sharded index write only the new rows into the shards
    that own them (no full upload), and search as a fresh index and as the
    JAX package's sharded index."""
    rng = np.random.default_rng(0)
    dim = 64
    index = td.DenseIndex(dim=dim, dtype="float32", metric="cosine", num_devices=8, device="cpu")
    # 40,950 rows: the 16 appended cross from shard 4 into shard 5 (8,192
    # rows a shard of the 65,536-row capacity).
    first = list(rng.normal(size=(40_950, 1, dim)).astype(np.float32))
    index.append_chunks(first, [f"a{i}" for i in range(len(first))])
    queries = rng.normal(size=(2, dim)).astype(np.float32)
    index.search_chunks(queries, num_hits=16, num_results=4)  # device arrays built

    uploads = {"n": 0}
    original = td.DenseIndex._full_upload

    def counting_upload(self):
        uploads["n"] += 1
        return original(self)

    monkeypatch.setattr(td.DenseIndex, "_full_upload", counting_upload)
    extra = [rng.normal(size=(1, dim)).astype(np.float32) for _ in range(16)]
    index.append_chunks(extra, [f"b{i}" for i in range(16)])
    assert index.num_rows <= index.capacity  # no reallocation -> no full upload
    scores, ordinals = index.search_chunks(queries, num_hits=32, num_results=6)
    assert uploads["n"] == 0, "multi-device append re-uploaded the full matrix"
    all_ids = [f"a{i}" for i in range(len(first))] + [f"b{i}" for i in range(16)]
    assert index.shard_rows == 8192 and index._rows[5][:6].abs().sum() > 0
    fresh = td.DenseIndex(dim=dim, dtype="float32", metric="cosine", num_devices=8, device="cpu")
    fresh.append_chunks(first + extra, all_ids)
    jfresh = jd.DenseIndex(dim=dim, dtype="float32", metric="cosine", num_devices=8)
    jfresh.append_chunks(first + extra, all_ids)
    for other in (fresh, jfresh):
        f_scores, f_ordinals = other.search_chunks(queries, num_hits=32, num_results=6)
        np.testing.assert_array_equal(ordinals, f_ordinals)
        np.testing.assert_allclose(scores, f_scores, rtol=RTOL)


def test_sharded_int4_two_stage_matches_exact() -> None:
    """The sharded int4 two-stage scan on the JAX test's seed-11 clustered
    fixture: the JAX package's result (ids equal, scores rtol 1e-5), every
    planted neighbour found, no masked row returned."""
    from raglite_tpu.ops.fused_scan import pack_rows_int4 as jpack
    from raglite_tpu.ops.fused_scan import quantize_rows_int8
    from raglite_tpu.parallel.sharded import sharded_int4_two_stage as jsharded
    from raglite_tpu_torch.ops.fused_scan import pack_rows_int4

    n_dev = 8
    mesh = jmesh.index_mesh(n_dev)
    rng = np.random.default_rng(11)
    L = 256  # per-shard bucket count for the tiny fixture
    N, d, B = n_dev * 2 * L, 256, 4
    base = rng.normal(size=(N, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    rows8, scale8 = quantize_rows_int8(base)
    valid = np.ones(N, dtype=bool)
    valid[::7] = False  # mask a seventh of the corpus
    targets = rng.choice(np.flatnonzero(valid), size=B, replace=False)
    q = base[targets] + 0.05 * rng.normal(size=(B, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw = dict(num_hits=8, candidates=64, metric="cosine", num_buckets=L)

    packed, scale4 = jpack(jnp.asarray(rows8), jnp.asarray(scale8))
    shard = jmesh.row_sharding(mesh)
    one_d = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    jscores, jids = jsharded(
        jax.device_put(packed, shard), jax.device_put(scale4, one_d),
        jax.device_put(jnp.asarray(rows8), shard), jax.device_put(jnp.asarray(scale8), one_d),
        jax.device_put(jnp.zeros((N,), jnp.float32), one_d), jax.device_put(jnp.asarray(valid), one_d),
        jnp.asarray(q), mesh=mesh, interpret=True, **kw,
    )
    t_rows8, t_scale8 = torch.from_numpy(rows8), torch.from_numpy(scale8)
    t_packed, t_scale4 = pack_rows_int4(t_rows8, t_scale8)
    split = lambda x: tmesh.split_rows(x, CPU8)  # noqa: E731
    scores, ids = tsh.sharded_int4_two_stage(
        split(t_packed), split(t_scale4), split(t_rows8), split(t_scale8),
        split(torch.zeros(N)), split(torch.from_numpy(valid)), torch.from_numpy(q),
        devices=CPU8, **kw,
    )
    scores, ids = scores.numpy(), ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=RTOL)
    for b, t in enumerate(targets):
        assert t in ids[b], f"query {b}: planted neighbor missing from sharded merge"
    finite = np.isfinite(scores)
    assert valid[ids[finite]].all(), "a masked row surfaced"
    # Shards that are not whole buckets are refused.
    with pytest.raises(ValueError, match="whole"):
        tsh.sharded_int4_two_stage(
            split(t_packed), split(t_scale4), split(t_rows8), split(t_scale8), split(torch.zeros(N)),
            split(torch.from_numpy(valid)), torch.from_numpy(q), devices=CPU8, **{**kw, "num_buckets": 4096},
        )


def _synthetic_keyword_indexes(n_chunks: int = 500, seed: int = 5):
    """The JAX test's zipf-ish synthetic corpus in both packages' keyword
    indexes (pure-Python builds)."""
    rng = np.random.default_rng(seed)
    vocab = [f"term{i}" for i in range(300)]
    weights = 1.0 / np.arange(1, len(vocab) + 1)
    weights /= weights.sum()
    jkw, tkw = JKeywordIndex(), TKeywordIndex(device="cpu")
    jkw._native = tkw._native = None
    for i in range(n_chunks):
        body = " ".join(rng.choice(vocab, size=rng.integers(8, 40), p=weights))
        jkw._add_chunk(f"c{i}", body)
        tkw._add_chunk(f"c{i}", body)
    return jkw, tkw, vocab, rng


def test_sharded_bm25_matches_single_device() -> None:
    """Postings sharded by chunk range and merged equal the single-device
    resident BM25 and the JAX package's sharded BM25, bit for bit."""
    jkw, tkw, vocab, rng = _synthetic_keyword_indexes()
    queries = [
        " ".join(rng.choice(vocab[:50], size=4)),
        "term0 term3 term7",
        "term250 term251",  # rare terms
        "absent-word term1",
    ]
    single = tkw.search_batch(queries, num_hits=12)
    sharded = tkw.sharded_search_batch(queries, num_hits=12, devices=CPU8)
    jsharded = jkw.sharded_search_batch(queries, num_hits=12, mesh=jmesh.index_mesh(8))
    assert sharded is not None and tkw._res["sharded"]["C"] % 256 == 0
    for q, (ids1, sc1), (ids8, sc8), (idsj, scj) in zip(queries, single, sharded, jsharded):
        assert ids8 == ids1 == idsj, q
        assert sc8 == sc1, q
        np.testing.assert_array_equal(np.float32(sc8), np.float32(scj))


def test_sharded_bm25_metadata_filter_and_deletes() -> None:
    jkw, tkw, vocab, rng = _synthetic_keyword_indexes(seed=6)
    for kw in (jkw, tkw):
        # Tombstone a slice of ordinals (weights re-zero on refresh).
        kw._dead = set(range(10, 60))
        kw._stale_dead = set(kw._dead)
        kw._alive_mask = None
        for o in kw._dead:
            kw.doc_len[o] = 0
        kw._res = None  # rebuild resident arrays from the updated state
    mask = np.zeros(len(tkw.chunk_ids), bool)
    mask[::3] = True
    queries = ["term1 term4 term9", "term20 term30"]
    single = tkw.search_batch(queries, num_hits=10, chunk_mask=mask)
    sharded = tkw.sharded_search_batch(queries, num_hits=10, devices=CPU8, chunk_mask=mask)
    jsharded = jkw.sharded_search_batch(queries, num_hits=10, mesh=jmesh.index_mesh(8), chunk_mask=mask)
    assert sharded is not None
    for (ids1, sc1), (ids8, sc8), (idsj, scj) in zip(single, sharded, jsharded):
        assert ids8 == ids1 == idsj
        assert sc8 == sc1
        np.testing.assert_array_equal(np.float32(sc8), np.float32(scj))
        for cid in ids8:
            o = int(cid[1:])
            assert mask[o] and o not in tkw._dead
    # A later delete refreshes the weights and re-derives the shards.
    tkw._dead |= {0, 3}
    tkw._alive_mask = None
    tkw._refresh_resident_weights()
    assert "sharded" not in tkw._res
    again = tkw.sharded_search_batch(queries, num_hits=10, devices=CPU8, chunk_mask=mask)
    assert again == tkw.search_batch(queries, num_hits=10, chunk_mask=mask)
