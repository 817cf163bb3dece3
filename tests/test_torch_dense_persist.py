"""Dense-index persistence and device-built indexes (index/dense.py:
``save``, ``load``, ``from_device_arrays``) against the JAX package's, on
the CPU: the same on-disk layout both ways, equal ids, scores within rtol
1e-4 (f16 query rounding and f32 summation order, ROADMAP queue 3), and a
metadata filter on a device-built index; and a store reopened from disk,
whose first insert replays no log yet still absorbs another writer."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.documents import Chunk as JChunk
from raglite_tpu.index import dense as jd
from raglite_tpu.store import Store as JStore
from raglite_tpu_torch.documents import Chunk as TChunk
from raglite_tpu_torch.index import dense as td
from raglite_tpu_torch.ops.fused_scan import INT4_NUM_BUCKETS
from raglite_tpu_torch.store import Store as TStore

RTOL = 1e-4
D = 48


def _unit(rng, n, d) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(seed: int = 0, chunks: int = 90):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 5, size=chunks)
    matrices = [_unit(rng, int(c), D).astype(np.float16) for c in counts]
    return matrices, [f"c{i}" for i in range(chunks)], rng.normal(size=(4, D)).astype(np.float32)


def _synced(module, chunk_cls, store_cls, matrices, ids, *, delete=(), **kw):
    store = store_cls(":memory:")
    for i, cid in enumerate(ids):
        doc = "odd" if i % 2 else "even"
        store.add_chunks([chunk_cls(id=cid, document_id=doc, index=i, headings="", body=cid)], [matrices[i]])
    store.deleted_chunks.update(delete)
    index = module.DenseIndex(dim=D, **kw)
    index.sync(store)
    return index


def _search(index, queries, **kw):
    scores, ordinals = index.search_chunks(queries, num_hits=40, num_results=8, **kw)
    return scores, [[index.chunk_ids[o] if o >= 0 else None for o in row] for row in ordinals]


KINDS = [("bfloat16", "cosine"), ("float16", "dot"), ("float32", "l2"), ("int8", "cosine")]


@pytest.mark.parametrize(("dtype", "metric"), KINDS)
def test_jax_saves_port_loads(tmp_path, dtype: str, metric: str) -> None:
    matrices, ids, q = _corpus()
    jidx = _synced(jd, JChunk, JStore, matrices, ids, delete={"c3", "c10"}, dtype=dtype, metric=metric)
    jidx.save(str(tmp_path / "index"))
    tidx = td.DenseIndex.load(str(tmp_path / "index"), device="cpu")
    assert (tidx.num_rows, tidx.dim, tidx.metric, tidx.chunk_ids) == (jidx.num_rows, D, metric, ids)
    jsc, jids = _search(jidx, q)
    tsc, tids = _search(tidx, q)
    assert tids == jids
    assert not {"c3", "c10"} & {c for row in tids for c in row}
    np.testing.assert_allclose(tsc, jsc, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize(("dtype", "metric"), KINDS)
def test_port_saves_jax_loads(tmp_path, dtype: str, metric: str) -> None:
    matrices, ids, q = _corpus(1)
    tidx = _synced(td, TChunk, TStore, matrices, ids, delete={"c7"}, dtype=dtype, metric=metric, device="cpu")
    tidx.save(str(tmp_path / "index"))
    jidx = jd.DenseIndex.load(str(tmp_path / "index"))
    assert (jidx.num_rows, jidx.chunk_ids) == (tidx.num_rows, ids)
    jsc, jids = _search(jidx, q)
    tsc, tids = _search(tidx, q)
    assert tids == jids
    np.testing.assert_allclose(tsc, jsc, rtol=RTOL, atol=1e-6)
    # And back: the port reloads its own files to the same answers.
    again = td.DenseIndex.load(str(tmp_path / "index"), device="cpu")
    asc, aids = _search(again, q)
    assert aids == tids
    np.testing.assert_array_equal(asc, tsc)


def test_layout_equal_to_jax(tmp_path) -> None:
    matrices, ids, _ = _corpus(2)
    _synced(jd, JChunk, JStore, matrices, ids, dtype="bfloat16", metric="cosine").save(str(tmp_path / "j"))
    _synced(td, TChunk, TStore, matrices, ids, dtype="bfloat16", metric="cosine", device="cpu").save(str(tmp_path / "t"))
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert json.loads((tmp_path / "t" / "manifest.json").read_text()) == json.loads((tmp_path / "j" / "manifest.json").read_text())
    for name in ("rows.npy", "valid.npy", "row_chunk.npy"):
        t, j = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_from_device_arrays_equals_jax(metric: str) -> None:
    rng = np.random.default_rng(3)
    n = 1000
    rows = _unit(rng, n, D)
    row_chunk = (np.arange(n) // 4).astype(np.int32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    jidx = jd.DenseIndex.from_device_arrays(jnp.asarray(rows, jnp.bfloat16), jnp.asarray(row_chunk), metric=metric)
    tidx = td.DenseIndex.from_device_arrays(torch.from_numpy(rows).to(torch.bfloat16), torch.from_numpy(row_chunk), metric=metric)
    np.testing.assert_array_equal(tidx.row_chunk, np.asarray(jidx.row_chunk))
    np.testing.assert_allclose(tidx._sqnorm[0].numpy(), np.asarray(jidx._dev_sqnorm), rtol=1e-6)
    kw = dict(num_hits=40, num_results=8)
    jsc, jord = jidx.search_chunks(q, **kw)
    tsc, tord = tidx.search_chunks(q, **kw)
    np.testing.assert_array_equal(tord, jord)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-6)
    # A metadata filter: chunks of even ordinal only, as search.py builds
    # the row mask from the host row map.
    chunk_mask = np.arange(n // 4) % 2 == 0
    row_mask = chunk_mask[tidx.row_chunk]
    fsc, ford = tidx.search_chunks(q, row_mask=row_mask, **kw)
    jfsc, jford = jidx.search_chunks(q, row_mask=chunk_mask[np.asarray(jidx.row_chunk)], **kw)
    assert (ford >= 0).all() and (ford % 2 == 0).all()
    np.testing.assert_array_equal(ford, jford)
    np.testing.assert_allclose(fsc, jfsc, rtol=1e-5, atol=1e-6)


def test_from_device_arrays_int8_and_packed_padding() -> None:
    """int8 rows with scales; the int4 stage's packed copy pads to a
    multiple of INT4_NUM_BUCKETS as the JAX package's does, and the int4
    route (forced here; it opens on a card) scans it as the JAX package's
    two-stage program does."""
    from raglite_tpu.ops import fused_scan as jfs

    rng = np.random.default_rng(4)
    n = INT4_NUM_BUCKETS + 300
    rows_i8, scale = jfs.quantize_rows_int8(_unit(rng, n, 256))
    row_chunk = np.arange(n, dtype=np.int32)
    jidx = jd.DenseIndex.from_device_arrays(jnp.asarray(rows_i8), jnp.asarray(row_chunk), row_scale=jnp.asarray(scale))
    tidx = td.DenseIndex.from_device_arrays(
        torch.from_numpy(np.array(rows_i8)), torch.from_numpy(row_chunk), row_scale=torch.from_numpy(np.array(scale))
    )
    assert tidx._dtype == torch.int8 and tidx.capacity == n
    jidx._ensure_packed4()
    tidx._ensure_packed4()
    assert tidx._packed4[0].shape[0] == 2 * INT4_NUM_BUCKETS == np.asarray(jidx._dev_packed4).shape[0]
    np.testing.assert_array_equal(tidx._packed4[0].numpy(), np.asarray(jidx._dev_packed4))
    np.testing.assert_array_equal(tidx._scale4[0].numpy(), np.asarray(jidx._dev_scale4))
    q = rng.normal(size=(2, 256)).astype(np.float32)
    jsc, jord = jidx.search_chunks(q, num_hits=16, num_results=5)
    tsc, tord = tidx.search_chunks(q, num_hits=16, num_results=5)
    np.testing.assert_array_equal(tord, jord)
    np.testing.assert_array_equal(tsc, jsc)
    tidx._use_int4_stage1 = lambda batch, exact: True
    tsc, tord = tidx.search_chunks(q, num_hits=16, num_results=5)
    assert tidx.last_route == "int4_two_stage"
    jsc, jord = np.asarray(jd._int4_two_stage_chunks(
        jidx._dev_packed4, jidx._dev_scale4, jidx._dev_rows, jidx._dev_scale, jidx._dev_sqnorm, jidx._dev_valid,
        jidx._dev_row_chunk, jnp.asarray(q), num_hits=16, num_results=5, candidates=256, metric="cosine",
        num_buckets=INT4_NUM_BUCKETS, interpret=True,
    ))
    np.testing.assert_array_equal(tord, jord.astype(np.int64))
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5)


def test_device_built_index_has_no_mirror_to_save(tmp_path) -> None:
    tidx = td.DenseIndex.from_device_arrays(torch.zeros((8, D), dtype=torch.bfloat16), torch.arange(8))
    with pytest.raises(ValueError, match="no host mirror"):
        tidx.save(str(tmp_path / "x"))


def test_loaded_index_syncs_with_its_store(tmp_path) -> None:
    """A reloaded index resumes from its store: nothing re-uploaded from
    the store when the ids agree, new chunks appended."""
    matrices, ids, q = _corpus(5)
    store = TStore(":memory:")
    store.add_chunks([TChunk(id=c, document_id="d", index=i, headings="", body=c) for i, c in enumerate(ids[:60])], matrices[:60])
    first = td.DenseIndex(dim=D, device="cpu")
    first.sync(store)
    first.save(str(tmp_path / "index"))
    loaded = td.DenseIndex.load(str(tmp_path / "index"), device="cpu")
    store.add_chunks([TChunk(id=c, document_id="d", index=60 + i, headings="", body=c) for i, c in enumerate(ids[60:])], matrices[60:])
    loaded.sync(store)
    first.sync(store)
    assert loaded.chunk_ids == ids == first.chunk_ids
    assert _search(loaded, q)[1] == _search(first, q)[1]


def _reopen(config_cls, store_module, path: str, **kw):
    """A fresh view of the store at ``path``, as a new process opens it."""
    store_module._store_for_path.cache_clear()
    return config_cls(store_path=path, embedder="hash:64", llm="echo", **kw)


def test_reopened_store_first_insert_reads_no_log(tmp_path, monkeypatch) -> None:
    """A store opened from disk knows the head it read: its first insert
    replays no log and keeps its generation (no device-index rebuild), and
    its chunks equal the JAX package's after the same inserts."""
    import raglite_tpu.store as jstore_module
    import raglite_tpu_torch.store as tstore_module
    from raglite_tpu import RAGLiteConfig as JConfig
    from raglite_tpu.documents import Document as JDocument
    from raglite_tpu.insert import insert_documents as jinsert
    from raglite_tpu_torch import RAGLiteConfig as TConfig
    from raglite_tpu_torch.documents import Document as TDocument
    from raglite_tpu_torch.insert import insert_documents as tinsert

    texts = ["# A\n\n" + "Pelicans carry fish in their pouches. " * 40, "# B\n\n" + "Herons wade in shallow water. " * 40]
    tcfg = _reopen(TConfig, tstore_module, str(tmp_path / "t"), device="cpu")
    jcfg = _reopen(JConfig, jstore_module, str(tmp_path / "j"))
    tinsert([TDocument.from_text(texts[0])], config=tcfg)
    jinsert([JDocument.from_text(texts[0])], config=jcfg)
    tcfg = _reopen(TConfig, tstore_module, tcfg.store_path, device="cpu")
    jcfg = _reopen(JConfig, jstore_module, jcfg.store_path)
    store = tstore_module.store_from_config(tcfg)
    generation = store.generation

    def no_replay(*args, **kwargs):
        raise AssertionError("the log was replayed")

    monkeypatch.setattr(TStore, "_read_log", no_replay)
    tinsert([TDocument.from_text(texts[1])], config=tcfg)
    jinsert([JDocument.from_text(texts[1])], config=jcfg)
    assert store.generation == generation
    assert store.chunk_order == jstore_module.store_from_config(jcfg).chunk_order
    monkeypatch.undo()
    again = tstore_module.store_from_config(_reopen(TConfig, tstore_module, tcfg.store_path, device="cpu"))
    assert again.chunk_order == store.chunk_order and len(again.documents) == 2


def test_reopened_store_still_absorbs_another_writer(tmp_path) -> None:
    """A head another writer committed after our open is still absorbed
    before our next save: both writers' chunks survive."""
    import raglite_tpu_torch.store as tstore_module
    from raglite_tpu_torch import RAGLiteConfig as TConfig
    from raglite_tpu_torch.documents import Document as TDocument
    from raglite_tpu_torch.insert import insert_documents as tinsert

    cfg = _reopen(TConfig, tstore_module, str(tmp_path / "kb"), device="cpu")
    tinsert([TDocument.from_text("# A\n\n" + "Alpha text about rivers. " * 30)], config=cfg)
    cfg = _reopen(TConfig, tstore_module, cfg.store_path, device="cpu")
    ours = tstore_module.store_from_config(cfg)
    other = TStore(cfg.store_path)  # a second writer, as another process
    doc = TDocument.from_text("other writer", id="other")
    other.add_document(doc)
    other.add_chunks([TChunk(id="other-0", document_id="other", index=0, headings="", body="other writer")],
                     [np.ones((1, 64), dtype=np.float16) / 8])
    with other.write_lock():
        other.save()
    tinsert([TDocument.from_text("# C\n\n" + "Gamma text about mountains. " * 30)], config=cfg)
    assert "other-0" in ours.chunk_order and "other" in ours.documents
    final = TStore(cfg.store_path)
    assert final.chunk_order == ours.chunk_order
