"""The retrieval programs that the port replays from CUDA graphs on the card
(utils/graphs.py: ``ProgramGraphs``; models/encoder.py: the token, pooled,
rerank-encode and MaxSim programs; index/dense.py: the int4, single-stage and
dense routes), run eagerly on the CPU as the card's first call runs them.

Each program is held to its JAX counterpart on the same numpy inputs
(weights carried across with ``params_from_jax``; the JAX package's Pallas
scans in interpret mode, the port's plain scans): ids equal, f32 states and
pools within 1e-4 absolute (tests/test_torch_encoder.py's tolerance),
MaxSim and index scores within rtol 1e-5 (tests/test_torch_dense.py's),
and 1e-4 where f16 query embeddings enter (the slice end to end).

The graph path's bookkeeping runs on the CPU through a test double for the
capture (a "graph" that re-runs the program on its static buffers, as a
replay re-runs the captured kernels): static inputs filled per call,
outputs copied out, a key per shape and per index generation, a sync
that waits for a search in flight, the LRU cap and the program lock.  A program must make no host read and no upload from
the host inside a capture: each runs under a dispatch mode that raises on
the ops that do.
"""

import contextlib
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import raglite_tpu.models.encoder as jenc
import raglite_tpu_torch.models.encoder as tenc
from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu import search as jsearch
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.index import dense as jd
from raglite_tpu.insert import insert_documents as jinsert
from raglite_tpu.ops import fused_scan as jfs
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch import search as tsearch
from raglite_tpu_torch.documents import Chunk as TChunk
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.index import dense as td
from raglite_tpu_torch.index.dense import dense_index_from_config
from raglite_tpu_torch.insert import insert_documents as tinsert
from raglite_tpu_torch.models import transformer as tt
from raglite_tpu_torch.models.tokenizer import ByteTokenizer
from raglite_tpu_torch.store import Store as TStore
from raglite_tpu_torch.utils import graphs

ROOT = Path(__file__).resolve().parent.parent
DOCS = {"MIGRATION.md": "migration", "BASELINE.md": "baseline"}
QUERIES = (
    "Which public symbols of the reference have equivalents?",
    "What does the baseline measure?",
    "How is the query adapter applied?",
)
RTOL = 1e-5
#: Ops that read a tensor's data on the host, make a tensor whose shape
#: depends on it, or lift a host value into a tensor (an upload on the card).
HOST_OPS = {
    torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero, torch.ops.aten.masked_select,
    torch.ops.aten.equal, torch.ops.aten._unique2, torch.ops.aten.unique_consecutive, torch.ops.aten.lift_fresh,
}


class _NoHostOps(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_OPS:
            msg = f"host read or upload inside a program: {func}"
            raise AssertionError(msg)
        return func(*args, **(kwargs or {}))


class _FakeGraph:
    """A replay that re-runs the program on the static inputs and writes its
    outputs into the captured ones (a replay's effect, on the CPU)."""

    def __init__(self, program, statics, outputs) -> None:
        self.program, self.statics, self.outputs = program, statics, outputs

    def replay(self) -> None:
        fresh = self.program(*self.statics)
        for out, new in zip(graphs._as_tuple(self.outputs), graphs._as_tuple(fresh)):
            out.copy_(new)


def _fake_capture(self, program, statics):
    outputs = program(*statics)
    return _FakeGraph(program, statics, outputs), outputs, [], 0.0, 0


@pytest.fixture
def fake_capture(monkeypatch):
    """ProgramGraphs objects made ``captures = True`` on the CPU take the
    graph path with the test double: no stream, the real lock."""
    monkeypatch.setattr(graphs, "_on_program_stream", lambda device: contextlib.nullcontext(None))
    monkeypatch.setattr(graphs.ProgramGraphs, "_capture", _fake_capture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def encoders():
    """The JAX tiny encoder in f32 and the port's with its weights."""
    j = jenc.TransformerEncoder("tiny", dtype=jnp.float32)
    model = tt.EncoderModel.from_params(j._cfg, j._params, dtype=torch.float32, device="cpu")
    return j, tenc.TransformerEncoder.from_model(model, ByteTokenizer(vocab_size=j._cfg["vocab"]))


def _ids_mask(rng, b: int, t: int, vocab: int):
    ids = rng.integers(3, vocab, size=(b, t)).astype(np.int64)
    mask = np.zeros((b, t), bool)
    for row, n in enumerate(rng.integers(1, t + 1, size=b)):
        mask[row, :n] = True
    ids[~mask] = 0
    return ids, mask


# --- Each program's eager step against its JAX counterpart --------------------


@pytest.mark.parametrize("b,t", [(1, 128), (8, 128), (3, 256)])
@pytest.mark.parametrize("kind", ["tokens", "pooled", "norm"])
def test_encoder_programs_match_jax(encoders, kind: str, b: int, t: int) -> None:
    """``_tokens_program`` = ``apply_tokens``, ``_pooled_program`` =
    ``_forward_pooled``, ``_norm_program`` = ``_rerank_encode``, through the
    encoder's ProgramGraphs (eager on the CPU), within 1e-4."""
    j, tcode = encoders
    ids, mask = _ids_mask(np.random.default_rng(b * t), b, t, j._cfg["vocab"])
    j._ensure_rerank_programs()
    jax_fn = {"tokens": j._forward, "pooled": j._forward_pooled, "norm": j._rerank_encode}[kind]
    want = np.asarray(jax_fn(j._params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask)), np.float32)
    program = {"tokens": tcode._tokens_program, "pooled": tcode._pooled_program, "norm": tcode._norm_program}[kind]
    got = tcode.programs((kind, b, t), program, ids, mask)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("c,tc", [(8, 128), (16, 256)])
def test_maxsim_program_matches_jax(encoders, c: int, tc: int) -> None:
    """``_score`` (cached rows stacked into the key's buffer, zero rows up
    to C) = ``_rerank_score`` on the same normalised states, rtol 1e-5."""
    j, tcode = encoders
    rng = np.random.default_rng(c + tc)
    j._ensure_rerank_programs()
    q_ids, q_mask = _ids_mask(rng, 1, 128, j._cfg["vocab"])
    c_ids, c_mask = _ids_mask(rng, c, tc, j._cfg["vocab"])
    c_mask[c - 3 :] = False  # padding rows of the tile
    qh = j._rerank_encode(j._params, jnp.asarray(q_ids, jnp.int32), jnp.asarray(q_mask))[0]
    ch = j._rerank_encode(j._params, jnp.asarray(c_ids, jnp.int32), jnp.asarray(c_mask))
    want = np.asarray(j._rerank_score(qh, jnp.asarray(q_mask), ch, jnp.asarray(c_mask)))
    rows = [torch.from_numpy(np.array(ch[i])) for i in range(c - 3)]
    got = tcode._score(torch.from_numpy(np.array(qh)), q_mask, rows, c_mask).numpy()
    np.testing.assert_allclose(got[: c - 3], want[: c - 3], rtol=RTOL, atol=1e-6)
    assert (got[c - 3 :] == 0).all() and (want[c - 3 :] == 0).all()


def _unit(rng, n, d) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _arrays(rng, dtype: str, metric: str, n: int = 2048, d: int = 64):
    rows = _unit(rng, n, d)
    valid = rng.random(n) > 0.05
    valid[-100:] = False  # capacity padding
    row_chunk = (np.arange(n) // 3).astype(np.int32)
    row_chunk[-100:] = -1
    if dtype == "int8":
        rows_s, scale = jfs.quantize_rows_int8(rows)
        rows_s, scale = np.asarray(rows_s), np.asarray(scale)
        deq = rows_s.astype(np.float32) * scale[:, None]
    else:
        rows_s, scale, deq = rows, None, rows
    sq = (deq**2).sum(axis=1).astype(np.float32) if metric == "l2" else np.zeros(n, np.float32)
    return rows_s, scale, sq, valid, row_chunk


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("adapted", [False, True], ids=["plain", "adapter"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_int4_two_stage_chunks_program_matches_jax(dtype: str, metric: str, adapted: bool) -> None:
    """``int4_two_stage_chunks`` = ``_int4_two_stage_chunks`` (int4 Pallas
    in interpret mode against the port's plain scan): ordinals equal."""
    rng = np.random.default_rng(7)
    rows_s, scale, sq, valid, row_chunk = _arrays(rng, dtype, metric)
    q = rng.normal(size=(3, rows_s.shape[1])).astype(np.float32)
    adapter = (np.eye(q.shape[1]) + 0.01 * rng.normal(size=(q.shape[1],) * 2)).astype(np.float32) if adapted else None
    jp, j4 = jfs.pack_rows_int4(jnp.asarray(rows_s), None if scale is None else jnp.asarray(scale))
    kw = dict(num_hits=20, num_results=8, candidates=64, metric=metric, num_buckets=256)
    want = np.asarray(jd._int4_two_stage_chunks(
        jp, j4, jnp.asarray(rows_s), None if scale is None else jnp.asarray(scale), jnp.asarray(sq),
        jnp.asarray(valid), jnp.asarray(row_chunk), jnp.asarray(q), None if adapter is None else jnp.asarray(adapter),
        interpret=True, **kw,
    ))
    one = lambda x: None if x is None else [_t(x)]  # noqa: E731
    sc, ords = td.int4_two_stage_chunks(
        one(jp), one(j4), one(rows_s), one(scale), one(sq), one(valid), _t(row_chunk), _t(q), _t(adapter),
        devices=[torch.device("cpu")], **kw,
    )
    np.testing.assert_array_equal(ords.numpy(), want[1].astype(np.int64))
    np.testing.assert_allclose(sc.numpy(), want[0], rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("adapted", [False, True], ids=["plain", "adapter"])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_dense_search_chunks_program_matches_jax(metric: str, adapted: bool) -> None:
    """``dense_search_chunks`` = ``_dense_search_chunks_fused(exact=True)``."""
    rng = np.random.default_rng(8)
    rows_s, _, sq, valid, row_chunk = _arrays(rng, "float32", metric, n=512)
    q = rng.normal(size=(4, rows_s.shape[1])).astype(np.float32)
    adapter = (np.eye(q.shape[1]) + 0.01 * rng.normal(size=(q.shape[1],) * 2)).astype(np.float32) if adapted else None
    want = np.asarray(jd._dense_search_chunks_fused(
        jnp.asarray(rows_s), jnp.asarray(sq), jnp.asarray(valid), jnp.asarray(row_chunk), jnp.asarray(q),
        None, None if adapter is None else jnp.asarray(adapter),
        num_hits=24, num_results=6, metric=metric, exact=True,
    ))
    sc, ords = td.dense_search_chunks(
        [_t(rows_s)], [_t(sq)], [_t(valid)], _t(row_chunk), _t(q), None, _t(adapter),
        num_hits=24, num_results=6, metric=metric, devices=[torch.device("cpu")],
    )
    np.testing.assert_array_equal(ords.numpy(), want[1].astype(np.int64))
    np.testing.assert_allclose(sc.numpy(), want[0], rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_fused_scan_chunks_program_matches_jax(dtype: str, metric: str) -> None:
    """``fused_scan_chunks`` = the JAX package's single-stage scan and its
    top-k (``fused_scan_topk``, Pallas in interpret mode) then
    ``_group_max_topk``, the two programs it dispatches there."""
    rng = np.random.default_rng(9)
    rows_s, scale, sq, valid, row_chunk = _arrays(rng, dtype, metric, n=2048)
    q = rng.normal(size=(2, rows_s.shape[1])).astype(np.float32)
    js, ji = jfs.fused_scan_topk(
        jnp.asarray(rows_s), jnp.asarray(sq), jnp.asarray(valid), jnp.asarray(q), num_hits=24, metric=metric,
        row_scale=None if scale is None else jnp.asarray(scale), num_buckets=1024, interpret=True,
    )
    want = np.asarray(jd._group_max_topk(js, ji, jnp.asarray(row_chunk), num_results=6))
    sc, ords = td.fused_scan_chunks(
        _t(rows_s), _t(sq), _t(valid), _t(row_chunk), _t(q), _t(scale), num_hits=24, num_results=6, metric=metric,
    )
    np.testing.assert_array_equal(ords.numpy(), want[1].astype(np.int64))
    np.testing.assert_allclose(sc.numpy(), want[0], rtol=RTOL, atol=1e-6)


# --- No host read inside a program --------------------------------------------


def _index(rng, n_chunks: int = 300, d: int = 256, dtype: str = "bfloat16") -> td.DenseIndex:
    store = TStore(":memory:")
    matrices = [_unit(rng, 2, d).astype(np.float16) for _ in range(n_chunks)]
    chunks = [TChunk(id=f"c{i}", document_id="doc", index=i, headings="", body=f"c{i}") for i in range(n_chunks)]
    store.add_chunks(chunks, matrices)
    index = td.DenseIndex(dim=d, dtype=dtype, device="cpu")
    index.sync(store)
    index._refresh_device()
    index._ensure_packed4()
    return index


def _programs(encoders) -> dict:
    """Each program with inputs of its shape: the encoder's four and the
    index's three routes (built over a CPU index, as on one card)."""
    _, tcode = encoders
    rng = np.random.default_rng(4)
    ids, mask = _ids_mask(rng, 8, 128, tcode._cfg["vocab"])
    states = tcode._norm_program(torch.from_numpy(ids), torch.from_numpy(mask))
    index = _index(rng)
    q = torch.from_numpy(rng.normal(size=(2, index.dim)).astype(np.float32))
    row_mask = torch.from_numpy(rng.random(index.capacity) > 0.5)
    adapter = index._adapter_device(np.eye(index.dim, dtype=np.float32))
    out = {
        "tokens": (tcode._tokens_program, torch.from_numpy(ids), torch.from_numpy(mask)),
        "pooled": (tcode._pooled_program, torch.from_numpy(ids), torch.from_numpy(mask)),
        "norm": (tcode._norm_program, torch.from_numpy(ids), torch.from_numpy(mask)),
        "maxsim": (tcode._maxsim, states[0], torch.from_numpy(mask[:1]), states, torch.from_numpy(mask)),
    }
    for route in ("int4_two_stage", "fused_scan", "dense"):
        program = index._chunks_program(route, num_hits=16, num_results=5, adapter=adapter)
        out[route] = (program, q, row_mask)
    return out


@pytest.mark.parametrize("name", ["tokens", "pooled", "norm", "maxsim", "int4_two_stage", "fused_scan", "dense"])
def test_programs_make_no_host_read(encoders, name: str) -> None:
    """Each program, the region a graph captures, runs under a dispatch
    mode that raises on host reads and uploads; the mode sees both."""
    program, *inputs = _programs(encoders)[name]
    with _NoHostOps(), torch.inference_mode():
        out = program(*inputs)
    assert all(torch.isfinite(t).any() for t in graphs._as_tuple(out))
    with pytest.raises(AssertionError, match="host read"), _NoHostOps():
        bool(inputs[0].any())
    with pytest.raises(AssertionError, match="upload"), _NoHostOps():
        torch.tensor(-1e30)


# --- Keys, generations, the LRU cap and the lock -------------------------------


def test_graph_path_equals_eager_and_copies_out(fake_capture) -> None:
    """Through the test double: the first call of a key is the eager
    program, later calls replay on refilled static buffers; every call's
    outputs are copies the next replay leaves alone."""
    programs = graphs.ProgramGraphs("cpu")
    programs.captures = True
    program = lambda x, y: (x * 2 + y.sum(), x.clone())  # noqa: E731
    stacked = graphs.Stacked([torch.ones(2)], 2)
    first = programs(("k", 3), program, np.arange(3.0), stacked)
    assert programs.counts["captured"] == 1 and ("k", 3) in programs
    assert programs._entries[("k", 3)].program is program  # its arrays live as long as its graph
    second = programs(("k", 3), program, np.arange(3.0) + 10, graphs.Stacked([torch.full((2,), 5.0)], 2))
    assert programs.counts["replayed"] == 1
    assert first[0].tolist() == [2.0, 4.0, 6.0] and first[1].tolist() == [0.0, 1.0, 2.0]
    assert second[0].tolist() == [30.0, 32.0, 34.0]  # 2 x + (5 + 5 + 0 + 0)
    third = programs(("k", 3), program, np.zeros(3), stacked)
    assert second[0].tolist() == [30.0, 32.0, 34.0] and third[0].tolist() == [2.0] * 3
    with graphs.eager_programs():
        assert programs(("k", 3), program, np.zeros(3), stacked)[0].tolist() == [2.0] * 3
    assert programs.counts == {"captured": 1, "replayed": 2, "kept_eager": 0, "evicted": 0}
    with pytest.raises(ValueError, match="for a key of"):
        programs(("k", 3), program, np.zeros(4), stacked)


def test_lru_cap_evicts_the_oldest_key(fake_capture, monkeypatch) -> None:
    monkeypatch.setattr(graphs, "PROGRAM_KEYS", 2)
    programs = graphs.ProgramGraphs("cpu", capture_if=lambda key: key != "big")
    programs.captures = True
    for key in ("a", "b", "a", "c"):
        programs(key, lambda x: x + 1, np.zeros(2))
    assert list(programs._entries) == ["a", "c"] and programs.counts["evicted"] == 1
    programs("big", lambda x: x + 1, np.zeros(2))
    assert "big" not in programs and programs.counts["kept_eager"] == 1
    programs.clear()
    assert len(programs) == 0 and programs._pool is None


def test_program_lock_serialises_threads(fake_capture) -> None:
    """Two threads replaying (and capturing) on one device never run a
    program at once; each gets its own inputs' result."""
    programs = graphs.ProgramGraphs("cpu")
    programs.captures = True
    inside, overlaps, results = [0], [], {}
    guard = threading.Lock()

    def program(x):
        with guard:
            inside[0] += 1
            overlaps.append(inside[0])
        time.sleep(0.002)
        with guard:
            inside[0] -= 1
        return x * 3

    def run(worker: int) -> None:
        results[worker] = [programs(("k", worker % 2), program, np.full(2, float(i)))[0].item() for i in range(10)]

    threads = [threading.Thread(target=run, args=(w,)) for w in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert max(overlaps) == 1
    assert results == {0: [3.0 * i for i in range(10)], 1: [3.0 * i for i in range(10)]}


def test_one_program_lock_per_card(monkeypatch) -> None:
    """"cuda" and "cuda:0" name one card, whose programs share one stream:
    they share one lock (an encoder on "cuda:0" and an index on "cuda"
    must never capture and replay on that stream at once)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    lock = graphs._program_lock(torch.device("cuda"))
    assert graphs._program_lock(torch.device("cuda", 0)) is lock
    assert graphs._program_lock(torch.device("cuda", 1)) is not lock
    assert graphs._program_lock(torch.device("cpu")) is not lock


def _add_chunks(store: TStore, rng, first: int, count: int, d: int) -> None:
    store.add_chunks(
        [TChunk(id=f"c{i}", document_id="doc", index=i, headings="", body=f"c{i}") for i in range(first, first + count)],
        [_unit(rng, 2, d).astype(np.float16) for _ in range(count)],
    )


def test_index_generation_keys(fake_capture) -> None:
    """A new generation (and key) after an append, a tombstone, a capacity
    growth and an adapter update; the stale graphs dropped; every graph
    result equal to the eager one."""
    rng = np.random.default_rng(5)
    d = 256
    store = TStore(":memory:")

    def add(first: int, count: int) -> None:
        _add_chunks(store, rng, first, count, d)

    add(0, 100)
    index = td.DenseIndex(dim=d, dtype="bfloat16", device="cpu")
    index.programs.captures = True
    q = rng.normal(size=(2, d)).astype(np.float32)

    def search(**kw):
        index.sync(store)
        got = index.search_chunks_device(q, num_hits=16, num_results=5, **kw)
        with graphs.eager_programs():
            want = index.search_chunks_device(q, num_hits=16, num_results=5, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return got

    search()
    gen = index.generation
    keys = set(index.programs._entries)
    assert len(keys) == 1 and next(iter(keys))[-1] == gen
    search()
    assert index.programs.counts["replayed"] == 1 and index.generation == gen
    add(100, 50)  # an append within the capacity
    _, ords = search()
    assert index.generation > gen
    assert all(key[-1] == index.generation for key in index.programs._entries)
    gen = index.generation
    doomed = {index.chunk_ids[int(o)] for o in ords[0][:2]}
    store.deleted_chunks |= doomed  # a tombstone
    store.version += 1
    _, ords = search()
    assert index.generation > gen and not doomed & {index.chunk_ids[int(o)] for o in ords[0] if o >= 0}
    gen, capacity = index.generation, index.capacity
    add(150, capacity // 2)  # a capacity growth
    search()
    assert index.capacity > capacity and index.generation > gen
    gen = index.generation
    adapter = (np.eye(d) + 0.01 * rng.normal(size=(d, d))).astype(np.float32)
    search(adapter=adapter)  # an adapter update
    assert index.generation == gen + 1
    search(adapter=adapter)  # the same adapter: the same key
    search(adapter=adapter.copy())
    assert index.generation == gen + 2
    mask = np.zeros(index.num_rows, bool)
    mask[::3] = True
    search(row_mask=mask)
    keys = set(index.programs._entries)
    assert len(keys) == 2 and {key[4:6] for key in keys} == {(False, True), (True, False)}


def test_sync_waits_for_a_search_in_flight(fake_capture, monkeypatch) -> None:
    """A sync that arrives while a search builds and captures its program
    (here: between the program's build and its capture) waits for the
    search: the key holds the generation of the arrays the program read,
    the sync's bump then drops that graph, and the next search captures
    the new generation, equal to the eager search each time."""
    rng = np.random.default_rng(9)
    d = 256
    store = TStore(":memory:")
    _add_chunks(store, rng, 0, 100, d)
    index = td.DenseIndex(dim=d, dtype="bfloat16", device="cpu")
    index.programs.captures = True
    index.sync(store)
    q = rng.normal(size=(2, d)).astype(np.float32)
    with graphs.eager_programs():
        before = index.search_chunks_device(q, num_hits=16, num_results=5)
    build = index._chunks_program
    syncer = threading.Thread(target=index.sync, args=(store,))
    seen: dict = {}

    def chunks_program(*args, **kw):
        program = build(*args, **kw)
        seen["generation"] = index.generation
        _add_chunks(store, rng, 100, index.capacity, d)  # grows the capacity: every array is replaced
        syncer.start()
        syncer.join(timeout=0.5)
        seen["waited"] = syncer.is_alive()
        return program

    monkeypatch.setattr(index, "_chunks_program", chunks_program)
    got = index.search_chunks_device(q, num_hits=16, num_results=5)
    syncer.join(timeout=60)
    assert seen["waited"] and not syncer.is_alive()
    assert torch.equal(got[0], before[0]) and torch.equal(got[1], before[1])
    assert index.generation > seen["generation"] and len(index.programs) == 0
    monkeypatch.setattr(index, "_chunks_program", build)
    got = index.search_chunks_device(q, num_hits=16, num_results=5)
    with graphs.eager_programs():
        want = index.search_chunks_device(q, num_hits=16, num_results=5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert [key[-1] for key in index.programs._entries] == [index.generation]


def test_index_size_rule() -> None:
    """The dense route's keys stay eager past GRAPH_SCAN_BYTES; the
    kernel routes are always captured."""
    index = td.DenseIndex(dim=768, dtype="bfloat16", device="cpu")
    index.capacity = 4096 * 80
    assert index._captured(("dense", 32, 40, 10, False, False, 0))
    index.capacity = 4096 * 305  # 1,249,280 rows
    assert not index._captured(("dense", 1, 40, 10, False, False, 0))
    assert index._captured(("int4_two_stage", 32, 40, 10, True, True, 0))
    assert index._captured(("fused_scan", 1, 40, 10, False, False, 0))


def test_encoder_size_rule(encoders) -> None:
    _, tcode = encoders
    heads = tcode._cfg["heads"]
    assert tcode._captured(("tokens", 8, 128)) and tcode._captured(("score", 128, 32, 8192))
    limit = tcode.GRAPH_ATTENTION_BYTES
    t = int((limit / (8 * heads * 4)) ** 0.5)
    assert tcode._captured(("norm", 8, t)) and not tcode._captured(("norm", 8, t + 1))


# --- The slice end to end -----------------------------------------------------


@pytest.fixture(scope="module")
def configs(encoders, tmp_path_factory: pytest.TempPathFactory):
    """A JAX and a port store of DOCS with the same tiny f32 encoder."""
    j_encoder, t_encoder = encoders
    root = tmp_path_factory.mktemp("retrieval_graphs")
    patch = pytest.MonkeyPatch()
    patch.setattr(jenc, "_make_encoder", lambda embedder: j_encoder)
    patch.setattr(tenc, "_make_encoder", lambda embedder, device: t_encoder)
    jcfg = JConfig(store_path=str(root / "jax"), embedder="flax:tiny", chunk_max_size=1024)
    tcfg = TConfig(store_path=str(root / "torch"), embedder="flax:tiny", chunk_max_size=1024, device="cpu")
    texts = {f: (ROOT / f).read_text(encoding="utf-8") for f in DOCS}
    jinsert([JDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=jcfg)
    tinsert([TDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=tcfg)
    yield jcfg, tcfg, t_encoder
    patch.undo()


def test_slice_from_graphs_matches_eager_and_jax(configs, fake_capture) -> None:
    """vector_search, vector_search_batch and rerank_chunks through the
    graph path (the test double) equal the eager programs exactly and the
    JAX package's ids (scores within rtol 1e-4: f16 query embeddings)."""
    jcfg, tcfg, t_encoder = configs
    index = dense_index_from_config(tcfg)
    for programs in (t_encoder.programs, index.programs):
        programs.captures = True
    t_encoder._rerank_cache.clear()
    try:
        for query in QUERIES:
            got = tsearch.vector_search(query, num_results=6, config=tcfg)
            with graphs.eager_programs():
                assert tsearch.vector_search(query, num_results=6, config=tcfg) == got
            want = jsearch.vector_search(query, num_results=6, config=jcfg)
            assert got[0] == want[0]
            np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
            chunks = tsearch.retrieve_chunks(got[0], config=tcfg)
            reranked = [c.id for c in tsearch.rerank_chunks(query, chunks, config=tcfg)]
            with graphs.eager_programs():
                assert [c.id for c in tsearch.rerank_chunks(query, chunks, config=tcfg)] == reranked
            j_chunks = jsearch.retrieve_chunks(want[0], config=jcfg)
            assert reranked == [c.id for c in jsearch.rerank_chunks(query, j_chunks, config=jcfg)]
        batch = tsearch.vector_search_batch(list(QUERIES), num_results=6, config=tcfg)
        with graphs.eager_programs():
            assert tsearch.vector_search_batch(list(QUERIES), num_results=6, config=tcfg) == batch
        for got, want in zip(batch, jsearch.vector_search_batch(list(QUERIES), num_results=6, config=jcfg), strict=True):
            assert got[0] == want[0]
            np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
        kinds = {key[0] for key in t_encoder.programs._entries}
        assert {"tokens", "pooled", "norm", "score"} <= kinds
        assert t_encoder.programs.counts["replayed"] > 0 and index.programs.counts["replayed"] > 0
    finally:
        for programs in (t_encoder.programs, index.programs):
            programs.captures = False
            programs.clear()


def test_rerank_threads_equal_sequential(configs, fake_capture) -> None:
    """Four threads reranking at once (shared cache, one program lock)
    give the calls made one after the other."""
    _, tcfg, t_encoder = configs
    t_encoder.programs.captures = True
    try:
        lists = [tsearch.retrieve_chunks(tsearch.vector_search(q, num_results=8, config=tcfg)[0], config=tcfg) for q in QUERIES]
        calls = [(q, lst) for q, lst in zip(QUERIES, lists)] * 2
        t_encoder._rerank_cache.clear()
        want = [[c.id for c in tsearch.rerank_chunks(q, lst, config=tcfg)] for q, lst in calls]
        t_encoder._rerank_cache.clear()
        got: dict[int, list[str]] = {}

        def run(i: int) -> None:
            q, lst = calls[i]
            got[i] = [c.id for c in tsearch.rerank_chunks(q, lst, config=tcfg)]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [got[i] for i in range(len(calls))] == want
    finally:
        t_encoder.programs.captures = False
        t_encoder.programs.clear()
