"""The port's ``ckpt:`` reader (models/checkpoint.py over models/ocdbt.py,
native/zstd.cpp and native/blosc.cpp) on every layout the JAX package's
``load_checkpoint`` restores through orbax and tensorstore, on the CPU:

- the committed fixtures (scripts/orbax_layout_fixtures.py: zarr v3 in
  orbax's sharded layout and in tensorstore's others, zarr v2 with Blosc,
  gzip, zlib and bz2, big-endian and F-order arrays, numbered OCDBT
  manifests) read bit for bit as the JAX package restores them, and through
  ``ckpt:`` / ``flax:ckpt:`` in both packages;
- a zarr v3 encoder served through ``flax:ckpt:`` by both packages;
- chip_smoke.py's zarr v3 writer, restored by the JAX package;
- arrays tensorstore writes here (every zarr v3 data type and fill value,
  Blosc's codecs, shuffles and block sizes, byte orders, a long numbered
  OCDBT history) against tensorstore's own read;
- corrupt checksums, missing chunks and codecs outside the list, which
  raise.

On the port's side tensorstore, ml_dtypes, zstandard and orbax are made
unimportable.  Tolerances: leaves bit for bit (bf16 as its 2-byte words);
vector_search ids equal and scores within rtol 1e-4 (query embeddings are
f16 in both packages).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ts = pytest.importorskip("tensorstore")
pytest.importorskip("orbax.checkpoint")

from raglite_tpu import RAGLiteConfig as JConfig  # noqa: E402
from raglite_tpu.documents import Document as JDocument  # noqa: E402
from raglite_tpu.insert import insert_documents as jinsert  # noqa: E402
from raglite_tpu.models import decoder as jdec  # noqa: E402
from raglite_tpu.models import encoder as jenc  # noqa: E402
from raglite_tpu.models.checkpoint import load_checkpoint as jload  # noqa: E402
from raglite_tpu.search import vector_search as jvector_search  # noqa: E402
from raglite_tpu_torch import RAGLiteConfig as TConfig  # noqa: E402
from raglite_tpu_torch import native  # noqa: E402
from raglite_tpu_torch.documents import Document as TDocument  # noqa: E402
from raglite_tpu_torch.insert import insert_documents as tinsert  # noqa: E402
from raglite_tpu_torch.models import decoder as tdec  # noqa: E402
from raglite_tpu_torch.models import encoder as tenc  # noqa: E402
from raglite_tpu_torch.models.checkpoint import _read_array, load_checkpoint  # noqa: E402
from raglite_tpu_torch.models.ocdbt import DirectoryStore, OcdbtReader  # noqa: E402
from raglite_tpu_torch.search import vector_search as tvector_search  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "orbax_layouts"
sys.path.insert(0, str(ROOT))
fixtures = importlib.import_module("scripts.orbax_layout_fixtures")
chip_smoke = importlib.import_module("chip_smoke")
STORAGE_PACKAGES = ("tensorstore", "ml_dtypes", "zstandard", "orbax")
SCORE_RTOL = 1e-4
QUERIES = ("Which layouts does the checkpoint reader take?", "How is the dense index searched?", "numbered manifests")

pytestmark = pytest.mark.filterwarnings("ignore:Sharding info not provided", "ignore:Couldn't find sharding info")


@contextlib.contextmanager
def _without_storage_packages():
    with pytest.MonkeyPatch.context() as m:
        for name in STORAGE_PACKAGES:
            m.setitem(sys.modules, name, None)
        yield


def _bits(x) -> np.ndarray:
    """A leaf's stored values (bf16 as uint16 words), for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], (*prefix, str(key))).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, (*prefix, str(i))).items()}
    return {prefix: tree}


def _assert_same_tree(ours, theirs) -> None:
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = _bits(a[key]), _bits(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, (key, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(_raw(x), _raw(y), err_msg=str(key))


def _raw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _copy(layout: str, tmp_path: Path) -> Path:
    return Path(shutil.copytree(FIXTURES / layout, tmp_path / layout))


# --- The committed fixtures ---------------------------------------------------------


def _layout_facts(root: Path) -> set[str]:
    """What a fixture's files show of its layout (so that a regenerated
    fixture still holds what its name says)."""
    params = root / "params"
    meta = json.loads((params / "_METADATA").read_text())
    facts = {"zarr3" if meta["use_zarr3"] else "zarr2", "ocdbt" if meta["use_ocdbt"] else "directory"}
    if sorted(params.glob("manifest.0*")):
        facts.add("numbered")
    store = OcdbtReader(params) if meta["use_ocdbt"] else DirectoryStore(params)
    with store:
        names = [".".join(k["key"] for k in e["key_metadata"]) for e in meta["tree_metadata"].values()]
        for name in names:
            raw = store.get(f"{name}/{'zarr.json' if meta['use_zarr3'] else '.zarray'}")
            text = raw.decode()
            for word in ("sharding_indexed", "transpose", '"big"', "gzip", "blosc", "crc32c", "zlib", "bz2", '"F"',
                         ">f4", ">i4", '"start"', '"v2"', "NaN", "lz4", "blosclz", "snappy", "zstd", "lz4hc"):
                if word in text:
                    facts.add(word.strip('"'))
    return facts


LAYOUT_FACTS = {
    "zarr3_ocdbt": {"zarr3", "ocdbt", "sharding_indexed", "zstd", "crc32c"},
    "zarr3_sharded": {"zarr3", "directory", "sharding_indexed", "transpose", "big", "gzip", "crc32c", "start"},
    "zarr3_blosc": {"zarr3", "ocdbt", "blosc", "crc32c", "v2", "NaN", "big", "lz4", "zstd", "blosclz"},
    "zarr2_blosc": {"zarr2", "directory", "blosc", "lz4", "lz4hc", "blosclz", "snappy", "zlib", "zstd"},
    "zarr2_stdlib": {"zarr2", "ocdbt", "gzip", "zlib", "bz2"},
    "zarr2_bigendian_f": {"zarr2", "directory", "F", ">f4", ">i4"},
    "ocdbt_numbered": {"zarr2", "ocdbt", "numbered", "zstd"},
}


@pytest.mark.parametrize("layout", fixtures.LAYOUTS)
def test_fixture_reads_bit_for_bit(layout: str) -> None:
    """Every leaf of each committed fixture equals the JAX package's restore
    and the values the fixture script draws, bit for bit; the fixture holds
    the layout its name says."""
    root = FIXTURES / layout
    assert LAYOUT_FACTS[layout] <= _layout_facts(root), _layout_facts(root)
    want, want_cfg = jload(root)
    with _without_storage_packages():
        got, cfg = load_checkpoint(root)
    assert cfg == want_cfg
    _assert_same_tree(got, want)
    tree, config = fixtures.fixture_tree(layout)
    assert cfg == config
    _assert_same_tree(got, tree)


@pytest.mark.parametrize("layout", fixtures.LAYOUTS)
def test_fixture_loads_through_ckpt(layout: str) -> None:
    """Each fixture loads as ``ckpt:`` (a decoder) or ``flax:ckpt:`` (an
    encoder) in both packages; the port's model holds the JAX package's
    weights (f32 logits or embeddings within 1e-4)."""
    root = FIXTURES / layout
    tree, cfg = fixtures.fixture_tree(layout)
    if "tok_emb" in tree and "lm_head" in tree:
        j_llm = jdec.JaxChatLLM(f"ckpt:{root}", dtype=np.float32)
        with _without_storage_packages():
            t_llm = tdec.TorchChatLLM(f"ckpt:{root}", device="cpu")
        assert t_llm.cfg == j_llm.cfg == cfg
        assert t_llm.params["tok_emb"].dtype == torch.bfloat16
        _assert_same_tree(t_llm.params["layers"], j_llm.params["layers"])
        ids = np.random.default_rng(1).integers(3, 259, (1, 12))
        t_params = tdec.params_from_jax(t_llm.params, dtype=torch.float32)
        t_logits, _ = t_llm.model.forward(t_params, torch.from_numpy(ids), t_llm.model.init_cache(1, 16, dtype=torch.float32), 0)
        j_params = {k: np.asarray(v, np.float32) if k != "layers" else [{n: np.asarray(w, np.float32) for n, w in layer.items()}
                                                                       for layer in v] for k, v in j_llm.params.items()}
        j_logits, _ = j_llm.model.forward(j_params, ids.astype(np.int32), j_llm.model.init_cache(1, 16, dtype=np.float32), 0)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    else:
        j_enc, t_enc = _f32_encoders(f"flax:ckpt:{root}")
        assert t_enc._cfg == j_enc._cfg == cfg
        np.testing.assert_allclose(t_enc.embed(list(QUERIES)), j_enc.embed(list(QUERIES)), rtol=1e-4, atol=1e-4)


def _f32_encoders(embedder: str):
    """The JAX package's and the port's encoders of ``flax:ckpt:<dir>``,
    each computing in f32 (both read the saved bf16 matrices; the JAX one
    keeps that dtype, so its tree is cast here)."""
    spec = embedder.removeprefix("flax:")
    j_enc = jenc.TransformerEncoder(spec)
    j_enc._params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), j_enc._params)
    with _without_storage_packages():
        t_enc = tenc.TransformerEncoder(spec, device="cpu", dtype=torch.float32)
    return j_enc, t_enc


def test_zarr3_encoder_serves_the_jax_packages_ids(tmp_path, monkeypatch) -> None:
    """The slice on the CPU: the zarr v3 fixture (orbax's sharded layout in
    OCDBT) served as ``flax:ckpt:<dir>`` by both packages over the same
    documents (each encoder in f32); vector_search ids equal, scores within
    SCORE_RTOL."""
    spec = f"flax:ckpt:{FIXTURES / 'zarr3_ocdbt'}"
    j_enc, t_enc = _f32_encoders(spec)
    made = []
    monkeypatch.setattr(jenc, "_make_encoder", lambda embedder: made.append(embedder) or j_enc)
    monkeypatch.setattr(tenc, "_make_encoder", lambda embedder, device: made.append(embedder) or t_enc)
    jcfg = JConfig(store_path=str(tmp_path / "jax"), embedder=spec, chunk_max_size=1024)
    tcfg = TConfig(store_path=str(tmp_path / "torch"), embedder=spec, chunk_max_size=1024, device="cpu")
    texts = [(ROOT / name).read_text(encoding="utf-8") for name in ("MIGRATION.md", "BASELINE.md")]
    jinsert([JDocument.from_text(t, id=str(i)) for i, t in enumerate(texts)], config=jcfg)
    with _without_storage_packages():
        tinsert([TDocument.from_text(t, id=str(i)) for i, t in enumerate(texts)], config=tcfg)
    assert set(made) == {spec}
    for query in QUERIES:
        (t_ids, t_scores), (j_ids, j_scores) = tvector_search(query, num_results=8, config=tcfg), jvector_search(
            query, num_results=8, config=jcfg)
        assert t_ids == j_ids and len(t_ids) == 8
        np.testing.assert_allclose(t_scores, j_scores, rtol=SCORE_RTOL)


def test_chip_smoke_zarr3_writer_is_restored_by_the_jax_package(tmp_path) -> None:
    """chip_smoke.write_zarr3_checkpoint (the layout phase 10 (f) writes on
    the card) is orbax's zarr v3 OCDBT checkpoint: the JAX package restores
    it equal to what was written, as the port reads it."""
    tree, cfg = fixtures.fixture_tree("zarr2_blosc")  # bf16, f32, int32 and 0-d leaves

    def to_torch(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype.name == "bfloat16" else torch.from_numpy(a)

    torch_tree = {k: to_torch(v) for k, v in tree.items() if k != "layers"}
    torch_tree["layers"] = [{k: to_torch(v) for k, v in layer.items()} for layer in tree["layers"]]
    with _without_storage_packages():
        size = chip_smoke.write_zarr3_checkpoint(tmp_path / "ck", torch_tree, cfg)
        got, got_cfg = load_checkpoint(tmp_path / "ck")
    assert size > 0 and got_cfg == cfg and json.loads((tmp_path / "ck" / "params" / "_METADATA").read_text())["use_zarr3"]
    want, want_cfg = jload(tmp_path / "ck")
    assert want_cfg == cfg
    _assert_same_tree(want, tree)
    _assert_same_tree(got, tree)


# --- Faults ---------------------------------------------------------------------------


def test_corrupt_crc32c_raises(tmp_path) -> None:
    """A flipped byte under a crc32c (a shard's index; a whole chunk) raises
    in both packages; nothing is returned."""
    root = _copy("zarr3_sharded", tmp_path)
    shard = root / "params" / "tok_emb" / "c" / "1" / "0"
    data = bytearray(shard.read_bytes())
    data[3] ^= 0x40  # inside the index at the start
    shard.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="crc32c mismatch"):
        load_checkpoint(root)
    with pytest.raises(ValueError):
        jload(root)
    root = _copy("zarr3_blosc", tmp_path)
    with OcdbtReader(root / "params") as store:
        path, offset, length = store._entries[b"tok_emb/c.0.0"]
    with open(root / "params" / path, "r+b") as f:
        f.seek(offset + 20)
        byte = f.read(1)[0]
        f.seek(offset + 20)
        f.write(bytes([byte ^ 1]))
    with pytest.raises(ValueError, match="crc32c mismatch"):
        load_checkpoint(root)


def test_missing_chunks_follow_the_metadata(tmp_path) -> None:
    """Empty inner chunks read as the fill value where ``_METADATA`` allows
    them (the fixture), and raise in both packages where it says that every
    chunk was stored (orbax's default)."""
    root = _copy("zarr3_sharded", tmp_path)
    meta_path = root / "params" / "_METADATA"
    meta = json.loads(meta_path.read_text())
    assert meta["store_array_data_equal_to_fill_value"] is False
    got, _ = load_checkpoint(root)
    assert not got["tok_emb"][:16].any()
    meta["store_array_data_equal_to_fill_value"] = True
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(root)
    with pytest.raises(ValueError):
        jload(root)


@pytest.mark.parametrize(("layout", "leaf", "edit", "named"), [
    ("zarr3_sharded", "layers.0.wq", lambda m: m["codecs"][0]["configuration"]["codecs"].append({"name": "lz4"}), "lz4"),
    ("zarr3_sharded", "layers.0.wq", lambda m: m["codecs"].append({"name": "zstd"}), "after sharding_indexed"),
    ("zarr3_sharded", "layers.0.wq", lambda m: m.update(data_type="float8_e4m3fn"), "float8_e4m3fn"),
    ("zarr3_sharded", "layers.0.wq", lambda m: m.update(chunk_grid={"name": "rectilinear"}), "rectilinear"),
    ("zarr3_sharded", "layers.0.wq", lambda m: m.update(chunk_key_encoding={"name": "nested"}), "nested"),
    ("zarr3_sharded", "layers.0.wq", lambda m: m["codecs"][0]["configuration"].update(index_location="middle"), "middle"),
    ("zarr2_blosc", "layers.0.wq", lambda m: m.update(compressor={"id": "lzma"}), "lzma"),
    ("zarr2_blosc", "layers.0.wq", lambda m: m.update(filters=[{"id": "delta", "dtype": "<f4"}]), "delta"),
    ("zarr2_blosc", "layers.0.wq", lambda m: m.update(dtype="<M8[s]"), "M8"),
], ids=["codec", "codec-after-shard", "data-type", "chunk-grid", "chunk-keys", "index-location", "compressor", "filters", "dtype"])
def test_unlisted_formats_raise_naming_them(tmp_path, layout, leaf, edit, named) -> None:
    root = _copy(layout, tmp_path)
    path = root / "params" / leaf / ("zarr.json" if layout.startswith("zarr3") else ".zarray")
    meta = json.loads(path.read_text())
    edit(meta)
    path.write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match=named):
        load_checkpoint(root)


def test_unknown_blosc_codec_and_truncation_raise() -> None:
    """A Blosc container naming a codec outside the list raises
    NotImplementedError naming it; a truncated one raises ValueError."""
    data = np.random.default_rng(0).integers(0, 4, 4096).astype(np.uint8)
    raw = _blosc_chunk(data, "lz4", 1, 0)
    native.blosc_decompress(raw, np.empty(4096, np.uint8))
    assert not raw[2] & 0x2  # compressed, not stored
    odd = bytearray(raw)
    odd[2] = (odd[2] & 0x1F) | (6 << 5)
    with pytest.raises(NotImplementedError, match="codec 6"):
        native.blosc_decompress(bytes(odd), np.empty(4096, np.uint8))
    with pytest.raises(ValueError):
        native.blosc_decompress(raw[: len(raw) // 2], np.empty(4096, np.uint8))
    with pytest.raises(ValueError, match="expected"):
        native.blosc_decompress(raw, np.empty(4095, np.uint8))


# --- Arrays tensorstore writes here --------------------------------------------------


def _blosc_chunk(data: np.ndarray, cname: str, shuffle: int, blocksize: int) -> bytes:
    """``data`` (1-D) as tensorstore's zarr v2 Blosc chunk."""
    spec = {"driver": "zarr", "kvstore": "memory://", "metadata": {
        "shape": list(data.shape), "chunks": list(data.shape), "dtype": data.dtype.str,
        "compressor": {"id": "blosc", "cname": cname, "clevel": 5, "shuffle": shuffle, "blocksize": blocksize}}}
    context = ts.Context()
    ts.open(spec, create=True, context=context).result().write(data).result()
    kv = ts.KvStore.open("memory://", context=context).result()
    return kv.read(b"0").result().value


@pytest.mark.parametrize("cname", ["blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd"])
def test_blosc_codecs_shuffles_and_blocks(cname: str) -> None:
    """native.blosc_decompress against the bytes tensorstore compressed:
    each shuffle, automatic and 256-byte blocks (a leftover last block),
    1-, 2-, 4- and 8-byte types, compressible, incompressible (stored) and
    constant data."""
    rng = np.random.default_rng(7)
    compressed = 0
    for dtype in ("|u1", "<i2", "<f4", "<f8"):
        for kind in ("levels", "noise", "constant"):
            n = 3000 + 13 * len(kind)
            values = {"levels": rng.integers(-6, 6, n), "noise": rng.standard_normal(n) * 1e3, "constant": np.full(n, 3)}[kind]
            data = values.astype(dtype)
            for shuffle in (0, 1, 2):
                for blocksize in (0, 256):
                    raw = _blosc_chunk(data, cname, shuffle, blocksize)
                    compressed += not raw[2] & 0x2
                    out = native.blosc_decompress(raw, np.empty(data.nbytes, np.uint8))
                    assert out.tobytes() == data.tobytes(), (dtype, kind, shuffle, blocksize)
    assert compressed >= 24


V3_FILLS = {
    "bool": [True], "int8": [-7], "int16": [300], "int32": [-5], "int64": [1 << 40], "uint8": [200],
    "uint16": [65000], "uint32": [4000000000], "uint64": [1 << 63], "float16": ["NaN", 1.5],
    "bfloat16": ["Infinity", "0x7fc1", -2.5], "float32": ["NaN", "-Infinity", "0x7f800001", 0.25],
    "float64": ["0x7ff8000000000001", 1e300], "complex64": [[1.5, "NaN"], ["0x3f800000", -2.0]],
    "complex128": [["Infinity", 0.5]],
}


@pytest.mark.parametrize("data_type", list(V3_FILLS))
def test_zarr3_data_types_and_fill_values(tmp_path, data_type: str) -> None:
    """Every zarr v3 data type in both byte orders, with each encoding of
    its fill value in an absent chunk, against tensorstore's read."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    np_type = ml_dtypes.bfloat16 if data_type == "bfloat16" else np.dtype(data_type)
    if data_type == "bool":
        values = rng.integers(0, 2, (9, 7))
    elif data_type.startswith("complex"):
        values = rng.integers(-50, 50, (9, 7)) + 1j * rng.integers(-50, 50, (9, 7))
    else:
        values = rng.integers(0 if data_type.startswith("uint") else -50, 50, (9, 7))
    data = values.astype(np_type)
    for i, fill in enumerate(V3_FILLS[data_type]):
        for endian in ("little", "big"):
            name = f"a{i}{endian}"
            codecs = [{"name": "bytes", "configuration": {"endian": endian}}]
            if np.dtype(np_type).itemsize == 1:
                codecs = [{"name": "bytes"}]
            spec = {"driver": "zarr3", "kvstore": f"file://{tmp_path}/{name}/", "metadata": {
                "shape": [9, 7], "data_type": data_type, "fill_value": fill, "codecs": codecs,
                "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [4, 4]}}}}
            array = ts.open(spec, create=True).result()
            array[:4, :4].write(data[:4, :4]).result()
            array[4:, :].write(data[4:, :]).result()  # chunk (0, 1) stays absent
            want = array.read().result()
            with DirectoryStore(tmp_path) as store:
                got = _read_array(store, name, zarr3=True)
            np.testing.assert_array_equal(_raw(_bits(got)), _raw(_bits(want)), err_msg=f"{data_type} {fill!r} {endian}")


@pytest.mark.parametrize("dtype", ["<i2", ">i2", ">u4", ">i8", ">f2", ">f4", ">f8", ">c8", ">c16", "|b1", "bfloat16"])
def test_zarr2_byte_orders_and_orders(tmp_path, dtype: str) -> None:
    """zarr v2 arrays of each dtype in both orders (3-D, partial edge chunks
    in every dimension), zlib-compressed, against tensorstore's read."""
    import ml_dtypes

    rng = np.random.default_rng(4)
    np_type = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    data = (rng.integers(0, 2, (5, 7, 6)) if dtype == "|b1" else rng.integers(-99, 99, (5, 7, 6))).astype(np_type)
    for order in ("C", "F"):
        spec = {"driver": "zarr", "kvstore": f"file://{tmp_path}/{order}/", "metadata": {
            "shape": [5, 7, 6], "chunks": [2, 3, 4], "dtype": dtype, "order": order,
            "compressor": {"id": "zlib", "level": 1}}}
        ts.open(spec, create=True).result().write(data).result()
        with DirectoryStore(tmp_path) as store:
            got = _read_array(store, order)
        np.testing.assert_array_equal(_bits(got), _bits(data.astype(np.dtype(np_type).newbyteorder("="))))


def test_zarr3_transposes_nested_shards_and_chunk_keys(tmp_path) -> None:
    """zarr v3 arrays with a 3-D transpose inside a shard (index at the
    start), a shard of shards, each chunk key encoding and separator, and
    empty inner chunks, against tensorstore."""
    data = np.random.default_rng(5).integers(-1000, 1000, (12, 10, 9)).astype("<i4")
    data[:6, :5, :] = 0  # inner chunks equal to the fill value: left empty
    transposed = [{"name": "transpose", "configuration": {"order": [2, 0, 1]}},
                  {"name": "bytes", "configuration": {"endian": "big"}}, {"name": "zstd", "configuration": {"level": 3}}]
    layouts = {  # name: (chunk key encoding, chunk shape, codecs)
        "transposed": ({"name": "default"}, [6, 10, 9], [
            {"name": "sharding_indexed", "configuration": {"chunk_shape": [3, 5, 3], "codecs": transposed,
                                                           "index_location": "start"}}]),
        "nested": ({"name": "v2", "configuration": {"separator": "/"}}, [4, 6, 5], [
            {"name": "sharding_indexed", "configuration": {"chunk_shape": [2, 6, 5], "codecs": [
                {"name": "sharding_indexed", "configuration": {"chunk_shape": [2, 3, 5], "codecs": [{"name": "bytes"}]}}]}}]),
        "dotted": ({"name": "default", "configuration": {"separator": "."}}, [4, 6, 5], [
            {"name": "bytes"}, {"name": "gzip", "configuration": {"level": 1}}, {"name": "crc32c"}]),
    }
    for name, (keys, chunk, codecs) in layouts.items():
        spec = {"driver": "zarr3", "kvstore": f"file://{tmp_path}/{name}/", "metadata": {
            "shape": [12, 10, 9], "data_type": "int32", "chunk_key_encoding": keys, "codecs": codecs,
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": chunk}}}}
        ts.open(spec, create=True).result().write(data).result()
        with DirectoryStore(tmp_path) as store:
            got = _read_array(store, name, zarr3=True)
        np.testing.assert_array_equal(got.numpy(), data, err_msg=name)


def test_transpose_before_a_shard_is_refused(tmp_path) -> None:
    """tensorstore writes a transpose before ``sharding_indexed`` only where
    the transposed inner grid equals the untransposed one, and then in
    another order than the zarr v3 spec's (it reads its own back); the port
    refuses it rather than read other values than the JAX package."""
    data = np.arange(12 * 6 * 6, dtype="<i4").reshape(12, 6, 6)
    spec = {"driver": "zarr3", "kvstore": f"file://{tmp_path}/a/", "metadata": {
        "shape": [12, 6, 6], "data_type": "int32", "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [6, 6, 6]}},
        "codecs": [{"name": "transpose", "configuration": {"order": [2, 0, 1]}},
                   {"name": "sharding_indexed", "configuration": {"chunk_shape": [3, 3, 3], "codecs": [{"name": "bytes"}]}}]}}
    array = ts.open(spec, create=True).result()
    array.write(data).result()
    np.testing.assert_array_equal(array.read().result(), data)
    with DirectoryStore(tmp_path) as store, pytest.raises(NotImplementedError, match="transpose before sharding_indexed"):
        _read_array(store, "a", zarr3=True)


def test_numbered_manifests_over_a_long_history(tmp_path) -> None:
    """An OCDBT database with numbered manifests after 40 commits (a version
    tree past its inline leaf) reads the newest version's keys."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"manifest_kind": "numbered"}}).result()
    values = {}
    for i in range(40):
        values[f"k{i:02d}"] = bytes([i]) * (3 + 97 * (i % 5))
        kv.write(f"k{i:02d}", values[f"k{i:02d}"]).result()
    kv.write("k00", b"replaced").result()
    values["k00"] = b"replaced"
    assert len(list(tmp_path.glob("manifest.0*"))) > 16
    with _without_storage_packages(), OcdbtReader(tmp_path) as store:
        assert store.keys() == sorted(values)
        assert all(store.get(k) == v for k, v in values.items())
