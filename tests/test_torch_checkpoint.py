"""The port's orbax ``ckpt:`` reader and writer (models/checkpoint.py over
models/ocdbt.py and the native zstd, without orbax, tensorstore or JAX)
against the JAX package's models/checkpoint.py (orbax over tensorstore),
both ways, on the CPU.  On the port's side tensorstore, ml_dtypes,
zstandard and orbax are made unimportable.

Tolerances: parameters read equal to what was written, bit for bit (bf16
as its 2-byte words); logits of the same f32 weights within 1e-4 (the
decoder tests' summation-order tolerance), greedy text equal; encoder
embeddings within 1e-4.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ts = pytest.importorskip("tensorstore")
ocp = pytest.importorskip("orbax.checkpoint")

from raglite_tpu.models import decoder as jdec  # noqa: E402
from raglite_tpu.models.checkpoint import load_checkpoint as jload  # noqa: E402
from raglite_tpu.models.checkpoint import save_checkpoint as jsave  # noqa: E402
from raglite_tpu.models.encoder import TransformerEncoder as JEncoder  # noqa: E402
from raglite_tpu_torch.models import decoder as tdec  # noqa: E402
from raglite_tpu_torch.models.checkpoint import _read_array, load_checkpoint, save_checkpoint  # noqa: E402
from raglite_tpu_torch.models.encoder import TransformerEncoder as TEncoder  # noqa: E402
from raglite_tpu_torch.models.ocdbt import OcdbtReader, OcdbtWriter  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "orbax_tiny"
TOL = 1e-4
TEXTS = ["the speed of light", "a dense index over chunks", ""]
MESSAGES = [{"role": "user", "content": "hi there"}]
#: What the card's machine lacks; the port's side must not need them.
STORAGE_PACKAGES = ("tensorstore", "ml_dtypes", "zstandard", "orbax")


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
        np.testing.assert_array_equal(x, y, err_msg=str(key))


def _logits(model, params, ids, *, jax_side: bool):
    if jax_side:
        out, _ = model.forward(params, jnp.asarray(ids, jnp.int32), model.init_cache(1, 32, dtype=jnp.float32),
                               jnp.asarray(0, jnp.int32))
        return np.asarray(out)
    out, _ = model.forward(params, torch.from_numpy(ids), model.init_cache(1, 32, dtype=torch.float32), 0)
    return out.numpy()


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
def test_jax_decoder_checkpoint_loads_into_the_port(tmp_path) -> None:
    j_llm = jdec.JaxChatLLM("tiny", seed=3, dtype=jnp.float32)
    j_llm.save_checkpoint(str(tmp_path / "dec"))
    with _without_storage_packages():
        tree, cfg = load_checkpoint(tmp_path / "dec")
        t_llm = tdec.TorchChatLLM(f"ckpt:{tmp_path / 'dec'}", device="cpu", dtype=torch.float32)
    assert cfg == j_llm.cfg and isinstance(tree["layers"], list) and len(tree["layers"]) == cfg["layers"]
    np.testing.assert_array_equal(tree["layers"][1]["wq"], np.asarray(j_llm.params["layers"][1]["wq"]))
    restored = jdec.JaxChatLLM(f"ckpt:{tmp_path / 'dec'}", dtype=jnp.float32)
    ids = np.random.default_rng(0).integers(3, 259, (1, 20))
    np.testing.assert_allclose(
        _logits(t_llm.model, t_llm.params, ids, jax_side=False),
        _logits(restored.model, restored.params, ids, jax_side=True), rtol=TOL, atol=TOL,
    )
    assert t_llm.complete(MESSAGES, max_tokens=12).content == restored.complete(MESSAGES, max_tokens=12).content


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
@pytest.mark.parametrize("kind", ["decoder-f32", "decoder-bf16", "encoder"])
def test_jax_checkpoints_read_bit_for_bit(tmp_path, kind: str) -> None:
    """Every leaf of a JAX-written checkpoint (compressed zstd frames in
    orbax's OCDBT) equals the JAX package's own read of it."""
    if kind == "encoder":
        JEncoder("tiny", seed=6, dtype=jnp.bfloat16).save_checkpoint(str(tmp_path / "ck"))
    else:
        dtype = jnp.float32 if kind == "decoder-f32" else jnp.bfloat16
        jdec.JaxChatLLM("tiny", seed=7, dtype=dtype).save_checkpoint(str(tmp_path / "ck"))
    want, want_cfg = jload(tmp_path / "ck")
    with _without_storage_packages():
        got, cfg = load_checkpoint(tmp_path / "ck")
    assert cfg == want_cfg
    _assert_same_tree(got, want)


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_decoder_checkpoint_is_read_by_jax(tmp_path, dtype) -> None:
    t_llm = tdec.TorchChatLLM("tiny", seed=4, device="cpu", dtype=dtype)
    with _without_storage_packages():
        t_llm.save_checkpoint(str(tmp_path / "dec"))
    params, cfg = jload(tmp_path / "dec")
    assert cfg == t_llm.cfg
    _assert_same_tree(t_llm.params, params)
    # Both read the weights in their saved dtype; the f32 logits are
    # compared, and the greedy text in both dtypes.
    j_llm = jdec.JaxChatLLM(f"ckpt:{tmp_path / 'dec'}")
    back = tdec.TorchChatLLM(f"ckpt:{tmp_path / 'dec'}", device="cpu")
    assert back.params["tok_emb"].dtype == dtype
    if dtype == torch.float32:
        ids = np.random.default_rng(1).integers(3, 259, (1, 20))
        np.testing.assert_allclose(
            _logits(back.model, back.params, ids, jax_side=False),
            _logits(j_llm.model, j_llm.params, ids, jax_side=True), rtol=TOL, atol=TOL,
        )
    assert back.complete(MESSAGES, max_tokens=12).content == j_llm.complete(MESSAGES, max_tokens=12).content
    q = tdec.TorchChatLLM(f"ckpt:{tmp_path / 'dec'}@int8", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        q.save_checkpoint(str(tmp_path / "again"))


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
def test_encoder_checkpoints_both_ways(tmp_path) -> None:
    JEncoder("tiny", seed=5, dtype=jnp.float32).save_checkpoint(str(tmp_path / "jax_enc"))
    want = JEncoder(f"ckpt:{tmp_path / 'jax_enc'}", dtype=jnp.float32).embed(TEXTS)
    ours = TEncoder(f"ckpt:{tmp_path / 'jax_enc'}", device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(ours.embed(TEXTS), want, rtol=TOL, atol=TOL)
    ours.save_checkpoint(str(tmp_path / "port_enc"))
    back = JEncoder(f"ckpt:{tmp_path / 'port_enc'}", dtype=jnp.float32).embed(TEXTS)
    np.testing.assert_allclose(back, want, rtol=TOL, atol=TOL)


def test_load_and_save_without_tensorstore(tmp_path) -> None:
    """With tensorstore, ml_dtypes, zstandard and orbax unimportable, the
    port writes a checkpoint and reads it back equal bit for bit."""
    llm = tdec.TorchChatLLM("tiny", seed=8, device="cpu")
    with _without_storage_packages():
        llm.save_checkpoint(str(tmp_path / "dec"))
        tree, cfg = load_checkpoint(tmp_path / "dec")
        back = tdec.TorchChatLLM(f"ckpt:{tmp_path / 'dec'}", device="cpu")
    assert cfg == llm.cfg
    _assert_same_tree(tree, llm.params)
    _assert_same_tree(back.params, llm.params)
    assert back.complete(MESSAGES, max_tokens=8).content == llm.complete(MESSAGES, max_tokens=8).content


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
def test_scalar_and_int32_leaves_both_ways(tmp_path) -> None:
    """0-d leaves (chunk key ``0``), int32, f32 and bf16 leaves and a list
    of dicts, written by either package and read by the other."""
    tree = {
        "step": np.asarray(12345, np.int32), "scale": np.asarray(0.5, np.float32),
        "ids": np.arange(-3, 7, dtype=np.int32),
        "blocks": [{"w": np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)} for _ in range(2)],
    }
    jsave(tmp_path / "jax", jax.tree.map(jnp.asarray, tree), {"kind": "test"})
    want, _ = jload(tmp_path / "jax")
    with _without_storage_packages():
        got, cfg = load_checkpoint(tmp_path / "jax")
    assert cfg == {"kind": "test"}
    _assert_same_tree(got, want)
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    ours = {**tree, "bf16": torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16) / 3}
    with _without_storage_packages():
        save_checkpoint(tmp_path / "port", ours, {"kind": "test"})
    back, _ = jload(tmp_path / "port")
    _assert_same_tree(ours, back)


def _tensorstore_array(root: Path, name: str, data: np.ndarray, chunks: list[int], *, skip: tuple = (),
                       separator: str = ".") -> None:
    """``data`` written by tensorstore's zarr driver into an OCDBT kvstore
    in chunks of ``chunks`` (edge chunks padded, as zarr v2 stores them);
    the chunk at index ``skip`` stays unwritten (its fill value)."""
    spec = {
        "driver": "zarr",
        "kvstore": {"driver": "ocdbt", "base": f"file://{root}/", "path": f"{name}/"},
        "metadata": {
            "shape": list(data.shape), "chunks": chunks, "dtype": data.dtype.str, "fill_value": 7,
            "compressor": {"id": "zstd", "level": 3}, "dimension_separator": separator,
        },
    }
    array = ts.open(spec, create=True, delete_existing=True).result()
    mask = np.ones(data.shape, bool)
    if skip:
        mask[tuple(slice(i * c, (i + 1) * c) for i, c in zip(skip, chunks))] = False
    for index in np.ndindex(*[-(-s // c) for s, c in zip(data.shape, chunks)]):
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, data.shape))
        if index != skip:
            array[region].write(data[region]).result()


@pytest.mark.parametrize("separator", [".", "/"])
def test_multi_chunk_arrays(tmp_path, separator: str) -> None:
    """Arrays that tensorstore wrote in several chunks, partial edge
    chunks and an absent chunk (the fill value) among them."""
    rng = np.random.default_rng(2)
    data = rng.integers(-1000, 1000, (37, 29)).astype(np.int32)
    _tensorstore_array(tmp_path, "grid", data, [8, 10], skip=(1, 2), separator=separator)
    floats = rng.standard_normal((3, 70, 5)).astype("<f4")
    _tensorstore_array(tmp_path, "cube", floats, [2, 32, 5], separator=separator)
    want = np.where(np.arange(37)[:, None] // 8 == 1, 1, 0) * np.where(np.arange(29)[None] // 10 == 2, 1, 0)
    want = np.where(want.astype(bool), 7, data)
    with _without_storage_packages(), OcdbtReader(tmp_path) as store:
        grid, cube = _read_array(store, "grid"), _read_array(store, "cube")
    np.testing.assert_array_equal(grid.numpy(), want)
    np.testing.assert_array_equal(cube.numpy(), floats)


def test_deep_trees_both_ways(tmp_path) -> None:
    """B+trees with interior nodes: tensorstore's read by the port (the
    walk's height > 0) and the port's (split at a small node size) read by
    tensorstore."""
    values = {f"layers.{i}.w/{j}.0": bytes([i, j]) * (3 + (7 * i + j) % 40) for i in range(40) for j in range(3)}
    values["tok_emb/0.0"] = np.arange(5000, dtype=np.uint16).tobytes()
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path / 'ts'}/",
        "config": {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16},
    }).result()
    txn = ts.Transaction()
    for key, value in values.items():
        kv.with_transaction(txn).write(key, value).result()
    txn.commit_async().result()
    with _without_storage_packages(), OcdbtReader(tmp_path / "ts") as store:
        assert store.height > 0
        assert store.keys() == sorted(values)
        assert all(store.get(k) == v for k, v in values.items())
    with _without_storage_packages():
        writer = OcdbtWriter(tmp_path / "port", max_decoded_node_bytes=400, max_inline_value_bytes=16)
        for key, value in values.items():
            writer.put(key, value)
        height = writer.commit()
    assert height >= 2
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path / 'port'}/"}).result()
    assert sorted(k.decode() for k in kv.list().result()) == sorted(values)
    assert all(kv.read(k).result().value == v for k, v in values.items())
    assert OcdbtReader(tmp_path / "port").height == height


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
def test_directory_layout_without_ocdbt(tmp_path) -> None:
    """orbax's ``use_ocdbt=False`` layout: one zarr directory per leaf."""
    params = jdec.init_decoder_params(jdec.JaxChatLLM._PRESETS["tiny"], seed=9, dtype=jnp.bfloat16)
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)) as checkpointer:
        checkpointer.save(tmp_path / "ck" / "params", params)
    (tmp_path / "ck" / "config.json").write_text(json.dumps(jdec.JaxChatLLM._PRESETS["tiny"]))
    assert not (tmp_path / "ck" / "params" / "manifest.ocdbt").exists()
    want, _ = jload(tmp_path / "ck")
    with _without_storage_packages():
        got, _ = load_checkpoint(tmp_path / "ck")
    _assert_same_tree(got, want)


def _fixture_module():
    spec = importlib.util.spec_from_file_location("orbax_fixture", ROOT / "scripts" / "orbax_fixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
def test_committed_fixture_matches_the_jax_package() -> None:
    """tests/data/orbax_tiny (scripts/orbax_fixture.py) holds the weights
    the JAX package draws for it, as both packages read them; its f32
    logits agree."""
    fixture = _fixture_module()
    with _without_storage_packages():
        got, cfg = load_checkpoint(FIXTURE)
        llm = tdec.TorchChatLLM(f"ckpt:{FIXTURE}", device="cpu")
    assert cfg == fixture.CONFIG
    want, _ = jload(FIXTURE)
    _assert_same_tree(got, want)
    _assert_same_tree(got, fixture.fixture_params())
    sizes = {k: v.numel() * v.element_size() for k, v in _flat(got).items()}
    assert max(sizes.values()) > 128 * 1024 and got["final_norm"].dtype == torch.float32
    j_model = jdec.DecoderModel(cfg)
    j_params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), want)
    t_params = tdec.params_from_jax(got, dtype=torch.float32)
    ids = np.random.default_rng(3).integers(3, 259, (1, 24))
    np.testing.assert_allclose(
        _logits(llm.model, t_params, ids, jax_side=False), _logits(j_model, j_params, ids, jax_side=True),
        rtol=TOL, atol=TOL,
    )
