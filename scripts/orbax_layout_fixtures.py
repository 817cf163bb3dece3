"""Write ``tests/data/orbax_layouts/<layout>/``: one small orbax checkpoint
per array and store layout that the JAX package's ``load_checkpoint``
restores through orbax and tensorstore, which the port's ``ckpt:`` reader
is held to bit for bit on the CPU (tests/test_torch_checkpoint_layouts.py)
and on the card (chip_smoke.py, phase 10 (f)).

Each fixture is a tiny decoder or encoder tree (so it also loads through
``ckpt:`` or ``flax:ckpt:``) that orbax saves; tensorstore then re-writes its
leaves in the fixture's layout (and, for ``ocdbt_numbered``, copies the
database into numbered manifests).  The decoders' trees carry two more
leaves, a 0-d int32 ``step`` and an int32 ``token_counts``.  The values come
from ``SEED`` with numpy, on few levels, so that the codecs find something
to compress:

- ``zarr3_ocdbt`` (encoder): orbax's ``use_zarr3=True`` as it writes it,
  in OCDBT: ``sharding_indexed`` with ``bytes`` and zstd inside and a
  crc32c index.
- ``zarr3_sharded`` (decoder, a directory per leaf): several shards a leaf,
  the index at the start, inner chunks coded ``transpose`` + big-endian
  ``bytes`` + gzip, empty inner chunks (the fill value; ``_METADATA`` says
  ``store_array_data_equal_to_fill_value: false``, else orbax refuses
  them), a nested shard.
- ``zarr3_blosc`` (encoder, OCDBT): ``bytes`` + ``blosc`` + ``crc32c`` in
  several chunks, ``v2`` and ``default`` chunk keys, big-endian f32 leaves,
  a ``"NaN"`` fill value.
- ``zarr2_blosc`` (decoder, a directory per leaf): Blosc with each inner
  codec (BloscLZ, LZ4, LZ4HC, Snappy, zlib, zstd) and each shuffle, blocks
  of 256 bytes and automatic ones, several chunks a leaf.
- ``zarr2_stdlib`` (encoder, OCDBT): gzip, zlib and bz2, ``.`` and ``/``
  chunk separators.
- ``zarr2_bigendian_f`` (decoder, a directory per leaf): ``>f4`` and
  ``>i4``, ``order: "F"``, partial edge chunks in both dimensions.
- ``ocdbt_numbered`` (decoder): orbax's default (zarr v2, zstd, OCDBT)
  copied into an OCDBT database with ``manifest_kind: numbered`` in three
  commits.

Usage (needs jax, orbax, tensorstore and ml_dtypes):
  JAX_PLATFORMS=cpu python scripts/orbax_layout_fixtures.py [--out tests/data/orbax_layouts]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DECODER = dict(layers=1, d_model=16, heads=2, kv_heads=1, d_ff=32, vocab=259, max_len=64)
ENCODER = dict(layers=1, d_model=16, heads=2, d_ff=32, vocab=259, max_len=128)
SEED = 18
LAYOUTS = (
    "zarr3_ocdbt", "zarr3_sharded", "zarr3_blosc", "zarr2_blosc", "zarr2_stdlib", "zarr2_bigendian_f",
    "ocdbt_numbered",
)
#: The Blosc variants of zarr2_blosc, cycled over its leaves: (inner codec,
#: shuffle: 0 none, 1 byte, 2 bit; block size, 0 for c-blosc's choice).
BLOSC_VARIANTS = (
    ("snappy", 1, 256), ("lz4", 1, 0), ("blosclz", 2, 256), ("lz4hc", 0, 256), ("zlib", 2, 0), ("zstd", 1, 256),
    ("lz4", 2, 256), ("blosclz", 1, 0),
)


def _bf16(values: np.ndarray) -> np.ndarray:
    import ml_dtypes

    return values.astype(ml_dtypes.bfloat16)


def _tree(cfg: dict, rng: np.random.Generator, *, encoder: bool) -> dict:
    """A model tree of the JAX package's layout: bf16 matrices on 16 levels,
    f32 vectors near 1 (scales) or 0 (biases) on 8 levels."""

    def matrix(*shape):
        return _bf16(rng.integers(-8, 8, shape) / 32)

    def vector(n, centre=1.0):
        return (centre + rng.integers(-4, 4, n) / 32).astype(np.float32)

    d, ff = cfg["d_model"], cfg["d_ff"]
    if encoder:
        layer = {f"w{x}": matrix(d, d) for x in "qkvo"}
        layer.update({f"b{x}": vector(d, 0.0) for x in "qkvo"})
        layer.update({
            "attn_ln_scale": vector(d), "attn_ln_bias": vector(d, 0.0), "w1": matrix(d, ff), "b1": vector(ff, 0.0),
            "w2": matrix(ff, d), "b2": vector(d, 0.0), "mlp_ln_scale": vector(d), "mlp_ln_bias": vector(d, 0.0),
        })
        return {
            "tok_emb": matrix(cfg["vocab"], d), "pos_emb": matrix(cfg["max_len"], d), "emb_ln_scale": vector(d),
            "emb_ln_bias": vector(d, 0.0), "layers": [layer], "final_ln_scale": vector(d), "final_ln_bias": vector(d, 0.0),
        }
    hd = d // cfg["heads"]
    layer = {
        "attn_norm": vector(d), "wq": matrix(d, cfg["heads"] * hd), "wk": matrix(d, cfg["kv_heads"] * hd),
        "wv": matrix(d, cfg["kv_heads"] * hd), "wo": matrix(cfg["heads"] * hd, d), "mlp_norm": vector(d),
        "w_gate": matrix(d, ff), "w_up": matrix(d, ff), "w_down": matrix(ff, d),
    }
    # Rows 0-15 of the embedding are zero: zarr3_sharded's inner chunks
    # there equal the fill value, and tensorstore leaves them empty.
    tok_emb = rng.integers(-8, 8, (cfg["vocab"], d)) / 32
    tok_emb[:16] = 0
    return {
        "tok_emb": _bf16(tok_emb), "final_norm": vector(d), "lm_head": matrix(d, cfg["vocab"]), "layers": [layer],
        "step": np.asarray(rng.integers(1, 1 << 30), np.int32),
        "token_counts": rng.integers(0, 1 << 20, cfg["vocab"]).astype(np.int32),
    }


def fixture_tree(layout: str) -> tuple[dict, dict]:
    """(parameter tree, config) of a layout's fixture, drawn from SEED."""
    encoder = layout in ("zarr3_ocdbt", "zarr3_blosc", "zarr2_stdlib")
    rng = np.random.default_rng([SEED, LAYOUTS.index(layout)])
    cfg = ENCODER if encoder else DECODER
    return _tree(cfg, rng, encoder=encoder), dict(cfg)


def _leaves(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, list):
            for i, item in enumerate(value):
                yield from _leaves(item, f"{prefix}{key}.{i}.")
        else:
            yield f"{prefix}{key}", value


def _dtype(value: np.ndarray, big: bool = False) -> str:
    if value.dtype.name == "bfloat16":
        return "bfloat16"
    return value.dtype.newbyteorder(">").str if big else value.dtype.str


def _v3_type(value: np.ndarray) -> str:
    return value.dtype.name


def _rewrite(kvstore, name: str, value: np.ndarray, metadata: dict, *, zarr3: bool, sparse: bool, context) -> None:
    """Write ``value`` as the array ``name/`` of ``kvstore`` (a spec, opened
    in ``context``) in tensorstore's layout of ``metadata``; chunks equal to
    the fill value are left out when ``sparse``."""
    import tensorstore as ts

    spec = {"driver": "zarr3" if zarr3 else "zarr", "kvstore": {**kvstore, "path": kvstore.get("path", "") + f"{name}/"},
            "metadata": {"shape": list(value.shape), **metadata}, "store_data_equal_to_fill_value": not sparse}
    ts.open(spec, create=True, delete_existing=True, context=context).result().write(value).result()


def _ocdbt_keys(params: Path) -> dict[bytes, bytes]:
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{params}/"}).result()
    return {key: kv.read(key).result().value for key in kv.list().result()}


def _new_ocdbt(params: Path, values: dict[bytes, bytes], commits: int = 1, config: dict | None = None) -> None:
    """Replace the OCDBT database of ``params`` by one holding ``values``,
    written in ``commits`` transactions (one data file each, no stale
    versions)."""
    import tensorstore as ts

    for path in list(params.iterdir()):
        if path.name in ("manifest.ocdbt", "d") or path.name.startswith("ocdbt.process_"):
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    spec = {"driver": "ocdbt", "base": f"file://{params}/", **({"config": config} if config else {})}
    target = ts.KvStore.open(spec).result()
    keys = sorted(values)
    for part in (keys[i::commits] for i in range(commits)):
        txn = ts.Transaction()
        for key in part:
            target.with_transaction(txn).write(key, values[key]).result()
        txn.commit_async().result()


def _chunks(shape, rows: int, cols: int) -> list[int]:
    return [min(s, c) for s, c in zip(shape, (rows, cols))] if shape else []


def _layout_leaf(layout: str, i: int, name: str, value: np.ndarray) -> dict:
    """The metadata a leaf of ``layout`` is re-written with (``name``, the
    ``i``-th leaf in tree order)."""
    shape = list(value.shape)
    if layout == "zarr3_sharded":
        codecs = [{"name": "transpose", "configuration": {"order": list(range(len(shape)))[::-1]}},
                  {"name": "bytes", "configuration": {"endian": "big"}}, {"name": "gzip", "configuration": {"level": 6}}]
        if not shape:
            return {"chunk_grid": {"name": "regular", "configuration": {"chunk_shape": []}},
                    "data_type": _v3_type(value), "codecs": codecs[1:]}
        # Several shards with a partial last one (the embedding, the
        # counts), a shard of shards (lm_head), else one shard of 2^ndim
        # inner chunks.
        d = DECODER["d_model"]
        shard, inner = {"tok_emb": ([64, d], [16, d // 2]), "token_counts": ([128], [32]),
                        "lm_head": ([d, 128], [d, 64])}.get(name, (shape, [s // 2 for s in shape]))
        if name == "lm_head":
            codecs = [{"name": "sharding_indexed", "configuration": {"chunk_shape": [d, 16], "codecs": codecs}}]
        index_codecs = [{"name": "bytes", "configuration": {"endian": "little"}}, {"name": "crc32c"}]
        return {
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": shard}}, "data_type": _v3_type(value),
            "codecs": [{"name": "sharding_indexed", "configuration": {
                "chunk_shape": inner, "codecs": codecs, "index_codecs": index_codecs, "index_location": "start"}}],
        }
    if layout == "zarr3_blosc":
        big = value.dtype == np.float32
        cname, shuffle = (("lz4", "bitshuffle"), ("zstd", "shuffle"), ("blosclz", "noshuffle"))[i % 3]
        keys = {"name": "v2", "configuration": {"separator": "."}} if i % 2 else {"name": "default", "configuration": {"separator": "."}}
        return {
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": _chunks(shape, 100, 6)}},
            "data_type": _v3_type(value), "chunk_key_encoding": keys,
            "fill_value": "NaN" if value.dtype.kind == "f" or value.dtype.name == "bfloat16" else 0,
            "codecs": [{"name": "bytes", "configuration": {"endian": "big" if big else "little"}},
                       {"name": "blosc", "configuration": {"cname": cname, "clevel": 5, "shuffle": shuffle,
                                                           "typesize": value.dtype.itemsize}},
                       {"name": "crc32c"}],
        }
    if layout == "zarr2_blosc":
        cname, shuffle, blocksize = BLOSC_VARIANTS[i % len(BLOSC_VARIANTS)]
        # 4,000-byte bf16 chunks: 15 blocks of 256 bytes and a leftover one
        return {"chunks": _chunks(shape, 100, 20) or [], "dtype": _dtype(value),
                "compressor": {"id": "blosc", "cname": cname, "clevel": 5, "shuffle": shuffle, "blocksize": blocksize}}
    if layout == "zarr2_stdlib":
        compressor = ({"id": "gzip", "level": 6}, {"id": "zlib", "level": 6}, {"id": "bz2", "level": 9})[i % 3]
        return {"chunks": _chunks(shape, 96, 5) or [], "dtype": _dtype(value), "compressor": compressor,
                "dimension_separator": "/" if i % 2 else "."}
    if layout == "zarr2_bigendian_f":
        # (tensorstore keeps order "C" for fewer than 2 dimensions)
        return {"chunks": _chunks(shape, 100, 5) or [], "dtype": _dtype(value, big=True),
                "order": "F" if len(shape) >= 2 else "C",
                "compressor": {"id": "zstd", "level": 3} if i % 2 else None}
    msg = f"no re-write for layout {layout!r}"
    raise ValueError(msg)


def write_fixture(out: Path, layout: str) -> None:
    import orbax.checkpoint as ocp
    import tensorstore as ts

    tree, cfg = fixture_tree(layout)
    zarr3 = layout.startswith("zarr3")
    ocdbt = layout in ("zarr3_ocdbt", "zarr3_blosc", "zarr2_stdlib", "ocdbt_numbered")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=ocdbt, use_zarr3=zarr3)) as checkpointer:
        checkpointer.save(out / "params", tree)
    (out / "config.json").write_text(json.dumps(cfg))
    params = out / "params"
    if layout == "ocdbt_numbered":  # three commits: manifests 1-3
        _new_ocdbt(params, _ocdbt_keys(params), commits=3, config={"manifest_kind": "numbered"})
    elif layout != "zarr3_ocdbt":
        # The leaves re-written in memory (OCDBT) or in place (a directory
        # each), then the OCDBT database written anew in one commit.
        kvstore = {"driver": "memory"} if ocdbt else {"driver": "file", "path": f"{params}/"}
        context = ts.Context()  # one memory store for every leaf
        sparse = layout == "zarr3_sharded"
        for i, (name, value) in enumerate(_leaves(tree)):
            if not ocdbt:
                shutil.rmtree(params / name)
            _rewrite(kvstore, name, value, _layout_leaf(layout, i, name, value), zarr3=zarr3, sparse=sparse,
                     context=context)
        if ocdbt:
            memory = ts.KvStore.open({"driver": "memory"}, context=context).result()
            _new_ocdbt(params, {key: memory.read(key).result().value for key in memory.list().result()})
        if sparse:  # orbax restores absent chunks as the fill value only when told that some are
            meta = json.loads((params / "_METADATA").read_text())
            meta["store_array_data_equal_to_fill_value"] = False
            (params / "_METADATA").write_text(json.dumps(meta))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(ROOT / "tests" / "data" / "orbax_layouts"))
    parser.add_argument("--layouts", nargs="*", default=list(LAYOUTS), choices=LAYOUTS)
    args = parser.parse_args()
    for layout in args.layouts:
        out = Path(args.out) / layout
        write_fixture(out, layout)
        size = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
        print(f"wrote {out} ({size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
