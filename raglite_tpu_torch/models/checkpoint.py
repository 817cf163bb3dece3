"""Orbax checkpoints of the JAX package's layout, read and written without
orbax, tensorstore or JAX (counterpart of raglite_tpu/models/checkpoint.py,
which goes through orbax).

A checkpoint directory holds ``config.json`` (the architecture) and
``params/``: ``_METADATA``, whose ``tree_metadata`` lists each leaf's path
with its key types (1: a list index, 2: a dict key), and one zarr array per
leaf, keyed by the leaf's path joined with ``.`` (``layers.0.wq``).  By
default (``use_ocdbt``) those keys live in an OCDBT database
(models/ocdbt.py); orbax's ``use_ocdbt=False`` puts them in one directory
per leaf.

``load_checkpoint`` reads what the JAX package's ``load_checkpoint``
restores through orbax and tensorstore, and nothing more:

- The store: OCDBT with a single-file manifest or numbered manifests
  (``manifest_kind`` 1), or one directory per leaf.
- ``use_zarr3=False``: zarr v2 arrays (``.zarray``; chunks ``0.0`` or
  ``0/0``, ``0`` for a 0-d array).  dtypes: bool, signed and unsigned
  integers, float16/32/64, complex64/128 in either byte order, and
  ``bfloat16``.  ``order`` ``"C"`` or ``"F"``.  ``compressor``: none,
  ``zstd``, ``blosc`` (BloscLZ, LZ4, LZ4HC, Snappy, zlib or zstd inside; no,
  byte or bit shuffle), ``gzip``, ``zlib``, ``bz2``; no ``filters``.
  ``fill_value``: null (0), numbers, ``"NaN"``, ``"Infinity"``,
  ``"-Infinity"``.
- ``use_zarr3=True``: zarr v3 arrays (``zarr.json``).  ``data_type``: bool,
  int8-64, uint8-64, float16, bfloat16, float32/64, complex64/128; a
  ``regular`` chunk grid; ``chunk_key_encoding`` ``default`` (``c/0/0``) or
  ``v2`` (``0.0``), either separator; ``fill_value``: numbers, ``"NaN"``,
  ``"Infinity"``, ``"-Infinity"``, hex bit patterns (``"0x7fc00000"``),
  ``[re, im]`` for complex types.  Codecs: ``transpose``; ``bytes`` (little
  or big endian); ``sharding_indexed`` (inner codecs and index codecs of
  this list, nested shards, the index at the ``start`` or the ``end``; not
  after a ``transpose``, where tensorstore departs from the spec, nor
  before a bytes->bytes codec, which tensorstore refuses);
  ``zstd``, ``gzip``, ``blosc`` and ``crc32c`` (verified: a mismatch raises
  before anything behind it is decoded).
- An absent chunk, or an empty inner chunk of a shard (offset and length
  2^64 - 1), holds the fill value, unless ``_METADATA`` says
  ``store_array_data_equal_to_fill_value`` (orbax's default since it writes
  every chunk): then it raises, as orbax does.

Anything else raises NotImplementedError naming what it met; a truncated or
corrupt chunk raises ValueError.  zstd and Blosc go through the port's
native decoders (native/zstd.cpp, native/blosc.cpp), which have no Python
fallback; gzip, zlib and bz2 through Python's zlib and bz2.

``load_checkpoint`` returns the tree of torch tensors on ``device``, each
leaf decoded (on a thread pool) and moved there in turn, so a checkpoint
never sits in host memory whole; leaves keep their saved dtype (bf16 as
``torch.bfloat16``) in native byte order.  ``save_checkpoint`` writes
orbax's default layout (zarr v2 in OCDBT; chunks as raw-block zstd frames;
leaves marked ``np.ndarray``, so orbax restores them without a device
sharding), which the JAX package's ``load_checkpoint`` reads back.
"""

from __future__ import annotations

import bz2
import collections
import json
import math
import os
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from raglite_tpu_torch import native
from raglite_tpu_torch.models.ocdbt import DirectoryStore, OcdbtReader, OcdbtWriter

__all__ = ["load_checkpoint", "save_checkpoint"]

#: Leaves decoded ahead of the one being moved to the device.
_DECODE_AHEAD = max(1, min(8, os.cpu_count() or 1))

#: zarr v3 data types -> numpy storage types (bfloat16 as its 2-byte words).
_V3_TYPES = {
    "bool": "?", "int8": "i1", "int16": "i2", "int32": "i4", "int64": "i8", "uint8": "u1", "uint16": "u2",
    "uint32": "u4", "uint64": "u8", "float16": "f2", "bfloat16": "u2", "float32": "f4", "float64": "f8",
    "complex64": "c8", "complex128": "c16",
}
#: Codecs of zarr v3 arrays: array->array, array->bytes, bytes->bytes.
_V3_CODECS = {"transpose", "bytes", "sharding_indexed", "zstd", "gzip", "blosc", "crc32c"}
#: zarr v2 compressors, read as bytes->bytes codecs of the same names.
_V2_COMPRESSORS = {"zstd", "blosc", "gzip", "zlib", "bz2"}
_MISSING = (1 << 64) - 1  # a sharded chunk's offset and length when it is empty
_NATIVE = "<" if sys.byteorder == "little" else ">"


class _Elem:
    """An element type: its numpy storage type (native byte order;
    bfloat16 as uint16)."""

    def __init__(self, storage: str, bf16: bool = False) -> None:
        self.np = np.dtype(storage).newbyteorder("=")
        self.bf16 = bf16

    def fill(self, value: Any, where: str) -> np.ndarray:
        """The 0-d array of a fill value (zarr v2's and v3's encodings)."""
        kind = self.np.kind
        if isinstance(value, str) and value.startswith("0x"):
            bits = int(value, 16)
            if bits >= 1 << (8 * self.np.itemsize) or kind not in "fc" and not self.bf16:
                msg = f"{where}: fill value {value!r} for {self.np}"
                raise ValueError(msg)
            raw = bits.to_bytes(self.np.itemsize, "big")[::-1 if _NATIVE == "<" else 1]
            return np.frombuffer(raw, self.np).reshape(()).copy()
        if kind == "c":
            re_im = value if isinstance(value, list) else [value, 0]
            if len(re_im) != 2:
                msg = f"{where}: complex fill value {value!r}"
                raise ValueError(msg)
            part = _Elem(f"f{self.np.itemsize // 2}")
            return np.asarray(complex(part.fill(re_im[0], where), part.fill(re_im[1], where)), self.np)
        number = 0 if value is None else float(value) if isinstance(value, str) else value
        if self.bf16:
            word = torch.tensor(float(number), dtype=torch.float32).to(torch.bfloat16).view(torch.int16)
            return np.asarray(word.item() & 0xFFFF, self.np)
        return np.asarray(number, self.np)

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if self.bf16 else t


def _v2_elem(name: Any, where: str) -> tuple[_Elem, str | None]:
    """A zarr v2 dtype string -> (element type, byte order of its stored
    bytes: "<", ">" or None for one byte)."""
    if name == "bfloat16":
        return _Elem("u2", bf16=True), "<"
    try:
        dt = np.dtype(name) if isinstance(name, str) else None
    except TypeError:
        dt = None
    if dt is None or dt.kind not in "biufc":
        msg = f"{where}: zarr dtype {name!r} (bool, integer, float, complex and bfloat16 types are read)"
        raise NotImplementedError(msg)
    order = None if dt.itemsize == 1 else ">" if dt.byteorder == ">" else "<" if dt.byteorder == "<" else _NATIVE
    return _Elem(dt.str[1:]), order


def _crc_checked(data, where: str) -> memoryview:
    """The bytes before a crc32c codec's trailing checksum, verified."""
    data = memoryview(data).cast("B")
    if len(data) < 4:
        msg = f"{where}: a crc32c-coded value of {len(data)} bytes"
        raise ValueError(msg)
    if native.crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        msg = f"{where}: crc32c mismatch"
        raise ValueError(msg)
    return data[:-4]


def _bytes_decode(name: str, data, size: int, dst: np.ndarray | None, where: str):
    """One bytes->bytes codec decoded to ``size`` bytes: into ``dst`` when
    given, else into a new buffer."""
    if name == "blosc":
        return native.blosc_decompress(data, dst)
    if name == "zstd":
        dst = np.empty(size, np.uint8) if dst is None else dst
        native.zstd_decompress(data, dst)
        return dst
    try:
        out = bz2.decompress(data) if name == "bz2" else zlib.decompress(data, 31 if name == "gzip" else 15)
    except (OSError, ValueError, zlib.error) as e:
        msg = f"{where}: corrupt {name} stream ({e})"
        raise ValueError(msg) from e
    if dst is None:
        return out
    if len(out) != dst.size:
        msg = f"{where}: a {name} stream of {len(out)} bytes, expected {dst.size}"
        raise ValueError(msg)
    dst[:] = np.frombuffer(out, np.uint8)
    return dst


def _region(index, chunks, shape) -> tuple[slice, ...]:
    return tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))


def _transpose_order(order: Any, ndim: int, where: str) -> list[int]:
    if order == "C":
        return list(range(ndim))
    if order == "F":
        return list(range(ndim))[::-1]
    if not isinstance(order, list) or sorted(order) != list(range(ndim)):
        msg = f"{where}: transpose order {order!r} for {ndim} dimensions"
        raise ValueError(msg)
    return order


class _Chain:
    """A zarr v3 codec chain (array->array codecs, one array->bytes codec,
    bytes->bytes codecs) over chunks of one shape and element type;
    :meth:`decode` undoes it."""

    def __init__(self, codecs: list[dict], shape: list[int], elem: _Elem, fill: np.ndarray | None, where: str) -> None:
        # (fill None: an empty inner chunk of a shard is an error)
        self.elem, self.where = elem, where
        self.transposes: list[list[int]] = []
        self.byte_order: str | None = None  # the bytes codec's "<" or ">"
        self.sharding: _Sharding | None = None  # or the sharding codec
        self.compressors: list[str] = []  # bytes->bytes, in encoding order
        encoded = list(shape)
        for codec in codecs:
            name, conf = codec.get("name"), codec.get("configuration") or {}
            if self.sharding is not None:
                msg = f"{where}: codec {name!r} after sharding_indexed (tensorstore refuses it too)"
                raise NotImplementedError(msg)
            if self.byte_order is None and name == "transpose":
                order = _transpose_order(conf.get("order"), len(encoded), where)
                self.transposes.append(order)
                encoded = [encoded[i] for i in order]
            elif self.byte_order is None and name == "bytes":
                endian = conf.get("endian")
                if endian not in (None, "little", "big") or (endian is None and elem.np.itemsize > 1):
                    msg = f"{where}: bytes codec endian {endian!r}"
                    raise ValueError(msg)
                self.byte_order = ">" if endian == "big" else "<"
            elif self.byte_order is None and name == "sharding_indexed":
                if self.transposes:
                    # tensorstore 0.1.80 writes this only where the transposed inner grid
                    # equals the untransposed one, and then in another order than the spec's
                    msg = f"{where}: transpose before sharding_indexed (tensorstore and the zarr v3 spec disagree on it)"
                    raise NotImplementedError(msg)
                self.sharding = _Sharding(conf, encoded, elem, fill, where)
            elif self.byte_order is not None and name in ("zstd", "gzip", "blosc", "crc32c", "zlib", "bz2"):
                self.compressors.append(name)
            else:
                msg = f"{where}: codec {name!r} in this position (array->array: transpose; array->bytes: bytes, sharding_indexed; bytes->bytes: zstd, gzip, blosc, crc32c)"
                raise NotImplementedError(msg)
        if self.byte_order is None and self.sharding is None:
            msg = f"{where}: no array->bytes codec"
            raise ValueError(msg)
        self.encoded = encoded
        self.nbytes = math.prod(encoded) * elem.np.itemsize  # what the bytes codec decodes from
        # Decoded straight into the caller's array: no transpose, stored bytes in native order.
        self.direct = not self.transposes and (elem.np.itemsize == 1 or self.byte_order == _NATIVE)

    def encoded_size(self) -> int:
        """The encoded bytes of a chain of fixed size (a shard index's)."""
        if self.sharding is not None or any(c != "crc32c" for c in self.compressors):
            msg = f"{self.where}: index codecs of variable size (transpose, bytes and crc32c are read)"
            raise NotImplementedError(msg)
        return self.nbytes + 4 * len(self.compressors)

    def decode(self, raw, into: np.ndarray | None = None) -> np.ndarray:
        """The chunk (C order, the chain's shape) of encoded bytes ``raw``;
        written into ``into`` (a C-contiguous array of that shape and type)
        when given."""
        if self.sharding is not None:
            return self.sharding.decode(raw, into)
        data, decoded_into = raw, False
        direct = into is not None and self.direct
        for i in range(len(self.compressors) - 1, -1, -1):
            name = self.compressors[i]
            if name == "crc32c":
                data = _crc_checked(data, self.where)
                continue
            size = self.nbytes + 4 * self.compressors[:i].count("crc32c")
            dst = into.reshape(-1).view(np.uint8) if direct and i == 0 else None
            data = _bytes_decode(name, data, size, dst, self.where)
            decoded_into = dst is not None
        arr = into if decoded_into else self._bytes(data, into if direct else None)
        for order in reversed(self.transposes):
            arr = arr.transpose(np.argsort(order))
        if into is not None and arr is not into:
            into[...] = arr
            return into
        return arr

    def _bytes(self, data, into: np.ndarray | None) -> np.ndarray:
        buf = memoryview(data).cast("B")
        if len(buf) != self.nbytes:
            msg = f"{self.where}: a chunk of {len(buf)} bytes, expected {self.nbytes}"
            raise ValueError(msg)
        if into is not None:
            into.reshape(-1).view(np.uint8)[:] = np.frombuffer(buf, np.uint8)
            return into
        stored = np.frombuffer(buf, self.elem.np.newbyteorder(self.byte_order)).reshape(self.encoded)
        return stored.astype(self.elem.np)  # a writable copy in native byte order


class _Sharding:
    """zarr v3's ``sharding_indexed`` codec: a shard of inner chunks (each
    coded by the inner chain) and an index of (offset, length) uint64 pairs
    per inner chunk, C order, coded by the index chain, at the start or the
    end of the shard."""

    def __init__(self, conf: dict, shape: list[int], elem: _Elem, fill: np.ndarray | None, where: str) -> None:
        inner = list(conf.get("chunk_shape") or [])
        if len(inner) != len(shape) or any(c <= 0 or s % c for s, c in zip(shape, inner)):
            msg = f"{where}: inner chunk shape {inner} does not divide the shard shape {shape}"
            raise ValueError(msg)
        self.shape, self.inner_shape, self.fill, self.elem, self.where = shape, inner, fill, elem, where
        self.grid = [s // c for s, c in zip(shape, inner)]
        self.inner = _Chain(conf.get("codecs") or [], inner, elem, fill, where)
        index_codecs = conf.get("index_codecs", [{"name": "bytes", "configuration": {"endian": "little"}}, {"name": "crc32c"}])
        u64 = _Elem("u8")
        self.index = _Chain(index_codecs, [*self.grid, 2], u64, np.asarray(_MISSING, np.uint64), f"{where} (shard index)")
        self.index_size = self.index.encoded_size()
        self.location = conf.get("index_location", "end")
        if self.location not in ("start", "end"):
            msg = f"{where}: shard index location {self.location!r}"
            raise NotImplementedError(msg)

    def decode(self, data, into: np.ndarray | None) -> np.ndarray:
        data = memoryview(data).cast("B")
        if len(data) < self.index_size:
            msg = f"{self.where}: a shard of {len(data)} bytes holds no index of {self.index_size}"
            raise ValueError(msg)
        raw = data[: self.index_size] if self.location == "start" else data[len(data) - self.index_size :]
        index = self.index.decode(raw).reshape(-1, 2)
        out = into if into is not None else np.empty(self.shape, self.elem.np)
        whole = self.grid == [1] * len(self.grid)
        for k, cell in enumerate(np.ndindex(*self.grid)):
            offset, length = int(index[k, 0]), int(index[k, 1])
            region = _region(cell, self.inner_shape, self.shape)
            if offset == _MISSING and length == _MISSING:
                if self.fill is None:
                    msg = f"{self.where}: inner chunk {cell} of a shard is missing (the checkpoint stores every chunk)"
                    raise ValueError(msg)
                out[region] = self.fill
            elif offset + length > len(data):
                msg = f"{self.where}: an inner chunk at {offset} + {length} past the shard's {len(data)} bytes"
                raise ValueError(msg)
            elif whole:
                self.inner.decode(data[offset : offset + length], out)
            else:
                out[region] = self.inner.decode(data[offset : offset + length])
        return out


class _Array:
    """One zarr array of a store: shape, chunk shape, element type, fill
    value, chunk keys and codec chain."""

    def __init__(self, store, name: str, zarr3: bool, missing_ok: bool) -> None:
        self.store, self.name, self.missing_ok = store, name, missing_ok
        if zarr3:
            self._v3(json.loads(store.get(f"{name}/zarr.json")))
        else:
            self._v2(json.loads(store.get(f"{name}/.zarray")))

    def _v2(self, meta: dict) -> None:
        where = f"{self.name} (zarr v2)"
        if meta.get("zarr_format") != 2:
            msg = f"{where}: zarr format {meta.get('zarr_format')} in .zarray"
            raise NotImplementedError(msg)
        if meta.get("filters"):
            msg = f"{where}: filters {meta['filters']!r} (none are read)"
            raise NotImplementedError(msg)
        self.elem, order = _v2_elem(meta.get("dtype"), where)
        self.shape, self.chunks = list(meta["shape"]), list(meta["chunks"])
        self.fill = self.elem.fill(meta.get("fill_value"), where)
        sep = meta.get("dimension_separator", ".")
        self.key = lambda index: f"{self.name}/" + (sep.join(map(str, index)) if index else "0")
        codecs: list[dict] = []
        if meta.get("order", "C") == "F":
            codecs.append({"name": "transpose", "configuration": {"order": "F"}})
        elif meta.get("order", "C") != "C":
            msg = f"{where}: order {meta.get('order')!r}"
            raise NotImplementedError(msg)
        codecs.append({"name": "bytes", "configuration": {"endian": {"<": "little", ">": "big", None: None}[order]}})
        compressor = (meta.get("compressor") or {}).get("id")
        if compressor is not None:
            if compressor not in _V2_COMPRESSORS:
                msg = f"{where}: compressor {compressor!r} (zstd, blosc, gzip, zlib, bz2 or none are read)"
                raise NotImplementedError(msg)
            codecs.append({"name": compressor})
        self.chain = _Chain(codecs, self.chunks, self.elem, self.fill if self.missing_ok else None, where)

    def _v3(self, meta: dict) -> None:
        where = f"{self.name} (zarr v3)"
        if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
            msg = f"{where}: zarr format {meta.get('zarr_format')}, node type {meta.get('node_type')!r} in zarr.json"
            raise NotImplementedError(msg)
        if meta.get("storage_transformers"):
            msg = f"{where}: storage transformers {meta['storage_transformers']!r}"
            raise NotImplementedError(msg)
        data_type = meta.get("data_type")
        if data_type not in _V3_TYPES:
            msg = f"{where}: data type {data_type!r} ({', '.join(_V3_TYPES)} are read)"
            raise NotImplementedError(msg)
        self.elem = _Elem(_V3_TYPES[data_type], bf16=data_type == "bfloat16")
        grid = meta.get("chunk_grid") or {}
        if grid.get("name") != "regular":
            msg = f"{where}: chunk grid {grid.get('name')!r} (regular grids are read)"
            raise NotImplementedError(msg)
        self.shape, self.chunks = list(meta["shape"]), list(grid["configuration"]["chunk_shape"])
        self.fill = self.elem.fill(meta.get("fill_value"), where)
        encoding = meta.get("chunk_key_encoding") or {"name": "default"}
        kind = encoding.get("name")
        if kind not in ("default", "v2"):
            msg = f"{where}: chunk key encoding {kind!r} (default and v2 are read)"
            raise NotImplementedError(msg)
        sep = (encoding.get("configuration") or {}).get("separator", "/" if kind == "default" else ".")
        if kind == "default":
            self.key = lambda index: f"{self.name}/" + sep.join(["c", *map(str, index)])
        else:
            self.key = lambda index: f"{self.name}/" + (sep.join(map(str, index)) if index else "0")
        codecs = meta.get("codecs") or []
        for codec in codecs:
            if codec.get("name") not in _V3_CODECS:
                msg = f"{where}: codec {codec.get('name')!r} ({', '.join(sorted(_V3_CODECS))} are read)"
                raise NotImplementedError(msg)
        self.chain = _Chain(codecs, self.chunks, self.elem, self.fill if self.missing_ok else None, where)

    def read(self) -> torch.Tensor:
        out = np.empty(self.shape, self.elem.np)
        whole = self.chunks == self.shape  # one chunk: decoded into the output itself
        for index in np.ndindex(*[-(-s // c) for s, c in zip(self.shape, self.chunks)]):
            raw = self.store.view(self.key(index))
            region = _region(index, self.chunks, self.shape)
            if raw is None:
                if not self.missing_ok:
                    msg = f"{self.name}: chunk {self.key(index)!r} is missing (the checkpoint stores every chunk)"
                    raise ValueError(msg)
                out[region] = self.fill
            elif whole:
                self.chain.decode(raw, out)
            else:
                chunk = self.chain.decode(raw)
                out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
        return self.elem.tensor(out)


def _read_array(store, name: str, *, zarr3: bool = False, missing_ok: bool = True) -> torch.Tensor:
    """One zarr array (v3 when ``zarr3``, else v2) of ``store`` as a CPU
    tensor; absent chunks hold the fill value when ``missing_ok``, else
    raise."""
    return _Array(store, name, zarr3, missing_ok).read()


def _lists(node: Any) -> Any:
    """Dicts keyed by list indices (key type 1) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def _in_order(pool: ThreadPoolExecutor, fn, items, ahead: int):
    """``(item, fn(item))`` in order, ``fn`` running on ``pool`` up to
    ``ahead`` items before the one yielded (host memory holds that many
    results)."""
    pending: collections.deque = collections.deque()
    for item in items:
        pending.append((item, pool.submit(fn, item)))
        if len(pending) > ahead:
            first, future = pending.popleft()
            yield first, future.result()
    while pending:
        first, future = pending.popleft()
        yield first, future.result()


def load_checkpoint(path: str | Path, *, device: str | torch.device = "cpu") -> tuple[dict[str, Any], dict]:
    """``(params, config)`` of a checkpoint directory: the parameter tree
    (nested dicts and lists, as orbax restores it) of torch tensors on
    ``device``, in their saved dtypes."""
    native.require_native()
    root = Path(path).absolute()
    config = json.loads((root / "config.json").read_text())
    meta = json.loads((root / "params" / "_METADATA").read_text())
    zarr3 = bool(meta.get("use_zarr3"))
    missing_ok = not meta.get("store_array_data_equal_to_fill_value", False)
    ocdbt = meta.get("use_ocdbt", (root / "params" / "manifest.ocdbt").exists())
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [int(k["key"]) if k["key_type"] == 1 else k["key"] for k in entry["key_metadata"]]
        leaves.append((keys, ".".join(str(k) for k in keys)))
    tree: dict = {}
    store = OcdbtReader(root / "params") if ocdbt else DirectoryStore(root / "params")
    with store, ThreadPoolExecutor(_DECODE_AHEAD) as pool:
        for (keys, _), leaf in _in_order(pool, lambda item: _read_array(store, item[1], zarr3=zarr3, missing_ok=missing_ok), leaves, _DECODE_AHEAD):
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = leaf.to(device)
    return _lists(tree), config


def _leaves(tree: Any, prefix: tuple = ()):
    """(path of (key, key_type) pairs, leaf) of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*prefix, (str(k), 2)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*prefix, (str(i), 1)))
    else:
        yield prefix, tree


def _host(leaf) -> torch.Tensor:
    """A contiguous CPU tensor of a torch tensor or an array numpy can read
    (bf16 arrays through their 2-byte words)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").contiguous()
    arr = np.asarray(leaf)
    arr = arr if arr.flags.c_contiguous else arr.copy()  # (ascontiguousarray makes 0-d arrays 1-d)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _encode(leaf) -> tuple[list[int], bytes, np.ndarray]:
    """A leaf's shape, ``.zarray`` and one chunk (a raw-block zstd frame)."""
    t = _host(leaf)
    shape = list(t.shape)
    dtype = "bfloat16" if t.dtype == torch.bfloat16 else t.reshape(-1)[:0].numpy().dtype.str
    zarray = {
        "chunks": shape, "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
        "dtype": dtype, "fill_value": None, "filters": None, "order": "C", "shape": shape, "zarr_format": 2,
    }
    frame = native.zstd_raw_frame(t.reshape(-1).view(torch.uint8).numpy())
    return shape, json.dumps(zarray, sort_keys=True, separators=(",", ":")).encode(), frame


def save_checkpoint(path: str | Path, params: Any, config: dict) -> None:
    """Write ``params`` (a tree of dicts and lists of torch tensors or
    arrays; dense weights only) and ``config`` in the layout above."""
    native.require_native()
    leaves = list(_leaves(params))
    if any(hasattr(leaf, "q8") for _, leaf in leaves):
        msg = "save_checkpoint takes dense weights; save the full-precision model and reload it with @int8"
        raise ValueError(msg)
    root = Path(path).absolute()
    tree_metadata = {}
    # The next leaves are copied to the host and framed while one is written.
    with OcdbtWriter(root / "params") as writer, ThreadPoolExecutor(1) as pool:
        for (keys, _), (shape, zarray, frame) in _in_order(pool, lambda item: _encode(item[1]), leaves, 2):
            name = ".".join(k for k, _ in keys)
            writer.put(f"{name}/.zarray", zarray)
            writer.put(f"{name}/" + (".".join("0" for _ in shape) if shape else "0"), frame)
            tree_metadata[str(tuple(k for k, _ in keys))] = {
                "key_metadata": [{"key": k, "key_type": kt} for k, kt in keys],
                "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False},
            }
        writer.commit()
    meta = {
        "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None,
    }
    (root / "params" / "_METADATA").write_text(json.dumps(meta))
    (root / "params" / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler",
        "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": 0, "commit_timestamp_nsecs": 0,
        "custom_metadata": {},
    }))
    (root / "config.json").write_text(json.dumps(config))
