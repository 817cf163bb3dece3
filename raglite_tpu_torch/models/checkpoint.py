"""Orbax checkpoints of the JAX package's layout, read and written without
orbax, tensorstore or JAX (counterpart of raglite_tpu/models/checkpoint.py,
which goes through orbax).

A checkpoint directory holds ``config.json`` (the architecture) and
``params/``: ``_METADATA``, whose ``tree_metadata`` lists each leaf's path
with its key types (1: a list index, 2: a dict key), and one zarr (v2) array
per leaf, keyed by the leaf's path joined with ``.`` (``layers.0.wq``): its
``.zarray`` JSON and its chunks (``0.0``; ``0`` for a 0-d array), each a
zstd frame.  By default (``use_ocdbt``) those keys live in an OCDBT
database (models/ocdbt.py); orbax's ``use_ocdbt=False`` puts them in one
directory per leaf.  zstd goes through the port's native decoder
(native/zstd.cpp), which has no Python fallback.

``load_checkpoint`` returns the tree of torch tensors on ``device``, each
leaf decoded (on a thread pool) and moved there in turn, so a checkpoint
never sits in host memory whole; leaves keep their saved dtype (bf16 as
``torch.bfloat16``).  ``save_checkpoint`` writes the same layout with
orbax's OCDBT config (chunks as raw-block zstd frames; leaves marked
``np.ndarray``, so orbax restores them without a device sharding), which
the JAX package's ``load_checkpoint`` reads back.
"""

from __future__ import annotations

import collections
import json
import math
import os
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


def _dtype(name: str) -> torch.dtype:
    """The torch dtype of a zarr v2 dtype string (tensorstore's
    ``bfloat16`` included; little-endian or single-byte types)."""
    if name == "bfloat16":
        return torch.bfloat16
    dt = np.dtype(name)
    if dt.byteorder == ">":
        msg = f"big-endian zarr dtype {name!r} (little-endian arrays are read)"
        raise NotImplementedError(msg)
    return torch.from_numpy(np.empty(0, dt)).dtype


def _read_array(store, name: str) -> torch.Tensor:
    """One zarr v2 array of ``store`` as a CPU tensor."""
    meta = json.loads(store.get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        msg = f"{name}: zarr format {meta.get('zarr_format')} (only zarr v2 arrays are read)"
        raise NotImplementedError(msg)
    compressor = (meta.get("compressor") or {}).get("id")
    if compressor not in (None, "zstd") or meta.get("filters") or meta.get("order", "C") != "C":
        msg = f"{name}: compressor {compressor!r}, filters {meta.get('filters')!r}, order {meta.get('order')!r} (zstd or none, no filters, C order are read)"
        raise NotImplementedError(msg)
    tdtype = _dtype(meta["dtype"])
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = torch.empty(shape, dtype=tdtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * out.element_size()
    whole = chunks == shape  # one chunk: decode into the output itself

    def decode(raw, dst: torch.Tensor) -> None:
        if compressor == "zstd":
            native.zstd_decompress(raw, dst)
        elif len(raw) != dst.numel():
            msg = f"{name}: an uncompressed chunk of {len(raw)} bytes, expected {dst.numel()}"
            raise ValueError(msg)
        else:
            dst.numpy()[:] = np.frombuffer(raw, np.uint8)

    for index in np.ndindex(*grid):
        raw = store.view(f"{name}/" + (sep.join(map(str, index)) if shape else "0"))
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        if raw is None:  # an absent chunk holds the fill value (null: 0)
            fill = meta.get("fill_value")
            out[region] = 0 if fill is None else float(fill) if isinstance(fill, str) else fill
            continue
        if whole:
            decode(raw, out.view(-1).view(torch.uint8))
            continue
        buf = torch.empty(chunk_bytes, dtype=torch.uint8)
        decode(raw, buf)
        out[region] = buf.view(tdtype).view(chunks)[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


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
    if meta.get("use_zarr3"):
        msg = "orbax checkpoints written with use_zarr3=True (zarr v3 arrays) are not read yet"
        raise NotImplementedError(msg)
    ocdbt = meta.get("use_ocdbt", (root / "params" / "manifest.ocdbt").exists())
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [int(k["key"]) if k["key_type"] == 1 else k["key"] for k in entry["key_metadata"]]
        leaves.append((keys, ".".join(str(k) for k in keys)))
    tree: dict = {}
    store = OcdbtReader(root / "params") if ocdbt else DirectoryStore(root / "params")
    with store, ThreadPoolExecutor(_DECODE_AHEAD) as pool:
        for (keys, _), leaf in _in_order(pool, lambda item: _read_array(store, item[1]), leaves, _DECODE_AHEAD):
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
