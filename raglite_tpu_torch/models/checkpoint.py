"""Orbax checkpoints of the JAX package's layout, read and written with
tensorstore alone (counterpart of raglite_tpu/models/checkpoint.py, which
goes through orbax and JAX).

A checkpoint directory holds ``config.json`` (the architecture) and
``params/``: an OCDBT key-value store with one zarr (v2) array per leaf,
keyed by the leaf's path joined with ``.`` (``layers.0.wq``), beside
``_METADATA``, whose ``tree_metadata`` lists each leaf's path with its key
types (1: a list index, 2: a dict key).  ``load_checkpoint`` returns the tree
of numpy arrays (bf16 leaves as ``ml_dtypes.bfloat16``, as tensorstore reads
them); ``save_checkpoint`` writes the same layout (leaves marked
``np.ndarray``, so orbax restores them without a device sharding), which the
JAX package's ``load_checkpoint`` reads back.  tensorstore is imported only
here, when a checkpoint is read or written.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

__all__ = ["load_checkpoint", "save_checkpoint"]


def _tensorstore():
    try:
        import tensorstore as ts
    except ImportError as e:
        msg = "ckpt: checkpoints need the tensorstore package (orbax's storage layer), which is not installed"
        raise ImportError(msg) from e
    return ts


def _kvstore(root: Path, key: str) -> dict:
    return {"driver": "ocdbt", "base": f"file://{root / 'params'}/", "path": f"{key}/"}


def load_checkpoint(path: str | Path) -> tuple[dict[str, Any], dict]:
    """``(params, config)`` of a checkpoint directory: the parameter tree
    (nested dicts and lists of numpy arrays, as orbax restores it)."""
    ts = _tensorstore()
    root = Path(path).absolute()
    config = json.loads((root / "config.json").read_text())
    tree_metadata = json.loads((root / "params" / "_METADATA").read_text())["tree_metadata"]
    context = ts.Context()
    tree: dict = {}
    for entry in tree_metadata.values():
        keys = [int(k["key"]) if k["key_type"] == 1 else k["key"] for k in entry["key_metadata"]]
        name = ".".join(str(k) for k in keys)
        array = ts.open({"driver": "zarr", "kvstore": _kvstore(root, name)}, context=context, open=True).result()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = array.read().result()
    return _lists(tree), config


def _lists(node: Any) -> Any:
    """Dicts keyed by list indices (key type 1) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


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


def _numpy(leaf) -> np.ndarray:
    """A host numpy array of a torch tensor or array (bf16 as ml_dtypes)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes  # installed with tensorstore

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str | Path, params: Any, config: dict) -> None:
    """Write ``params`` (a tree of dicts and lists of torch tensors or
    arrays; dense weights only) and ``config`` in the layout above."""
    ts = _tensorstore()
    root = Path(path).absolute()
    (root / "params").mkdir(parents=True, exist_ok=True)
    context = ts.Context()  # one OCDBT manifest for every leaf's writes
    tree_metadata = {}
    for keys, leaf in _leaves(params):
        if hasattr(leaf, "q8"):
            msg = "save_checkpoint takes dense weights; save the full-precision model and reload it with @int8"
            raise ValueError(msg)
        arr = _numpy(leaf)
        name = ".".join(k for k, _ in keys)
        dtype = "bfloat16" if arr.dtype.name == "bfloat16" else arr.dtype.str
        array = ts.open(
            {
                "driver": "zarr",
                "kvstore": _kvstore(root, name),
                "metadata": {
                    "shape": list(arr.shape), "chunks": list(arr.shape) or [], "dtype": dtype,
                    "compressor": {"id": "zstd", "level": 1},
                },
            },
            context=context, create=True, delete_existing=True,
        ).result()
        array.write(arr).result()
        tree_metadata[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False, "write_shape": list(arr.shape)},
        }
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
