"""The safetensors format, read and written without the ``safetensors``
package (the card's machine has none).

A file is an 8-byte little-endian header length, a JSON header (each
tensor's ``dtype``, ``shape`` and ``data_offsets`` into the data that
follows; an optional ``__metadata__`` of strings), then the raw
little-endian data.  :class:`SafetensorsReader` maps the files and copies one
tensor at a time from the mapped pages to its device, so a checkpoint never
sits on the host whole (4B parameters in f32 would be 16 GB); BF16 is read as
its 2-byte words viewed as ``torch.bfloat16``, which numpy alone cannot read.
:func:`save_file` writes the same format.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path

import torch

__all__ = ["SafetensorsReader", "safetensors_files", "save_file"]

#: safetensors dtype name <-> torch dtype.
_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def safetensors_files(path: str | os.PathLike) -> list[Path]:
    """A file itself, or every ``*.safetensors`` of a directory, sorted (the
    shards of a checkpoint, as the JAX package's loader reads them)."""
    p = Path(path)
    if p.is_file():
        return [p]
    files = sorted(f for f in p.iterdir() if f.name.endswith(".safetensors"))
    if not files:
        msg = f"no *.safetensors file in {p}"
        raise FileNotFoundError(msg)
    return files


class _MappedFile:
    def __init__(self, path: Path) -> None:
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            # Copy-on-write pages: torch.frombuffer wants a writable buffer,
            # and nothing is ever written back to the file.
            self.map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self.base = 8 + n
        self.entries: dict[str, dict] = header
        for name, entry in header.items():
            if entry["dtype"] not in _DTYPES:
                msg = f"{path}: tensor {name!r} has dtype {entry['dtype']}, which is not supported"
                raise NotImplementedError(msg)


class SafetensorsReader:
    """Every tensor of a safetensors file or of a directory of shards, by
    name.  ``get`` copies one tensor from the mapped file to ``device``
    (cast to ``dtype`` there, so a bf16 tensor crosses the bus as bf16);
    the reader holds no tensor.  Use it as a context manager, or call
    :meth:`close`."""

    def __init__(self, path: str | os.PathLike) -> None:
        self._files = [_MappedFile(f) for f in safetensors_files(path)]
        self._where = {name: f for f in self._files for name in f.entries}

    def __enter__(self) -> "SafetensorsReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for f in self._files:
            f.map.close()
        self._files, self._where = [], {}

    def keys(self) -> list[str]:
        return list(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._where[name].entries[name]["shape"])

    def get(
        self, name: str, *, device: str | torch.device = "cpu", dtype: torch.dtype | None = None
    ) -> torch.Tensor:
        f = self._where[name]
        entry = f.entries[name]
        stored = _DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = entry["shape"]
        numel = 1
        for n in shape:
            numel *= n
        if numel == 0:
            return torch.zeros(shape, dtype=dtype or stored, device=device)
        if end - begin != numel * stored.itemsize:
            msg = f"tensor {name!r}: {end - begin} bytes for shape {shape} of {entry['dtype']}"
            raise ValueError(msg)
        view = torch.frombuffer(f.map, dtype=stored, count=numel, offset=f.base + begin).view(shape)
        # A copy in every case: the mapping closes with the reader.
        out = view.to(device=device, copy=True)
        return out if dtype is None else out.to(dtype)


def save_file(tensors: dict[str, torch.Tensor], path: str | os.PathLike, metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (any device; contiguous copies are made on the
    host one at a time) as one safetensors file, in the given order."""
    header: dict[str, dict] = {}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            msg = f"tensor {name!r}: dtype {t.dtype} has no safetensors name here"
            raise NotImplementedError(msg)
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + size]}
        offset += size
    if metadata:
        header = {"__metadata__": metadata, **header}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            host = t.detach().to("cpu").contiguous()
            if host.numel():
                f.write(memoryview(host.reshape(-1).view(torch.uint8).numpy()))
