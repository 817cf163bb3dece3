"""OCDBT key-value stores (tensorstore's "optionally-cooperative distributed
B+tree", the storage under orbax's checkpoints), read and written without
tensorstore: the envelopes' zstd and CRC32C go through the port's native
library (native/zstd.cpp).

A database directory holds ``manifest.ocdbt`` and data files under ``d/``
(orbax's root tree points into ``ocdbt.process_<i>/d/`` through each data
file's base path).  Every manifest and B+tree node is an envelope: a
big-endian magic (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), the
file's length (u64 little-endian), varint format version 0 and varint
compression (0 none, 1 zstd), the body, and the CRC32C of all that (u32
little-endian).  Integers in bodies are LEB128 varints unless noted.

- Manifest body: the config (16-byte uuid, manifest kind, max inline value
  bytes, max decoded node bytes, version tree arity log2 as one byte,
  compression method and, for zstd, its level as an int32), then the
  inline version tree leaf: a data-file table and, column by column, each
  version's generation, root height (one byte), root node reference (data
  file id, offset, length), statistics (keys, tree bytes, indirect value
  bytes) and commit time (u64 ns), then the count of version tree nodes.
- Data-file table: the count, then per file its shared prefix length with
  the previous path (from the second file on), its suffix length and its
  base path length, then the suffixes; a file's path is base + relative.
- B+tree node body: its height (one byte), a data-file table and entries
  whose keys are prefix-compressed (shared length from the second on, then
  suffix lengths, then the bytes).  A leaf gives each value's length and
  kind (0 inline, 1 indirect), the indirect values' data file ids and
  offsets, then the inline bytes.  An interior node gives each child's
  subtree common prefix length (stripped from the child's keys), its
  reference and its statistics.

With ``manifest_kind`` 1 (numbered), ``manifest.ocdbt`` holds the config
alone and each commit writes ``manifest.<generation as 16 hex digits>``:
the config again and the version tree.

:class:`OcdbtReader` walks the newest version's tree; :class:`OcdbtWriter`
writes one single-process database (values and nodes in one data file, the
manifest last) with orbax's config.
"""

from __future__ import annotations

import mmap
import os
import re
import threading
import time
import uuid
from pathlib import Path

import numpy as np

from raglite_tpu_torch import native

__all__ = ["DirectoryStore", "OcdbtReader", "OcdbtWriter"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # the offset and length of an empty version's root
_NUMBERED = re.compile(r"manifest\.[0-9a-f]{16}")  # a numbered manifest (its generation in hex)

#: The config orbax writes (decoded from a checkpoint of the JAX package's
#: ``save_checkpoint``: orbax 0.11, tensorstore 0.1.80).
ORBAX_MAX_INLINE_VALUE_BYTES = 1024
ORBAX_MAX_DECODED_NODE_BYTES = 100_000_000
ORBAX_VERSION_TREE_ARITY_LOG2 = 4


class _Reader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data) or shift > 63:
                msg = "OCDBT: truncated or malformed varint"
                raise ValueError(msg)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            msg = "OCDBT: truncated body"
            raise ValueError(msg)
        self.pos += n
        return self.data[self.pos - n : self.pos]

    def byte(self) -> int:
        return self.raw(1)[0]


def _varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _inflate(body: bytes, limit: int) -> bytes:
    """A zstd body whose frames may declare no content size: decoded into a
    buffer that doubles up to ``limit`` bytes."""
    cap = max(4096, 4 * len(body))
    while True:
        out = np.empty(cap, np.uint8)
        try:
            n = native.zstd_decompress(body, out, exact=False)
        except ValueError as e:
            if "more bytes than expected" not in str(e) or cap >= limit:
                raise
            cap = min(2 * cap, limit)
            continue
        return out[:n].tobytes()


def unwrap(data: bytes, magic: int, what: str, limit: int = 1 << 31) -> bytes:
    """The body of a manifest or node envelope (checked and decompressed)."""
    if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
        msg = f"OCDBT {what}: bad magic number or truncated"
        raise ValueError(msg)
    if int.from_bytes(data[4:12], "little") != len(data):
        msg = f"OCDBT {what}: length field {int.from_bytes(data[4:12], 'little')} != {len(data)} bytes"
        raise ValueError(msg)
    if native.crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        msg = f"OCDBT {what}: CRC32C mismatch"
        raise ValueError(msg)
    r = _Reader(data, 12)
    version, compression = r.varint(), r.varint()
    if version != 0 or compression not in (0, 1):
        msg = f"OCDBT {what}: unsupported format version {version} or compression {compression}"
        raise ValueError(msg)
    body = data[r.pos : -4]
    return _inflate(body, limit) if compression == 1 else body


def wrap(body: bytes, magic: int) -> bytes:
    """An envelope of ``body``, zstd-compressed as raw blocks."""
    frame = native.zstd_raw_frame(body).tobytes()
    head = magic.to_bytes(4, "big") + (14 + len(frame) + 4).to_bytes(8, "little") + b"\x00\x01"
    data = head + frame
    return data + native.crc32c(data).to_bytes(4, "little")


def _read_table(r: _Reader) -> list[str]:
    paths, _base = _read_keys(r, r.varint(), column=True)
    return [p.decode() for p in paths]


def _table(paths: list[str]) -> bytes:
    """A data-file table of paths with an empty base path each."""
    shared, suffix, raw = _keys([p.encode() for p in paths])
    return _varint(len(paths)) + shared + suffix + _varints([0] * len(paths)) + raw


def _read_keys(r: _Reader, n: int, *, column: bool) -> tuple[list[bytes], list[int]]:
    """``n`` prefix-compressed keys, and the column of varints between their
    lengths and bytes when there is one (a table's base path lengths, an
    interior node's subtree common prefix lengths)."""
    shared = [0, *r.varints(n - 1)] if n else []
    suffix = r.varints(n)
    common = r.varints(n) if column else []
    keys, prev = [], b""
    for i in range(n):
        key = prev[: shared[i]] + r.raw(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


def _keys(keys: list[bytes]) -> tuple[bytes, bytes, bytes]:
    """(shared lengths, suffix lengths, suffix bytes) of sorted keys."""
    shared = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    starts = [0, *shared]
    suffixes = [k[s:] for k, s in zip(keys, starts)]
    return _varints(shared), _varints(len(x) for x in suffixes), b"".join(suffixes)


class _Files:
    """Read-only maps of a database's data files."""

    def __init__(self, root: Path) -> None:
        self.root = root
        self._maps: dict[str, mmap.mmap] = {}
        self._lock = threading.Lock()  # leaves are read from a thread pool

    def view(self, path: str, offset: int, length: int) -> memoryview:
        with self._lock:
            m = self._maps.get(path)
            if m is None:
                with open(self.root / path, "rb") as f:
                    m = self._maps[path] = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if offset + length > len(m):
            msg = f"OCDBT: {path} holds {len(m)} bytes, a reference reaches {offset + length}"
            raise ValueError(msg)
        return memoryview(m)[offset : offset + length]

    def close(self) -> None:
        for m in self._maps.values():
            try:
                m.close()
            except BufferError:  # a caller still holds a view; the map closes with it
                pass
        self._maps.clear()


class _Store:
    """Read-only keys over files under ``root``: ``view(key)`` (a zero-copy
    view of the value's bytes where they lie in a file, None when absent),
    ``get(key) -> bytes``."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self._files = _Files(self.root)

    def view(self, key: str) -> bytes | memoryview | None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        value = self.view(key)
        if value is None:
            raise KeyError(key)
        return bytes(value)

    def close(self) -> None:
        self._files.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class OcdbtReader(_Store):
    """The newest version of an OCDBT database, and ``keys()``.
    ``height`` is the root node's height (0: one leaf)."""

    def __init__(self, root: str | Path) -> None:
        super().__init__(root)
        r = _Reader(unwrap((self.root / "manifest.ocdbt").read_bytes(), MANIFEST_MAGIC, "manifest"))
        uuid_, kind = self._config(r)
        if kind == 1:  # numbered: manifest.ocdbt holds the config, the newest manifest.<16 hex digits> the versions
            numbered = sorted(p.name for p in self.root.iterdir() if _NUMBERED.fullmatch(p.name))
            if not numbered:
                msg = f"OCDBT: {self.root} has a numbered-manifest config and no numbered manifest"
                raise ValueError(msg)
            r = _Reader(unwrap((self.root / numbered[-1]).read_bytes(), MANIFEST_MAGIC, f"manifest {numbered[-1]}"))
            if self._config(r)[0] != uuid_:  # (its own kind field reads 0)
                msg = f"OCDBT: {numbered[-1]} belongs to another database than manifest.ocdbt"
                raise ValueError(msg)
        elif kind != 0:
            msg = f"OCDBT: manifest kind {kind} (single-file and numbered manifests are read)"
            raise NotImplementedError(msg)
        paths = _read_table(r)
        n = r.varint()
        if n == 0:
            msg = "OCDBT manifest without versions"
            raise ValueError(msg)
        _generation, heights = r.varints(n), [r.byte() for _ in range(n)]
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        self.height = heights[-1]
        self._entries: dict[bytes, bytes | tuple[str, int, int]] = {}
        if offsets[-1] != _MISSING:
            self._walk((paths[file_ids[-1]], offsets[-1], lengths[-1]), self.height, b"")

    def _config(self, r: _Reader) -> tuple[bytes, int]:
        """Reads a manifest's config; (uuid, manifest kind)."""
        uuid_, kind = r.raw(16), r.varint()
        r.varint()  # max inline value bytes
        self.max_decoded_node_bytes = r.varint()
        r.byte()  # version tree arity log2
        if r.varint() == 1:
            r.raw(4)  # zstd level
        return uuid_, kind

    def _walk(self, ref: tuple[str, int, int], height: int, prefix: bytes) -> None:
        data = bytes(self._files.view(*ref))
        body = unwrap(data, NODE_MAGIC, "B+tree node", self.max_decoded_node_bytes)
        r = _Reader(body)
        if r.byte() != height:
            msg = f"OCDBT: node at {ref} has another height than its reference says ({height})"
            raise ValueError(msg)
        paths = _read_table(r)
        n = r.varint()
        keys, common = _read_keys(r, n, column=height > 0)
        if height > 0:
            file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for i, key in enumerate(keys):
                self._walk((paths[file_ids[i]], offsets[i], lengths[i]), height - 1, prefix + key[: common[i]])
            return
        lengths, kinds = r.varints(n), r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            msg = "OCDBT: unknown value kind"
            raise ValueError(msg)
        indirect = [i for i in range(n) if kinds[i] == 1]
        file_ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(file_ids, offsets)))
        for i, key in enumerate(keys):
            if i in refs:
                file_id, offset = refs[i]
                self._entries[prefix + key] = (paths[file_id], offset, lengths[i])
            else:
                self._entries[prefix + key] = r.raw(lengths[i])

    def keys(self) -> list[str]:
        return sorted(k.decode() for k in self._entries)

    def view(self, key: str) -> bytes | memoryview | None:
        value = self._entries.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        return self._files.view(*value)



class DirectoryStore(_Store):
    """Keys as files under a directory: orbax's ``use_ocdbt=False`` layout
    (one zarr directory per leaf)."""

    def view(self, key: str) -> bytes | memoryview | None:
        path = self.root / key
        if not path.is_file():
            return None
        size = path.stat().st_size
        return self._files.view(key, 0, size) if size else b""


class OcdbtWriter:
    """Writes one single-process OCDBT database (a context manager): values
    of more than ``max_inline_value_bytes`` go to one data file as they
    come, and :meth:`commit` appends the B+tree (leaves split, and interior
    nodes added, so that no node's body exceeds ``max_decoded_node_bytes``)
    and writes the manifest last.  The config defaults to orbax's."""

    def __init__(
        self,
        root: str | Path,
        *,
        max_inline_value_bytes: int = ORBAX_MAX_INLINE_VALUE_BYTES,
        max_decoded_node_bytes: int = ORBAX_MAX_DECODED_NODE_BYTES,
    ) -> None:
        self.root = Path(root)
        (self.root / "d").mkdir(parents=True, exist_ok=True)
        self.max_inline_value_bytes = max_inline_value_bytes
        self.max_decoded_node_bytes = max_decoded_node_bytes
        self._name = f"d/{uuid.uuid4().hex}"
        self._file = open(self.root / self._name, "wb")  # noqa: SIM115 - closed by commit or close
        self._offset = 0
        self._entries: dict[bytes, bytes | tuple[int, int]] = {}

    def close(self) -> None:
        """Close the data file (a database not committed has no manifest)."""
        self._file.close()

    def __enter__(self) -> "OcdbtWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _append(self, data) -> int:
        offset = self._offset
        self._file.write(data)
        self._offset += len(memoryview(data).cast("B"))
        return offset

    def put(self, key: str, value) -> None:
        """Store ``value`` (bytes-like) under ``key``."""
        k = key.encode()
        if k in self._entries:
            msg = f"OCDBT writer: key {key!r} written twice"
            raise ValueError(msg)
        n = len(memoryview(value).cast("B"))
        self._entries[k] = bytes(value) if n <= self.max_inline_value_bytes else (self._append(value), n)

    # --- the tree ----------------------------------------------------------

    def _groups(self, items: list, size) -> list[list]:
        """Consecutive runs of items whose bodies (bounded by ``size``) fit a node."""
        limit = self.max_decoded_node_bytes - 64 - len(self._name)
        groups, current, used = [], [], 0
        for item in items:
            s = size(item)
            if current and used + s > limit:
                groups.append(current)
                current, used = [], 0
            current.append(item)
            used += s
        return [*groups, current]

    def _node(self, height: int, table: list[str], entries: bytes) -> tuple[int, int]:
        data = wrap(bytes([height]) + _table(table) + entries, NODE_MAGIC)
        return self._append(data), len(data)

    def _leaf(self, keys: list[bytes], prefix: bytes) -> tuple[int, int, int, int, int]:
        """Writes a leaf; (offset, length, keys, tree bytes, indirect value
        bytes)."""
        values = [self._entries[k] for k in keys]
        indirect = [v for v in values if isinstance(v, tuple)]
        shared, suffix, raw = _keys([k[len(prefix) :] for k in keys])
        body = (
            _varint(len(keys)) + shared + suffix + raw
            + _varints(len(v) if isinstance(v, bytes) else v[1] for v in values)
            + _varints(0 if isinstance(v, bytes) else 1 for v in values)
            + _varints([0] * len(indirect)) + _varints(v[0] for v in indirect)
            + b"".join(v for v in values if isinstance(v, bytes))
        )
        offset, length = self._node(0, [self._name] if indirect else [], body)
        return offset, length, len(keys), length, sum(v[1] for v in indirect)

    def _write(self, node: tuple[int, list], prefix: bytes) -> tuple[int, int, int, int, int]:
        """Writes a subtree, children first; (offset, length, keys, tree
        bytes, indirect value bytes)."""
        height, items = node
        if height == 0:
            return self._leaf(items, prefix)
        refs, keys, commons = [], [], []
        for child in items:
            first, last = _first(child), _last(child)
            child_prefix = os.path.commonprefix([first, last])
            refs.append(self._write(child, child_prefix))
            keys.append(first[len(prefix) :])
            commons.append(len(child_prefix) - len(prefix))
        shared, suffix, raw = _keys(keys)
        body = (
            _varint(len(items)) + shared + suffix + _varints(commons) + raw
            + _varints([0] * len(refs)) + _varints(r[0] for r in refs) + _varints(r[1] for r in refs)
            + _varints(r[2] for r in refs) + _varints(r[3] for r in refs) + _varints(r[4] for r in refs)
        )
        offset, length = self._node(height, [self._name], body)
        return offset, length, sum(r[2] for r in refs), length + sum(r[3] for r in refs), sum(r[4] for r in refs)

    def commit(self) -> int:
        """Write the tree and the manifest; returns the root's height."""
        if not self._entries:
            msg = "OCDBT writer: nothing to commit"
            raise ValueError(msg)
        keys = sorted(self._entries)

        def leaf_size(k: bytes) -> int:
            v = self._entries[k]
            return 32 + len(k) + (len(v) if isinstance(v, bytes) else 20)

        level: list[tuple[int, list]] = [(0, g) for g in self._groups(keys, leaf_size)]
        height = 0
        while len(level) > 1:
            height += 1
            level = [(height, g) for g in self._groups(level, lambda child: 80 + len(_first(child)))]
        offset, length, num_keys, tree_bytes, indirect_bytes = self._write(level[0], b"")
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        body = (
            uuid.uuid4().bytes + _varint(0) + _varint(self.max_inline_value_bytes)
            + _varint(self.max_decoded_node_bytes) + bytes([ORBAX_VERSION_TREE_ARITY_LOG2])
            + _varint(1) + (0).to_bytes(4, "little")  # zstd, level 0
            + _table([self._name])
            # One version: generation 1, its root (height, data file 0,
            # offset, length) and statistics, its commit time; no version
            # tree nodes.
            + _varint(1) + _varint(1) + bytes([height]) + _varints([0, offset, length, num_keys, tree_bytes, indirect_bytes])
            + time.time_ns().to_bytes(8, "little") + _varint(0)
        )
        tmp = self.root / "manifest.ocdbt.tmp"
        with open(tmp, "wb") as f:
            f.write(wrap(body, MANIFEST_MAGIC))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.root / "manifest.ocdbt")
        return height


def _first(node: tuple[int, list]) -> bytes:
    while node[0] > 0:
        node = node[1][0]
    return node[1][0]


def _last(node: tuple[int, list]) -> bytes:
    while node[0] > 0:
        node = node[1][-1]
    return node[1][-1]
