"""First-party native (C++) host code, reached through ctypes.

The port's own copy of the JAX package's native layer (counterpart of
raglite_tpu/native/__init__.py, which the port never imports):

- ``postings.cpp``: the inverted-index builder (UTF-8 tokenizer, term
  dictionary, CSR postings export, binary serialization) that feeds the
  device BM25 (ops/bm25.py), the C++ fast paths of the sentence and
  chunklet DPs (sentences.py, chunklets.py), and the hash encoder's
  featurizer, CPU embedding and table draw (models/encoder.py,
  models/hash_table.py).
- ``hnsw.cpp``: the first-party HNSW graph (:class:`HnswIndex`), the recall
  baseline irbench.py measures the dense index against; a copy of the JAX
  package's, so that the same vectors and seed give the same ids and scores.
- ``zstd.cpp``: a zstd frame decoder (RFC 8878), a raw-block frame writer
  and CRC32C, the codecs of orbax's OCDBT/zarr checkpoints
  (models/ocdbt.py, models/checkpoint.py).
- ``blosc.cpp``: the Blosc container (both unshuffles) with its LZ4,
  BloscLZ and Snappy decoders, tensorstore's ``blosc`` compressor
  (models/checkpoint.py); its zlib streams go to Python's zlib, its zstd
  streams to ``zstd.cpp``.  These codecs have no Python fallback:
  :func:`require_native` raises with the build's error.

The sources go into one library, built with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` at first use
into ``raglite_tpu_torch/_build/``, beside the CUDA kernels, under a file
lock (several processes may start at once) and moved into place whole.  If
the build fails (no toolchain), callers take the pure-Python
implementations, which give the same results, and the failure is logged at
WARNING.  This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SOURCES = tuple(Path(__file__).parent / name for name in ("postings.cpp", "hnsw.cpp", "zstd.cpp", "blosc.cpp"))
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LIB_PATH = _BUILD_DIR / "libraglite_native.so"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False
_BUILD_ERROR = ""


def _compile() -> Path | None:
    """Build the library unless a copy newer than every source exists."""
    global _BUILD_ERROR
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _LIB_PATH.exists() and all(_LIB_PATH.stat().st_mtime >= src.stat().st_mtime for src in _SOURCES):
            return _LIB_PATH
        tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", *map(str, _SOURCES), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.SubprocessError, FileNotFoundError) as exc:
            stderr = getattr(exc, "stderr", None) or b""
            _BUILD_ERROR = f"{exc}\n{stderr.decode(errors='replace')[-4000:]}".strip()
            logger.warning("native library build failed (%s); using the Python fallback", exc)
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, _LIB_PATH)
        return _LIB_PATH


def load_native() -> ctypes.CDLL | None:
    """Compile (once) and load the native library; None on failure."""
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        path = _compile()
        if path is None:
            _LIB_FAILED = True
            return None
        lib = ctypes.CDLL(str(path))
        c_void, c_char_p = ctypes.c_void_p, ctypes.c_char_p
        c_i32, c_i64 = ctypes.c_int32, ctypes.c_int64
        lib.rlt_builder_new.argtypes = []
        lib.rlt_builder_new.restype = c_void
        lib.rlt_builder_free.argtypes = [c_void]
        lib.rlt_builder_free.restype = None
        lib.rlt_builder_add_chunk.argtypes = [c_void, c_char_p, c_i64]
        lib.rlt_builder_add_chunk.restype = c_i32
        lib.rlt_builder_num_terms.argtypes = [c_void]
        lib.rlt_builder_num_terms.restype = c_i32
        lib.rlt_builder_num_chunks.argtypes = [c_void]
        lib.rlt_builder_num_chunks.restype = c_i32
        lib.rlt_builder_num_postings.argtypes = [c_void]
        lib.rlt_builder_num_postings.restype = c_i64
        lib.rlt_builder_dict_bytes.argtypes = [c_void]
        lib.rlt_builder_dict_bytes.restype = c_i64
        lib.rlt_builder_export.argtypes = [c_void] + [c_void] * 6
        lib.rlt_builder_export.restype = None
        lib.rlt_builder_lookup.argtypes = [c_void, c_char_p, c_i64]
        lib.rlt_builder_lookup.restype = c_i32
        lib.rlt_builder_tokenize_lookup.argtypes = [c_void, c_char_p, c_i64, c_void, c_i32]
        lib.rlt_builder_tokenize_lookup.restype = c_i32
        lib.rlt_builder_save_size.argtypes = [c_void]
        lib.rlt_builder_save_size.restype = c_i64
        lib.rlt_builder_save.argtypes = [c_void, c_void]
        lib.rlt_builder_save.restype = None
        lib.rlt_builder_load.argtypes = [c_char_p, c_i64]
        lib.rlt_builder_load.restype = c_void
        lib.rlt_count_tokens.argtypes = [c_char_p, c_i64]
        lib.rlt_count_tokens.restype = c_i32
        lib.rlt_solve_boundaries.argtypes = [c_void, c_i64, c_i64, c_i64, ctypes.c_float, c_void]
        lib.rlt_solve_boundaries.restype = c_i64
        lib.rlt_split_chunklets.argtypes = [c_void] * 4 + [c_i64, c_i64, c_void]
        lib.rlt_split_chunklets.restype = c_i64
        c_u32 = ctypes.c_uint32
        lib.rlt_hash_featurize.argtypes = [c_char_p, c_i64, c_i32, c_u32, c_void, c_void, c_void, c_i64]
        lib.rlt_hash_featurize.restype = c_i32
        lib.rlt_hash_embed.argtypes = [c_char_p, c_i64, c_i32, c_u32, c_void, c_i32, c_void]
        lib.rlt_hash_embed.restype = c_i32
        lib.rlt_normal_table.argtypes = [c_i64, c_i64, c_i64, c_void]
        lib.rlt_normal_table.restype = None
        lib.rlt_hnsw_new.argtypes = [c_i32, c_i32, c_i32, c_i32, ctypes.c_uint64]
        lib.rlt_hnsw_new.restype = c_void
        lib.rlt_hnsw_free.argtypes = [c_void]
        lib.rlt_hnsw_free.restype = None
        lib.rlt_hnsw_add.argtypes = [c_void, c_void, c_i64]
        lib.rlt_hnsw_add.restype = None
        lib.rlt_hnsw_size.argtypes = [c_void]
        lib.rlt_hnsw_size.restype = c_i32
        lib.rlt_hnsw_memory_bytes.argtypes = [c_void]
        lib.rlt_hnsw_memory_bytes.restype = c_i64
        lib.rlt_hnsw_search.argtypes = [c_void, c_void, c_i64, c_i32, c_i32, c_void, c_void]
        lib.rlt_hnsw_search.restype = None
        lib.rlt_zstd_error.argtypes = []
        lib.rlt_zstd_error.restype = c_char_p
        lib.rlt_zstd_decompress.argtypes = [c_void, c_i64, c_void, c_i64, c_i32]
        lib.rlt_zstd_decompress.restype = c_i64
        lib.rlt_zstd_raw_frame_size.argtypes = [c_i64]
        lib.rlt_zstd_raw_frame_size.restype = c_i64
        lib.rlt_zstd_raw_frame.argtypes = [c_void, c_i64, c_void]
        lib.rlt_zstd_raw_frame.restype = c_i64
        lib.rlt_crc32c.argtypes = [c_void, c_i64, c_u32]
        lib.rlt_crc32c.restype = c_u32
        lib.rlt_blosc_error.argtypes = []
        lib.rlt_blosc_error.restype = c_char_p
        lib.rlt_blosc_nbytes.argtypes = [c_void, c_i64]
        lib.rlt_blosc_nbytes.restype = c_i64
        lib.rlt_blosc_decompress.argtypes = [c_void, c_i64, c_void, c_i64, _InflateFn]
        lib.rlt_blosc_decompress.restype = c_i64
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return load_native() is not None


def require_native() -> ctypes.CDLL:
    """The native library, or a RuntimeError naming why it did not build
    (for the callers that have no Python fallback)."""
    lib = load_native()
    if lib is None:
        msg = f"the native library (raglite_tpu_torch/native/*.cpp, built with g++) is unavailable: {_BUILD_ERROR or 'not built'}"
        raise RuntimeError(msg)
    return lib


def _address(buf, *, writable: bool = False) -> tuple[int, int]:
    """(address, bytes) of a C-contiguous host buffer: a CPU torch tensor, a
    numpy array or (read-only) any bytes-like object."""
    if hasattr(buf, "data_ptr"):  # torch.Tensor
        if buf.device.type != "cpu" or not buf.is_contiguous():
            msg = "expected a contiguous CPU tensor"
            raise ValueError(msg)
        return buf.data_ptr(), buf.numel() * buf.element_size()
    arr = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    if not arr.flags.c_contiguous or (writable and not arr.flags.writeable):
        msg = "expected a C-contiguous" + (" writable" if writable else "") + " buffer"
        raise ValueError(msg)
    return arr.ctypes.data, arr.nbytes


def zstd_decompress(src, out, *, exact: bool = True) -> int:
    """Decode the zstd frames of ``src`` into ``out`` (a writable CPU tensor
    or numpy array), which they must fill when ``exact``; returns the bytes
    written.  Raises ValueError on a truncated or corrupt input, a bad
    content checksum or an output of another size than expected."""
    lib = require_native()
    src_ptr, src_len = _address(src)
    dst_ptr, dst_len = _address(out, writable=True)
    n = lib.rlt_zstd_decompress(src_ptr, src_len, dst_ptr, dst_len, int(exact))
    if n < 0:
        raise ValueError(lib.rlt_zstd_error().decode())
    return int(n)


def zstd_raw_frame(data) -> np.ndarray:
    """One zstd frame of raw (stored) blocks holding ``data``: valid zstd
    that any decoder reads, written at memcpy speed."""
    lib = require_native()
    ptr, n = _address(data)
    out = np.empty(lib.rlt_zstd_raw_frame_size(n), np.uint8)
    written = lib.rlt_zstd_raw_frame(ptr, n, out.ctypes.data)
    return out[:written]


#: The inflate callback of Blosc's zlib streams: (src, size, dst, cap) ->
#: bytes written, or -1.
_InflateFn = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64)


def _inflate(src: int, size: int, dst: int, cap: int) -> int:
    try:
        out = zlib.decompress(ctypes.string_at(src, size))
    except zlib.error:
        return -1
    if len(out) > cap:
        return -1
    ctypes.memmove(dst, out, len(out))
    return len(out)


_INFLATE = _InflateFn(_inflate)  # kept alive for the library's calls


def _blosc_failed(lib, code: int):
    message = lib.rlt_blosc_error().decode()
    return NotImplementedError(message) if code == -2 else ValueError(message)


def blosc_decompress(src, out=None):
    """Decode the Blosc container ``src`` into ``out`` (a writable CPU
    tensor or numpy array of exactly its uncompressed size), or into a new
    uint8 array; returns ``out``.  Raises ValueError on a truncated or
    corrupt container or another size than ``out``'s, NotImplementedError on
    a codec or format version it does not read."""
    lib = require_native()
    src_ptr, src_len = _address(src)
    n = lib.rlt_blosc_nbytes(src_ptr, src_len)
    if n < 0:
        raise _blosc_failed(lib, n)
    if out is None:
        out = np.empty(n, np.uint8)
    dst_ptr, dst_len = _address(out, writable=True)
    written = lib.rlt_blosc_decompress(src_ptr, src_len, dst_ptr, dst_len, _INFLATE)
    if written < 0:
        raise _blosc_failed(lib, written)
    return out


def crc32c(data) -> int:
    """CRC32C (Castagnoli) of ``data``, as OCDBT's manifests and nodes end."""
    lib = require_native()
    ptr, n = _address(data)
    return int(lib.rlt_crc32c(ptr, n, 0))


class NativePostingsBuilder:
    """ctypes wrapper over the C++ inverted-index builder."""

    def __init__(self, _handle: int | None = None) -> None:
        lib = load_native()
        if lib is None:
            msg = "native library unavailable"
            raise RuntimeError(msg)
        self._lib = lib
        self._handle = _handle if _handle is not None else lib.rlt_builder_new()

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rlt_builder_free(self._handle)
            self._handle = None

    def add_chunk(self, text: str) -> int:
        # Lowercase HERE: Python str.lower() covers all of Unicode, while the
        # C++ lower_cp maps ASCII/Latin-1 only; without this, native BM25
        # would be case-sensitive for Greek, Cyrillic and the like and
        # diverge from the Python fallback tokenizer (index/keyword.py).
        data = text.lower().encode("utf-8")
        return int(self._lib.rlt_builder_add_chunk(self._handle, data, len(data)))

    @property
    def num_terms(self) -> int:
        return int(self._lib.rlt_builder_num_terms(self._handle))

    @property
    def num_chunks(self) -> int:
        return int(self._lib.rlt_builder_num_chunks(self._handle))

    @property
    def num_postings(self) -> int:
        return int(self._lib.rlt_builder_num_postings(self._handle))

    def export(self) -> dict[str, np.ndarray | list[str]]:
        """CSR postings and dictionary as numpy arrays (ready to upload)."""
        n_terms, n_chunks = self.num_terms, self.num_chunks
        n_post = self.num_postings
        dict_bytes = int(self._lib.rlt_builder_dict_bytes(self._handle))
        offsets = np.zeros(n_terms + 1, np.int64)
        chunks = np.zeros(max(n_post, 1), np.int32)
        tf = np.zeros(max(n_post, 1), np.int32)
        doc_len = np.zeros(max(n_chunks, 1), np.int32)
        term_offsets = np.zeros(n_terms + 1, np.int64)
        term_bytes = np.zeros(max(dict_bytes, 1), np.uint8)
        self._lib.rlt_builder_export(
            self._handle,
            offsets.ctypes.data, chunks.ctypes.data, tf.ctypes.data,
            doc_len.ctypes.data, term_offsets.ctypes.data, term_bytes.ctypes.data,
        )
        raw = term_bytes.tobytes()
        terms = [raw[term_offsets[t] : term_offsets[t + 1]].decode("utf-8") for t in range(n_terms)]
        return {
            "offsets": offsets,
            "chunks": chunks[:n_post],
            "tf": tf[:n_post],
            "doc_len": doc_len[:n_chunks],
            "terms": terms,
        }

    def lookup(self, term: str) -> int:
        data = term.lower().encode("utf-8")
        return int(self._lib.rlt_builder_lookup(self._handle, data, len(data)))

    def tokenize_lookup(self, text: str, cap: int = 256) -> np.ndarray:
        """Query-side tokenization into term ids (unknown terms skipped)."""
        data = text.lower().encode("utf-8")
        out = np.zeros(cap, np.int32)
        n = self._lib.rlt_builder_tokenize_lookup(self._handle, data, len(data), out.ctypes.data, cap)
        return out[:n]

    def save(self) -> bytes:
        size = int(self._lib.rlt_builder_save_size(self._handle))
        buf = np.zeros(size, np.uint8)
        self._lib.rlt_builder_save(self._handle, buf.ctypes.data)
        return buf.tobytes()

    @classmethod
    def loads(cls, data: bytes) -> "NativePostingsBuilder":
        lib = load_native()
        if lib is None:
            msg = "native library unavailable"
            raise RuntimeError(msg)
        handle = lib.rlt_builder_load(data, len(data))
        if not handle:
            msg = "corrupt postings blob"
            raise ValueError(msg)
        return cls(_handle=handle)


def solve_boundaries(
    probas: np.ndarray, *, min_len: int, window: int | None, threshold: float
) -> list[int] | None | bool:
    """C++ fast path for the sentence-boundary DP
    (sentences.py:_solve_boundaries).  Returns the boundary list, None for
    infeasible, or False when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return False
    probas32 = np.ascontiguousarray(probas, dtype=np.float32)
    out = np.empty(max(len(probas32), 1), np.int64)
    count = lib.rlt_solve_boundaries(
        probas32.ctypes.data, len(probas32), min_len,
        window if window is not None else 0, float(threshold), out.ctypes.data,
    )
    if count < 0:
        return None
    return [int(x) for x in out[:count]]


def split_chunklet_cuts(
    probas: np.ndarray,
    pref_proba: np.ndarray,
    pref_stmt: np.ndarray,
    pref_len: np.ndarray,
    *,
    max_size: int,
) -> list[int] | None:
    """C++ fast path for the default-cost chunklet DP
    (chunklets.py:split_chunklets).  Returns interior cut indices, or None
    when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    n = len(probas)
    probas64 = np.ascontiguousarray(probas, np.float64)
    pp = np.ascontiguousarray(pref_proba, np.float64)
    ps = np.ascontiguousarray(pref_stmt, np.float64)
    pl = np.ascontiguousarray(pref_len, np.int64)
    cuts = np.empty(max(n, 1), np.int64)
    count = lib.rlt_split_chunklets(
        probas64.ctypes.data, pp.ctypes.data, ps.ctypes.data, pl.ctypes.data,
        n, max_size, cuts.ctypes.data,
    )
    return [int(x) for x in cuts[:count]]


def count_tokens(text: str) -> int | None:
    """C++ token counter (the ``\\w+|[^\\w\\s]`` tokenizer); None if no lib."""
    lib = load_native()
    if lib is None:
        return None
    data = text.lower().encode("utf-8")
    return int(lib.rlt_count_tokens(data, len(data)))


def hash_featurize(
    text: str, *, max_tokens: int, mask: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int] | None:
    """C++ featurizer of the hash encoder (models/encoder.py:HashEncoder):
    (feature ids int32, signs f32, per-token feature bounds int64 [n + 1],
    n tokens), or None when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    data = text.lower().encode("utf-8")
    cap = 2 * len(data) + 64  # a token of c codepoints has at most c + 1 features
    token_cap = min(max_tokens, max(len(data), 1))  # a token takes >= 1 byte
    ids = np.empty(cap, np.int32)
    signs = np.empty(cap, np.float32)
    bounds = np.zeros(token_cap + 1, np.int64)
    n = lib.rlt_hash_featurize(data, len(data), token_cap, mask, ids.ctypes.data, signs.ctypes.data, bounds.ctypes.data, cap)
    if n < 0:
        msg = "hash featurizer: feature buffer too small"
        raise RuntimeError(msg)
    total = int(bounds[n])
    return ids[:total], signs[:total], bounds[: n + 1], int(n)


def hash_embed(text: str, table: np.ndarray, *, max_tokens: int, mask: int) -> np.ndarray | None:
    """Fused C++ hash embedding (tokenize, hash, signed row sums, L2 norm in
    one pass); ``table`` is C-contiguous f32 [mask + 1, dim].  Returns [n
    tokens, dim] f32, or None when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    if table.dtype != np.float32 or not table.flags.c_contiguous:
        msg = "hash_embed needs a C-contiguous float32 table"
        raise ValueError(msg)
    data = text.lower().encode("utf-8")
    row_cap = min(max_tokens, max(len(data), 1))
    out = np.zeros((row_cap, table.shape[1]), np.float32)
    n = lib.rlt_hash_embed(data, len(data), row_cap, mask, table.ctypes.data, table.shape[1], out.ctypes.data)
    return out[:n]


def normal_table(seed: int, rows: int, dim: int) -> np.ndarray | None:
    """``jax.random.normal(PRNGKey(seed), (rows, dim), float32)`` drawn in
    C++ on all cores (models/hash_table.py); None when the native library is
    unavailable."""
    lib = load_native()
    if lib is None:
        return None
    out = np.empty((rows, dim), np.float32)
    lib.rlt_normal_table(int(seed), int(rows), int(dim), out.ctypes.data)
    return out


class HnswIndex:
    """ctypes wrapper over the first-party C++ HNSW graph (hnsw.cpp): the
    recall baseline of the claim "recall@10 >= HNSW at equal memory" (the
    upstream RAGLite serves from DuckDB VSS HNSW with ef_search = 160 at its
    defaults).  Host code; the same vectors, parameters and seed give the
    JAX package's ``HnswIndex``'s ids and scores bit for bit."""

    def __init__(
        self,
        dim: int,
        *,
        M: int = 32,
        ef_construction: int = 200,
        metric: str = "cosine",
        seed: int = 42,
    ) -> None:
        lib = load_native()
        if lib is None:
            msg = "native library unavailable"
            raise RuntimeError(msg)
        self._lib = lib
        self.dim = dim
        self._handle = lib.rlt_hnsw_new(dim, M, ef_construction, 0 if metric in ("cosine", "dot") else 1, seed)

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rlt_hnsw_free(self._handle)
            self._handle = None

    def add(self, vectors: np.ndarray) -> None:
        v = np.ascontiguousarray(vectors, np.float32)
        if v.ndim != 2 or v.shape[1] != self.dim:
            msg = f"vectors of shape {v.shape}; expected [n, {self.dim}]"
            raise ValueError(msg)
        self._lib.rlt_hnsw_add(self._handle, v.ctypes.data, v.shape[0])

    def __len__(self) -> int:
        return int(self._lib.rlt_hnsw_size(self._handle))

    @property
    def memory_bytes(self) -> int:
        """Bytes of the graph's links and its f32 vectors."""
        return int(self._lib.rlt_hnsw_memory_bytes(self._handle))

    def search(self, queries: np.ndarray, k: int, *, ef_search: int = 160) -> tuple[np.ndarray, np.ndarray]:
        """(ids [B, k] int32, scores [B, k] f32): similarities, descending,
        for cosine/dot, squared distances for l2; -1 and 0 past the graph's
        reach."""
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            msg = f"queries of shape {q.shape}; expected [B, {self.dim}]"
            raise ValueError(msg)
        ids = np.empty((q.shape[0], k), np.int32)
        scores = np.empty((q.shape[0], k), np.float32)
        self._lib.rlt_hnsw_search(self._handle, q.ctypes.data, q.shape[0], k, ef_search, ids.ctypes.data, scores.ctypes.data)
        return ids, scores
