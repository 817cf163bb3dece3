"""First-party native (C++) host code, reached through ctypes.

The port's own copy of the JAX package's native layer (counterpart of
raglite_tpu/native/__init__.py, which the port never imports):

- ``postings.cpp``: the inverted-index builder (UTF-8 tokenizer, term
  dictionary, CSR postings export, binary serialization) that feeds the
  device BM25 (ops/bm25.py), the C++ fast paths of the sentence and
  chunklet DPs (sentences.py, chunklets.py), and the hash encoder's
  featurizer, CPU embedding and table draw (models/encoder.py,
  models/hash_table.py).

The library is built with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` at first use
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
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).parent / "postings.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LIB_PATH = _BUILD_DIR / "libraglite_postings.so"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False


def _compile() -> Path | None:
    """Build the library unless a copy newer than the source exists."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "postings.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SOURCE.stat().st_mtime:
            return _LIB_PATH
        tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(_SOURCE), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.SubprocessError, FileNotFoundError) as exc:
            logger.warning("native postings build failed (%s); using the Python fallback", exc)
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
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return load_native() is not None


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
