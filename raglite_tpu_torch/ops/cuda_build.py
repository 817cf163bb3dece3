"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``, at first use, into ``raglite_tpu_torch/_build/`` (listed in
``.gitignore``).  The library name carries a digest of the sources and
flags, so an edited kernel never loads a stale build.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them.

Every wrapper calls its kernel the same way: :func:`function` binds a
launcher's C signature once, :func:`launch` calls it on the current CUDA
stream, raises on a cudaError and counts the launch.  Under a CUDA graph's
capture (:func:`recording_launches`) the launch is recorded, not run, and
the graph counts it on each replay (:func:`count_replayed`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "BUILD_DIR", "FLOAT", "INT", "LONG", "SOURCES", "VOID", "build_all", "count_replayed", "function", "launch",
    "library", "recording_launches",
]

#: C types of the launchers: pointers are void*, shapes int, sizes long long.
VOID, INT, FLOAT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: One library per kernel source.
SOURCES = ("bucket_scan", "int4_scan", "decode_attention", "prefill_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
#: The launches this thread's current graph capture has recorded, if any.
_capturing = threading.local()


def _nvcc() -> str:
    for candidate in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    msg = "nvcc not found: the port's CUDA kernels build with the CUDA toolkit"
    raise RuntimeError(msg)


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    per library built; raises with that output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs: dict[str, str] = {}
    failed: list[str] = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def function(source: str, symbol: str, argtypes: list, restype=INT):
    """``symbol`` of the library of ``csrc/<source>.cu``, with its C
    signature bound when it is first asked for."""
    fn = _functions.get(symbol)
    if fn is None:
        fn = getattr(library(source), symbol)
        fn.argtypes, fn.restype = argtypes, restype
        _functions[symbol] = fn
    return fn


def launch(counts: dict[str, int], name: str, fn, args: list, device: torch.device) -> None:
    """Call the launcher ``fn`` with ``args`` and, as its last argument, the
    current CUDA stream of ``device``; raise if it returns a cudaError, else
    add one to ``counts[name]``, or, under this thread's graph capture,
    record the launch for :func:`count_replayed` (the two places a kernel
    launch is counted)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = f"{name}: kernel launch failed with cudaError {err}"
        raise RuntimeError(msg)
    recorded = getattr(_capturing, "launches", None)
    if recorded is not None:  # captured into a graph: counted when it replays
        recorded.setdefault((id(counts), name), [counts, name, 0])[2] += 1
        return
    with _count_lock:  # threads may launch at once (insert_evals searches on 4)
        counts[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Around a CUDA graph's capture in this thread: yields a list that
    receives, when the block ends, ``(counts, name, n)`` for the launches of
    each kernel recorded into the graph (and not counted by :func:`launch`)."""
    out: list[tuple[dict[str, int], str, int]] = []
    _capturing.launches = {}
    try:
        yield out
    finally:
        out.extend(tuple(entry) for entry in _capturing.launches.values())
        _capturing.launches = None


def count_replayed(recorded: list[tuple[dict[str, int], str, int]]) -> None:
    """Count the launches one replay of a graph made (``recorded`` by
    :func:`recording_launches` during its capture)."""
    with _count_lock:
        for counts, name, n in recorded:
            counts[name] += n
