"""One decode step captured as a CUDA graph and replayed: the port's
counterpart of the JAX package's one-dispatch decode programs
(``jax.jit`` of ``_decode_chunk_device``, ``speculate_chunk_device``,
``_jax_forward_one`` and ``_jax_forward_step_batch``).

A step is a function of no arguments that reads and updates, in place, a
state of tensors whose addresses never change (the KV cache, the carried
logits, the counters).  :class:`StepGraph` runs it:

- where it does not capture (the CPU; a tensor-parallel forward, which
  spans devices), eagerly on every call;
- on the card, the first call eagerly: a real step, which is also the
  warm-up, so that everything a step keeps per stream (cuBLAS's workspace,
  the decode kernel's scratch and ticket counters) and every kernel module
  exists before the capture.  Then the step is captured on the current
  stream (``capture_error_mode="thread_local"``: another thread's calls do
  not break this capture), with the step's ``torch.Generator`` registered
  so that a sampled step draws fresh numbers on each replay, and every
  later call replays the graph.  A failed capture or replay raises;
  nothing falls back to the eager step.

A kernel launch recorded during a capture does not run, so it is not
counted there (``ops/cuda_build.py:recording_launches``); the graph adds
it to its kernel's ``launch_counts`` on each replay.

Streams.  A graph captured on a stream holds the decode kernel's scratch
and ticket counters of that stream (``ops/decode_attention.py:
_scratch_for``), so two graphs of one capture stream must never run at
once, nor a graph beside eager calls on that stream.  Each generation
therefore checks out a stream of its own (:func:`generation_stream`) and
runs all of its device work there (:func:`on_stream`): prefill, warm-up,
capture and replays.  Streams go back to a pool and are reused, so the
pool, and the scratch kept per stream, grow only to the largest number of
generations that ran at once (at most :data:`MAX_STREAMS`; more wait).

Keyed programs.  :class:`ProgramGraphs` is the counterpart of the JAX
package's other one-dispatch programs on the retrieval path (``jax.jit`` of
the encoder's forward, pooled forward, rerank encode and MaxSim score; the
dense index's search programs): a function of tensors to tensors, captured
once per shape key and replayed, as ``jax.jit`` compiles once per shape and
dispatches once.  Inputs are copied into the key's static buffers and the
outputs copied out of the graph's, so callers never hold a tensor that the
next replay overwrites.  Every program of a device runs on one program
stream under one lock (:func:`_program_lock`): a capture must be alone on
its stream, and a replay's outputs must be copied out before another replay
can reuse memory of the pool.  The stream has high priority, so PyTorch
draws it from another pool than the default-priority streams that
:func:`generation_stream` hands out: a rerank inside ``rag()`` never
captures on a generation's stream.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Hashable, Iterator, NamedTuple

import torch

from raglite_tpu_torch.ops import cuda_build

__all__ = [
    "MAX_STREAMS", "PROGRAM_KEYS", "ProgramGraphs", "Stacked", "StepGraph", "captures", "eager_programs",
    "generation_stream", "on_stream", "shared_programs",
]

#: Generations that may hold a stream at once on one device (PyTorch hands
#: out its side streams round-robin from a pool of 32; the checked-out
#: streams must be distinct).
MAX_STREAMS = 16
#: Shape keys one :class:`ProgramGraphs` holds at once; the least recently
#: used is evicted first (its graph freed).
PROGRAM_KEYS = 32

_pool_lock = threading.Condition()
#: Per device index: every stream the pool made, and those free now.
_streams: dict[int, list[torch.cuda.Stream]] = {}
_free: dict[int, list[torch.cuda.Stream]] = {}


def captures(model, device: torch.device) -> bool:
    """Whether ``model``'s decode steps on ``device`` run from CUDA graphs:
    on the card, for a model whose forward stays on one device
    (``model.captures``)."""
    return device.type == "cuda" and model.captures


def _checkout(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _pool_lock:
        made, free = _streams.setdefault(index, []), _free.setdefault(index, [])
        while not free and len(made) >= MAX_STREAMS:
            _pool_lock.wait()
        if free:
            return free.pop()
        handles = {s.cuda_stream for s in made}
        for _ in range(64):  # skip PyTorch pool streams this pool already holds
            stream = torch.cuda.Stream(device=index)
            if stream.cuda_stream not in handles:
                made.append(stream)
                return stream
    msg = "generation_stream: no distinct CUDA stream left in PyTorch's pool"
    raise RuntimeError(msg)


@contextlib.contextmanager
def generation_stream(device: torch.device | None) -> Iterator[torch.cuda.Stream | None]:
    """A stream of the pool for one generation on ``device``, or None where
    the generation does not capture (``device`` None).  It first waits for
    the caller's current stream (weights and inputs written there); on exit
    the caller's stream waits for it, and it goes back to the pool."""
    if device is None:
        yield None
        return
    stream = _checkout(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    try:
        yield stream
    finally:
        torch.cuda.current_stream(device).wait_stream(stream)
        index = stream.device.index
        with _pool_lock:
            _free[index].append(stream)
            _pool_lock.notify()


def on_stream(stream: torch.cuda.Stream | None):
    """Make ``stream`` current for a region of device work (no-op for
    None).  Enter it around work between yields, never across one: a
    suspended generator must not leave its stream current in its caller."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class StepGraph:
    """``step`` run eagerly (``capture`` False), or run eagerly once and then
    replayed from a CUDA graph captured on the current stream (``capture``
    True: every call must come from the same stream).  ``generator`` is the
    ``torch.Generator`` the step draws from, if any.  After the capture,
    ``capture_ms`` is its host time and ``recorded`` the kernel launches
    one replay makes, per kernel."""

    def __init__(self, step: Callable[[], None], *, capture: bool, generator: torch.Generator | None = None) -> None:
        self.step = step
        self.capture = capture
        self.generator = generator
        self.graph: torch.cuda.CUDAGraph | None = None
        self.calls = 0
        self.capture_ms: float | None = None
        self.recorded: list[tuple[dict[str, int], str, int]] = []

    def __call__(self) -> None:
        self.calls += 1
        if self.graph is not None:
            self.graph.replay()
            cuda_build.count_replayed(self.recorded)
            return
        self.step()
        if self.capture:
            self._capture()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with cuda_build.recording_launches() as recorded:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.step()
            except BaseException:
                with contextlib.suppress(Exception):  # the capture is void; the step's error is the one to see
                    graph.capture_end()
                raise
            graph.capture_end()
        self.recorded = recorded
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3


# --- Keyed one-dispatch programs ---------------------------------------------

_setup_lock = threading.Lock()
#: Per device: the lock every program of the device runs under, and its stream.
_program_locks: dict[str, threading.Lock] = {}
_program_streams: dict[int, torch.cuda.Stream] = {}
_eager = threading.local()


def _program_lock(device: torch.device) -> threading.Lock:
    """The lock of ``device``'s program stream: one a card, however the
    device is spelt ("cuda" and "cuda:0" share one stream, so one lock)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _setup_lock:
        return _program_locks.setdefault(str(device), threading.Lock())


@contextlib.contextmanager
def _on_program_stream(device: torch.device) -> Iterator[torch.cuda.Stream]:
    """Make the device's program stream current; it first waits for the
    caller's stream (yielded), which waits for it at the end."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _setup_lock:
        stream = _program_streams.get(index)
        if stream is None:
            stream = _program_streams[index] = torch.cuda.Stream(device=index, priority=-1)
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield caller
    finally:
        caller.wait_stream(stream)


@contextlib.contextmanager
def eager_programs() -> Iterator[None]:
    """Within the block, in this thread, every :class:`ProgramGraphs` runs
    its program as plain PyTorch calls on the caller's stream: the eager
    reference that a replay is held to, and timed beside."""
    prev = getattr(_eager, "on", False)
    _eager.on = True
    try:
        yield
    finally:
        _eager.on = prev


class Stacked(NamedTuple):
    """A program input given as rows (device tensors of one shape): stacked
    into a ``[count, ...]`` tensor whose rows past ``len(rows)`` are zero."""

    rows: list
    count: int


def _materialized(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, Stacked):
        rows = [r.to(device) for r in x.rows]
        return torch.stack(rows + [torch.zeros_like(rows[0])] * (x.count - len(rows)))
    return torch.as_tensor(x).to(device)


def _static(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, Stacked):
        row = x.rows[0]
        return torch.zeros((x.count, *row.shape), dtype=row.dtype, device=device)
    t = torch.as_tensor(x)
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _fill(static: torch.Tensor, x: Any) -> None:
    """Copy one input into its static buffer on the current stream (CUDA
    stages a pageable host array before the copy call returns)."""
    if isinstance(x, Stacked):
        n = len(x.rows)
        torch.stack(x.rows, out=static[:n])
        if n < static.shape[0]:
            static[n:].zero_()
        return
    t = torch.as_tensor(x)
    if t.shape != static.shape or t.dtype != static.dtype:
        msg = f"ProgramGraphs: input {tuple(t.shape)} {t.dtype} for a key of {tuple(static.shape)} {static.dtype}"
        raise ValueError(msg)
    static.copy_(t, non_blocking=True)


def _as_tuple(out) -> tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


class _Captured(NamedTuple):
    graph: Any
    program: Callable  # kept with its graph: the device arrays it closes over stay alive
    inputs: list[torch.Tensor]
    outputs: tuple[torch.Tensor, ...]
    single: bool
    recorded: list
    capture_ms: float
    pool_bytes: int


class ProgramGraphs:
    """A family of programs ``program(*inputs) -> tensor or tuple of
    tensors``, each run from a CUDA graph per shape key.

    ``self(key, program, *inputs)``: the key names the program and every
    input shape (the caller's contract); ``program`` is called only where
    the key is new (the device arrays it closes over belong to the key).
    Inputs are host arrays, CPU or device tensors, or :class:`Stacked` rows.
    On the card, under the device's program lock and on its program stream:

    - a new key allocates static input buffers, fills them and runs the
      program eagerly on them (the call's result, and the warm-up: cuBLAS's
      workspace and every kernel module exist before the capture), then
      captures it (``capture_error_mode="thread_local"``) into this object's
      memory pool;
    - a known key fills its buffers, replays and returns clones of the
      outputs, made on the program stream and recorded on the caller's
      stream, so the caller never holds memory the next replay writes.

    A failed capture or replay raises; nothing falls back to the eager
    program.  Kernel launches recorded in a capture count on each replay
    (``ops/cuda_build.py:count_replayed``).  At most :data:`PROGRAM_KEYS`
    keys are held, in LRU order; evicting one frees its graph.  An entry
    keeps its program, and so every device array the program closes over:
    a graph never outlives the memory it reads.

    Memory: the graphs of one object share one pool.  That is safe because
    they never run at once (one lock) and every replay's outputs are copied
    out before the lock is released: a later capture may reuse an earlier
    graph's intermediates, never its live static buffers.  So the pool holds
    the largest key's intermediates and every key's static outputs, not the
    sum of every key's intermediates (an encoder key at bge-m3's width holds
    hundreds of MB of attention logits).  :meth:`clear` drops every graph;
    the emptied pool goes back to the allocator, and the next capture opens
    a new one.

    Runs eagerly on every call (inputs moved to the device, the caller's
    stream, no lock): on the CPU, where ``capture`` is False (a program
    spanning devices), inside :func:`eager_programs`, and for a key that
    ``capture_if(key)`` refuses (a documented size rule of the owner, never
    an error).  Every call runs under ``torch.inference_mode``.
    """

    def __init__(
        self,
        device: torch.device | str,
        *,
        capture: bool = True,
        capture_if: Callable[[Hashable], bool] | None = None,
    ) -> None:
        self.device = torch.device(device)
        self.captures = capture and self.device.type == "cuda"
        self.capture_if = capture_if
        self._entries: OrderedDict[Hashable, _Captured] = OrderedDict()
        self._pool = None
        self._stats_lock = threading.Lock()
        #: Calls by outcome: "captured" (first call of a key), "replayed",
        #: "kept_eager" (refused by ``capture_if``), "evicted" keys.
        self.counts = {"captured": 0, "replayed": 0, "kept_eager": 0, "evicted": 0}
        #: Host ms spent capturing, over every capture (evicted keys too).
        self.capture_ms = 0.0

    def _count(self, what: str) -> None:
        with self._stats_lock:
            self.counts[what] += 1

    def stats(self) -> dict[Hashable, dict[str, Any]]:
        """Per held key: capture ms, the pool bytes its capture added, and
        the kernel launches a replay counts."""
        return {
            key: {
                "capture_ms": e.capture_ms, "pool_bytes": e.pool_bytes,
                "launches": {name: n for _, name, n in e.recorded},
            }
            for key, e in list(self._entries.items())
        }

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def clear(self) -> None:
        """Drop every graph (their pool goes back to the allocator)."""
        with _program_lock(self.device):
            self._entries.clear()
            self._pool = None

    def eager(self, program: Callable, *inputs):
        """``program`` on the inputs moved to the device, on the caller's
        stream."""
        with torch.inference_mode():
            return program(*(_materialized(x, self.device) for x in inputs))

    def __call__(self, key: Hashable, program: Callable, *inputs):
        if not self.captures or getattr(_eager, "on", False):
            return self.eager(program, *inputs)
        if self.capture_if is not None and not self.capture_if(key):
            self._count("kept_eager")
            return self.eager(program, *inputs)
        with _program_lock(self.device), torch.inference_mode(), _on_program_stream(self.device) as caller:
            entry = self._entries.get(key)
            if entry is None:
                out = self._first(key, program, inputs)
            else:
                self._entries.move_to_end(key)
                for static, x in zip(entry.inputs, inputs):
                    _fill(static, x)
                entry.graph.replay()
                cuda_build.count_replayed(entry.recorded)
                self._count("replayed")
                out = tuple(t.clone() for t in entry.outputs)
                out = out[0] if entry.single else out
            if caller is not None:
                for t in _as_tuple(out):
                    t.record_stream(caller)
        return out

    def _first(self, key: Hashable, program: Callable, inputs: tuple):
        statics = [_static(x, self.device) for x in inputs]
        for static, x in zip(statics, inputs):
            _fill(static, x)
        out = program(*statics)  # the warm-up, and this call's result
        graph, outputs, recorded, capture_ms, pool_bytes = self._capture(program, statics)
        self._entries[key] = _Captured(
            graph, program, statics, _as_tuple(outputs), not isinstance(outputs, tuple), recorded, capture_ms, pool_bytes
        )
        with self._stats_lock:
            self.counts["captured"] += 1
            self.capture_ms += capture_ms
        while len(self._entries) > PROGRAM_KEYS:
            self._entries.popitem(last=False)
            self._count("evicted")
        return out

    def _capture(self, program: Callable, statics: list[torch.Tensor]):
        """Capture ``program`` on the current stream into this object's
        pool: (graph, static outputs, recorded launches, capture ms, bytes
        the pool grew by)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with cuda_build.recording_launches() as recorded:
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                outputs = program(*statics)
            except BaseException:
                with contextlib.suppress(Exception):  # the capture is void; the program's error is the one to see
                    graph.capture_end()
                raise
            graph.capture_end()
        capture_ms = (time.perf_counter() - t0) * 1e3
        return graph, outputs, recorded, capture_ms, torch.cuda.memory_reserved(self.device) - reserved


_shared: dict[str, ProgramGraphs] = {}


def shared_programs(device: torch.device | str) -> ProgramGraphs:
    """The :class:`ProgramGraphs` of ``device``'s ownerless programs: one a
    card however the device is spelt, one for the CPU (eager)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _setup_lock:
        programs = _shared.get(str(device))
        if programs is None:
            programs = _shared[str(device)] = ProgramGraphs(device)
        return programs
