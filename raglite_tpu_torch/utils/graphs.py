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
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator

import torch

from raglite_tpu_torch.ops import cuda_build

__all__ = ["MAX_STREAMS", "StepGraph", "captures", "generation_stream", "on_stream"]

#: Generations that may hold a stream at once on one device (PyTorch hands
#: out its side streams round-robin from a pool of 32; the checked-out
#: streams must be distinct).
MAX_STREAMS = 16

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
