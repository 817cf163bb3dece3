"""The decode steps that the port captures as CUDA graphs on the card
(models/decoder.py: ``_DecodeLoop``, ``_ForwardOne``, ``_ForwardBatch``;
models/speculative.py: ``SpeculativeLoop``; utils/graphs.py), run eagerly
on the CPU as they are there.

Each step form is held to the eager function it replaces on the same
weights, cache and generator: tokens, logits and the carried state exactly
(the same ops in the same order on the same CPU tensors).  Greedy tokens of
``TorchChatLLM`` are held to ``JaxChatLLM``'s exactly (f32 weights carried
across, bf16 KV caches, as in tests/test_torch_decoder.py).  A step must
make no host read (the card replays it with none): each runs under a
dispatch mode that raises on the ops that read a tensor on the host or
give a shape that depends on the data.
"""

import itertools
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raglite_tpu.models import decoder as jdec
from raglite_tpu_torch.models import decoder as tdec
from raglite_tpu_torch.models import speculative as tspec
from raglite_tpu_torch.ops import cuda_build
from raglite_tpu_torch.parallel.tp_decoder import TPDecoderModel
from raglite_tpu_torch.utils import graphs

#: Copy-heavy prompts (drafts get accepted) of different lengths.
PROMPTS = [
    "the cat sat on the mat. the cat sat on the mat. the cat sat",
    "alpha beta gamma. alpha beta gamma. alpha beta",
    "q9 zp! & unique tokens only here",
    "ab",
]
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=40, min_p=0.05)
#: Steps a decode chunk, tokens a speculative chunk: short chunks, so that
#: several carry state from one to the next in little time.
STEPS = 8
SPEC_TOKENS = 16
GREEDY = dict(temperature=0.0, top_p=1.0, top_k=0, min_p=0.0)
#: Ops that read a tensor's data on the host, or make a tensor whose shape
#: depends on it.
HOST_READS = {
    torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero, torch.ops.aten.masked_select,
    torch.ops.aten.equal, torch.ops.aten._unique2, torch.ops.aten.unique_consecutive,
}


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS:
            msg = f"host read inside a step: {func}"
            raise AssertionError(msg)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tiny CPU tensors (under
    several test workers a pool per worker only contends), restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_llm() -> jdec.JaxChatLLM:
    return jdec.JaxChatLLM("tiny", seed=3, dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_llm(jax_llm) -> tdec.TorchChatLLM:
    llm = tdec.TorchChatLLM("tiny", device="cpu", dtype=torch.float32)
    llm.params = tdec.params_from_jax(jax_llm.params, dtype=torch.float32)
    return llm


def _prefilled(llm, prompts: list[str], extra: int = 64):
    """A ragged batch of ``prompts`` prefilled as ``_generate_batch`` does
    (rows padded to 8, padding rows done): (cache, lens, last logits, done,
    history [B, S] of the prompt tokens)."""
    tok = llm.tokenizer
    encoded = [[tok.BOS, *tok.encode(p)] for p in prompts]
    bpad = max(len(prompts), 1) if len(prompts) == 1 else 8
    pad = tdec._bucket(max(len(ids) for ids in encoded))
    ids = torch.full((bpad, pad), tok.PAD, dtype=torch.int64)
    lens = torch.ones((bpad,), dtype=torch.int64)
    for i, row in enumerate(encoded):
        ids[i, : len(row)] = torch.tensor(row)
        lens[i] = len(row)
    s = pad + extra + tdec.DECODE_CHUNK
    cache = llm.model.init_cache(bpad, s)
    last, cache = tdec._prefill_last(llm.model, llm.params, ids, cache, lens)
    done = torch.arange(bpad) >= len(prompts)
    hist = torch.full((bpad, s), tok.PAD, dtype=torch.int64)
    hist[:, :pad] = ids
    return cache, lens, last, done, hist


def _clone_cache(cache: dict) -> dict:
    return {k: [t.clone() for t in v] for k, v in cache.items()}


def _decode_args(llm, sampling: dict, seed: int = 5):
    return (
        torch.from_numpy(llm._base_mask()), llm._stop_ids_device(), torch.Generator().manual_seed(seed),
    ), dict(num_steps=STEPS, **sampling)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_decode_loop_equals_eager_chunks(rows, sampling, torch_llm) -> None:
    """Three chunks of the step form equal three ``_decode_chunk_device``
    calls: tokens, the carried logits, offsets and done flags."""
    llm = torch_llm
    cache, lens, last, done, _ = _prefilled(llm, PROMPTS[:rows])
    eager_cache = _clone_cache(cache)
    (mask, stops, gen), kw = _decode_args(llm, sampling)
    loop = tdec._DecodeLoop(llm.model, cache, llm.params, lens, last, mask, done, stops, gen, **kw)
    (mask2, stops2, gen2), _ = _decode_args(llm, sampling)
    e_lens, e_last, e_done = lens, last, done
    chunks = []
    for _ in range(3):
        out = loop.chunk().clone()
        chunks.append(out)
        e_out, eager_cache, e_lens, e_last, e_done = tdec._decode_chunk_device(
            llm.model, eager_cache, llm.params, e_lens, e_last, mask2, e_done, stops2, gen2, **kw
        )
        assert torch.equal(out, e_out)
        assert torch.equal(loop.last, e_last) and torch.equal(loop.lens, e_lens) and torch.equal(loop.done, e_done)
    assert all(torch.equal(a, b) for a, b in zip(cache["k"], eager_cache["k"]))
    assert int((chunks[0][:rows] != tspec._NO_TOKEN).sum(dim=1).max()) >= 4  # tokens, not only stops
    assert loop.graph.calls == 3 * STEPS and loop.graph.graph is None  # eager on the CPU


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_speculative_loop_equals_eager_chunks(rows, sampling, torch_llm) -> None:
    """Chunks of ``SpeculativeLoop`` equal ``speculate_chunk_device`` calls:
    tokens, verify iterations and every carried tensor."""
    llm = torch_llm
    cache, lens, last, done, hist = _prefilled(llm, PROMPTS[:rows])
    eager_cache = _clone_cache(cache)
    (mask, stops, gen), _ = _decode_args(llm, sampling)
    (mask2, stops2, gen2), _ = _decode_args(llm, sampling)
    reject = torch.full((lens.shape[0],), -1, dtype=torch.int64)
    kw = dict(num_tokens=SPEC_TOKENS, draft_len=tdec.SPEC_DRAFT_LEN, pad_id=llm.tokenizer.PAD, **sampling)
    loop = tspec.SpeculativeLoop(llm.model, cache, llm.params, lens, last, reject, mask, done, stops, gen, hist, lens, **kw)
    state = (lens, last, reject, done, hist, lens)
    total = 0
    for _ in range(3):
        out, iters = loop.chunk()
        e_out, eager_cache, *carry, e_iters = tspec.speculate_chunk_device(
            llm.model, eager_cache, llm.params, state[0], state[1], state[2], mask2, state[3], stops2, gen2,
            state[4], state[5], **kw,
        )
        state = tuple(carry)
        assert torch.equal(out, e_out) and iters == e_iters
        for got, want in zip((loop.lens, loop.logits, loop.reject, loop.done, loop.hist, loop.hl), state):
            assert torch.equal(got, want)
        total += iters
    assert loop.graph.calls == total > 0
    if sampling is GREEDY:  # copy-heavy rows accept drafts
        assert int(loop.hl[0] - lens[0]) > total


def test_forward_one_and_batch_equal_eager(torch_llm) -> None:
    """``_ForwardOne`` and ``_ForwardBatch`` equal ``_forward_one`` and
    ``_forward_step_batch`` token by token, logits bit for bit."""
    llm = torch_llm
    tokens = [70, 71, 290, 5, 88, 70]
    cache, lens, *_ = _prefilled(llm, PROMPTS[:1])
    eager_cache = _clone_cache(cache)
    step = tdec._ForwardOne(llm.model, llm.params, cache, int(lens[0]), torch.device("cpu"))
    for i, token in enumerate(tokens):
        want = tdec._forward_one(llm.model, llm.params, token, eager_cache, int(lens[0]) + i)
        assert torch.equal(step(token), want)
    cache, lens, *_ = _prefilled(llm, PROMPTS[:3])
    eager_cache = _clone_cache(cache)
    batch = tdec._ForwardBatch(llm.model, llm.params, cache, lens)
    rng = np.random.default_rng(0)
    e_lens = lens
    for _ in range(4):
        step_tokens = torch.from_numpy(rng.integers(3, 259, lens.shape[0]))
        want = tdec._forward_step_batch(llm.model, llm.params, step_tokens, eager_cache, e_lens)
        assert torch.equal(batch(step_tokens), want)
        e_lens = e_lens + 1
    assert torch.equal(batch.lens, e_lens)


@pytest.mark.parametrize("speculate", [False, True], ids=["plain", "speculative"])
@pytest.mark.parametrize("prompt", PROMPTS[:2])
def test_greedy_tokens_match_jax(prompt, speculate, jax_llm, torch_llm, monkeypatch) -> None:
    """``TorchChatLLM._generate_tokens`` through the step forms emits
    ``JaxChatLLM``'s greedy tokens, speculation off and on."""
    monkeypatch.setenv("RAGLITE_TPU_SPECULATE", "always" if speculate else "0")
    want = list(jax_llm._generate_tokens(prompt, max_new_tokens=48))
    got = list(torch_llm._generate_tokens(prompt, max_new_tokens=48))
    assert got == want and len(got) > 0


def _steps(llm):
    """One instance of every step form, prefilled, by name."""
    cache, lens, last, done, hist = _prefilled(llm, PROMPTS[:2])
    one_cache, one_lens, *_ = _prefilled(llm, PROMPTS[:1])
    (mask, stops, gen), kw = _decode_args(llm, SAMPLED)
    reject = torch.full((lens.shape[0],), -1, dtype=torch.int64)
    spec = dict(num_tokens=SPEC_TOKENS, draft_len=tdec.SPEC_DRAFT_LEN, pad_id=llm.tokenizer.PAD)
    loops = {
        "decode_greedy": tdec._DecodeLoop(
            llm.model, cache, llm.params, lens, last, mask, done, stops, gen, **{**kw, **GREEDY}
        ),
        "decode_sampled": tdec._DecodeLoop(llm.model, cache, llm.params, lens, last, mask, done, stops, gen, **kw),
        "verify_greedy": tspec.SpeculativeLoop(
            llm.model, cache, llm.params, lens, last, reject, mask, done, stops, gen, hist, lens, **spec, **GREEDY
        ),
        "verify_sampled": tspec.SpeculativeLoop(
            llm.model, cache, llm.params, lens, last, reject, mask, done, stops, gen, hist, lens, **spec, **SAMPLED
        ),
        "forward_one": tdec._ForwardOne(llm.model, llm.params, one_cache, int(one_lens[0]), torch.device("cpu")),
        "forward_batch": tdec._ForwardBatch(llm.model, llm.params, cache, lens),
    }
    loops["verify_greedy"]._set_active()
    loops["verify_sampled"]._set_active()
    return loops


@pytest.mark.parametrize(
    "name", ["decode_greedy", "decode_sampled", "verify_greedy", "verify_sampled", "forward_one", "forward_batch"]
)
def test_steps_make_no_host_read(name, torch_llm) -> None:
    """Each step, the whole region a graph captures, runs under a dispatch
    mode that raises on host reads; the mode does see a host read."""
    step = _steps(torch_llm)[name]
    with _NoHostRead():
        step.step()
        step.step()
    with pytest.raises(AssertionError, match="host read"), _NoHostRead():
        bool(step.lens.any())


def test_two_threads_equal_sequential(torch_llm, monkeypatch) -> None:
    """Two generations at once on one model (a speculative greedy stream, a
    sampled stream and a constrained batch) give what they give one after
    the other: each call owns its cache and state."""
    monkeypatch.delenv("RAGLITE_TPU_SPECULATE", raising=False)
    llm = torch_llm
    schema = {"type": "object", "properties": {"a": {"type": "string"}}, "required": ["a"]}
    calls = [
        lambda: list(llm._generate_tokens(PROMPTS[0], max_new_tokens=40)),
        lambda: list(llm._generate_tokens(PROMPTS[1], max_new_tokens=40, seed=9, **SAMPLED)),
        lambda: [r.content for r in llm.complete_batch(
            [[{"role": "user", "content": p}] for p in PROMPTS[1:3]], max_tokens=24,
            response_format={"type": "json_schema", "json_schema": {"schema": schema}},
        )],
    ]
    want = [call() for call in calls]
    got: list = [None] * len(calls)

    def run(i: int) -> None:
        got[i] = calls[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert got == want and all(want)


def test_stream_pool_under_threads(monkeypatch) -> None:
    """Many more threads than the pool's limit check streams out at once
    (a short switch interval): no stream is ever held by two generations,
    the pool never holds two streams with one handle (PyTorch hands out its
    32 side streams round-robin) and never grows past MAX_STREAMS."""
    made = itertools.count()

    class _Stream:
        def __init__(self, device=None) -> None:
            self.cuda_stream = next(made) % 32
            self.device = torch.device("cuda", 0)

        def wait_stream(self, other) -> None:
            pass

    current = _Stream()
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: current)
    monkeypatch.setattr(graphs, "_streams", {})
    monkeypatch.setattr(graphs, "_free", {})
    lock, held, errors = threading.Lock(), set(), []

    def generate() -> None:
        for _ in range(25):
            _Stream()  # other code takes a side stream: the round-robin moves on
            with graphs.generation_stream(torch.device("cuda", 0)) as stream:
                with lock:
                    if stream.cuda_stream in held:
                        errors.append(stream.cuda_stream)
                    held.add(stream.cuda_stream)
                time.sleep(0.005)  # long enough that the pool fills under a loaded host too
                with lock:
                    held.discard(stream.cuda_stream)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=generate) for _ in range(3 * graphs.MAX_STREAMS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    pool = graphs._streams[0]
    assert len(pool) == graphs.MAX_STREAMS == len({s.cuda_stream for s in pool})
    assert sorted(map(id, graphs._free[0])) == sorted(map(id, pool))  # every stream back in the pool


def test_launches_recorded_under_capture_count_on_replay(monkeypatch) -> None:
    """A launch made while this thread records (a graph capture) is not
    counted; ``count_replayed`` adds it once a replay; other launches count
    as they launch."""

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda device: graphs.on_stream(None))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    counts = {"a": 0, "b": 0}
    device = torch.device("cpu")
    cuda_build.launch(counts, "a", lambda *args: 0, [], device)
    with cuda_build.recording_launches() as recorded:
        for name in ("a", "b", "b"):
            cuda_build.launch(counts, name, lambda *args: 0, [], device)
        assert counts == {"a": 1, "b": 0} and recorded == []
    assert recorded == [(counts, "a", 1), (counts, "b", 2)]
    for _ in range(3):
        cuda_build.count_replayed(recorded)
    assert counts == {"a": 4, "b": 6}
    cuda_build.launch(counts, "a", lambda *args: 0, [], device)  # recording ended
    assert counts["a"] == 5
    with pytest.raises(RuntimeError, match="cudaError 700"):
        cuda_build.launch(counts, "a", lambda *args: 700, [], device)
    assert counts["a"] == 5


def test_eager_where_no_graph_is_captured(torch_llm) -> None:
    """The CPU and a tensor-parallel model run every step eagerly on the
    current stream: no generation stream, no capture."""
    llm = torch_llm
    assert llm._graph_device() is None
    assert graphs.captures(llm.model, torch.device("cuda")) and not graphs.captures(llm.model, torch.device("cpu"))
    assert not TPDecoderModel.captures
    with graphs.generation_stream(None) as stream, graphs.on_stream(stream):
        assert stream is None
    calls = []
    step = graphs.StepGraph(lambda: calls.append(1), capture=False)
    for _ in range(3):
        step()
    assert len(calls) == step.calls == 3 and step.graph is None and step.capture_ms is None
