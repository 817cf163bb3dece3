"""Schema-constrained, forced-tool and batched generation of the port
(models/json_automaton.py, models/schema_automaton.py and
models/decoder.py:TorchChatLLM) against the JAX package's, on the CPU.

Tolerances: automata states are compared exactly at every byte; sampled
tokens of ``_sample_host`` exactly (the same numpy code on the same logits
and seed); generated text exactly, token for token, on ``jax:tiny`` with
the JAX weights carried across in f32 (``params_from_jax``), both sides
with a bf16 KV cache: greedy and constrained decode take an argmax (or a
host draw) over logits that agree to ~1e-6.
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raglite_tpu.models import decoder as jdec
from raglite_tpu.models.json_automaton import JsonAutomaton as JJson
from raglite_tpu.models.schema_automaton import SchemaAutomaton as JSchema
from raglite_tpu_torch.models import decoder as tdec
from raglite_tpu_torch.models.json_automaton import JsonAutomaton as TJson
from raglite_tpu_torch.models.llm import ToolCall, _make_llm
from raglite_tpu_torch.models.schema_automaton import SchemaAutomaton as TSchema

#: An object with a string, an enum and an anyOf [integer, null] field.
SCHEMA = {
    "type": "object",
    "properties": {
        "title": {"type": "string"},
        "kind": {"enum": ["note", "paper", "manual"]},
        "year": {"anyOf": [{"type": "integer"}, {"type": "null"}]},
    },
    "required": ["title", "kind", "year"],
}
SCHEMAS = {
    "json": None,
    "object": SCHEMA,
    "nested": {
        "type": "object",
        "properties": {
            "tags": {"type": "array", "items": {"type": "string"}},
            "score": {"type": "number"},
            "ok": {"type": "boolean"},
            "inner": {"type": "object", "properties": {"n": {"type": "integer"}, "z": {"type": "null"}}},
            "ids": {"anyOf": [{"type": "array", "items": {"type": "integer"}}, {"type": "null"}]},
        },
    },
    "string": {"type": "string", "enum": ["alpha", "alps", "beta"]},
}
TOOLS = [
    {"type": "function", "function": {
        "name": "search_knowledge_base", "description": "Search the knowledge base.",
        "parameters": {"type": "object", "properties": {"query": {"type": "string"}}, "required": ["query"]},
    }},
    {"type": "function", "function": {
        "name": "fetch_page", "description": "Fetch one page.",
        "parameters": {"type": "object", "properties": {"page": {"type": "integer"}}, "required": ["page"]},
    }},
]
MESSAGES = [{"role": "user", "content": "Tell me about the cat on the mat."}]
PROMPTS = [
    "the cat sat on the mat. the cat sat on the mat. the cat sat",
    "q9 zp! & unique tokens only here",
    "ab",
    "hello world " * 12,
    "",
    "speculation copies spans: speculation copies spans",
    "x",
    "ragged prompts of different lengths share one prefill",
    "a ninth row pads the batch to sixteen",
]


def _automata(kind: str):
    schema = SCHEMAS[kind]
    return (JJson(), TJson()) if schema is None else (JSchema(schema), TSchema(schema))


def _state(automaton) -> tuple:
    """(allowed bytes, can_end, done, closing bytes or the error closing
    raised)."""
    try:
        closing = bytes(copy.deepcopy(automaton).completion_bytes())
    except ValueError as exc:
        closing = str(exc)
    return sorted(automaton.allowed_bytes()), automaton.can_end(), automaton.done(), closing


def _same_state(t_auto, j_auto) -> None:
    """Equal states, except where the JAX package's JsonAutomaton cannot
    close a top-level object not yet opened: the port's repaired copy
    closes it, as JSON that the JAX automaton accepts."""
    t_state, j_state = _state(t_auto), _state(j_auto)
    if isinstance(j_state[3], str) and isinstance(t_auto, TJson) and not t_auto._started:
        assert t_state[:3] == j_state[:3] and "not allowed in mode value" in j_state[3]
        closing = copy.deepcopy(j_auto)
        for byte in t_state[3]:
            closing.feed(byte)
        assert closing.done() and json.loads(t_state[3] or b"null") == {}
        return
    assert t_state == j_state


@pytest.mark.parametrize("kind", list(SCHEMAS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_automata_equal_jax_on_random_walks(kind: str, seed: int) -> None:
    """Random byte walks (each byte drawn from what the automaton allows,
    printable bytes preferred): the same allowed bytes, can_end, done and
    closing bytes at every step."""
    rng = np.random.default_rng(seed)
    j_auto, t_auto = _automata(kind)
    for _ in range(160):
        _same_state(t_auto, j_auto)
        allowed, _, done, _ = _state(t_auto)
        if done or not allowed:
            break
        printable = [b for b in allowed if 0x20 <= b < 0x7F]
        pool = printable if printable and rng.random() < 0.9 else allowed
        byte = int(rng.choice(pool))
        j_auto.feed(byte)
        t_auto.feed(byte)


def test_sample_host_equals_jax() -> None:
    rng = np.random.default_rng(4)
    for case in range(12):
        logits = rng.normal(0, 3, 300).astype(np.float32)
        logits[rng.random(300) < 0.3] = -np.inf
        kw = dict(
            temperature=[0.0, 0.7, 1.3][case % 3], top_p=[1.0, 0.8][case % 2],
            top_k=[0, 20, 5][case % 3], min_p=[0.0, 0.05][(case // 2) % 2],
        )
        j_rng, t_rng = np.random.default_rng(case), np.random.default_rng(case)
        want = [jdec.JaxChatLLM._sample_host(logits, rng=j_rng, **kw) for _ in range(20)]
        got = [tdec.TorchChatLLM._sample_host(logits, rng=t_rng, **kw) for _ in range(20)]
        assert got == want, kw


@pytest.fixture(scope="module")
def llms():
    j_llm = jdec.JaxChatLLM("tiny", seed=3, dtype=jnp.float32)
    t_llm = tdec.TorchChatLLM("tiny", device="cpu", dtype=torch.float32)
    t_llm.params = tdec.params_from_jax(j_llm.params, dtype=torch.float32)
    return j_llm, t_llm


@pytest.mark.parametrize(
    "response_format",
    [
        {"type": "json_schema", "json_schema": {"name": "S", "schema": SCHEMA}},
        {"type": "json_object"},
    ],
    ids=["json_schema", "json_object"],
)
def test_response_format_equals_jax(llms, response_format) -> None:
    j_llm, t_llm = llms
    want = j_llm.complete(MESSAGES, response_format=response_format, max_tokens=48).content
    got = t_llm.complete(MESSAGES, response_format=response_format, max_tokens=48).content
    assert got == want
    value = json.loads(got)
    if "json_schema" in response_format:
        assert list(value) == ["title", "kind", "year"] and value["kind"] in SCHEMA["properties"]["kind"]["enum"]
        automaton = TSchema(SCHEMA)
        for byte in got.encode("utf-8"):
            assert byte in automaton.allowed_bytes()
            automaton.feed(byte)
        assert automaton.done()


@pytest.mark.parametrize("prefix", [b"", b" ", b"\n\t "])
def test_object_closes_before_its_first_brace(prefix: bytes) -> None:
    """The repair: a json_object answer whose budget ran out on leading
    white space closes as ``{}`` (the JAX package's automaton raises)."""
    automaton = TJson()
    for byte in prefix:
        automaton.feed(byte)
    assert automaton.completion_bytes() == b"{}" and automaton.done()
    with pytest.raises(ValueError, match="not allowed"):
        j_auto = JJson()
        for byte in prefix:
            j_auto.feed(byte)
        j_auto.completion_bytes()


def test_response_format_through_the_factory() -> None:
    """The decoder behind ``llm="jax:tiny"`` answers a response format (it
    raised before this slice) and says it supports one."""
    llm = _make_llm("jax:tiny", "cpu")
    assert llm.supports_response_format
    content = llm.complete([{"role": "user", "content": "x"}], response_format={"type": "json_object"}, max_tokens=24).content
    json.loads(content)


@pytest.mark.parametrize(
    "tool_choice", ["required", {"type": "function", "function": {"name": "fetch_page"}}], ids=["required", "named"]
)
def test_forced_tool_call_equals_jax(llms, tool_choice) -> None:
    j_llm, t_llm = llms
    want = list(j_llm.stream(MESSAGES, tools=TOOLS, tool_choice=tool_choice, max_tokens=40))
    got = list(t_llm.stream(MESSAGES, tools=TOOLS, tool_choice=tool_choice, max_tokens=40))
    assert len(got) == 1 and isinstance(got[0], ToolCall)
    assert (got[0].name, got[0].arguments) == (want[0].name, want[0].arguments)
    schema = next(t["function"]["parameters"] for t in TOOLS if t["function"]["name"] == got[0].name)
    automaton = TSchema(schema)
    for byte in got[0].arguments.encode("utf-8"):
        automaton.feed(byte)
    assert automaton.done()
    response = t_llm.complete(MESSAGES, tools=TOOLS, tool_choice=tool_choice, max_tokens=40)
    assert [tc.arguments for tc in response.tool_calls] == [got[0].arguments]


@pytest.mark.parametrize(
    "response_format", [None, {"type": "json_schema", "json_schema": {"schema": SCHEMA}}], ids=["greedy", "schema"]
)
def test_complete_batch_equals_jax(llms, response_format) -> None:
    """Nine ragged prompts (B padded to 16), greedy: speculative on the
    device, or the constrained host loop."""
    j_llm, t_llm = llms
    batch = [[{"role": "user", "content": p}] for p in PROMPTS]
    want = [r.content for r in j_llm.complete_batch(batch, response_format=response_format, max_tokens=40)]
    got = [r.content for r in t_llm.complete_batch(batch, response_format=response_format, max_tokens=40)]
    assert got == want
    if response_format:
        for content in got:
            assert set(json.loads(content)) == {"title", "kind", "year"}


@pytest.mark.parametrize("speculate", ["auto", "0"])
def test_complete_batch_equals_per_prompt_complete(llms, monkeypatch, speculate: str) -> None:
    """Greedy batched decode equals the port's own B = 1 decode, prompt by
    prompt, with speculation on (batched verify at per-row offsets) and off
    (the plain chunk loop)."""
    _, t_llm = llms
    monkeypatch.setenv("RAGLITE_TPU_SPECULATE", speculate)
    batch = [[{"role": "user", "content": p}] for p in PROMPTS[:5]]
    got = [r.content for r in t_llm.complete_batch(batch, max_tokens=40)]
    assert got == [t_llm.complete(m, max_tokens=40).content for m in batch]


def test_sampled_batch_runs_and_ends(llms) -> None:
    """Seeded sampling, unconstrained (the device chunk loop) and under a
    schema (the host sampler): every row ends within its budget, the same
    seed gives the same rows, and constrained rows parse."""
    _, t_llm = llms
    prompts = [t_llm._format_messages([{"role": "user", "content": p}], None) for p in PROMPTS[:4]]
    kw = dict(max_new_tokens=40, temperature=0.8, top_k=20, top_p=0.9, seed=5)
    first = t_llm._generate_batch(prompts, **kw)
    assert first == t_llm._generate_batch(prompts, **kw)
    assert len(first) == 4 and all(len(tokens) <= 40 for tokens in first)
    batch = [[{"role": "user", "content": p}] for p in PROMPTS[:4]]
    schema_format = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}
    sampling = dict(max_tokens=40, temperature=0.8, top_k=20, top_p=0.9, seed=5)
    for response in t_llm.complete_batch(batch, response_format=schema_format, **sampling):
        assert set(json.loads(response.content)) == {"title", "kind", "year"}
