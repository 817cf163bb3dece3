"""The port's evals (evals.py) and extraction core (extract.py) against the
JAX package's, on the CPU, with the echo LLM over ``hash:`` stores.

Tolerances, stated per test: the response schemas and system prompts equal
those the JAX package sends (pydantic's ``model_json_schema()`` of its
models); generated evals (question, gold chunk ids, contexts, ground truth)
equal under the same ``random.seed``; answered evals equal; the judged
metric columns equal, NaN positions included; the embedding columns
(``answer_similarity``, ``context_relevancy``, ``faithfulness_proxy``,
``answer_relevancy``) within rtol 1e-4 (query embeddings are f16 in both
packages, and one f16 ulp may flip between XLA's and torch's pooling sums).
"""

import json
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import raglite_tpu.evals as jevals
import raglite_tpu.extract as jextract
import raglite_tpu_torch.evals as tevals
from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.insert import insert_documents as jinsert
from raglite_tpu.store import store_from_config as jstore
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.extract import extract_json, schema_validator
from raglite_tpu_torch.insert import insert_documents as tinsert
from raglite_tpu_torch.models.llm import ChatResponse
from raglite_tpu_torch.store import store_from_config as tstore

ROOT = Path(__file__).resolve().parent.parent
TEXTS = (
    "# Optics\n\n" + "Refraction bends light through prisms. " * 60,
    "# Baking\n\n" + "Yeast ferments dough for bread. " * 60,
    "# Tides\n\n" + "The moon's gravity raises ocean tides twice a day. " * 40,
)
JUDGED = ("faithfulness", "context_precision", "context_recall")
EMBEDDED = ("answer_similarity", "context_relevancy", "faithfulness_proxy", "answer_relevancy")


@pytest.fixture(scope="module")
def kb(tmp_path_factory: pytest.TempPathFactory):
    """The same three documents in a ``hash:128`` store of each package."""
    root = tmp_path_factory.mktemp("evals")
    jcfg = JConfig(store_path=str(root / "jax"), embedder="hash:128", llm="echo")
    tcfg = TConfig(store_path=str(root / "torch"), embedder="hash:128", llm="echo", device="cpu")
    jinsert([JDocument.from_text(t) for t in TEXTS], config=jcfg)
    tinsert([TDocument.from_text(t) for t in TEXTS], config=tcfg)
    return jcfg, tcfg


def _eval_tuple(ev):
    return (ev.id, ev.question, ev.chunk_ids, ev.contexts, ev.ground_truth, ev.document_id)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_generate_eval_matches_jax(kb, seed: int) -> None:
    """The same seed gives the same question, gold chunk ids, contexts and
    ground truth in both packages."""
    jcfg, tcfg = kb
    random.seed(seed)
    want = jevals.generate_eval(max_chunks=5, config=jcfg)
    random.seed(seed)
    got = tevals.generate_eval(max_chunks=5, config=tcfg)
    assert _eval_tuple(got) == _eval_tuple(want)
    assert got.question.endswith("?") and got.chunk_ids


def test_schemas_and_prompts_equal_jax(kb, monkeypatch: pytest.MonkeyPatch) -> None:
    """Every extraction the evals make sends the JAX package's schema (its
    pydantic model's ``model_json_schema()``), name, description and system
    prompt, in the same order: generate_eval's question, judgments and
    answer, the claims of faithfulness and recall, the reverse questions."""
    jcfg, tcfg = kb
    sent = {"jax": [], "torch": []}
    j_extract, j_first = jevals.extract_with_llm, jextract._extract_batch_first_pass
    t_extract, t_first = tevals.extract_json, tevals.extract_json_batch_first_pass

    def j_record(return_type, *args, **kwargs):
        sent["jax"].append((return_type.model_json_schema(), return_type.__name__, return_type.__doc__ or "",
                            str(getattr(return_type, "system_prompt", "")).strip()))
        return j_extract(return_type, *args, **kwargs)

    def j_record_first(return_type, *args, **kwargs):
        sent["jax"].append((return_type.model_json_schema(), return_type.__name__, return_type.__doc__ or "",
                            str(getattr(return_type, "system_prompt", "")).strip()))
        return j_first(return_type, *args, **kwargs)

    def t_record(schema, name, system_prompt, *args, description="", **kwargs):
        sent["torch"].append((schema, name, description, system_prompt.strip()))
        return t_extract(schema, name, system_prompt, *args, description=description, **kwargs)

    def t_record_first(schema, name, system_prompt, *args, description="", **kwargs):
        sent["torch"].append((schema, name, description, system_prompt.strip()))
        return t_first(schema, name, system_prompt, *args, description=description, **kwargs)

    monkeypatch.setattr(jevals, "extract_with_llm", j_record)
    monkeypatch.setattr(jextract, "_extract_batch_first_pass", j_record_first)
    monkeypatch.setattr(tevals, "extract_json", t_record)
    monkeypatch.setattr(tevals, "extract_json_batch_first_pass", t_record_first)
    random.seed(7)
    jev = jevals.generate_eval(max_chunks=4, config=jcfg)
    random.seed(7)
    tev = tevals.generate_eval(max_chunks=4, config=tcfg)
    columns = {"question": [jev.question], "answer": ["Refraction bends light. Prisms split it."],
               "contexts": [jev.contexts], "ground_truth": [jev.ground_truth]}
    jevals.answer_faithfulness(pd.DataFrame(columns), jcfg)
    jevals.context_recall(pd.DataFrame(columns), jcfg)
    jevals.answer_relevancy(pd.DataFrame(columns), jcfg)
    columns["question"], columns["contexts"], columns["ground_truth"] = [tev.question], [tev.contexts], [tev.ground_truth]
    tevals.answer_faithfulness(columns, tcfg)
    tevals.context_recall(columns, tcfg)
    tevals.answer_relevancy(columns, tcfg)
    names = [name for _, name, _, _ in sent["jax"]]
    assert {"QuestionResponse", "ContextEvalResponse", "AnswerResponse", "ClaimsResponse", "ReverseQuestions"} <= set(names)
    assert sent["torch"] == sent["jax"]


def test_schema_constants_are_pydantics() -> None:
    """The module's schema constants are pydantic's schemas of the JAX
    package's models (QuestionResponse is importable; the others are built
    inside the functions and checked through their calls above)."""
    assert tevals.QUESTION_SCHEMA == jevals.QuestionResponse.model_json_schema()
    assert tevals.QUESTION_SYSTEM_PROMPT == jevals.QuestionResponse.system_prompt
    for schema in (tevals.QUESTION_SCHEMA, tevals.CONTEXT_EVAL_SCHEMA, tevals.ANSWER_SCHEMA,
                   tevals.CLAIMS_SCHEMA, tevals.REVERSE_QUESTIONS_SCHEMA):
        assert list(schema["properties"]) == schema["required"] and schema["additionalProperties"] is False


@pytest.mark.parametrize(
    ("question", "ok"),
    [
        ("What bends light through a prism?", True),
        ("What does the context say about prisms?", False),
        ("Which document mentions yeast?", False),
        ("Is this a question about tides?", False),
        ("Light bends through prisms.", False),
        ("  What Bends LIGHT?  ", True),
    ],
)
def test_validate_question_matches_jax(question: str, ok: bool) -> None:
    content = json.dumps({"question": question})
    validate = schema_validator(tevals.QUESTION_SCHEMA, tevals.validate_question)
    try:
        jevals.QuestionResponse.model_validate_json(content)
        want = True
    except ValueError:
        want = False
    try:
        validate(content)
        got = True
    except ValueError:
        got = False
    assert got == want == ok


@pytest.mark.parametrize(
    ("content", "ok"),
    [
        ('{"claims": ["a", "b"]}', True),
        ('{"claims":["a","b"]}', True),
        ('{\n  "claims": [\n    "a",\n    "b"\n  ]\n}', True),
        ('{"claims": []}', True),
        ('{"claims": ["caf\\u00e9", "naïve \\"quoted\\""]}', True),
        ('{"claims": ["a"], "extra": 1}', False),
        ('{}', False),
        ('{"claims": "a"}', False),
        ('{"claims": [1, 2]}', False),
        ('["a"]', False),
        ('{"claims": ["a"]', False),
    ],
)
def test_schema_validator_agrees_with_pydantic(content: str, ok: bool) -> None:
    """The core's three-step validation (parse, conform, check) accepts
    what pydantic's model accepts on these documents: white space and key
    order are free, extra or missing keys and wrong types are not."""
    from pydantic import BaseModel, ConfigDict, Field

    class ClaimsResponse(BaseModel):
        """Standalone factual claims made by an answer."""

        model_config = ConfigDict(extra="forbid")
        claims: list[str] = Field(..., description="Short standalone factual claims made by the answer, one per item.")

    assert ClaimsResponse.model_json_schema() == tevals.CLAIMS_SCHEMA
    try:
        ClaimsResponse.model_validate_json(content)
        want = True
    except ValueError:
        want = False
    try:
        schema_validator(tevals.CLAIMS_SCHEMA)(content)
        got = True
    except ValueError:
        got = False
    assert got == want == ok


def test_schema_validator_key_order_is_free() -> None:
    schema = {
        "type": "object",
        "properties": {"a": {"type": "boolean"}, "b": {"type": "integer"}},
        "required": ["a", "b"],
        "additionalProperties": False,
    }
    assert schema_validator(schema)('{"b": 3, "a": true}') == {"b": 3, "a": True}
    with pytest.raises(ValueError, match="conform"):
        schema_validator(schema)('{"b": 3.5, "a": true}')


def test_extract_json_retries_then_raises(monkeypatch: pytest.MonkeyPatch) -> None:
    """The core asks again after a rejected response, up to llm_max_tries,
    and puts the schema in the prompt for an LLM without response formats."""
    import raglite_tpu_torch.extract as textract

    calls = []

    class NoFormat:
        supports_response_format = False

        def complete(self, messages, *, response_format=None, **kwargs):
            calls.append((messages, response_format))
            return ChatResponse(content='{"claims": ["x"]}' if len(calls) == 3 else "not json")

    monkeypatch.setattr(textract, "llm_from_config", lambda config: NoFormat())
    config = TConfig(device="cpu", llm="echo")
    got = extract_json(tevals.CLAIMS_SCHEMA, "ClaimsResponse", "Decompose.", schema_validator(tevals.CLAIMS_SCHEMA),
                       ["one", "two"], True, config)
    assert got == {"claims": ["x"]} and len(calls) == 3
    (system, user), response_format = calls[0]
    assert response_format is None and system["content"].startswith("Decompose.\n\nFormat your response according")
    assert user["content"] == '<context index="1">\none\n</context>\n\n<context index="2">\ntwo\n</context>'
    calls.clear()
    with pytest.raises(ValueError, match="Failed to extract ClaimsResponse"):
        extract_json(tevals.CLAIMS_SCHEMA, "ClaimsResponse", "Decompose.", lambda c: (_ for _ in ()).throw(ValueError(c)),
                     "text", True, config)
    assert len(calls) == config.llm_max_tries


def _prism_cases():
    """The JAX tests' echo cases (tests/test_evals.py): one frame per
    metric, as column dicts."""
    contexts = [
        "Refraction bends light as it passes through a glass prism, separating "
        "white light into its component colors according to wavelength."
    ]
    useful = "A glass prism separates white light into component colors through refraction."
    useless = "Sourdough bread rises because wild yeast ferments the dough overnight."
    question = "How does a glass prism separate white light into colors?"
    return {
        "faithfulness": {
            "question": ["What does a prism do to light?"] * 3,
            "answer": [
                "Refraction bends light through the glass prism. The prism separates "
                "white light into component colors by wavelength.",
                "Volcanic eruptions produce basalt columns. Honey never spoils in sealed amphorae.",
                "",
            ],
            "contexts": [contexts, contexts, [""]],
            "ground_truth": ["It separates light into colors."] * 3,
        },
        "precision": {
            "question": [question] * 3,
            "answer": ["It refracts light."] * 3,
            "contexts": [[useful, useless], [useless, useful], []],
            "ground_truth": ["Refraction separates the colors."] * 3,
        },
        "recall": {
            "question": ["How does a prism separate light?"] * 2,
            "answer": ["It refracts light."] * 2,
            "contexts": [
                ["A glass prism separates white light into component colors through refraction, "
                 "bending each wavelength by a different amount."],
                [useless],
            ],
            "ground_truth": ["The prism separates white light into component colors. Refraction "
                             "bends each wavelength differently."] * 2,
        },
        "relevancy": {
            "question": [question] * 2,
            "answer": [
                "A glass prism separates white light into colors by refraction.",
                "Honey never spoils when stored in sealed amphorae.",
            ],
            "contexts": [[""], [""]],
            "ground_truth": ["Refraction separates the colors."] * 2,
        },
    }


@pytest.mark.parametrize("case", ["faithfulness", "precision", "recall", "relevancy"])
@pytest.mark.parametrize("frame", ["dict", "DataFrame"])
def test_metrics_match_jax(case: str, frame: str) -> None:
    """The four metrics on the JAX tests' echo cases: judged columns equal
    (NaN where nothing could be judged), answer relevancy within rtol 1e-4;
    the port takes a dict of lists as well as a DataFrame."""
    columns = _prism_cases()[case]
    jcfg = JConfig(store_path=":memory:", embedder="hash:256", llm="echo")
    tcfg = TConfig(store_path=":memory:", embedder="hash:256", llm="echo", device="cpu")
    given = columns if frame == "dict" else pd.DataFrame(columns)
    for name in ("answer_faithfulness", "context_precision", "context_recall"):
        want = getattr(jevals, name)(pd.DataFrame(columns), jcfg)
        got = getattr(tevals, name)(given, tcfg)
        np.testing.assert_array_equal(got, want)
    want = jevals.answer_relevancy(pd.DataFrame(columns), jcfg)
    np.testing.assert_allclose(tevals.answer_relevancy(given, tcfg), want, rtol=1e-4, atol=1e-6)


def _same_evals(kb, n: int):
    """``n`` evals generated in the JAX package under seeds 0..n-1, stored in
    both packages' stores (generate_eval is held equal above)."""
    jcfg, tcfg = kb
    from raglite_tpu_torch.documents import Eval as TEval

    js, ts = jstore(jcfg), tstore(tcfg)
    for seed in range(n):
        random.seed(100 + seed)
        ev = jevals.generate_eval(max_chunks=4, config=jcfg)
        js.add_evals([ev])
        ts.add_evals([TEval(**{k: getattr(ev, k) for k in TEval.__dataclass_fields__})])


def test_answer_and_evaluate_match_jax(kb) -> None:
    """answer_evals equal column by column; evaluate's judged columns equal
    and its embedding columns within rtol 1e-4; the column functions equal
    the DataFrames."""
    jcfg, tcfg = kb
    _same_evals(kb, 3)
    want = jevals.answer_evals(num_evals=3, config=jcfg)
    got_columns = tevals.answer_evals_columns(3, config=tcfg)
    got = tevals.answer_evals(num_evals=3, config=tcfg)
    assert isinstance(got, pd.DataFrame) and list(got.columns) == list(want.columns)
    for column in want.columns:
        assert list(got[column]) == list(want[column]) == list(got_columns[column]), column
    want_m = jevals.evaluate(want, config=jcfg)
    got_m = tevals.evaluate(got, config=tcfg)
    assert list(got_m.columns) == list(want_m.columns)
    assert list(got_m["question"]) == list(want_m["question"])
    for column in JUDGED:
        np.testing.assert_array_equal(got_m[column].to_numpy(), want_m[column].to_numpy())
    for column in EMBEDDED:
        np.testing.assert_allclose(got_m[column].to_numpy(), want_m[column].to_numpy(), rtol=1e-4, atol=1e-6)
    cols = tevals.evaluate_columns(got_columns, tcfg)
    for column in (*JUDGED, *EMBEDDED):
        np.testing.assert_array_equal(np.asarray(cols[column]), got_m[column].to_numpy())
    # judge=False: the embedding columns alone; an int answers that many.
    plain = tevals.evaluate(2, config=tcfg, judge=False)
    assert list(plain.columns) == ["question", *EMBEDDED[:3]] and len(plain) == 2


def test_evaluate_without_evals_matches_jax() -> None:
    empty = {"question": [], "answer": [], "contexts": [], "ground_truth": []}
    want = jevals.evaluate(pd.DataFrame(empty), JConfig(store_path=":memory:", embedder="hash:128"))
    got = tevals.evaluate(empty, TConfig(store_path=":memory:", embedder="hash:128", device="cpu"))
    assert list(got.columns) == list(want.columns) and got.empty


def test_insert_evals_judges_negatives(tmp_path) -> None:
    """The port of tests/test_evals.py::test_generate_eval_judges_negatives:
    evals are stored, and the echo judge's gold sets are a strict subset of
    the corpus."""
    config = TConfig(store_path=str(tmp_path / "kb"), embedder="hash:128", llm="echo", device="cpu")
    tinsert([TDocument.from_text(t) for t in TEXTS[:2]], config=config)
    tevals.insert_evals(num_evals=4, config=config)
    store = tstore(config)
    assert store.evals
    assert any(len(ev.chunk_ids) < len(store.chunk_order) for ev in store.evals.values())


def test_generate_eval_requires_documents(tmp_path) -> None:
    config = TConfig(store_path=str(tmp_path / "empty"), embedder="hash:128", device="cpu")
    with pytest.raises(ValueError, match="insert_documents"):
        tevals.generate_eval(config=config)


def test_evals_run_without_pandas_and_pydantic(tmp_path) -> None:
    """With pandas, tqdm and pydantic unimportable (the card's machine may
    lack them), the package imports and the column functions and the
    adapter run; only the DataFrame entry points need pandas."""
    code = textwrap.dedent(
        f"""
        import random, sys
        for name in ("pandas", "tqdm", "pydantic"):
            sys.modules[name] = None
        from raglite_tpu_torch import Document, RAGLiteConfig, insert_documents, insert_evals, update_query_adapter
        from raglite_tpu_torch.evals import answer_evals, answer_evals_columns, evaluate_columns
        config = RAGLiteConfig(store_path={str(tmp_path / "kb")!r}, embedder="hash:128", llm="echo", device="cpu")
        insert_documents([Document.from_text(t) for t in {list(TEXTS)!r}], config=config)
        random.seed(0)
        insert_evals(num_evals=6, config=config)
        columns = answer_evals_columns(2, config=config)
        metrics = evaluate_columns(columns, config)
        assert len(metrics["faithfulness"]) == len(columns["question"]) == 2
        assert update_query_adapter(config=config).shape == (128, 128)
        try:
            answer_evals(1, config=config)
        except ImportError:
            print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
