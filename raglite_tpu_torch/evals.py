"""Eval generation, answering and quality evaluation (counterpart of
raglite_tpu/evals.py).

``generate_eval`` / ``insert_evals`` make question-answer evals from the
store with the configured LLM, ``answer_evals`` answers them with ``rag()``,
and ``evaluate`` scores the answers: four LLM-judged metrics in the manner
of Ragas (faithfulness, context precision, answer relevancy, context
recall) beside three embedding cosines.  Every prompt, budget and fallback
is the JAX package's.

Two differences of form, because a GPU machine may have neither pandas,
tqdm nor pydantic:

- The response models are plain JSON schemas (pydantic's
  ``model_json_schema()`` of the JAX package's models, held equal by the
  tests) with check functions, driven through extract.py's core.  A
  response is parsed, must conform to its schema (the constrained
  decoder's automaton) and pass its check; unlike pydantic's lax mode, a
  boolean must be a JSON boolean.
- The metrics work on a mapping of columns ("question", "answer",
  "contexts", "ground_truth"), so a ``dict`` of lists serves as well as a
  ``pandas.DataFrame``; :func:`answer_evals_columns` and
  :func:`evaluate_columns` return dicts.  Only :func:`answer_evals` and
  :func:`evaluate` build the DataFrame the API returns, importing pandas
  when called.  No progress bars are shown.
"""

from __future__ import annotations

import contextlib
import json
import re
from collections.abc import Mapping, Sequence
from concurrent.futures import ThreadPoolExecutor, as_completed
from random import randint
from typing import TYPE_CHECKING, Any

import numpy as np

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.documents import Eval
from raglite_tpu_torch.embed import embed_queries
from raglite_tpu_torch.extract import extract_json, extract_json_batch_first_pass, schema_validator
from raglite_tpu_torch.rag import add_context, rag, retrieve_context
from raglite_tpu_torch.search import retrieve_chunk_spans, vector_search
from raglite_tpu_torch.store import store_from_config

if TYPE_CHECKING:
    import pandas as pd

__all__ = [
    "generate_eval",
    "insert_evals",
    "answer_evals",
    "answer_evals_columns",
    "evaluate",
    "evaluate_columns",
    "answer_faithfulness",
    "context_precision",
    "answer_relevancy",
    "context_recall",
]

#: A mapping of equally long columns: "question", "answer", "contexts"
#: (a list of strings per eval) and "ground_truth".
Columns = Mapping[str, Sequence[Any]]

EVALUATE_COLUMNS = (
    "question", "answer_similarity", "context_relevancy", "faithfulness_proxy",
    "faithfulness", "context_precision", "answer_relevancy", "context_recall",
)

# --- Response schemas (pydantic's model_json_schema() of the JAX models) ----

QUESTION_SCHEMA = {
    "additionalProperties": False,
    "description": "A specific question about the content of a set of document contexts.",
    "properties": {
        "question": {
            "description": "A specific question about the content of a set of document contexts.",
            "title": "Question",
            "type": "string",
        }
    },
    "required": ["question"],
    "title": "QuestionResponse",
    "type": "object",
}
QUESTION_SYSTEM_PROMPT = """
You are given a set of contexts extracted from a document.
You are a subject matter expert on the document's topic.
Your task is to generate a question to quiz other subject matter experts on the information in the provided context.
The question MUST be specific, self-contained, answerable using ONLY the provided context, and MUST NOT reference the existence of the context.
""".strip()

CONTEXT_EVAL_SCHEMA = {
    "additionalProperties": False,
    "description": "Indicate whether the provided context can be used to answer a given question.",
    "properties": {
        "hit": {
            "description": (
                "True if the provided context contains (a part of) the answer to the given "
                "question, false otherwise."
            ),
            "title": "Hit",
            "type": "boolean",
        }
    },
    "required": ["hit"],
    "title": "ContextEvalResponse",
    "type": "object",
}

ANSWER_SCHEMA = {
    "additionalProperties": False,
    "description": "Answer a question using the provided context.",
    "properties": {
        "answer": {
            "description": "A complete answer to the given question using the provided context.",
            "title": "Answer",
            "type": "string",
        }
    },
    "required": ["answer"],
    "title": "AnswerResponse",
    "type": "object",
}

CLAIMS_SCHEMA = {
    "additionalProperties": False,
    "description": "Standalone factual claims made by an answer.",
    "properties": {
        "claims": {
            "description": "Short standalone factual claims made by the answer, one per item.",
            "items": {"type": "string"},
            "title": "Claims",
            "type": "array",
        }
    },
    "required": ["claims"],
    "title": "ClaimsResponse",
    "type": "object",
}

REVERSE_QUESTIONS_SCHEMA = {
    "additionalProperties": False,
    "description": "Questions that a given answer directly and completely answers.",
    "properties": {
        "questions": {
            "description": (
                "Up to 3 distinct questions the given answer directly and completely answers. "
                "Empty if the answer is evasive, vague, or declines to answer."
            ),
            "items": {"type": "string"},
            "title": "Questions",
            "type": "array",
        }
    },
    "required": ["questions"],
    "title": "ReverseQuestions",
    "type": "object",
}
REVERSE_QUESTIONS_SYSTEM_PROMPT = (
    "You are given an answer. Generate up to 3 distinct questions that this "
    "answer directly and completely answers. If the answer is evasive, vague, "
    "or declines to answer, return an empty list."
)


def validate_question(value: dict[str, Any]) -> None:
    """Reject generic or context-referential questions (the JAX package's
    ``QuestionResponse.validate_question``)."""
    question = value["question"].strip().lower()
    if "context" in question or "document" in question or "question" in question:
        raise ValueError(value["question"])
    if not question.endswith("?"):
        raise ValueError(value["question"])


def _extract(schema: dict[str, Any], system_prompt: str, user_prompt, config: RAGLiteConfig, check=None) -> dict:
    """One strict extraction of ``schema`` (extract.py's core)."""
    return extract_json(
        schema, schema["title"], system_prompt, schema_validator(schema, check), user_prompt,
        True, config, description=schema["description"],
    )


# --- Eval generation ------------------------------------------------------------


def generate_eval(*, max_chunks: int = 20, config: RAGLiteConfig | None = None) -> Eval:
    """One eval: a random seed chunk, its related chunks by vector search,
    an LLM question about them, the question's candidate chunks judged for
    relevance by the LLM, and an LLM ground-truth answer from the relevant
    ones."""
    config = config or RAGLiteConfig()
    store = store_from_config(config)
    alive = store.alive_chunk_ids()
    if not alive:
        msg = "First run `insert_documents()` before generating evals."
        raise ValueError(msg)
    # A random live seed chunk, expanded by vector search on its mean
    # embedding.
    seed_chunk_id = alive[randint(0, len(alive) - 1)]  # noqa: S311
    seed_matrix = store.embeddings[seed_chunk_id].astype(np.float32)
    related_chunk_ids, _ = vector_search(
        np.mean(seed_matrix, axis=0),
        num_results=randint(1, max_chunks),  # noqa: S311
        config=config,
    )
    related_contexts = [
        str(span) if isinstance(span, str) else span.content
        for span in retrieve_chunk_spans(related_chunk_ids, config=config)
    ]
    question = _extract(QUESTION_SCHEMA, QUESTION_SYSTEM_PROMPT, related_contexts, config, validate_question)[
        "question"
    ]
    # Candidate chunks for the question, judged for relevance by the LLM.
    candidate_chunk_ids, _ = vector_search(question, num_results=2 * max_chunks, config=config)
    candidate_chunks = [store.get_chunk(cid) for cid in candidate_chunk_ids]
    judge_prompt = (
        "You are given a context extracted from a document. Determine whether it contains "
        f'(a part of) the answer to this question: "{question}"'
    )
    candidates = [c for c in candidate_chunks if c is not None]
    candidate_strs = [str(c) for c in candidates]
    # Judge all candidates in one batched decode where the LLM has one;
    # failures fall back to the per-chunk retry loop, and unjudgeable chunks
    # count as misses.
    validate_hit = schema_validator(CONTEXT_EVAL_SCHEMA)
    try:
        first_pass = extract_json_batch_first_pass(
            CONTEXT_EVAL_SCHEMA, CONTEXT_EVAL_SCHEMA["title"], judge_prompt, validate_hit, candidate_strs,
            True, config, description=CONTEXT_EVAL_SCHEMA["description"],
        )
    except Exception:  # noqa: BLE001 - e.g. a [B, T] cache or prefill out of memory
        first_pass = None  # degrade to the per-chunk loop below
    relevant_chunks = []
    for i, candidate in enumerate(candidates):
        verdict = first_pass[i] if first_pass is not None else None
        if verdict is None:
            with contextlib.suppress(ValueError):
                verdict = _extract(CONTEXT_EVAL_SCHEMA, judge_prompt, candidate_strs[i], config)
        if verdict is not None and verdict["hit"]:
            relevant_chunks.append(candidate)
    if not relevant_chunks:
        msg = "No relevant chunks found to answer the question."
        raise ValueError(msg)
    answer_prompt = (
        "You are given a set of contexts extracted from a document. Generate a complete, "
        f'self-contained answer to the following question using them: "{question}"'
    )
    answer = _extract(ANSWER_SCHEMA, answer_prompt, [str(c) for c in relevant_chunks], config)["answer"]
    return Eval.from_chunks(question=question, contexts=relevant_chunks, ground_truth=answer)


def insert_evals(
    *, num_evals: int = 100, max_chunks_per_eval: int = 20, config: RAGLiteConfig | None = None
) -> None:
    """Generate ``num_evals`` evals on 4 threads and store them; an eval
    that fails is left out."""
    config = config or RAGLiteConfig()
    store = store_from_config(config)
    evals: list[Eval] = []
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = [
            pool.submit(generate_eval, max_chunks=max_chunks_per_eval, config=config)
            for _ in range(num_evals)
        ]
        for future in as_completed(futures):
            with contextlib.suppress(Exception):
                evals.append(future.result())
    with store.write_lock():
        store.add_evals(evals)
        store.save()


# --- Answering ------------------------------------------------------------------


def answer_evals_columns(num_evals: int = 100, *, config: RAGLiteConfig | None = None) -> dict[str, list]:
    """Answer the first ``num_evals`` stored evals (by id) with ``rag()``
    over ``retrieve_context``: the columns question, answer, contexts and
    ground_truth."""
    config = config or RAGLiteConfig()
    store = store_from_config(config)
    evals = sorted(store.evals.values(), key=lambda e: e.id)[:num_evals]
    answers: list[str] = []
    contexts: list[list[str]] = []
    for eval_ in evals:
        spans = retrieve_context(query=eval_.question, config=config)
        messages = [add_context(user_prompt=eval_.question, context=spans, config=config)]
        answers.append("".join(rag(messages, config=config)))
        contexts.append([span.content for span in spans])
    return {
        "question": [e.question for e in evals],
        "answer": answers,
        "contexts": contexts,
        "ground_truth": [e.ground_truth for e in evals],
    }


def answer_evals(num_evals: int = 100, *, config: RAGLiteConfig | None = None) -> pd.DataFrame:
    """:func:`answer_evals_columns` as a ``pandas.DataFrame``."""
    import pandas as pd

    return pd.DataFrame(answer_evals_columns(num_evals, config=config))


# --- Metrics --------------------------------------------------------------------


def _similarity(a: list[str], b: list[str], config: RAGLiteConfig) -> np.ndarray:
    """Pairwise cosine similarity of two string lists (one batched embed)."""
    emb = embed_queries([*a, *b], config=config).astype(np.float32)
    ea, eb = emb[: len(a)], emb[len(a) :]
    return np.sum(ea * eb, axis=1)


#: A judgment's context budget (characters): judge prompts stay inside a
#: small local model's window.
_JUDGE_CONTEXT_CHARS = 6000
_SENTENCE_RE = re.compile(r"[^.!?\n]+[.!?]?")


def _judge_bool_batch(
    prompt_pairs: list[tuple[str, str]], field: str, config: RAGLiteConfig
) -> list[bool | None]:
    """One boolean verdict per (system prompt, user text) pair.

    The verdicts share one schema but not their system prompts (each names
    the claim or question under judgment), so they go to
    ``llm.complete_batch`` directly: one batched decode for the whole
    panel, with a per-item fallback; an item that cannot be judged gives
    None."""
    from raglite_tpu_torch.models.llm import llm_from_config

    llm = llm_from_config(config)
    schema = {
        "type": "object",
        "properties": {field: {"type": "boolean"}},
        "required": [field],
        "additionalProperties": False,
    }
    response_format = (
        {"type": "json_schema", "json_schema": {"name": "Verdict", "schema": schema, "strict": True}}
        if llm.supports_response_format
        else None
    )
    schema_suffix = (
        "" if response_format is not None
        else f"\n\nFormat your response according to this JSON schema:\n{schema}"
    )
    messages = [
        [{"role": "system", "content": system + schema_suffix}, {"role": "user", "content": user}]
        for system, user in prompt_pairs
    ]
    responses: list | None = None
    if hasattr(llm, "complete_batch"):
        try:
            responses = list(llm.complete_batch(messages, response_format=response_format))
        except Exception:  # noqa: BLE001 - e.g. the batched prefill out of memory
            responses = None
    verdicts: list[bool | None] = []
    for i, msg in enumerate(messages):
        response = responses[i] if responses is not None else None
        if response is None:
            try:
                response = llm.complete(msg, response_format=response_format)
            except Exception:  # noqa: BLE001
                response = None
        verdict: bool | None = None
        if response is not None and response.content:
            with contextlib.suppress(ValueError, TypeError, AttributeError):
                parsed = json.loads(response.content)
                if isinstance(parsed.get(field), bool):
                    verdict = parsed[field]
        verdicts.append(verdict)
    return verdicts


def _decompose_claims(question: str, answer: str, config: RAGLiteConfig) -> list[str]:
    """An answer's standalone factual claims (at most 16): the LLM's
    decomposition, else the answer's sentences."""
    system_prompt = (
        f'You are given the answer to the question "{question}". Decompose the answer '
        "into short standalone factual claims, each fully understandable on its own. "
        "Include every claim the answer makes and nothing it does not state."
    )
    claims: list[str] = []
    with contextlib.suppress(ValueError):
        claims = _extract(CLAIMS_SCHEMA, system_prompt, answer, config)["claims"]
    claims = [c.strip() for c in claims if c and c.strip()]
    if not claims:
        claims = [m.group(0).strip() for m in _SENTENCE_RE.finditer(answer) if m.group(0).strip()]
    return claims[:16]


def _claims_fraction(columns: Columns, text_column: str, judge: str, field: str, config: RAGLiteConfig) -> np.ndarray:
    """The fraction of each eval's claims (of ``text_column``) that the
    judge finds in its contexts; NaN where no claim could be judged."""
    pairs: list[tuple[str, str]] = []
    owners: list[int] = []
    for i, (question, text, contexts) in enumerate(
        zip(columns["question"], columns[text_column], columns["contexts"])
    ):
        context_block = "\n\n".join(contexts)[:_JUDGE_CONTEXT_CHARS]
        if not context_block.strip():
            continue
        for claim in _decompose_claims(question, str(text), config):
            pairs.append((judge.format(claim=claim), context_block))
            owners.append(i)
    verdicts = _judge_bool_batch(pairs, field, config)
    n = len(columns["question"])
    hits = np.zeros(n)
    total = np.zeros(n)
    for owner, verdict in zip(owners, verdicts):
        if verdict is not None:
            total[owner] += 1
            hits[owner] += bool(verdict)
    with np.errstate(invalid="ignore"):
        return np.where(total > 0, hits / np.maximum(total, 1), np.nan)


def answer_faithfulness(columns: Columns, config: RAGLiteConfig | None = None) -> np.ndarray:
    """LLM-judged faithfulness: the fraction of the answer's claims that
    the retrieved contexts directly support (NaN where none could be
    judged)."""
    judge = (
        "You are given context passages extracted from documents. Determine "
        'whether this claim is directly supported by them: "{claim}"'
    )
    return _claims_fraction(columns, "answer", judge, "supported", config or RAGLiteConfig())


def context_precision(columns: Columns, config: RAGLiteConfig | None = None) -> np.ndarray:
    """LLM-judged context precision: sum_k(precision@k * v_k) / sum_k(v_k)
    over the verdicts v_k of the retrieved contexts in their order (NaN
    where none could be judged)."""
    config = config or RAGLiteConfig()
    pairs: list[tuple[str, str]] = []
    owners: list[int] = []
    for i, (question, ground_truth, contexts) in enumerate(
        zip(columns["question"], columns["ground_truth"], columns["contexts"])
    ):
        system = (
            "You are given ONE retrieved context passage. Determine whether it contains "
            f'information useful for answering this question: "{question}" '
            f"(reference answer: {str(ground_truth)[:800]})"
        )
        for context in contexts:
            pairs.append((system, str(context)[:_JUDGE_CONTEXT_CHARS]))
            owners.append(i)
    verdicts = _judge_bool_batch(pairs, "useful", config)
    per_eval: dict[int, list[bool]] = {}
    for owner, verdict in zip(owners, verdicts):
        if verdict is not None:
            per_eval.setdefault(owner, []).append(bool(verdict))
    out = np.full(len(columns["question"]), np.nan)
    for i, ordered in per_eval.items():
        hits, score = 0, 0.0
        for k, useful in enumerate(ordered, start=1):
            if useful:
                hits += 1
                score += hits / k
        out[i] = score / hits if hits else 0.0
    return out


def answer_relevancy(columns: Columns, config: RAGLiteConfig | None = None) -> np.ndarray:
    """Answer relevancy: the mean cosine between the question and up to 3
    questions the LLM generates from the answer; where the answer yields
    none (an evasive answer), cosine(question, answer)."""
    config = config or RAGLiteConfig()
    reverse: list[list[str]] = []
    for answer in columns["answer"]:
        questions: list[str] = []
        with contextlib.suppress(ValueError):
            questions = _extract(REVERSE_QUESTIONS_SCHEMA, REVERSE_QUESTIONS_SYSTEM_PROMPT, str(answer), config)[
                "questions"
            ]
        reverse.append([q.strip() for q in questions if q and q.strip()][:3])
    # One batched embed: every question, every fallback answer and every
    # generated question.
    questions = [str(q) for q in columns["question"]]
    fallbacks = [str(a) for a in columns["answer"]]
    flat = [q for qs in reverse for q in qs]
    emb = embed_queries([*questions, *fallbacks, *flat], config=config).astype(np.float32)
    q_emb = emb[: len(questions)]
    a_emb = emb[len(questions) : 2 * len(questions)]
    r_emb = emb[2 * len(questions) :]
    out = np.zeros(len(questions))
    offset = 0
    for i, qs in enumerate(reverse):
        if qs:
            block = r_emb[offset : offset + len(qs)]
            offset += len(qs)
            out[i] = float(np.mean(block @ q_emb[i]))
        else:
            out[i] = float(a_emb[i] @ q_emb[i])
    return out


def context_recall(columns: Columns, config: RAGLiteConfig | None = None) -> np.ndarray:
    """LLM-judged context recall: the fraction of the ground truth's claims
    attributable to the retrieved contexts (NaN where none could be
    judged)."""
    judge = (
        "You are given context passages retrieved from documents. Determine "
        'whether this claim can be attributed to them: "{claim}"'
    )
    return _claims_fraction(columns, "ground_truth", judge, "attributed", config or RAGLiteConfig())


def evaluate_columns(
    columns: Columns | int = 100, config: RAGLiteConfig | None = None, *, judge: bool = True
) -> dict[str, Any]:
    """The metrics of answered evals (a mapping of columns, or the number
    of stored evals to answer first) as columns:

    - faithfulness, context_precision, answer_relevancy, context_recall:
      the LLM-judged metrics above (``judge=False`` leaves them out and
      calls no LLM);
    - answer_similarity: cosine(answer, ground_truth);
    - context_relevancy: the mean cosine(question, context);
    - faithfulness_proxy: cosine(answer, the contexts joined): topical
      agreement only, where ``faithfulness`` is the real metric.
    """
    config = config or RAGLiteConfig()
    if isinstance(columns, int):
        columns = answer_evals_columns(columns, config=config)
    questions = list(columns["question"])
    if not questions:
        return {name: [] for name in EVALUATE_COLUMNS}
    answer_similarity = _similarity(list(columns["answer"]), list(columns["ground_truth"]), config)
    # Context relevancy: one batched embed of every question and every
    # context (each question encoded once).
    contexts_per_eval = [list(ctx) or [""] for ctx in columns["contexts"]]
    flat_contexts = [c for ctx in contexts_per_eval for c in ctx]
    emb = embed_queries([*questions, *flat_contexts], config=config).astype(np.float32)
    q_emb = emb[: len(questions)]
    c_emb = emb[len(questions) :]
    context_relevancy = np.zeros(len(questions))
    offset = 0
    for i, ctx in enumerate(contexts_per_eval):
        block = c_emb[offset : offset + len(ctx)]
        offset += len(ctx)
        context_relevancy[i] = float(np.mean(block @ q_emb[i]))
    faithfulness_cosine = _similarity(
        list(columns["answer"]), ["\n".join(ctx) for ctx in columns["contexts"]], config
    )
    out: dict[str, Any] = {
        "question": questions,
        "answer_similarity": answer_similarity,
        "context_relevancy": context_relevancy,
        "faithfulness_proxy": faithfulness_cosine,
    }
    if judge:
        out["faithfulness"] = answer_faithfulness(columns, config)
        out["context_precision"] = context_precision(columns, config)
        out["answer_relevancy"] = answer_relevancy(columns, config)
        out["context_recall"] = context_recall(columns, config)
    return out


def evaluate(
    answered_evals: pd.DataFrame | Columns | int = 100,
    config: RAGLiteConfig | None = None,
    *,
    judge: bool = True,
) -> pd.DataFrame:
    """:func:`evaluate_columns` as a ``pandas.DataFrame`` (with the columns
    of all metrics, and no rows, when there are no evals)."""
    import pandas as pd

    out = evaluate_columns(answered_evals, config, judge=judge)
    if not len(out["question"]):
        return pd.DataFrame(columns=list(EVALUATE_COLUMNS))
    return pd.DataFrame(out)
