"""The port's structured extraction (extract.py) and self-query search
against the JAX package's, on the CPU, with the echo LLM and with the
``jax:tiny`` decoder (the JAX weights carried across in f32 to both
factories, so both packages answer from the same model).

Tolerances: extracted models, metadata and filters equal; search ids equal.
"""

import importlib
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path
from typing import Annotated, ClassVar

import jax.numpy as jnp
import pytest
import torch
from pydantic import BaseModel, Field

import raglite_tpu.models.llm as jllm
import raglite_tpu_torch.models.llm as tllm
from raglite_tpu import RAGLiteConfig as JConfig
from raglite_tpu import search as jsearch
from raglite_tpu.documents import Document as JDocument
from raglite_tpu.extract import expand_document_metadata as j_expand
from raglite_tpu.extract import extract_with_llm as j_extract
from raglite_tpu.extract import self_query_filter as j_self_query
from raglite_tpu.insert import insert_documents as jinsert
from raglite_tpu.models import decoder as jdec
from raglite_tpu_torch import RAGLiteConfig as TConfig
from raglite_tpu_torch import expand_document_metadata as t_expand
from raglite_tpu_torch import extract_with_llm as t_extract
from raglite_tpu_torch import search as tsearch
from raglite_tpu_torch.documents import Document as TDocument
from raglite_tpu_torch.extract import self_query_filter as t_self_query
from raglite_tpu_torch.insert import insert_documents as tinsert
from raglite_tpu_torch.models import decoder as tdec

ROOT = Path(__file__).resolve().parent.parent
DOCS = {"MIGRATION.md": "migration", "BASELINE.md": "baseline", "PAPER.md": "paper"}
QUERIES = ("What does the baseline measure?", "migration of the reference symbols")
LLMS = ["echo", "jax:tiny"]
chip_smoke = importlib.import_module("chip_smoke")


class NameResponse(BaseModel):
    """A named response."""

    name: str = Field(..., description="The user's name.")
    system_prompt: ClassVar[str] = "Extract the user's name."


FIELDS = {
    "title": Annotated[str, Field(..., description="Document title.")],
    "reviewed": Annotated[bool, Field(..., description="Peer reviewed?")],
    "year": Annotated[int | None, Field(None, description="Year of publication.")],
}


@pytest.fixture(scope="module")
def same_decoder():
    """Both factories' ``jax:tiny`` answer from the JAX package's seeded
    weights, in f32."""
    j_llm = jdec.JaxChatLLM("tiny", seed=3, dtype=jnp.float32)
    t_llm = tdec.TorchChatLLM("tiny", device="cpu", dtype=torch.float32)
    t_llm.params = tdec.params_from_jax(j_llm.params, dtype=torch.float32)
    patch = pytest.MonkeyPatch()
    j_make, t_make = jllm._make_llm, tllm._make_llm
    patch.setattr(jllm, "_make_llm", lambda llm: j_llm if llm == "jax:tiny" else j_make(llm))
    patch.setattr(tllm, "_make_llm", lambda llm, device: t_llm if llm == "jax:tiny" else t_make(llm, device))
    yield
    patch.undo()


@pytest.fixture(scope="module")
def stores(tmp_path_factory: pytest.TempPathFactory, same_decoder):
    """A ``hash:256`` store in each package holding DOCS, each document
    tagged with its topic; configs per LLM."""
    root = tmp_path_factory.mktemp("extract")
    jcfg = JConfig(store_path=str(root / "jax"), embedder="hash:256", chunk_max_size=1024)
    tcfg = TConfig(store_path=str(root / "torch"), embedder="hash:256", chunk_max_size=1024, device="cpu")
    texts = {f: (ROOT / f).read_text(encoding="utf-8") for f in DOCS}
    jinsert([JDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=jcfg)
    tinsert([TDocument.from_text(t, id=f, topic=DOCS[f]) for f, t in texts.items()], config=tcfg)
    return {llm: (replace(jcfg, llm=llm), replace(tcfg, llm=llm)) for llm in LLMS}


@pytest.mark.parametrize("llm", LLMS)
@pytest.mark.parametrize("prompt", ["My name is Thomas A. Anderson.", ["chunk one", "chunk two"]], ids=["str", "list"])
def test_extract_with_llm_equals_jax(stores, llm: str, prompt) -> None:
    jcfg, tcfg = stores[llm]
    want = j_extract(NameResponse, prompt, config=jcfg, max_tokens=48)
    got = t_extract(NameResponse, prompt, config=tcfg, max_tokens=48)
    assert isinstance(got, NameResponse) and got == want


@pytest.mark.parametrize("llm", LLMS)
def test_expand_document_metadata_equals_jax(stores, llm: str) -> None:
    """Three documents through the batched first pass."""
    jcfg, tcfg = stores[llm]
    texts = [
        "A paper about relativity by A. Einstein, 1905.",
        (ROOT / "PAPER.md").read_text(encoding="utf-8")[:700],
        "Short note.",
    ]
    want = list(j_expand([JDocument.from_text(t, id=f"d{i}") for i, t in enumerate(texts)], FIELDS, config=jcfg, max_tokens=64))
    got = list(t_expand([TDocument.from_text(t, id=f"d{i}") for i, t in enumerate(texts)], FIELDS, config=tcfg, max_tokens=64))
    assert [d.metadata_ for d in got] == [d.metadata_ for d in want]
    assert all("title" in d.metadata_ for d in got)


@pytest.mark.parametrize("llm", LLMS)
def test_self_query_filter_equals_jax(stores, llm: str) -> None:
    jcfg, tcfg = stores[llm]
    for query in (*QUERIES, "papers about the baseline topic"):
        assert t_self_query(query, config=tcfg) == j_self_query(query, config=jcfg)


@pytest.mark.parametrize("llm", LLMS)
@pytest.mark.parametrize("search", ["vector_search", "keyword_search", "hybrid_search"])
def test_self_query_searches_equal_jax(stores, llm: str, search: str) -> None:
    """``self_query=True`` through each search and its batch form."""
    jcfg, tcfg = stores[llm]
    jcfg, tcfg = replace(jcfg, self_query=True), replace(tcfg, self_query=True)
    for query in QUERIES:
        want, _ = getattr(jsearch, search)(query, num_results=5, config=jcfg)
        got, _ = getattr(tsearch, search)(query, num_results=5, config=tcfg)
        assert got == want, (search, query)
    want_batch = [ids for ids, _ in getattr(jsearch, f"{search}_batch")(list(QUERIES), num_results=5, config=jcfg)]
    got_batch = [ids for ids, _ in getattr(tsearch, f"{search}_batch")(list(QUERIES), num_results=5, config=tcfg)]
    assert got_batch == want_batch


def test_echo_json_for_extract_schemas_equals_jax() -> None:
    """The echo LLM's schema instances for the schemas extract.py builds
    (a model with a ClassVar prompt, metadata fields with extra="forbid",
    a self-query model of ``list[int] | None`` fields)."""
    from pydantic import ConfigDict, create_model

    models = [
        NameResponse,
        create_model("DocumentMetadata", __config__=ConfigDict(extra="forbid"), **FIELDS),
        create_model("DocumentMetadata", __config__=ConfigDict(extra="forbid"), topic=str, audience=str),
        create_model(
            "MetadataFilterModel",
            topic=(list[int] | None, Field(default=None, description="Allowed options: {0: 'a', 1: 'b'}")),
            type=(list[int] | None, Field(default=None)),
        ),
    ]
    messages = [
        {"role": "system", "content": 'Judge "whether the passage answers the question" strictly.'},
        {"role": "user", "content": "The passage answers: what does the baseline measure in the paper?"},
    ]
    for model in models:
        response_format = {"type": "json_schema", "json_schema": {"name": model.__name__, "schema": model.model_json_schema()}}
        want = jllm.EchoLLM().complete(messages, response_format=response_format).content
        assert tllm.EchoLLM().complete(messages, response_format=response_format).content == want


def test_chip_smoke_metadata_schema_is_pydantics(monkeypatch: pytest.MonkeyPatch) -> None:
    """The system prompt and schema chip_smoke.py sends for the fields
    {"topic": str, "audience": str} are those expand_document_metadata
    builds (pydantic's ``model_json_schema``)."""
    import raglite_tpu_torch.extract as textract

    seen = []

    class Recorder:
        supports_response_format = True

        def complete_batch(self, messages_batch, *, response_format=None, **sampling):
            seen.append((messages_batch, response_format))
            return [tllm.ChatResponse(content='{"topic": "t", "audience": "a"}') for _ in messages_batch]

    monkeypatch.setattr(textract, "llm_from_config", lambda config: Recorder())
    docs = list(t_expand([TDocument.from_text("x", id="x")], {"topic": str, "audience": str}, config=TConfig(device="cpu")))
    assert docs[0].metadata_["topic"] == ["t"]
    (messages,), response_format = seen[0]
    assert messages[0] == {"role": "system", "content": chip_smoke.METADATA_SYSTEM_PROMPT}
    assert response_format["json_schema"]["schema"] == chip_smoke.METADATA_SCHEMA


def test_import_leaves_pydantic_out() -> None:
    """Importing the package, extract.py and evals.py loads no pydantic; the
    pydantic entry points load it when called."""
    code = textwrap.dedent(
        """
        import sys
        import raglite_tpu_torch
        import raglite_tpu_torch.search, raglite_tpu_torch.rag, raglite_tpu_torch.models.decoder
        import raglite_tpu_torch.extract, raglite_tpu_torch.evals
        assert callable(raglite_tpu_torch.extract_with_llm)
        assert "pydantic" not in sys.modules, "pydantic"
        config = raglite_tpu_torch.RAGLiteConfig(store_path=":memory:", llm="echo", device="cpu")
        docs = raglite_tpu_torch.expand_document_metadata(
            [raglite_tpu_torch.Document.from_text("x")], {"topic": str}, config=config
        )
        assert [d.metadata_["topic"] for d in docs] == [["x"]] and "pydantic" in sys.modules
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_pdf_ingestion_names_its_roadmap_item(tmp_path: Path) -> None:
    """ROADMAP queue 1 item 3 (PDF ingestion) is done: a PDF opens through
    ``Document.from_path`` as in the JAX package, where it once raised
    naming the item (tests/test_torch_markdown.py holds real PDFs)."""
    path = tmp_path / "x.pdf"
    path.write_bytes(b"%PDF-1.4\n")
    ours, theirs = TDocument.from_path(path), JDocument.from_path(path)
    assert (ours.id, ours.content) == (theirs.id, theirs.content)
