"""Document, Chunk, ChunkSpan, and Eval records.

Behavioral parity with the reference's SQLModel ORM tables
(raglite/_database.py:63-515), re-designed as plain
dataclasses: there is no SQL backend — records are persisted by the
host-side columnar store (store.py) and chunk embeddings live in device
memory (index/dense.py), not in relational rows.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from hashlib import sha256
from pathlib import Path
from typing import Any
from xml.sax.saxutils import escape

import numpy as np

from raglite_tpu_torch.types import ChunkId, DocumentId, EvalId, FloatMatrix

# Line-level Markdown heading syntax. Headings are tracked with a direct
# line scanner (rather than a full Markdown token parse): the heading trail
# only needs ATX (`## Title`, optional closing hashes), setext (`Title`
# followed by a ===/--- underline), and enough fence awareness to not read
# `# comment` inside a code block as a heading.
_ATX = re.compile(r"^ {0,3}(#{1,6})(?:[ \t]+(.*?))?[ \t]*$")
_ATX_CLOSE = re.compile(r"[ \t]+#+[ \t]*$")
_SETEXT_UNDERLINE = re.compile(r"^ {0,3}(=+|-+)[ \t]*$")
_FENCE = re.compile(r"^ {0,3}(`{3,}|~{3,})")


def hash_bytes(data: bytes, max_len: int = 16) -> str:
    """Content hash used for idempotent ids (reference: _database.py:58-60)."""
    return sha256(data).hexdigest()[:max_len]


def adapt_metadata(metadata: Any) -> dict[str, list[Any]]:
    """Normalize metadata values to lists (reference: _database.py:51-55)."""
    if not metadata:
        return {}
    return {k: v if isinstance(v, list) else [v] for k, v in metadata.items()}


@dataclass
class Document:
    """A document (reference: _database.py:63-205).

    ``content`` is kept on the instance but not persisted by the store —
    mirroring the reference's PrivateAttr (_database.py:78).
    """

    id: DocumentId
    filename: str
    url: str | None = None
    metadata_: dict[str, Any] = field(default_factory=dict)
    content: str | None = None

    @property
    def front_matter(self) -> str:
        """Metadata as YAML front matter (reference: _database.py:97-104)."""
        metadata_lines = "\n".join(
            f"{key}: {value}" for key, value in self.metadata_.items() if value is not None
        )
        return f"---\n{metadata_lines}\n---" if metadata_lines else ""

    @staticmethod
    def from_path(
        doc_path: Path | str,
        *,
        id: DocumentId | None = None,  # noqa: A002
        url: str | None = None,
        **kwargs: Any,
    ) -> "Document":
        """Create a document from a file path; id defaults to a content hash
        (reference: _database.py:105-149).  The file is converted to
        Markdown by suffix (markdown.py:document_to_markdown): PDF, HTML,
        office formats, CSV/TSV, structured text as code blocks, anything
        else read as text."""
        from raglite_tpu_torch.markdown import document_to_markdown

        doc_path = Path(doc_path)
        metadata = adapt_metadata(
            {
                "filename": doc_path.name,
                "uri": id,
                "url": url,
                "size": doc_path.stat().st_size,
                "created": doc_path.stat().st_ctime,
                "modified": doc_path.stat().st_mtime,
                **kwargs,
            }
        )
        return Document(
            id=id if id is not None else hash_bytes(doc_path.read_bytes()),
            filename=doc_path.name,
            url=url,
            metadata_=metadata,
            content=document_to_markdown(doc_path),
        )

    @staticmethod
    def from_text(
        content: str,
        *,
        id: DocumentId | None = None,  # noqa: A002
        url: str | None = None,
        filename: str | None = None,
        **kwargs: Any,
    ) -> "Document":
        """Create a document from text; filename defaults to the (truncated)
        first line (reference: _database.py:151-201)."""
        first_line = content.strip().split("\n", 1)[0].strip()
        if len(first_line) > 80:
            first_line = f"{first_line[:80]}..."
        metadata = adapt_metadata(
            {
                "filename": filename or first_line,
                "uri": id,
                "url": url,
                "size": len(content.encode()),
                **kwargs,
            }
        )
        return Document(
            id=id if id is not None else hash_bytes(content.encode()),
            filename=filename or first_line,
            url=url,
            metadata_=metadata,
            content=content,
        )

    def __repr__(self) -> str:
        return f"Document(id={self.id!r}, filename={self.filename!r})"


@dataclass
class Chunk:
    """A document chunk (reference: _database.py:207-336)."""

    id: ChunkId
    document_id: DocumentId
    index: int
    headings: str
    body: str
    metadata_: dict[str, Any] = field(default_factory=dict)
    #: Back-reference filled in by the store on retrieval (reference uses a
    #: SQLAlchemy relationship, _database.py:228-230).
    document: Document | None = field(default=None, compare=False, repr=False)
    #: Multi-vector embedding rows, filled in lazily by the store/index.
    _embedding_matrix: FloatMatrix | None = field(default=None, compare=False, repr=False)

    @staticmethod
    def from_body(
        document: Document,
        index: int,
        body: str,
        headings: str = "",
        metadata: dict[str, Any] | None = None,
        **kwargs: Any,
    ) -> "Chunk":
        """Create a chunk with a deterministic id (reference: _database.py:232-249).

        Inherited document metadata goes through ``metadata`` (a plain dict),
        never splatted as kwargs — user metadata keys named ``index``/``body``/
        ``headings``/``document`` must not collide with the parameters."""
        return Chunk(
            id=hash_bytes(f"{document.id}-{index}".encode()),
            document_id=document.id,
            index=index,
            headings=Chunk.truncate_headings(headings, body),
            body=body,
            metadata_=adapt_metadata(
                {
                    "filename": document.filename,
                    "url": document.url,
                    **(metadata or {}),
                    **kwargs,
                }
            ),
            document=document,
        )

    @staticmethod
    def extract_heading_lines(doc: str, *, leading_only: bool = False) -> list[str]:
        """Rolling Markdown heading trail, one slot per level h1..h6.

        Behavioral parity with the reference's heading tracking
        (raglite/_database.py:251-268), built as a
        single-pass line scanner: each heading writes its slot and clears
        all deeper slots; with ``leading_only`` the scan stops at the first
        non-heading content so only the document's *leading* headings count.
        """
        trail = [""] * 6

        def note(level: int, text: str) -> None:
            trail[level - 1] = "#" * level + " " + text
            for deeper in range(level, 6):
                trail[deeper] = ""

        lines = doc.split("\n")
        total = len(lines)
        fence_char: str | None = None
        i = 0
        while i < total:
            line = lines[i]
            fence = _FENCE.match(line)
            if fence_char is not None:
                # Inside a code fence: content is opaque until the closer.
                if fence and fence.group(1)[0] == fence_char:
                    fence_char = None
                elif leading_only and line.strip():
                    break
                i += 1
                continue
            if fence:
                if leading_only:
                    break
                fence_char = fence.group(1)[0]
                i += 1
                continue
            if not line.strip():
                i += 1
                continue
            atx = _ATX.match(line)
            if atx:
                note(len(atx.group(1)), _ATX_CLOSE.sub("", atx.group(2) or "").strip())
                i += 1
                continue
            # Possible setext heading: a paragraph run directly followed by
            # a ===/--- underline. Collect the run, then look for the rule.
            underline_level = 0
            run_end = i
            paragraph: list[str] = []
            if not line.startswith(("    ", "\t")):
                while run_end < total:
                    candidate = lines[run_end]
                    rule = _SETEXT_UNDERLINE.match(candidate)
                    if rule and paragraph:
                        underline_level = 1 if rule.group(1)[0] == "=" else 2
                        break
                    if (
                        not candidate.strip()
                        or _ATX.match(candidate)
                        or _FENCE.match(candidate)
                    ):
                        break
                    paragraph.append(candidate.strip())
                    run_end += 1
            if underline_level:
                note(underline_level, " ".join(paragraph))
                i = run_end + 1
                continue
            if leading_only:
                break
            i += 1
        return trail

    @staticmethod
    def truncate_headings(headings: str, body: str) -> str:
        """Contextual headings strictly above the body's own leading heading.

        If the body opens at level L, inherited headings at level >= L are
        stale siblings/children and are dropped; a body with no leading
        heading keeps the whole trail (parity: _database.py:270-277).
        """
        body_lead = Chunk.extract_heading_lines(body, leading_only=True)
        cutoff = next((lvl for lvl, line in enumerate(body_lead, start=1) if line), 7)
        trail = Chunk.extract_heading_lines(headings)
        return "\n".join(
            line for lvl, line in enumerate(trail, start=1) if line and lvl < cutoff
        )

    def extract_headings(self) -> str:
        """Final heading state after this chunk (reference: _database.py:279-283)."""
        heading_lines = self.extract_heading_lines(self.headings + "\n\n" + self.body)
        return "\n".join(heading for heading in heading_lines if heading)

    @property
    def embedding_matrix(self) -> FloatMatrix:
        """Multi-vector embedding rows (reference: _database.py:285-289).

        Filled in by ``store.attach_embeddings`` / ``retrieve_chunks``.
        """
        if self._embedding_matrix is None:
            msg = f"chunk {self.id} has no attached embeddings"
            raise ValueError(msg)
        return np.asarray(self._embedding_matrix)

    @property
    def front_matter(self) -> str:
        """Filename/url/uri front matter (reference: _database.py:301-313)."""
        metadata = "\n".join(
            f"{key}: {_scalar(self.metadata_.get(key))}"
            for key in ("filename", "url", "uri")
            if _scalar(self.metadata_.get(key)) is not None
        )
        return f"---\n{metadata}\n---" if metadata else ""

    @property
    def content(self) -> str:
        """Front matter + contextual headings + body (reference: _database.py:315-318)."""
        return f"{self.front_matter}\n\n{self.headings.strip()}\n\n{self.body.strip()}".strip()

    def __hash__(self) -> int:
        return hash(self.id)

    def __str__(self) -> str:
        return self.content

    def __repr__(self) -> str:
        return json.dumps(
            {
                "id": self.id,
                "document_id": self.document_id,
                "index": self.index,
                "headings": self.headings,
                "body": self.body[:100],
                "metadata": self.metadata_,
            },
            indent=4,
        )


def _scalar(value: Any) -> Any:
    """Unwrap single-element metadata lists for display."""
    if isinstance(value, list) and len(value) == 1:
        return value[0]
    return value


@dataclass
class ChunkSpan:
    """A consecutive sequence of chunks from one document
    (reference: _database.py:339-395)."""

    chunks: list[Chunk]
    document: Document = field(init=False)

    def __post_init__(self) -> None:
        if self.chunks:
            assert self.chunks[0].document is not None
            self.document = self.chunks[0].document

    def _span_fields(self) -> dict[str, str]:
        """The span payload shared by both renderings: where the span came
        from (document id + source), its chunk-id range, and its text."""
        first, last = self.chunks[0], self.chunks[-1]
        return {
            "id": self.document.id,
            "source": self.document.url or self.document.filename,
            "from_chunk_id": first.id,
            "to_chunk_id": last.id,
            "headings": first.headings.strip(),
            "content": "".join(chunk.body for chunk in self.chunks).strip(),
        }

    def to_xml(self, index: int | None = None) -> str:
        """Render as an Anthropic long-context `<document>` element.

        Wire-format compatible with the reference (_database.py:349-368) so
        prompts built against reference output keep working; the rendering
        itself is assembled from the shared span payload.
        """
        if not self.chunks:
            return ""
        f = self._span_fields()
        open_attrs = ("" if index is None else f' index="{index}"') + f' id="{f["id"]}"'
        span_attrs = f'from_chunk_id="{f["from_chunk_id"]}" to_chunk_id="{f["to_chunk_id"]}"'
        parts = [f"<document{open_attrs}>"]
        parts.append(f"<source>{f['source']}</source>")
        parts.append(f"<span {span_attrs}>")
        for tag in ("headings", "content"):
            parts.append(f"<{tag}>\n{escape(f[tag])}\n</{tag}>")
        parts.append("</span>")
        parts.append("</document>")
        return "\n".join(parts)

    def to_json(self, index: int | None = None) -> str:
        """Render as a JSON document object (wire format: _database.py:370-389)."""
        if not self.chunks:
            return "{}"
        f = self._span_fields()
        payload: dict[str, Any] = {} if index is None else {"index": index}
        payload["id"] = f["id"]
        payload["source"] = f["source"]
        payload["span"] = {
            key: f[key] for key in ("from_chunk_id", "to_chunk_id", "headings", "content")
        }
        return json.dumps(payload)

    @property
    def content(self) -> str:
        """Front matter + heading + concatenated bodies (reference: _database.py:391-395)."""
        if not self.chunks:
            return ""
        front_matter = self.chunks[0].front_matter
        heading = self.chunks[0].headings.strip()
        bodies = "".join(chunk.body for chunk in self.chunks)
        # Strip only the ASSEMBLED string (reference: _database.py:391-395):
        # stripping `bodies` itself would drop the first chunk's own leading
        # newlines whenever front matter or heading is present.
        return f"{front_matter}\n\n{heading}\n\n{bodies}".strip()


@dataclass
class Eval:
    """A question/ground-truth evaluation example
    (reference: _database.py:476-515)."""

    id: EvalId
    document_id: DocumentId
    chunk_ids: list[ChunkId]
    question: str
    contexts: list[str]
    ground_truth: str
    metadata_: dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_chunks(
        question: str, contexts: list[Chunk], ground_truth: str, **kwargs: Any
    ) -> "Eval":
        """Deterministic id from document + chunks + question
        (reference: _database.py:497-515)."""
        document_id = contexts[0].document_id
        chunk_ids = [context.id for context in contexts]
        return Eval(
            id=hash_bytes(f"{document_id}-{chunk_ids}-{question}".encode()),
            document_id=document_id,
            chunk_ids=chunk_ids,
            question=question,
            contexts=[str(context) for context in contexts],
            ground_truth=ground_truth,
            metadata_=adapt_metadata(kwargs),
        )
