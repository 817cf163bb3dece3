"""Convert documents to GitHub-Flavored Markdown.

Counterpart of the reference's pdftext/sklearn pipeline
(raglite/_markdown.py:13-221), operating on the
first-party PDF parser (utils/pdf.py) instead of PDFium, with a
self-contained weighted 1-D k-means for heading-size clustering instead of
sklearn (reference: _markdown.py:57-58).
"""

from __future__ import annotations

import re
from html.parser import HTMLParser
from pathlib import Path

import numpy as np

from raglite_tpu_torch.utils.pdf import PdfPage, parse_pdf

__all__ = ["document_to_markdown", "parsed_pdf_to_markdown", "html_to_markdown"]


def _kmeans_1d(values: np.ndarray, weights: np.ndarray, k: int, iters: int = 50) -> np.ndarray:
    """Weighted 1-D k-means. Deterministic: centers init at weighted quantiles."""
    k = min(k, len(values))
    order = np.argsort(values)
    values, weights = values[order], weights[order]
    cum = np.cumsum(weights) - weights / 2
    quantiles = (np.arange(k) + 0.5) / k * np.sum(weights)
    centers = np.interp(quantiles, cum, values)
    for _ in range(iters):
        assign = np.argmin(np.abs(values[:, None] - centers[None, :]), axis=1)
        new_centers = centers.copy()
        for j in range(k):
            m = assign == j
            if np.any(m):
                new_centers[j] = np.average(values[m], weights=weights[m])
        if np.allclose(new_centers, centers):
            break
        centers = new_centers
    return np.sort(np.unique(centers))[::-1]


def _effective_font_size(size: float, font_name: str) -> float:
    """Font size with fallback to digits embedded in the font name when the
    parsed size is degenerate (reference: _markdown.py:19-31 uses the same
    name-digit fallback for pdftext's size==1 sentinel)."""
    if size > 1.0:
        return size
    digits = re.findall(r"\d+", font_name or "")
    if digits:
        return float(digits[-1])
    return 1.0


def _is_bold(font_name: str) -> bool:
    name = (font_name or "").lower()
    return "bold" in name or "bx" in name or "bd" in name


def _is_italic(font_name: str) -> bool:
    name = (font_name or "").lower()
    return "ital" in name or "oblique" in name or re.search(r"cm(ti|mi|ssi|sl)", name) is not None


def parsed_pdf_to_markdown(pages: list[PdfPage]) -> list[str]:  # noqa: C901, PLR0912, PLR0915
    """Convert parsed PDF pages to Markdown (reference: _markdown.py:13-196).

    Heading detection: the mode font size (excluding tiny fonts) is the
    paragraph size; larger sizes are clustered into at most six levels
    (h1 = largest cluster).  Lines take the level of the majority of their
    characters.  Page-number-only lines are stripped, emphasis is derived
    from font names, and headings split across consecutive lines merge.
    """
    # --- Gather font-size statistics over all spans -------------------------
    sizes: list[float] = []
    weights: list[int] = []
    for page in pages:
        for block in page.blocks:
            for line in block.lines:
                for span in line.spans:
                    if span.text.strip():
                        sizes.append(round(_effective_font_size(span.font_size, span.font_name) * 2) / 2)
                        weights.append(len(span.text))
    if not sizes:
        return ["" for _ in pages]
    size_arr = np.asarray(sizes)
    weight_arr = np.asarray(weights, dtype=np.float64)
    unique_sizes = np.unique(size_arr)
    counts = np.array([weight_arr[size_arr == s].sum() for s in unique_sizes])
    # Paragraph size = mode among non-tiny sizes (reference: _markdown.py:47-52).
    tiny = unique_sizes < min(5.0, float(np.max(unique_sizes)))
    eligible = np.where(~tiny, counts, -counts)
    mode_font_size = unique_sizes[int(np.argmax(eligible))]
    # Cluster sizes above the mode into at most 6 heading levels.
    above = unique_sizes > mode_font_size
    if np.any(above):
        heading_sizes = _kmeans_1d(unique_sizes[above], counts[above], k=6)
    else:
        heading_sizes = np.array([])

    def span_level(span_size: float, font_name: str) -> int:
        """1..6 = heading, 7 = paragraph, 8 = small."""
        s = round(_effective_font_size(span_size, font_name) * 2) / 2
        if s < mode_font_size:
            return 8
        if s == mode_font_size or len(heading_sizes) == 0:
            return 7
        return int(np.argmin(np.abs(heading_sizes - s))) + 1

    # --- Emit Markdown ------------------------------------------------------
    pages_md: list[str] = []
    for page in pages:
        blocks_md: list[str] = []
        for block in page.blocks:
            lines_md: list[str] = []
            for line in block.lines:
                text_spans = [s for s in line.spans if s.text.strip()]
                if not text_spans:
                    continue
                raw = line.text
                # Strip page-number-only lines (reference: _markdown.py:106-119).
                if re.match(r"^\s*[#0]*\d+\s*$", raw):
                    continue
                # Majority heading level by character count.
                level_chars = np.zeros(9)
                for s in text_spans:
                    level_chars[span_level(s.font_size, s.font_name)] += len(s.text)
                level = int(np.argmax(level_chars[1:])) + 1
                line_bold = all(_is_bold(s.font_name) for s in text_spans)
                line_italic = all(_is_italic(s.font_name) for s in text_spans)
                # Per-span emphasis only when the whole line isn't emphasised.
                parts: list[str] = []
                prev_end: float | None = None
                for s in line.spans:
                    t = s.text
                    if (
                        prev_end is not None
                        and s.x - prev_end > 0.15 * max(s.font_size, 1.0)
                        and parts
                        and not parts[-1].endswith(" ")
                        and not t.startswith(" ")
                    ):
                        parts.append(" ")
                    prev_end = max(s.x_end, s.x)
                    if not t.strip():
                        parts.append(t)
                        continue
                    bold, italic = _is_bold(s.font_name), _is_italic(s.font_name)
                    if not line_bold and not line_italic and bold and italic:
                        parts.append(f"***{t}***")
                    elif not line_bold and bold:
                        parts.append(f"**{t}**")
                    elif not line_italic and italic:
                        parts.append(f"*{t}*")
                    else:
                        parts.append(t)
                line_text = "".join(parts).rstrip()
                if not line_text:
                    continue
                if level <= 6:
                    line_text = f"{'#' * level} {line_text}"
                elif line_bold and line_italic:
                    line_text = f"***{line_text}***"
                elif line_bold:
                    line_text = f"**{line_text}**"
                elif line_italic:
                    line_text = f"*{line_text}*"
                lines_md.append(line_text)
            if lines_md:
                blocks_md.append("\n".join(lines_md))
        pages_md.append("\n\n".join(blocks_md).strip())
    # Merge headings split across consecutive lines (reference: _markdown.py:166-182).
    def _merge(match: re.Match[str]) -> str:
        parts = [ln.strip("# ").strip() for ln in match.group().splitlines() if ln.strip()]
        return f"{match.group(1)} {' '.join(parts)}\n\n"

    pages_md = [
        re.sub(
            r"^(#+)[ \t]+[^\n]+\n+(?:^\1[ \t]+[^\n]+\n+)+",
            _merge,
            page + "\n\n",
            flags=re.MULTILINE,
        ).strip()
        for page in pages_md
    ]
    return pages_md


def document_to_markdown(doc_path: Path | str) -> str:
    """Convert a document file to Markdown (reference: _markdown.py:197-221).

    PDFs go through the first-party parser; ``.md``/``.txt`` are read as-is;
    other formats fall back to reading the file as text.
    """
    doc_path = Path(doc_path)
    suffix = doc_path.suffix.lower()
    if suffix == ".pdf":
        pages = parse_pdf(doc_path)
        return "\n\n".join(parsed_pdf_to_markdown(pages))
    if suffix in (".md", ".txt"):
        return doc_path.read_text()
    if suffix in (".html", ".htm", ".xhtml"):
        return html_to_markdown(doc_path.read_text())
    # First-party converters for the formats the reference hands to
    # pypandoc (_markdown.py:197-221) — see utils/office.py.
    if suffix == ".docx":
        from raglite_tpu_torch.utils.office import docx_to_markdown

        return docx_to_markdown(doc_path)
    if suffix == ".pptx":
        from raglite_tpu_torch.utils.office import pptx_to_markdown

        return pptx_to_markdown(doc_path)
    if suffix == ".odt":
        from raglite_tpu_torch.utils.office import odt_to_markdown

        return odt_to_markdown(doc_path)
    if suffix == ".epub":
        from raglite_tpu_torch.utils.office import epub_to_markdown

        return epub_to_markdown(doc_path)
    if suffix == ".rtf":
        from raglite_tpu_torch.utils.office import rtf_to_markdown

        return rtf_to_markdown(doc_path.read_text(errors="replace"))
    if suffix in (".csv", ".tsv"):
        from raglite_tpu_torch.utils.office import csv_to_markdown

        return csv_to_markdown(
            doc_path.read_text(), delimiter="\t" if suffix == ".tsv" else ","
        )
    if suffix in (".json", ".yaml", ".yml", ".toml"):
        from raglite_tpu_torch.utils.office import code_block_markdown

        return code_block_markdown(doc_path.read_text(), suffix.lstrip("."))
    try:
        return doc_path.read_text()
    except UnicodeDecodeError as error:
        msg = f"unsupported document format: {doc_path.suffix}"
        raise ValueError(msg) from error


class _HtmlToMarkdown(HTMLParser):
    """Minimal HTML → Markdown (headings, paragraphs, lists, emphasis,
    links, code, blockquotes).  First-party replacement for the reference's
    pypandoc fallback (_markdown.py:197-221) for the HTML case."""

    _SKIP = {"script", "style", "head", "title", "meta", "nav"}

    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.parts: list[str] = []
        self._skip_depth = 0
        self._list_stack: list[str] = []
        self._href: str | None = None

    def _tail(self, k: int = 4) -> str:
        """Last <= k characters of the output WITHOUT joining everything —
        re-joining per tag/data event would make conversion O(n^2)."""
        tail = ""
        for part in reversed(self.parts):
            tail = part + tail
            if len(tail) >= k:
                return tail[-k:]
        return tail

    def _newline(self, n: int = 2) -> None:
        tail = self._tail(n)
        if self.parts and tail != "\n" * n:
            trailing = len(tail) - len(tail.rstrip("\n"))
            if trailing < n:
                self.parts.append("\n" * (n - trailing))

    def handle_starttag(self, tag: str, attrs) -> None:
        if tag in self._SKIP:
            self._skip_depth += 1
            return
        if tag in ("h1", "h2", "h3", "h4", "h5", "h6"):
            self._newline()
            self.parts.append("#" * int(tag[1]) + " ")
        elif tag == "p" or tag == "div":
            self._newline()
        elif tag == "br":
            self.parts.append("\n")
        elif tag in ("ul", "ol"):
            self._list_stack.append(tag)
            self._newline()
        elif tag == "li":
            indent = "  " * max(len(self._list_stack) - 1, 0)
            marker = "-" if (self._list_stack and self._list_stack[-1] == "ul") else "1."
            self._newline(1)
            self.parts.append(f"{indent}{marker} ")
        elif tag in ("strong", "b"):
            self.parts.append("**")
        elif tag in ("em", "i"):
            self.parts.append("*")
        elif tag == "code":
            self.parts.append("`")
        elif tag == "pre":
            self._newline()
            self.parts.append("```\n")
        elif tag == "blockquote":
            self._newline()
            self.parts.append("> ")
        elif tag == "a":
            self._href = dict(attrs).get("href")
            self.parts.append("[")

    def handle_endtag(self, tag: str) -> None:
        if tag in self._SKIP:
            self._skip_depth = max(self._skip_depth - 1, 0)
            return
        if tag in ("h1", "h2", "h3", "h4", "h5", "h6", "p", "div", "blockquote"):
            self._newline()
        elif tag in ("ul", "ol"):
            if self._list_stack:
                self._list_stack.pop()
            self._newline()
        elif tag in ("strong", "b"):
            self.parts.append("**")
        elif tag in ("em", "i"):
            self.parts.append("*")
        elif tag == "code":
            self.parts.append("`")
        elif tag == "pre":
            self.parts.append("\n```")
            self._newline()
        elif tag == "a":
            self.parts.append(f"]({self._href})" if self._href else "]")
            self._href = None

    def handle_data(self, data: str) -> None:
        if self._skip_depth:
            return
        if self._tail().endswith(("\n", "# ", "- ", "1. ", "> ")) or not self.parts:
            data = data.lstrip("\n")
        if data.strip() or data == " ":
            self.parts.append(re.sub(r"[ \t]+", " ", data.replace("\n", " ")))


def html_to_markdown(html: str) -> str:
    """Convert HTML to Markdown with the stdlib parser."""
    parser = _HtmlToMarkdown()
    parser.feed(html)
    parser.close()
    return re.sub(r"\n{3,}", "\n\n", "".join(parser.parts)).strip() + "\n"
