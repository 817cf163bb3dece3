"""First-party converters for office/structured formats.

The reference shells out to pypandoc for anything that is not PDF or plain
Markdown (raglite/_markdown.py:197-221).  Pandoc is a
heavyweight external binary; these converters cover the common formats
with stdlib-only parsing:

- ``.docx``  — OOXML: paragraphs/headings/lists/tables from word/document.xml
- ``.pptx``  — OOXML slides: per-slide headings from title placeholders,
  bullets from body text frames
- ``.odt``   — ODF: headings (outline level), paragraphs, list items from
  content.xml
- ``.epub``  — zip of XHTML chapters -> the HTML->Markdown pipeline
- ``.rtf``   — control-word stripper with paragraph reconstruction
- ``.csv``/``.tsv`` — Markdown tables
- ``.json``/``.yaml``/``.yml``/``.toml`` — fenced code blocks
"""

from __future__ import annotations

import csv
import io
import re
import zipfile
from pathlib import Path
from xml.etree import ElementTree

__all__ = [
    "code_block_markdown",
    "csv_to_markdown",
    "docx_to_markdown",
    "epub_to_markdown",
    "odt_to_markdown",
    "pptx_to_markdown",
    "rtf_to_markdown",
]

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"


def _docx_paragraph(par: ElementTree.Element) -> str:
    """One OOXML paragraph -> one Markdown line (heading/list aware)."""
    texts: list[str] = []
    for run in par.iter(f"{_W}r"):
        bold = run.find(f"{_W}rPr/{_W}b") is not None
        italic = run.find(f"{_W}rPr/{_W}i") is not None
        chunk = "".join(
            node.text or "" for node in run.iter() if node.tag in (f"{_W}t", f"{_W}tab")
        )
        if not chunk:
            continue
        if bold:
            chunk = f"**{chunk}**"
        elif italic:
            chunk = f"*{chunk}*"
        texts.append(chunk)
    text = "".join(texts).strip()
    if not text:
        return ""
    style = par.find(f"{_W}pPr/{_W}pStyle")
    style_val = style.get(f"{_W}val", "") if style is not None else ""
    match = re.fullmatch(r"(?:Heading|berschrift|Titre)(\d)", style_val, re.IGNORECASE)
    if match:
        level = min(int(match.group(1)), 6)
        return "#" * level + " " + text
    if style_val.lower() == "title":
        return "# " + text
    if par.find(f"{_W}pPr/{_W}numPr") is not None:
        return "- " + text
    return text


def _docx_table(table: ElementTree.Element) -> str:
    rows = []
    for tr in table.findall(f"{_W}tr"):
        cells = []
        for tc in tr.findall(f"{_W}tc"):
            cell = " ".join(
                filter(None, (_docx_paragraph(p) for p in tc.findall(f"{_W}p")))
            )
            cells.append(cell.replace("|", "\\|"))
        rows.append("| " + " | ".join(cells) + " |")
    if not rows:
        return ""
    header_sep = "| " + " | ".join("---" for _ in rows[0].split("|")[1:-1]) + " |"
    return "\n".join([rows[0], header_sep, *rows[1:]])


def docx_to_markdown(path: Path | str) -> str:
    with zipfile.ZipFile(path) as zf:
        xml = zf.read("word/document.xml")
    root = ElementTree.fromstring(xml)
    body = root.find(f"{_W}body")
    parts: list[str] = []
    for element in body if body is not None else []:
        if element.tag == f"{_W}p":
            line = _docx_paragraph(element)
            if line:
                parts.append(line)
        elif element.tag == f"{_W}tbl":
            table = _docx_table(element)
            if table:
                parts.append(table)
    return "\n\n".join(parts) + "\n"


def _epub_spine_order(zf: zipfile.ZipFile) -> list[str] | None:
    """Chapter files in OPF spine (reading) order, or None when the package
    metadata is absent/invalid."""
    try:
        container = ElementTree.fromstring(zf.read("META-INF/container.xml"))
        ns_c = {"c": "urn:oasis:names:tc:opendocument:xmlns:container"}
        rootfile = container.find(".//c:rootfile", ns_c)
        opf_path = rootfile.get("full-path")  # type: ignore[union-attr]
        opf = ElementTree.fromstring(zf.read(opf_path))
        ns_o = {"o": "http://www.idpf.org/2007/opf"}
        base = opf_path.rsplit("/", 1)[0] + "/" if "/" in opf_path else ""
        hrefs = {
            item.get("id"): base + (item.get("href") or "")
            for item in opf.findall(".//o:manifest/o:item", ns_o)
        }
        order = [
            hrefs[ref.get("idref")]
            for ref in opf.findall(".//o:spine/o:itemref", ns_o)
            if ref.get("idref") in hrefs
        ]
        return order or None
    except (KeyError, ElementTree.ParseError, AttributeError):
        return None


def epub_to_markdown(path: Path | str) -> str:
    from raglite_tpu_torch.markdown import html_to_markdown

    parts: list[str] = []
    with zipfile.ZipFile(path) as zf:
        # Reading order comes from the OPF spine; a lexical filename sort
        # would scramble books with 10+ chapter files (ch10 before ch2).
        names = set(zf.namelist())
        chapters = _epub_spine_order(zf) or sorted(
            n for n in names if n.endswith((".xhtml", ".html", ".htm"))
        )
        for name in chapters:
            if name not in names:
                continue
            markdown = html_to_markdown(zf.read(name).decode("utf-8", errors="replace"))
            if markdown.strip():
                parts.append(markdown.strip())
    return "\n\n".join(parts) + "\n"


_RTF_DESTINATIONS = (
    "fonttbl", "colortbl", "stylesheet", "info", "pict", "header", "footer",
    "generator", "themedata",
)


def rtf_to_markdown(text: str) -> str:
    """Strip RTF control words, keeping paragraph structure and unicode
    escapes (\\uN)."""
    out: list[str] = []
    i, n = 0, len(text)
    depth_skip: list[int] = []
    depth = 0
    while i < n:
        ch = text[i]
        if ch == "{":
            depth += 1
            i += 1
        elif ch == "}":
            if depth_skip and depth_skip[-1] == depth:
                depth_skip.pop()
            depth -= 1
            i += 1
        elif ch == "\\":
            if text[i + 1 : i + 2] == "*":
                # \* marks an IGNORABLE destination: skip the whole group
                # (real Word files carry many — \*\listtable, \*\mmathPr, ...).
                depth_skip.append(depth)
                i += 2
                continue
            m = re.match(r"\\([a-z]+)(-?\d+)? ?", text[i:])
            if m:
                word, arg = m.group(1), m.group(2)
                if word in _RTF_DESTINATIONS:
                    depth_skip.append(depth)
                elif depth_skip:
                    pass  # inside a skipped destination: emit nothing
                elif word == "par":
                    out.append("\n\n")
                elif word == "tab":
                    out.append("\t")
                elif word == "u" and arg is not None:
                    code = int(arg)
                    out.append(chr(code + 65536 if code < 0 else code))
                    # \uN is followed by a fallback to skip: either one plain
                    # character or a \'hh escape (Word emits \u8217\'92).
                    tail = text[i + len(m.group(0)) :]
                    if tail[:2] == "\\'":
                        i += 4  # the \'hh fallback escape
                    elif tail[:1] not in ("\\", "{", "}", ""):
                        i += 1
                i += len(m.group(0))
            elif text[i + 1 : i + 2] in ("\\", "{", "}"):
                if not depth_skip:
                    out.append(text[i + 1])
                i += 2
            elif text[i + 1 : i + 2] == "'":
                # \'hh legacy-codepage escape: decode as cp1252 (the common
                # Windows RTF codepage) so accented text survives.
                hex_digits = text[i + 2 : i + 4]
                try:
                    if not depth_skip:
                        out.append(bytes([int(hex_digits, 16)]).decode("cp1252"))
                except (ValueError, UnicodeDecodeError):
                    pass
                i += 4
            else:
                i += 1
        else:
            if not depth_skip:
                out.append(ch)
            i += 1
    markdown = "".join(out)
    markdown = re.sub(r"[ \t]+", " ", markdown)
    markdown = re.sub(r"\n{3,}", "\n\n", markdown)
    return markdown.strip() + "\n"


def csv_to_markdown(text: str, *, delimiter: str = ",") -> str:
    rows = list(csv.reader(io.StringIO(text), delimiter=delimiter))
    if not rows:
        return ""
    width = max(len(r) for r in rows)
    norm = [r + [""] * (width - len(r)) for r in rows]
    lines = ["| " + " | ".join(c.replace("|", "\\|") for c in r) + " |" for r in norm]
    sep = "| " + " | ".join("---" for _ in range(width)) + " |"
    return "\n".join([lines[0], sep, *lines[1:]]) + "\n"


def code_block_markdown(text: str, language: str) -> str:
    fence = "````" if "```" in text else "```"
    return f"{fence}{language}\n{text.rstrip()}\n{fence}\n"


# --- pptx ---------------------------------------------------------------

_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
_P = "{http://schemas.openxmlformats.org/presentationml/2006/main}"


def _pptx_shape_text(shape: ElementTree.Element) -> list[str]:
    """Paragraph texts of one shape's text body."""
    out: list[str] = []
    for par in shape.iter(f"{_A}p"):
        text = "".join(node.text or "" for node in par.iter(f"{_A}t")).strip()
        if text:
            out.append(text)
    return out


def _pptx_is_title(shape: ElementTree.Element) -> bool:
    ph = shape.find(f"{_P}nvSpPr/{_P}nvPr/{_P}ph")
    return ph is not None and ph.get("type", "") in ("title", "ctrTitle")


def pptx_to_markdown(path: Path | str) -> str:
    """PowerPoint -> Markdown: one ``##`` heading per slide (the title
    placeholder when present), body text as bullets."""
    with zipfile.ZipFile(path) as zf:
        slide_names = sorted(
            (n for n in zf.namelist() if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)),
            key=lambda n: int(re.search(r"(\d+)", n).group(1)),
        )
        parts: list[str] = []
        for i, name in enumerate(slide_names, start=1):
            root = ElementTree.fromstring(zf.read(name))
            title: str | None = None
            bullets: list[str] = []
            for shape in root.iter(f"{_P}sp"):
                texts = _pptx_shape_text(shape)
                if not texts:
                    continue
                if title is None and _pptx_is_title(shape):
                    title = " ".join(texts)
                else:
                    bullets.extend(texts)
            parts.append(f"## {title or f'Slide {i}'}")
            parts.extend(f"- {b}" for b in bullets)
    return "\n\n".join(parts) + "\n"


# --- odt ----------------------------------------------------------------

_ODF_TEXT = "{urn:oasis:names:tc:opendocument:xmlns:text:1.0}"
_ODF_OFFICE = "{urn:oasis:names:tc:opendocument:xmlns:office:1.0}"


def _odt_text(element: ElementTree.Element) -> str:
    """Flatten an ODF paragraph/heading (tabs/spaces/spans included)."""
    parts: list[str] = [element.text or ""]
    for child in element:
        tag = child.tag
        if tag == f"{_ODF_TEXT}s":
            parts.append(" " * int(child.get(f"{_ODF_TEXT}c", "1")))
        elif tag == f"{_ODF_TEXT}tab":
            parts.append("\t")
        elif tag == f"{_ODF_TEXT}line-break":
            parts.append("\n")
        else:
            parts.append(_odt_text(child))
        parts.append(child.tail or "")
    return "".join(parts)


def odt_to_markdown(path: Path | str) -> str:
    """OpenDocument Text -> Markdown: outline-level headings, paragraphs,
    list items."""
    with zipfile.ZipFile(path) as zf:
        root = ElementTree.fromstring(zf.read("content.xml"))
    body = root.find(f"{_ODF_OFFICE}body/{_ODF_OFFICE}text")
    parts: list[str] = []

    def walk(element: ElementTree.Element, list_depth: int = 0) -> None:
        for child in element:
            tag = child.tag
            if tag == f"{_ODF_TEXT}h":
                level = min(int(child.get(f"{_ODF_TEXT}outline-level", "1") or 1), 6)
                text = _odt_text(child).strip()
                if text:
                    parts.append("#" * level + " " + text)
            elif tag == f"{_ODF_TEXT}p":
                text = _odt_text(child).strip()
                if text:
                    prefix = "  " * max(list_depth - 1, 0) + "- " if list_depth else ""
                    parts.append(prefix + text)
            elif tag == f"{_ODF_TEXT}list":
                for item in child.findall(f"{_ODF_TEXT}list-item"):
                    walk(item, list_depth + 1)

    if body is not None:
        walk(body)
    return "\n\n".join(parts) + "\n"
