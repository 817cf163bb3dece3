"""The port's document conversion (markdown.py, utils/pdf.py,
utils/office.py, Document.from_path) against the JAX package's on the same
files, built here from the repo's Markdown and from hand-made PDFs and
office files: equal Markdown strings, equal parsed PDF pages, equal
documents."""

import dataclasses
import sys
import zipfile
from pathlib import Path

import pytest

import raglite_tpu.markdown as jmd
import raglite_tpu.utils.pdf as jpdf
import raglite_tpu_torch.markdown as tmd
import raglite_tpu_torch.utils.pdf as tpdf
from raglite_tpu.documents import Document as JDocument
from raglite_tpu_torch.documents import Document as TDocument
from tests.test_markdown import _cid_pdf, _mini_pdf
from tests.test_office_formats import _make_docx, _make_odt, _make_pptx

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TEXTS = chip_smoke.STORE_DOCS


@pytest.fixture(scope="module")
def documents(tmp_path_factory: pytest.TempPathFactory):
    """chip_smoke's eight documents (phase 11 (a)) from the repo's text."""
    texts = [(ROOT / name).read_text(encoding="utf-8") for name in TEXTS]
    return chip_smoke.write_documents(tmp_path_factory.mktemp("docs"), texts)


@pytest.mark.parametrize("kind", chip_smoke.DOC_KINDS)
def test_document_kinds_convert_as_jax(documents, kind: str) -> None:
    path, headings, sentence = documents[kind]
    markdown = tmd.document_to_markdown(path)
    assert markdown == jmd.document_to_markdown(path)
    chip_smoke.check_conversion(kind, markdown, headings, sentence)


@pytest.mark.parametrize("kind", chip_smoke.DOC_KINDS)
def test_from_path_equals_jax(documents, kind: str) -> None:
    path = documents[kind][0]
    t, j = TDocument.from_path(path, topic="port"), JDocument.from_path(path, topic="port")
    assert (t.id, t.filename, t.content) == (j.id, j.filename, j.content)
    assert t.metadata_ == j.metadata_


def _pages(module, path) -> list[dict]:
    return [dataclasses.asdict(page) for page in module.parse_pdf(path)]


@pytest.mark.parametrize(
    ("scrambled", "contents_array"), [(False, False), (True, False), (False, True), (True, True)]
)
def test_pdf_page_tree_and_contents_array(tmp_path, scrambled: bool, contents_array: bool) -> None:
    path = _mini_pdf(tmp_path, scrambled_pages=scrambled, contents_array=contents_array)
    pages = _pages(tpdf, path)
    assert pages == _pages(jpdf, path)
    assert "first page" in str(pages[0]) and "second page" in str(pages[1])
    assert tmd.document_to_markdown(path) == jmd.document_to_markdown(path)


def test_pdf_cid_tounicode_and_without(tmp_path) -> None:
    path = _cid_pdf(tmp_path)
    assert _pages(tpdf, path) == _pages(jpdf, path)
    markdown = tmd.document_to_markdown(path)
    assert markdown == jmd.document_to_markdown(path)
    assert "# CID Heading" in markdown
    stripped = tmp_path / "no_tounicode.pdf"
    stripped.write_bytes(path.read_bytes().replace(b" /ToUnicode 7 0 R", b""))
    assert _pages(tpdf, stripped) == _pages(jpdf, stripped)
    assert tmd.document_to_markdown(stripped) == jmd.document_to_markdown(stripped)


def test_multipage_pdf_pages_equal(documents) -> None:
    """chip_smoke's PDF: several pages, Flate streams, a Type1 body font and
    a Type0 heading font; every span equal."""
    pages = _pages(tpdf, documents["pdf"][0])
    assert len(pages) > 1
    assert pages == _pages(jpdf, documents["pdf"][0])


def test_html_to_markdown_equal() -> None:
    html = (
        "<html><head><title>skip</title><script>x()</script></head><body>"
        "<h1>Relativity</h1><p>On <strong>simultaneity</strong> and <em>light</em>.</p>"
        "<ul><li>alpha</li><li>beta <code>c</code></li></ul><ol><li>one</li></ol>"
        '<blockquote>quoted</blockquote><p>See <a href="http://x.test">the paper</a>.</p>'
        "<pre>code\n  block</pre></body></html>"
    )
    assert tmd.html_to_markdown(html) == jmd.html_to_markdown(html)
    assert "[the paper](http://x.test)" in tmd.html_to_markdown(html)


def _office_files(tmp_path) -> dict[str, Path]:
    files = {}
    files["docx"] = tmp_path / "doc.docx"
    _make_docx(files["docx"], [("Heading1", "Relativity"), ("", "Moving clocks run slow."), ("Heading2", "Length"), ("", "Rods contract.")])
    files["pptx"] = _make_pptx(tmp_path / "deck.pptx")
    files["odt"] = _make_odt(tmp_path / "report.odt")
    files["epub"] = tmp_path / "book.epub"
    with zipfile.ZipFile(files["epub"], "w") as zf:
        zf.writestr("ch1.xhtml", "<html><body><h1>Chapter One</h1><p>It was a dark night.</p></body></html>")
        zf.writestr("ch2.xhtml", "<html><body><h1>Chapter Two</h1><p>Dawn finally broke.</p></body></html>")
    files["rtf"] = tmp_path / "note.rtf"
    files["rtf"].write_text(r"{\rtf1\ansi{\fonttbl{\f0 Calibri;}}\f0 First paragraph.\par Second with \u233?clair and \'e9t\'e9.\par}")
    files["csv"] = tmp_path / "data.csv"
    files["csv"].write_text('name,score\nalice,10\n"b|ob",12\n')
    files["tsv"] = tmp_path / "data.tsv"
    files["tsv"].write_text("a\tb\n1\t2\n")
    files["json"] = tmp_path / "conf.json"
    files["json"].write_text('{"key": "```value```"}')
    files["md"] = tmp_path / "notes.md"
    files["md"].write_text("# Title\n\nBody text.\n")
    files["txt"] = tmp_path / "notes.txt"
    files["txt"].write_text("plain text\n")
    return files


@pytest.mark.parametrize("kind", ["docx", "pptx", "odt", "epub", "rtf", "csv", "tsv", "json", "md", "txt"])
def test_office_and_text_formats_equal(tmp_path, kind: str) -> None:
    path = _office_files(tmp_path)[kind]
    markdown = tmd.document_to_markdown(path)
    assert markdown == jmd.document_to_markdown(path)
    assert markdown.strip()


def test_undecodable_file_raises_as_jax(tmp_path) -> None:
    path = tmp_path / "blob.bin"
    path.write_bytes(bytes(range(128, 256)) * 4)
    with pytest.raises(ValueError, match="unsupported document format: .bin"):
        TDocument.from_path(path)
    with pytest.raises(ValueError, match="unsupported document format: .bin"):
        JDocument.from_path(path)
