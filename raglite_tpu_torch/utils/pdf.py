"""Minimal first-party PDF text extractor.

Replaces the reference's dependency on pdftext/PDFium
(raglite/_markdown.py:9,202) with a self-contained
parser: indirect-object scanning, FlateDecode streams, content-stream
tokenization, and positioned text runs grouped into lines and blocks with
per-span font name/size — the structure `markdown.py` consumes for
font-size-based heading detection.

Scope: text extraction for Flate/uncompressed PDFs with simple (Type1/
TrueType) fonts AND composite CID/Type0 fonts carrying ToUnicode CMaps
(bfchar/bfrange, 1- and 2-byte code spaces) — the dominant modern-PDF
encoding (subset fonts emitted by LaTeX/Word/Chrome print).  Type0 fonts
WITHOUT a ToUnicode map (codes are raw glyph ids with no text meaning) and
image-only PDFs remain out of scope; callers should fall back to another
ingestion path for those.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["PdfSpan", "PdfLine", "PdfBlock", "PdfPage", "parse_pdf"]


@dataclass
class PdfSpan:
    text: str
    font_name: str
    font_size: float
    x: float
    y: float
    x_end: float = 0.0


@dataclass
class PdfLine:
    spans: list[PdfSpan] = field(default_factory=list)

    @property
    def y(self) -> float:
        return self.spans[0].y if self.spans else 0.0

    @property
    def text(self) -> str:
        """Concatenate spans, inserting a space at significant x-gaps."""
        parts: list[str] = []
        prev_end: float | None = None
        for s in self.spans:
            if (
                prev_end is not None
                and s.x - prev_end > 0.15 * max(s.font_size, 1.0)
                and parts
                and not parts[-1].endswith(" ")
                and not s.text.startswith(" ")
            ):
                parts.append(" ")
            parts.append(s.text)
            prev_end = max(s.x_end, s.x)
        return "".join(parts)


@dataclass
class PdfBlock:
    lines: list[PdfLine] = field(default_factory=list)


@dataclass
class PdfPage:
    number: int
    blocks: list[PdfBlock] = field(default_factory=list)


# --- Low-level object model ---------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b", re.S)
_NAME_RE = re.compile(rb"/([^\s/<>\[\]()]+)")


class _PdfFile:
    """All indirect objects of a PDF, found by linear scan (robust to broken
    xref tables, which are common in old PDFs)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.objects: dict[int, tuple[bytes, bytes | None]] = {}
        self._scan()

    def _scan(self) -> None:
        for m in _OBJ_RE.finditer(self.data):
            num = int(m.group(1))
            start = m.end()
            end = self.data.find(b"endobj", start)
            if end < 0:
                continue
            body = self.data[start:end]
            stream = None
            s = body.find(b"stream")
            if s >= 0:
                head = body[:s]
                raw = body[s + len(b"stream") :]
                if raw.startswith(b"\r\n"):
                    raw = raw[2:]
                elif raw.startswith(b"\n") or raw.startswith(b"\r"):
                    raw = raw[1:]
                e = raw.rfind(b"endstream")
                stream = raw[:e] if e >= 0 else raw
                body = head
            self.objects[num] = (body, stream)

    def resolve(self, token: bytes) -> bytes:
        """Resolve `N 0 R` references to the referenced object's dict."""
        m = re.match(rb"\s*(\d+)\s+\d+\s+R", token)
        if m:
            return self.objects.get(int(m.group(1)), (b"", None))[0]
        return token

    def get_stream(self, num: int) -> bytes | None:
        body, stream = self.objects.get(num, (b"", None))
        if stream is None:
            return None
        out = stream
        if re.search(rb"/Filter\s*(?:\[\s*)?/(?:FlateDecode|Fl)\b", body):
            try:
                out = zlib.decompress(out)
            except zlib.error:
                try:  # Tolerate trailing garbage.
                    out = zlib.decompressobj().decompress(out)
                except zlib.error:
                    return None
        return out

    @staticmethod
    def _dict_value(dict_bytes: bytes, key: bytes) -> bytes | None:
        """Extract the raw value following /key in a dictionary (best-effort)."""
        m = re.search(rb"/" + key + rb"\b\s*", dict_bytes)
        if not m:
            return None
        rest = dict_bytes[m.end() :]
        if rest.startswith(b"["):
            depth, i = 0, 0
            for i, ch in enumerate(rest):
                if ch == 0x5B:
                    depth += 1
                elif ch == 0x5D:
                    depth -= 1
                    if depth == 0:
                        break
            return rest[: i + 1]
        if rest.startswith(b"<<"):
            depth, i = 0, 0
            while i < len(rest) - 1:
                if rest[i : i + 2] == b"<<":
                    depth += 1
                    i += 2
                elif rest[i : i + 2] == b">>":
                    depth -= 1
                    i += 2
                    if depth == 0:
                        break
                else:
                    i += 1
            return rest[:i]
        m2 = re.match(rb"[^/\]>]*(?:\d+\s+\d+\s+R)?", rest)
        return m2.group(0).strip() if m2 else None


# --- Content-stream tokenizer -------------------------------------------------

_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


def _tokenize(content: bytes):  # noqa: C901, PLR0912
    """Yield (kind, value) tokens: 'num', 'str', 'name', 'op', 'arr_open/close'."""
    i, n = 0, len(content)
    while i < n:
        c = content[i : i + 1]
        if c in _WS:
            i += 1
        elif c == b"%":
            j = content.find(b"\n", i)
            i = n if j < 0 else j + 1
        elif c == b"(":
            # Literal string with escapes and balanced parens.
            depth, j, out = 1, i + 1, bytearray()
            while j < n and depth > 0:
                ch = content[j]
                if ch == 0x5C and j + 1 < n:  # backslash escape
                    nxt = content[j + 1]
                    esc = {0x6E: 0x0A, 0x72: 0x0D, 0x74: 0x09, 0x62: 0x08, 0x66: 0x0C}
                    if nxt in esc:
                        out.append(esc[nxt])
                        j += 2
                    elif 0x30 <= nxt <= 0x37:  # octal
                        k = j + 1
                        oct_digits = b""
                        while k < n and len(oct_digits) < 3 and 0x30 <= content[k] <= 0x37:
                            oct_digits += content[k : k + 1]
                            k += 1
                        out.append(int(oct_digits, 8) & 0xFF)
                        j = k
                    elif nxt in (0x0A, 0x0D):  # line continuation
                        j += 2
                    else:
                        out.append(nxt)
                        j += 2
                elif ch == 0x28:
                    depth += 1
                    out.append(ch)
                    j += 1
                elif ch == 0x29:
                    depth -= 1
                    if depth > 0:
                        out.append(ch)
                    j += 1
                else:
                    out.append(ch)
                    j += 1
            yield ("str", bytes(out))
            i = j
        elif c == b"<" and content[i : i + 2] != b"<<":
            j = content.find(b">", i)
            if j < 0:
                break
            hexstr = re.sub(rb"\s", b"", content[i + 1 : j])
            if len(hexstr) % 2:
                hexstr += b"0"
            try:
                yield ("str", bytes.fromhex(hexstr.decode("ascii", "ignore")))
            except ValueError:
                pass
            i = j + 1
        elif content[i : i + 2] == b"<<":
            yield ("dict_open", b"<<")
            i += 2
        elif content[i : i + 2] == b">>":
            yield ("dict_close", b">>")
            i += 2
        elif c == b"/":
            j = i + 1
            while j < n and content[j] not in _WS + _DELIM:
                j += 1
            yield ("name", content[i + 1 : j])
            i = j
        elif c == b"[":
            yield ("arr_open", b"[")
            i += 1
        elif c == b"]":
            yield ("arr_close", b"]")
            i += 1
        elif c in b"+-.0123456789":
            j = i + 1
            while j < n and content[j : j + 1] in b"+-.0123456789e":
                j += 1
            try:
                yield ("num", float(content[i:j]))
            except ValueError:
                pass
            i = j
        else:
            j = i
            while j < n and content[j] not in _WS + _DELIM:
                j += 1
            if j > i:
                yield ("op", content[i:j])
            i = max(j, i + 1)


# --- Text extraction ----------------------------------------------------------

# Computer-Modern/TeX and Standard-encoding specials that differ from Latin-1.
_GLYPH_FIXUPS = {
    0x0B: "ff", 0x0C: "fi", 0x0D: "fl", 0x0E: "ffi", 0x0F: "ffl",
    0x10: "ı", 0x12: "`", 0x13: "´", 0x14: "ˇ", 0x15: "˘",
    0x19: "ß", 0x1A: "æ", 0x1B: "œ", 0x1C: "ø",
    0x7B: "–", 0x7C: "—", 0x7D: "˝", 0x7F: "¨",
}


# CMSY (TeX math symbol) glyphs that appear in prose: x = section sign.
_CMSY_FIXUPS = {0x78: "§", 0x79: "†", 0x7A: "‡"}


@dataclass
class _FontInfo:
    """Per-font decode state resolved from the page's /Font resources."""

    name: str = "Unknown"
    #: code → unicode string from the font's ToUnicode CMap (None = absent).
    to_unicode: dict[int, str] | None = None
    #: bytes per character code: 1 for simple fonts, 2 for Identity-H/CID.
    code_bytes: int = 1
    #: Type0/CID composite font (2-byte codes even without ToUnicode).
    composite: bool = False


_DEFAULT_FONT = _FontInfo()


def _decode_simple(raw: bytes, font_name: str) -> str:
    if "CMSY" in font_name:
        return "".join(_CMSY_FIXUPS.get(b, chr(b) if 32 <= b < 127 else "") for b in raw)
    out = []
    for b in raw:
        if b in _GLYPH_FIXUPS and ("CM" in font_name or "TeX" in font_name):
            out.append(_GLYPH_FIXUPS[b])
        elif 32 <= b < 127:
            out.append(chr(b))
        elif b >= 160:
            out.append(bytes([b]).decode("latin-1"))
        else:
            out.append("")
    return "".join(out)


def _decode_text(raw: bytes, font: _FontInfo) -> str:
    """Decode a shown string through the font's ToUnicode CMap when present
    (CID/Type0 and subset simple fonts), else the byte-encoding heuristics.

    The reference reads these fonts through PDFium (pdftext,
    raglite/_markdown.py:9,202)."""
    if font.to_unicode is not None:
        step = font.code_bytes
        out: list[str] = []
        for i in range(0, len(raw) - step + 1, step):
            code = int.from_bytes(raw[i : i + step], "big")
            mapped = font.to_unicode.get(code)
            if mapped is None and step == 2 and not font.composite:
                # Mixed 1/2-byte simple-font CMaps: retry the single byte.
                mapped = font.to_unicode.get(raw[i])
            out.append(mapped if mapped is not None else "")
        return "".join(out)
    if font.composite:
        return ""  # raw glyph ids carry no text meaning without ToUnicode
    return _decode_simple(raw, font.name)


_HEX_TOKEN = re.compile(rb"<([0-9A-Fa-f\s]*)>|(\[)|(\])")


def _utf16_hex(dst_hex: bytes) -> str:
    """A CMap destination hex string -> unicode (UTF-16BE code units)."""
    h = re.sub(rb"\s", b"", dst_hex)
    if len(h) % 2:
        h += b"0"
    try:
        data = bytes.fromhex(h.decode("ascii"))
    except (ValueError, UnicodeDecodeError):
        return ""
    if len(data) % 2:  # single-byte destination (rare, but legal per spec)
        return data.decode("latin-1")
    return data.decode("utf-16-be", "ignore")


def _parse_tounicode(cmap: bytes) -> tuple[dict[int, str], int]:
    """Parse a ToUnicode CMap stream: bfchar pairs, bfrange triples (both the
    incrementing and the array-destination form), and the codespacerange
    which fixes the code width (PDF 32000 §9.10.3).  Returns
    (code→unicode, bytes-per-code)."""
    mapping: dict[int, str] = {}
    code_bytes = 0
    for m in re.finditer(rb"begincodespacerange(.*?)endcodespacerange", cmap, re.S):
        for h in re.finditer(rb"<([0-9A-Fa-f\s]*)>", m.group(1)):
            clean = re.sub(rb"\s", b"", h.group(1))
            code_bytes = max(code_bytes, (len(clean) + 1) // 2)
    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", cmap, re.S):
        items = re.findall(rb"<([0-9A-Fa-f\s]*)>", m.group(1))
        for i in range(0, len(items) - 1, 2):
            src_clean = re.sub(rb"\s", b"", items[i])
            if src_clean:
                mapping[int(src_clean, 16)] = _utf16_hex(items[i + 1])
    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", cmap, re.S):
        tokens = list(_HEX_TOKEN.finditer(m.group(1)))
        i = 0
        while i + 2 < len(tokens) or (i + 2 == len(tokens) and tokens[i + 1].group(1) is not None):
            lo_t, hi_t = tokens[i], tokens[i + 1] if i + 1 < len(tokens) else None
            if lo_t.group(1) is None or hi_t is None or hi_t.group(1) is None:
                i += 1
                continue
            lo = int(re.sub(rb"\s", b"", lo_t.group(1)) or b"0", 16)
            hi = int(re.sub(rb"\s", b"", hi_t.group(1)) or b"0", 16)
            if i + 2 >= len(tokens):
                break
            nxt = tokens[i + 2]
            if nxt.group(2) is not None:  # array form: [ <d1> <d2> ... ]
                j = i + 3
                code = lo
                while j < len(tokens) and tokens[j].group(3) is None:
                    if tokens[j].group(1) is not None and code <= hi:
                        mapping[code] = _utf16_hex(tokens[j].group(1))
                        code += 1
                    j += 1
                i = j + 1
            else:  # incrementing form: <lo> <hi> <dst>
                base = _utf16_hex(nxt.group(1) or b"")
                if base:
                    # The increment applies to the LAST UTF-16 code unit.
                    head, last = base[:-1], ord(base[-1])
                    for offset in range(hi - lo + 1):
                        mapping[lo + offset] = head + chr(last + offset)
                i += 3
    return mapping, code_bytes or 1


def _font_info(pdf: _PdfFile, fdict: bytes) -> _FontInfo:
    """Resolve one /Font resource dict into decode state."""
    bm = re.search(rb"/BaseFont\s*/([#\w\-+.]+)", fdict)
    name = bm.group(1).decode("latin-1") if bm else "Unknown"
    composite = re.search(rb"/Subtype\s*/Type0\b", fdict) is not None
    to_unicode: dict[int, str] | None = None
    code_bytes = 2 if composite else 1
    tu = pdf._dict_value(fdict, b"ToUnicode")
    if tu is not None:
        ref = re.match(rb"\s*(\d+)\s+\d+\s+R", tu)
        if ref is not None:
            stream = pdf.get_stream(int(ref.group(1)))
            if stream:
                to_unicode, declared = _parse_tounicode(stream)
                # Identity-H composite codes are 2 bytes regardless of a
                # sloppy 1-byte codespacerange in the ToUnicode CMap.
                code_bytes = max(declared, 2) if composite else declared
    return _FontInfo(name=name, to_unicode=to_unicode, code_bytes=code_bytes, composite=composite)


def _page_font_map(pdf: _PdfFile, page_dict: bytes) -> dict[bytes, _FontInfo]:
    """Map content-stream font resource names (/F5) to decode state."""
    res = pdf._dict_value(page_dict, b"Resources") or b""
    res = pdf.resolve(res)
    fonts_val = pdf._dict_value(res, b"Font") or b""
    fonts_val = pdf.resolve(fonts_val)
    font_map: dict[bytes, _FontInfo] = {}
    for m in re.finditer(rb"/([^\s/<>\[\]()]+)\s+(\d+)\s+\d+\s+R", fonts_val):
        fdict = pdf.objects.get(int(m.group(2)), (b"", None))[0]
        font_map[m.group(1)] = _font_info(pdf, fdict)
    return font_map


def _extract_page_spans(pdf: _PdfFile, content: bytes, font_map: dict[bytes, _FontInfo]) -> list[PdfSpan]:  # noqa: C901, PLR0912, PLR0915
    """Interpret enough of the text operators to get positioned runs.

    Implements proper text-matrix composition (PDF 32000 §9.4.2): ``Td``/``TD``
    moves are in text space and must be transformed by the current line
    matrix; the effective font size is ``Tf``-size × the matrix's y-scale.
    """
    spans: list[PdfSpan] = []
    stack: list[float | bytes] = []
    names: list[bytes] = []
    font, size = _DEFAULT_FONT, 10.0
    tm = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]  # current text matrix [a b c d e f]
    tlm = list(tm)  # line matrix
    leading = 0.0
    in_array: list = []
    collecting_array = False

    def translate_tlm(tx: float, ty: float) -> None:
        nonlocal tm, tlm
        tlm = [
            tlm[0], tlm[1], tlm[2], tlm[3],
            tx * tlm[0] + ty * tlm[2] + tlm[4],
            tx * tlm[1] + ty * tlm[3] + tlm[5],
        ]
        tm = list(tlm)

    def eff_size() -> float:
        return size * (tm[1] ** 2 + tm[3] ** 2) ** 0.5

    def show(raw: bytes) -> None:
        nonlocal tm
        text = _decode_text(raw, font)
        span = None
        if text:
            span = PdfSpan(text, font.name, round(eff_size(), 2), tm[4], tm[5])
            spans.append(span)
        # Advance along the baseline (~0.5 em per glyph; real width tables
        # are not needed for extraction-quality ordering).  Composite fonts
        # consume code_bytes bytes per glyph.
        adv = 0.5 * size * (len(raw) // font.code_bytes)
        tm = [tm[0], tm[1], tm[2], tm[3], adv * tm[0] + tm[4], adv * tm[1] + tm[5]]
        if span is not None:
            span.x_end = tm[4]

    def kern(amount: float) -> None:
        nonlocal tm
        adv = -amount / 1000.0 * size
        tm = [tm[0], tm[1], tm[2], tm[3], adv * tm[0] + tm[4], adv * tm[1] + tm[5]]

    for kind, val in _tokenize(content):
        if kind == "num":
            (in_array if collecting_array else stack).append(val)
        elif kind == "str":
            if collecting_array:
                in_array.append(val)
            else:
                stack.append(val)
        elif kind == "name":
            names.append(val)
        elif kind == "arr_open":
            collecting_array, in_array = True, []
        elif kind == "arr_close":
            collecting_array = False
        elif kind == "op":
            op = val
            if op == b"Tf" and names:
                font = font_map.get(names[-1]) or _FontInfo(name=names[-1].decode("latin-1"))
                size = float(stack[-1]) if stack and isinstance(stack[-1], float) else size
            elif op == b"Td" and len(stack) >= 2:
                translate_tlm(float(stack[-2]), float(stack[-1]))  # type: ignore[arg-type]
            elif op == b"TD" and len(stack) >= 2:
                leading = -float(stack[-1])  # type: ignore[arg-type]
                translate_tlm(float(stack[-2]), float(stack[-1]))  # type: ignore[arg-type]
            elif op == b"Tm" and len(stack) >= 6:
                tlm = [float(v) for v in stack[-6:]]  # type: ignore[arg-type]
                tm = list(tlm)
            elif op == b"T*":
                translate_tlm(0.0, -leading)
            elif op == b"TL" and stack:
                leading = float(stack[-1])  # type: ignore[arg-type]
            elif op == b"BT":
                tm = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]
                tlm = list(tm)
            elif op == b"Tj" and stack and isinstance(stack[-1], bytes):
                show(stack[-1])
            elif op in (b"'", b'"'):
                translate_tlm(0.0, -leading)
                raws = [v for v in stack if isinstance(v, bytes)]
                if raws:
                    show(raws[-1])
            elif op == b"TJ":
                for item in in_array:
                    if isinstance(item, bytes):
                        show(item)
                    elif isinstance(item, float):
                        if item < -120:  # inter-word gap in em-thousandths
                            spans.append(PdfSpan(" ", font.name, round(eff_size(), 2), tm[4], tm[5]))
                        kern(item)
                in_array = []
            stack.clear()
            names.clear()
    return spans


def _group_spans(spans: list[PdfSpan]) -> list[PdfBlock]:
    """Group positioned spans into lines (by y) and blocks (by y-gap)."""
    if not spans:
        return []
    lines_by_y: list[PdfLine] = []
    for span in spans:
        placed = False
        for line in lines_by_y:
            if abs(line.y - span.y) < max(2.0, 0.4 * span.font_size):
                line.spans.append(span)
                placed = True
                break
        if not placed:
            lines_by_y.append(PdfLine(spans=[span]))
    for line in lines_by_y:
        line.spans.sort(key=lambda s: s.x)
    lines_by_y.sort(key=lambda ln: -ln.y)
    # Split into blocks on vertical gaps larger than 1.8x the median spacing.
    gaps = [lines_by_y[i].y - lines_by_y[i + 1].y for i in range(len(lines_by_y) - 1)]
    med = sorted(gaps)[len(gaps) // 2] if gaps else 12.0
    blocks: list[PdfBlock] = [PdfBlock(lines=[lines_by_y[0]])]
    for i in range(1, len(lines_by_y)):
        if gaps[i - 1] > 1.8 * max(med, 1.0):
            blocks.append(PdfBlock())
        blocks[-1].lines.append(lines_by_y[i])
    return blocks


def _page_tree_order(pdf: "_PdfFile") -> list[int] | None:
    """Page object numbers in /Root -> /Pages -> /Kids READING order.

    Object numbers do not imply page order (incremental updates and many
    generators emit pages non-sequentially); only the page tree does."""
    catalog = next(
        (
            num
            for num, (body, _) in pdf.objects.items()
            if re.search(rb"/Type\s*/Catalog\b", body)
        ),
        None,
    )
    if catalog is None:
        return None
    visited: set[int] = set()

    def leaves(num: int, depth: int) -> list[int]:
        if depth > 64 or num in visited or num not in pdf.objects:
            return []
        visited.add(num)
        body = pdf.objects[num][0]
        if re.search(rb"/Type\s*/Page\b(?!s)", body):
            return [num]
        out: list[int] = []
        kids_val = pdf._dict_value(body, b"Kids") or b""
        for m in re.finditer(rb"(\d+)\s+\d+\s+R", kids_val):
            out.extend(leaves(int(m.group(1)), depth + 1))
        return out

    pages_ref = pdf._dict_value(pdf.objects[catalog][0], b"Pages") or b""
    m = re.search(rb"(\d+)\s+\d+\s+R", pages_ref)
    if m is None:
        return None
    return leaves(int(m.group(1)), 0) or None


def _page_content(pdf: "_PdfFile", body: bytes) -> bytes:
    """Concatenated content streams of one page.

    /Contents may reference streams directly OR point at an ARRAY object of
    stream references (PDF 32000 §7.7.3.3) — resolve one level of
    indirection for referenced objects that carry no stream themselves."""
    contents_val = pdf._dict_value(body, b"Contents") or b""
    streams: list[bytes] = []
    for m in re.finditer(rb"(\d+)\s+\d+\s+R", contents_val):
        num = int(m.group(1))
        stream = pdf.get_stream(num)
        if stream is not None:
            streams.append(stream)
            continue
        inner = pdf.objects.get(num)
        if inner is None:
            continue
        for m2 in re.finditer(rb"(\d+)\s+\d+\s+R", inner[0]):
            stream = pdf.get_stream(int(m2.group(1)))
            if stream is not None:
                streams.append(stream)
    return b"\n".join(streams)


def parse_pdf(path: Path | str) -> list[PdfPage]:
    """Parse a PDF into pages of blocks/lines/spans with font info."""
    data = Path(path).read_bytes()
    pdf = _PdfFile(data)
    pages: list[PdfPage] = []
    order = _page_tree_order(pdf)
    if order:
        page_objs = [(num, pdf.objects[num][0]) for num in order]
    else:  # damaged/missing page tree: fall back to object-number order
        page_objs = [
            (num, body)
            for num, (body, _) in sorted(pdf.objects.items())
            if re.search(rb"/Type\s*/Page\b(?!s)", body)
        ]
    for idx, (_, body) in enumerate(page_objs):
        content = _page_content(pdf, body)
        font_map = _page_font_map(pdf, body)
        spans = _extract_page_spans(pdf, content, font_map)
        pages.append(PdfPage(number=idx + 1, blocks=_group_spans(spans)))
    return pages
