"""Markdown block structure, without a Markdown package.

sentences.py and chunklets.py read only where Markdown blocks open: the
type and line ``map`` of ``heading_open`` (ATX and setext),
``blockquote_open``, ``paragraph_open``, ``bullet_list_open`` and
``ordered_list_open``.  This module finds them with a CommonMark block
scanner that follows the block rules of markdown-it (the parser the JAX
package uses, in its default CommonMark preset) line by line: indented and
fenced code, blockquotes, thematic breaks, lists, link reference
definitions, HTML blocks, ATX and setext headings and paragraphs, with the
same lazy continuation, interruption and nesting rules.  Nothing inside
code or HTML blocks is marked.  Inline syntax is not parsed: the callers
need none.

The token stream of a text is cached (the insert path parses the same text
for sentences and for chunklets).
"""

from __future__ import annotations

import html
import re
from functools import lru_cache

__all__ = ["BlockToken", "newline_offsets", "parse_markdown"]

_SPACE = (" ", "\t")
_MAX_NESTING = 20


class BlockToken:
    """An opening block token: ``type`` and ``map`` ([first line, line
    after the block]), as markdown-it names them."""

    __slots__ = ("map", "type")

    def __init__(self, type_: str, map_: list[int]) -> None:
        self.type = type_
        self.map = map_

    def __repr__(self) -> str:
        return f"BlockToken({self.type!r}, {self.map!r})"


_BLOCK_NAMES = (
    "address|article|aside|base|basefont|blockquote|body|caption|center|col|colgroup|dd|"
    "details|dialog|dir|div|dl|dt|fieldset|figcaption|figure|footer|form|frame|frameset|"
    "h1|h2|h3|h4|h5|h6|head|header|hr|html|iframe|legend|li|link|main|menu|menuitem|nav|"
    "noframes|ol|optgroup|option|p|param|search|section|summary|table|tbody|td|tfoot|th|"
    "thead|title|tr|track|ul"
)
_ATTRIBUTE = (
    r"(?:\s+[a-zA-Z_:][a-zA-Z0-9:._-]*"
    r"""(?:\s*=\s*(?:[^"'=<>`\x00-\x20]+|'[^']*'|"[^"]*"))?)"""
)
_OPEN_CLOSE_TAG = (
    rf"^(?:<[A-Za-z][A-Za-z0-9\-]*{_ATTRIBUTE}*\s*\/?>|<\/[A-Za-z][A-Za-z0-9\-]*\s*>)"
)
#: CommonMark's seven HTML block kinds: (start, end, may interrupt a paragraph).
_HTML_BLOCKS = (
    (re.compile(r"^<(script|pre|style|textarea)(?=(\s|>|$))", re.I),
     re.compile(r"<\/(script|pre|style|textarea)>", re.I), True),
    (re.compile(r"^<!--"), re.compile(r"-->"), True),
    (re.compile(r"^<\?"), re.compile(r"\?>"), True),
    (re.compile(r"^<![A-Z]"), re.compile(r">"), True),
    (re.compile(r"^<!\[CDATA\["), re.compile(r"\]\]>"), True),
    (re.compile(rf"^</?({_BLOCK_NAMES})(?=(\s|/?>|$))", re.I), re.compile(r"^$"), True),
    (re.compile(_OPEN_CLOSE_TAG + r"\s*$"), re.compile(r"^$"), False),
)
_BAD_PROTOCOL = re.compile(r"^(vbscript|javascript|file|data):")
_GOOD_DATA = re.compile(r"^data:image\/(gif|png|jpeg|webp);")
_ESCAPE = re.compile(r"\\([\\!\"#$%&'()*+,./:;<=>?@\[\]^`{}|_~-])")


def _unescape(text: str) -> str:
    return html.unescape(_ESCAPE.sub(r"\1", text))


class _Scanner:
    """Per-line state and block rules (markdown-it's StateBlock and
    rules_block, for block structure only)."""

    def __init__(self, src: str) -> None:
        self.src = src
        self.b: list[int] = []  # line start offsets
        self.e: list[int] = []  # line end offsets
        self.t: list[int] = []  # chars of leading whitespace
        self.s: list[int] = []  # indent width, tabs expanded
        self.bs: list[int] = []  # indent of the block's own content (blockquotes)
        found = False
        start = indent = offset = 0
        length = len(src)
        for pos, ch in enumerate(src):
            if not found:
                if ch in _SPACE:
                    indent += 1
                    offset += 4 - offset % 4 if ch == "\t" else 1
                    continue
                found = True
            if ch == "\n" or pos == length - 1:
                end = pos if ch == "\n" else pos + 1
                self._add_line(start, end, indent, offset)
                found = False
                indent = offset = 0
                start = end + 1
        self._add_line(length, length, 0, 0)
        self.line_max = len(self.b) - 1
        self.blk_indent = 0
        self.line = 0
        self.list_indent = -1
        self.parent = "root"
        self.level = 0
        self.tokens: list[BlockToken] = []
        self.rules = (
            self.code, self.fence, self.blockquote, self.hr, self.list, self.reference,
            self.html_block, self.heading, self.lheading, self.paragraph,
        )
        # The rules that may end a block of each kind (the paragraph's also
        # end blockquotes and reference definitions).
        self.ends_paragraph = (
            self.fence, self.blockquote, self.hr, self.list, self.html_block, self.heading,
        )
        self.ends_list = (self.fence, self.blockquote, self.hr)

    def _add_line(self, start: int, end: int, indent: int, offset: int) -> None:
        self.b.append(start)
        self.e.append(end)
        self.t.append(indent)
        self.s.append(offset)
        self.bs.append(0)

    # --- helpers ------------------------------------------------------------

    def ch(self, pos: int) -> str:
        return self.src[pos] if 0 <= pos < len(self.src) else ""

    def is_empty(self, line: int) -> bool:
        return self.b[line] + self.t[line] >= self.e[line]

    def is_code(self, line: int) -> bool:
        return self.s[line] - self.blk_indent >= 4

    def skip_empty(self, line: int) -> int:
        while line < self.line_max and self.is_empty(line):
            line += 1
        return line

    def skip_spaces(self, pos: int) -> int:
        while self.ch(pos) in _SPACE:
            pos += 1
        return pos

    def skip_char(self, pos: int, char: str) -> int:
        while self.ch(pos) == char:
            pos += 1
        return pos

    def terminates(self, rules, line: int, end: int) -> bool:
        return any(rule(line, end, True) for rule in rules)

    def push(self, type_: str, map_: list[int]) -> list[int]:
        self.tokens.append(BlockToken(type_, map_))
        return map_

    # --- block loop ---------------------------------------------------------

    def tokenize(self, line: int, end: int) -> None:
        while line < end:
            self.line = line = self.skip_empty(line)
            if line >= end or self.s[line] < self.blk_indent:
                break
            if self.level >= _MAX_NESTING:
                self.line = end
                break
            for rule in self.rules:
                if rule(line, end, False):
                    break
            line = self.line
            if line < end and self.is_empty(line):
                line += 1
                self.line = line

    # --- rules (each: start line, end line, silent -> matched) ---------------

    def code(self, start: int, end: int, silent: bool) -> bool:
        if not self.is_code(start):
            return False
        last = nxt = start + 1
        while nxt < end:
            if self.is_empty(nxt):
                nxt += 1
            elif self.is_code(nxt):
                nxt += 1
                last = nxt
            else:
                break
        self.line = last
        return True

    def fence(self, start: int, end: int, silent: bool) -> bool:
        pos, mx = self.b[start] + self.t[start], self.e[start]
        if self.is_code(start) or pos + 3 > mx:
            return False
        marker = self.src[pos]
        if marker not in ("~", "`"):
            return False
        mem = pos
        pos = self.skip_char(pos, marker)
        length = pos - mem
        if length < 3 or (marker == "`" and "`" in self.src[pos:mx]):
            return False
        if silent:
            return True
        nxt, closed = start, False
        while True:
            nxt += 1
            if nxt >= end:
                break
            pos = mem = self.b[nxt] + self.t[nxt]
            mx = self.e[nxt]
            if pos < mx and self.s[nxt] < self.blk_indent:
                break
            if pos >= len(self.src):
                break
            if self.src[pos] != marker or self.is_code(nxt):
                continue
            pos = self.skip_char(pos, marker)
            if pos - mem < length or self.skip_spaces(pos) < mx:
                continue
            closed = True
            break
        self.line = nxt + (1 if closed else 0)
        return True

    def _quote_line(self, line: int, pos: int, mx: int) -> bool:
        """Strip the '>' marker (at pos - 1) of ``line`` from its indent
        state, as markdown-it does; returns whether the rest is empty."""
        initial = offset = self.s[line] + 1
        nxt = self.ch(pos)
        adjust_tab = False
        space_after = nxt in _SPACE
        if nxt == " ":
            pos += 1
            initial += 1
            offset += 1
        elif nxt == "\t":
            if (self.bs[line] + offset) % 4 == 3:
                pos += 1
                initial += 1
                offset += 1
            else:
                adjust_tab = True
        self.b[line] = pos
        while pos < mx:
            ch = self.src[pos]
            if ch == "\t":
                offset += 4 - (offset + self.bs[line] + (1 if adjust_tab else 0)) % 4
            elif ch == " ":
                offset += 1
            else:
                break
            pos += 1
        self.bs[line] = self.s[line] + 1 + (1 if space_after else 0)
        self.s[line] = offset - initial
        self.t[line] = pos - self.b[line]
        return pos >= mx

    def blockquote(self, start: int, end: int, silent: bool) -> bool:
        old_line_max = self.line_max
        pos, mx = self.b[start] + self.t[start], self.e[start]
        if self.is_code(start) or self.ch(pos) != ">":
            return False
        if silent:
            return True
        saved = []  # (b, t, s, bs) of every line whose state changes
        saved.append((self.b[start], self.t[start], self.s[start], self.bs[start]))
        last_empty = self._quote_line(start, pos + 1, mx)
        old_parent, self.parent = self.parent, "blockquote"
        nxt = start + 1
        while nxt < end:
            outdented = self.s[nxt] < self.blk_indent
            pos, mx = self.b[nxt] + self.t[nxt], self.e[nxt]
            if pos >= mx:
                break
            if self.src[pos] == ">" and not outdented:
                saved.append((self.b[nxt], self.t[nxt], self.s[nxt], self.bs[nxt]))
                last_empty = self._quote_line(nxt, pos + 1, mx)
                nxt += 1
                continue
            if last_empty:
                break
            if self.terminates(self.ends_paragraph, nxt, end):
                self.line_max = nxt
                if self.blk_indent != 0:
                    saved.append((self.b[nxt], self.t[nxt], self.s[nxt], self.bs[nxt]))
                    self.s[nxt] -= self.blk_indent
                break
            saved.append((self.b[nxt], self.t[nxt], self.s[nxt], self.bs[nxt]))
            self.s[nxt] = -1  # a lazy continuation line
            nxt += 1
        old_indent, self.blk_indent = self.blk_indent, 0
        lines = self.push("blockquote_open", [start, 0])
        self.level += 1
        self.tokenize(start, nxt)
        self.level -= 1
        self.line_max = old_line_max
        self.parent = old_parent
        lines[1] = self.line
        for i, (b, t, s, bs) in enumerate(saved):
            self.b[start + i], self.t[start + i], self.s[start + i], self.bs[start + i] = b, t, s, bs
        self.blk_indent = old_indent
        return True

    def hr(self, start: int, end: int, silent: bool) -> bool:
        pos, mx = self.b[start] + self.t[start], self.e[start]
        if self.is_code(start):
            return False
        marker = self.ch(pos)
        if marker not in ("*", "-", "_"):
            return False
        count = 1
        for ch in self.src[pos + 1 : mx]:
            if ch != marker and ch not in _SPACE:
                return False
            count += ch == marker
        if count < 3:
            return False
        if not silent:
            self.line = start + 1
        return True

    def _bullet_marker(self, line: int) -> int:
        pos, mx = self.b[line] + self.t[line], self.e[line]
        if self.ch(pos) not in ("*", "-", "+"):
            return -1
        pos += 1
        if pos < mx and self.src[pos] not in _SPACE:
            return -1
        return pos

    def _ordered_marker(self, line: int) -> int:
        start = pos = self.b[line] + self.t[line]
        mx = self.e[line]
        if pos + 1 >= mx or not ("0" <= self.src[pos] <= "9"):
            return -1
        pos += 1
        while True:
            if pos >= mx:
                return -1
            ch = self.src[pos]
            pos += 1
            if "0" <= ch <= "9":
                if pos - start >= 10:
                    return -1
                continue
            if ch in (")", "."):
                break
            return -1
        if pos < mx and self.src[pos] not in _SPACE:
            return -1
        return pos

    def list(self, start: int, end: int, silent: bool) -> bool:
        if self.is_code(start):
            return False
        if (
            self.list_indent >= 0
            and self.s[start] - self.list_indent >= 4
            and self.s[start] < self.blk_indent
        ):
            return False
        interrupts = silent and self.parent == "paragraph" and self.s[start] >= self.blk_indent
        after = self._ordered_marker(start)
        if after >= 0:
            ordered = True
            first = self.b[start] + self.t[start]
            if interrupts and int(self.src[first : after - 1]) != 1:
                return False
        else:
            after = self._bullet_marker(start)
            if after < 0:
                return False
            ordered = False
        if interrupts and self.skip_spaces(after) >= self.e[start]:
            return False
        marker = self.src[after - 1]
        if silent:
            return True
        lines = self.push("ordered_list_open" if ordered else "bullet_list_open", [start, 0])
        self.level += 1
        nxt = start
        old_parent, self.parent = self.parent, "list"
        while nxt < end:
            pos, mx = after, self.e[nxt]
            initial = offset = self.s[nxt] + after - (self.b[start] + self.t[start])
            while pos < mx:
                ch = self.src[pos]
                if ch == "\t":
                    offset += 4 - (offset + self.bs[nxt]) % 4
                elif ch == " ":
                    offset += 1
                else:
                    break
                pos += 1
            content = pos
            indent_after = 1 if content >= mx else offset - initial
            if indent_after > 4:
                indent_after = 1
            indent = initial + indent_after
            self.level += 1  # list_item_open
            old_t, old_s = self.t[start], self.s[start]
            old_list_indent = self.list_indent
            self.list_indent = self.blk_indent
            self.blk_indent = indent
            self.t[start] = content - self.b[start]
            self.s[start] = offset
            if content >= mx and self.is_empty(start + 1):
                self.line = min(self.line + 2, end)
            else:
                self.tokenize(start, end)
            self.blk_indent = self.list_indent
            self.list_indent = old_list_indent
            self.t[start], self.s[start] = old_t, old_s
            self.level -= 1  # list_item_close
            nxt = start = self.line
            if nxt >= end or self.s[nxt] < self.blk_indent or self.is_code(start):
                break
            if self.terminates(self.ends_list, nxt, end):
                break
            if ordered:
                after = self._ordered_marker(nxt)
            else:
                after = self._bullet_marker(nxt)
            if after < 0 or marker != self.src[after - 1]:
                break
        self.level -= 1
        lines[1] = nxt
        self.line = nxt
        self.parent = old_parent
        return True

    def _next_ref_line(self, line: int) -> str | None:
        """The next line of a reference definition, or None where the
        definition cannot go on."""
        end = self.line_max
        if line >= end or self.is_empty(line):
            return None
        if not (self.is_code(line) or self.s[line] < 0):
            old_parent, self.parent = self.parent, "reference"
            stop = self.terminates(self.ends_paragraph, line, end)
            self.parent = old_parent
            if stop:
                return None
        return self.src[self.b[line] + self.t[line] : self.e[line] + 1]

    def reference(self, start: int, end: int, silent: bool) -> bool:
        pos, mx = self.b[start] + self.t[start], self.e[start]
        nxt = start + 1
        if self.is_code(start) or self.ch(pos) != "[":
            return False
        text = self.src[pos : mx + 1]

        def more() -> bool:
            nonlocal text, nxt
            line = self._next_ref_line(nxt)
            if line is None:
                return False
            text += line
            nxt += 1
            return True

        label_end = None
        pos = 1
        while pos < len(text):
            ch = text[pos]
            if ch == "[":
                return False
            if ch == "]":
                label_end = pos
                break
            if ch == "\n":
                more()
            elif ch == "\\":
                pos += 1
                if pos < len(text) and text[pos] == "\n":
                    more()
            pos += 1
        if label_end is None or text[label_end + 1 : label_end + 2] != ":":
            return False
        pos = label_end + 2
        while pos < len(text):
            ch = text[pos]
            if ch == "\n":
                more()
            elif ch not in _SPACE:
                break
            pos += 1
        dest_ok, pos, dest = _link_destination(text, pos, len(text))
        if not dest_ok:
            return False
        url = _unescape(dest).strip().lower()
        if _BAD_PROTOCOL.search(url) and not _GOOD_DATA.search(url):
            return False
        dest_end, dest_end_line = pos, nxt
        start_pos = pos
        while pos < len(text):
            ch = text[pos]
            if ch == "\n":
                more()
            elif ch not in _SPACE:
                break
            pos += 1
        title_ok, title_pos, title, can_continue, closer = _link_title(text, pos, len(text), None)
        while can_continue:
            mx = len(text)
            if not more():
                break
            pos = mx
            title_ok, title_pos, title, can_continue, closer = _link_title(
                text, pos, len(text), (title, closer)
            )
        if pos < len(text) and start_pos != pos and title_ok:
            pos = title_pos
        else:
            title = ""
            pos, nxt = dest_end, dest_end_line
        while pos < len(text) and text[pos] in _SPACE:
            pos += 1
        if pos < len(text) and text[pos] != "\n" and title:
            # Garbage after the title: the definition ends at the destination.
            title = ""
            pos, nxt = dest_end, dest_end_line
            while pos < len(text) and text[pos] in _SPACE:
                pos += 1
        if pos < len(text) and text[pos] != "\n":
            return False
        if not text[1:label_end].strip():
            return False
        if not silent:
            self.line = nxt
        return True

    def html_block(self, start: int, end: int, silent: bool) -> bool:
        pos, mx = self.b[start] + self.t[start], self.e[start]
        if self.is_code(start) or self.ch(pos) != "<":
            return False
        line_text = self.src[pos:mx]
        kind = next((k for k in _HTML_BLOCKS if k[0].search(line_text)), None)
        if kind is None:
            return False
        if silent:
            return kind[2]
        nxt = start + 1
        if not kind[1].search(line_text):
            while nxt < end:
                if self.s[nxt] < self.blk_indent:
                    break
                line_text = self.src[self.b[nxt] + self.t[nxt] : self.e[nxt]]
                if kind[1].search(line_text):
                    if line_text:
                        nxt += 1
                    break
                nxt += 1
        self.line = nxt
        return True

    def heading(self, start: int, end: int, silent: bool) -> bool:
        pos, mx = self.b[start] + self.t[start], self.e[start]
        if self.is_code(start) or self.ch(pos) != "#" or pos >= mx:
            return False
        level = 1
        pos += 1
        while self.ch(pos) == "#" and pos < mx and level <= 6:
            level += 1
            pos += 1
        if level > 6 or (pos < mx and self.ch(pos) not in _SPACE):
            return False
        if not silent:
            self.line = start + 1
            self.push("heading_open", [start, self.line])
        return True

    def lheading(self, start: int, end: int, silent: bool) -> bool:
        if self.is_code(start):
            return False
        level = None
        nxt = start + 1
        old_parent, self.parent = self.parent, "paragraph"
        while nxt < end and not self.is_empty(nxt):
            if self.s[nxt] - self.blk_indent > 3:
                nxt += 1
                continue
            if self.s[nxt] >= self.blk_indent:
                pos, mx = self.b[nxt] + self.t[nxt], self.e[nxt]
                if pos < mx and self.src[pos] in ("-", "="):
                    marker = self.src[pos]
                    if self.skip_spaces(self.skip_char(pos, marker)) >= mx:
                        level = 1 if marker == "=" else 2
                        break
            if self.s[nxt] < 0:
                nxt += 1
                continue
            if self.terminates(self.ends_paragraph, nxt, end):
                break
            nxt += 1
        if not level:
            # markdown-it leaves the parent type set here; the paragraph
            # rule that runs next saves and restores that value.
            return False
        self.line = nxt + 1
        self.push("heading_open", [start, self.line])
        self.parent = old_parent
        return True

    def paragraph(self, start: int, end: int, silent: bool) -> bool:
        nxt = start + 1
        end = self.line_max
        old_parent, self.parent = self.parent, "paragraph"
        while nxt < end and not self.is_empty(nxt):
            if self.s[nxt] - self.blk_indent > 3 or self.s[nxt] < 0:
                nxt += 1
                continue
            if self.terminates(self.ends_paragraph, nxt, end):
                break
            nxt += 1
        self.line = nxt
        self.push("paragraph_open", [start, nxt])
        self.parent = old_parent
        return True


def _link_destination(text: str, pos: int, mx: int) -> tuple[bool, int, str]:
    """(ok, end position, raw destination) of a link destination."""
    start = pos
    if pos < mx and text[pos] == "<":
        pos += 1
        while pos < mx:
            ch = text[pos]
            if ch in ("\n", "<"):
                return False, pos, ""
            if ch == ">":
                return True, pos + 1, text[start + 1 : pos]
            pos += 2 if ch == "\\" and pos + 1 < mx else 1
        return False, pos, ""
    level = 0
    while pos < mx:
        ch = text[pos]
        if ch == " " or ord(ch) < 0x20 or ch == "\x7f":
            break
        if ch == "\\" and pos + 1 < mx:
            if text[pos + 1] == " ":
                break
            pos += 2
            continue
        if ch == "(":
            level += 1
            if level > 32:
                return False, pos, ""
        if ch == ")":
            if level == 0:
                break
            level -= 1
        pos += 1
    if start == pos or level != 0:
        return False, pos, ""
    return True, pos, text[start:pos]


def _link_title(text: str, pos: int, mx: int, prev: tuple[str, str] | None):
    """(ok, end position, title, can continue, closing marker) of a link
    title starting at ``pos``, or continuing ``prev`` (title so far,
    closing marker) on the next line."""
    start = pos
    if prev is None:
        if pos >= mx or text[pos] not in ('"', "'", "("):
            return False, pos, "", False, ""
        closer = ")" if text[pos] == "(" else text[pos]
        title = ""
        start += 1
        pos += 1
    else:
        title, closer = prev
    while pos < mx:
        ch = text[pos]
        if ch == closer:
            return True, pos + 1, title + _unescape(text[start:pos]), False, closer
        if ch == "(" and closer == ")":
            return False, pos, title, False, closer
        if ch == "\\" and pos + 1 < mx:
            pos += 1
        pos += 1
    return False, pos, title + _unescape(text[start:pos]), True, closer


@lru_cache(maxsize=8)
def parse_markdown(doc: str) -> tuple[BlockToken, ...]:
    """The opening block tokens of ``doc`` in document order (cached: the
    tokens are shared, so callers must not change them).  Lines are counted
    after markdown-it's normalization (\\r\\n and \\r end lines too)."""
    src = re.sub(r"\r\n?", "\n", doc).replace("\0", "�")
    if not src:
        return ()
    scanner = _Scanner(src)
    scanner.tokenize(0, scanner.line_max)
    return tuple(scanner.tokens)


def newline_offsets(doc: str) -> list[int]:
    """Character offset of every markdown LINE start (\\n-separated).

    str.splitlines also splits on \\x0c/\\x0b/\\u2028/... which markdown-it
    does NOT count as lines, so token.map line numbers would otherwise point
    at the wrong offsets for PDF-extracted text containing form feeds."""
    offsets = [0]
    pos = doc.find("\n")
    while pos != -1:
        offsets.append(pos + 1)
        pos = doc.find("\n", pos + 1)
    return offsets
