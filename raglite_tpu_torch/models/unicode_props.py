"""The Unicode properties the ``tokenizers`` package's components read, and
extended grapheme clusters, for models/tokenizer.py.

``tokenizers`` (0.22) takes its properties from several Rust crates of
several Unicode versions: BERT's normalizer and pre-tokenizer (and the
``Punctuation`` pre-tokenizer) read general categories of about Unicode 8
(``unicode_categories``), the NF* forms and ``StripAccents`` those of
``unicode-normalization``, ``Lowercase``, ``Strip``, ``WhitespaceSplit``
and ``Digits`` Rust's own (newer than Python 3.12's Unicode 15.0), the
``Whitespace`` pre-tokenizer Oniguruma's ``\\w`` and ``\\s``, Split and
Replace patterns Oniguruma's ``\\p{...}`` sets, ``UnicodeScripts`` a
script table of its own, and ``Precompiled`` the grapheme clusters of
``unicode-segmentation``.  Each property here is derived from Python's
``unicodedata`` and then corrected by the code points where the two
disagree, or, where Python has no such property (scripts, blocks, binary
properties, Nmt's map), read from range tables; models/unicode_tables.py
holds both (generated by scripts/tokenizer_unicode_tables.py from
``tokenizers`` itself), so that the port gives ``tokenizers``' results on
every code point without it.

:func:`graphemes` splits text into extended grapheme clusters by the rules
of UAX #29 (GB3-GB13; GB9c, the Indic conjunct rule, is left out: it only
ever joins clusters of 9 or more UTF-8 bytes, which ``Precompiled`` looks
up character by character either way).
"""

from __future__ import annotations

import unicodedata
from bisect import bisect_right
from functools import lru_cache

from raglite_tpu_torch.models import unicode_tables as T


def _in(ranges: tuple[tuple[int, int], ...], cp: int) -> bool:
    """Whether ``cp`` lies in one of the sorted, disjoint, inclusive
    ``ranges``."""
    i = bisect_right(ranges, (cp, 0x10FFFF)) - 1
    return i >= 0 and ranges[i][0] <= cp <= ranges[i][1]


_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
#: Unicode White_Space (Rust's ``char::is_whitespace``).
WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000" + "".join(map(chr, range(0x2000, 0x200B))))


@lru_cache(maxsize=65536)
def is_other(c: str) -> bool:
    """``unicode_categories``' ``is_other`` as ``tokenizers`` reads it
    (Cc, Cf or Co in its Unicode version)."""
    return (unicodedata.category(c) in ("Cc", "Cf", "Co")) != _in(T.OTHER_FIX, ord(c))


@lru_cache(maxsize=65536)
def is_punctuation(c: str) -> bool:
    """BERT's punctuation: ASCII punctuation or a P* category (of the crate's
    Unicode version)."""
    return (c in _ASCII_PUNCT or unicodedata.category(c)[0] == "P") != _in(T.PUNCT_FIX, ord(c))


@lru_cache(maxsize=65536)
def is_nonspacing_mark(c: str) -> bool:
    """Mn, as BERT's ``strip_accents`` reads it."""
    return (unicodedata.category(c) == "Mn") != _in(T.MN_FIX, ord(c))


@lru_cache(maxsize=65536)
def is_combining_mark(c: str) -> bool:
    """M*, as the ``StripAccents`` normalizer reads it."""
    return (unicodedata.category(c)[0] == "M") != _in(T.MARK_FIX, ord(c))


@lru_cache(maxsize=65536)
def lower(c: str) -> str:
    """Rust's ``char::to_lowercase`` (full mappings, no context: a final
    sigma lowercases to σ)."""
    return T.LOWER_FIX.get(c) or c.lower()


def normalize(form: str, s: str) -> str:
    """``unicode-normalization``'s NFC, NFD, NFKC or NFKD: Python's, except
    that the code points the crate does not decompose are left as they
    are."""
    fixed = T.NF_FIXED[form]
    if not fixed or not any(_in(fixed, ord(c)) for c in s):
        return unicodedata.normalize(form, s)
    out, start = [], 0
    for i, c in enumerate(s):
        if _in(fixed, ord(c)):
            out += [unicodedata.normalize(form, s[start:i]), c]
            start = i + 1
    out.append(unicodedata.normalize(form, s[start:]))
    return "".join(out)


@lru_cache(maxsize=65536)
def word_class(c: str) -> int:
    """Oniguruma's classes as the ``Whitespace`` pre-tokenizer's
    ``\\w+|[^\\w\\s]+`` reads them: 0 a word character (L, M, Nd, Pc, Nl),
    1 white space, 2 anything else."""
    word = (unicodedata.category(c)[0] in "LM" or unicodedata.category(c) in ("Nd", "Pc", "Nl")) != _in(T.WORD_FIX, ord(c))
    if word:
        return 0
    return 1 if (c in WHITESPACE) != _in(T.SPACE_FIX, ord(c)) else 2


@lru_cache(maxsize=65536)
def is_whitespace(c: str) -> bool:
    """Rust's ``char::is_whitespace`` (``Strip``, ``WhitespaceSplit``)."""
    return (c in WHITESPACE) != _in(T.RUST_SPACE_FIX, ord(c))


@lru_cache(maxsize=65536)
def is_numeric(c: str) -> bool:
    """Rust's ``char::is_numeric`` (``Digits``): Nd, Nl or No."""
    return (unicodedata.category(c)[0] == "N") != _in(T.NUMERIC_FIX, ord(c))


@lru_cache(maxsize=1)
def nmt_map() -> dict[int, str | None]:
    """``Nmt``'s map as a ``str.translate`` table: control characters
    removed, the white space it knows turned into spaces."""
    table: dict[int, str | None] = {}
    for ranges, to in ((T.NMT_REMOVED, None), (T.NMT_SPACE, " ")):
        for a, b in ranges:
            table.update(dict.fromkeys(range(a, b + 1), to))
    return table


_SCRIPT_STARTS = [a for a, _, _ in T.SCRIPTS]


@lru_cache(maxsize=65536)
def script(c: str) -> int:
    """``UnicodeScripts``' script class of ``c``: 0 for Any (a space, an
    unassigned code point), which joins whatever run it is in; Hiragana,
    Katakana and U+30FC are in Han's class."""
    cp = ord(c)
    i = bisect_right(_SCRIPT_STARTS, cp) - 1
    return T.SCRIPTS[i][2] if i >= 0 and cp <= T.SCRIPTS[i][1] else 0


# --- Oniguruma's \\p{...} sets -------------------------------------------------

#: Oniguruma's one-letter general categories and LC, as unions.
_CATEGORY_GROUPS = {"L": "Lu Ll Lt Lm Lo", "M": "Mn Mc Me", "N": "Nd Nl No", "P": "Pc Pd Ps Pe Pi Pf Po",
                    "S": "Sm Sc Sk So", "Z": "Zs Zl Zp", "C": "Cc Cf Cs Co Cn", "LC": "Lu Ll Lt"}


@lru_cache(maxsize=1)
def _onig_categories() -> dict[str, list[tuple[int, int]]]:
    """Each two-letter general category as Oniguruma reads it: Python's,
    with the code points ``ONIG_GC_FIX`` moves."""
    python = [unicodedata.category(chr(cp)) for cp in range(0x110000)]
    cats = list(python)
    for cat, ranges in T.ONIG_GC_FIX.items():
        for a, b in ranges:
            for cp in range(a, b + 1):
                if python[cp] != cat:  # moved into cat (and so out of its own)
                    cats[cp] = cat
    out: dict[str, list[tuple[int, int]]] = {}
    start = 0
    for cp in range(1, 0x110001):
        if cp == 0x110000 or cats[cp] != cats[start]:
            out.setdefault(cats[start], []).append((start, cp - 1))
            start = cp
    return out


def merged(ranges) -> tuple[tuple[int, int], ...]:
    """Inclusive code point ranges, sorted and joined where they touch."""
    out: list[list[int]] = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return tuple((a, b) for a, b in out)


@lru_cache(maxsize=256)
def onig_property(name: str, in_class: bool = False) -> tuple[tuple[int, int], ...]:
    """The code points of Oniguruma's ``\\p{name}`` as sorted inclusive
    ranges (``in_class``: inside a character class, where Oniguruma reads
    Latin-1 through a table of its own).  Oniguruma ignores case, spaces,
    hyphens and underscores in the name, and a leading ``^`` negates it; a
    name it rejects raises ``ValueError``, as ``tokenizers`` does when it
    reads the pattern."""
    key = "".join(ch for ch in name if ch not in " -_").lower()
    negate = key.startswith("^")
    value = T.ONIG_ALIASES.get(key[1:] if negate else key)
    if value is None:
        msg = f"Oniguruma rejects the property name {name!r}"
        raise ValueError(msg)
    ranges = _onig_set(value)
    flips = T.ONIG_IN_CLASS_FIX.get(value) if in_class else None
    if flips:  # the symmetric difference
        ranges = merged([*intersect(ranges, complement(flips)), *intersect(flips, complement(ranges))])
    return complement(ranges) if negate else ranges


def _onig_set(value: str) -> tuple[tuple[int, int], ...]:
    """An ``ONIG_ALIASES`` value's ranges: a stored set, or a general
    category (or their union) as Oniguruma reads it."""
    if value in T.ONIG_SETS:
        return tuple((int(a, 16), int(b or a, 16)) for a, _, b in (r.partition("-") for r in T.ONIG_SETS[value].split()))
    cats = _onig_categories()
    return merged(r for cat in _CATEGORY_GROUPS.get(value, value).split() for r in cats.get(cat, ()))


#: The POSIX bracket names Oniguruma knows (``[:alpha:]``, ``[:^alpha:]``).
POSIX_NAMES = frozenset("alnum alpha ascii blank cntrl digit graph lower print punct space upper xdigit word".split())


@lru_cache(maxsize=32)
def posix_bracket(name: str) -> tuple[tuple[int, int], ...]:
    """The code points of Oniguruma's ``[:name:]`` inside a class: the
    property of that name, or the set ``ONIG_POSIX`` names where they differ
    (``punct`` takes the symbols too); another name raises ``ValueError``,
    as in Oniguruma."""
    negate = name.startswith("^")
    base = name[1:] if negate else name
    if base not in POSIX_NAMES:
        msg = f"Oniguruma rejects the POSIX bracket [:{name}:]"
        raise ValueError(msg)
    key = T.ONIG_POSIX.get(base)
    ranges = _onig_set(key) if key else onig_property(base, True)
    return complement(ranges) if negate else ranges


def intersect(a, b) -> tuple[tuple[int, int], ...]:
    """The intersection of two sorted, disjoint range tuples."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo <= hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tuple(out)


def complement(ranges: tuple[tuple[int, int], ...]) -> tuple[tuple[int, int], ...]:
    """The code points (0 to 0x10FFFF) outside sorted, disjoint ``ranges``."""
    out, start = [], 0
    for a, b in ranges:
        if a > start:
            out.append((start, a - 1))
        start = b + 1
    if start <= 0x10FFFF:
        out.append((start, 0x10FFFF))
    return tuple(out)


def is_chinese_char(c: str) -> bool:
    """The CJK ideograph blocks BERT pads with spaces."""
    cp = ord(c)
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


# --- Extended grapheme clusters (UAX #29) ------------------------------------

CR, LF, CONTROL, EXTEND, ZWJ, RI, PREPEND, SPACING, L, V, T_, LV, LVT, PICT, OTHER = range(15)

#: Grapheme_Cluster_Break=Prepend.
_PREPEND = (
    (0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F), (0x0890, 0x0891), (0x08E2, 0x08E2), (0x0D4E, 0x0D4E),
    (0x110BD, 0x110BD), (0x110CD, 0x110CD), (0x111C2, 0x111C3), (0x1193F, 0x1193F), (0x11941, 0x11941),
    (0x11A3A, 0x11A3A), (0x11A84, 0x11A89), (0x11D46, 0x11D46), (0x11F02, 0x11F02),
)
#: Other_Grapheme_Extend (Grapheme_Extend beyond Mn and Me), and the emoji
#: modifiers, which are Extend too.
_EXTEND_MORE = (
    (0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E), (0x0B57, 0x0B57), (0x0BBE, 0x0BBE), (0x0BD7, 0x0BD7),
    (0x0CC2, 0x0CC2), (0x0CD5, 0x0CD6), (0x0D3E, 0x0D3E), (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
    (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F), (0xFF9E, 0xFF9F), (0x1133E, 0x1133E), (0x11357, 0x11357),
    (0x114B0, 0x114B0), (0x114BD, 0x114BD), (0x115AF, 0x115AF), (0x11930, 0x11930), (0x1D165, 0x1D165),
    (0x1D16E, 0x1D172), (0x1F3FB, 0x1F3FF), (0xE0020, 0xE007F),
)
#: Spacing marks (Mc) that are not SpacingMark.
_NOT_SPACING = (
    (0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106D), (0x1083, 0x1083), (0x1087, 0x108C),
    (0x108F, 0x108F), (0x109A, 0x109C), (0x1A61, 0x1A61), (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
    (0x11720, 0x11721),
)
#: Unassigned Default_Ignorable_Code_Points (Control).
_IGNORABLE_CN = ((0x2065, 0x2065), (0xFFF0, 0xFFF8), (0xE0000, 0xE0000), (0xE0002, 0xE001F), (0xE0080, 0xE00FF), (0xE01F0, 0xE0FFF))
#: Extended_Pictographic (emoji-data.txt).
_PICT = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122), (0x2139, 0x2139),
    (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0),
    (0x25FB, 0x25FE), (0x2600, 0x2605), (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
    (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0), (0x27BF, 0x27BF), (0x2934, 0x2935),
    (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F),
    (0x1F16C, 0x1F171), (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5),
    (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F), (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F),
    (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F),
    (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD),
)


def _base_class(c: str) -> int:
    """Grapheme_Cluster_Break (with Extended_Pictographic) from
    ``unicodedata`` and the tables above."""
    cp = ord(c)
    if c == "\r":
        return CR
    if c == "\n":
        return LF
    if c == "\u200d":
        return ZWJ
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return RI
    if _in(_PREPEND, cp):
        return PREPEND
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or _in(_EXTEND_MORE, cp):
        return EXTEND
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs") or (cat == "Cn" and _in(_IGNORABLE_CN, cp)):
        return CONTROL
    if (cat == "Mc" and not _in(_NOT_SPACING, cp)) or cp in (0x0E33, 0x0EB3):
        return SPACING
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return T_
    if 0xAC00 <= cp <= 0xD7A3:
        return LV if (cp - 0xAC00) % 28 == 0 else LVT
    if _in(_PICT, cp):
        return PICT
    return OTHER


@lru_cache(maxsize=65536)
def grapheme_class(c: str) -> int:
    """:func:`_base_class`, corrected where ``unicode-segmentation``
    disagrees: a code point in ``JOIN_FIX`` flips between joining what
    precedes it (Extend) and not (Other), one in ``PREPEND_FIX`` between
    Prepend and Other, one in ``PICT_FIX`` between Extended_Pictographic and
    Other."""
    cls, cp = _base_class(c), ord(c)
    if _in(T.JOIN_FIX, cp):
        cls = OTHER if cls in (EXTEND, ZWJ, SPACING) else EXTEND
    if _in(T.PREPEND_FIX, cp):
        cls = OTHER if cls == PREPEND else PREPEND
    if _in(T.PICT_FIX, cp):
        cls = OTHER if cls == PICT else PICT
    return cls


_HANGUL_NEXT = {L: (L, V, LV, LVT), LV: (V, T_), V: (V, T_), LVT: (T_,), T_: (T_,)}


def graphemes(s: str) -> list[str]:
    """The extended grapheme clusters of ``s`` (GB3-GB13 of UAX #29)."""
    if not s:
        return []
    out: list[str] = []
    start = 0
    prev = grapheme_class(s[0])
    ri_run = 1 if prev == RI else 0  # regional indicators ending at prev
    emoji = 1 if prev == PICT else 0  # 1: ExtPict Extend*, 2: ... then ZWJ
    for i in range(1, len(s)):
        cur = grapheme_class(s[i])
        if prev == CR and cur == LF:
            join = True
        elif prev in (CONTROL, CR, LF) or cur in (CONTROL, CR, LF):
            join = False
        elif cur in _HANGUL_NEXT.get(prev, ()) or cur in (EXTEND, ZWJ, SPACING) or prev == PREPEND:
            join = True
        elif prev == ZWJ and cur == PICT:
            join = emoji == 2
        else:
            join = prev == RI and cur == RI and ri_run % 2 == 1
        if not join:
            out.append(s[start:i])
            start = i
        ri_run = ri_run + 1 if cur == RI else 0
        if cur == PICT:
            emoji = 1
        elif cur == EXTEND and emoji == 1:
            emoji = 1
        elif cur == ZWJ and emoji == 1:
            emoji = 2
        else:
            emoji = 0
        prev = cur
    out.append(s[start:])
    return out
