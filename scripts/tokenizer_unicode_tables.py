"""Write raglite_tpu_torch/models/unicode_tables.py: the code points where
the ``tokenizers`` package's Unicode properties differ from what
raglite_tpu_torch/models/unicode_props.py derives from Python's
``unicodedata``, and range tables of the properties Python has no data for.

Each property is probed on every code point through the ``tokenizers``
component that reads it (BertNormalizer, BertPreTokenizer, StripAccents,
Lowercase, NFC/NFD/NFKC/NFKD, Whitespace, and Precompiled charsmaps for
grapheme clusters; Strip and WhitespaceSplit for Rust's ``is_whitespace``,
Digits for ``is_numeric``, Punctuation, Nmt's map, UnicodeScripts' script
classes), and the port's own derivation is compared with it.  Every
``\\p{...}`` name Oniguruma accepts (taken from the names stored in the
``tokenizers`` library, each checked by compiling it) is probed through a
Split pattern: general categories as corrections, scripts, blocks and
binary properties as range tables.  Run it with the ``tokenizers`` version
the port is held to (0.22.2) and the Python the port runs on, then check
the tests:

    python scripts/tokenizer_unicode_tables.py
    python -m pytest tests/test_torch_hf_tokenizer.py tests/test_torch_hf_tokenizer_components.py -q
"""

from __future__ import annotations

import base64
import importlib
import json
import re
import sys
import time
import unicodedata
from multiprocessing import get_context
from pathlib import Path

import tokenizers
from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "raglite_tpu_torch" / "models" / "unicode_tables.py"

CODE_POINTS = [cp for cp in range(sys.maxunicode + 1) if not 0xD800 <= cp <= 0xDFFF]
ALL_TEXT = "".join(map(chr, CODE_POINTS))


def ranges(cps) -> tuple[tuple[int, int], ...]:
    out: list[list[int]] = []
    for cp in sorted(cps):
        if out and out[-1][1] == cp - 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return tuple((a, b) for a, b in out)


def precompiled(mapping: dict[str, str]):
    """A ``tokenizers`` normalizer over a charsmap built by chip_smoke.py's
    writer (the one the tests hold the port's reader to)."""
    import chip_smoke

    spec = json.loads(Tokenizer(models.BPE(vocab={"a": 0}, merges=[])).to_str())
    charsmap = base64.b64encode(chip_smoke.precompiled_charsmap(mapping)).decode()
    spec["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": charsmap}
    return Tokenizer.from_str(json.dumps(spec)).normalizer


#: The general categories Python's ``unicodedata`` names (Oniguruma's
#: \\p{Lu} ...); the one-letter ones and LC are their unions.
CATEGORIES = (
    "Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po",
    "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc", "Cf", "Cs", "Co", "Cn",
)
GROUPS = {g: tuple(c for c in CATEGORIES if c[0] == g) for g in "LMNPSZC"} | {"LC": ("Lu", "Ll", "Lt")}
#: Oniguruma's POSIX bracket names.
POSIX = ("alnum", "alpha", "ascii", "blank", "cntrl", "digit", "graph", "lower", "print", "punct", "space", "upper",
         "xdigit", "word")


def spans(pre, text: str) -> list[tuple[int, int]]:
    """The (start, end) character offsets of ``pre``'s pieces of ``text``."""
    return [span for _, span in pre.pre_tokenize_str(text)]


def members(pattern: str) -> set[int]:
    """The code points a one-character Oniguruma class ``pattern`` takes:
    the complement of what a Split that removes its runs keeps."""
    keep = bytearray(len(CODE_POINTS))
    for a, b in spans(pre_tokenizers.Split(Regex(pattern + "+"), "removed"), ALL_TEXT):
        keep[a:b] = b"\1" * (b - a)
    return {cp for cp, kept in zip(CODE_POINTS, keep) if not kept}


def onig_names() -> list[str]:
    """Every property name Oniguruma accepts, in its own spelling
    (lowercase, no separators): the lowercase words stored in the
    ``tokenizers`` library that compile as \\p{...}."""
    blob = Path(tokenizers.__file__).with_name("tokenizers.abi3.so").read_bytes()
    words = {w.decode() for w in re.findall(rb"(?<![\x21-\x7e])([a-z][a-z0-9]{0,47})(?![\x21-\x7e])", blob)}
    out = []
    for w in sorted(words):
        try:
            pre_tokenizers.Split(Regex(rf"\p{{{w}}}"), "isolated")
        except Exception:
            continue
        out.append(w)
    return out


def unicode_scripts() -> tuple[set[int], list[tuple[int, int, int]]]:
    """``UnicodeScripts``' script of every code point: the set of those it
    treats as Any (transparent), and (start, end, class) ranges of the rest,
    classes numbered from 1 in order of first appearance."""
    pre = pre_tokenizers.UnicodeScripts()
    # "a c a \u3042 c \u3042": two pieces of three iff c is Any, four if it
    # is Latin or Han, six otherwise.
    any_cps: set[int] = set()
    for i in range(0, len(CODE_POINTS), 65536):
        block = CODE_POINTS[i : i + 65536]
        starts = bytearray(6 * len(block))
        for a, _ in spans(pre, "".join(f"a{chr(cp)}a\u3042{chr(cp)}\u3042" for cp in block)):
            starts[a] = 1
        any_cps.update(cp for k, cp in enumerate(block) if sum(starts[6 * k : 6 * k + 6]) == 2)
    rest = [cp for cp in CODE_POINTS if cp not in any_cps]
    text = "".join(map(chr, rest))
    reps: list[str] = []  # one character of each class
    out: list[tuple[int, int, int]] = []
    for a, b in spans(pre, text):
        rep = text[a]
        cls = next((i + 1 for i, r in enumerate(reps) if len(pre.pre_tokenize_str(r + rep)) == 1), None)
        if cls is None:
            reps.append(rep)
            cls = len(reps)
        for cp in rest[a:b]:
            if out and out[-1][2] == cls and out[-1][1] == cp - 1:
                out[-1] = (out[-1][0], cp, cls)
            else:
                out.append((cp, cp, cls))
    return any_cps, out


def onig_tables() -> tuple[dict[str, set[int]], dict[str, str], dict[str, set[int]], dict[str, set[int]], dict[str, str]]:
    """Oniguruma's sets: corrections of the general categories against
    ``unicodedata``, every accepted name mapped to a category or a set key,
    the sets that are not categories (scripts, blocks, binary properties,
    POSIX brackets that differ from their property; equal sets stored
    once), what a key flips inside a class, and the POSIX brackets' keys
    where they differ."""
    names = onig_names()
    with get_context("spawn").Pool(4) as pool:
        sets = dict(zip(names, pool.map(members, [rf"\p{{{n}}}" for n in names], chunksize=8)))
    by_cat = {c: set() for c in CATEGORIES}
    for cp in CODE_POINTS:
        by_cat[unicodedata.category(chr(cp))].add(cp)
    gc_fix = {c: sets[c.lower()] ^ by_cat[c] for c in CATEGORIES}
    derived = {c: frozenset(sets[c.lower()]) for c in CATEGORIES}
    derived |= {g: frozenset().union(*(derived[c] for c in parts)) for g, parts in GROUPS.items()}
    key_of = {v: k for k, v in derived.items()}
    aliases: dict[str, str] = {}
    stored: dict[frozenset, str] = {}
    for name in sorted(names, key=lambda n: (-len(n), n)):  # a set's key: its longest name
        members_ = frozenset(sets[name])
        if members_ in key_of:
            aliases[name] = key_of[members_]
        else:
            aliases[name] = stored.setdefault(members_, name)
    for g in GROUPS:
        if aliases.get(g.lower()) != g:
            raise SystemExit(f"Oniguruma's \\p{{{g}}} is not the union of its categories")
    # Inside a class Oniguruma reads Latin-1 through a table of its own
    # (\w there lacks the superscripts and fractions): the flips, by key.
    latin1 = "".join(map(chr, range(256)))
    in_class: dict[str, set[int]] = {}
    for name in names:
        pre = pre_tokenizers.Split(Regex(rf"[\p{{{name}}}]+"), "removed")
        inside = set(range(256)) - {cp for a, b in spans(pre, latin1) for cp in range(a, b)}
        flips = inside ^ {cp for cp in sets[name] if cp < 256}
        if flips and in_class.setdefault(aliases[name], flips) != flips:
            raise SystemExit(f"the aliases of {aliases[name]} differ inside a class")
    # POSIX brackets: where one differs from its property inside a class
    # ([:punct:] takes the symbols), its own set.
    posix: dict[str, str] = {}
    for name in POSIX:
        got = frozenset(members(f"[[:{name}:]]"))
        if got != frozenset(sets[name] ^ in_class.get(aliases[name], set())):
            posix[name] = key_of.get(got) or stored.setdefault(got, f"posix{name}")
    return gc_fix, aliases, {key: set(m) for m, key in stored.items()}, in_class, posix


def main() -> None:
    # The port's derivations, without corrections.
    import raglite_tpu_torch.models.unicode_tables as tables

    for name in ("OTHER_FIX", "PUNCT_FIX", "MN_FIX", "MARK_FIX", "WORD_FIX", "SPACE_FIX", "JOIN_FIX", "PREPEND_FIX", "PICT_FIX"):
        setattr(tables, name, ())
    tables.NF_FIXED = {"NFC": (), "NFD": (), "NFKC": (), "NFKD": ()}
    tables.LOWER_FIX = {}
    for name in ("RUST_SPACE_FIX", "NUMERIC_FIX", "NMT_REMOVED", "NMT_SPACE", "SCRIPTS"):
        setattr(tables, name, ())
    tables.ONIG_GC_FIX, tables.ONIG_ALIASES, tables.ONIG_SETS = {}, {}, {}
    tables.ONIG_IN_CLASS_FIX, tables.ONIG_POSIX = {}, {}
    props = importlib.reload(importlib.import_module("raglite_tpu_torch.models.unicode_props"))

    t0 = time.time()
    fixes: dict[str, set[int]] = {k: set() for k in ("OTHER", "PUNCT", "MN", "MARK", "WORD", "SPACE", "JOIN", "PREPEND", "PICT")}
    nf_fixed: dict[str, set[int]] = {f: set() for f in ("NFC", "NFD", "NFKC", "NFKD")}
    lower_fix: dict[str, str] = {}
    clean = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=False, strip_accents=False, lowercase=False)
    strip_mn = normalizers.BertNormalizer(clean_text=False, handle_chinese_chars=False, strip_accents=True, lowercase=False)
    strip_m, low = normalizers.StripAccents(), normalizers.Lowercase()
    nf = {f: getattr(normalizers, f)() for f in nf_fixed}
    bert_pre, ws_pre = pre_tokenizers.BertPreTokenizer(), pre_tokenizers.Whitespace()
    join, pict = precompiled({"a": "X"}), precompiled({"\u00a9": "X"})
    for cp in CODE_POINTS:
        c = chr(cp)
        if c not in "\t\n\r\0\ufffd":
            other = clean.normalize_str(c) == ""
            if other != props.is_other(c):
                fixes["OTHER"].add(cp)
        pieces = len(bert_pre.pre_tokenize_str("a" + c + "a"))
        if pieces != 2 and (pieces == 3) != props.is_punctuation(c):
            fixes["PUNCT"].add(cp)
        for form, norm in nf.items():
            got = norm.normalize_str(c)
            if got != unicodedata.normalize(form, c):
                if got != c:
                    raise SystemExit(f"{form} of U+{cp:04X} is {got!r}: neither Python's nor the code point itself")
                nf_fixed[form].add(cp)
        if nf["NFD"].normalize_str(c) == c and (strip_mn.normalize_str(c) == "") != props.is_nonspacing_mark(c):
            fixes["MN"].add(cp)
        if (strip_m.normalize_str(c) == "") != props.is_combining_mark(c):
            fixes["MARK"].add(cp)
        lowered = low.normalize_str(c)
        if lowered != c.lower():
            lower_fix[c] = lowered
        pieces = len(ws_pre.pre_tokenize_str("a" + c + "a"))
        word = pieces == 1
        if word != (unicodedata.category(c)[0] in "LM" or unicodedata.category(c) in ("Nd", "Pc", "Nl")):
            fixes["WORD"].add(cp)
        if not word and (pieces == 2) != (c in props.WHITESPACE):
            fixes["SPACE"].add(cp)
        joined = join.normalize_str("a" + c) == "X"
        if c != "a" and joined != (props._base_class(c) in (props.EXTEND, props.ZWJ, props.SPACING)):
            fixes["JOIN"].add(cp)
        if not joined and c != "\u00a9":
            crate_pict = pict.normalize_str("\u00a9\u200d" + c) == "X\u200d" + c
            if crate_pict != (props._base_class(c) == props.PICT):
                fixes["PICT"].add(cp)
    print(f"swept {len(CODE_POINTS)} code points in {time.time() - t0:.0f} s", flush=True)
    # Prepend: a key for every code point of a block; c + "a" is one
    # cluster (looked up whole, the shortest key "c" replacing it) iff c
    # is Prepend.
    block = 4096
    for start in range(0, sys.maxunicode + 1, block):
        cps = [cp for cp in range(start, start + block) if not 0xD800 <= cp <= 0xDFFF and chr(cp) not in "a\n\r"]
        norm = precompiled({chr(cp): "Y" for cp in cps})
        for cp in cps:
            joined = norm.normalize_str(chr(cp) + "a") == "Y"
            if joined != (props._base_class(chr(cp)) == props.PREPEND):
                fixes["PREPEND"].add(cp)
    print(f"prepend probed in {time.time() - t0:.0f} s", flush=True)

    # Rust's char::is_whitespace (WhitespaceSplit, Strip), char::is_numeric
    # (Digits), the Punctuation pre-tokenizer and Nmt's map.
    rust_space, numeric, nmt_removed, nmt_space = set(), set(), set(), set()
    ws_split, digits = pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Digits(individual_digits=True)
    punct, strip, nmt = pre_tokenizers.Punctuation(), normalizers.Strip(), normalizers.Nmt()
    for cp in CODE_POINTS:
        c = chr(cp)
        space = len(ws_split.pre_tokenize_str("a" + c + "a")) == 2
        if space != (strip.normalize_str(c + "a" + c) == "a"):
            raise SystemExit(f"WhitespaceSplit and Strip disagree on U+{cp:04X}")
        if space != (c in props.WHITESPACE):
            rust_space.add(cp)
        if (len(digits.pre_tokenize_str("a" + c + "a")) == 3) != (unicodedata.category(c)[0] == "N"):
            numeric.add(cp)
        if (len(punct.pre_tokenize_str("a" + c + "a")) == 3) != (len(bert_pre.pre_tokenize_str("a" + c + "a")) == 3):
            raise SystemExit(f"Punctuation and BertPreTokenizer disagree on U+{cp:04X}")
        mapped = nmt.normalize_str(c)
        if mapped == "":
            nmt_removed.add(cp)
        elif mapped == " " and c != " ":
            nmt_space.add(cp)
        elif mapped != c:
            raise SystemExit(f"Nmt maps U+{cp:04X} to {mapped!r}")
    any_cps, scripts = unicode_scripts()
    print(f"scripts probed in {time.time() - t0:.0f} s", flush=True)
    gc_fix, aliases, sets, in_class, posix = onig_tables()
    print(f"{len(aliases)} Oniguruma names probed in {time.time() - t0:.0f} s", flush=True)

    def fmt(rs) -> str:
        body = ", ".join(f"(0x{a:04X}, 0x{b:04X})" for a, b in rs)
        return f"({body},)" if rs else "()"

    def packed(cps) -> str:
        """Ranges as one string: "a-b" or "a" in hex, space separated."""
        return " ".join(f"{a:X}" if a == b else f"{a:X}-{b:X}" for a, b in ranges(cps))

    lines = [
        '"""Code points where ``tokenizers`` ' + tokenizers.__version__ + "'s Unicode properties differ from",
        "models/unicode_props.py's derivations from Python's ``unicodedata`` (Unicode "
        + unicodedata.unidata_version + "),",
        "as inclusive ranges, and the sets Python has no data for (scripts, Oniguruma's",
        "properties).  Written by scripts/tokenizer_unicode_tables.py; do not edit by",
        'hand."""',
        "",
    ]
    for key, cps in fixes.items():
        lines.append(f"{key}_FIX = {fmt(ranges(cps))}")
    lines.append("NF_FIXED = {" + ", ".join(f'"{f}": {fmt(ranges(cps))}' for f, cps in nf_fixed.items()) + "}")
    lines.append("LOWER_FIX = {" + ", ".join(f"{k!r}: {v!r}" for k, v in sorted(lower_fix.items())) + "}")
    lines.append(f"RUST_SPACE_FIX = {fmt(ranges(rust_space))}")
    lines.append(f"NUMERIC_FIX = {fmt(ranges(numeric))}")
    lines.append(f"NMT_REMOVED = {fmt(ranges(nmt_removed))}")
    lines.append(f"NMT_SPACE = {fmt(ranges(nmt_space))}")
    lines.append("#: UnicodeScripts' script classes, (start, end, class); a code point in")
    lines.append("#: none of them is Any.")
    if any(a <= cp <= b for a, b, _ in scripts for cp in any_cps):
        raise SystemExit("a code point is both Any and of a script")
    lines.append("SCRIPTS = (" + ", ".join(f"(0x{a:04X}, 0x{b:04X}, {c})" for a, b, c in scripts) + ",)")
    lines.append("#: Oniguruma's general categories, corrections as above.")
    lines.append("ONIG_GC_FIX = {" + ", ".join(f'"{c}": {fmt(ranges(v))}' for c, v in gc_fix.items() if v) + "}")
    lines.append("#: Every \\p{...} name Oniguruma accepts (lowercase, no separators): a general")
    lines.append("#: category or a key of ONIG_SETS.")
    lines.append("ONIG_ALIASES = {" + ", ".join(f'"{n}": "{k}"' for n, k in sorted(aliases.items())) + "}")
    lines.append("#: Code points an ONIG_ALIASES value flips inside a class (Latin-1 there has")
    lines.append("#: a table of its own).")
    lines.append("ONIG_IN_CLASS_FIX = {" + ", ".join(f'"{k}": {fmt(ranges(v))}' for k, v in sorted(in_class.items())) + "}")
    lines.append("#: POSIX brackets ([:name:]) that differ from their property inside a class:")
    lines.append("#: a key of ONIG_SETS or a general category.")
    lines.append("ONIG_POSIX = {" + ", ".join(f'"{k}": "{v}"' for k, v in sorted(posix.items())) + "}")
    lines.append("#: Oniguruma's scripts, blocks, binary properties and POSIX brackets, packed ranges.")
    lines.append("ONIG_SETS = {")
    lines.extend(f'    "{k}": "{packed(v)}",' for k, v in sorted(sets.items()))
    lines.append("}")
    OUT.write_text("\n".join(lines) + "\n")
    print({k: len(v) for k, v in {**fixes, **nf_fixed}.items()}, len(lower_fix), f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
