"""First-party language detection: Unicode-script routing + stopword voting.

Replaces the reference's ``langdetect`` dependency
(raglite/_search.py:374-385), which only feeds
per-language reranker selection.  Two stages:

1. **Script detection** (deterministic): counts characters per Unicode
   script block.  Non-Latin scripts identify the language family outright —
   Hangul→ko, kana→ja, Han-without-kana→zh, Thai→th, Greek→el, Hebrew→he,
   Devanagari→hi, and so on — which is exactly the case the stopword
   approach could never cover (CJK has no spaces to tokenize).  Cyrillic
   and Arabic scripts are sub-split by distinctive characters
   (ukrainian ``і/ї/є``, persian ``پ/چ/ژ/گ``).
2. **Stopword voting** (Latin script): high-frequency function words for
   19 Latin-script languages; ties/low-signal return "other".

This covers 30+ languages vs langdetect's 55; the tail it misses routes to
"other", whose default reranker is the same device MaxSim as every other
language, so the routing consequence is nil until per-language rerankers
diverge.
"""

from __future__ import annotations

import re

_STOPWORDS = {
    "en": {"the", "and", "of", "to", "in", "is", "that", "it", "for", "was", "with", "are", "this", "which"},
    "de": {"der", "die", "das", "und", "ist", "nicht", "von", "mit", "ein", "eine", "zu", "den", "auf"},
    "fr": {"le", "la", "les", "et", "est", "des", "une", "dans", "que", "pour", "qui", "pas", "sur"},
    "es": {"el", "la", "los", "las", "es", "una", "que", "para", "por", "con", "del", "se"},
    "nl": {"de", "het", "een", "en", "van", "dat", "niet", "voor", "met", "aan", "zijn", "ook"},
    "it": {"il", "la", "che", "di", "non", "una", "per", "sono", "del", "gli", "nel"},
    "pt": {"o", "a", "os", "as", "que", "uma", "para", "com", "não", "dos", "mais"},
    "sv": {"och", "att", "det", "som", "på", "är", "av", "för", "inte", "med", "den", "till"},
    "da": {"og", "det", "at", "der", "til", "er", "som", "på", "de", "ikke", "med", "af"},
    "no": {"og", "det", "at", "er", "som", "på", "ikke", "av", "til", "den", "har", "jeg"},
    "fi": {"ja", "on", "ei", "että", "oli", "mutta", "hän", "se", "joka", "kun", "niin", "myös"},
    "pl": {"nie", "się", "jest", "na", "do", "że", "w", "z", "to", "jak", "po", "ale"},
    "cs": {"je", "se", "na", "že", "s", "z", "do", "to", "jako", "ale", "pro", "jsou"},
    "ro": {"și", "în", "de", "la", "cu", "este", "un", "o", "pe", "care", "nu", "pentru"},
    "hu": {"és", "a", "az", "hogy", "nem", "is", "egy", "van", "meg", "volt", "ez", "de"},
    "tr": {"bir", "ve", "bu", "için", "de", "da", "ile", "ne", "gibi", "daha", "çok", "var"},
    "id": {"yang", "dan", "di", "ini", "itu", "dengan", "untuk", "dari", "tidak", "pada", "adalah", "ke"},
    "vi": {"và", "của", "là", "có", "không", "được", "trong", "cho", "người", "những", "một", "các"},
    "et": {"ja", "on", "ei", "et", "ka", "see", "oli", "kui", "aga", "oma", "mis", "ta"},
}

# Latin letters incl. the sharp s (U+00DF) but NOT the division sign
# (U+00F7) — [à-ÿ] splits 'weiß' and joins '÷'.
_WORD_RE = re.compile(r"[a-zß-öø-ÿāăąćčďđēėęěğīįıłńňōőœřśşšťūůűźżžḀ-ỿ]+")

# (language-or-None, inclusive codepoint ranges).  A None language means the
# script needs a sub-split (Han → zh unless kana present; Cyrillic/Arabic
# split on distinctive letters below).
_SCRIPT_RANGES: list[tuple[str, tuple[tuple[int, int], ...]]] = [
    ("hangul", ((0xAC00, 0xD7A3), (0x1100, 0x11FF), (0x3130, 0x318F))),
    ("kana", ((0x3040, 0x309F), (0x30A0, 0x30FF), (0x31F0, 0x31FF))),
    ("han", ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0xF900, 0xFAFF))),
    ("cyrillic", ((0x0400, 0x04FF), (0x0500, 0x052F))),
    ("arabic", ((0x0600, 0x06FF), (0x0750, 0x077F), (0xFB50, 0xFDFF))),
    ("hebrew", ((0x0590, 0x05FF),)),
    ("greek", ((0x0370, 0x03FF), (0x1F00, 0x1FFF))),
    ("devanagari", ((0x0900, 0x097F),)),
    ("bengali", ((0x0980, 0x09FF),)),
    ("tamil", ((0x0B80, 0x0BFF),)),
    ("telugu", ((0x0C00, 0x0C7F),)),
    ("kannada", ((0x0C80, 0x0CFF),)),
    ("malayalam", ((0x0D00, 0x0D7F),)),
    ("gujarati", ((0x0A80, 0x0AFF),)),
    ("gurmukhi", ((0x0A00, 0x0A7F),)),
    ("sinhala", ((0x0D80, 0x0DFF),)),
    ("thai", ((0x0E00, 0x0E7F),)),
    ("lao", ((0x0E80, 0x0EFF),)),
    ("myanmar", ((0x1000, 0x109F),)),
    ("khmer", ((0x1780, 0x17FF),)),
    ("georgian", ((0x10A0, 0x10FF),)),
    ("armenian", ((0x0530, 0x058F),)),
    ("ethiopic", ((0x1200, 0x137F),)),
    ("latin", ((0x0041, 0x005A), (0x0061, 0x007A), (0x00C0, 0x024F),
               (0x1E00, 0x1EFF))),  # Latin Extended Additional: Vietnamese
]

_SCRIPT_LANG = {
    "hangul": "ko", "kana": "ja", "hebrew": "he", "greek": "el",
    "devanagari": "hi", "bengali": "bn", "tamil": "ta", "telugu": "te",
    "kannada": "kn", "malayalam": "ml", "gujarati": "gu", "gurmukhi": "pa",
    "sinhala": "si", "thai": "th", "lao": "lo", "myanmar": "my",
    "khmer": "km", "georgian": "ka", "armenian": "hy", "ethiopic": "am",
}

# Sub-splits on letters unique to one language within a shared script.
_UKRAINIAN = set("іїєґ")
_BULGARIAN_HINT = set("ъщ")  # ъ is common in bg, near-absent in modern ru prose
_PERSIAN = set("پچژگ")
_URDU = set("ٹڈڑےہ")


def _script_counts(text: str) -> dict[str, int]:
    counts: dict[str, int] = {}
    for ch in text[:2000]:
        cp = ord(ch)
        if cp < 0x41:  # digits/punctuation/space fast path
            continue
        for name, ranges in _SCRIPT_RANGES:
            if any(lo <= cp <= hi for lo, hi in ranges):
                counts[name] = counts.get(name, 0) + 1
                break
    return counts


def _detect_latin(text: str) -> str:
    words = _WORD_RE.findall(text.lower())[:400]
    if not words:
        return "other"
    best_lang, best_hits = "other", 0
    for lang, stopwords in _STOPWORDS.items():
        hits = sum(1 for w in words if w in stopwords)
        if hits > best_hits:
            best_lang, best_hits = lang, hits
    if best_hits < max(2, len(words) // 50):
        return "other"
    return best_lang


def detect_language(text: str) -> str:
    """Best-matching ISO 639-1 code, or "other" when nothing matches."""
    counts = _script_counts(text)
    if not counts:
        return "other"
    script = max(counts, key=counts.get)  # type: ignore[arg-type]
    total = sum(counts.values())
    # Han text with ANY kana is Japanese; kana dominance likewise.
    if script in ("han", "kana") or (script == "hangul" and counts.get("han")):
        if counts.get("kana", 0) > 0:
            return "ja"
        if script == "han":
            return "zh"
    if script == "hangul":
        return "ko"
    if script == "cyrillic":
        letters = set(text.lower())
        if letters & _UKRAINIAN:
            return "uk"
        if len(letters & _BULGARIAN_HINT) >= 2:
            return "bg"
        return "ru"
    if script == "arabic":
        letters = set(text)
        if letters & _URDU:
            return "ur"
        if letters & _PERSIAN:
            return "fa"
        return "ar"
    if script in _SCRIPT_LANG:
        return _SCRIPT_LANG[script]
    # Mostly-Latin text (tolerate a minority of other-script symbols).
    if counts.get("latin", 0) >= total * 0.5:
        return _detect_latin(text)
    return "other"
