"""Multilingual sentence-boundary corpus with constructed gold labels.

Training/eval data for the learned boundary model (boundary.py).  Sentence
pools across nine languages carry the hard cases SaT exists for —
abbreviations, initials, decimals, enumerations, quotes, CJK punctuation,
lowercase continuations — and documents are assembled by sampling
sentences and joiners, so every gold boundary index is known by
construction (no third-party labels needed in a zero-egress image).

The reference's equivalent supervision is wtpsplit's pretraining; here the
generator doubles as the eval benchmark: train on one seed range, hold
out another, and report boundary-F1 for both the heuristic and the
learned model (tests/test_boundary_model.py, PARITY.md).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SENTENCE_POOL", "make_document", "make_corpus"]

# Each entry is one full sentence WITHOUT trailing whitespace.  Hard cases
# are deliberately over-represented.
SENTENCE_POOL: dict[str, list[str]] = {
    "en": [
        "The experiment confirmed the hypothesis beyond reasonable doubt.",
        "Dr. Smith arrived at 9 a.m. with the final report.",
        "Prof. A. Einstein published the paper in 1905.",
        "The ratio was approximately 3.14159 across all trials.",
        "See Fig. 4 and Sec. 2.3 for the derivation.",
        "Results improved by 12.5 percent, i.e. nearly an eighth.",
        "Samples were stored at -20 C (cf. Appendix B).",
        "\"Is it reproducible?\" she asked.",
        "He said, \"The data speak for themselves.\"",
        "The committee met in Washington, D.C. last spring.",
        "Shipping costs rose to $4.99 per unit in Q3.",
        "Visit https://example.org/docs for the full spec.",
        "It failed twice... then it worked.",
        "No. 5 ranked highest among the variants.",
        "Mr. and Mrs. Doyle signed on p. 12 of the contract.",
        "What could possibly go wrong?",
        "Stop!",
        "The sensor logged 0.5 mm of drift per day.",
        "Clouds gathered over the valley, and the wind rose.",
        "E. coli cultures doubled every 20 min. under these conditions.",
    ],
    "de": [
        "Die Messung wurde z.B. bei 20 Grad wiederholt.",
        "Dr. Weber erklärte das Verfahren ausführlich.",
        "Das Ergebnis lag bei ca. 3,5 Prozent.",
        "Die Probe wog 1,25 g und war damit zu leicht.",
        "Vgl. Abschnitt 4 bzw. Anhang A für Details.",
        "Können wir das bis Montag schaffen?",
        "Der Zug fährt um 14.30 Uhr vom Gleis 7 ab.",
        "Straßenbahnen fuhren früher durch die Altstadt.",
        "Das Experiment misslang, d.h. die Kontrolle fehlte.",
        "„Wie bitte?“, fragte sie erstaunt.",
    ],
    "fr": [
        "M. Dupont a présenté les résultats hier soir.",
        "La température atteignit 37,2 degrés à midi.",
        "Voir p. 45 du rapport pour les annexes.",
        "« Est-ce vraiment nécessaire ? » demanda-t-elle.",
        "Les mesures furent répétées, etc., jusqu'à convergence.",
        "L'équipe arriva à 18 h 30 précises.",
        "Quelle surprise !",
        "Le coût s'élève à 3,99 euros par échantillon.",
    ],
    "es": [
        "El Sr. García firmó el acuerdo esta mañana.",
        "¿Cuándo llegará la próxima remesa?",
        "¡Qué resultado tan inesperado!",
        "La muestra pesaba 2,5 kg aproximadamente.",
        "Véase la pág. 12 para la metodología.",
        "El ensayo se repitió tres veces, es decir, por triplicado.",
    ],
    "it": [
        "Il dott. Rossi ha verificato i dati due volte.",
        "La misura era di 1,75 m con un errore minimo.",
        "Che cosa significa questo risultato?",
        "L'esperimento è riuscito al primo tentativo.",
    ],
    "pt": [
        "O Dr. Silva apresentou o relatório final.",
        "A amostra pesava 3,2 kg no total.",
        "Quando começa a próxima fase?",
    ],
    "ja": [
        "実験は三回繰り返された。",
        "結果は予想と一致しましたか？",
        "温度は摂氏二十度に保たれた。",
        "「本当ですか」と彼女は尋ねた。",
        "誤差は〇・五ミリ以下だった。",
        "すばらしい！",
    ],
    "zh": [
        "实验结果与理论预测一致。",
        "样品在低温下保存了三个月。",
        "这个方法可靠吗？",
        "数据分析花费了两周时间。",
        "太出乎意料了！",
        "第３.２节描述了测量方法。",
    ],
    "ru": [
        "Доктор Иванов проверил данные дважды.",
        "Температура составила 36,6 градуса.",
        "См. рис. 3 и табл. 2 для сравнения.",
        "Когда начнётся следующий этап?",
        "Образец весил 1,5 кг и т.д.",
    ],
}

_JOINERS = [" ", " ", " ", "  ", "\n", "\n\n"]
_CJK_JOINERS = ["", "", "\n", "\n\n"]


def make_document(
    rng: np.random.Generator, *, min_sentences: int = 4, max_sentences: int = 24
) -> tuple[str, set[int]]:
    """One synthetic document and its gold boundary indices.

    A gold boundary marks the LAST character of each non-final sentence
    (pre-whitespace — the convention of heuristic_sentence_boundaries;
    split_sentences shifts trailing whitespace afterwards)."""
    langs = list(SENTENCE_POOL)
    # Mostly monolingual documents with occasional code-switching.
    base_lang = langs[rng.integers(len(langs))]
    count = int(rng.integers(min_sentences, max_sentences + 1))
    parts: list[str] = []
    gold: set[int] = set()
    pos = 0
    for i in range(count):
        lang = base_lang if rng.random() > 0.1 else langs[rng.integers(len(langs))]
        pool = SENTENCE_POOL[lang]
        sentence = pool[rng.integers(len(pool))]
        parts.append(sentence)
        pos += len(sentence)
        if i < count - 1:
            gold.add(pos - 1)
            cjk = lang in ("ja", "zh")
            joiners = _CJK_JOINERS if cjk else _JOINERS
            joiner = joiners[rng.integers(len(joiners))]
            parts.append(joiner)
            pos += len(joiner)
    return "".join(parts), gold


def make_corpus(
    *, num_documents: int, seed: int
) -> list[tuple[str, set[int]]]:
    rng = np.random.default_rng(seed)
    return [make_document(rng) for _ in range(num_documents)]
