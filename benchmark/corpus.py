"""The seeded background corpus, as the program's store holds it.

Frozen from ``add_background`` in the repository's ``chip_smoke.py`` (as of
this benchmark's first version), which follows ``bench.py``'s hybrid
section: unit-norm rows drawn on the device in one call (``rows_per_chunk``
to a chunk, rounded to float16, the store's type), and chunk bodies of
``body_terms`` words ``w<t>``, ``t`` drawn zipf(``zipf_a``) modulo
``vocab``.  The store gets one document and every chunk through
``Store.add_chunks``; the reference gets the same rows and bodies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Corpus", "make_corpus", "chunk_id", "ordinal_of"]


def chunk_id(ordinal: int) -> str:
    return f"bg-{ordinal}"


def ordinal_of(cid: str) -> int:
    return int(cid.removeprefix("bg-"))


@dataclass
class Corpus:
    rows: np.ndarray  # [chunks x rows_per_chunk, d] float16
    rows_per_chunk: int
    bodies: list[str]


def make_corpus(spec: dict, dim: int, seed: int, device: str) -> Corpus:
    """Rows and bodies of a configuration's ``corpus`` block from ``seed``."""
    n = int(spec["chunks"])
    per = int(spec["rows_per_chunk"])
    g = torch.Generator(device=device).manual_seed(seed)
    vecs = torch.randn((n * per, dim), generator=g, device=device)
    rows = (vecs / vecs.norm(dim=1, keepdim=True)).to(torch.float16).cpu().numpy()
    del vecs
    terms = np.random.default_rng(seed).zipf(float(spec["zipf_a"]), size=(n, int(spec["body_terms"])))
    terms = terms.astype(np.int64) % int(spec["vocab"])
    bodies = [" ".join(f"w{t}" for t in row) + "\n" for row in terms.tolist()]
    return Corpus(rows, per, bodies)


def fill_store(store, corpus: Corpus) -> None:
    """One document and every chunk into the program's store."""
    from raglite_tpu_torch.documents import Chunk, Document

    doc = Document.from_text("background\n", id="background", filename="background")
    store.add_document(doc)
    per = corpus.rows_per_chunk
    chunks = [
        Chunk(id=chunk_id(i), document_id=doc.id, index=i, headings="", body=body)
        for i, body in enumerate(corpus.bodies)
    ]
    store.add_chunks(chunks, [corpus.rows[i * per : (i + 1) * per] for i in range(len(chunks))])
