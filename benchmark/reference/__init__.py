"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy: a byte-level BPE and a byte tokenizer
(``tokenizers.py``), the encoder's forward in float32 with its weights read
from the raw files or drawn again from the seed (``encoder.py``), and exact
dense search, Okapi BM25 and weighted reciprocal-rank fusion
(``search.py``).  It imports nothing of the program under test and takes
none of its state: the benchmark hands it the same inputs it hands the
program (texts, rows, weight files).
"""
