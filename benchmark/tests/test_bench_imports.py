"""No run imports JAX or the JAX package; the reference imports no part of
the program.  Top-level names are compared whole: the port's name begins
with the JAX package's."""

import json
import subprocess
import sys

from benchmark.run import ROOT, forbidden_modules


def test_forbidden_names_are_compared_whole():
    mods = ["raglite_tpu_torch", "raglite_tpu_torch.search", "jaxtyping", "flaxen", "numpy"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["raglite_tpu.search", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "raglite_tpu.search"]


def _loaded_after(code: str) -> list[str]:
    probe = code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_and_the_judge_import_nothing_of_the_program():
    loaded = _loaded_after(
        "import benchmark.reference.encoder, benchmark.reference.search, benchmark.reference.tokenizers, "
        "benchmark.judge, benchmark.traffic, benchmark.corpus, benchmark.tools.control"
    )
    tops = {m.split(".", 1)[0] for m in loaded}
    assert not tops & {"raglite_tpu_torch", "raglite_tpu", "jax", "jaxlib", "flax"}


def test_a_whole_run_imports_no_jax(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark.tests.tiny import write_tiny_bench
from benchmark.run import Cell, run_cell, process_start_epoch, forbidden_modules
cell = Cell.load(write_tiny_bench(Path({str(tmp_path)!r})), "tiny.vector")
out = run_cell(cell, 3, 1.0, False, device="cpu", started=process_start_epoch())
assert out["correct"], out
assert forbidden_modules() == [], forbidden_modules()
"""
    loaded = _loaded_after(code)
    assert "raglite_tpu_torch" in loaded
    assert not {m.split(".", 1)[0] for m in loaded} & {"raglite_tpu", "jax", "jaxlib", "flax"}
