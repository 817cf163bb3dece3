"""The port's counterparts of two JAX scripts, each run as its command line
in a process of its own beside the script:

- ``python -m raglite_tpu_torch.train.export_hf`` against
  scripts/export_hf_encoder.py, on a tiny ``save_npz_encoder`` checkpoint:
  the same ``config.json`` and ``tokenizer.json``, and ``model.safetensors``
  files that load, in both packages, to equal tensors.
- ``python -m raglite_tpu_torch.store_scale`` against
  scripts/store_scale_run.py at 20,000 chunks of d 8: the same JSON keys
  (the reopen's included) and equal ``chunks``, ``lazy_open`` and
  ``filtered_matches``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(args: list[str]) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return done.stdout


def _tiny_npz(path: Path) -> None:
    """A seeded 2-layer, d 32 encoder (final LayerNorm included) as the
    port's ``save_npz_encoder`` writes it, beside a tokenizer.json."""
    from raglite_tpu_torch.models.transformer import EncoderModel, params_to_jax, save_npz_encoder

    cfg = {"vocab": 300, "d_model": 32, "heads": 4, "d_ff": 64, "layers": 2, "max_len": 64, "ln_eps": 1e-5}
    torch.manual_seed(7)
    model = EncoderModel(cfg, dtype=torch.float32, final_ln=True)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape) * 0.2)
    path.mkdir(parents=True)
    save_npz_encoder(str(path / "encoder.npz"), params_to_jax(model), cfg)
    vocab = {chr(97 + i): i for i in range(26)}
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [], "normalizer": None,
            "pre_tokenizer": None, "post_processor": None, "decoder": None,
            "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": []}}
    (path / "tokenizer.json").write_text(json.dumps(spec))


def test_export_hf_matches_the_jax_script(tmp_path) -> None:
    pytest.importorskip("safetensors")
    import jax.numpy as jnp

    from raglite_tpu.models import transformer as jt
    from raglite_tpu_torch.models import transformer as tt

    src = tmp_path / "npz"
    _tiny_npz(src)
    theirs, ours = tmp_path / "jax", tmp_path / "port"
    _run(["scripts/export_hf_encoder.py", "--src", str(src), "--out", str(theirs)])
    said = _run(["-m", "raglite_tpu_torch.train.export_hf", "--src", str(src), "--out", str(ours)])
    assert "model.safetensors" in said
    assert json.loads((ours / "config.json").read_text()) == json.loads((theirs / "config.json").read_text())
    assert (ours / "tokenizer.json").read_bytes() == (theirs / "tokenizer.json").read_bytes()
    jcfg_a, jparams_a, _ = jt.load_safetensors_encoder(str(theirs), dtype=jnp.float32)
    jcfg_b, jparams_b, _ = jt.load_safetensors_encoder(str(ours), dtype=jnp.float32)
    assert jcfg_a == jcfg_b
    flat_a = {k: np.asarray(v) for k, v in _flat(jparams_a)}
    flat_b = {k: np.asarray(v) for k, v in _flat(jparams_b)}
    assert flat_a.keys() == flat_b.keys()
    for key, value in flat_a.items():
        np.testing.assert_array_equal(flat_b[key], value, err_msg=key)
    _, model_a, _ = tt.load_safetensors_encoder(str(theirs), dtype=torch.float32)
    _, model_b, _ = tt.load_safetensors_encoder(str(ours), dtype=torch.float32)
    state_a, state_b = model_a.state_dict(), model_b.state_dict()
    assert state_a.keys() == state_b.keys() and "final_ln.weight" in state_a
    for key, value in state_a.items():
        assert torch.equal(state_b[key], value), key


def _flat(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


def _keys(tree: dict) -> set[str]:
    return {f"{k}.{sub}" for k, v in tree.items() if isinstance(v, dict) for sub in _keys(v)} | set(tree)


def test_store_scale_matches_the_jax_script(tmp_path) -> None:
    args = ["--chunks", "20000", "--dim", "8"]
    theirs = json.loads(_run(["scripts/store_scale_run.py", *args, "--dir", str(tmp_path / "jax")]).strip().splitlines()[-1])
    ours = json.loads(
        _run(["-m", "raglite_tpu_torch.store_scale", *args, "--dir", str(tmp_path / "port")]).strip().splitlines()[-1]
    )
    assert _keys(ours) == _keys(theirs)
    assert ours["n_chunks"] == theirs["n_chunks"] == 20_000
    for key in ("chunks", "lazy_open", "filtered_matches"):
        assert ours["reopen"][key] == theirs["reopen"][key], key
    assert ours["reopen"]["chunks"] == 20_000 and ours["reopen"]["lazy_open"] is True
