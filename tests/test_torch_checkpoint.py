"""The port's orbax ``ckpt:`` reader and writer (models/checkpoint.py,
tensorstore without orbax or JAX) against the JAX package's
models/checkpoint.py, both ways, on the CPU.

Tolerances: parameters read equal to what was written, bit for bit; logits
of the same f32 weights within 1e-4 (the decoder tests' summation-order
tolerance), greedy text equal; encoder embeddings within 1e-4.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("tensorstore")
pytest.importorskip("orbax.checkpoint")

from raglite_tpu.models import decoder as jdec  # noqa: E402
from raglite_tpu.models.checkpoint import load_checkpoint as jload  # noqa: E402
from raglite_tpu.models.encoder import TransformerEncoder as JEncoder  # noqa: E402
from raglite_tpu_torch.models import decoder as tdec  # noqa: E402
from raglite_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from raglite_tpu_torch.models.encoder import TransformerEncoder as TEncoder  # noqa: E402

TOL = 1e-4
TEXTS = ["the speed of light", "a dense index over chunks", ""]
MESSAGES = [{"role": "user", "content": "hi there"}]


def _logits(model, params, ids, *, jax_side: bool):
    if jax_side:
        out, _ = model.forward(params, jnp.asarray(ids, jnp.int32), model.init_cache(1, 32, dtype=jnp.float32),
                               jnp.asarray(0, jnp.int32))
        return np.asarray(out)
    out, _ = model.forward(params, torch.from_numpy(ids), model.init_cache(1, 32, dtype=torch.float32), 0)
    return out.numpy()


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
def test_jax_decoder_checkpoint_loads_into_the_port(tmp_path) -> None:
    j_llm = jdec.JaxChatLLM("tiny", seed=3, dtype=jnp.float32)
    j_llm.save_checkpoint(str(tmp_path / "dec"))
    tree, cfg = load_checkpoint(tmp_path / "dec")
    assert cfg == j_llm.cfg and isinstance(tree["layers"], list) and len(tree["layers"]) == cfg["layers"]
    np.testing.assert_array_equal(tree["layers"][1]["wq"], np.asarray(j_llm.params["layers"][1]["wq"]))
    t_llm = tdec.TorchChatLLM(f"ckpt:{tmp_path / 'dec'}", device="cpu", dtype=torch.float32)
    restored = jdec.JaxChatLLM(f"ckpt:{tmp_path / 'dec'}", dtype=jnp.float32)
    ids = np.random.default_rng(0).integers(3, 259, (1, 20))
    np.testing.assert_allclose(
        _logits(t_llm.model, t_llm.params, ids, jax_side=False),
        _logits(restored.model, restored.params, ids, jax_side=True), rtol=TOL, atol=TOL,
    )
    assert t_llm.complete(MESSAGES, max_tokens=12).content == restored.complete(MESSAGES, max_tokens=12).content


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_decoder_checkpoint_is_read_by_jax(tmp_path, dtype) -> None:
    t_llm = tdec.TorchChatLLM("tiny", seed=4, device="cpu", dtype=dtype)
    t_llm.save_checkpoint(str(tmp_path / "dec"))
    params, cfg = jload(tmp_path / "dec")
    assert cfg == t_llm.cfg
    for i, layer in enumerate(t_llm.params["layers"]):
        for name, value in layer.items():
            np.testing.assert_array_equal(np.asarray(params["layers"][i][name]).astype(np.float32), value.float().numpy())
    np.testing.assert_array_equal(np.asarray(params["tok_emb"]).astype(np.float32), t_llm.params["tok_emb"].float().numpy())
    # Both read the weights in their saved dtype; the f32 logits are
    # compared, and the greedy text in both dtypes.
    j_llm = jdec.JaxChatLLM(f"ckpt:{tmp_path / 'dec'}")
    back = tdec.TorchChatLLM(f"ckpt:{tmp_path / 'dec'}", device="cpu")
    assert back.params["tok_emb"].dtype == dtype
    if dtype == torch.float32:
        ids = np.random.default_rng(1).integers(3, 259, (1, 20))
        np.testing.assert_allclose(
            _logits(back.model, back.params, ids, jax_side=False),
            _logits(j_llm.model, j_llm.params, ids, jax_side=True), rtol=TOL, atol=TOL,
        )
    assert back.complete(MESSAGES, max_tokens=12).content == j_llm.complete(MESSAGES, max_tokens=12).content
    q = tdec.TorchChatLLM(f"ckpt:{tmp_path / 'dec'}@int8", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        q.save_checkpoint(str(tmp_path / "again"))


@pytest.mark.filterwarnings("ignore:Sharding info not provided")
def test_encoder_checkpoints_both_ways(tmp_path) -> None:
    JEncoder("tiny", seed=5, dtype=jnp.float32).save_checkpoint(str(tmp_path / "jax_enc"))
    want = JEncoder(f"ckpt:{tmp_path / 'jax_enc'}", dtype=jnp.float32).embed(TEXTS)
    ours = TEncoder(f"ckpt:{tmp_path / 'jax_enc'}", device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(ours.embed(TEXTS), want, rtol=TOL, atol=TOL)
    ours.save_checkpoint(str(tmp_path / "port_enc"))
    back = JEncoder(f"ckpt:{tmp_path / 'port_enc'}", dtype=jnp.float32).embed(TEXTS)
    np.testing.assert_allclose(back, want, rtol=TOL, atol=TOL)


def test_missing_tensorstore_is_named(tmp_path, monkeypatch) -> None:
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        load_checkpoint(tmp_path)
    with pytest.raises(ImportError, match="tensorstore"):
        save_checkpoint(tmp_path, {"w": torch.zeros(2)}, {})
