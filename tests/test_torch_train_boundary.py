"""The port's boundary-model trainer (raglite_tpu_torch/train/boundary.py)
against scripts/train_boundary.py and the JAX package's model, on the CPU.

Tolerances: the examples are equal; the BCE loss within rtol 1e-6 and its
gradients within 1e-6 of the largest |g| (f32 sums in other orders); Adam
fed the same gradients keeps the parameters within rtol 1e-6 of
``optax.adam(3e-3)`` (absolute floor 1e-9, a thousandth of an ulp of the
learning rate); a saved model reloads to equal parameters and
probabilities.  The script's whole recipe on the CPU reaches the held-out
F1 the acceptance asks of the card (0.99; the packaged model's is 0.999).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raglite_tpu.models.boundary as jb
import raglite_tpu.models.boundary_data as jdata
import raglite_tpu_torch.models.boundary as tb
from raglite_tpu_torch.models.boundary_data import make_corpus
from raglite_tpu_torch.train import boundary as tr
from raglite_tpu_torch.train import optim

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def script():
    """scripts/train_boundary.py as a module (it imports JAX and optax and
    runs nothing at import)."""
    spec = importlib.util.spec_from_file_location("train_boundary_script", ROOT / "scripts" / "train_boundary.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def examples():
    return tr.build_examples(make_corpus(num_documents=40, seed=tr.TRAIN_SEED))


def test_build_examples_equal_the_scripts(script, examples) -> None:
    corpus = jdata.make_corpus(num_documents=40, seed=script.TRAIN_SEED)
    assert corpus == make_corpus(num_documents=40, seed=tr.TRAIN_SEED)
    for got, want in zip(examples, script.build_examples(corpus), strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (script.TRAIN_SEED, script.EVAL_SEED, script.NUM_TRAIN_DOCS) == (tr.TRAIN_SEED, tr.EVAL_SEED, tr.NUM_TRAIN_DOCS)


def _jax_loss(params, xb, yb, wb):
    probs = jb._apply(params, xb)
    eps = 1e-7
    bce = -(yb * jnp.log(probs + eps) + (1 - yb) * jnp.log(1 - probs + eps))
    return jnp.mean(wb * bce)


def _params(seed: int) -> dict[str, np.ndarray]:
    params = tr.init_params(seed=seed)
    rng = np.random.default_rng(seed)
    params["b1"] = rng.normal(scale=0.1, size=params["b1"].shape).astype(np.float32)
    return params


def _grads(model: tb.BoundaryModel, batch) -> tuple[float, dict[str, np.ndarray]]:
    loss = tr.bce_loss(model, *map(torch.from_numpy, batch))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    names = ["emb", "w1", "b1", "w2", "b2"]
    transposed = {"w1", "w2"}
    return float(loss.detach()), {n: (g.T if n in transposed else g).numpy() for n, g in zip(names, grads)}


def test_bce_loss_and_gradients_match_jax(examples) -> None:
    params = _params(1)
    batch = tuple(a[:1024] for a in examples)
    jloss, jgrads = jax.value_and_grad(_jax_loss)({k: jnp.asarray(v) for k, v in params.items()}, *map(jnp.asarray, batch))
    loss, grads = _grads(tb.BoundaryModel.from_params(params, device="cpu"), batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name], np.asarray(g), atol=1e-6 * scale, rtol=0, err_msg=name)


def test_adam_steps_match_optax(examples) -> None:
    """5 steps of ``optax.adam(3e-3)`` and the port's ``adam`` on the same
    gradients (JAX's, at JAX's parameters), from the seeded init; then the
    port's own steps (its gradients) stay within rtol 1e-4 of the loss."""
    params = _params(2)
    optimizer = optax.adam(tr.LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = optimizer.init(jp)
    model = tb.BoundaryModel.from_params(params, device="cpu")
    own = tb.BoundaryModel.from_params(params, device="cpu")
    names = ["emb", "w1", "b1", "w2", "b2"]
    opt = optim.adam(list(model.parameters()), tr.LR)
    own_opt = optim.adam(list(own.parameters()), tr.LR)
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss))
    for k in range(5):
        batch = tuple(a[256 * k : 256 * (k + 1)] for a in examples)
        jloss, g = grad_fn(jp, *map(jnp.asarray, batch))
        updates, state = optimizer.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(np.array(g[n].T if n in ("w1", "w2") else g[n])) for n in names])
        for name, value in model.params().items():
            np.testing.assert_allclose(value, np.asarray(jp[name]), rtol=1e-6, atol=1e-9, err_msg=name)
        loss = tr.bce_loss(own, *map(torch.from_numpy, batch))
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
        own_opt.step(list(torch.autograd.grad(loss, list(own.parameters()))))


def test_save_then_load_round_trips(tmp_path) -> None:
    model = tb.BoundaryModel.from_params(_params(3), device="cpu")
    path = tmp_path / "out" / "boundary.npz"
    model.save(path)
    back = tb.BoundaryModel.load(path, device="cpu")
    for name, value in model.params().items():
        np.testing.assert_array_equal(back.params()[name], value)
    doc = "Dr. Smith arrived early. The meeting began at 9 a.m. sharp. 実験は成功した。"
    np.testing.assert_array_equal(back(doc), model(doc))
    # The JAX package reads the file to the same probabilities.
    np.testing.assert_allclose(jb.BoundaryModel.load(path)(doc), model(doc), atol=1e-6)


def test_init_params_shapes_and_scales() -> None:
    params = tr.init_params(seed=0)
    want = jax.tree.map(lambda x: (x.shape, x.dtype), jb.init_params(seed=0))
    assert {k: (v.shape, v.dtype) for k, v in params.items()} == want
    assert not params["b1"].any() and not params["b2"].any()
    assert abs(params["emb"].std() - 0.1) < 0.01
    assert abs(params["w1"].std() * np.sqrt(params["w1"].shape[0]) - 1) < 0.05
    assert not np.array_equal(params["w1"], tr.init_params(seed=1)["w1"])


def test_the_scripts_recipe_on_the_cpu(tmp_path) -> None:
    """``python -m raglite_tpu_torch.train.boundary --device cpu``: 800
    documents, 40 epochs, the save to ``--out`` and the held-out report."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the steps are small; one thread is as fast
    try:
        model, stats = tr.main(["--device", "cpu", "--out", str(tmp_path / "boundary.npz")])
    finally:
        torch.set_num_threads(threads)
    assert stats["docs"] == 800 and stats["steps"] == 40 * (stats["examples"] // 1024)
    assert stats["f1_learned"] >= 0.99 > stats["f1_heuristic"]
    back = tb.BoundaryModel.load(tmp_path / "boundary.npz", device="cpu")
    doc = make_corpus(num_documents=1, seed=tr.EVAL_SEED)[0][0]
    np.testing.assert_array_equal(back(doc), model(doc))
    np.testing.assert_allclose(back(doc), jb.BoundaryModel.load(tmp_path / "boundary.npz")(doc), atol=1e-6)
