"""The port's encoder trainer (raglite_tpu_torch/train/) against the JAX
script's losses, optax and the script's host draws, on the CPU.

The JAX side is rebuilt here from scripts/train_encoder.py's lines (its
loss functions over ``raglite_tpu.models.transformer.EncoderModel``, its
``make_batch`` closures, its mining tile); the script itself is not
imported, since importing it sets a persistent JAX compile cache.
Weights cross as numpy arrays (``params_from_jax(..., dtype=float32)``).

Tolerances: in f32 each loss within rtol 1e-5 and each gradient leaf within
1e-5 of the largest |g| of the tree (XLA's and PyTorch's CPU matmuls sum in
other orders); in bf16 (matrices cast, vectors f32, as the script does)
each loss within rtol 1e-2 and the flattened gradients' cosine at least
0.999 (bf16 rounds at the same places in both, but a rounding can land on
either side after a differently ordered f32 sum).  The optimizer's f32
parameters within rtol 1e-6, with an absolute floor of 1e-6 of the peak
learning rate: the global norm of the clip is summed in another order, so
an update may differ in its last bit, which near a parameter's zero
crossing is no relative bound.  Batch draws and the token cache are equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from tokenizers import Tokenizer

from raglite_tpu.models import transformer as jt
from raglite_tpu_torch.models import transformer as tt
from raglite_tpu_torch.train import corpus as tcorpus
from raglite_tpu_torch.train import encoder as te
from raglite_tpu_torch.train import optim

CFG = dict(layers=2, d_model=64, heads=4, d_ff=128, vocab=512, max_len=128)
SEQ, QSEQ = 32, 16
PAD, BOS, MASK = 0, 1, 3
TEMP = 0.05


def _tokens(seed: int = 0, docs: int = 40):
    """A random token cache: documents of 20-100 ids in [4, vocab)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(20, 100, docs)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    flat = rng.integers(4, CFG["vocab"], int(offsets[-1])).astype(np.uint16)
    return flat, offsets


def _jax_params(seed: int = 1):
    params = jt.init_encoder_params(CFG, seed=seed, dtype=jnp.float32)
    # Nonzero biases and LayerNorm parameters, so every term has a gradient
    # worth comparing.
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    for layer in params["layers"]:
        for name in layer:
            if name.startswith("b") or name.endswith("_bias"):
                layer[name] = rng.normal(scale=0.1, size=layer[name].shape).astype(np.float32)
    return params


# --- The script's losses, in JAX -------------------------------------------------


def _cast(p, dtype):
    return jax.tree.map(lambda x: x.astype(dtype) if x.ndim >= 2 else x, p)


def _jax_losses(dtype):
    model = jt.EncoderModel(CFG)

    def mlm(p, ids, labels, weights):
        p16 = _cast(p, dtype)
        hidden = model.apply_tokens(p16, ids, ids != PAD)
        logits = jnp.einsum("btd,vd->btv", hidden.astype(dtype), p16["tok_emb"], preferred_element_type=jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * weights) / jnp.maximum(jnp.sum(weights), 1.0)

    @jax.checkpoint
    def embed(p, ids):
        mask = ids != PAD
        hidden = model.apply_tokens(p, ids, mask)
        pooled = jnp.sum(hidden * mask[:, :, None], axis=1) / jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
        return pooled / jnp.maximum(jnp.linalg.norm(pooled, axis=1, keepdims=True), 1e-6)

    def contrastive(p, a_ids, b_ids):
        p16 = _cast(p, dtype)
        za = embed(p16, a_ids)
        zb = embed(p16, b_ids)
        logits = za @ zb.T / TEMP
        labels = jnp.arange(za.shape[0])
        loss_ab = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        loss_ba = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
        return 0.5 * (jnp.mean(loss_ab) + jnp.mean(loss_ba))

    def hardneg(p, q_ids, pos_ids, neg_ids):
        p16 = _cast(p, dtype)
        zq, zp, zn = embed(p16, q_ids), embed(p16, pos_ids), embed(p16, neg_ids)
        logits = zq @ jnp.concatenate([zp, zn]).T / TEMP
        labels = jnp.arange(zq.shape[0])
        loss_qp = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        loss_pq = optax.softmax_cross_entropy_with_integer_labels((zp @ zq.T) / TEMP, labels)
        return 0.5 * (jnp.mean(loss_qp) + jnp.mean(loss_pq))

    @jax.checkpoint
    def tokens_and_pool(p, ids):
        mask = ids != PAD
        hidden = model.apply_tokens(p, ids, mask)
        pooled = jnp.sum(hidden * mask[:, :, None], axis=1) / jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
        pooled = pooled / jnp.maximum(jnp.linalg.norm(pooled, axis=1, keepdims=True), 1e-6)
        tok = hidden / jnp.maximum(jnp.linalg.norm(hidden, axis=-1, keepdims=True), 1e-6)
        tok = tok * mask[:, :, None]
        return tok.astype(jnp.bfloat16), pooled

    def maxsim_matrix(qt, q_mask, dt, d_mask):
        sims = jnp.einsum("bqd,ctd->bcqt", qt, dt, preferred_element_type=jnp.float32)
        sims = jnp.where(d_mask[None, :, None, :], sims, -jnp.inf)
        best = jnp.max(sims, axis=-1)
        best = jnp.where(jnp.isfinite(best), best, 0.0)
        denom = jnp.maximum(jnp.sum(q_mask, axis=1), 1.0)
        return jnp.einsum("bcq,bq->bc", best, q_mask) / denom[:, None]

    def maxsim(p, q_ids, pos_ids, neg_ids, dense_weight=1.5):
        p16 = _cast(p, dtype)
        qt, zq = tokens_and_pool(p16, q_ids)
        pt, zp = tokens_and_pool(p16, pos_ids)
        nt, zn = tokens_and_pool(p16, neg_ids)
        labels = jnp.arange(zq.shape[0])
        dense_logits = zq @ jnp.concatenate([zp, zn]).T / TEMP
        loss_dense = 0.5 * (
            jnp.mean(optax.softmax_cross_entropy_with_integer_labels(dense_logits, labels))
            + jnp.mean(optax.softmax_cross_entropy_with_integer_labels((zp @ zq.T) / TEMP, labels))
        )
        q_mask = (q_ids != PAD).astype(jnp.float32)
        d_mask = jnp.concatenate([pos_ids, neg_ids]) != PAD
        dt = jnp.concatenate([pt, nt])
        ms_logits = maxsim_matrix(qt, q_mask, dt, d_mask) / TEMP
        loss_tok = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(ms_logits, labels))
        return dense_weight * loss_dense + loss_tok

    return {"mlm": mlm, "contrastive": contrastive, "hardneg": hardneg, "maxsim": maxsim}


def _port_loss(name):
    if name == "maxsim":
        return lambda net, p, *b: te.maxsim_loss(net, p, *b, dense_weight=1.5)[0]
    return {"mlm": te.mlm_loss, "contrastive": te.contrastive_loss, "hardneg": te.hardneg_loss}[name]


def _batch(name: str, batch: int = 6):
    flat, offsets = _tokens()
    if name == "mlm":
        return te.MLMBatches(flat, offsets, batch, SEQ, CFG["vocab"])()
    if name == "contrastive":
        return te.CropBatches(flat, offsets, batch, SEQ, QSEQ)()
    ok = np.flatnonzero(np.diff(offsets) >= 48)
    neighbors = ok[np.random.default_rng(5).integers(0, ok.size, (ok.size, 8))]
    return te.NegativeBatches(flat, offsets, ok, neighbors, batch, SEQ, QSEQ, seed=2)()


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mlm", "contrastive", "hardneg", "maxsim"])
def test_loss_and_gradients_match_the_script(name: str, dtype: str) -> None:
    params = _jax_params()
    arrays = _batch(name)
    jloss, jgrads = jax.value_and_grad(_jax_losses(getattr(jnp, dtype))[name])(
        jax.tree.map(jnp.asarray, params), *map(jnp.asarray, arrays)
    )
    net = te.Trainable(CFG, tt.params_from_jax(params, dtype=torch.float32), torch.device("cpu"), getattr(torch, dtype))
    loss = _port_loss(name)(net, net.cast(), *map(torch.from_numpy, arrays))
    grads = dict(zip(net.masters, torch.autograd.grad(loss, net.leaves)))
    loss = loss.detach()
    tgrads = tt.state_to_jax(grads)
    want, got = _flat(jgrads), _flat(jax.tree.map(lambda t: t.numpy(), tgrads))
    assert jax.tree.structure(jax.tree.map(np.asarray, jgrads)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), tgrads)
    )
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        # The MaxSim phase rounds its token states to bf16 in every mode (as
        # the script does): a state on a rounding boundary lands on either
        # side, and a max over tokens may then pick another token.
        atol = (1e-4 if name == "maxsim" else 1e-5) * np.abs(want).max()
        for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jgrads), jax.tree.leaves(tgrads)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0, err_msg=str(path))
    else:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-2)
        cosine = float(want @ got / (np.linalg.norm(want) * np.linalg.norm(got)))
        assert cosine >= 0.999, cosine


@pytest.mark.parametrize("warmup", [2, 0])
def test_adamw_clip_and_schedule_match_optax(warmup: int) -> None:
    """5 steps of the script's chain (clip, adamw at b1 0.9, b2 0.98, eps
    1e-6, wd 0.01, warmup-cosine) on gradients that cross the clip's norm
    both ways; a warmup from 0 makes the first update's lr 0."""
    rng = np.random.default_rng(warmup)
    shapes = [(64, 32), (32,), (3, 16, 8), (300,)]
    p0 = [(rng.normal(size=s) * 0.1 + (i == 1)).astype(np.float32) for i, s in enumerate(shapes)]
    grads = [[rng.normal(size=s).astype(np.float32) * (3.0 if k % 2 else 0.01) for s in shapes] for k in range(5)]
    peak = 1e-3
    chain = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(optax.warmup_cosine_decay_schedule(0.0, peak, warmup, 5, 1e-4), b1=0.9, b2=0.98, eps=1e-6,
                    weight_decay=0.01),
    )
    jp = [jnp.asarray(x) for x in p0]
    state = chain.init(jp)
    update = jax.jit(chain.update)
    tp = [torch.from_numpy(x.copy()) for x in p0]
    opt = optim.adamw(tp, optim.warmup_cosine_decay_schedule(0.0, peak, warmup, 5, 1e-4), b1=0.9, b2=0.98,
                      eps=1e-6, weight_decay=0.01, clip=1.0)
    for k, g in enumerate(grads):
        updates, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        # The update clips its gradients in place: hand it copies, since
        # JAX may still be reading the same numpy buffers.
        opt.step([torch.from_numpy(x.copy()) for x in g])
        for j, t in zip(jp, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6 * peak)
        if k == 0 and warmup:
            for j, t in zip(p0, tp):  # lr 0: only the moments moved
                np.testing.assert_array_equal(t.numpy(), j)
    sched = optax.warmup_cosine_decay_schedule(0.0, 4e-4, 50, 200, 2e-5)
    ours = optim.warmup_cosine_decay_schedule(0.0, 4e-4, 50, 200, 2e-5)
    # f32 in both; XLA's cos and numpy's may differ in the last bit.
    np.testing.assert_allclose([ours(i) for i in range(260)], [float(sched(i)) for i in range(260)], rtol=1e-6)


def test_cross_entropy_matches_optax() -> None:
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 7)).astype(np.float32) * 10
    labels = rng.integers(0, 7, 5)
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits), jnp.asarray(labels))
    got = optim.softmax_cross_entropy_with_integer_labels(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --- The script's draws (its make_batch closures, copied) ------------------------


def _doc_sampler(flat, offsets, rng, min_len=24):
    lengths = np.diff(offsets)
    ok = np.flatnonzero(lengths >= min_len)
    while True:
        idx = ok[rng.integers(0, ok.size)]
        yield offsets[idx], lengths[idx]


def _script_mlm(flat, offsets, batch, vocab):
    rng = np.random.default_rng(0)
    sampler = _doc_sampler(flat, offsets, rng, min_len=SEQ // 2)

    def make_batch():
        ids = np.full((batch, SEQ), PAD, np.int32)
        labels = np.zeros((batch, SEQ), np.int32)
        weights = np.zeros((batch, SEQ), np.float32)
        for b in range(batch):
            start, length = next(sampler)
            take = min(length, SEQ)
            off = start + (rng.integers(0, length - take + 1) if length > take else 0)
            row = flat[off : off + take].astype(np.int32)
            n_mask = max(1, int(0.15 * take))
            pos = rng.choice(take, size=n_mask, replace=False)
            labels[b, pos] = row[pos]
            weights[b, pos] = 1.0
            corrupted = row.copy()
            split = rng.random(n_mask)
            corrupted[pos[split < 0.8]] = MASK
            rand_pos = pos[(split >= 0.8) & (split < 0.9)]
            corrupted[rand_pos] = rng.integers(4, vocab, rand_pos.size)
            ids[b, :take] = corrupted
        return ids, labels, weights

    return make_batch


def _script_contrastive(flat, offsets, batch):
    rng = np.random.default_rng(1)
    sampler = _doc_sampler(flat, offsets, rng, min_len=48)

    def crop(start, length, lo, hi):
        size = int(rng.integers(lo, min(hi, length) + 1))
        off = int(rng.integers(0, length - size + 1))
        return flat[start + off : start + off + size].astype(np.int32)

    def make_batch():
        a = np.full((batch, SEQ), PAD, np.int32)
        b = np.full((batch, QSEQ), PAD, np.int32)
        for i in range(batch):
            start, length = next(sampler)
            ca = crop(start, length, 32, SEQ)
            cb = crop(start, length, 8, min(48, QSEQ))
            a[i, : ca.size] = ca
            b[i, : cb.size] = cb
        return a, b

    return make_batch


def _script_negatives(flat, offsets, ok_docs, neighbors, batch, seed):
    rng = np.random.default_rng(seed)
    lengths = np.diff(offsets)
    doc_row = {int(d): i for i, d in enumerate(ok_docs)}

    def crop(doc_idx, lo, hi):
        start, length = int(offsets[doc_idx]), int(lengths[doc_idx])
        size = int(rng.integers(lo, min(hi, length) + 1))
        off = int(rng.integers(0, length - size + 1))
        return flat[start + off : start + off + size].astype(np.int32)

    def make_batch():
        q = np.full((batch, QSEQ), PAD, np.int32)
        p_ = np.full((batch, SEQ), PAD, np.int32)
        n_ = np.full((batch, SEQ), PAD, np.int32)
        for i in range(batch):
            di = int(ok_docs[rng.integers(0, ok_docs.size)])
            cq = crop(di, 8, min(48, QSEQ))
            cp = crop(di, 32, SEQ)
            ni = int(neighbors[doc_row[di], rng.integers(0, neighbors.shape[1])])
            cn = crop(ni, 32, SEQ)
            q[i, : cq.size] = cq
            p_[i, : cp.size] = cp
            n_[i, : cn.size] = cn
        return q, p_, n_

    return make_batch


@pytest.mark.parametrize("name", ["mlm", "contrastive", "hardneg", "maxsim"])
def test_batch_makers_draw_the_scripts_numbers(name: str) -> None:
    flat, offsets = _tokens(3, docs=60)
    batch = 16
    if name == "mlm":
        ours, script = te.MLMBatches(flat, offsets, batch, SEQ, CFG["vocab"]), _script_mlm(flat, offsets, batch, CFG["vocab"])
    elif name == "contrastive":
        ours, script = te.CropBatches(flat, offsets, batch, SEQ, QSEQ), _script_contrastive(flat, offsets, batch)
    else:
        ok = np.flatnonzero(np.diff(offsets) >= 48)
        neighbors = ok[np.random.default_rng(7).integers(0, ok.size, (ok.size, 8))]
        seed = 2 if name == "hardneg" else 3
        ours = te.NegativeBatches(flat, offsets, ok, neighbors, batch, SEQ, QSEQ, seed=seed)
        script = _script_negatives(flat, offsets, ok, neighbors, batch, seed)
    for _ in range(4):
        for got, want in zip(ours(), script(), strict=True):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_nearest_matches_the_scripts_tile_on_tie_free_embeddings() -> None:
    """The mining's tiles and top 8 (self excluded) against the script's
    ``topk_tile`` on bf16 embeddings whose similarities have no ties: each
    row's products with the others are distinct integers below 256, exact
    in bf16."""
    n, d, k = 16, 4, 8
    rng = np.random.default_rng(0)
    embs = np.zeros((n, d), np.float32)
    embs[:, rng.integers(0, d)] = rng.permutation(np.arange(1, n + 1))
    jembs = jnp.asarray(embs, jnp.bfloat16)

    def topk_tile(embs, tile, tile_idx):
        sims = (tile @ embs.T).astype(jnp.float32)
        cols = jnp.arange(embs.shape[0])[None, :]
        sims = jnp.where(cols == tile_idx[:, None], -jnp.inf, sims)
        return jax.lax.top_k(sims, k)[1]

    want = np.empty((n, k), np.int64)
    for i in range(0, n, 5):
        tile = jembs[i : i + 5]
        want[i : i + tile.shape[0]] = np.asarray(topk_tile(jembs, tile, jnp.arange(i, i + tile.shape[0])))
    got = te.nearest(torch.from_numpy(embs).to(torch.bfloat16), k, tile=5)
    np.testing.assert_array_equal(got, want)


def test_mining_excludes_self_and_maps_documents() -> None:
    flat, offsets = _tokens(4, docs=30)
    net = te.Trainable(CFG, tt.params_from_jax(_jax_params(), dtype=torch.float32), torch.device("cpu"), torch.bfloat16)
    ok, neighbors = te.mine_hard_negatives(net, flat, offsets, SEQ)
    assert np.array_equal(ok, np.flatnonzero(np.diff(offsets) >= 48))
    assert neighbors.shape == (ok.size, 8)
    assert set(neighbors.ravel()) <= set(ok.tolist())
    assert all(d not in row for d, row in zip(ok, neighbors))
    assert all(len(set(row.tolist())) == 8 for row in neighbors)


def test_token_cache_equals_tokenizers_ids(tmp_path) -> None:
    """Harvested documents tokenized by the port equal ``tokenizers``'
    ``encode_batch`` of the packaged tokenizer.json (the script's cache)."""
    stats = tcorpus.write_corpus(tmp_path / "corpus", 0.05)
    assert stats["train_docs"] > 5
    texts = [json.loads(line)["text"] for line in (tmp_path / "corpus" / "train.jsonl").read_text().splitlines()]
    out = tcorpus.build_token_cache(tmp_path / "corpus", tmp_path / "tokens.npz", str(te.PACKAGED_TOKENIZER))
    flat, offsets = tcorpus.load_tokens(tmp_path / "tokens.npz")
    ref = Tokenizer.from_file(str(te.PACKAGED_TOKENIZER)).encode_batch(texts)
    want = np.concatenate([np.asarray(e.ids, np.uint16) for e in ref])
    assert out["docs"] == len(texts) and flat.dtype == np.uint16
    np.testing.assert_array_equal(flat, want)
    np.testing.assert_array_equal(offsets, np.cumsum([0] + [len(e.ids) for e in ref]))


def test_export_reads_in_the_jax_package(tmp_path) -> None:
    """A phase file and its export, written by the port, read by
    ``raglite_tpu``'s ``load_npz_encoder`` to the arrays the script's own
    export writes from the same phase file."""
    state = te.init_params(CFG, seed=4)
    workdir = tmp_path / "work"
    workdir.mkdir()
    te.save_params(workdir / "hardneg.npz", state, CFG)
    run = te.Run(cfg=CFG, workdir=workdir, device=torch.device("cpu"))
    assert te.run_export(run, tmp_path / "out").name == "hardneg.npz"
    # The phase file round-trips in f32.
    jcfg, jparams, _ = jt.load_npz_encoder(str(workdir / "hardneg.npz"), dtype=jnp.float32)
    assert jcfg == CFG
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jparams),
                            jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), tt.state_to_jax(state)))):
        np.testing.assert_array_equal(np.asarray(j), t, err_msg=str(path))
    # The script's export of the same file.
    cfg16, p16, _ = jt.load_npz_encoder(str(workdir / "hardneg.npz"), dtype=jnp.float16)
    jt.save_npz_encoder(str(tmp_path / "script.npz"), p16, cfg16, dtype=np.float16)
    with np.load(tmp_path / "out" / "encoder.npz") as ours, np.load(tmp_path / "script.npz") as script:
        assert set(ours.files) == set(script.files)
        for key in script.files:
            assert ours[key].dtype == script[key].dtype, key
            np.testing.assert_array_equal(ours[key], script[key], err_msg=key)
    _, got, _ = jt.load_npz_encoder(str(tmp_path / "out" / "encoder.npz"), dtype=jnp.float16)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(p16)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    config = json.loads((tmp_path / "out" / "config.json").read_text())
    assert config == {**CFG, "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2}
    assert (tmp_path / "out" / "tokenizer.json").read_bytes() == te.PACKAGED_TOKENIZER.read_bytes()


def _jax_train(params, loss_fn, schedule, batches, steps):
    chain = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(schedule, b1=0.9, b2=0.98, eps=1e-6, weight_decay=0.01),
    )
    opt_state = chain.init(params)

    @jax.jit
    def train_step(p, o, *batch):
        loss, grads = jax.value_and_grad(loss_fn)(p, *batch)
        updates, o = chain.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    losses = []
    for _ in range(steps):
        params, opt_state, loss = train_step(params, opt_state, *map(jnp.asarray, batches()))
        losses.append(float(loss))
    return params, losses


def test_phases_chain_and_match_the_scripts_steps(tmp_path) -> None:
    """The slice end to end on the CPU in f32: ``run_mlm`` from the seeded
    init and ``run_contrastive`` from its file, each 4 steps, against the
    script's train steps (its loss, optax's chain, its batches) from the
    same weights; then mining, ``run_hardneg``, ``run_maxsim`` and the
    export, whose encoder loads as ``flax:<out>``."""
    from raglite_tpu_torch.models.encoder import TransformerEncoder

    workdir = tmp_path / "work"
    workdir.mkdir()
    flat, offsets = _tokens(6, docs=50)
    np.savez(workdir / "tokens.npz", flat=flat, offsets=offsets)
    lines: list[str] = []
    run = te.Run(cfg=CFG, workdir=workdir, device=torch.device("cpu"), seq=SEQ, qseq=QSEQ,
                 compute_dtype=torch.float32, log=lines.append)
    losses = _jax_losses(jnp.float32)
    steps, batch = 4, 6

    init = jax.tree.map(jnp.asarray, tt.state_to_jax({k: v.numpy() for k, v in te.init_params(CFG).items()}))
    mlm = te.run_mlm(run, steps, batch)
    want, want_losses = _jax_train(
        init, losses["mlm"], optax.warmup_cosine_decay_schedule(0.0, 4e-4, 1, steps, 2e-5),
        te.MLMBatches(flat, offsets, batch, SEQ, CFG["vocab"]), steps,
    )
    np.testing.assert_allclose(mlm["losses"], want_losses, rtol=1e-5)
    _, got, _ = jt.load_npz_encoder(str(workdir / "mlm.npz"), dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)

    con = te.run_contrastive(run, steps, batch)
    want, want_losses = _jax_train(
        got, losses["contrastive"], optax.warmup_cosine_decay_schedule(0.0, 1e-4, 0, steps, 1e-5),
        te.CropBatches(flat, offsets, batch, SEQ, QSEQ), steps,
    )
    np.testing.assert_allclose(con["losses"], want_losses, rtol=1e-5)
    _, got, _ = jt.load_npz_encoder(str(workdir / "contrastive.npz"), dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)

    hard = te.run_hardneg(run, 2, 4)
    sim = te.run_maxsim(run, 2, 4)
    assert hard["mined_docs"] == sim["mined_docs"] == int(np.sum(np.diff(offsets) >= 48))
    assert all(np.isfinite(hard["losses"])) and all(np.isfinite(sim["losses"]))
    assert {"mlm.npz", "contrastive.npz", "hardneg.npz", "maxsim.npz"} <= {p.name for p in workdir.iterdir()}
    assert any(line.startswith("hardneg: mined top-8") for line in lines)
    te.run_export(run, tmp_path / "out")
    # The packaged tokenizer's ids reach 16,383: for this 512-row vocabulary
    # the export gets the packaged tokenizer cut to its first 512 ids (and
    # the merges among them).
    spec = json.loads((tmp_path / "out" / "tokenizer.json").read_text())
    vocab = {k: v for k, v in spec["model"]["vocab"].items() if v < CFG["vocab"]}
    pairs = [m.split(" ") if isinstance(m, str) else m for m in spec["model"]["merges"]]
    spec["model"]["vocab"] = vocab
    spec["model"]["merges"] = [m for m in pairs if m[0] in vocab and m[1] in vocab and m[0] + m[1] in vocab]
    (tmp_path / "out" / "tokenizer.json").write_text(json.dumps(spec))
    encoder = TransformerEncoder(str(tmp_path / "out"), device="cpu", dtype=torch.float32)
    emb = encoder.embed(["a sentence about cats", "another about dogs"])
    assert emb.shape == (2, CFG["d_model"]) and np.isfinite(emb).all()


def test_step_flops_counts_the_shapes() -> None:
    base = te.SIZES["base"]
    # From the shapes by hand: ~424 M FLOP a token at SEQ 128 (layer GEMMs,
    # attention and the tied logits, forward and backward).
    per_token = te.step_flops(base, [(1, 128)], logits=128) / 128
    assert 4.0e8 < per_token < 4.5e8, per_token
