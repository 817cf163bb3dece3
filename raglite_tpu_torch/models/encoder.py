"""Embedding encoders (counterpart of raglite_tpu/models/encoder.py).

``TransformerEncoder`` ("flax:<preset|dir|file.safetensors|ckpt:dir>", the
JAX package's spec names kept so configs map one to one) runs the PyTorch
``EncoderModel`` on the configured device, with token-level outputs for late
chunking and a device-resident MaxSim rerank.  ``"flax:sem"`` is the packaged 8-layer,
d=768 semantic encoder; its weights are read by path from the JAX package's
data directory.  ``HashEncoder`` ("hash:<dim>") is the weightless
feature-hashing encoder of the hermetic configs, over the JAX package's own
Gaussian table (models/hash_table.py).  ``OpenAICompatEncoder``
("openai:<base_url>#<model>") takes its embeddings from an OpenAI-compatible
``/embeddings`` endpoint and normalises them on the configured device.
"""

from __future__ import annotations

import os
import re
import zlib
from functools import lru_cache
from pathlib import Path
from typing import Protocol

import numpy as np
import torch

from raglite_tpu_torch.ops.fused_scan import full_f32_matmul
from raglite_tpu_torch.utils.padding import round_up as _round_up

__all__ = [
    "Encoder", "HashEncoder", "OpenAICompatEncoder", "TransformerEncoder",
    "encoder_from_config", "embedding_dim", "hash_pool_plain", "load_pretrained_encoder",
]

#: The JAX package's packaged encoder (encoder.npz, tokenizer.json, config.json).
PACKAGED_ENCODER_DIR = (
    Path(__file__).resolve().parents[2] / "raglite_tpu" / "models" / "data" / "encoder"
)


class Encoder(Protocol):
    """Uniform encoder interface consumed by embed.py."""

    dim: int
    max_tokens: int
    supports_token_embeddings: bool

    def count_tokens(self, texts: list[str]) -> list[int]: ...

    def embed_token_level(self, text: str) -> np.ndarray:
        """Token-level embeddings [num_tokens, dim] (pre-pooling)."""
        ...

    def embed(self, texts: list[str]) -> np.ndarray:
        """Mean-pooled embeddings [len(texts), dim]."""
        ...


# --- Hash encoder -------------------------------------------------------------

_TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


@lru_cache(maxsize=2)
def _hash_table(seed: int, rows: int, dim: int) -> np.ndarray:
    """The f32 table per (seed, rows, dim), drawn once a process: in C++,
    or in numpy without the native library (models/hash_table.py)."""
    from raglite_tpu_torch.models.hash_table import normal_table_np
    from raglite_tpu_torch.native import normal_table

    table = normal_table(seed, rows, dim)
    return table if table is not None else normal_table_np(seed, rows, dim)


def _hash_pool(table: torch.Tensor, ids: torch.Tensor, signs: torch.Tensor, bounds: np.ndarray) -> torch.Tensor:
    """Token embeddings [n, d] f32 on the table's device: the signed sum of
    each token's feature rows (features ``bounds[t]:bounds[t + 1]``), L2
    normalised (norm floored at 1e-6), as the JAX package's ``_hash_pool``.
    Deterministic: tokens are grouped by their feature count rounded up to a
    power of two, each group's rows gathered into [tokens, count, d] (a pad
    slot reads the zero row appended to ``ids``) and summed along the count
    axis; no atomics."""
    counts = np.diff(bounds)
    n = counts.size
    device = table.device
    zero_slot = ids.numel()  # rows/signs get one zero entry appended here
    rows = table[torch.cat([ids, ids.new_zeros(1)])].to(torch.float32)
    rows = rows * torch.cat([signs, signs.new_zeros(1)])[:, None]
    out = torch.empty((n, table.shape[1]), dtype=torch.float32, device=device)
    width = 1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
    for w in np.unique(width):
        members = np.nonzero(width == w)[0]
        slot = bounds[members][:, None] + np.arange(w)[None, :]
        slot = np.where(np.arange(w)[None, :] < counts[members][:, None], slot, zero_slot)
        gathered = rows[torch.from_numpy(slot).to(device)]  # [m, w, d]
        out[torch.from_numpy(members).to(device)] = gathered.sum(dim=1)
    norm = torch.linalg.vector_norm(out, dim=1, keepdim=True)
    return out / torch.clamp(norm, min=1e-6)


def hash_pool_plain(table: np.ndarray, ids: np.ndarray, signs: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """The plain version of the device pool: f64 on the host, one token at a
    time (``table`` rows as given, e.g. the bf16 table's values)."""
    rows = table[ids].astype(np.float64) * signs[:, None]
    out = np.stack([rows[a:b].sum(axis=0) for a, b in zip(bounds[:-1], bounds[1:])])
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-6)


class HashEncoder:
    """Deterministic feature-hashing encoder (``hash:<dim>``).

    A token's features are the word itself and, for words of three or more
    characters, the character trigrams of ``#word#``; each hashes (crc32) to
    a row of a fixed Gaussian table with a sign from the hash's top bit.  A
    token's embedding is the L2-normalised signed sum of its rows; a text's
    embedding is the mean of its tokens'.  The table is the JAX package's
    ``jax.random.normal(PRNGKey(seed), (2**vocab_bits, dim))``, bit for bit.
    As in the JAX package, a CUDA device keeps it in bf16 and pools there (a
    gather and a segment sum); the CPU keeps it in f32 and pools in C++
    (``native.hash_embed``).
    """

    supports_token_embeddings = True

    def __init__(
        self,
        dim: int = 1024,
        *,
        vocab_bits: int = 16,
        max_tokens: int = 8192,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ) -> None:
        self.dim = dim
        self.max_tokens = max_tokens
        self._mask = (1 << vocab_bits) - 1
        self.device = torch.device(device)
        self._table_np = _hash_table(seed, 1 << vocab_bits, dim)
        self._table = (
            torch.from_numpy(self._table_np).to(self.device, torch.bfloat16)
            if self.device.type == "cuda"
            else torch.from_numpy(self._table_np)
        )

    def _features(self, token: str) -> tuple[list[int], list[float]]:
        """Python featurizer (the fallback without the native library)."""
        feats = [token]
        padded = f"#{token}#"
        if len(token) > 2:
            feats.extend(padded[i : i + 3] for i in range(len(padded) - 2))
        ids, signs = [], []
        for f in feats:
            h = zlib.crc32(f.encode("utf-8"))
            ids.append(h & self._mask)
            signs.append(1.0 if (h >> 31) & 1 else -1.0)
        return ids, signs

    def _featurize(self, text: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """(feature ids int32, signs f32, per-token feature bounds int64 [n +
        1], n tokens): the C++ featurizer, else the Python one."""
        from raglite_tpu_torch.native import hash_featurize

        native = hash_featurize(text, max_tokens=self.max_tokens, mask=self._mask)
        if native is not None:
            return native
        tokens = _TOKEN_RE.findall(text.lower())[: self.max_tokens]
        ids: list[int] = []
        signs: list[float] = []
        bounds = [0]
        for token in tokens:
            f_ids, f_signs = self._features(token)
            ids.extend(f_ids)
            signs.extend(f_signs)
            bounds.append(len(ids))
        return (
            np.asarray(ids, dtype=np.int32),
            np.asarray(signs, dtype=np.float32),
            np.asarray(bounds, dtype=np.int64),
            len(tokens),
        )

    def count_tokens(self, texts: list[str]) -> list[int]:
        from raglite_tpu_torch.native import count_tokens as native_count

        counts = []
        for text in texts:
            n = native_count(text)
            counts.append(n if n is not None else len(_TOKEN_RE.findall(text.lower())))
        return counts

    @torch.inference_mode()
    def embed_token_level(self, text: str) -> np.ndarray:
        if self.device.type == "cpu":
            from raglite_tpu_torch.native import hash_embed

            native = hash_embed(text, self._table_np, max_tokens=self.max_tokens, mask=self._mask)
            if native is not None:
                return native
        ids, signs, bounds, n = self._featurize(text)
        if n == 0:
            return np.zeros((0, self.dim), dtype=np.float32)
        out = _hash_pool(
            self._table,
            torch.from_numpy(ids.astype(np.int64)).to(self.device),
            torch.from_numpy(signs).to(self.device),
            bounds,
        )
        return out.cpu().numpy()

    def embed(self, texts: list[str]) -> np.ndarray:
        """Mean of each text's token embeddings [len(texts), dim] f32."""
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, text in enumerate(texts):
            tok = self.embed_token_level(text)
            if tok.shape[0]:
                out[i] = tok.mean(axis=0)
        return out


class TransformerEncoder:
    """XLM-RoBERTa-class encoder on a torch device.

    Specs, as the JAX package reads them: ``sem`` (the packaged encoder), a
    directory holding ``encoder.npz`` and ``tokenizer.json``, ``ckpt:<dir>``
    (an orbax checkpoint of the JAX package's layout, byte tokenizer), a
    HuggingFace safetensors directory or ``.safetensors`` file (XLM-R or
    BERT layout, with its ``tokenizer.json``), or a preset (``tiny``,
    ``base``, ``large``; any other name is ``tiny``) with random weights
    drawn from a seeded ``torch.Generator`` (not the JAX package's draws).
    Texts are padded to 128-token buckets and batched per bucket, as in the
    JAX package.
    """

    supports_token_embeddings = True

    _PRESETS = {
        "tiny": dict(layers=2, d_model=256, heads=4, d_ff=512, vocab=8192, max_len=512),
        "base": dict(layers=12, d_model=768, heads=12, d_ff=3072, vocab=250002, max_len=8192),
        "large": dict(layers=24, d_model=1024, heads=16, d_ff=4096, vocab=250002, max_len=8192),
    }

    def __init__(
        self,
        spec: str = "tiny",
        *,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
    ) -> None:
        from raglite_tpu_torch.models.tokenizer import ByteTokenizer, load_tokenizer
        from raglite_tpu_torch.models.transformer import EncoderModel, load_npz_encoder

        if spec == "sem":
            spec = str(PACKAGED_ENCODER_DIR)
        if spec.startswith("ckpt:"):
            from raglite_tpu_torch.models.checkpoint import load_checkpoint

            params, cfg = load_checkpoint(spec.removeprefix("ckpt:"), device=device)
            model = EncoderModel.from_params(cfg, params, dtype=dtype, device=device)
            tokenizer = ByteTokenizer(vocab_size=cfg["vocab"])
        elif os.path.isdir(spec) and os.path.exists(os.path.join(spec, "encoder.npz")):
            cfg, params, _ = load_npz_encoder(os.path.join(spec, "encoder.npz"))
            model = EncoderModel.from_params(cfg, params, dtype=dtype, device=device)
            tokenizer = load_tokenizer(os.path.join(spec, "tokenizer.json"))
        elif os.path.isdir(spec) or spec.endswith(".safetensors"):
            cfg, model, tokenizer = load_pretrained_encoder(spec, dtype=dtype, device=device)
        else:
            cfg = dict(self._PRESETS.get(spec, self._PRESETS["tiny"]))
            model = _random_encoder(cfg, dtype=dtype, seed=seed).to(device).eval()
            tokenizer = ByteTokenizer(vocab_size=cfg["vocab"])
        self._init(cfg, model, tokenizer)

    def save_checkpoint(self, path: str) -> None:
        """Write an orbax checkpoint of the JAX package's layout, loadable
        as ``flax:ckpt:<path>`` by either package."""
        from raglite_tpu_torch.models.checkpoint import save_checkpoint
        from raglite_tpu_torch.models.transformer import params_to_jax

        save_checkpoint(path, params_to_jax(self._model), self._cfg)

    @classmethod
    def from_model(cls, model, tokenizer) -> "TransformerEncoder":
        """Wrap an already built ``EncoderModel`` and tokenizer."""
        encoder = cls.__new__(cls)
        encoder._init(model.cfg, model, tokenizer)
        return encoder

    def _init(self, cfg: dict, model, tokenizer) -> None:
        self._cfg = cfg
        self._model = model
        self._tokenizer = tokenizer
        self.device = next(model.parameters()).device
        self.dim = cfg["d_model"]
        self.max_tokens = cfg["max_len"]
        # Device-resident L2-normalized token states keyed by candidate text
        # (insertion-ordered LRU): warm reranks skip the candidate encode.
        # RAGLITE_TPU_RERANK_CACHE sets the cap (0 disables), as in the JAX
        # package.
        self._rerank_cache: dict[str, tuple[torch.Tensor, int]] = {}
        self._rerank_cache_cap = int(os.environ.get("RAGLITE_TPU_RERANK_CACHE", "128"))

    def count_tokens(self, texts: list[str]) -> list[int]:
        return [len(self._tokenizer.encode(t)) for t in texts]

    def _encode_ids(self, text: str) -> np.ndarray:
        return np.asarray(self._tokenizer.encode(text)[: self.max_tokens], np.int64)

    @torch.inference_mode()
    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """[B, T] ids and mask (host) -> [B, T, d] f32 states on the device."""
        ids_t = torch.from_numpy(ids).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        return self._model(ids_t, mask_t)

    def _padded(self, encoded: list[np.ndarray], members: list[int], pad: int, bpad: int):
        ids = np.zeros((bpad, pad), np.int64)
        mask = np.zeros((bpad, pad), np.bool_)
        for row, i in enumerate(members):
            ids[row, : encoded[i].size] = encoded[i]
            mask[row, : encoded[i].size] = True
        return ids, mask

    @staticmethod
    def _buckets(encoded: list[np.ndarray], skip=lambda i: False) -> dict[int, list[int]]:
        """Text indices per padded length (a multiple of 128 tokens)."""
        buckets: dict[int, list[int]] = {}
        for i, ids in enumerate(encoded):
            if ids.size and not skip(i):
                buckets.setdefault(_round_up(max(ids.size, 8), 128), []).append(i)
        return buckets

    def embed_token_level(self, text: str) -> np.ndarray:
        ids = self._encode_ids(text)
        if ids.size == 0:
            return np.zeros((0, self.dim), dtype=np.float32)
        pad = _round_up(max(ids.size, 8), 128)
        hidden = self._forward(*self._padded([ids], [0], pad, 1))
        return hidden[0, : ids.size].cpu().numpy()

    #: Bytes of f32 attention logits ([B, heads, T, T]) one forward may
    #: make: at bge-m3's 8,192 positions one row's are 4.3 GB, so long
    #: segments go one row at a time (rows are independent: same results).
    _ATTENTION_BYTES = 2 << 30

    def _rows_per_forward(self, pad: int, cap: int) -> int:
        per_row = self._cfg["heads"] * pad * pad * 4
        return max(1, min(cap, self._ATTENTION_BYTES // per_row))

    def embed_token_level_batch(self, texts: list[str]) -> list[np.ndarray]:
        """Token-level embeddings for many texts as length-bucketed [B, T]
        forwards of up to 8 texts (fewer where T is long); returns [n_i, d]
        per text."""
        encoded = [self._encode_ids(t) for t in texts]
        out: list[np.ndarray] = [np.zeros((0, self.dim), np.float32) for _ in texts]
        for pad, members in self._buckets(encoded).items():
            rows = self._rows_per_forward(pad, 8)
            for start in range(0, len(members), rows):
                group = members[start : start + rows]
                hidden = self._forward(*self._padded(encoded, group, pad, min(_round_up(len(group), 8), rows)))
                hidden = hidden.cpu().numpy()
                for row, i in enumerate(group):
                    out[i] = hidden[row, : encoded[i].size]
        return out

    def embed(self, texts: list[str]) -> np.ndarray:
        """Mean-pooled embeddings, batched per length bucket (64 texts a
        forward, fewer where T is long)."""
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        encoded = [self._encode_ids(t) for t in texts]
        for pad, members in self._buckets(encoded).items():
            rows = self._rows_per_forward(pad, 64)
            for start in range(0, len(members), rows):
                group = members[start : start + rows]
                ids, mask = self._padded(encoded, group, pad, min(_round_up(len(group), 8), rows))
                hidden = self._forward(ids, mask)
                mask_t = torch.from_numpy(mask).to(self.device)
                denom = mask_t.sum(dim=1, keepdim=True).clamp(min=1)
                pooled = (hidden * mask_t[:, :, None]).sum(dim=1) / denom
                out[group] = pooled.cpu().numpy()[: len(group)]
        return out

    def _encode_norm(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """L2-normalized token states [B, T, d] f32, left on the device."""
        hidden = self._forward(ids, mask)
        return hidden / torch.linalg.vector_norm(hidden, dim=-1, keepdim=True).clamp(min=1e-12)

    @staticmethod
    def _score(qh, q_mask, ch, c_mask) -> torch.Tensor:
        """Masked MaxSim of query states [Tq, d] against candidate states
        [C, Tc, d] -> [C] f32, at full f32 precision (TF32 off)."""
        with full_f32_matmul():
            sims = torch.einsum("qd,ctd->cqt", qh, ch)
        sims = sims.masked_fill(~c_mask[:, None, :], float("-inf"))
        best = sims.amax(dim=-1)  # [C, Tq]
        best = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
        return (best * q_mask[0][None, :]).sum(dim=-1)

    @torch.inference_mode()
    def rerank_maxsim(self, query: str, texts: list[str]) -> np.ndarray:
        """Token-level MaxSim scores [len(texts)] computed on the device:
        encode the query and any uncached candidates, L2-normalize the token
        states, score, and fetch only the per-candidate scores, once per
        call (the structure of the JAX package's ``rerank_maxsim``)."""
        q_ids = self._encode_ids(query)
        if q_ids.size == 0 or not texts:
            return np.zeros(len(texts), np.float32)
        encoded = [self._encode_ids(t) for t in texts]
        qt = _round_up(max(q_ids.size, 8), 128)
        q_np, q_mask_np = self._padded([q_ids], [0], qt, 1)
        q_mask = torch.from_numpy(q_mask_np).to(self.device)
        qh = self._encode_norm(q_np, q_mask_np)[0]
        cache, cap = self._rerank_cache, self._rerank_cache_cap
        # Refresh hits' recency before this call's inserts, so a candidate
        # list near the cap cannot evict its own entries.
        for text in texts:
            if text in cache:
                cache[text] = cache.pop(text)
        tile = 32  # bounds the encode's [B, heads, T, T] attention
        missing = self._buckets(encoded, skip=lambda i: texts[i] in cache)
        for tc, members in missing.items():
            for start in range(0, len(members), tile):
                group = members[start : start + tile]
                states = self._encode_norm(
                    *self._padded(encoded, group, tc, _round_up(len(group), 8))
                )
                for row, i in enumerate(group):
                    cache[texts[i]] = (states[row], int(encoded[i].size))
        scores = np.zeros(len(texts), np.float32)
        by_tc: dict[int, list[int]] = {}
        for i, text in enumerate(texts):
            if text in cache:  # texts with no tokens score 0
                by_tc.setdefault(int(cache[text][0].shape[0]), []).append(i)
        pieces: list[tuple[list[int], int]] = []
        dev_scores: list[torch.Tensor] = []
        offset = 0
        for tc, members in by_tc.items():
            for start in range(0, len(members), tile):
                group = members[start : start + tile]
                bpad = _round_up(len(group), 8)
                rows = [cache[texts[i]][0] for i in group]
                rows.extend([torch.zeros_like(rows[0])] * (bpad - len(rows)))
                c_mask = torch.zeros((bpad, tc), dtype=torch.bool)
                for row, i in enumerate(group):
                    c_mask[row, : cache[texts[i]][1]] = True
                dev_scores.append(
                    self._score(qh, q_mask, torch.stack(rows), c_mask.to(self.device))
                )
                pieces.append((group, offset))
                offset += bpad
        if dev_scores:
            flat = torch.cat(dev_scores).cpu().numpy()  # the one host fetch
            for group, off in pieces:
                scores[group] = flat[off : off + len(group)]
        while len(cache) > cap:
            cache.pop(next(iter(cache)))
        return scores


def load_pretrained_encoder(path: str, *, dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cpu"):
    """``(cfg, model, tokenizer)`` of an XLM-R or BERT-family safetensors
    checkpoint (models/transformer.py:load_safetensors_encoder)."""
    from raglite_tpu_torch.models.transformer import load_safetensors_encoder

    return load_safetensors_encoder(path, dtype=dtype, device=device)


def _random_encoder(cfg: dict, *, dtype: torch.dtype, seed: int):
    """Preset encoder with seeded random weights (normal / sqrt(fan_in)
    matrices, 0.02-scaled embeddings, unit LayerNorms, zero biases)."""
    from raglite_tpu_torch.models.transformer import EncoderModel

    g = torch.Generator().manual_seed(seed)
    model = EncoderModel(cfg, dtype=dtype, final_ln=True)
    for name, param in model.named_parameters():
        if name.endswith("emb.weight"):
            param.copy_(torch.randn(param.shape, generator=g) * 0.02)
        elif param.ndim == 2:
            param.copy_(torch.randn(param.shape, generator=g) / param.shape[1] ** 0.5)
    return model


class OpenAICompatEncoder:
    """Remote embeddings over an OpenAI-compatible ``/embeddings`` endpoint
    (``openai:<base_url>#<model>``), 96 inputs a request.  The rows are
    L2-normalised on the configured device, like every encoder's output, and
    returned in f16.  A bearer token is read from
    ``RAGLITE_TPU_EMBEDDER_API_KEY`` or ``OPENAI_API_KEY`` where one is set."""

    supports_token_embeddings = False
    BATCH = 96

    def __init__(self, spec: str, *, dim: int | None = None, device: torch.device | str = "cuda") -> None:
        base, _, model = spec.partition("#")
        self.base_url = base.rstrip("/")
        self.model = model or "default"
        self.device = torch.device(device)
        self._dim = dim
        self.api_key = os.environ.get("RAGLITE_TPU_EMBEDDER_API_KEY") or os.environ.get(
            "OPENAI_API_KEY", ""
        )

    def _post(self, texts: list[str]) -> np.ndarray:
        import json
        import urllib.request

        req = urllib.request.Request(
            f"{self.base_url}/embeddings",
            data=json.dumps({"model": self.model, "input": texts}).encode(),
            headers={
                "Content-Type": "application/json",
                **({"Authorization": f"Bearer {self.api_key}"} if self.api_key else {}),
            },
        )
        with urllib.request.urlopen(req, timeout=300) as resp:  # noqa: S310
            payload = json.loads(resp.read())
        rows = sorted(payload["data"], key=lambda d: d.get("index", 0))
        return np.asarray([r["embedding"] for r in rows], dtype=np.float32)

    @property
    def dim(self) -> int:
        if self._dim is None:
            # One short request tells the endpoint's width.
            self._dim = int(self._post(["dimension probe"]).shape[1])
        return self._dim

    def count_tokens(self, texts: list[str]) -> list[int]:
        # About three characters a token.
        return [max(len(t) // 3, 1) for t in texts]

    def embed_token_level(self, text: str) -> np.ndarray:
        msg = "remote embedders expose no token-level embeddings"
        raise NotImplementedError(msg)

    def embed(self, texts: list[str]) -> np.ndarray:
        out = [self._post(texts[start : start + self.BATCH]) for start in range(0, len(texts), self.BATCH)]
        if not out:
            return np.zeros((0, self.dim), np.float16)
        rows = torch.from_numpy(np.concatenate(out, axis=0)).to(self.device)
        norms = torch.linalg.vector_norm(rows, dim=1, keepdim=True)
        return (rows / torch.clamp(norms, min=1e-12)).to(torch.float16).cpu().numpy()


@lru_cache(maxsize=4)
def _make_encoder(embedder: str, device: str) -> Encoder:
    kind, _, arg = embedder.partition(":")
    if kind == "hash":
        return HashEncoder(dim=int(arg) if arg else 1024, device=device)
    if kind == "flax":
        return TransformerEncoder(arg or "tiny", device=device)
    if kind == "openai":
        return OpenAICompatEncoder(arg, device=device)
    msg = (
        f"unknown embedder {embedder!r} (expected 'hash:<dim>', "
        "'flax:<preset|path>', or 'openai:<base_url>#<model>')"
    )
    raise ValueError(msg)


def encoder_from_config(config) -> Encoder:
    """The configured embedder on the configured (checked) device, cached."""
    return _make_encoder(config.embedder, str(config.torch_device()))


def embedding_dim(config) -> int:
    return encoder_from_config(config).dim
