"""Prompt-lookup speculative decoding (counterpart of
raglite_tpu/models/speculative.py).

RAG answers copy heavily from the retrieved contexts in the prompt, and a
B = 1 decode step reads every weight to emit one token.  Verifying K drafted
tokens in one (K + 1)-token forward costs about the same weight traffic, so
copied spans come out several tokens a forward.  Drafts come from n-gram
matches against the token history (prompt + generated): a trigram match
beats a bigram match, the most recent match wins, and a miss costs nothing
(the verify forward still commits one token).

With ``temperature == 0`` the emitted tokens equal plain greedy decode's
when the verify forward's per-position numerics equal the T = 1 forward's:
on the card the verify kernel reproduces the decode kernel bit for bit
(csrc/decode_attention.cu); the matrix products outside it are cuBLAS's and
may sum in another order for 8 rows than for 1.  With ``temperature > 0``
the speculative-sampling rule applies: draft d is accepted with probability
p̃(d) under the filtered target distribution, and on rejection the next
token is drawn from p̃ with d's mass removed (carried as ``reject``).

The JAX loop is one ``lax.while_loop`` per chunk.  Here it is a host loop
whose condition (some row still active) is read from the card once per
verify iteration: a fixed trip count would run up to ``num_tokens`` verify
forwards where a copy-heavy chunk needs a few.  The tokens come back in one
fetch per chunk, as in the JAX design.  :class:`SpeculativeLoop` runs the
iteration as one step on a state of tensors updated in place, on the card
captured once as a CUDA graph and replayed (utils/graphs.py);
:func:`speculate_chunk_device` is its eager form.
"""

from __future__ import annotations

import torch

from raglite_tpu_torch.utils import graphs
from raglite_tpu_torch.utils.graphs import StepGraph

#: Sentinel in decode output for "row was already done".
_NO_TOKEN = -1


def _filtered_probs(logits: torch.Tensor, *, temperature, top_p, top_k, min_p) -> torch.Tensor:
    """The normalized distribution the plain decode loop samples from
    (temperature, then top-k, min-p and top-p filtering)."""
    logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    if min_p and min_p > 0.0:
        pmax = probs.max(dim=-1, keepdim=True).values
        probs = torch.where(probs >= min_p * pmax, probs, 0.0)
    if top_p and top_p < 1.0:
        probs = probs / probs.sum(dim=-1, keepdim=True)
        sorted_probs = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(sorted_probs, dim=-1)
        keep = (csum - sorted_probs) < top_p
        kept_min = torch.where(keep, sorted_probs, torch.inf).min(dim=-1, keepdim=True).values
        probs = torch.where(probs >= kept_min, probs, 0.0)
    return probs / probs.sum(dim=-1, keepdim=True)


def _categorical(probs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row from ``probs`` [..., V]: the Gumbel-max form of
    ``jax.random.categorical`` over ``log(max(probs, 1e-30))``, with the
    noise from ``gen`` (other bits than JAX's)."""
    u = torch.rand(probs.shape, generator=gen, device=probs.device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(torch.log(torch.clamp(probs, min=1e-30)) + gumbel, dim=-1)


def _draw(probs: torch.Tensor, reject: torch.Tensor, gen: torch.Generator, *, greedy: bool) -> torch.Tensor:
    """Per row, sample (or argmax) from ``probs`` [B, V] with token id
    ``reject[b]`` excluded: the exact residual of speculative sampling; for
    greedy a no-op (a rejected draft was not the argmax)."""
    v = probs.shape[-1]
    probs = torch.where(torch.arange(v, device=probs.device)[None, :] == reject[:, None], 0.0, probs)
    if greedy:
        return torch.argmax(probs, dim=-1)
    return _categorical(probs, gen)


def _ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, t: torch.Tensor, draft_len: int, pad_id: int) -> torch.Tensor:
    """Draft ``draft_len`` tokens per row by longest-suffix n-gram lookup.

    hist [B, H], hist_len [B], t [B] (the token just committed, not yet in
    ``hist``).  Trigram (hist[L-2], hist[L-1], t) matches beat bigram
    (hist[L-1], t) matches; the most recent match wins; the draft is the
    history following the match, with slots past the committed history (and
    the no-match case) set to ``pad_id``.  Returns [B, draft_len]."""
    h = hist.shape[1]
    dev = hist.device
    s0 = hist.gather(1, torch.clamp(hist_len - 2, min=0)[:, None])
    s1 = hist.gather(1, torch.clamp(hist_len - 1, min=0)[:, None])
    tt = t[:, None]
    hl = hist_len[:, None]
    j = torch.arange(h - 2, device=dev)
    m2 = (hist[:, : h - 2] == s1) & (hist[:, 1 : h - 1] == tt) & (j + 2 < hl)
    j3 = torch.arange(h - 3, device=dev)
    m3 = (hist[:, : h - 3] == s0) & (hist[:, 1 : h - 2] == s1) & (hist[:, 2 : h - 1] == tt) & (j3 + 3 < hl)
    has2, has3 = m2.any(dim=1), m3.any(dim=1)
    best2 = torch.argmax(torch.where(m2, j + 1, 0), dim=1)
    best3 = torch.argmax(torch.where(m3, j3 + 1, 0), dim=1)
    start = torch.where(has3, best3 + 3, best2 + 2)
    # Slice at the clamped start (the clamp of JAX's dynamic_slice) and mask
    # with it, so validity lines up with the tokens actually returned.
    start_c = torch.clamp(start, max=h - draft_len)
    idx = start_c[:, None] + torch.arange(draft_len, device=dev)
    drafts = hist.gather(1, idx)
    valid = (has2 | has3)[:, None] & (idx < hl) & (idx >= start[:, None])
    return torch.where(valid, drafts, pad_id)


def speculate_chunk_device(  # noqa: PLR0913
    model,
    cache,
    params,
    cache_lens: torch.Tensor,  # [B] committed tokens whose KV is valid
    last_logits: torch.Tensor,  # [B, V] f32: logits the next token is sampled from
    reject: torch.Tensor,  # [B] draft rejected at this position (-1: none)
    logits_mask: torch.Tensor,  # [V] f32 additive mask
    done: torch.Tensor,  # [B] bool
    stop_ids: torch.Tensor,  # [Ks] (padded with -7)
    gen: torch.Generator,
    hist: torch.Tensor,  # [B, H] committed token history
    hist_len: torch.Tensor,  # [B]
    *,
    num_tokens: int,
    draft_len: int,
    pad_id: int,
    temperature: float,
    top_p: float,
    top_k: int,
    min_p: float,
):
    """Emit up to ``num_tokens`` tokens PER ROW by prompt-lookup speculation.
    A row whose chunk budget, or whose KV capacity, can no longer fit a full
    window freezes (its sampling state carries into the next chunk) while
    the others keep verifying.  Returns (out [B, num_tokens]: committed
    tokens then ``_NO_TOKEN``, cache, cache_lens, last_logits, reject, done,
    hist, hist_len, n_verify_iters).  The eager form of
    :class:`SpeculativeLoop`, which generation runs."""
    k = draft_len
    greedy = temperature == 0.0
    cap = num_tokens
    b = last_logits.shape[0]
    dev = last_logits.device
    rows = torch.arange(b, device=dev)
    # KV capacity == history capacity (both max_total): a row whose next
    # window could run past the cache freezes, so the window's writes never
    # clamp onto valid recent entries.
    kv_cap = hist.shape[1]

    def probs_of(logits: torch.Tensor) -> torch.Tensor:
        masked = logits + logits_mask
        if greedy:  # a one-hot argmax distribution keeps a single code path
            return torch.nn.functional.one_hot(torch.argmax(masked, dim=-1), masked.shape[-1]).to(torch.float32)
        return _filtered_probs(masked, temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p)

    out = torch.full((b, cap + 1), _NO_TOKEN, dtype=torch.int64, device=dev)
    out_len = torch.zeros((b,), dtype=torch.int64, device=dev)
    logits, hl = last_logits, hist_len
    it = 0
    while it < cap:
        active = ~done & (out_len + k + 1 <= cap) & (cache_lens + k + 1 <= kv_cap)
        if not bool(active.any()):  # the one host read per iteration
            break
        # 1. Commit one token per row (with the residual exclusion).
        t = _draw(probs_of(logits), reject, gen, greedy=greedy)
        # 2. Draft K continuation tokens per row from its history.
        drafts = _ngram_draft(hist, hl, t, k, pad_id)
        window = torch.cat([t[:, None], drafts], dim=1)  # [B, K+1]
        # 3. Verify: one forward over every row's window at its offset.
        #    Frozen/done rows flow through too; their KV writes land at their
        #    unadvanced offsets and are overwritten when they resume.
        wlogits, cache = model.forward(params, torch.where(active[:, None], window, 0), cache, cache_lens)
        probs = probs_of(wlogits)  # [B, K+1, V]
        # 4. Longest accepted prefix per row.
        p_draft = probs[:, :k, :].gather(2, drafts[:, :, None])[..., 0]
        if greedy:
            acc = p_draft > 0.5  # one-hot: draft == argmax
        else:
            acc = torch.rand((b, k), generator=gen, device=dev) < p_draft
        acc_cum = torch.cumprod(acc.to(torch.int64), dim=1).to(torch.bool)
        a = acc_cum.sum(dim=1)  # [B] accepted drafts
        # 5. Emission: t plus accepted drafts, cut at the first stop.
        ok = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev), acc_cum], dim=1)
        is_stop = (window[:, :, None] == stop_ids[None, None, :]).any(dim=2) & ok
        stopped = torch.cumsum(is_stop.to(torch.int64), dim=1) > 0  # inclusive
        emit = ok & ~stopped & active[:, None]
        done_next = done | (is_stop.any(dim=1) & active)
        n_emit = emit.sum(dim=1)
        slot = torch.cumsum(emit.to(torch.int64), dim=1) - 1
        # Non-emitted window tokens go to the scratch slot `cap`.
        pos = torch.where(emit, out_len[:, None] + slot, cap)
        out.scatter_(1, pos, torch.where(emit, window, _NO_TOKEN))
        hist_pos = torch.where(emit, hl[:, None] + slot, hist.shape[1] - 1)
        hist = hist.scatter(1, hist_pos, torch.where(emit, window, hist[:, -1:]))
        # 6. Carry: KV is valid for t and the accepted drafts; the next
        #    iteration samples after the last committed token (window row a),
        #    excluding the rejected draft's mass.
        advance = torch.where(done_next | ~active, 0, 1 + a)
        cache_lens = cache_lens + advance
        logits = torch.where(active[:, None], wlogits[rows, a, :], logits)
        reject = torch.where(
            active,
            torch.where(a < k, drafts[rows, torch.clamp(a, max=k - 1)], -1),
            reject,
        )
        out_len = out_len + n_emit
        done = done_next
        hl = hl + n_emit
        it += 1
    return out[:, :cap], cache, cache_lens, logits, reject, done, hist, hl, it


class SpeculativeLoop:
    """:func:`speculate_chunk_device` as one verify iteration (draw, draft,
    the T = draft_len + 1 forward, acceptance, carry) on a state of tensors
    updated in place: ``lens``, ``logits``, ``reject``, ``done``, ``hist``,
    ``hl`` (copies of the arguments, carried from chunk to chunk) and the
    chunk's ``out``, ``out_len`` and ``active``.  The iteration ends by
    computing the next one's ``active``, so the host's one read per
    iteration is ``active.any()``.  It runs through a :class:`StepGraph`:
    on the card captured once and replayed, on the CPU eagerly."""

    def __init__(  # noqa: PLR0913
        self, model, cache, params, cache_lens: torch.Tensor, last_logits: torch.Tensor, reject: torch.Tensor,
        logits_mask: torch.Tensor, done: torch.Tensor, stop_ids: torch.Tensor, gen: torch.Generator,
        hist: torch.Tensor, hist_len: torch.Tensor, *,
        num_tokens: int, draft_len: int, pad_id: int, temperature: float, top_p: float, top_k: int, min_p: float,
    ) -> None:
        self.model, self.cache, self.params = model, cache, params
        self.logits_mask, self.stop_ids, self.gen = logits_mask, stop_ids, gen
        self.k, self.cap, self.pad_id = draft_len, num_tokens, pad_id
        self.greedy = temperature == 0.0
        self.sampling = dict(temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p)
        b, dev = last_logits.shape[0], last_logits.device
        self.lens, self.logits, self.reject = cache_lens.clone(), last_logits.clone(), reject.clone()
        self.done, self.hist, self.hl = done.clone(), hist.clone(), hist_len.clone()
        self.out = torch.full((b, num_tokens + 1), _NO_TOKEN, dtype=torch.int64, device=dev)
        self.out_len = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.rows = torch.arange(b, device=dev)
        self.graph = StepGraph(
            self.step, capture=graphs.captures(model, dev), generator=None if self.greedy else gen,
        )

    def _probs(self, logits: torch.Tensor) -> torch.Tensor:
        masked = logits + self.logits_mask
        if self.greedy:
            # The argmax's one-hot distribution (by a comparison: F.one_hot
            # reads its input's range on the host for a CPU tensor).
            ids = torch.arange(masked.shape[-1], device=masked.device)
            return (ids == torch.argmax(masked, dim=-1, keepdim=True)).to(torch.float32)
        return _filtered_probs(masked, **self.sampling)

    def _set_active(self) -> None:
        """Rows that verify next: not done, with room for a whole window in
        the chunk and in the KV cache (KV capacity == history capacity)."""
        window = self.k + 1
        self.active.copy_(
            ~self.done & (self.out_len + window <= self.cap) & (self.lens + window <= self.hist.shape[1])
        )

    def step(self) -> None:
        k, cap, active = self.k, self.cap, self.active
        b = active.shape[0]
        # 1. Commit one token per row (with the residual exclusion).
        t = _draw(self._probs(self.logits), self.reject, self.gen, greedy=self.greedy)
        # 2. Draft K continuation tokens per row from its history.
        drafts = _ngram_draft(self.hist, self.hl, t, k, self.pad_id)
        window = torch.cat([t[:, None], drafts], dim=1)  # [B, K+1]
        # 3. Verify: one forward over every row's window at its offset
        #    (frozen and done rows too, at their unadvanced offsets).
        wlogits, _ = self.model.forward(self.params, torch.where(active[:, None], window, 0), self.cache, self.lens)
        probs = self._probs(wlogits)  # [B, K+1, V]
        # 4. Longest accepted prefix per row.
        p_draft = probs[:, :k, :].gather(2, drafts[:, :, None])[..., 0]
        if self.greedy:
            acc = p_draft > 0.5  # one-hot: draft == argmax
        else:
            acc = torch.rand((b, k), generator=self.gen, device=active.device) < p_draft
        acc_cum = torch.cumprod(acc.to(torch.int64), dim=1).to(torch.bool)
        a = acc_cum.sum(dim=1)  # [B] accepted drafts
        # 5. Emission: t plus accepted drafts, cut at the first stop.
        ok = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=active.device), acc_cum], dim=1)
        is_stop = (window[:, :, None] == self.stop_ids[None, None, :]).any(dim=2) & ok
        stopped = torch.cumsum(is_stop.to(torch.int64), dim=1) > 0  # inclusive
        emit = ok & ~stopped & active[:, None]
        done_next = self.done | (is_stop.any(dim=1) & active)
        n_emit = emit.sum(dim=1)
        slot = torch.cumsum(emit.to(torch.int64), dim=1) - 1
        # Non-emitted window tokens go to the scratch slot `cap`.
        self.out.scatter_(1, torch.where(emit, self.out_len[:, None] + slot, cap), torch.where(emit, window, _NO_TOKEN))
        hist_pos = torch.where(emit, self.hl[:, None] + slot, self.hist.shape[1] - 1)
        self.hist.scatter_(1, hist_pos, torch.where(emit, window, self.hist[:, -1:]))
        # 6. Carry: KV is valid for t and the accepted drafts; the next
        #    iteration samples after the last committed token (window row a),
        #    excluding the rejected draft's mass.
        self.lens += torch.where(done_next | ~active, 0, 1 + a)
        self.logits.copy_(torch.where(active[:, None], wlogits[self.rows, a, :], self.logits))
        rejected = torch.where(a < k, drafts[self.rows, torch.clamp(a, max=k - 1)], -1)
        self.reject.copy_(torch.where(active, rejected, self.reject))
        self.out_len += n_emit
        self.hl += n_emit
        self.done.copy_(done_next)
        self._set_active()

    def chunk(self) -> tuple[torch.Tensor, int]:
        """Up to ``num_tokens`` tokens per row; returns (out [B, num_tokens]:
        committed tokens then ``_NO_TOKEN``, verify iterations run)."""
        self.out.fill_(_NO_TOKEN)
        self.out_len.zero_()
        self._set_active()
        iters = 0
        while iters < self.cap and bool(self.active.any()):  # the one host read per iteration
            self.graph()
            iters += 1
        return self.out[:, : self.cap], iters
