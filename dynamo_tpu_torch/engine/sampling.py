"""Sampling: greedy / temperature / top-k / top-p / min-p, batched on the
device (port of ``dynamo_tpu/engine/sampling.py``).

Randomness enters as a uniform noise tensor ``[B, V]`` and tokens are drawn
by the Gumbel-max rule, which samples exactly the categorical distribution
of the (filtered, tempered) logits. The runner draws the noise from its
engine ``torch.Generator`` for unseeded slots, and from a generator keyed by
(request seed, fed position) for seeded ones (:func:`seeded_uniform`), so a
seeded stream ignores batch placement as in the reference. JAX's threefry
bits and torch's Philox bits differ, so seeded streams match the reference
in distribution, not token for token.

Which branches run is decided on the host from the requests' parameters
(``need_filter``, and noise only when some slot samples), so nothing here
reads device values back. Penalties (:func:`apply_penalties`), the
``min_tokens`` EOS ban (:func:`ban_eos`), logprobs
(:func:`sample_tokens_with_logprobs`) and the speculative acceptance rule
(:func:`accept_speculative`: greedy argmax prefix, rejection sampling
against a one-hot or a real draft distribution) are the reference's. A
seeded stream is keyed by a stream constant besides (seed, position), so
the acceptance draws (``SPEC_STREAM``) and the draft model's
(``spec/draft.py DRAFT_STREAM``) differ from the window sampler's, as the
reference's keys do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

_NEG_INF = -1e30

MAX_EOS_IDS = 8  # per-slot EOS ids carried on device for min_tokens masking
#: seeded stream of speculative acceptance (the reference's key base 0x5EC5);
#: 0 is the window sampler's
SPEC_STREAM = 0x5EC5
LOGPROBS_K = 20  # top alternatives computed on device (= the OpenAI API max)


def fold_seed(seed) -> int:
    """Any user seed (64-bit, negative, ...) -> nonzero int31 device seed;
    only ``None`` maps to 0 (= unseeded). ``seed=0`` is a real seed."""
    if seed is None:
        return 0
    return (int(seed) % 0x7FFFFFFE) + 1


@dataclass
class SamplingParams:
    """Per-request sampling options (the reference's fields; the scheduler
    rejects none of them)."""

    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled
    min_p: float = 0.0  # 0 => disabled; keep tokens with p >= min_p * p_max
    max_tokens: int = 512
    min_tokens: int = 0  # EOS suppressed until this many tokens generated
    stop: Sequence[str] = ()
    seed: Optional[int] = None  # per-request deterministic sampling stream
    ignore_eos: bool = False
    # vLLM-semantics penalties: presence/frequency over OUTPUT tokens,
    # repetition over prompt + output
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0

    @property
    def needs_penalties(self) -> bool:
        return (
            self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0
            or self.repetition_penalty != 1.0
        )

    @property
    def needs_filter(self) -> bool:
        return self.top_k > 0 or self.top_p < 1.0 or self.min_p > 0.0


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    counts: torch.Tensor,  # [B, V] int32 output-token counts
    seen: torch.Tensor,  # [B, V] bool, token in prompt or output
    presence: torch.Tensor,  # [B]
    frequency: torch.Tensor,  # [B]
    repetition: torch.Tensor,  # [B] (1.0 = off)
) -> torch.Tensor:
    """vLLM-semantics sampling penalties, in vLLM's order: repetition divides
    positive / multiplies negative RAW logits of any seen token FIRST, then
    frequency and presence subtract over output-token occurrences. Neutral
    values (0, 0, 1) leave a row's logits bit for bit."""
    rep = repetition[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, penalized, logits)
    cf = counts.float()
    logits = logits - frequency[:, None] * cf
    return logits - presence[:, None] * (cf > 0).float()


def ban_eos(logits: torch.Tensor, eos_ids: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
    """``logits`` [B, V] with ``penalty`` [B] (-1e30 bans, 0 allows) added at
    each row's ``eos_ids`` [B, MAX_EOS_IDS], whose unused entries hold V.
    The reference drops those with an out-of-range scatter; an out-of-range
    index is a device fault here, so they are clamped into range and add 0."""
    V = logits.shape[-1]
    used = eos_ids < V
    add = torch.where(used, penalty[:, None].expand_as(eos_ids), torch.zeros((), device=logits.device))
    return logits.scatter_add(1, eos_ids.clamp(max=V - 1).long(), add.to(logits.dtype))


def gumbel(uniform: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in (0, 1): argmax(logits + gumbel) draws
    from softmax(logits)."""
    return -torch.log(-torch.log(uniform.clamp(1e-20, 1.0 - 1e-7)))


def filter_keep_mask(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int (0 = off)
    top_p: torch.Tensor,  # [B] (1.0 = off)
    min_p: torch.Tensor | None = None,  # [B] (0 = off)
) -> torch.Tensor:
    """[B, V] bool mask of tokens surviving top-k/top-p/min-p."""
    V = logits.shape[-1]
    temp = torch.where(temperature > 0, temperature, torch.ones_like(temperature))[:, None]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values

    # top-k: keep entries with logit >= k-th largest value
    k = torch.where(top_k > 0, top_k.clamp(1, V), torch.full_like(top_k, V)).long()
    kth_value = sorted_logits.gather(-1, (k - 1)[:, None])
    keep_k = logits >= kth_value

    # top-p: keep the sorted prefix whose cumulative probability is < p
    # (always keeping the first)
    sorted_probs = torch.softmax(sorted_logits / temp, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    sorted_keep = (cum - sorted_probs) < top_p[:, None]
    num_keep = sorted_keep.sum(dim=-1).clamp(min=1)
    p_value = sorted_logits.gather(-1, (num_keep - 1)[:, None])
    keep_p = logits >= p_value

    keep = keep_k & keep_p
    if min_p is not None:
        # keep tokens whose (tempered) prob >= min_p * max prob
        max_l = logits.max(dim=-1, keepdim=True).values
        thresh = max_l / temp + torch.log(min_p.clamp(min=1e-10))[:, None]
        keep_m = (logits / temp) >= thresh
        keep = keep & torch.where(min_p[:, None] > 0, keep_m, torch.ones_like(keep_m))
    return keep


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int (0 = off)
    top_p: torch.Tensor,  # [B] (1.0 = off)
    min_p: torch.Tensor | None = None,  # [B] (0 = off)
    uniform: torch.Tensor | None = None,  # [B, V] noise in (0, 1); None = all greedy
    need_filter: bool = True,
) -> torch.Tensor:
    """One token per slot (int32). Greedy where temperature <= 0; pass
    ``uniform`` only when some slot samples, and ``need_filter`` only when
    some slot sets top-k/top-p/min-p (with none, the keep-mask is all-true)."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if uniform is None:
        return greedy
    temp = torch.where(temperature > 0, temperature, torch.ones_like(temperature))[:, None]
    masked = logits
    if need_filter:
        keep = filter_keep_mask(logits, temperature, top_k, top_p, min_p=min_p)
        masked = torch.where(keep, logits, torch.full_like(logits, _NEG_INF))
    sampled = (masked / temp + gumbel(uniform)).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def sample_tokens_with_logprobs(
    logits: torch.Tensor,  # [B, V] float32, possibly penalized / EOS-banned
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    raw_logits: torch.Tensor | None = None,  # the model's logits before penalties and bans
    **kwargs,  # min_p / uniform / need_filter, forwarded to sample_tokens
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """sample_tokens + OpenAI-style logprobs of the model distribution.

    Returns (tokens [B], chosen_logprob [B], topk_ids [B, K], topk_logprobs
    [B, K]), K = LOGPROBS_K. Logprobs are the log-softmax of the RAW model
    logits (``raw_logits`` when sampling from penalized / masked ones): the
    model's distribution, as the OpenAI API means it."""
    tokens = sample_tokens(logits, temperature, top_k, top_p, **kwargs)
    logprobs = torch.log_softmax(logits if raw_logits is None else raw_logits, dim=-1)
    chosen = logprobs.gather(-1, tokens[:, None].long())[:, 0]
    top_vals, top_ids = torch.topk(logprobs, min(LOGPROBS_K, logprobs.shape[-1]), dim=-1)
    return tokens, chosen, top_ids.to(torch.int32), top_vals


def seeded_uniform(seed: int, position: int, vocab_size: int, device, stream: int = 0) -> torch.Tensor:
    """[vocab_size] noise of a seeded request at one fed position: a
    generator keyed by (folded seed, position, ``stream``), so the stream
    is the same whatever slot or batch the request lands in. ``stream`` 0
    is the window sampler's; another constant gives an independent
    stream."""
    gen = torch.Generator(device=device)
    key = (int(seed) << 32) | (int(position) & 0xFFFFFFFF)
    if stream:
        key ^= (int(stream) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    gen.manual_seed(key)
    return torch.rand(vocab_size, generator=gen, device=device)


def accept_speculative(
    logits: torch.Tensor,  # [B, K+1, V] float32; row i predicts position p+i+1
    drafts: torch.Tensor,  # [B, K] int proposed tokens (pad entries arbitrary)
    n_drafts: torch.Tensor,  # [B] int real drafts a slot (<= K)
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int (0 = off)
    top_p: torch.Tensor,  # [B] (1.0 = off)
    min_p: torch.Tensor | None = None,  # [B] (0 = off)
    draft_probs: torch.Tensor | None = None,  # [B, K, V] real draft distributions q
    uniform: torch.Tensor | None = None,  # [B, K + V] noise in (0, 1); None = all greedy
    need_filter: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative acceptance over one verify pass: (tokens [B, K+1] int32,
    n_emit [B] int32); a slot emits ``tokens[:n_emit]``.

    A slot's verify pass fed [t_p, d_1..d_K] at positions p..p+K, so
    ``logits[:, i]`` is the target distribution of the token at p+i+1 given
    a correct prefix through d_i. Greedy slots (temperature <= 0) accept
    the leading drafts equal to the raw argmax and emit the argmax rows
    (token-identical to the non-speculative engine). Sampling slots take
    the exact rejection rule (Leviathan et al. / Chen et al.): without
    ``draft_probs`` (one-hot q, the n-gram case) d_i is accepted with
    probability p(d_i), and a rejection resamples from p with d_i removed;
    with ``draft_probs`` d_i is accepted with probability min(1, p/q) and a
    rejection resamples from max(0, p - q) renormalized; all accepted, the
    bonus token samples from the last row. p is the filtered distribution
    (``filter_keep_mask`` over all B * (K+1) rows, skipped when
    ``need_filter`` is False: no slot filters). ``uniform[:, :K]`` are the
    acceptance draws, ``uniform[:, K:]`` the final token's Gumbel noise;
    the caller draws them (seeded slots from a (seed, anchor position,
    ``SPEC_STREAM``) stream), so nothing here reads the device from the
    host."""
    B, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    greedy = logits.argmax(dim=-1).to(torch.int32)  # [B, K1] raw argmax
    drafts = drafts.to(torch.int32)
    draft_valid = torch.arange(K, device=dev)[None, :] < n_drafts[:, None]
    g_match = (greedy[:, :K] == drafts) & draft_valid
    g_acc = torch.cumprod(g_match.to(torch.int32), dim=1).sum(dim=1)
    if uniform is None:
        return greedy, (g_acc + 1).to(torch.int32)

    flat = logits.reshape(B * K1, V)
    temps_r = temperature.repeat_interleave(K1)
    temp_r = torch.where(temps_r > 0, temps_r, torch.ones_like(temps_r))[:, None]
    masked = flat
    if need_filter:
        keep = filter_keep_mask(flat, temps_r, top_k.repeat_interleave(K1), top_p.repeat_interleave(K1),
                                min_p=None if min_p is None else min_p.repeat_interleave(K1))
        masked = torch.where(keep, flat, torch.full_like(flat, _NEG_INF))
    probs = torch.softmax(masked / temp_r, dim=-1).reshape(B, K1, V)
    masked = masked.reshape(B, K1, V)
    d_idx = drafts.long()[..., None]
    p_draft = probs[:, :K].gather(-1, d_idx)[..., 0]  # [B, K]
    u = uniform[:, :K]
    if draft_probs is None:
        s_match = (u < p_draft) & draft_valid
    else:
        # q > 0 wherever the draft sampled; the floor only guards pad rows
        q_draft = draft_probs.gather(-1, d_idx)[..., 0]
        s_match = (u * q_draft.clamp(min=1e-20) < p_draft) & draft_valid
    s_acc = torch.cumprod(s_match.to(torch.int32), dim=1).sum(dim=1)
    a = torch.where(temperature > 0, s_acc, g_acc)  # [B] accepted drafts

    b_idx = torch.arange(B, device=dev)
    rows = a.long()
    rej_row = rows.clamp(0, max(K - 1, 0))
    rejected = a < n_drafts
    noise = gumbel(uniform[:, K:])
    temp = torch.where(temperature > 0, temperature, torch.ones_like(temperature))[:, None]
    if draft_probs is None:
        # row a's filtered logits; on a rejection the rejected draft is
        # removed (the residual max(0, p - q) for a one-hot q)
        row = masked[b_idx, rows]
        d_rej = drafts.gather(1, rej_row[:, None]).long()
        ban = torch.where(rejected, torch.full_like(temperature, _NEG_INF), torch.zeros_like(temperature))
        row = row.scatter_add(1, d_rej, ban[:, None])
        final = (row / temp + noise).argmax(dim=-1)
    else:
        # in probability space (temperature is in p already): a rejection
        # takes the residual, all accepted the bonus row's p; an empty
        # residual (float cancellation where p == q) falls back to p
        p_rows = probs[b_idx, rows]
        res = (p_rows - draft_probs[b_idx, rej_row]).clamp(min=0.0)
        use_res = rejected[:, None] & (res.sum(dim=-1, keepdim=True) > 0)
        dist = torch.where(use_res, res, p_rows)
        log_d = torch.where(dist > 0, torch.log(dist.clamp(min=1e-38)), torch.full_like(dist, _NEG_INF))
        final = (log_d + noise).argmax(dim=-1)
    drafts_pad = torch.cat([drafts, torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
    take_draft = torch.arange(K1, device=dev)[None, :] < a[:, None]
    out_sampled = torch.where(take_draft, drafts_pad, final.to(torch.int32)[:, None])
    out = torch.where(temperature[:, None] > 0, out_sampled, greedy)
    return out, (a + 1).to(torch.int32)
