"""Draft-model speculative decoding: the device side (port of
``dynamo_tpu/spec/draft.py``).

``--speculative draft:<model>:<k>`` loads a second, smaller model through the
port's registry (with the engine's ``quantize`` / ``kv_cache_dtype``, so the
draft composes with int8 weights and the int8 KV cache) and drafts k tokens
a spec round for EVERY spec-mode lane in one batched step: no per-sequence
Python in the round's hot path.

The draft keeps its own paged KV:

  - a separate page pool (the target's page_size / num_pages geometry, page
    0 the trash page) with a minimal per-sequence free-list allocator; no
    prefix cache: draft KV is cheap to recompute and its only reader is the
    next draft round;
  - per-sequence draft page tables on the target's width ladder
    (``config.table_bucket_for``);
  - rejected draft rows are overwritten by the next round's feeds at the
    advanced anchor, the target verify pass's KV discipline.

A round's draft step does both phases on the device:

  1. catch-up: feed the tokens the target emitted since the draft's last fed
     position (the one correction / bonus token in steady state) through
     the draft model's multi-query ``verify`` pass (K2 / K5), landing on the
     logits of the next position;
  2. drafting: k single-token ``decode`` steps (K1 / K5), each sampling a
     draft token from the draft's FILTERED distribution (the request's
     temperature / top-k / top-p / min-p: the q the acceptance rule needs)
     and feeding it back. The q rows are written into the runner's
     ``draft_q`` [B, K, V], which the verify step reads on the device.

On the card the step is the runner's captured graph (one per table width,
sampled and filtered, ``ModelRunner._step``), and so is each draft prefill
chunk (one per bucket and width). Draft prefill chunks are sized by the
depth-aware planner (``EngineConfig.chunk_len_for``), as the reference's.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from dynamo_tpu_torch.engine.sampling import _NEG_INF, filter_keep_mask, gumbel

#: seeded stream of draft-token sampling (the reference's key base 0xD4AF).
#: It differs from the acceptance stream (sampling.SPEC_STREAM) and the
#: window sampler's (0): rejection sampling is exact only when the
#: accept / reject draws are independent of the draws that made the drafts
DRAFT_STREAM = 0xD4AF


class DraftModelRunner:
    """Owns the draft model, its paged KV pool and page bookkeeping, and the
    prefill / draft-step bodies. Built by ModelRunner when
    ``config.spec.kind == "draft"``; every method runs on the engine
    thread."""

    def __init__(self, config, spec, runner):
        from dynamo_tpu_torch.models.registry import load_model

        self.config = config
        self.spec = spec
        # a proxy: the runner owns this object, and a strong reference back
        # would keep both models on the card until the cyclic GC ran
        self.runner = weakref.proxy(runner)
        self.model = load_model(spec.model, device=runner.device, quantize=config.quantize,
                                kv_cache_dtype=config.kv_cache_dtype)
        V, Vd = runner.model.config.vocab_size, self.model.config.vocab_size
        if Vd != V:
            raise ValueError(f"draft model {spec.model!r} has vocab_size {Vd}, the target {V}: "
                             "drafts must share the target's vocabulary")
        self.kv = self.model.init_kv_cache(config.num_pages, config.page_size)
        # minimal page allocator: page 0 is the trash page, everything else
        # free-listed per sequence (no sharing, no prefix cache)
        self._free: list[int] = list(range(config.num_pages - 1, 0, -1))
        self._pages: dict[str, list[int]] = {}

    # ---------------- page bookkeeping ----------------

    def ensure_capacity(self, seq_id: str, length: int) -> bool:
        """Pages to hold ``length`` draft-timeline tokens. False when the
        pool is out of pages (nothing partially taken: the caller drops the
        sequence's draft state and the round degrades to verify-only)."""
        pages = self._pages.setdefault(seq_id, [])
        need = -(-length // self.config.page_size) - len(pages)
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        for _ in range(need):
            pages.append(self._free.pop())
        return True

    def free_sequence(self, seq_id: str) -> None:
        pages = self._pages.pop(seq_id, None)
        if pages:
            self._free.extend(pages)

    def table_for(self, seq_id: str) -> np.ndarray:
        """Page table at the sequence's current width-ladder rung."""
        pages = self._pages.get(seq_id, [])
        table = np.zeros(self.config.table_bucket_for(max(1, len(pages))), np.int32)
        table[: len(pages)] = pages
        return table

    # ---------------- step bodies (device work only) ----------------

    def _prefill_impl(self, ints, flts, noise, bucket: int, mp: int):
        """One draft prefill chunk: ``ints`` [bucket + mp + 2] = token buf,
        page table, (start_pos, n_real). KV-write only (the first draft
        round's catch-up re-feeds the last prompt token and samples from
        there); returns the last row's logits, which nothing reads."""
        tokens = ints[:bucket]
        table = ints[bucket : bucket + mp].contiguous()
        start, n = ints[bucket + mp], ints[bucket + mp + 1]
        ar = torch.arange(bucket, dtype=torch.int32, device=ints.device)
        logits, _ = self.model.prefill(self.kv, tokens, (start + ar).contiguous(), table, ar < n, (n - 1).clamp(min=0))
        return (logits,)

    def _draft_impl(self, ints, flts, noise, need_filter: bool):
        """Catch-up feed + k-step autoregressive drafting for all lanes.
        ``ints`` [4 + (K+1) + W, B] = positions (first catch-up fed
        position), active, n_feed, top_ks, the K+1 catch-up token rows, then
        the transposed draft page tables; ``flts`` [3, B] = temps, top_ps,
        min_ps; ``noise`` [K, B, V] (None: no lane samples, and no q is
        computed: greedy acceptance never reads it). Returns (draft tokens
        [B, K], the last step's logits); q[:, j], the filtered distribution
        token j+1 was sampled from, goes to ``runner.draft_q``."""
        K = self.spec.k
        K1 = K + 1
        positions = ints[0]
        active = ints[1].bool()
        n_feed = ints[2]
        top_ks = ints[3]
        fed = ints[4 : 4 + K1].t().contiguous()
        page_tables = ints[4 + K1 :].t().contiguous()
        temps, top_ps, min_ps = flts[0], flts[1], flts[2]
        B = positions.shape[0]
        dev = ints.device

        # phase 1: multi-query catch-up (rows past n_feed land on the trash
        # page); the logits at row n_feed - 1 predict the first draft token
        t_idx = torch.arange(K1, dtype=torch.int32, device=dev)
        pos_mat = (positions[:, None] + t_idx[None, :]).contiguous()
        row_valid = active[:, None] & (t_idx[None, :] < n_feed[:, None])
        logits_all, _ = self.model.verify(self.kv, fed, pos_mat, page_tables, row_valid)
        logits = logits_all[torch.arange(B, device=dev), (n_feed - 1).clamp(min=0).long()]

        # phase 2: k decode steps, each feeding the token it drew (its KV row
        # is right for as long as the token survives acceptance)
        temp = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
        pos = (positions + n_feed).contiguous()
        toks = torch.empty((B, K), dtype=torch.int32, device=dev)
        q_out = self.runner.draft_q
        for j in range(K):
            tok = logits.argmax(dim=-1).to(torch.int32)
            if noise is not None:
                masked = logits
                if need_filter:
                    keep = filter_keep_mask(logits, temps, top_ks, top_ps, min_p=min_ps)
                    masked = torch.where(keep, logits, torch.full_like(logits, _NEG_INF))
                q_out[:, j] = torch.softmax(masked / temp, dim=-1)
                sampled = (masked / temp + gumbel(noise[j])).argmax(dim=-1).to(torch.int32)
                tok = torch.where(temps > 0, sampled, tok)
            toks[:, j] = tok
            logits, _ = self.model.decode(self.kv, tok, pos, page_tables, active)
            pos = pos + 1
        return toks, logits

    # ---------------- host API (engine thread) ----------------

    def prefill_sequence(self, seq_id: str, tokens: list[int]) -> bool:
        """Chunked draft prefill of a sequence's full history (no prefix
        cache: the draft always recomputes). Returns False when the draft
        pool cannot hold the history and one round's drafts; nothing is
        left allocated then."""
        self.free_sequence(seq_id)  # always a fresh build: no stale pages
        n = len(tokens)
        if not self.ensure_capacity(seq_id, n + self.spec.k + 1):
            self.free_sequence(seq_id)
            return False
        table = self.table_for(seq_id)
        start = 0
        while start < n:
            end = min(start + self.config.chunk_len_for(start), n)
            self._prefill_chunk(np.asarray(tokens[start:end], np.int32), start, table)
            start = end
        return True

    def _prefill_chunk(self, tokens: np.ndarray, start: int, table: np.ndarray) -> None:
        bucket, mp = self.config.bucket_for(max(1, len(tokens))), len(table)
        ints = np.zeros(bucket + mp + 2, np.int32)
        ints[: len(tokens)] = tokens
        ints[bucket : bucket + mp] = table
        ints[bucket + mp] = start
        ints[bucket + mp + 1] = len(tokens)
        body = functools.partial(self._prefill_impl, bucket=bucket, mp=mp)
        self.runner._step("draft_prefill", ("draft_prefill", bucket, mp), body, ints, np.zeros(1, np.float32), None)

    @torch.no_grad()
    def dispatch_draft(
        self,
        positions: np.ndarray,  # [B] first catch-up fed position per lane
        page_tables: np.ndarray,  # [B, W] draft page tables at the round's rung
        active: np.ndarray,  # [B] bool
        fed_tokens: np.ndarray,  # [B, K+1] catch-up tokens (zero-padded tail)
        n_feed: np.ndarray,  # [B] real catch-up token count (>= 1 when active)
        temps: np.ndarray,
        top_ks: np.ndarray,
        top_ps: np.ndarray,
        min_ps: np.ndarray | None = None,
        seeds: np.ndarray | None = None,
    ):
        """One batched draft round over every lane. Returns (draft tokens
        [B, K] on their way to the host, draft probs [B, K, V] on the
        device). The caller reads the tokens (it builds the verify feed) and
        passes the prob rows STRAIGHT to dispatch_verify."""
        from dynamo_tpu_torch.engine.model_runner import HostResult

        B = positions.shape[0]
        min_ps = np.zeros(B, np.float32) if min_ps is None else min_ps
        live = active & (temps > 0)
        noise_args = None
        if live.any():
            seeded = seeds if seeds is not None and np.any(seeds[live]) else None
            if seeded is not None:
                seeded = np.where(live, seeded, 0)
            noise_args = (B, seeded, positions, self.spec.k, self.model.config.vocab_size, DRAFT_STREAM)
        need_filter = bool(np.any(live & ((top_ks > 0) | (top_ps < 1.0) | (min_ps > 0))))
        toks = self._dispatch(positions, page_tables, active, fed_tokens, n_feed, temps, top_ks, top_ps, min_ps,
                              noise_args, need_filter)
        return HostResult(toks), self.runner.draft_q

    def _dispatch(self, positions, page_tables, active, fed_tokens, n_feed, temps, top_ks, top_ps, min_ps,
                  noise_args, need_filter: bool) -> torch.Tensor:
        B = positions.shape[0]
        K1 = self.spec.k + 1
        ints = np.empty((4 + K1 + page_tables.shape[1], B), np.int32)
        ints[0] = positions
        ints[1] = active
        ints[2] = np.maximum(n_feed, 1)
        ints[3] = top_ks
        ints[4 : 4 + K1] = fed_tokens.T
        ints[4 + K1 :] = page_tables.T
        flts = np.stack([temps, top_ps, min_ps]).astype(np.float32)
        key = ("draft_step", B, page_tables.shape[1], noise_args is not None, need_filter)
        body = functools.partial(self._draft_impl, need_filter=need_filter)
        toks, _ = self.runner._step("draft_step", key, body, ints, flts, noise_args)
        return toks

    # ---------------- warmup (captures ahead of serving) ----------------

    def warmup_step(self, width: int, sampled: bool = False, need_filter: bool = False) -> None:
        """The draft step at table width ``width``, every lane inactive (its
        KV rows land on the draft pool's trash page); ``sampled`` draws
        noise as a sampling lane would."""
        from dynamo_tpu_torch.engine.model_runner import HostResult

        B, K = self.config.max_seqs, self.spec.k
        zeros = np.zeros(B, np.int32)
        noise_args = (B, None, zeros, K, self.model.config.vocab_size, DRAFT_STREAM) if sampled else None
        with self.runner._keep_generator():
            toks = self._dispatch(zeros, np.zeros((B, width), np.int32), np.zeros(B, bool),
                                  np.zeros((B, K + 1), np.int32), np.ones(B, np.int32),
                                  np.full(B, 1.0 if sampled else 0.0, np.float32),
                                  np.full(B, 5 if need_filter else 0, np.int32), np.ones(B, np.float32),
                                  np.zeros(B, np.float32), noise_args, need_filter)
            HostResult(toks).numpy()

    def warmup_prefill(self, bucket: int, width: int) -> None:
        """One draft prefill chunk at ``bucket`` and table width ``width``:
        ``bucket`` zeros from position 0 over an all-zero table (the trash
        page)."""
        self._prefill_chunk(np.zeros(bucket, np.int32), 0, np.zeros(width, np.int32))
