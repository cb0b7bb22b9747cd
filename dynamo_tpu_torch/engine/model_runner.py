"""ModelRunner: owns the model, the paged KV cache and the device-resident
token-feedback buffer, and runs the packed prefill and fused decode-window
steps (port of ``dynamo_tpu/engine/model_runner.py``).

  - prefill chunks are padded to ``config.prefill_buckets``; chunks of up to
    N distinct sequences share one weight pass (``prefill_chunk_batch``)
  - the last sampled token per slot lives on the device
    (``slot_state["tokens"]``, with one extra drop slot at index max_seqs):
    a final prefill chunk writes its slot's first token there and decode
    windows read and update it, so the host never reads a window's results
    before dispatching the next one
  - small per-slot inputs ride two packed int/float arrays, copied to the
    device with ``non_blocking=True`` from pinned host memory; results come
    back through pinned buffers with an event recorded after the copy
    (:class:`HostResult`), which the scheduler polls instead of blocking
  - nothing inside a window reads the device from the host
  - penalties read and update the per-slot device state
    ``slot_state["counts"]`` (output-token counts) and
    ``slot_state["seen"]`` (token in prompt or output), [max_seqs + 1, V]
    each, allocated on the first request that needs them
    (``_ensure_penalty_state``; the warmup allocates them first) and reset
    per request by ``seed_penalty_slot``; a ``min_tokens`` request bans
    its EOS ids (up to ``MAX_EOS_IDS``) until its fed position reaches
    ``eos_allowed_from``. Penalties and the EOS ban form ONE "extras"
    variant of each step body (neutral inputs are no-ops), and logprobs
    (the chosen token's and the top ``LOGPROBS_K`` of the raw logits) a
    second flag: the plain variants carry neither the penalty arithmetic
    nor the full-vocab log-softmax and top-k. Seeded streams need no
    variant here (their noise is drawn on the host side of the call)

Models with ``prefill_packed`` (Llama) take the packed path when
``prefill_lanes > 1``; the others (DeepSeek), and every model at
``prefill_lanes == 1``, take the reference's per-request path
(``prefill_chunk``: one sequence's chunk per call).

On the card the step bodies are the reference's jitted step functions:
each distinct shape of a decode window and of a prefill call is captured
once into a CUDA graph (``engine/graphs.py``) and replayed after that, its
control arrays and noise copied into static inputs, the KV pools and
``slot_state["tokens"]`` written in place (the reference donates them);
captures are counted by ``compile_monitor``. The penalty state is
updated in place too (index writes into the same tensors, never a new
entry), so a graph that reads it keeps reading the live state. ``warmup_core``
/ ``warmup`` / ``warmup_extra_thunks`` capture the shapes serving reaches
ahead of it, with every write on the trash page and the drop slot. On the
CPU the bodies run eagerly.

Speculative decoding (``config.speculative``): ``dispatch_verify`` feeds
every spec-mode slot's anchor and up to k drafts at consecutive positions
through ``model.verify`` (one weight pass, K2 for Llama, K5 for DeepSeek)
and runs ``accept_speculative`` on the device, so only [B, k+1] tokens and
[B] emit counts come back; a draft-model engine owns a
:class:`~dynamo_tpu_torch.spec.draft.DraftModelRunner` (``self.draft``)
whose k-token draft step writes its probability rows into
``self.draft_q``, the static tensor the verify graphs read. Verify is
captured once per (table width, sampled, filtered, draft probabilities
read), the draft step once per (table width, sampled, filtered), and the
warmup captures both. sp waits.

Multi-LoRA (``config.lora_adapters``, ``dynamo_tpu_torch/lora/``): the
adapter pool (``self.lora``, a ``LoraPool`` of max_loras + 1 slots) is
allocated once at start on the runner's device, and ``self.lora_store``
maps adapter names to its slots. An adapter's host copy is staged once, on
the store's load thread (``stage_lora_tree``: pinned tensors on the card's
host), and ``load_lora_slot`` writes a slot's planes and scale IN PLACE
(captured graphs read the pool's addresses), copied with
``non_blocking=True`` from that pinned staging, which stays referenced
until an event recorded after the copies has completed: a blocking copy
would wait for every step queued on the stream. A decode slot's adapter slot lives in
``slot_state["lora"]`` ([max_seqs + 1] int32, the drop row last), written
by ``set_slot_lora`` at admission and read by every decode window on the
device; each prefill lane's rides the prefill ``ints`` (the column after
the lane's decode slot), each verify slot's an ``ints`` row. A LoRA
engine's step bodies always apply the delta, base lanes on the zero slot,
so the graphs are the same shapes and count as without adapters (the
warmup captures the LoRA bodies); an engine without adapters runs the
bodies unchanged. A model without ``SUPPORTS_LORA`` (DeepSeek) raises at
init, as the reference's runner does.

KV page export and import (disaggregation, the reference's
``extract_pages*`` / ``inject_pages*``): the model's ``gather_pages_wire``
/ ``scatter_pages_wire`` as torch indexing on the engine thread's stream,
ordered behind every step already enqueued there (a queued graph replay
that still writes a freed page lands before an inject into it). The
same-process handoff is a :class:`DeviceKv`, the gathered block with an
event recorded after the gather: ``inject_pages`` makes its own stream wait
on that event and marks the block as used there, so neither the read nor
the producer's reuse of the memory depends on the two engines sharing a
stream. ``extract_pages_async`` copies the gather into pinned host memory
and resolves the copy's event on a two-thread pool, off the engine thread.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.graphs import CudaGraphs, GraphCache
from dynamo_tpu_torch.engine.sampling import (
    LOGPROBS_K,
    MAX_EOS_IDS,
    SPEC_STREAM,
    SamplingParams,
    accept_speculative,
    apply_penalties,
    ban_eos,
    fold_seed,
    sample_tokens,
    sample_tokens_with_logprobs,
    seeded_uniform,
)
from dynamo_tpu_torch.ops.attention import DECODE_KERNEL_ENV
from dynamo_tpu_torch.utils import get_logger
from dynamo_tpu_torch.utils.compile_monitor import CompileMonitor

log = get_logger("engine.runner")

#: per-lane control columns of the prefill ``ints`` between the page table
#: and the EOS ids: start_pos, n_real, top_k, decode slot, adapter slot
PREFILL_COLS = 5


class HostResult:
    """Device results on their way to the host: the copies into pinned
    memory are enqueued at construction and one event is recorded after
    them. CPU tensors are ready at once."""

    def __init__(self, *devs: torch.Tensor):
        if devs[0].is_cuda:
            self._host = [torch.empty(d.shape, dtype=d.dtype, pin_memory=True) for d in devs]
            for h, d in zip(self._host, devs):
                h.copy_(d, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [d.clone() for d in devs]
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self):
        """The array (one result) or the tuple of arrays (several)."""
        if self._event is not None:
            self._event.synchronize()
        arrays = [h.numpy() for h in self._host]
        return arrays[0] if len(arrays) == 1 else tuple(arrays)


class DeviceKv:
    """A KV block gathered on the card (a tensor, or the int8 {"q", "s"}
    dict), with the CUDA event recorded after its gather on the producer's
    stream (None on the CPU)."""

    __slots__ = ("data", "ready")

    def __init__(self, data, ready=None):
        self.data, self.ready = data, ready


def _wire_map(fn, data):
    """``fn`` over a wire block's tensors (the int8 dict's leaves too)."""
    return {k: fn(v) for k, v in data.items()} if isinstance(data, dict) else fn(data)


class ModelRunner:
    def __init__(self, config: EngineConfig, model):
        self.config = config
        self.model = model
        self.device = model.device
        self.kv_cache = model.init_kv_cache(config.num_pages, config.page_size)
        B = config.max_seqs
        # token feedback buffer; index B is the drop slot for lanes whose
        # sampled token must not land anywhere (non-final or pad lanes).
        # "counts" / "seen" join it on the first penalty or min_tokens
        # request (_ensure_penalty_state), with the same drop row
        self.slot_state = {"tokens": torch.zeros(B + 1, dtype=torch.int32, device=self.device)}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        # captures of the step bodies (the reference's compiles): on the
        # card every step replays a graph; on the CPU the bodies run eagerly
        self.compile_monitor = CompileMonitor()
        self.graphs = (
            GraphCache(CudaGraphs(self.device), self.compile_monitor) if self.device.type == "cuda" else None
        )
        self._noise_bufs: dict = {}  # static noise inputs by shape, shared by the graphs
        # the last step's logits of the last dispatch ([B, V] of a window's
        # last step, [N, V] of a prefill call); a graph's static output, so
        # the next replay of that graph overwrites it
        self.last_logits = None
        # draft-model speculation: a second model with its own paged KV pool
        # and a batched k-token draft step (spec/draft.py), loaded through
        # the registry with this engine's quantize / kv_cache_dtype. Its
        # probability rows land in draft_q, which the verify graphs read
        self.draft = None
        self.draft_q = None
        spec = config.spec
        if spec is not None and spec.kind == "draft":
            from dynamo_tpu_torch.spec.draft import DraftModelRunner

            self.draft_q = torch.zeros((B, spec.k, model.config.vocab_size), device=self.device)
            self.draft = DraftModelRunner(config, spec, self)
        # multi-LoRA: the adapter pool, the name -> slot store, and each
        # decode slot's adapter slot next to the token feedback
        self.lora = None
        self.lora_store = None
        self._lora_staging: list = []  # (event, pinned tensors) of slot loads in flight
        if config.lora_adapters:
            from dynamo_tpu_torch.lora import LoraStore, init_lora_pool

            if not getattr(model, "SUPPORTS_LORA", False):
                raise ValueError(f"model {type(model).__name__} does not support LoRA adapters")
            self.lora = init_lora_pool(model, config.max_loras, config.lora_rank, device=self.device)
            self.slot_state["lora"] = torch.zeros(B + 1, dtype=torch.int32, device=self.device)
            self.lora_store = LoraStore(config, model, self.load_lora_slot, self.stage_lora_tree)

    # ---------------- host -> device ----------------

    def _stage(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor to copy from: pinned (from torch's
        caching host allocator, reused only after the copy that read it has
        run) when the runner is on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return self._stage(a).to(self.device, non_blocking=True)

    def _noise_shape(self, noise_args) -> tuple:
        """(steps, B, width) of ``noise_args`` (width V unless given)."""
        B, _, _, steps, *rest = noise_args
        return (steps, B, rest[0] if rest else self.model.config.vocab_size)

    def _noise(self, B: int, seeds: np.ndarray | None, positions: np.ndarray, steps: int, width: int | None = None,
               stream: int = 0, out=None):
        """[steps, B, width] uniforms (width V unless given; into ``out``
        when given): the engine generator for every slot, rows of seeded
        slots replaced by their (seed, fed position + step, ``stream``)
        stream."""
        width = width or self.model.config.vocab_size
        u = torch.empty((steps, B, width), device=self.device) if out is None else out
        u.uniform_(0.0, 1.0, generator=self._gen)
        if seeds is not None:
            for i in np.flatnonzero(seeds):
                for j in range(steps):
                    u[j, i] = seeded_uniform(int(seeds[i]), int(positions[i]) + j, width, self.device, stream)
        return u

    def _step(self, label: str, key: tuple, body, ints: np.ndarray, flts: np.ndarray, noise_args) -> tuple:
        """Run ``body(ints, flts, noise) -> (tokens, logits)`` on this
        call's arrays: eagerly on the CPU, through the graph of ``key`` on
        the card. ``noise_args`` (B, seeds, positions, steps[, width,
        stream]) or None."""
        if self.graphs is None:
            noise = None if noise_args is None else self._noise(*noise_args)
            return body(self._to_device(ints), self._to_device(flts), noise)

        def make_inputs():
            noise = None
            if noise_args is not None:
                shape = self._noise_shape(noise_args)
                noise = self._noise_bufs.get(shape)
                if noise is None:
                    noise = self._noise_bufs[shape] = torch.empty(shape, device=self.device)
            return (torch.empty(ints.shape, dtype=torch.int32, device=self.device),
                    torch.empty(flts.shape, dtype=torch.float32, device=self.device), noise)

        def fill(inputs):
            s_ints, s_flts, s_noise = inputs
            s_ints.copy_(self._stage(ints), non_blocking=True)
            s_flts.copy_(self._stage(flts), non_blocking=True)
            if noise_args is not None:
                self._noise(*noise_args, out=s_noise)

        return self.graphs.run(label, key, make_inputs, fill, body)

    # ---------------- step bodies (device work only) ----------------

    def _prefill_impl(self, ints, flts, noise, bucket: int, mp: int, need_filter: bool, want_lp: bool = False,
                      extras: bool = False):
        """ints [N, bucket + mp + PREFILL_COLS + MAX_EOS_IDS] = token buf, page
        table, (start_pos, n_real, top_k, slot, adapter slot), then the
        lane's EOS ids (V-padded); flts [6, N] = (temperature, top_p, min_p, presence,
        frequency, repetition). Every lane's last-row logits are sampled;
        the token lands in ``slot_state["tokens"][slot]`` (slot max_seqs =
        dropped). On the packed path the lanes take
        ``model.prefill_packed``; off it N is 1 and the lane takes
        ``model.prefill``. ``extras``: the EOS ban (the first sampled token
        is generation #1, so a lane's EOS ids are banned outright), then
        the penalties against the slot's state, which takes the sampled
        token (the drop row takes the others'). A LoRA runner applies each
        lane's adapter slot (0 = base). Returns (tokens [N],
        logits [N, V]) and, with ``want_lp``, (chosen logprob [N], top ids
        [N, K], top logprobs [N, K])."""
        tokens = ints[:, :bucket]
        page_tables = ints[:, bucket : bucket + mp]
        start_pos = ints[:, bucket + mp]
        n = ints[:, bucket + mp + 1]
        top_ks = ints[:, bucket + mp + 2]
        slots = ints[:, bucket + mp + 3]
        lora_ids = ints[:, bucket + mp + 4]
        eos_ids = ints[:, bucket + mp + PREFILL_COLS :]
        ar = torch.arange(bucket, dtype=torch.int32, device=ints.device)
        positions = (start_pos[:, None] + ar[None, :]).contiguous()
        valid = ar[None, :] < n[:, None]
        last = (n - 1).clamp(min=0)
        lora = {} if self.lora is None else dict(lora=self.lora)
        if self.packed_prefill_mode:
            if lora:
                lora["lora_ids"] = lora_ids.contiguous()
            logits, _ = self.model.prefill_packed(
                self.kv_cache, tokens, positions, page_tables.contiguous(), valid, last, **lora
            )
        else:
            if lora:
                lora["lora_id"] = lora_ids[:1]
            logits, _ = self.model.prefill(
                self.kv_cache, tokens[0], positions[0], page_tables[0].contiguous(), valid[0], last[0], **lora
            )
            logits = logits[None]
        raw = logits
        rows = slots.long()
        if extras:
            logits = ban_eos(logits, eos_ids, torch.full_like(flts[0], -1e30))
            logits = apply_penalties(logits, self.slot_state["counts"][rows], self.slot_state["seen"][rows],
                                     flts[3], flts[4], flts[5])
        kwargs = dict(min_p=flts[2], uniform=None if noise is None else noise[0], need_filter=need_filter)
        lp = ()
        if want_lp:
            toks, *lp = sample_tokens_with_logprobs(logits, flts[0], top_ks, flts[1], raw_logits=raw, **kwargs)
        else:
            toks = sample_tokens(logits, flts[0], top_ks, flts[1], **kwargs)
        self.slot_state["tokens"].index_put_((rows,), toks)
        if extras:
            # flat (row, token) indices: index_add_ accumulates the drop
            # row's repeats, and neither op syncs with the host (capturable)
            flat = rows * logits.shape[-1] + toks.long()
            self.slot_state["counts"].view(-1).index_add_(0, flat, torch.ones_like(toks))
            self.slot_state["seen"].view(-1).index_fill_(0, flat, True)
        return (toks, raw, *lp)

    def _decode_window_impl(self, ints, flts, noise, num_steps: int, need_filter: bool, want_lp: bool = False,
                            extras: bool = False):
        """num_steps fused decode steps; the token feedback starts from the
        device-resident ``slot_state["tokens"]``. ``ints`` [5 + MAX_EOS_IDS
        + W, B] = positions, limits (max fed position), active, top_ks,
        eos_allowed_from, the per-slot EOS id rows (V-padded), then the
        transposed page tables; ``flts`` [6, B] = temps, top_ps, min_ps,
        presence, frequency, repetition. A slot freezes once its fed
        position would pass its limit. ``extras``: each step applies the
        penalties against the slots' state, then bans a slot's EOS ids while
        its fed position is below eos_allowed_from, and the active slots'
        sampled tokens update counts and seen. A LoRA runner applies each
        slot's adapter slot (``slot_state["lora"]``). Returns (tokens
        [num_steps, B], the last step's raw logits [B, V]) and, with ``want_lp``,
        (chosen logprobs [num_steps, B], top ids and top logprobs
        [num_steps, B, K])."""
        B = ints.shape[1]
        positions = ints[0].contiguous()
        limits = ints[1]
        act = ints[2].bool()
        top_ks = ints[3]
        eos_from = ints[4]
        eos_ids = ints[5 : 5 + MAX_EOS_IDS].t()
        page_tables = ints[5 + MAX_EOS_IDS :].t().contiguous()
        temps, top_ps, min_ps = flts[0], flts[1], flts[2]
        tokens = self.slot_state["tokens"][:B].clone()
        lora = {} if self.lora is None else dict(lora=self.lora, lora_ids=self.slot_state["lora"][:B])
        out = torch.empty((num_steps, B), dtype=torch.int32, device=ints.device)
        lp_out = None
        if want_lp:
            K = min(LOGPROBS_K, self.model.config.vocab_size)
            lp_out = (torch.empty((num_steps, B), device=ints.device),
                      torch.empty((num_steps, B, K), dtype=torch.int32, device=ints.device),
                      torch.empty((num_steps, B, K), device=ints.device))
        if extras:
            counts, seen = self.slot_state["counts"], self.slot_state["seen"]
            row_base = torch.arange(B, device=ints.device) * counts.shape[-1]
            ban = torch.full((B,), -1e30, device=ints.device)
            allow = torch.zeros_like(ban)
        logits = None
        for step in range(num_steps):
            logits, _ = self.model.decode(self.kv_cache, tokens, positions, page_tables, act, **lora)
            masked = logits
            if extras:
                masked = apply_penalties(masked, counts[:B], seen[:B], flts[3], flts[4], flts[5])
                masked = ban_eos(masked, eos_ids, torch.where(positions >= eos_from, allow, ban))
            kwargs = dict(min_p=min_ps, uniform=None if noise is None else noise[step], need_filter=need_filter)
            if want_lp:
                toks, *lp = sample_tokens_with_logprobs(masked, temps, top_ks, top_ps, raw_logits=logits, **kwargs)
                for dst, src in zip(lp_out, lp):
                    dst[step] = src
            else:
                toks = sample_tokens(masked, temps, top_ks, top_ps, **kwargs)
            out[step] = toks
            tokens = torch.where(act, toks, tokens)
            if extras:
                # only the rows that emitted this step count (``seen`` stays exact)
                flat = row_base + toks.long()
                counts.view(-1).index_add_(0, flat, act.to(counts.dtype))
                seen.view(-1)[flat] = seen.view(-1)[flat] | act
            positions = positions + act.to(positions.dtype)
            act = act & (positions <= limits)
        self.slot_state["tokens"][:B] = tokens
        return (out, logits, *(lp_out or ()))

    def _verify_impl(self, ints, flts, noise, K1: int, need_filter: bool, draft_probs=None):
        """Speculative verify step: every slot feeds its anchor token and up
        to K drafts at consecutive positions through ``model.verify``, then
        ``accept_speculative`` runs on the device. ``ints`` [5 + K1 + W, B]
        = positions (anchor fed position), active, top_ks, n_drafts, adapter
        slots (read by a LoRA runner), the K1 fed-token rows, then the
        transposed page tables; ``flts`` [3, B] =
        temps, top_ps, min_ps; ``noise`` [1, B, K + V] (None: no slot
        samples). Rows past a slot's n_drafts scatter their KV to the trash
        page. Returns (tokens [B, K1], n_emit [B], logits [B, K1, V])."""
        positions = ints[0]
        active = ints[1].bool()
        top_ks = ints[2]
        n_drafts = ints[3]
        lora = {} if self.lora is None else dict(lora=self.lora, lora_ids=ints[4].contiguous())
        fed = ints[5 : 5 + K1].t().contiguous()
        page_tables = ints[5 + K1 :].t().contiguous()
        t_idx = torch.arange(K1, dtype=torch.int32, device=ints.device)
        pos_mat = (positions[:, None] + t_idx[None, :]).contiguous()
        row_valid = active[:, None] & (t_idx[None, :] <= n_drafts[:, None])
        logits, _ = self.model.verify(self.kv_cache, fed, pos_mat, page_tables, row_valid, **lora)
        out, n_emit = accept_speculative(
            logits, fed[:, 1:], n_drafts, flts[0], top_ks, flts[1], min_p=flts[2], draft_probs=draft_probs,
            uniform=None if noise is None else noise[0], need_filter=need_filter,
        )
        return out, torch.where(active, n_emit, torch.zeros_like(n_emit)), logits

    # ---------------- host API (engine thread) ----------------

    def write_token_slots(self, slots: np.ndarray, tokens: np.ndarray) -> None:
        """Host-known tokens -> slot token feedback."""
        idx = self._to_device(np.asarray(slots, np.int64))
        self.slot_state["tokens"].index_put_((idx,), self._to_device(np.asarray(tokens, np.int32)))

    # ---------------- multi-LoRA ----------------

    def set_slot_lora(self, slot: int, lora_slot: int) -> None:
        """Set decode slot ``slot``'s adapter slot in ``slot_state["lora"]``
        (an in-place index write; a slot out of range lands on the drop
        row). Written once at admission; decode windows read it on the
        device. A no-op on a runner without adapters."""
        if self.lora is None:
            return
        B = self.config.max_seqs
        self.slot_state["lora"][slot if 0 <= slot < B else B] = int(lora_slot)

    def stage_lora_tree(self, host_tree: dict) -> dict:
        """An adapter's host tree (the reference's: {module: {"a" [L, in, r],
        "b" [L, r, out]}}, numpy) as f32 tensors to copy from, pinned on the
        card's host; the store runs this once an adapter, on its load
        thread."""
        return {m: {k: self._stage(np.asarray(v, np.float32)) for k, v in e.items()} for m, e in host_tree.items()}

    @torch.no_grad()
    def load_lora_slot(self, slot: int, host_tree: dict, scale: float) -> None:
        """Write one adapter (a host tree at the pool rank, staged by
        ``stage_lora_tree``) and its scale into pool slot ``slot``, in place.
        The copies leave the pinned staging with ``non_blocking=True``, on
        the engine thread's stream, so they land after every step already
        enqueued and before any enqueued after; the staging stays referenced
        until an event recorded after them has completed."""
        pool = self.lora
        for m, entry in host_tree.items():
            group, cols = pool.a_columns(m, slot)
            pool.a[group][:, :, cols].copy_(entry["a"], non_blocking=True)
            pool.b[m][:, pool.b_rows(slot)].copy_(entry["b"], non_blocking=True)
        pool.scales[slot] = float(scale)
        if self.device.type == "cuda":
            self._lora_staging = [(ev, keep) for ev, keep in self._lora_staging if not ev.query()]
            done = torch.cuda.Event()
            done.record()
            self._lora_staging.append((done, host_tree))

    # ---------------- KV page export / import (disaggregation) ----------------

    def _flat_ids(self, page_ids) -> torch.Tensor:
        """[n] logical page ids -> [L, n] flat pool ids on the device, copied
        from pinned memory without a host wait (a blocking copy would wait
        for every step already queued on the stream: the KV tiers' saves and
        restores run inside allocation)."""
        L, P = self.model.config.num_layers, self.config.num_pages
        ids = np.asarray(page_ids, np.int64)
        return self._to_device(ids[None, :] + (np.arange(L, dtype=np.int64) * P)[:, None])

    @torch.no_grad()
    def extract_pages_device(self, page_ids: np.ndarray) -> DeviceKv:
        """Gather KV blocks into a device block ([L, 2, n, page_size, Hkv, D]
        for Llama, [L, n, ps, latent] for MLA, the {"q", "s"} dict for an
        int8 cache) without a host copy: the same-process (ici) path. An
        event after the gather marks when the block is written."""
        data = self.model.gather_pages_wire(self.kv_cache, self._flat_ids(page_ids))
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return DeviceKv(data, ready)

    def extract_pages(self, page_ids: np.ndarray):
        """KV blocks as host tensors (the int8 cache's {"q", "s"} dict),
        waiting for the copy."""
        return self.extract_pages_async(page_ids).result()

    @torch.no_grad()
    def extract_pages_async(self, page_ids: np.ndarray):
        """Chunk-streamed export: the gather and its copy into pinned host
        memory are enqueued NOW (on the engine thread, right behind the
        prefill chunk that finalized these pages), and the wait for the copy
        runs on a two-thread side pool. Returns a concurrent.futures.Future
        of the host block; the engine thread goes on dispatching the next
        chunk while this one drains."""
        from concurrent.futures import Future, ThreadPoolExecutor

        data = self.model.gather_pages_wire(self.kv_cache, self._flat_ids(page_ids))
        if self.device.type != "cuda":
            fut: Future = Future()
            fut.set_result(data)  # a fresh gather: no later step writes it
            return fut

        def to_pinned(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h

        host = _wire_map(to_pinned, data)
        done = torch.cuda.Event()
        done.record()
        pool = getattr(self, "_d2h_pool", None)
        if pool is None:
            pool = self._d2h_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="kv-d2h")

        def wait():
            done.synchronize()
            return host

        return pool.submit(wait)

    @torch.no_grad()
    def inject_pages(self, page_ids: np.ndarray, data) -> None:
        """Write KV blocks received from a peer into our pages, in place.
        ``data``: host tensors (the socket and inline paths), a
        :class:`DeviceKv` from an engine in this process (ici: this stream
        waits on its event first), or the int8 {"q", "s"} dict of either.
        Dtypes convert inside the model's ``scatter_pages_wire``."""
        if isinstance(data, DeviceKv):
            if data.ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(data.ready)

                def keep(t):
                    if t.is_cuda:
                        t.record_stream(stream)  # the producer's allocator waits for this read
                    return t

                _wire_map(keep, data.data)
            data = data.data
        # no host wait: pinned blocks stay alive (torch's caching host
        # allocator) until the copy that reads them has run, and a pageable
        # block is staged before the call returns
        data = _wire_map(lambda t: t.to(self.device, non_blocking=True), data)
        self.model.scatter_pages_wire(self.kv_cache, self._flat_ids(page_ids), data)

    def _ensure_penalty_state(self) -> None:
        """Allocate ``slot_state["counts"]`` and ``["seen"]`` ([max_seqs +
        1, V], row max_seqs the drop row) once: a graph that reads them
        bakes in their addresses, so they are never reallocated."""
        if "counts" not in self.slot_state:
            V, B = self.model.config.vocab_size, self.config.max_seqs
            self.slot_state["counts"] = torch.zeros((B + 1, V), dtype=torch.int32, device=self.device)
            self.slot_state["seen"] = torch.zeros((B + 1, V), dtype=torch.bool, device=self.device)

    def seed_penalty_slot(self, slot: int, token_ids, output_from: int | None = None) -> None:
        """Reset a slot's penalty state: mark all of ``token_ids`` seen and
        count the tail from ``output_from`` as output occurrences (a
        re-admitted request's prompt that embeds its earlier output keeps
        its presence / frequency penalties). In-place writes, on the stream
        the slot's prefill is enqueued on after."""
        self._ensure_penalty_state()
        ids = np.asarray(token_ids, np.int64)
        out_ids = ids[output_from:] if output_from is not None else ids[:0]
        counts, seen = self.slot_state["counts"][slot], self.slot_state["seen"][slot]
        counts.zero_()
        seen.zero_()
        if len(ids):
            seen.index_fill_(0, self._to_device(ids), True)
        if len(out_ids):
            counts.index_add_(0, self._to_device(out_ids), torch.ones(len(out_ids), dtype=counts.dtype,
                                                                       device=self.device))

    @property
    def packed_prefill_mode(self) -> bool:
        """True when the scheduler packs prefill chunks of several sequences
        into one call (the reference's gate, without its pp/sp terms, which
        the port does not run)."""
        return self.config.prefill_lanes > 1 and hasattr(self.model, "prefill_packed")

    def pack_prefill_lanes(self, lanes: list, N: int):
        """Build the packed int/float control arrays on the host.
        ``lanes``: [(tokens np[int32], start_pos, page_table, slot_or_-1,
        sampling, eos_ids, is_final[, adapter slot])]. Returns (ints, flts, mp, sampled,
        need_filter, seeds, sample_pos, extras): ``extras`` when a final
        lane has penalties or bans its EOS ids (``min_tokens`` >= 1)."""
        V = self.model.config.vocab_size
        bucket = self.config.bucket_for(max(len(lane[0]) for lane in lanes))
        # the widest lane's ladder bucket; narrow lanes zero-pad into the
        # trash page
        mp = self.config.table_bucket_for(max(len(lane[2]) for lane in lanes))
        ints = np.zeros((N, bucket + mp + PREFILL_COLS + MAX_EOS_IDS), np.int32)
        ints[:, bucket + mp + PREFILL_COLS :] = V  # no EOS id to ban
        flts = np.zeros((6, N), np.float32)
        flts[1] = 1.0  # top_p neutral
        flts[5] = 1.0  # repetition neutral
        seeds = np.zeros(N, np.int32)
        sample_pos = np.zeros(N, np.int64)
        sampled = need_filter = extras = False
        for j, (tokens, start_pos, page_table, slot, sampling, eos_ids, is_final, *lora_slot) in enumerate(lanes):
            n = len(tokens)
            ints[j, :n] = tokens
            ints[j, bucket : bucket + len(page_table[:mp])] = page_table[:mp]
            ints[j, bucket + mp] = start_pos
            ints[j, bucket + mp + 1] = n
            ints[j, bucket + mp + 2] = sampling.top_k
            ints[j, bucket + mp + 3] = slot if (is_final and slot >= 0) else self.config.max_seqs
            ints[j, bucket + mp + 4] = lora_slot[0] if lora_slot else 0
            # min_tokens >= 1: the first sampled token (generation #1) must
            # not be EOS (vLLM: EOS is suppressed while generated < min_tokens)
            want_eos = bool(is_final and eos_ids and sampling.min_tokens >= 1 and not sampling.ignore_eos)
            if want_eos:
                if len(eos_ids) > MAX_EOS_IDS:
                    log.warning("min_tokens: %d EOS ids exceed the device limit %d; ids beyond the limit "
                                "are not suppressed", len(eos_ids), MAX_EOS_IDS)
                ids = np.asarray(eos_ids, np.int32)[:MAX_EOS_IDS]
                ints[j, bucket + mp + PREFILL_COLS : bucket + mp + PREFILL_COLS + len(ids)] = ids
            flts[:, j] = (sampling.temperature, sampling.top_p, sampling.min_p, sampling.presence_penalty,
                          sampling.frequency_penalty, sampling.repetition_penalty)
            extras = extras or want_eos or (is_final and sampling.needs_penalties)
            if is_final and sampling.temperature > 0:
                sampled = True
                need_filter = need_filter or sampling.needs_filter
                seeds[j] = fold_seed(sampling.seed)
                sample_pos[j] = start_pos + n - 1
        # pad lanes: n=0, start 0, page table 0 (every read lands in the
        # in-bounds trash page), slot out of range so the feedback drops,
        # adapter slot 0
        ints[len(lanes) :, bucket + mp + 3] = self.config.max_seqs
        return ints, flts, mp, sampled, need_filter, seeds, sample_pos, extras

    @torch.no_grad()
    def prefill_chunk_batch(self, lanes: list, N: int, want_logprobs: bool = False) -> HostResult:
        """Dispatch ONE packed prefill covering chunks of up to N distinct
        sequences. Returns the [N] sampled tokens on their way to the host
        (callers read only final-chunk lanes), with ``want_logprobs`` as
        (tokens, chosen logprobs [N], top ids [N, K], top logprobs [N, K])."""
        ints, flts, mp, sampled, need_filter, seeds, sample_pos, extras = self.pack_prefill_lanes(lanes, N)
        if extras:
            self._ensure_penalty_state()
        bucket = ints.shape[1] - mp - PREFILL_COLS - MAX_EOS_IDS
        noise_args = (N, seeds if seeds.any() else None, sample_pos, 1) if sampled else None
        packed = self.packed_prefill_mode
        label = "prefill_packed" if packed else "prefill"
        key = (label, N, bucket, mp, sampled, need_filter, want_logprobs, extras)
        body = functools.partial(self._prefill_impl, bucket=bucket, mp=mp, need_filter=need_filter,
                                 want_lp=want_logprobs, extras=extras)
        toks, self.last_logits, *lp = self._step(label, key, body, ints, flts, noise_args)
        return HostResult(toks, *lp)

    def prefill_chunk(
        self,
        tokens: np.ndarray,  # [n] real tokens for this chunk
        start_pos: int,
        page_table: np.ndarray,  # [ladder width]
        sample: bool,  # the sequence's final chunk: sample its first token
        sampling,  # SamplingParams
        slot: int = -1,  # decode slot to seed with the sampled token (device side)
        eos_ids=(),  # the request's EOS ids (min_tokens bans them on the device)
        want_logprobs: bool = False,  # only a sampling (final) chunk's are read
        lora_slot: int = 0,  # the chunk's adapter slot (0 = base)
    ) -> HostResult:
        """The per-request path: dispatch ONE prefill chunk of one sequence
        (``model.prefill``). On the final chunk the sampled token also lands
        in ``slot_state["tokens"][slot]`` on the device. Returns the [1]
        sampled token on its way to the host (read it only when
        ``sample``), with ``want_logprobs`` as ``prefill_chunk_batch``
        returns them."""
        lane = (tokens, start_pos, page_table, slot, sampling, eos_ids, sample, lora_slot)
        return self.prefill_chunk_batch([lane], N=1, want_logprobs=want_logprobs and sample)

    @torch.no_grad()
    def dispatch_decode_window(
        self,
        positions: np.ndarray,  # [B] fed-token position per slot
        page_tables: np.ndarray,  # [B, W]
        active: np.ndarray,  # [B] bool
        limits: np.ndarray,  # [B] max fed-token position per slot
        temps: np.ndarray,
        top_ks: np.ndarray,
        top_ps: np.ndarray,
        num_steps: int,
        min_ps: np.ndarray | None = None,  # [B]
        seeds: np.ndarray | None = None,  # [B] int32 folded seeds (0 = unseeded)
        want_logprobs: bool = False,
        penalties: np.ndarray | None = None,  # [3, B] presence / frequency / repetition
        eos_allowed_from: np.ndarray | None = None,  # [B] fed position where EOS unblocks (min_tokens)
        eos_ids: np.ndarray | None = None,  # [B, MAX_EOS_IDS] V-padded
    ) -> HostResult:
        """Dispatch one fused decode window WITHOUT waiting for results.
        Returns the [num_steps, B] tokens on their way to the host, with
        ``want_logprobs`` as (tokens, chosen logprobs [num_steps, B], top
        ids and top logprobs [num_steps, B, K]). Penalties and the EOS ban
        take the one "extras" variant (their neutral inputs are no-ops)."""
        B = positions.shape[0]
        min_ps = np.zeros(B, np.float32) if min_ps is None else min_ps
        live = active & (temps > 0)
        noise_args = None
        if live.any():
            seeded = seeds if seeds is not None and np.any(seeds[live]) else None
            if seeded is not None:
                seeded = np.where(live, seeded, 0)
            noise_args = (B, seeded, positions, num_steps)
        need_filter = bool(np.any(live & ((top_ks > 0) | (top_ps < 1.0) | (min_ps > 0))))
        return self._window(positions, page_tables, active, limits, temps, top_ks, top_ps, min_ps, num_steps,
                            noise_args, need_filter, want_logprobs, penalties, eos_allowed_from, eos_ids)

    def _window(self, positions, page_tables, active, limits, temps, top_ks, top_ps, min_ps, num_steps: int,
                noise_args, need_filter: bool, want_logprobs: bool = False, penalties=None, eos_allowed_from=None,
                eos_ids=None) -> HostResult:
        B = positions.shape[0]
        V = self.model.config.vocab_size
        ints = np.empty((5 + MAX_EOS_IDS + page_tables.shape[1], B), np.int32)
        ints[0] = positions
        ints[1] = limits
        ints[2] = active
        ints[3] = top_ks
        ints[4] = eos_allowed_from if eos_allowed_from is not None else 0
        ints[5 : 5 + MAX_EOS_IDS] = eos_ids.T if eos_ids is not None else V
        ints[5 + MAX_EOS_IDS :] = page_tables.T
        flts = np.empty((6, B), np.float32)
        flts[0] = temps
        flts[1] = top_ps
        flts[2] = min_ps
        flts[3:6] = penalties if penalties is not None else np.array([[0.0], [0.0], [1.0]], np.float32)
        extras = penalties is not None or eos_ids is not None
        if extras:
            self._ensure_penalty_state()
        # the decode kernel is read at capture, as the reference's jit reads
        # it at trace time: a graph per choice
        key = ("decode_window", B, page_tables.shape[1], num_steps, noise_args is not None, need_filter,
               os.environ.get(DECODE_KERNEL_ENV, "lookahead"), want_logprobs, extras)
        body = functools.partial(self._decode_window_impl, num_steps=num_steps, need_filter=need_filter,
                                 want_lp=want_logprobs, extras=extras)
        toks, self.last_logits, *lp = self._step("decode_window", key, body, ints, flts, noise_args)
        return HostResult(toks, *lp)

    @torch.no_grad()
    def dispatch_verify(
        self,
        positions: np.ndarray,  # [B] anchor fed position per slot
        page_tables: np.ndarray,  # [B, W]
        active: np.ndarray,  # [B] bool
        fed_tokens: np.ndarray,  # [B, K+1] anchor + (padded) draft tokens
        n_drafts: np.ndarray,  # [B] real draft count per slot
        temps: np.ndarray,
        top_ks: np.ndarray,
        top_ps: np.ndarray,
        min_ps: np.ndarray | None = None,
        seeds: np.ndarray | None = None,  # [B] int32 folded seeds (0 = unseeded)
        draft_probs: torch.Tensor | None = None,  # [B, K, V] from dispatch_draft (stays on the device)
        lora_slots: np.ndarray | None = None,  # [B] adapter slot per decode slot (None: all base)
    ) -> HostResult:
        """Dispatch one speculative verify pass; returns (tokens [B, K+1],
        n_emit [B]) on their way to the host. The caller reads both before
        it proposes again (rounds are synchronous: the gain is k+1 tokens a
        weight pass, not dispatch-ahead). ``draft_probs`` rides to the
        acceptance on the device (draft-model rounds); None keeps the
        one-hot (n-gram) rule."""
        B = positions.shape[0]
        min_ps = np.zeros(B, np.float32) if min_ps is None else min_ps
        live = active & (temps > 0)
        noise_args = None
        if live.any():
            seeded = seeds if seeds is not None and np.any(seeds[live]) else None
            if seeded is not None:
                seeded = np.where(live, seeded, 0)
            K = fed_tokens.shape[1] - 1
            noise_args = (B, seeded, positions, 1, K + self.model.config.vocab_size, SPEC_STREAM)
        need_filter = bool(np.any(live & ((top_ks > 0) | (top_ps < 1.0) | (min_ps > 0))))
        return self._verify(positions, page_tables, active, fed_tokens, n_drafts, temps, top_ks, top_ps, min_ps,
                            noise_args, need_filter, draft_probs, lora_slots)

    def _verify(self, positions, page_tables, active, fed_tokens, n_drafts, temps, top_ks, top_ps, min_ps,
                noise_args, need_filter: bool, draft_probs=None, lora_slots=None) -> HostResult:
        B, K1 = fed_tokens.shape
        ints = np.empty((5 + K1 + page_tables.shape[1], B), np.int32)
        ints[0] = positions
        ints[1] = active
        ints[2] = top_ks
        ints[3] = n_drafts
        ints[4] = lora_slots if lora_slots is not None else 0
        ints[5 : 5 + K1] = fed_tokens.T
        ints[5 + K1 :] = page_tables.T
        flts = np.stack([temps, top_ps, min_ps]).astype(np.float32)
        sampled = noise_args is not None
        if not sampled:
            draft_probs = None  # greedy acceptance never reads q
        elif draft_probs is not None and draft_probs is not self.draft_q:
            # the graphs read the one static tensor the draft step writes
            raise ValueError("draft_probs must be the draft step's output (runner.draft_q)")
        key = ("verify", B, K1, page_tables.shape[1], sampled, need_filter, draft_probs is not None)
        body = functools.partial(self._verify_impl, K1=K1, need_filter=need_filter, draft_probs=draft_probs)
        out, n_emit, self.last_logits = self._step("verify", key, body, ints, flts, noise_args)
        return HostResult(out, n_emit)

    def dispatch_draft(self, *args, **kwargs):
        """One batched draft round across every spec-mode lane (draft-model
        speculation only; see spec/draft.py DraftModelRunner.dispatch_draft).
        Returns (draft tokens [B, K] on their way to the host, draft probs
        [B, K, V] on the device)."""
        if self.draft is None:
            raise RuntimeError("dispatch_draft requires speculative='draft:...'")
        return self.draft.dispatch_draft(*args, **kwargs)

    # ---------------- warmup (captures ahead of serving) ----------------

    @contextlib.contextmanager
    def _keep_generator(self):
        """Restore the engine generator's state after a warmup call's noise
        draws, so warming up leaves the served sampling streams as they
        would have been."""
        state = self._gen.get_state()
        try:
            yield
        finally:
            self._gen.set_state(state)

    def _warmup_window(self, width: int, sampled: bool = False, need_filter: bool = False,
                       want_logprobs: bool = False, extras: bool = False) -> None:
        """The default decode window at table width ``width``, every slot
        inactive: its KV rows land on the trash page, and the slot tokens
        and penalty state stay as they are. ``sampled`` draws noise as a
        sampling slot would (so the sampled body is captured without a live
        slot); ``want_logprobs`` / ``extras`` take those variants (neutral
        penalties, no EOS id)."""
        B, K = self.config.max_seqs, self.config.decode_steps
        zeros = np.zeros(B, np.int32)
        temps = np.full(B, 1.0 if sampled else 0.0, np.float32)
        noise_args = (B, None, zeros, K) if sampled else None
        penalties = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, B)) if extras else None
        with self._keep_generator():
            self._window(zeros, np.zeros((B, width), np.int32), np.zeros(B, bool), zeros, temps,
                         np.full(B, 5 if need_filter else 0, np.int32), np.ones(B, np.float32),
                         np.zeros(B, np.float32), K, noise_args, need_filter, want_logprobs, penalties).numpy()

    def _warmup_prefill(self, bucket: int, N: int, width: int, sampling: SamplingParams | None = None,
                        want_logprobs: bool = False) -> None:
        """One prefill call of N lanes at ``bucket`` and table width
        ``width``: one lane of zeros at position 0 over an all-zero table
        (its KV rows land on the trash page), its token dropped (slot -1;
        the pad lanes' too, and the drop row takes its penalty update).
        ``sampling`` samples that token (a final lane, with EOS id 0 to ban
        where it sets min_tokens), else greedy; ``want_logprobs`` takes the
        logprobs variant (a final lane)."""
        final = sampling is not None or want_logprobs
        lane = (np.zeros(bucket, np.int32), 0, np.zeros(width, np.int32), -1,
                sampling or SamplingParams(temperature=0.0), (0,) if sampling is not None else (), final)
        with self._keep_generator():
            if self.packed_prefill_mode:
                self.prefill_chunk_batch([lane], N=N, want_logprobs=want_logprobs).numpy()
            else:
                self.prefill_chunk(*lane[:3], sample=lane[6], sampling=lane[4], slot=-1, eos_ids=lane[5],
                                   want_logprobs=want_logprobs).numpy()

    def _warmup_verify(self, width: int, sampled: bool = False, need_filter: bool = False,
                       with_q: bool = False) -> None:
        """The verify step at table width ``width``, every slot inactive
        (its KV rows land on the trash page); ``sampled`` draws noise as a
        sampling slot would, ``with_q`` reads the draft probabilities."""
        B, K = self.config.max_seqs, self.config.spec.k
        zeros = np.zeros(B, np.int32)
        V = self.model.config.vocab_size
        noise_args = (B, None, zeros, 1, K + V, SPEC_STREAM) if sampled else None
        with self._keep_generator():
            self._verify(zeros, np.zeros((B, width), np.int32), np.zeros(B, bool), np.zeros((B, K + 1), np.int32),
                         zeros, np.full(B, 1.0 if sampled else 0.0, np.float32),
                         np.full(B, 5 if need_filter else 0, np.int32), np.ones(B, np.float32),
                         np.zeros(B, np.float32), noise_args, need_filter,
                         self.draft_q if with_q else None).numpy()

    def _spec_warmup_thunks(self) -> tuple[list, list]:
        """(core, extra) thunks of the speculative steps: core the greedy
        verify at the first table width and, in draft mode, the draft
        step and the smallest draft prefill there; extra the greedy verify
        and draft step at the wider widths, every draft prefill bucket at
        every width, and the sampled variants (sampled, and filtered) at
        the first width (with and without the draft probabilities)."""
        spec = self.config.spec
        if spec is None:
            return [], []
        widths, buckets = self.config.table_buckets, self.config.prefill_buckets
        draft = self.draft
        core = [functools.partial(self._warmup_verify, widths[0])]
        extra = [functools.partial(self._warmup_verify, w) for w in widths[1:]]
        for need_filter in (False, True):
            extra.append(functools.partial(self._warmup_verify, widths[0], True, need_filter))
            if draft is not None:
                extra.append(functools.partial(self._warmup_verify, widths[0], True, need_filter, True))
        if draft is not None:
            core += [functools.partial(draft.warmup_step, widths[0]),
                     functools.partial(draft.warmup_prefill, buckets[0], widths[0])]
            extra += [functools.partial(draft.warmup_step, w) for w in widths[1:]]
            extra += [functools.partial(draft.warmup_step, widths[0], True, f) for f in (False, True)]
            extra += [functools.partial(draft.warmup_prefill, b, w) for w in widths for b in buckets
                      if (b, w) != (buckets[0], widths[0])]
        return core, extra

    def _lane_counts(self, bucket: int) -> list[int]:
        """The N a prefill call at ``bucket`` takes: each power of two up to
        lanes_for(bucket) on the packed path (the scheduler rounds up to
        one), 1 off it."""
        if not self.packed_prefill_mode:
            return [1]
        top = self.config.lanes_for(bucket)
        return [n for n in (1 << i for i in range(top.bit_length())) if n < top] + [top]

    def warmup_core(self) -> None:
        """Capture what the first requests need, before serving: the
        default decode window at the first table width, each prefill
        bucket at N = 1 and N = lanes_for(bucket) (per-request: N = 1)
        there, and with speculation the greedy verify (and the draft
        model's step and smallest prefill) there. Every call writes only
        the trash page. The penalty state is allocated first, so every
        graph is captured against it."""
        t0 = time.monotonic()
        self._ensure_penalty_state()
        width = self.config.table_buckets[0]
        self._warmup_window(width)
        for b in self.config.prefill_buckets:
            for n in sorted({1, self._lane_counts(b)[-1]}):
                self._warmup_prefill(b, n, width)
        for thunk in self._spec_warmup_thunks()[0]:
            thunk()
        log.info("warmup(core): %d captures in %.1fs", self.compile_monitor.compiles, time.monotonic() - t0)

    def warmup_extra_thunks(self) -> list:
        """Thunks capturing the other shapes serving reaches: the
        intermediate N at the first table width, every shape at the wider
        widths, the sampled variants (sampled, and sampled with a top-k /
        top-p / min-p filter) of the default window and of each bucket's N =
        1 and largest N at the first width, and the feature variants at the
        first width (the reference's: windows with penalties, with
        logprobs, and with both; prefill at every bucket and N with
        logprobs, with extras, and with both; and, since sampling is a
        graph flag here, the sampled window and prefill with both), then
        the speculative steps' (``_spec_warmup_thunks``). Each
        runs against the trash page and the drop slot; a serving engine
        runs them one by one between steps (``run_on_engine``)."""
        buckets, widths = self.config.prefill_buckets, self.config.table_buckets
        thunks = []
        for b in buckets:
            for n in self._lane_counts(b)[1:-1]:
                thunks.append(functools.partial(self._warmup_prefill, b, n, widths[0]))
        for width in widths[1:]:
            thunks.append(functools.partial(self._warmup_window, width))
            for b in buckets:
                for n in self._lane_counts(b):
                    thunks.append(functools.partial(self._warmup_prefill, b, n, width))
        for sampling, need_filter in ((SamplingParams(temperature=1.0), False),
                                      (SamplingParams(temperature=1.0, top_k=5), True)):
            thunks.append(functools.partial(self._warmup_window, widths[0], True, need_filter))
            for b in buckets:
                for n in sorted({1, self._lane_counts(b)[-1]}):
                    thunks.append(functools.partial(self._warmup_prefill, b, n, widths[0], sampling))
        extras = SamplingParams(presence_penalty=0.1, min_tokens=1)
        sampled_extras = SamplingParams(temperature=1.0, presence_penalty=0.1, min_tokens=1)
        for sampled, want_lp, with_extras in ((False, False, True), (False, True, False), (False, True, True),
                                              (True, True, True)):
            thunks.append(functools.partial(self._warmup_window, widths[0], sampled, False, want_lp, with_extras))
            sampling = (sampled_extras if sampled else extras) if with_extras else None
            for b in buckets:
                for n in self._lane_counts(b):
                    thunks.append(functools.partial(self._warmup_prefill, b, n, widths[0], sampling, want_lp))
        return thunks + self._spec_warmup_thunks()[1]

    def warmup(self) -> None:
        """Capture every shape synchronously (core + extras)."""
        t0 = time.monotonic()
        self.warmup_core()
        for thunk in self.warmup_extra_thunks():
            thunk()
        log.info("warmup: %d captures in %.1fs", self.compile_monitor.compiles, time.monotonic() - t0)
