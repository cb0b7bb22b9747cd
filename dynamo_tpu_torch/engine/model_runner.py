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

Models with ``prefill_packed`` (Llama) take the packed path when
``prefill_lanes > 1``; the others (DeepSeek), and every model at
``prefill_lanes == 1``, take the reference's per-request path
(``prefill_chunk``: one sequence's chunk per call).

On the card the step bodies are the reference's jitted step functions:
each distinct shape of a decode window and of a prefill call is captured
once into a CUDA graph (``engine/graphs.py``) and replayed after that, its
control arrays and noise copied into static inputs, the KV pools and
``slot_state["tokens"]`` written in place (the reference donates them);
captures are counted by ``compile_monitor``. ``warmup_core`` /
``warmup`` / ``warmup_extra_thunks`` capture the shapes serving reaches
ahead of it, with every write on the trash page. On the CPU the bodies run
eagerly. Penalties, logprobs, LoRA, spec, sp and the KV page export/import
wait.
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
from dynamo_tpu_torch.engine.sampling import SamplingParams, fold_seed, sample_tokens, seeded_uniform
from dynamo_tpu_torch.ops.attention import DECODE_KERNEL_ENV
from dynamo_tpu_torch.utils import get_logger
from dynamo_tpu_torch.utils.compile_monitor import CompileMonitor

log = get_logger("engine.runner")


class HostResult:
    """A device result on its way to the host: the copy into pinned memory
    is enqueued at construction and an event is recorded after it. CPU
    tensors are ready at once."""

    def __init__(self, dev: torch.Tensor):
        if dev.is_cuda:
            self._host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = dev.clone()
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class ModelRunner:
    def __init__(self, config: EngineConfig, model):
        self.config = config
        self.model = model
        self.device = model.device
        self.kv_cache = model.init_kv_cache(config.num_pages, config.page_size)
        B = config.max_seqs
        # token feedback buffer; index B is the drop slot for lanes whose
        # sampled token must not land anywhere (non-final or pad lanes)
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

    # ---------------- host -> device ----------------

    def _stage(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor to copy from: pinned (from torch's
        caching host allocator, reused only after the copy that read it has
        run) when the runner is on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return self._stage(a).to(self.device, non_blocking=True)

    def _noise(self, B: int, seeds: np.ndarray | None, positions: np.ndarray, steps: int, out=None):
        """[steps, B, V] uniforms (into ``out`` when given): the engine
        generator for every slot, rows of seeded slots replaced by their
        (seed, fed position) stream."""
        V = self.model.config.vocab_size
        u = torch.empty((steps, B, V), device=self.device) if out is None else out
        u.uniform_(0.0, 1.0, generator=self._gen)
        if seeds is not None:
            for i in np.flatnonzero(seeds):
                for j in range(steps):
                    u[j, i] = seeded_uniform(int(seeds[i]), int(positions[i]) + j, V, self.device)
        return u

    def _step(self, label: str, key: tuple, body, ints: np.ndarray, flts: np.ndarray, noise_args) -> tuple:
        """Run ``body(ints, flts, noise) -> (tokens, logits)`` on this
        call's arrays: eagerly on the CPU, through the graph of ``key`` on
        the card. ``noise_args`` (B, seeds, positions, steps) or None."""
        if self.graphs is None:
            noise = None if noise_args is None else self._noise(*noise_args)
            return body(self._to_device(ints), self._to_device(flts), noise)

        def make_inputs():
            noise = None
            if noise_args is not None:
                shape = (noise_args[3], noise_args[0], self.model.config.vocab_size)
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

    def _prefill_impl(self, ints, flts, noise, bucket: int, mp: int, need_filter: bool):
        """ints [N, bucket + mp + 4] = token buf, page table, (start_pos,
        n_real, top_k, slot); flts [3, N] = (temperature, top_p, min_p).
        Every lane's last-row logits are sampled; the token lands in
        ``slot_state["tokens"][slot]`` (slot max_seqs = dropped). On the
        packed path the lanes take ``model.prefill_packed``; off it N is 1
        and the lane takes ``model.prefill``. Returns (tokens [N], logits
        [N, V])."""
        tokens = ints[:, :bucket]
        page_tables = ints[:, bucket : bucket + mp]
        start_pos = ints[:, bucket + mp]
        n = ints[:, bucket + mp + 1]
        top_ks = ints[:, bucket + mp + 2]
        slots = ints[:, bucket + mp + 3]
        ar = torch.arange(bucket, dtype=torch.int32, device=ints.device)
        positions = (start_pos[:, None] + ar[None, :]).contiguous()
        valid = ar[None, :] < n[:, None]
        last = (n - 1).clamp(min=0)
        if self.packed_prefill_mode:
            logits, _ = self.model.prefill_packed(
                self.kv_cache, tokens, positions, page_tables.contiguous(), valid, last
            )
        else:
            logits, _ = self.model.prefill(
                self.kv_cache, tokens[0], positions[0], page_tables[0].contiguous(), valid[0], last[0]
            )
            logits = logits[None]
        toks = sample_tokens(
            logits, flts[0], top_ks, flts[1], min_p=flts[2],
            uniform=None if noise is None else noise[0], need_filter=need_filter,
        )
        self.slot_state["tokens"].index_put_((slots.long(),), toks)
        return toks, logits

    def _decode_window_impl(self, ints, flts, noise, num_steps: int, need_filter: bool):
        """num_steps fused decode steps; the token feedback starts from the
        device-resident ``slot_state["tokens"]``. ``ints`` [4 + W, B] =
        positions, limits (max fed position), active, top_ks, then the
        transposed page tables; ``flts`` [3, B] = temps, top_ps,
        min_ps. A slot freezes once its fed position would pass its limit.
        Returns (tokens [num_steps, B], the last step's logits [B, V])."""
        B = ints.shape[1]
        positions = ints[0].contiguous()
        limits = ints[1]
        act = ints[2].bool()
        top_ks = ints[3]
        page_tables = ints[4:].t().contiguous()
        temps, top_ps, min_ps = flts[0], flts[1], flts[2]
        tokens = self.slot_state["tokens"][:B].clone()
        out = torch.empty((num_steps, B), dtype=torch.int32, device=ints.device)
        logits = None
        for step in range(num_steps):
            logits, _ = self.model.decode(self.kv_cache, tokens, positions, page_tables, act)
            toks = sample_tokens(
                logits, temps, top_ks, top_ps, min_p=min_ps,
                uniform=None if noise is None else noise[step], need_filter=need_filter,
            )
            out[step] = toks
            tokens = torch.where(act, toks, tokens)
            positions = positions + act.to(positions.dtype)
            act = act & (positions <= limits)
        self.slot_state["tokens"][:B] = tokens
        return out, logits

    # ---------------- host API (engine thread) ----------------

    def write_token_slots(self, slots: np.ndarray, tokens: np.ndarray) -> None:
        """Host-known tokens -> slot token feedback."""
        idx = self._to_device(np.asarray(slots, np.int64))
        self.slot_state["tokens"].index_put_((idx,), self._to_device(np.asarray(tokens, np.int32)))

    @property
    def packed_prefill_mode(self) -> bool:
        """True when the scheduler packs prefill chunks of several sequences
        into one call (the reference's gate, without its pp/sp terms, which
        the port does not run)."""
        return self.config.prefill_lanes > 1 and hasattr(self.model, "prefill_packed")

    def pack_prefill_lanes(self, lanes: list, N: int):
        """Build the packed int/float control arrays on the host.
        ``lanes``: [(tokens np[int32], start_pos, page_table, slot_or_-1,
        sampling, is_final)]. Returns (ints, flts, mp, sampled, need_filter,
        seeds, sample_pos)."""
        bucket = self.config.bucket_for(max(len(lane[0]) for lane in lanes))
        # the widest lane's ladder bucket; narrow lanes zero-pad into the
        # trash page
        mp = self.config.table_bucket_for(max(len(lane[2]) for lane in lanes))
        ints = np.zeros((N, bucket + mp + 4), np.int32)
        flts = np.zeros((3, N), np.float32)
        flts[1] = 1.0  # top_p neutral
        seeds = np.zeros(N, np.int32)
        sample_pos = np.zeros(N, np.int64)
        sampled = need_filter = False
        for j, (tokens, start_pos, page_table, slot, sampling, is_final) in enumerate(lanes):
            n = len(tokens)
            ints[j, :n] = tokens
            ints[j, bucket : bucket + len(page_table[:mp])] = page_table[:mp]
            ints[j, bucket + mp] = start_pos
            ints[j, bucket + mp + 1] = n
            ints[j, bucket + mp + 2] = sampling.top_k
            ints[j, bucket + mp + 3] = slot if (is_final and slot >= 0) else self.config.max_seqs
            flts[:, j] = (sampling.temperature, sampling.top_p, sampling.min_p)
            if is_final and sampling.temperature > 0:
                sampled = True
                need_filter = need_filter or sampling.needs_filter
                seeds[j] = fold_seed(sampling.seed)
                sample_pos[j] = start_pos + n - 1
        # pad lanes: n=0, start 0, page table 0 (every read lands in the
        # in-bounds trash page), slot out of range so the feedback drops
        ints[len(lanes) :, bucket + mp + 3] = self.config.max_seqs
        return ints, flts, mp, sampled, need_filter, seeds, sample_pos

    @torch.no_grad()
    def prefill_chunk_batch(self, lanes: list, N: int) -> HostResult:
        """Dispatch ONE packed prefill covering chunks of up to N distinct
        sequences. Returns the [N] sampled tokens on their way to the host —
        callers read only final-chunk lanes."""
        ints, flts, mp, sampled, need_filter, seeds, sample_pos = self.pack_prefill_lanes(lanes, N)
        bucket = ints.shape[1] - mp - 4
        noise_args = (N, seeds if seeds.any() else None, sample_pos, 1) if sampled else None
        packed = self.packed_prefill_mode
        label = "prefill_packed" if packed else "prefill"
        key = (label, N, bucket, mp, sampled, need_filter)
        body = functools.partial(self._prefill_impl, bucket=bucket, mp=mp, need_filter=need_filter)
        toks, self.last_logits = self._step(label, key, body, ints, flts, noise_args)
        return HostResult(toks)

    def prefill_chunk(
        self,
        tokens: np.ndarray,  # [n] real tokens for this chunk
        start_pos: int,
        page_table: np.ndarray,  # [ladder width]
        sample: bool,  # the sequence's final chunk: sample its first token
        sampling,  # SamplingParams
        slot: int = -1,  # decode slot to seed with the sampled token (device side)
    ) -> HostResult:
        """The per-request path: dispatch ONE prefill chunk of one sequence
        (``model.prefill``). On the final chunk the sampled token also lands
        in ``slot_state["tokens"][slot]`` on the device. Returns the [1]
        sampled token on its way to the host (read it only when
        ``sample``)."""
        return self.prefill_chunk_batch([(tokens, start_pos, page_table, slot, sampling, sample)], N=1)

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
    ) -> HostResult:
        """Dispatch one fused decode window WITHOUT waiting for results.
        Returns the [num_steps, B] tokens on their way to the host."""
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
                            noise_args, need_filter)

    def _window(self, positions, page_tables, active, limits, temps, top_ks, top_ps, min_ps, num_steps: int,
                noise_args, need_filter: bool) -> HostResult:
        B = positions.shape[0]
        ints = np.empty((4 + page_tables.shape[1], B), np.int32)
        ints[0] = positions
        ints[1] = limits
        ints[2] = active
        ints[3] = top_ks
        ints[4:] = page_tables.T
        flts = np.empty((3, B), np.float32)
        flts[0] = temps
        flts[1] = top_ps
        flts[2] = min_ps
        # the decode kernel is read at capture, as the reference's jit reads
        # it at trace time: a graph per choice
        key = ("decode_window", B, page_tables.shape[1], num_steps, noise_args is not None, need_filter,
               os.environ.get(DECODE_KERNEL_ENV, "lookahead"))
        body = functools.partial(self._decode_window_impl, num_steps=num_steps, need_filter=need_filter)
        toks, self.last_logits = self._step("decode_window", key, body, ints, flts, noise_args)
        return HostResult(toks)

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

    def _warmup_window(self, width: int, sampled: bool = False, need_filter: bool = False) -> None:
        """The default decode window at table width ``width``, every slot
        inactive: its KV rows land on the trash page and the slot tokens
        stay as they are. ``sampled`` draws noise as a sampling slot would
        (so the sampled body is captured without a live slot)."""
        B, K = self.config.max_seqs, self.config.decode_steps
        zeros = np.zeros(B, np.int32)
        temps = np.full(B, 1.0 if sampled else 0.0, np.float32)
        noise_args = (B, None, zeros, K) if sampled else None
        with self._keep_generator():
            self._window(zeros, np.zeros((B, width), np.int32), np.zeros(B, bool), zeros, temps,
                         np.full(B, 5 if need_filter else 0, np.int32), np.ones(B, np.float32),
                         np.zeros(B, np.float32), K, noise_args, need_filter).numpy()

    def _warmup_prefill(self, bucket: int, N: int, width: int, sampling: SamplingParams | None = None) -> None:
        """One prefill call of N lanes at ``bucket`` and table width
        ``width``: one lane of zeros at position 0 over an all-zero table
        (its KV rows land on the trash page), its token dropped (slot -1;
        the pad lanes' too). ``sampling`` samples that token (a final
        lane), else greedy."""
        lane = (np.zeros(bucket, np.int32), 0, np.zeros(width, np.int32), -1,
                sampling or SamplingParams(temperature=0.0), sampling is not None)
        with self._keep_generator():
            if self.packed_prefill_mode:
                self.prefill_chunk_batch([lane], N=N).numpy()
            else:
                self.prefill_chunk(*lane[:3], sample=lane[5], sampling=lane[4], slot=-1).numpy()

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
        default decode window at the first table width, and each prefill
        bucket at N = 1 and N = lanes_for(bucket) (per-request: N = 1)
        there. Every call writes only the trash page."""
        t0 = time.monotonic()
        width = self.config.table_buckets[0]
        self._warmup_window(width)
        for b in self.config.prefill_buckets:
            for n in sorted({1, self._lane_counts(b)[-1]}):
                self._warmup_prefill(b, n, width)
        log.info("warmup(core): %d captures in %.1fs", self.compile_monitor.compiles, time.monotonic() - t0)

    def warmup_extra_thunks(self) -> list:
        """Thunks capturing the other shapes serving reaches: the
        intermediate N at the first table width, every shape at the wider
        widths, and the sampled variants (sampled, and sampled with a
        top-k / top-p / min-p filter) of the default window and of each
        bucket's N = 1 and largest N at the first width. Each runs against
        the trash page; a serving engine runs them one by one between steps
        (``run_on_engine``)."""
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
        return thunks

    def warmup(self) -> None:
        """Capture every shape synchronously (core + extras)."""
        t0 = time.monotonic()
        self.warmup_core()
        for thunk in self.warmup_extra_thunks():
            thunk()
        log.info("warmup: %d captures in %.1fs", self.compile_monitor.compiles, time.monotonic() - t0)
