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

PyTorch runs eagerly: the reference's jitted step functions are plain
methods here. CUDA graphs, penalties, logprobs, LoRA, spec, sp and the KV
page export/import wait.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.sampling import fold_seed, sample_tokens, seeded_uniform
from dynamo_tpu_torch.utils import get_logger

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

    # ---------------- host -> device ----------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        # pinned staging block from torch's caching host allocator (reused
        # only after the copy that read it has run)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _noise(self, B: int, seeds: np.ndarray | None, positions: np.ndarray, steps: int):
        """[steps, B, V] uniforms: the engine generator for every slot, rows
        of seeded slots replaced by their (seed, fed position) stream."""
        V = self.model.config.vocab_size
        u = torch.rand((steps, B, V), generator=self._gen, device=self.device)
        if seeds is not None:
            for i in np.flatnonzero(seeds):
                for j in range(steps):
                    u[j, i] = seeded_uniform(int(seeds[i]), int(positions[i]) + j, V, self.device)
        return u

    # ---------------- step bodies (device work only) ----------------

    def _prefill_impl(self, ints, flts, bucket: int, mp: int, noise, need_filter: bool):
        """ints [N, bucket + mp + 4] = token buf, page table, (start_pos,
        n_real, top_k, slot); flts [3, N] = (temperature, top_p, min_p).
        Every lane's last-row logits are sampled; the token lands in
        ``slot_state["tokens"][slot]`` (slot max_seqs = dropped). On the
        packed path the lanes take ``model.prefill_packed``; off it N is 1
        and the lane takes ``model.prefill``."""
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
        return toks

    def _decode_window_impl(self, ints, flts, num_steps: int, noise, need_filter: bool):
        """num_steps fused decode steps; the token feedback starts from the
        device-resident ``slot_state["tokens"]``. ``ints`` [4 + W, B] =
        positions, limits (max fed position), active, top_ks, then the
        transposed page tables; ``flts`` [3, B] = temps, top_ps,
        min_ps. A slot freezes once its fed position would pass its limit."""
        B = ints.shape[1]
        positions = ints[0].contiguous()
        limits = ints[1]
        act = ints[2].bool()
        top_ks = ints[3]
        page_tables = ints[4:].t().contiguous()
        temps, top_ps, min_ps = flts[0], flts[1], flts[2]
        tokens = self.slot_state["tokens"][:B].clone()
        out = torch.empty((num_steps, B), dtype=torch.int32, device=ints.device)
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
        return out

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
        noise = (
            self._noise(N, seeds if seeds.any() else None, sample_pos, 1) if sampled else None
        )
        toks = self._prefill_impl(
            self._to_device(ints), self._to_device(flts), bucket, mp, noise, need_filter
        )
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
        ints = np.empty((4 + page_tables.shape[1], B), np.int32)
        ints[0] = positions
        ints[1] = limits
        ints[2] = active
        ints[3] = top_ks
        ints[4:] = page_tables.T
        flts = np.empty((3, B), np.float32)
        flts[0] = temps
        flts[1] = top_ps
        flts[2] = min_ps if min_ps is not None else 0.0
        live = active & (temps > 0)
        noise = None
        if live.any():
            seeded = seeds if seeds is not None and np.any(seeds[live]) else None
            if seeded is not None:
                seeded = np.where(live, seeded, 0)
            noise = self._noise(B, seeded, positions, num_steps)
        need_filter = bool(np.any(live & ((top_ks > 0) | (top_ps < 1.0) | (flts[2] > 0))))
        toks = self._decode_window_impl(
            self._to_device(ints), self._to_device(flts), num_steps, noise, need_filter
        )
        return HostResult(toks)
