"""Continuous-batching scheduler: FIFO admission, packed chunked prefill,
dispatch-ahead decode windows (port of ``dynamo_tpu/engine/scheduler.py``).

  - admit waiting requests whenever a decode slot and enough pages exist
    (the watermark keeps headroom for decode growth; free pages include the
    prefix cache's reclaimable ones). Admission allocates through the prefix
    cache: a prompt's leading full blocks already cached are shared, and its
    prefill starts at ``cached_len``, which the first output reports as
    ``cached_tokens``
  - prefill chunks of distinct sequences pack into shared prefill calls
    (one weight pass each) when ``runner.packed_prefill_mode``; otherwise
    each call carries one sequence's chunk (the reference's per-request
    ``run_prefill_chunks`` through ``runner.prefill_chunk``). Either way
    calls dispatch ahead up to ``prefill_pipeline_depth``
  - decode runs as fused K-step windows dispatched ahead of result
    materialization (``pipeline_depth`` windows in flight): the sampled-token
    feedback lives on the device, so the host never waits between windows.
    Results reconcile in dispatch order; EOS is therefore found up to
    pipeline_depth * K steps late

Every dispatch records its step anatomy (``utils/step_anatomy.py``) at the
reference's seams: host prep and dispatch where a prefill call or a decode
window is dispatched (a ``prefill_packed`` / ``prefill_chunk`` /
``decode_window`` record, with its tokens and its roofline floor), the
device wait and the reconcile where its results are read back.

Prefix-cache registration follows the reference: a sequence's prompt
blocks are committed (``allocator.commit_prefilled``) when its final prefill
chunk is dispatched, and every materialized token goes through
``allocator.append_token``, which registers a decode-written block one
token after it fills.

Penalties, ``min_tokens`` and logprobs are the reference's: a penalty
request's slot state is seeded at admission (``runner.seed_penalty_slot``);
prefill lanes carry each request's EOS ids, decode windows the per-slot
penalties, EOS rows and ``eos_allowed_from``; a request with ``logprobs``
gets its chosen-token logprob and its top ``logprobs`` alternatives in
``StepOutput.logprob`` / ``top_logprobs``; EOS stops a stream only past
``min_tokens`` tokens.

Scheduled-vs-materialized positions: ``seq.sched_len`` counts tokens in the
*scheduled* timeline (the prefill's first token + every window step), while
``seq.generated`` holds materialized tokens only.

The request dataclasses keep the reference's field names; fields of features
this port does not run yet stay at their defaults, and requests that ask for
them (images, LoRA) are rejected at admission. ``cancel`` takes the
engine's submission number too, so an ended stream cannot cancel a later
request that reuses its id (the reference cancels by id alone). Not ported
yet: QoS, preemption (a sequence that cannot grow gets a shorter window, or
finishes with "error" when it cannot advance), spec, LoRA, prefix
fetch/migration, offload, metering and the stage/metric planes.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.engine.sampling import MAX_EOS_IDS, SamplingParams, fold_seed
from dynamo_tpu_torch.utils import get_logger
from dynamo_tpu_torch.utils.step_anatomy import StepAnatomy, roofline_for_runner

log = get_logger("engine.sched")


@dataclass
class EngineRequest:
    """Tokens-in/tokens-out request (the reference's ExecutionContext contract)."""

    request_id: str
    token_ids: list[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_token_ids: tuple[int, ...] = ()
    images: list = field(default_factory=list)
    mm_embeds: Optional[list] = None
    logprobs: Optional[int] = None
    mrope_pos: Optional[object] = None
    mrope_delta: int = 0
    penalty_output_from: Optional[int] = None
    # monotonic submission time (TTFT zero point), stamped by the engine
    enqueue_ts: float = 0.0
    trace_id: Optional[str] = None
    kv_holder_addr: str = ""
    kv_holder_blocks: int = 0
    kv_handoff_seq: str = ""
    lora_name: str = ""
    tenant: str = ""
    scenario: str = ""
    priority: str = ""
    cost_admitted: bool = False
    # the engine's number for this submission (0: not submitted through an
    # engine); a cancel that names it leaves other submissions of the id be
    submission: int = 0


@dataclass
class StepOutput:
    request_id: str
    token: Optional[int] = None
    finished: bool = False
    finish_reason: Optional[str] = None  # stop | length | error
    cached_tokens: int = 0  # prefix-cache hit length (first output only)
    logprob: Optional[float] = None  # chosen-token logprob (when requested)
    top_logprobs: Optional[list] = None  # [(token_id, logprob), ...]


@dataclass
class RunningSeq:
    req: EngineRequest
    slot: int
    prompt_len: int
    cached_len: int
    generated: list[int] = field(default_factory=list)  # materialized tokens
    page_table: np.ndarray = None  # [ladder width]
    admitted_order: int = 0
    sched_len: int = 0  # tokens in the scheduled timeline (>= len(generated))
    finished: bool = False
    # packed-prefill progress: next chunk start, or None when all chunks are
    # dispatched (decode windows only pick up seqs with prefill_pos None)
    prefill_pos: Optional[int] = None
    spec_mode: bool = False
    ngram: Optional[object] = None
    draft_pos: Optional[int] = None
    draft_dead: bool = False
    fetch: Optional[object] = None
    migrating: bool = False
    lora_slot: int = 0
    queue_wait_s: Optional[float] = None
    first_token_wall: float = 0.0
    last_token_wall: float = 0.0
    itl_gaps: list = field(default_factory=list)

    @property
    def pos(self) -> int:
        """Materialized position of the next token to be decoded."""
        return self.prompt_len + len(self.generated)

    @property
    def next_fed_pos(self) -> int:
        """Position where the next scheduled window's first KV write lands."""
        return self.prompt_len + self.sched_len - 1


@dataclass
class _InFlight:
    kind: str  # "first_batch" | "window"
    dev: object  # model_runner.HostResult
    # first_batch: [(seq, lane, cached_len)]; window: [(seq, slot_idx, steps)]
    seqs: list = field(default_factory=list)
    # step-anatomy record of the dispatch: the reconcile's device wait and
    # emission time attribute back to it
    rec: object = None
    # the result carries logprob arrays (dev.numpy() is then (tokens,
    # chosen, top ids, top logprobs))
    lp: bool = False


def _unsupported(req: EngineRequest) -> Optional[str]:
    """Name of a requested feature this port does not run yet, or None."""
    if req.images:
        return "images"
    if req.lora_name:
        return "lora"
    return None


class Scheduler:
    def __init__(self, config: EngineConfig, runner, allocator: PageAllocator):
        self.config = config
        self.runner = runner
        self.allocator = allocator
        self.waiting: deque[EngineRequest] = deque()
        self.slots: list[Optional[RunningSeq]] = [None] * config.max_seqs
        self.in_flight: deque[_InFlight] = deque()
        self._admit_counter = 0
        # per-dispatch host/device phases and the live roofline
        self.anatomy = StepAnatomy(roofline=roofline_for_runner(runner, config))

    # ---------------- queue ----------------

    def add_request(self, req: EngineRequest) -> None:
        self.waiting.append(req)

    @property
    def num_running(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.in_flight) or any(s is not None for s in self.slots)

    def cancel(self, request_id: str, submission: int | None = None) -> bool:
        """Cancel the request ``request_id`` (only its submission
        ``submission`` when given)."""

        def match(req: EngineRequest) -> bool:
            return req.request_id == request_id and (submission is None or req.submission == submission)

        for s in self.slots:
            if s is not None and match(s.req):
                self._release(s)
                return True
        for req in list(self.waiting):
            if match(req):
                self.waiting.remove(req)
                return True
        return False

    # ---------------- main loop step ----------------

    def step(self) -> list[StepOutput]:
        outputs: list[StepOutput] = []
        outputs.extend(self._reconcile(block=False))
        outputs.extend(self._admit())
        dispatched = self._dispatch_prefill_batches(outputs)
        dispatched += self._dispatch_windows(outputs)
        pipeline_full = self._windows_in_flight() >= max(1, self.config.pipeline_depth)
        if pipeline_full or (self.in_flight and not dispatched and not outputs):
            outputs.extend(self._reconcile(block=True))
        return outputs

    def _windows_in_flight(self) -> int:
        return sum(1 for e in self.in_flight if e.kind == "window")

    def _prefills_in_flight(self) -> int:
        return sum(1 for e in self.in_flight if e.kind == "first_batch")

    # ---------------- page-table ladder ----------------

    def _new_table(self, pages: list[int]) -> np.ndarray:
        """Page table at the sequence's current ladder width."""
        table = np.zeros(self.config.table_bucket_for(max(1, len(pages))), np.int32)
        table[: len(pages)] = pages
        return table

    def _refresh_table(self, seq: RunningSeq) -> None:
        """Re-sync a sequence's table from the allocator, promoting it to
        the next ladder rung when its pages outgrew the current width."""
        pages = self.allocator._seqs[seq.req.request_id].pages
        if len(pages) > len(seq.page_table):
            seq.page_table = np.zeros(self.config.table_bucket_for(len(pages)), np.int32)
        seq.page_table[: len(pages)] = pages

    # ---------------- admission ----------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit(self) -> list[StepOutput]:
        """FIFO admission while a slot and pages (above the watermark) exist."""
        outputs = []
        watermark_pages = int(self.config.watermark * self.config.num_pages)
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.waiting[0]
            why = None
            if len(req.token_ids) > self.config.max_model_len:
                why = "oversized prompt"
            elif not req.token_ids:
                why = "empty prompt"
            else:
                why = _unsupported(req)
            if why is not None:
                self.waiting.popleft()
                log.warning("rejecting %s: %s", req.request_id, why)
                outputs.append(StepOutput(req.request_id, finished=True, finish_reason="error"))
                continue
            pages_needed = -(-len(req.token_ids) // self.config.page_size)
            if self.allocator.free_pages < pages_needed + watermark_pages:
                break
            self.waiting.popleft()
            try:
                self._start_sequence(req, slot)
            except MemoryError:
                self.waiting.appendleft(req)
                break
        return outputs

    def _start_sequence(self, req: EngineRequest, slot: int) -> None:
        wait = max(0.0, time.monotonic() - req.enqueue_ts) if req.enqueue_ts else None
        cached_len, state = self.allocator.allocate_sequence(req.request_id, req.token_ids)
        sam = req.sampling
        if sam.min_tokens >= 1 and not sam.ignore_eos and len(req.eos_token_ids) > MAX_EOS_IDS:
            log.warning("min_tokens: %d EOS ids exceed the device limit %d for %s; the excess are not "
                        "suppressed on device", len(req.eos_token_ids), MAX_EOS_IDS, req.request_id)
        if sam.needs_penalties:
            # enqueued before the request's prefill, which reads the slot's state
            self.runner.seed_penalty_slot(slot, req.token_ids, output_from=req.penalty_output_from)
        self.slots[slot] = RunningSeq(
            req=req,
            slot=slot,
            prompt_len=len(req.token_ids),
            cached_len=cached_len,
            page_table=self._new_table(state.pages),
            admitted_order=self._admit_counter,
            sched_len=1,  # the prefill's sampled token enters the timeline now
            prefill_pos=cached_len,
            queue_wait_s=wait,
        )
        self._admit_counter += 1

    # ---------------- prefill (packed or per request) ----------------

    def _dispatch_prefill_batches(self, outputs: list[StepOutput]) -> int:
        """Pack pending prefill chunks of distinct sequences into shared
        prefill calls (one weight pass per call), or, off the packed path,
        one sequence's chunk per call. Each sequence contributes at most one
        chunk per call (chunk i+1 reads the pages chunk i wrote).

        At most ``prefill_batches_per_step`` calls per invocation while
        decode work is running, and at most ``prefill_pipeline_depth``
        unreconciled prefill calls at any time."""
        count = 0
        cap = self.config.prefill_batches_per_step
        depth = max(1, self.config.prefill_pipeline_depth)
        decode_running = any(
            s is not None and not s.finished and s.prefill_pos is None for s in self.slots
        )
        packed = self.runner.packed_prefill_mode
        while True:
            if cap and decode_running and count >= cap:
                return count
            while self._prefills_in_flight() >= depth:
                if depth > 1:
                    outputs.extend(self._reconcile(block=False))
                    if self._prefills_in_flight() < depth:
                        break
                outputs.extend(self._reconcile(block=True))
            t_prep = time.monotonic()
            pending = sorted(
                (s for s in self.slots
                 if s is not None and not s.finished and s.prefill_pos is not None),
                key=lambda s: s.admitted_order,
            )
            if not pending:
                return count
            # greedy bucket-aware packing in admission order: grow the lane
            # set while every taken lane still fits the bucket's row budget
            limit = self.config.max_prefill_chunk
            chunks = []
            bucket = 0
            for s in pending:
                end = min(s.prefill_pos + limit, s.prompt_len)
                cand = self.config.bucket_for(max(bucket, end - s.prefill_pos))
                if chunks and (not packed or len(chunks) + 1 > self.config.lanes_for(cand)):
                    break
                chunks.append((s, s.prefill_pos, end))
                bucket = cand
            lanes, finals = [], []
            want_lp = False
            for j, (seq, start, end) in enumerate(chunks):
                is_final = end == seq.prompt_len
                lanes.append((
                    np.asarray(seq.req.token_ids[start:end], np.int32),
                    start,
                    seq.page_table,
                    seq.slot,
                    seq.req.sampling,
                    () if seq.req.sampling.ignore_eos else seq.req.eos_token_ids,
                    is_final,
                ))
                if is_final:
                    finals.append((seq, j, seq.cached_len))
                    want_lp = want_lp or seq.req.logprobs is not None
            rows = sum(end - start for _, start, end in chunks)
            rec = self.anatomy.begin("prefill_packed" if packed else "prefill_chunk", ts=t_prep)
            t0 = time.monotonic()
            self.anatomy.add_phase(rec, "host_prep", t0 - t_prep)
            try:
                if packed:
                    # N rounds up to a power of two (at most log2(lanes) shapes per bucket)
                    N = min(self.config.lanes_for(bucket), 1 << (len(chunks) - 1).bit_length())
                    result = self.runner.prefill_chunk_batch(lanes, N=N, want_logprobs=want_lp)
                else:
                    tokens, start, table, slot, sampling, eos_ids, is_final = lanes[0]
                    result = self.runner.prefill_chunk(
                        tokens, start, table, sample=is_final, sampling=sampling, slot=slot, eos_ids=eos_ids,
                        want_logprobs=want_lp,
                    )
            except Exception:
                log.exception(
                    "prefill failed for %s", [seq.req.request_id for seq, _, _ in chunks]
                )
                for seq, _, _ in chunks:
                    outputs.extend(self._finish(seq, "error"))
                continue
            self.anatomy.add_phase(rec, "dispatch", time.monotonic() - t0)
            self.anatomy.note_steps(rec, tokens=rows, participants=len(chunks))
            self.anatomy.note_prefill_floor(rec, rows)
            for seq, start, end in chunks:
                if end == seq.prompt_len:
                    # the prompt's blocks join the prefix cache now, before
                    # this call has run: a request admitted next may read
                    # them in a prefill enqueued behind it. Sound because
                    # every page write and read (graph replays included) is
                    # on one CUDA stream, in dispatch order
                    self.allocator.commit_prefilled(seq.req.request_id, seq.prompt_len)
                    seq.prefill_pos = None
                else:
                    seq.prefill_pos = end
            self.in_flight.append(_InFlight(kind="first_batch", dev=result, seqs=finals, rec=rec, lp=want_lp))
            count += 1

    # ---------------- decode windows ----------------

    def _dispatch_windows(self, outputs: list[StepOutput]) -> int:
        count = 0
        while self._windows_in_flight() < max(1, self.config.pipeline_depth):
            if not self._dispatch_one_window(outputs):
                break
            count += 1
        return count

    def _plan_steps(self, seq: RunningSeq, K: int) -> int:
        """Steps this window can run for `seq` before budget/length bounds."""
        if seq.prefill_pos is not None:
            return 0  # prefill chunks still pending; no sampled token yet
        budget = seq.req.sampling.max_tokens - seq.sched_len
        length = self.config.max_model_len - seq.next_fed_pos
        return max(0, min(K, budget, length))

    def _capacity(self, seq: RunningSeq) -> int:
        return self.allocator._seqs[seq.req.request_id].num_pages * self.config.page_size

    def _dispatch_one_window(self, outputs: list[StepOutput]) -> bool:
        t_prep = time.monotonic()
        K = max(1, self.config.decode_steps)

        # capacity pass: every participant needs pages for its planned writes
        # (fed positions next_fed_pos .. next_fed_pos + steps - 1); page
        # tables are static inside the window
        for seq in sorted((s for s in self.slots if s is not None), key=lambda s: s.admitted_order):
            steps = self._plan_steps(seq, K)
            if steps <= 0:
                continue
            need = seq.next_fed_pos + steps
            while self.slots[seq.slot] is seq and not self.allocator.ensure_capacity(
                seq.req.request_id, need
            ):
                if self.in_flight:
                    # page pressure: drain the pipeline (EOS may free pages)
                    outputs.extend(self._reconcile(block=True, drain=True))
                    continue
                if self._capacity(seq) <= seq.next_fed_pos:
                    # no preemption yet: a sequence that cannot advance fails
                    outputs.extend(self._finish(seq, "error"))
                break  # otherwise a shorter window; limits[] freezes at capacity
            if self.slots[seq.slot] is seq:
                self._refresh_table(seq)

        participants = []
        for seq in self.slots:
            if seq is None or seq.finished:
                continue
            steps = min(self._plan_steps(seq, K), self._capacity(seq) - seq.next_fed_pos)
            if steps > 0:
                participants.append((seq, steps))
        if not participants:
            return False

        B = self.config.max_seqs
        # the widest participant's ladder rung
        W = self.config.table_bucket_for(max(len(seq.page_table) for seq, _ in participants))
        positions = np.zeros(B, np.int32)
        page_tables = np.zeros((B, W), np.int32)
        active = np.zeros(B, bool)
        limits = np.zeros(B, np.int32)
        temps = np.zeros(B, np.float32)
        top_ks = np.zeros(B, np.int32)
        top_ps = np.ones(B, np.float32)
        min_ps = np.zeros(B, np.float32)
        penalties = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, B))
        seeds = np.zeros(B, np.int32)
        eos_allowed_from = np.zeros(B, np.int32)
        eos_rows = np.full((B, MAX_EOS_IDS), self.runner.model.config.vocab_size, np.int32)
        any_eos_mask = False
        snapshot = []
        for seq, steps in participants:
            i = seq.slot
            sam = seq.req.sampling
            positions[i] = seq.next_fed_pos
            page_tables[i, : len(seq.page_table)] = seq.page_table
            active[i] = True
            limits[i] = seq.next_fed_pos + steps - 1  # max fed position
            temps[i] = sam.temperature
            top_ks[i] = sam.top_k
            top_ps[i] = sam.top_p
            min_ps[i] = sam.min_p
            penalties[:, i] = (sam.presence_penalty, sam.frequency_penalty, sam.repetition_penalty)
            seeds[i] = fold_seed(sam.seed)
            if sam.min_tokens > 1 and seq.req.eos_token_ids and not sam.ignore_eos:
                # the step sampling generation #k feeds position prompt_len
                # + k - 2 (the prefill sampled #1); EOS stays banned while
                # sampling #k for k <= min_tokens, so it unblocks at fed
                # position prompt_len + min_tokens - 1
                eos_allowed_from[i] = seq.prompt_len + sam.min_tokens - 1
                ids = np.asarray(seq.req.eos_token_ids[:MAX_EOS_IDS], np.int32)
                eos_rows[i, : len(ids)] = ids
                any_eos_mask = True
            snapshot.append((seq, i, steps))
            seq.sched_len += steps
        want_lp = any(seq.req.logprobs is not None for seq, _ in participants)
        want_pen = any(seq.req.sampling.needs_penalties for seq, _ in participants)
        # every step reads the weights and each participant's KV pages: the
        # bytes-moved floor at this occupancy
        live_pages = sum(
            self.allocator._seqs[seq.req.request_id].num_pages
            for seq, _ in participants if seq.req.request_id in self.allocator._seqs
        )
        rec = self.anatomy.begin("decode_window", ts=t_prep)
        t0 = time.monotonic()
        self.anatomy.add_phase(rec, "host_prep", t0 - t_prep)
        result = self.runner.dispatch_decode_window(
            positions, page_tables, active, limits, temps, top_ks, top_ps, K,
            min_ps=min_ps, seeds=seeds if np.any(seeds) else None, want_logprobs=want_lp,
            penalties=penalties if want_pen else None,
            eos_allowed_from=eos_allowed_from if any_eos_mask else None,
            eos_ids=eos_rows if any_eos_mask else None,
        )
        self.anatomy.add_phase(rec, "dispatch", time.monotonic() - t0)
        self.anatomy.note_steps(
            rec, steps=K, tokens=sum(steps for _, _, steps in snapshot), participants=len(snapshot),
            floor_bytes=self.anatomy.decode_floor_bytes(live_pages, K),
        )
        self.in_flight.append(_InFlight(kind="window", dev=result, seqs=snapshot, rec=rec, lp=want_lp))
        return True

    # ---------------- results ----------------

    def _reconcile(self, block: bool, drain: bool = False) -> list[StepOutput]:
        """Materialize arrived results in dispatch order and emit tokens.

        block: wait for (at least) the oldest entry. drain: wait for all."""
        outputs: list[StepOutput] = []
        while self.in_flight:
            entry = self.in_flight[0]
            # the reference's _is_ready: the CUDA event recorded after the
            # result's device-to-host copy (CPU results are always ready)
            ready = entry.dev.is_ready()
            if not (block or drain) and not ready:
                break
            self.in_flight.popleft()
            t0 = time.monotonic()
            data = entry.dev.numpy()
            lp = None
            if entry.lp:
                data, *lp = data
            if not ready:  # the host blocked on the device
                self.anatomy.add_phase(entry.rec, "device_wait", time.monotonic() - t0)
            t_rec = time.monotonic()
            block = False
            if entry.kind == "first_batch":
                for seq, lane, cached in entry.seqs:
                    if not seq.finished:
                        step_lp = None if lp is None else (lp[0][lane], lp[1][lane], lp[2][lane])
                        outputs.extend(self._emit_token(seq, int(data[lane]), cached=cached, lp=step_lp))
            else:
                for seq, slot_idx, steps in entry.seqs:
                    for j in range(min(steps, data.shape[0])):
                        if seq.finished:
                            break  # EOS/cancel discovered earlier; zombie tokens
                        step_lp = None if lp is None else (lp[0][j, slot_idx], lp[1][j, slot_idx],
                                                           lp[2][j, slot_idx])
                        outputs.extend(self._emit_token(seq, int(data[j, slot_idx]), lp=step_lp))
            # emitting this entry's tokens attributes back to its dispatch
            self.anatomy.add_phase(entry.rec, "reconcile", time.monotonic() - t_rec)
        return outputs

    def _emit_token(self, seq: RunningSeq, token: int, cached: int = 0, lp=None) -> list[StepOutput]:
        if seq.finished:
            return []
        req = seq.req
        seq.generated.append(token)
        now = time.monotonic()
        if len(seq.generated) == 1:
            seq.first_token_wall = now
        else:
            seq.itl_gaps.append(max(0.0, now - seq.last_token_wall))
        seq.last_token_wall = now
        seq.sched_len = max(seq.sched_len, len(seq.generated))
        self.allocator.append_token(req.request_id, token)
        finish: Optional[str] = None
        if (
            not req.sampling.ignore_eos
            and req.eos_token_ids
            and token in req.eos_token_ids
            and len(seq.generated) > req.sampling.min_tokens
        ):
            finish = "stop"
        elif len(seq.generated) >= req.sampling.max_tokens:
            finish = "length"
        elif seq.pos >= self.config.max_model_len:
            finish = "length"
        out = StepOutput(req.request_id, token=token, cached_tokens=cached)
        if lp is not None and req.logprobs is not None:
            chosen, top_ids, top_vals = lp
            out.logprob = float(chosen)
            n = min(req.logprobs, len(top_ids))
            if n > 0:
                out.top_logprobs = [(int(top_ids[i]), float(top_vals[i])) for i in range(n)]
        if finish is not None:
            out.finished = True
            out.finish_reason = finish
            self._release(seq)
        return [out]

    def _finish(self, seq: RunningSeq, reason: str) -> list[StepOutput]:
        self._release(seq)
        return [StepOutput(seq.req.request_id, finished=True, finish_reason=reason)]

    def _release(self, seq: RunningSeq) -> None:
        seq.finished = True
        self.allocator.free_sequence(seq.req.request_id)
        if self.slots[seq.slot] is seq:
            self.slots[seq.slot] = None
