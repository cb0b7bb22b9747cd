"""Continuous-batching scheduler: priority-class admission, packed chunked
prefill, dispatch-ahead decode windows, preemption under page pressure (port
of ``dynamo_tpu/engine/scheduler.py``).

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
    calls dispatch ahead up to ``prefill_pipeline_depth``. Each chunk's
    length comes from the depth-aware planner (``config.chunk_len_for``:
    shorter chunks deep into a long prompt, longer ones under a deep
    backlog on the packed path); it returns prefill buckets only, so it
    asks for no graph shape the warmup did not capture
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

Speculative decoding (``config.speculative``) is the reference's spec
round: a request without penalties, logprobs or ``min_tokens`` is in spec
mode from admission and never rides a decode window; each step proposes up
to k drafts for every spec-mode sequence (its n-gram index, or one batched
draft-model step, ``runner.dispatch_draft``), verifies them in ONE
multi-query pass (``runner.dispatch_verify``) and emits the accepted prefix
and the correction / bonus token. Rounds are synchronous. The counters keep
the reference's names (``stage.spec_*``), and the step anatomy records
``spec_draft`` and ``spec_verify`` dispatches, a verify round at the
decode floor of one weight pass.

Page pressure follows the reference's ladder, in the window capacity pass
and the spec round alike: drain the pipeline (EOS may free pages), then
preempt a victim (``_pick_victim``: most recently admitted, or lowest
priority class first under ``config.qos``), then run a shorter window (a
truncated proposal), and finish with "error" only when no victim is left
and the sequence cannot advance at all. Every caller of ``_preempt`` drains
the pipeline first: a queued graph replay still writes the pages a
sequence holds. ``_preempt`` requeues the request at the front of the
waiting queue with prompt + generated tokens, the remaining ``max_tokens``
and ``min_tokens``, the original ``enqueue_ts``, ``penalty_output_from``,
its tenant, class, logprobs and submission number; its full blocks come
back from the prefix cache and only the tail is prefilled again.

Multi-tenant QoS (``config.qos``, ``utils/qos.py``): admission takes the
first waiting request of the highest class present (FIFO within a class),
a start consumes ``1 / priority_weight`` of the per-step fairness cap off
the packed path, and a critical request that has waited
``qos_preempt_wait_ms`` with no free slot preempts the lowest-class, most
recent lane (``_shed_for_critical``; the reference's live-migration shed
needs a peer, which the port does not have yet, so the shed always
preempts).

The request dataclasses keep the reference's field names; fields of features
this port does not run yet stay at their defaults, and requests that ask for
them (images, LoRA) are rejected at admission, so there is no adapter to
release on preemption. ``cancel`` takes the engine's submission number
too, so an ended stream cannot cancel a later request that reuses its id
(the reference cancels by id alone); a preempted request keeps its number.
Not ported yet: LoRA, prefix fetch/migration, offload, metering, the events
journal and the stage/metric planes (of the reference's ``StageStats`` only
the spec counters).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.engine.sampling import MAX_EOS_IDS, SamplingParams, fold_seed
from dynamo_tpu_torch.spec import make_proposer
from dynamo_tpu_torch.utils import get_logger
from dynamo_tpu_torch.utils.qos import priority_rank, priority_weight
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


@dataclass
class StageStats:
    """The reference's ``StageStats`` speculative counters (spec rounds are
    synchronous verify passes, so dispatch and device wait land in one
    number): draft tokens proposed, drafts accepted, tokens emitted
    (accepted + each round's correction / bonus token), and the draft
    model's batched steps and per-sequence draft prefills."""

    spec_rounds: int = 0
    spec_dispatch_s: float = 0.0
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_emitted: int = 0
    spec_draft_calls: int = 0
    spec_draft_s: float = 0.0
    spec_draft_prefills: int = 0
    spec_draft_prefill_s: float = 0.0


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
        self.stage = StageStats()
        self.spec = config.spec
        self.proposer = make_proposer(self.spec) if self.spec is not None else None
        self.preempt_count = 0  # sequences bounced back to waiting (page pressure)
        self.pressure_drain_count = 0  # pipeline drains forced by ensure_capacity misses
        # multi-tenant QoS: preemption victims per class, and critical-
        # triggered sheds (a waiting critical request evicting a lower lane)
        self.qos_preempted: dict[str, int] = {}
        self.qos_sheds = 0

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
        if self.spec is not None:
            dispatched += self._dispatch_spec_round(outputs)
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
        """Admission in class order (``_next_waiting_index``) while a slot
        and pages (above the watermark) exist. Off the packed path a start
        counts against the per-step fairness cap like a packed call does
        (weighted by its class under QoS), so a burst cannot queue all its
        prefill ahead of running decode windows."""
        outputs = []
        watermark_pages = int(self.config.watermark * self.config.num_pages)
        cap = self.config.prefill_batches_per_step
        decode_running = any(
            s is not None and not s.finished and s.prefill_pos is None for s in self.slots
        )
        packed = self.runner.packed_prefill_mode
        started = 0.0
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                # a waiting critical request may evict a lower-class lane
                if not self._shed_for_critical(outputs):
                    break
                slot = self._free_slot()
                if slot is None:
                    break
            idx = self._next_waiting_index()
            req = self.waiting[idx]
            # rejections are host work only: they go before the fairness cap
            why = None
            if len(req.token_ids) > self.config.max_model_len:
                why = "oversized prompt"
            elif not req.token_ids:
                why = "empty prompt"
            else:
                why = _unsupported(req)
            if why is not None:
                del self.waiting[idx]
                log.warning("rejecting %s: %s", req.request_id, why)
                outputs.append(StepOutput(req.request_id, finished=True, finish_reason="error"))
                continue
            if cap and decode_running and started >= cap and not packed:
                break
            pages_needed = -(-len(req.token_ids) // self.config.page_size)
            if self.allocator.free_pages < pages_needed + watermark_pages:
                break
            del self.waiting[idx]
            try:
                self._start_sequence(req, slot)
                # a start consumes 1 / weight cap units: a critical burst
                # starts more per step than batch work at the same cap
                started += 1.0 / priority_weight(req.priority) if self.config.qos else 1.0
            except MemoryError:
                self.waiting.appendleft(req)
                break
        return outputs

    # ---------------- multi-tenant QoS (utils/qos.py) ----------------

    def _next_waiting_index(self) -> int:
        """The first waiting request of the highest class present (FIFO
        within a class); plain FIFO with QoS off."""
        if not self.config.qos or len(self.waiting) < 2:
            return 0
        best_i, best_rank = 0, priority_rank(self.waiting[0].priority)
        for i, req in enumerate(self.waiting):
            if i == 0:
                continue
            r = priority_rank(req.priority)
            if r < best_rank:
                best_i, best_rank = i, r
                if r == 0:
                    break
        return best_i

    def _shed_for_critical(self, outputs: list[StepOutput]) -> bool:
        """A critical request waiting (no free slot) past the
        ``qos_preempt_wait_ms`` gate preempts the lowest-class, most recent
        running lane; never a critical one. Returns True when a slot was
        freed."""
        if not self.config.qos or not self.waiting:
            return False
        req = self.waiting[self._next_waiting_index()]
        if priority_rank(req.priority) != 0:
            return False
        if req.enqueue_ts and time.monotonic() - req.enqueue_ts < self.config.qos_preempt_wait_ms / 1e3:
            return False  # transient full house: don't thrash lanes
        victims = [
            s for s in self.slots
            if s is not None and not s.finished and priority_rank(s.req.priority) > 0
        ]
        if not victims:
            return False
        victim = max(victims, key=lambda s: (priority_rank(s.req.priority), s.admitted_order))
        self.qos_sheds += 1
        # the preempt contract: drain, so victim.generated is complete and
        # no queued replay writes its pages after they are freed
        if self.in_flight:
            outputs.extend(self._reconcile(block=True, drain=True))
        if victim.finished or self.slots[victim.slot] is not victim:
            return self._free_slot() is not None  # the drain finished it anyway
        log.info("QoS shed: preempting %s (%s) for waiting critical %s",
                 victim.req.request_id, victim.req.priority or "standard", req.request_id)
        self._preempt(victim)
        return True

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
            spec_mode=self._spec_eligible(req),
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
            # set while every taken lane still fits the bucket's row budget.
            # Each lane's chunk is depth-aware (chunk_len_for); on the packed
            # path a deep backlog promotes the bucket (the reference's
            # per-request chain plans with no backlog)
            backlog_rows = sum(s.prompt_len - s.prefill_pos for s in pending) if packed else 0
            chunks = []
            bucket = 0
            for s in pending:
                limit = self.config.chunk_len_for(s.prefill_pos, backlog_rows=backlog_rows)
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

    # ---------------- speculative decode (spec rounds) ----------------

    def _spec_eligible(self, req: EngineRequest) -> bool:
        """Spec mode, fixed at admission: penalties and logprobs need the
        window path's per-slot device state and min_tokens its EOS masking,
        so those requests ride decode windows (correct, not speculated)."""
        if self.spec is None:
            return False
        s = req.sampling
        return not req.images and req.logprobs is None and not s.needs_penalties and s.min_tokens <= 0

    def _propose_ngram(self, seq: RunningSeq, max_d: int) -> list[int]:
        """Propose through the sequence's incremental suffix index, built
        once from the prompt at the first round and extended with the
        tokens emitted since."""
        idx = seq.ngram
        if idx is None:
            idx = seq.ngram = self.proposer.index(seq.req.token_ids)
        for t in seq.generated[len(idx) - seq.prompt_len :]:
            idx.append(t)
        return idx.propose(max_d)

    def _free_draft(self, seq: RunningSeq) -> None:
        if seq.draft_pos is not None:  # set in draft mode only
            self.runner.draft.free_sequence(seq.req.request_id)
        seq.draft_pos = None

    def _drop_draft(self, seq: RunningSeq, why: str) -> None:
        """The draft pool cannot serve this sequence: it goes on verifying
        (one token a round, still exact) with no proposals for the rest of
        its life."""
        log.warning("draft cache dropped for %s (%s)", seq.req.request_id, why)
        self._free_draft(seq)
        seq.draft_dead = True

    def _draft_sync(self, seq: RunningSeq, K: int) -> bool:
        """Bring the draft model's KV up to the sequence's history: in the
        steady state extend its capacity for this round's k draft rows; a
        fresh (or fallen-behind) sequence chunk-prefills everything but the
        newest token. Returns True when the lane can draft this round."""
        if seq.draft_dead:
            return False
        draft = self.runner.draft
        rid = seq.req.request_id
        behind = None if seq.draft_pos is None else seq.pos - seq.draft_pos
        if behind is not None and not 1 <= behind <= K + 1:
            # a catch-up wider than the step's K+1 rows: rebuild
            self._free_draft(seq)
            behind = None
        if behind is None:
            hist = list(seq.req.token_ids) + seq.generated
            t0 = time.monotonic()
            if not draft.prefill_sequence(rid, hist[:-1]):
                self._drop_draft(seq, "draft page pool exhausted at prefill")
                return False
            self.stage.spec_draft_prefills += 1
            self.stage.spec_draft_prefill_s += time.monotonic() - t0
            seq.draft_pos = len(hist) - 1
            return True
        # fed positions this round reach seq.pos + K - 1
        if not draft.ensure_capacity(rid, seq.pos + K):
            self._drop_draft(seq, "draft page pool exhausted")
            return False
        return True

    def _dispatch_draft_phase(self, candidates: list, K: int):
        """Batched drafting for a draft-model round: one
        ``runner.dispatch_draft`` across every lane whose draft cache is
        live. Fills each candidate's draft list in place (candidates are
        [seq, p, drafts, max_d] records) and returns the [B, K, V] draft
        probabilities for the verify pass (None when no lane drafted)."""
        live = [cand for cand in candidates if cand[3] > 0 and self._draft_sync(cand[0], K)]
        if not live:
            return None
        B = self.config.max_seqs
        draft = self.runner.draft
        tables = {s.req.request_id: draft.table_for(s.req.request_id) for s, _, _, _ in live}
        W = self.config.table_bucket_for(max(len(t) for t in tables.values()))
        positions = np.zeros(B, np.int32)
        page_tables = np.zeros((B, W), np.int32)
        active = np.zeros(B, bool)
        fed = np.zeros((B, K + 1), np.int32)
        n_feed = np.ones(B, np.int32)
        temps = np.zeros(B, np.float32)
        top_ks = np.zeros(B, np.int32)
        top_ps = np.ones(B, np.float32)
        min_ps = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int32)
        for seq, _, _, _ in live:
            i = seq.slot
            table = tables[seq.req.request_id]
            positions[i] = seq.draft_pos
            page_tables[i, : len(table)] = table
            active[i] = True
            pending = seq.generated[seq.draft_pos - seq.prompt_len :]
            n_feed[i] = len(pending)
            fed[i, : len(pending)] = pending
            s = seq.req.sampling
            temps[i], top_ks[i], top_ps[i], min_ps[i] = s.temperature, s.top_k, s.top_p, s.min_p
            seeds[i] = fold_seed(s.seed)
        t0 = time.monotonic()
        toks_res, q = self.runner.dispatch_draft(
            positions, page_tables, active, fed, n_feed, temps, top_ks, top_ps,
            min_ps=min_ps, seeds=seeds if np.any(seeds) else None,
        )
        t_disp = time.monotonic()
        toks = toks_res.numpy()
        dt = time.monotonic() - t0
        self.stage.spec_draft_calls += 1
        self.stage.spec_draft_s += dt
        self.anatomy.record(
            "spec_draft", dispatch_s=t_disp - t0, device_wait_s=time.monotonic() - t_disp, steps=K,
            tokens=int(sum(c[3] for c in live)), participants=len(live), ts=t0,
        )
        for cand in live:
            cand[2] = toks[cand[0].slot, : cand[3]].tolist()
        return q

    def _dispatch_spec_round(self, outputs: list[StepOutput]) -> int:
        """One speculative verify round over every spec-mode decode slot:
        propose up to k drafts a slot (its n-gram index, or one batched
        draft-model step shared by every lane), feed [anchor, drafts...] at
        consecutive fed positions through ONE multi-query verify pass, and
        emit the accepted prefix and the correction / bonus token (1..k+1
        tokens). Rounds are synchronous (the next proposal needs this
        round's tokens), so the host tracks materialized positions exactly;
        KV written for rejected drafts (target and draft pools) is
        overwritten by the next round at the advanced anchor. Returns 1
        when a round ran."""
        K = self.spec.k
        draft_mode = self.spec.kind == "draft"
        candidates = []  # mutable [seq, p, drafts, max_d] records
        for seq in sorted((s for s in self.slots if s is not None), key=lambda s: s.admitted_order):
            if seq.finished or not seq.spec_mode or seq.prefill_pos is not None or not seq.generated:
                continue  # prefill pending, or its first token still in flight
            budget = seq.req.sampling.max_tokens - len(seq.generated)
            p = seq.prompt_len + len(seq.generated) - 1  # anchor fed position
            if budget <= 0 or p >= self.config.max_model_len:
                continue
            max_d = max(0, min(K, budget - 1, self.config.max_model_len - 1 - p))
            if draft_mode:
                drafts = None  # filled by the batched draft step below
            else:
                drafts = self._propose_ngram(seq, max_d) if max_d > 0 else []
                max_d = len(drafts)
            # pages for the fed rows anchor..anchor+max_d, by the window
            # path's ladder: drain the pipeline, then preempt, then shrink
            # the proposal to the allocated pages
            need = p + max_d + 1
            while self.slots[seq.slot] is seq and not self.allocator.ensure_capacity(seq.req.request_id, need):
                if self.in_flight:
                    self.pressure_drain_count += 1
                    outputs.extend(self._reconcile(block=True, drain=True))
                    continue
                victim = self._pick_victim(exclude=seq)
                if victim is None:
                    cap = self._capacity(seq)
                    if cap > p:
                        # no victim left: the round runs at a truncated depth
                        max_d = min(max_d, cap - 1 - p)
                        if drafts is not None:
                            drafts = drafts[:max_d]
                        break
                    outputs.extend(self._finish(seq, "error"))
                    break
                self._preempt(victim)
            if self.slots[seq.slot] is not seq or seq.finished:
                continue
            self._refresh_table(seq)
            candidates.append([seq, p, drafts, max_d])
        # a drain or a preemption above can end an earlier candidate
        candidates = [c for c in candidates if not c[0].finished and self.slots[c[0].slot] is c[0]]
        if not candidates:
            return 0

        draft_probs = None
        if draft_mode:
            draft_probs = self._dispatch_draft_phase(candidates, K)
            for c in candidates:
                if c[2] is None:  # the lane did not draft (dead draft or no budget)
                    c[2], c[3] = [], 0
                else:
                    c[3] = len(c[2])

        t_prep = time.monotonic()
        B = self.config.max_seqs
        # the widest participant's ladder rung
        W = self.config.table_bucket_for(max(len(s.page_table) for s, _, _, _ in candidates))
        positions = np.zeros(B, np.int32)
        page_tables = np.zeros((B, W), np.int32)
        active = np.zeros(B, bool)
        fed = np.zeros((B, K + 1), np.int32)
        n_drafts = np.zeros(B, np.int32)
        temps = np.zeros(B, np.float32)
        top_ks = np.zeros(B, np.int32)
        top_ps = np.ones(B, np.float32)
        min_ps = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int32)
        snapshot = []
        for seq, p, drafts, _ in candidates:
            i = seq.slot
            positions[i] = p
            page_tables[i, : len(seq.page_table)] = seq.page_table
            active[i] = True
            fed[i, 0] = seq.generated[-1]
            fed[i, 1 : 1 + len(drafts)] = drafts
            n_drafts[i] = len(drafts)
            s = seq.req.sampling
            temps[i], top_ks[i], top_ps[i], min_ps[i] = s.temperature, s.top_k, s.top_p, s.min_p
            seeds[i] = fold_seed(s.seed)
            snapshot.append((seq, i, len(drafts), p))

        t0 = time.monotonic()
        result = self.runner.dispatch_verify(
            positions, page_tables, active, fed, n_drafts, temps, top_ks, top_ps, min_ps=min_ps,
            seeds=seeds if np.any(seeds) else None, draft_probs=draft_probs,
        )
        t_disp = time.monotonic()
        tokens, n_emit = result.numpy()
        dt = time.monotonic() - t0
        st = self.stage
        st.spec_rounds += 1
        st.spec_dispatch_s += dt
        # one verify round reads the weights and every participant's live
        # pages once (a multi-query pass): the floor of one decode step
        live_pages = sum(
            self.allocator._seqs[s.req.request_id].num_pages
            for s, _, _, _ in candidates if s.req.request_id in self.allocator._seqs
        )
        rec = self.anatomy.record(
            "spec_verify", host_prep_s=t0 - t_prep, dispatch_s=t_disp - t0,
            device_wait_s=time.monotonic() - t_disp, steps=1, participants=len(candidates),
            floor_bytes=self.anatomy.decode_floor_bytes(live_pages, 1), ts=t_prep,
        )
        t_rec = time.monotonic()
        round_emitted = 0
        for seq, i, proposed, p in snapshot:
            if seq.finished:
                continue
            emitted = int(n_emit[i])
            accepted = max(0, emitted - 1)
            st.spec_proposed += proposed
            st.spec_accepted += accepted
            st.spec_emitted += emitted
            round_emitted += emitted
            if draft_mode and seq.draft_pos is not None:
                # accepted draft rows are already fed in the draft cache;
                # the correction / bonus token is next round's catch-up
                seq.draft_pos = p + 1 + accepted
            for j in range(emitted):
                outputs.extend(self._emit_token(seq, int(tokens[i, j])))
                if seq.finished:
                    break  # stop / length mid-chunk: the tail tokens are dead
        self.anatomy.add_phase(rec, "reconcile", time.monotonic() - t_rec)
        self.anatomy.note_steps(rec, tokens=round_emitted)
        return 1

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
        if seq.spec_mode:
            return 0  # advances through speculative verify rounds, never windows
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
                # page pressure: drain the pipeline (EOS may free pages),
                # then preempt the victim
                if self.in_flight:
                    self.pressure_drain_count += 1
                    outputs.extend(self._reconcile(block=True, drain=True))
                    continue
                victim = self._pick_victim(exclude=seq)
                if victim is None:
                    if self._capacity(seq) <= seq.next_fed_pos:
                        outputs.extend(self._finish(seq, "error"))
                    break  # otherwise a shorter window; limits[] freezes at capacity
                self._preempt(victim)
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

    def _pick_victim(self, exclude: RunningSeq) -> Optional[RunningSeq]:
        """The lane to preempt: the most recently admitted, or under QoS the
        lowest class first (most recent within it)."""
        candidates = [s for s in self.slots if s is not None and s is not exclude]
        if not candidates:
            return None
        if self.config.qos:
            return max(candidates, key=lambda s: (priority_rank(s.req.priority), s.admitted_order))
        return max(candidates, key=lambda s: s.admitted_order)

    def _preempt(self, seq: RunningSeq) -> None:
        """Return a sequence to the front of the waiting queue; it restarts
        later from prompt + generated tokens (the prefix cache gives most of
        them back). Callers must drain the pipeline first, so
        ``seq.generated`` is complete and no queued dispatch writes the
        pages freed here."""
        log.info("preempting %s (page pressure)", seq.req.request_id)
        self.preempt_count += 1
        cls = seq.req.priority or "standard"
        self.qos_preempted[cls] = self.qos_preempted.get(cls, 0) + 1
        # frees the pages and the draft cache (rebuilt from the resume prompt
        # at the first spec round after re-admission)
        self._release(seq)
        req = seq.req
        self.waiting.appendleft(dataclasses.replace(
            req,
            token_ids=list(req.token_ids) + seq.generated,
            # the original submission time: a resumed request never looks
            # faster than an uninterrupted run
            enqueue_ts=req.enqueue_ts or time.monotonic(),
            # prior output starts where the ORIGINAL prompt ended
            penalty_output_from=(
                req.penalty_output_from if req.penalty_output_from is not None else seq.prompt_len
            ),
            # recomputed over the resume prompt at re-admission
            mrope_pos=None,
            mrope_delta=0,
            # generated tokens count against max_tokens and min_tokens; every
            # other sampling field (penalties, seed, ...) carries over
            sampling=dataclasses.replace(
                req.sampling,
                max_tokens=max(1, req.sampling.max_tokens - len(seq.generated)),
                min_tokens=max(0, req.sampling.min_tokens - len(seq.generated)),
            ),
        ))

    def _release(self, seq: RunningSeq) -> None:
        seq.finished = True
        self.allocator.free_sequence(seq.req.request_id)
        self._free_draft(seq)
        if self.slots[seq.slot] is seq:
            self.slots[seq.slot] = None
