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
``qos_preempt_wait_ms`` with no free slot evicts the lowest-class, most
recent lane (``_shed_for_critical``): through the hosting worker's
``migrate_shed`` hook (live migration to a peer) when one is wired, with a
cooldown while that handoff is in flight, else by preemption.

Multi-LoRA (the reference's, ``dynamo_tpu_torch/lora/``): a request that
names ``lora_name`` pins its adapter's pool slot at admission
(``runner.lora_store.acquire``). An adapter still loading, or whose slots
are all pinned, defers the request without blocking the queue behind it
(deferred requests go back to the queue's front, in order); an unknown
adapter, a broken source or an engine without adapters fails that request
with "error" and serves on. The adapter's uid salts the sequence's block
hashes (``_lora_salt``), so its prefix never serves another adapter or the
base model, locally, in the router or over the fleet and handoff pulls
(their hashes are the sequence's own). The pin is released on finish,
cancel and preemption (re-admission acquires again); adopted sequences
acquire blocking; prefill lanes, verify rounds and (through
``runner.set_slot_lora``) decode windows carry the slot.

The request dataclasses keep the reference's field names; fields of features
this port does not run yet stay at their defaults, and requests that ask for
them (images) are rejected at admission. ``cancel`` takes the engine's submission number
too, so an ended stream cannot cancel a later request that reuses its id
(the reference cancels by id alone); a preempted request keeps its number.
Disaggregation (the reference's): ``run_prefill_chunks`` is the prefill
worker's per-request chunk chain (``on_chunk`` fires after each chunk's
dispatch, the streamed export's hook), and ``adopt_prefilled`` enters a
sequence whose prompt KV came from a remote prefill: it emits the remote
first token and takes a decode slot, or waits in ``adopted_waiting`` for
one (those go first at admission). ``local_prefill_rows`` counts the prompt
rows prefilled on this engine.

The fleet prefix pull (FETCHING_KV, the reference's): when the router
attached a holder (``kv_holder_addr`` / ``kv_holder_blocks``) whose prefix
beats the local cache by ``prefix_fetch_min_blocks``, admission starts a
pull through ``prefix_fetcher`` (``disagg/prefix_fetch.py``) and the
sequence's prefill waits; ``_poll_fetches`` scatters the pulled pages
(``runner.inject_pages``) and moves ``prefill_pos`` and ``cached_len`` past
them, or, on any failure (timeout, ``gone``, error, a missed deadline belt),
prefills from where it was. A pull never errors a request.

The KV tiers and live migration (the reference's):

  - a migration adoption (``kv_handoff_seq``) rides the same wait with the
    pull's ``seq_handoff`` kind, the ``migration_timeout_s`` belt and a
    one-block bar; the ``migration_*`` counters count both roles;
  - a sequence the source froze for its handoff (``RunningSeq.migrating``,
    MIGRATING_OUT) rides no decode window or spec round and is never a
    preemption victim;
  - with no remote holder, a disk tier that holds the chain past the
    device and host hits restores it asynchronously into the same wait
    (``_maybe_start_disk_restore`` / ``_resolve_disk_restore``, the
    ``disk_restore_*`` counters);
  - each step first drains the coldest refcount-0 cached blocks to the host
    tier while page occupancy is above ``offload_watermark``
    (``_drain_cold_to_host``, ``offload_pressure_blocks``).

Not ported yet: metering, the events journal and the stage/metric
planes (of the reference's ``StageStats`` only the spec counters, and the
prefix pull's counters and wait histogram).
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
from dynamo_tpu_torch.utils import tracing
from dynamo_tpu_torch.utils.prometheus import Histogram
from dynamo_tpu_torch.utils.qos import priority_rank, priority_weight
from dynamo_tpu_torch.utils.step_anatomy import StepAnatomy, roofline_for_runner

log = get_logger("engine.sched")

# queue-wait-scale buckets (seconds): the FETCHING_KV dwell time
_WAIT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


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
class _PrefixFetch:
    """Handle for one sequence's FETCHING_KV wait."""

    fut: object  # concurrent.futures.Future[PrefixFetchResult]
    base_block: int  # first requested block's index in the sequence
    t0: float
    # belt over the client's own wait_for: if the fetcher's loop dies and the
    # future never resolves, the scheduler still unwedges admission here
    belt_deadline: float
    handoff: bool = False  # a migration adoption's seq_handoff pull
    disk: bool = False  # a disk-tier restore (engine/kv_store.py), not a pull


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
        self.lora_store = getattr(runner, "lora_store", None)
        self._lora_deferred = False  # the last admission deferred a request for its adapter
        if self.lora_store is not None:
            self.lora_store.anatomy = self.anatomy  # slot loads record as lora_slot_load dispatches
        self.stage = StageStats()
        self.spec = config.spec
        self.proposer = make_proposer(self.spec) if self.spec is not None else None
        self.preempt_count = 0  # sequences bounced back to waiting (page pressure)
        self.pressure_drain_count = 0  # pipeline drains forced by ensure_capacity misses
        # multi-tenant QoS: preemption victims per class, and critical-
        # triggered sheds (a waiting critical request evicting a lower lane)
        self.qos_preempted: dict[str, int] = {}
        self.qos_sheds = 0
        # prefilled remotely (disaggregation), waiting for a decode slot
        self.adopted_waiting: deque[RunningSeq] = deque()
        self.local_prefill_rows = 0  # prompt rows prefilled on this engine
        self.reconciled = 0  # in-flight results materialized
        # fleet-wide prefix cache: the pull client (disagg/prefix_fetch.py
        # PrefixFetchClient), attached by the engine; None = never pull
        self.prefix_fetcher = None
        self.prefix_fetch_hits = 0  # fetches that landed >= 1 remote block
        self.prefix_fetch_fallbacks = 0  # timeout/gone/error -> recompute
        self.prefix_fetch_blocks = 0  # blocks pulled and scattered
        self.prefix_fetch_bytes = 0  # payload bytes pulled (wire KV dtype)
        self.prefix_fetch_tokens = 0  # prompt tokens whose recompute was skipped
        self.prefix_fetch_hist = Histogram(
            "dynamo_prefix_fetch_seconds",
            "remote prefix pull wall time, fetch start to scatter/fallback",
            _WAIT_BUCKETS,
        )
        # disk KV tier (engine/kv_store.py): the resume counters (the store
        # counts spills / restores / drops / I/O errors at the file layer)
        self.disk_restore_hits = 0  # restores that landed >= 1 disk block
        self.disk_restore_fallbacks = 0  # miss / corrupt head -> recompute
        self.disk_restore_blocks = 0  # blocks promoted disk -> device
        self.disk_restore_tokens = 0  # prompt tokens whose recompute was skipped
        # live migration (disagg/migrate.py): both roles' counters
        self.migration_out = 0  # sequences handed to a peer (stream re-pinned)
        self.migration_out_failed = 0  # handoffs that resumed locally instead
        self.migration_in = 0  # migrated sequences admitted (ADOPTING)
        self.migration_in_pulled = 0  # adoptions whose seq_handoff pull landed
        self.migration_in_recomputed = 0  # adoptions that rebuilt KV from history
        self.migration_tokens_salvaged = 0  # history tokens whose recompute a pull skipped
        self.offload_pressure_blocks = 0  # cold blocks drained to host by the watermark
        # the QoS shed through live migration: the hosting worker's hook,
        # (request_id) -> bool, hands the victim to a peer instead of
        # preempting it; a cooldown keeps one waiting critical request from
        # migrating another lane every step while the handoff is in flight
        self.qos_shed_migrations = 0
        self.migrate_shed = None
        self._last_shed_migration = 0.0

    # ---------------- queue ----------------

    def add_request(self, req: EngineRequest) -> None:
        self.waiting.append(req)

    @property
    def num_running(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def has_work(self) -> bool:
        return (bool(self.waiting) or bool(self.adopted_waiting) or bool(self.in_flight)
                or any(s is not None for s in self.slots))

    def oldest_waiting_age(self, now: Optional[float] = None) -> float:
        """Age of the oldest queued request (the watchdog's stuck-queue
        signal). 0 when the queue is empty or unstamped."""
        for req in self.waiting:
            if req.enqueue_ts:
                return max(0.0, (now or time.monotonic()) - req.enqueue_ts)
        return 0.0

    def progress_marker(self) -> int:
        """Monotonic count of completed engine work (every recorded dispatch
        and every reconciled result); a frozen marker while has_work() holds
        means the loop is wedged (the watchdog's no-progress signal)."""
        return sum(self.anatomy.dispatch_counts.values()) + self.reconciled

    def cancel(self, request_id: str, submission: int | None = None) -> bool:
        """Cancel the request ``request_id`` (only its submission
        ``submission`` when given)."""

        def match(req: EngineRequest) -> bool:
            return req.request_id == request_id and (submission is None or req.submission == submission)

        for s in self.slots:
            if s is not None and match(s.req):
                self._release(s)
                return True
        for s in list(self.adopted_waiting):
            if match(s.req):
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
        self._drain_cold_to_host()
        outputs.extend(self._reconcile(block=False))
        outputs.extend(self._admit())
        dispatched = self._poll_fetches()
        dispatched += self._dispatch_prefill_batches(outputs)
        if self.spec is not None:
            dispatched += self._dispatch_spec_round(outputs)
        dispatched += self._dispatch_windows(outputs)
        pipeline_full = self._windows_in_flight() >= max(1, self.config.pipeline_depth)
        if pipeline_full or (self.in_flight and not dispatched and not outputs):
            outputs.extend(self._reconcile(block=True))
        elif not outputs and not dispatched and not self.in_flight and (
                self._fetching() or self._migrating() or self._lora_deferred):
            # FETCHING_KV / MIGRATING_OUT / an adapter's host load is the only
            # live work: each resolves on another thread, so don't hot-spin
            # the engine loop
            time.sleep(0.001)
        return outputs

    def _drain_cold_to_host(self) -> None:
        """Watermark-driven host offload: once page-pool occupancy crosses
        ``offload_watermark``, move the coldest refcount-0 cached blocks to
        the host tier in batches (one gather each), returning their pages
        to the free list, so allocation bursts and decode growth find fresh
        pages instead of paying the reclaim, or preempting, at exhaustion."""
        alloc, cfg = self.allocator, self.config
        if alloc.offload is None or cfg.offload_watermark >= 1.0:
            return
        total = max(1, cfg.num_pages - 1)
        drained = 0
        t0 = time.monotonic()
        while alloc.used_pages / total > cfg.offload_watermark and alloc._reusable:
            moved = alloc.drain_to_host(cfg.offload_drain_batch)
            if not moved:
                break
            self.offload_pressure_blocks += moved
            drained += moved
        if drained:
            dt = time.monotonic() - t0
            self.anatomy.record("offload_drain", dispatch_s=dt, tokens=drained, ts=t0)
            tracing.record_span("engine.offload.drain", t0, duration=dt, attrs={"blocks": drained})

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
        # adopted sequences first: their pages are allocated and their first
        # token emitted, they only need a decode slot
        while self.adopted_waiting:
            slot = self._free_slot()
            if slot is None:
                break
            seq = self.adopted_waiting.popleft()
            seq.slot = slot
            self.slots[slot] = seq
            self.runner.write_token_slots(np.array([slot], np.int32), np.array([seq.generated[-1]], np.int32))
            self.runner.set_slot_lora(slot, seq.lora_slot)
        watermark_pages = int(self.config.watermark * self.config.num_pages)
        cap = self.config.prefill_batches_per_step
        decode_running = any(
            s is not None and not s.finished and s.prefill_pos is None for s in self.slots
        )
        packed = self.runner.packed_prefill_mode
        started = 0.0
        # requests whose adapter is loading (or whose slots are all pinned)
        # step aside without blocking the queue; they go back to its front
        deferred: list[EngineRequest] = []
        try:
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
                lora_slot = 0
                if req.lora_name:
                    try:
                        if self.lora_store is None:
                            raise KeyError("the engine has no LoRA adapters")
                        lora_slot = self.lora_store.acquire(req.lora_name)
                    except Exception as e:
                        # unknown adapter or broken source: this request can
                        # never serve; fail it, not the queue
                        del self.waiting[idx]
                        log.warning("rejecting %s: %s", req.request_id, e)
                        outputs.append(StepOutput(req.request_id, finished=True, finish_reason="error"))
                        continue
                    if lora_slot is None:
                        del self.waiting[idx]
                        deferred.append(req)
                        continue
                del self.waiting[idx]
                try:
                    self._start_sequence(req, slot, lora_slot=lora_slot)
                    # a start consumes 1 / weight cap units: a critical burst
                    # starts more per step than batch work at the same cap
                    started += 1.0 / priority_weight(req.priority) if self.config.qos else 1.0
                except MemoryError:
                    self._release_lora_name(req.lora_name, lora_slot)
                    self.waiting.appendleft(req)
                    break
        finally:
            self.waiting.extendleft(reversed(deferred))
            self._lora_deferred = bool(deferred)
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
            if s is not None and not s.finished and not s.migrating and priority_rank(s.req.priority) > 0
        ]
        if not victims:
            return False
        victim = max(victims, key=lambda s: (priority_rank(s.req.priority), s.admitted_order))
        now = time.monotonic()
        if self.migrate_shed is not None and (
            now - self._last_shed_migration < max(0.05, self.config.qos_preempt_wait_ms / 1e3)
        ):
            return False  # a shed handoff is in flight; let it land
        self.qos_sheds += 1
        if self.migrate_shed is not None:
            try:
                if self.migrate_shed(victim.req.request_id):
                    self._last_shed_migration = now
                    self.qos_shed_migrations += 1
                    log.info("QoS shed: migrating %s (%s) for waiting critical %s", victim.req.request_id,
                             victim.req.priority or "standard", req.request_id)
                    return False  # the slot frees when the handoff completes
            except Exception:
                log.exception("migrate_shed hook failed; preempting instead")
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

    # ---------------- multi-LoRA ----------------

    def _lora_salt(self, req: EngineRequest) -> int:
        """The adapter's uid folded into the request's block identity (0 =
        base): adapter prefixes never cross-hit, locally, in the router's
        radix view or over the fleet pull."""
        if not req.lora_name:
            return 0
        from dynamo_tpu_torch.lora.adapter import lora_uid

        return lora_uid(req.lora_name)

    def _release_lora_name(self, name: str, lora_slot) -> None:
        if name and lora_slot and self.lora_store is not None:
            self.lora_store.release(name)

    def _release_lora(self, seq: RunningSeq) -> None:
        self._release_lora_name(seq.req.lora_name, seq.lora_slot)
        seq.lora_slot = 0

    def _start_sequence(self, req: EngineRequest, slot: int, lora_slot: int = 0) -> None:
        wait = max(0.0, time.monotonic() - req.enqueue_ts) if req.enqueue_ts else None
        cached_len, state = self.allocator.allocate_sequence(req.request_id, req.token_ids,
                                                             salt=self._lora_salt(req))
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
            lora_slot=lora_slot,
            queue_wait_s=wait,
        )
        self._admit_counter += 1
        # decode windows read each slot's adapter slot on the device
        self.runner.set_slot_lora(slot, lora_slot)
        if req.kv_handoff_seq:
            self.migration_in += 1
        prompt_len = len(req.token_ids)
        fetch = self._maybe_start_fetch(req, cached_len, prompt_len)
        if fetch is None:
            # no remote holder (or it lost): a cold session's blocks may still
            # sit on the local disk tier, restored into the same wait
            fetch = self._maybe_start_disk_restore(req, cached_len, prompt_len)
        self.slots[slot].fetch = fetch

    # ---------------- fleet-wide prefix fetch (FETCHING_KV) ----------------

    def _maybe_start_fetch(self, req: EngineRequest, cached_len: int, prompt_len: int) -> Optional[_PrefixFetch]:
        """Kick a remote-prefix pull when the router attached a holder whose
        matched prefix beats our local cache by >= prefix_fetch_min_blocks.
        Returns the FETCHING_KV handle, or None (prefill proceeds normally).

        A migration adoption (``req.kv_handoff_seq``) rides the same
        machinery with the ``seq_handoff`` kind, its own belt
        (``migration_timeout_s``) and a one-block bar: any committed block
        the source still holds beats recomputing it."""
        handoff = bool(req.kv_handoff_seq)
        ps = self.config.page_size
        if self.prefix_fetcher is None or not req.kv_holder_addr or req.kv_holder_blocks <= 0:
            if handoff and (prompt_len - 1) // ps > cached_len // ps:
                # no pull possible: the adoption rebuilds its KV from history
                self.migration_in_recomputed += 1
            return None
        if not handoff and not self.config.prefix_fetch:
            return None
        base = cached_len // ps
        # never consume the entire prompt from cache: the final token must
        # prefill so the model produces next-token logits (the rule the local
        # prefix cache applies in allocate_sequence)
        want_to = min(req.kv_holder_blocks, (prompt_len - 1) // ps)
        min_blocks = 1 if handoff else max(1, self.config.prefix_fetch_min_blocks)
        if want_to - base < min_blocks:
            return None
        state = self.allocator._seqs[req.request_id]
        hashes = [b.sequence_hash for b in state.token_seq.blocks[base:want_to]]
        if not hashes:
            return None
        timeout = self.config.migration_timeout_s if handoff else self.config.prefix_fetch_timeout_s
        try:
            fut = self.prefix_fetcher.fetch(req.kv_holder_addr, hashes, timeout_s=timeout,
                                            kind="seq_handoff" if handoff else "prefix_fetch",
                                            seq_id=req.kv_handoff_seq)
        except Exception:
            log.exception("prefix fetch start failed for %s", req.request_id)
            if handoff:
                self.migration_in_recomputed += 1
            return None
        now = time.monotonic()
        log.debug("%s for %s: blocks [%d, %d) from %s", "seq handoff pull" if handoff else "prefix fetch",
                  req.request_id, base, want_to, req.kv_holder_addr)
        return _PrefixFetch(fut=fut, base_block=base, t0=now, belt_deadline=now + timeout + 2.0, handoff=handoff)

    def _maybe_start_disk_restore(self, req: EngineRequest, cached_len: int,
                                  prompt_len: int) -> Optional[_PrefixFetch]:
        """Kick an asynchronous disk -> device restore when the disk tier
        holds the chain past the device and host hits (a cold session
        resuming). It parks in the same FETCHING_KV wait as a pull: the
        engine loop never blocks on file I/O; the disk tier's thread reads,
        verifies and dequantizes, and ``_poll_fetches`` scatters the result
        as it scatters a remote part."""
        disk = getattr(self.allocator.offload, "disk", None)
        if disk is None or len(disk) == 0:
            return None
        ps = self.config.page_size
        base = cached_len // ps
        want_to = (prompt_len - 1) // ps  # the last token always prefills
        if want_to <= base:
            return None
        state = self.allocator._seqs[req.request_id]
        hashes = [b.sequence_hash for b in state.token_seq.blocks[base:want_to]]
        if not hashes or hashes[0] not in disk:
            return None
        fut = disk.restore_async(hashes)
        now = time.monotonic()
        log.debug("disk restore for %s: blocks [%d, %d)", req.request_id, base, want_to)
        return _PrefixFetch(fut=fut, base_block=base, t0=now,
                            belt_deadline=now + self.config.prefix_fetch_timeout_s + 2.0, disk=True)

    def _fetching(self) -> bool:
        return any(s is not None and not s.finished and s.fetch is not None for s in self.slots)

    def _migrating(self) -> bool:
        return any(s is not None and not s.finished and s.migrating for s in self.slots)

    def _poll_fetches(self) -> int:
        """Resolve FETCHING_KV sequences: scatter pulled pages and advance
        prefill_pos past them on a hit, fall back to recompute on anything
        else. Returns the number of sequences released into prefill."""
        resolved = 0
        for seq in list(self.slots):
            if seq is None or seq.finished or seq.fetch is None:
                continue
            f = seq.fetch
            res = None
            timed_out = False
            if f.fut.done():
                try:
                    res = f.fut.result()
                except Exception:
                    log.exception("prefix fetch future failed for %s", seq.req.request_id)
            elif time.monotonic() >= f.belt_deadline:
                # the client's own timeout should have fired long ago: its
                # loop is gone, and a dead fetcher must never wedge admission
                f.fut.cancel()
                timed_out = True
                log.warning("prefix fetch for %s missed the belt deadline; recomputing", seq.req.request_id)
            else:
                continue
            seq.fetch = None
            resolved += 1
            dt = time.monotonic() - f.t0
            if not f.disk:
                self.prefix_fetch_hist.observe(dt)
            applied = 0
            if res is not None and getattr(res, "status", "") == "hit" and res.blocks:
                applied = self._scatter_fetched(seq, f, res)
            if f.disk:
                self._resolve_disk_restore(seq, f, res, applied, dt, timed_out)
                continue
            if applied:
                new_cached = (f.base_block + applied) * self.config.page_size
                self.prefix_fetch_hits += 1
                self.prefix_fetch_blocks += applied
                self.prefix_fetch_bytes += res.bytes
                self.prefix_fetch_tokens += max(0, new_cached - seq.prefill_pos)
                if f.handoff:
                    self.migration_in_pulled += 1
                    self.migration_tokens_salvaged += max(0, new_cached - seq.prefill_pos)
                seq.prefill_pos = max(seq.prefill_pos, new_cached)
                seq.cached_len = max(seq.cached_len, new_cached)
                tracing.record_span(
                    "engine.prefix_fetch", f.t0, duration=dt, request_id=seq.req.request_id,
                    trace_id=seq.req.trace_id,
                    attrs={"blocks": applied, "bytes": res.bytes, "holder": seq.req.kv_holder_addr,
                           "handoff": f.handoff},
                )
            else:
                self.prefix_fetch_fallbacks += 1
                if f.handoff:
                    self.migration_in_recomputed += 1
                status = getattr(res, "status", "dead") if res is not None else "dead"
                log.info("%s for %s fell back to recompute (%s)", "seq handoff pull" if f.handoff else "prefix fetch",
                         seq.req.request_id, status)
        return resolved

    def _resolve_disk_restore(self, seq: RunningSeq, f: _PrefixFetch, res, applied: int, dt: float,
                              timed_out: bool) -> None:
        """Book a resolved disk restore: promote the scattered blocks disk ->
        device (their advertised identity stayed valid: no removed event),
        drop corrupt blocks truthfully, and move prefill past the restored
        prefix."""
        failed = list(getattr(res, "failed", ()) or ()) if res is not None else []
        if applied:
            new_cached = (f.base_block + applied) * self.config.page_size
            self.disk_restore_hits += 1
            self.disk_restore_blocks += applied
            self.disk_restore_tokens += max(0, new_cached - seq.prefill_pos)
            self.allocator.promote_restored(seq.req.request_id, f.base_block, applied)
            seq.prefill_pos = max(seq.prefill_pos, new_cached)
            seq.cached_len = max(seq.cached_len, new_cached)
            tracing.record_span("engine.disk_restore", f.t0, duration=dt, request_id=seq.req.request_id,
                                trace_id=seq.req.trace_id, attrs={"blocks": applied, "bytes": res.bytes})
        else:
            self.disk_restore_fallbacks += 1
            log.info("disk restore for %s fell back to recompute (%s)", seq.req.request_id,
                     "belt_timeout" if timed_out else getattr(res, "status", "dead") if res is not None else "dead")
        if failed:
            # corrupt / truncated files left their last tier: one truthful
            # removed a block; the tail past them recomputes
            self.allocator.drop_disk_blocks(failed)

    def _scatter_fetched(self, seq: RunningSeq, f: _PrefixFetch, res) -> int:
        """Inject pulled parts into the sequence's pre-allocated pages.
        Returns the contiguous block count applied (0 on any failure: the
        recompute overwrites whatever partially landed)."""
        state = self.allocator._seqs.get(seq.req.request_id)
        if state is None:
            return 0
        t0 = time.monotonic()
        try:
            applied = 0
            for part in res.parts:
                if part.block_from != applied:
                    break  # hole: only the contiguous leading run is cached
                ids = np.asarray(state.pages[f.base_block + part.block_from: f.base_block + part.block_to], np.int32)
                if len(ids) != part.block_to - part.block_from:
                    break
                self.runner.inject_pages(ids, part.data)
                applied = part.block_to
            if applied:
                rec = self.anatomy.begin("prefix_fetch_scatter", ts=t0)
                self.anatomy.add_phase(rec, "dispatch", time.monotonic() - t0)
                self.anatomy.note_steps(rec, tokens=applied, participants=1)
            return applied
        except Exception:
            log.exception("scatter of fetched prefix failed for %s; recomputing", seq.req.request_id)
            return 0

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
                (s for s in self.slots  # FETCHING_KV: hold until the pull resolves
                 if s is not None and not s.finished and s.prefill_pos is not None and s.fetch is None),
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
                    seq.lora_slot,
                ))
                if is_final:
                    finals.append((seq, j, seq.cached_len))
                    want_lp = want_lp or seq.req.logprobs is not None
            rows = sum(end - start for _, start, end in chunks)
            self.local_prefill_rows += rows
            rec = self.anatomy.begin("prefill_packed" if packed else "prefill_chunk", ts=t_prep)
            t0 = time.monotonic()
            self.anatomy.add_phase(rec, "host_prep", t0 - t_prep)
            try:
                if packed:
                    # N rounds up to a power of two (at most log2(lanes) shapes per bucket)
                    N = min(self.config.lanes_for(bucket), 1 << (len(chunks) - 1).bit_length())
                    result = self.runner.prefill_chunk_batch(lanes, N=N, want_logprobs=want_lp)
                else:
                    tokens, start, table, slot, sampling, eos_ids, is_final, lora_slot = lanes[0]
                    result = self.runner.prefill_chunk(
                        tokens, start, table, sample=is_final, sampling=sampling, slot=slot, eos_ids=eos_ids,
                        want_logprobs=want_lp, lora_slot=lora_slot,
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
            if (seq.finished or not seq.spec_mode or seq.prefill_pos is not None or seq.migrating
                    or not seq.generated):
                continue  # prefill pending, frozen for a handoff, or its first token still in flight
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
        lora_slots = np.zeros(B, np.int32)
        snapshot = []
        for seq, p, drafts, _ in candidates:
            i = seq.slot
            positions[i] = p
            lora_slots[i] = seq.lora_slot
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
            lora_slots=lora_slots if np.any(lora_slots) else None,
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
        if seq.migrating:
            return 0  # MIGRATING_OUT: frozen for the handoff, its pages stay
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
            self.reconciled += 1
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
        lowest class first (most recent within it). A sequence frozen for a
        handoff never is: requeueing it while the destination continues the
        same stream would fork the request."""
        candidates = [s for s in self.slots if s is not None and s is not exclude and not s.migrating]
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
        # frees the pages, the draft cache (rebuilt from the resume prompt at
        # the first spec round after re-admission) and the adapter pin
        # (re-admission acquires again; the host copy is cached)
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
        """Free everything a sequence holds: its pages, draft cache and
        adapter pin (on finish, cancel, preemption and a committed
        migration)."""
        seq.finished = True
        self.allocator.free_sequence(seq.req.request_id)
        self._free_draft(seq)
        self._release_lora(seq)
        if seq.slot >= 0 and self.slots[seq.slot] is seq:
            self.slots[seq.slot] = None
        elif seq in self.adopted_waiting:
            self.adopted_waiting.remove(seq)

    # ---------------- disaggregation ----------------

    def run_prefill_chunks(self, req: EngineRequest, page_table: np.ndarray, cached_len: int, prompt_len: int,
                           on_chunk=None) -> int:
        """The prefill worker's path: the prompt past ``cached_len`` in
        chunks of ``chunk_len_for`` rows, one ``runner.prefill_chunk`` call
        each, dispatched back to back; the final chunk samples the first
        output token, returned as a host int (the reference's ``sync=True``;
        only that result is waited for). ``on_chunk(start, end)`` fires
        after each chunk's dispatch, so the pages it finalized can be
        exported while the next chunk computes."""
        rows = max(0, prompt_len - cached_len)
        self.local_prefill_rows += rows
        s = req.sampling
        eos_ids = () if s.ignore_eos else req.eos_token_ids
        t0 = time.monotonic()
        rec = self.anatomy.begin("prefill_chunk", ts=t0)
        first = None
        start = cached_len
        while start < prompt_len:
            end = min(start + self.config.chunk_len_for(start), prompt_len)
            is_last = end == prompt_len
            res = self.runner.prefill_chunk(
                np.asarray(req.token_ids[start:end], np.int32), start, page_table, sample=is_last, sampling=s,
                eos_ids=eos_ids,
            )
            if is_last:
                first = res
            if on_chunk is not None:
                on_chunk(start, end)
            start = end
        t_disp = time.monotonic()
        self.anatomy.add_phase(rec, "dispatch", t_disp - t0)
        token = int(first.numpy()[0])
        self.anatomy.add_phase(rec, "device_wait", time.monotonic() - t_disp)
        self.anatomy.note_steps(rec, tokens=rows, participants=1)
        self.anatomy.note_prefill_floor(rec, rows)
        return token

    def adopt_prefilled(self, req: EngineRequest, first_token: int, cached_len: int = 0) -> list[StepOutput]:
        """Adopt a sequence whose prompt KV was produced remotely. Its pages
        must be allocated under ``req.request_id`` and the KV injected; this
        emits the first token and gives the sequence a decode slot, or
        queues it in ``adopted_waiting`` until one frees."""
        wait = max(0.0, time.monotonic() - req.enqueue_ts) if req.enqueue_ts else None
        state = self.allocator._seqs[req.request_id]
        lora_slot = 0
        if req.lora_name:
            # the KV arrived computed: the adapter must be pinned before any
            # decode window, and adoption has no retry loop
            if self.lora_store is None:
                raise RuntimeError(f"adopted request {req.request_id} names adapter {req.lora_name!r} but the "
                                   "engine has no LoRA adapters")
            lora_slot = self.lora_store.acquire_blocking(req.lora_name)
            if lora_slot is None:
                raise RuntimeError(f"no free LoRA slot for adopted request {req.request_id}")
        seq = RunningSeq(
            req=req,
            slot=-1,
            prompt_len=len(req.token_ids),
            cached_len=cached_len,
            page_table=self._new_table(state.pages),
            admitted_order=self._admit_counter,
            sched_len=1,
            spec_mode=self._spec_eligible(req),
            lora_slot=lora_slot,
            queue_wait_s=wait,
        )
        self._admit_counter += 1
        slot = self._free_slot()
        if slot is not None:
            seq.slot = slot
            self.slots[slot] = seq
            self.runner.write_token_slots(np.array([slot], np.int32), np.array([first_token], np.int32))
            self.runner.set_slot_lora(slot, lora_slot)
        else:
            self.adopted_waiting.append(seq)
        return self._emit_token(seq, first_token, cached=cached_len)
