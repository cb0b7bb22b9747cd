"""AsyncTorchEngine: asyncio facade over the engine step loop (port of
``dynamo_tpu/engine/engine.py`` ``AsyncJaxEngine``).

The step loop runs on a dedicated thread; requests arrive through a
thread-safe inbox, and results cross back via ``loop.call_soon_threadsafe``
into per-request asyncio queues. The engine runs on the card
(``EngineConfig.device="cuda"``, the default) unless the caller asks for
the CPU; with no card visible a CUDA engine raises at start.

Warmup follows the reference: ``EngineConfig.warmup=True`` captures every
step graph before ``start`` returns, ``"background"`` the ones the first
requests need, then the rest one by one between serving steps
(``run_on_engine``, on the engine thread, which owns the graphs' state). A
capture that fails is an error: the engine raises, it does not go on
eagerly. A finished stream cancels its own submission only (id and
submission number), so a request that reuses the id of one that just ended
is served (the reference cancels by id; ROADMAP "Known differences").

The allocator's KV events (block ``stored`` / ``removed``) go to the
``kv_event_sink`` the engine is given, and ``metrics()`` reports the
reference's ``ForwardPassMetrics`` (slots, KV blocks, waiting requests,
cache usage and the prefix-cache hit rate) for the KV router.

QoS: every finished stream (errors included) feeds a
``DrainRateEstimator``, and ``backpressure_snapshot()`` prices the wait a
new request faces from it (the HTTP service's batch-class shed).
``resource_snapshot()`` carries the preemption and QoS counters under the
reference's keys.

Not ported yet: the SLO, goodput, events and health planes, the rest of the
resource snapshot and the disaggregation/migration commands.
"""

from __future__ import annotations

import asyncio
import itertools
import queue as thread_queue
import threading
import time
from dataclasses import dataclass
from typing import AsyncIterator, Callable, Optional

import torch

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.engine.scheduler import EngineRequest, Scheduler, StepOutput
from dynamo_tpu_torch.llm.kv_events import KvCacheEvent
from dynamo_tpu_torch.utils import get_logger
from dynamo_tpu_torch.utils.qos import DrainRateEstimator

log = get_logger("engine")


@dataclass
class ForwardPassMetrics:
    """Worker load metrics for the KV router (the reference's fields and
    names)."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0

    def to_wire(self) -> dict:
        return self.__dict__.copy()


def resolve_device(name: str) -> torch.device:
    """The engine's device; a CUDA device with no card visible raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineConfig.device={name!r} but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class AsyncTorchEngine:
    """Tokens-in/tokens-out streaming engine (the ExecutionContext contract).

    ``model`` optionally supplies an already built model (``LlamaModel`` or
    ``DeepseekModel``) on the engine's device, with the engine's
    ``kv_cache_dtype`` in its config (tests load converted reference weights
    this way); otherwise ``config.model_id`` is built by the registry."""

    def __init__(self, config: EngineConfig, model=None,
                 kv_event_sink: Optional[Callable[[KvCacheEvent], None]] = None):
        self.config = config
        self._given_model = model
        self._extra_kv_sink = kv_event_sink
        self._inbox: thread_queue.Queue = thread_queue.Queue()
        self._cancel_box: thread_queue.Queue = thread_queue.Queue()
        self._cmd_box: thread_queue.Queue = thread_queue.Queue()
        self._outputs: dict[str, tuple] = {}
        self._submissions = itertools.count(1)
        self._warmup_task: Optional[asyncio.Task] = None
        self.warmup_s = 0.0  # seconds of warmup before start() returned
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._started = False
        self.device: Optional[torch.device] = None
        self.scheduler: Optional[Scheduler] = None
        self.allocator: Optional[PageAllocator] = None
        self.runner = None
        self.model = None
        # measured queue-drain rate: Retry-After and the shed check price
        # from it
        self.drain_estimator = DrainRateEstimator()

    # ---------------- lifecycle ----------------

    async def start(self) -> None:
        if self._started:
            return
        await asyncio.get_running_loop().run_in_executor(None, self._initialize)
        self._thread = threading.Thread(target=self._run_loop, name="engine-loop", daemon=True)
        self._thread.start()
        self._started = True
        if self.config.warmup == "background":
            self._warmup_task = asyncio.get_running_loop().create_task(self._background_warmup())

    async def _background_warmup(self) -> None:
        """Capture the remaining step graphs on the engine thread, one per
        idle gap: a request that arrives mid-warmup waits for at most one
        capture. A capture that fails fails the task (``wait_warmup``
        raises it) and the engine refuses new requests."""
        t0 = time.monotonic()
        for thunk in self.runner.warmup_extra_thunks():
            while self.scheduler.has_work():
                await asyncio.sleep(0.05)
            if self._stopping.is_set():
                return
            try:
                await self.run_on_engine(thunk)
            except Exception:
                log.error("background warmup failed: the engine takes no new requests")
                raise
        log.info("background warmup: %d captures in %.1fs", self.runner.compile_monitor.compiles,
                 time.monotonic() - t0)

    async def wait_warmup(self) -> None:
        """Wait for the background warmup (if any) to end; raises what
        failed it."""
        if self._warmup_task is not None:
            await asyncio.shield(self._warmup_task)

    async def run_on_engine(self, fn):
        """Run ``fn()`` on the engine thread between steps (it owns the KV
        cache, the graphs and the scheduler); returns its value."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._cmd_box.put((fn, loop, fut))
        return await fut

    def _initialize(self) -> None:
        from dynamo_tpu_torch.engine.model_runner import ModelRunner
        from dynamo_tpu_torch.models.registry import load_model

        t0 = time.monotonic()
        self.device = resolve_device(self.config.device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self._given_model is not None:
            self.model = self._given_model
            if self.model.device != self.device:
                raise ValueError(f"model is on {self.model.device}, engine on {self.device}")
            want = None if self.config.kv_cache_dtype == "bf16" else self.config.kv_cache_dtype
            have = getattr(self.model.config, "kv_cache_dtype", None)
            if have != want:
                raise ValueError(f"model's kv_cache_dtype is {have!r}, the engine's {want!r}")
            have = getattr(self.model.config, "quantize", None)
            if have != self.config.quantize:
                raise ValueError(f"model's quantize is {have!r}, the engine's {self.config.quantize!r}")
        else:
            self.model = load_model(
                self.config.model_id, device=self.device, quantize=self.config.quantize,
                kv_cache_dtype=self.config.kv_cache_dtype,
            )
        self.runner = ModelRunner(self.config, self.model)
        # the sink itself, not a bound method of this engine (the reference's
        # _on_kv_event): a cycle through the allocator would keep a dropped
        # engine's weights and pools on the card until the cyclic GC ran
        self.allocator = PageAllocator(self.config.num_pages, self.config.page_size,
                                       event_sink=self._extra_kv_sink)
        self.scheduler = Scheduler(self.config, self.runner, self.allocator)
        t_warm = time.monotonic()
        if self.config.warmup == "background":
            # readiness waits only for the shapes the first requests need;
            # the rest are captured between serving steps (see start())
            self.runner.warmup_core()
        elif self.config.warmup:
            self.runner.warmup()
        self.warmup_s = time.monotonic() - t_warm
        log.info(
            "engine ready: model=%s device=%s pages=%d (%.1fs)",
            self.config.model_id, self.device, self.config.num_pages, time.monotonic() - t0,
        )

    async def shutdown(self, join_timeout: float = 120.0) -> None:
        self._stopping.set()
        task = self._warmup_task
        if task is not None:
            task.cancel()  # a pending run_on_engine would never resolve; a no-op once done
            if task.get_loop() is asyncio.get_running_loop():
                await asyncio.gather(task, return_exceptions=True)  # retrieves its outcome
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: self._thread.join(join_timeout)
            )
            if self._thread.is_alive():
                log.error("engine loop did not exit within %.0fs; abandoning thread", join_timeout)

    # ---------------- metrics / events / prefix ----------------

    def metrics(self) -> ForwardPassMetrics:
        alloc, sched = self.allocator, self.scheduler
        if alloc is None or sched is None:
            return ForwardPassMetrics()
        hit_rate = alloc.cache_hit_blocks / alloc.cache_query_blocks if alloc.cache_query_blocks else 0.0
        return ForwardPassMetrics(
            request_active_slots=sched.num_running,
            request_total_slots=self.config.max_seqs,
            kv_active_blocks=alloc.active_pages,
            kv_total_blocks=self.config.num_pages - 1,
            num_requests_waiting=len(sched.waiting),
            gpu_cache_usage_perc=alloc.used_pages / max(1, self.config.num_pages - 1),
            gpu_prefix_cache_hit_rate=hit_rate,
        )

    def resource_snapshot(self) -> dict:
        """The preemption and QoS counters, under the reference's
        ``resource_snapshot`` keys: preemptions, pressure drains, and per
        class the running lanes and preemption victims, and the critical
        sheds. {} before start."""
        sched = self.scheduler
        if sched is None:
            return {}
        running: dict = {}
        for s in sched.slots:
            if s is not None and not s.finished:
                cls = s.req.priority or "standard"
                running[cls] = running.get(cls, 0) + 1
        return {
            "preemptions": sched.preempt_count,
            "pressure_drains": sched.pressure_drain_count,
            "qos": {
                "enabled": self.config.qos,
                "running": running,
                "preempted": dict(sched.qos_preempted),
                "sheds": sched.qos_sheds,
            },
        }

    def backpressure_snapshot(self) -> dict:
        """Queue depth, measured drain rate and the estimated wait a NEW
        request faces (the HTTP service sheds batch-class load when it
        exceeds the budget). ``est_wait_s`` is None until anything has
        finished: a cold engine must not shed on a made-up rate."""
        sched = self.scheduler
        depth = len(sched.waiting) if sched is not None else 0
        rate = self.drain_estimator.rate_rps()
        return {
            "queue_depth": depth,
            "drain_rps": round(rate, 4) if rate is not None else None,
            "est_wait_s": round(depth / rate, 4) if rate and rate > 0 else None,
            "retry_after_s": self.drain_estimator.retry_after_s(depth),
        }

    def sync_lookup_prefix(self, token_ids: list[int], salt: int = 0) -> int:
        """Leading tokens of ``token_ids`` the prefix cache holds (call on
        the engine thread, e.g. through ``run_on_engine``)."""
        return self.allocator.lookup_prefix(token_ids, salt=salt)

    # ---------------- request API ----------------

    async def generate(self, request: EngineRequest) -> AsyncIterator[StepOutput]:
        """Submit a request; yields StepOutputs until finished."""
        async for batch in self.generate_batched(request):
            for item in batch:
                yield item

    async def generate_batched(self, request: EngineRequest) -> AsyncIterator[list[StepOutput]]:
        """Submit a request; yields LISTS of StepOutputs (one list per
        reconciled window for this request)."""
        if not request.enqueue_ts:
            request.enqueue_ts = time.monotonic()
        request.submission = next(self._submissions)
        self._register_stream(request)
        self._inbox.put(request)
        async for batch in self._drain_stream_batched(request.request_id):
            yield batch

    def _register_stream(self, request: EngineRequest) -> None:
        if not self._started:
            raise RuntimeError("engine not started")
        task = self._warmup_task
        if task is not None and task.done() and not task.cancelled() and task.exception() is not None:
            raise RuntimeError("the engine's background warmup failed") from task.exception()
        # the caller's loop per request: generate() may run on another loop
        # than start(); each call_soon_threadsafe must target the queue's loop
        self._outputs[request.request_id] = (asyncio.get_running_loop(), asyncio.Queue(), request.submission)

    async def _drain_stream_batched(self, request_id: str) -> AsyncIterator[list[StepOutput]]:
        entry = self._outputs[request_id]
        _, out_q, submission = entry
        try:
            while True:
                item = await out_q.get()
                if isinstance(item, Exception):
                    raise item
                batch = item if isinstance(item, list) else [item]
                done = False
                for i, o in enumerate(batch):
                    if o.finished:  # nothing rides past a finish
                        batch, done = batch[: i + 1], True
                        break
                yield batch
                if done:
                    return
        finally:
            if self._outputs.get(request_id) is entry:
                del self._outputs[request_id]
            self._cancel_box.put((request_id, submission))

    # ---------------- engine thread ----------------

    def _run_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stopping.is_set():
            did_work = self._drain_inboxes()
            if self.scheduler.has_work():
                try:
                    outputs = self.scheduler.step()
                except Exception as e:  # engine-step failure: fail all running
                    log.exception("engine step failed")
                    self._fail_all(e)
                    continue
                self._post_grouped(outputs)
            elif not did_work:
                try:
                    self.scheduler.add_request(self._inbox.get(timeout=0.02))
                except thread_queue.Empty:
                    pass

    def _drain_inboxes(self) -> bool:
        got = False
        while True:
            try:
                self.scheduler.add_request(self._inbox.get_nowait())
                got = True
            except thread_queue.Empty:
                break
        while True:
            try:
                fn, loop, fut = self._cmd_box.get_nowait()
            except thread_queue.Empty:
                break
            got = True
            try:
                result, exc = fn(), None
            except Exception as e:
                log.exception("engine command failed")
                result, exc = None, e
            try:
                loop.call_soon_threadsafe(_resolve, fut, result, exc)
            except RuntimeError:  # the caller's loop is gone
                pass
        while True:
            try:
                self.scheduler.cancel(*self._cancel_box.get_nowait())
            except thread_queue.Empty:
                break
        return got

    def _post_grouped(self, outputs: list) -> None:
        """One thread crossing per request per step, order preserved. Every
        finish (a cancel or a preemption has none) is a drain-rate sample."""
        by_rid: dict[str, list] = {}
        finished = 0
        for out in outputs:
            by_rid.setdefault(out.request_id, []).append(out)
            finished += out.finished
        if finished:
            self.drain_estimator.note_finish(finished)
        for rid, group in by_rid.items():
            self._post(rid, group if len(group) > 1 else group[0])

    def _post(self, request_id: str, item) -> None:
        entry = self._outputs.get(request_id)
        if entry is None:
            return
        loop, q, submission = entry
        try:
            loop.call_soon_threadsafe(q.put_nowait, item)
        except RuntimeError:
            # caller's loop is gone; treat as cancelled
            self._outputs.pop(request_id, None)
            self._cancel_box.put((request_id, submission))

    def _fail_all(self, exc: Exception) -> None:
        """Fail every request the scheduler knows about, waiting ones included."""
        sched = self.scheduler
        rids = {s.req.request_id for s in sched.slots if s is not None}
        rids.update(r.request_id for r in sched.waiting)
        sched.in_flight.clear()
        for rid in rids:
            sched.cancel(rid)
            self._post(rid, exc)


def _resolve(fut: asyncio.Future, result, exc) -> None:
    if fut.done():  # the waiter was cancelled
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)
