"""AsyncTorchEngine: asyncio facade over the engine step loop (port of
``dynamo_tpu/engine/engine.py`` ``AsyncJaxEngine``).

The step loop runs on a dedicated thread; requests arrive through a
thread-safe inbox, and results cross back via ``loop.call_soon_threadsafe``
into per-request asyncio queues. The engine runs on the card
(``EngineConfig.device="cuda"``, the default) unless the caller asks for
the CPU; with no card visible a CUDA engine raises at start.

Not ported yet: the metric, SLO, goodput, events and health planes, the
disaggregation/migration commands and background warmup.
"""

from __future__ import annotations

import asyncio
import queue as thread_queue
import threading
import time
from typing import AsyncIterator, Optional

import torch

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.engine.scheduler import EngineRequest, Scheduler, StepOutput
from dynamo_tpu_torch.utils import get_logger

log = get_logger("engine")


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

    def __init__(self, config: EngineConfig, model=None):
        self.config = config
        self._given_model = model
        self._inbox: thread_queue.Queue = thread_queue.Queue()
        self._cancel_box: thread_queue.Queue = thread_queue.Queue()
        self._outputs: dict[str, tuple] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._started = False
        self.device: Optional[torch.device] = None
        self.scheduler: Optional[Scheduler] = None
        self.allocator: Optional[PageAllocator] = None
        self.runner = None
        self.model = None

    # ---------------- lifecycle ----------------

    async def start(self) -> None:
        if self._started:
            return
        await asyncio.get_running_loop().run_in_executor(None, self._initialize)
        self._thread = threading.Thread(target=self._run_loop, name="engine-loop", daemon=True)
        self._thread.start()
        self._started = True

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
        else:
            self.model = load_model(
                self.config.model_id, device=self.device, kv_cache_dtype=self.config.kv_cache_dtype
            )
        self.runner = ModelRunner(self.config, self.model)
        self.allocator = PageAllocator(self.config.num_pages, self.config.page_size)
        self.scheduler = Scheduler(self.config, self.runner, self.allocator)
        log.info(
            "engine ready: model=%s device=%s pages=%d (%.1fs)",
            self.config.model_id, self.device, self.config.num_pages, time.monotonic() - t0,
        )

    async def shutdown(self, join_timeout: float = 120.0) -> None:
        self._stopping.set()
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: self._thread.join(join_timeout)
            )
            if self._thread.is_alive():
                log.error("engine loop did not exit within %.0fs; abandoning thread", join_timeout)

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
        self._register_stream(request.request_id)
        self._inbox.put(request)
        async for batch in self._drain_stream_batched(request.request_id):
            yield batch

    def _register_stream(self, request_id: str) -> None:
        if not self._started:
            raise RuntimeError("engine not started")
        # the caller's loop per request: generate() may run on another loop
        # than start(); each call_soon_threadsafe must target the queue's loop
        self._outputs[request_id] = (asyncio.get_running_loop(), asyncio.Queue())

    async def _drain_stream_batched(self, request_id: str) -> AsyncIterator[list[StepOutput]]:
        _, out_q = self._outputs[request_id]
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
            self._outputs.pop(request_id, None)
            self._cancel_box.put(request_id)

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
                self.scheduler.cancel(self._cancel_box.get_nowait())
            except thread_queue.Empty:
                break
        return got

    def _post_grouped(self, outputs: list) -> None:
        """One thread crossing per request per step, order preserved."""
        by_rid: dict[str, list] = {}
        for out in outputs:
            by_rid.setdefault(out.request_id, []).append(out)
        for rid, group in by_rid.items():
            self._post(rid, group if len(group) > 1 else group[0])

    def _post(self, request_id: str, item) -> None:
        entry = self._outputs.get(request_id)
        if entry is None:
            return
        loop, q = entry
        try:
            loop.call_soon_threadsafe(q.put_nowait, item)
        except RuntimeError:
            # caller's loop is gone; treat as cancelled
            self._outputs.pop(request_id, None)
            self._cancel_box.put(request_id)

    def _fail_all(self, exc: Exception) -> None:
        """Fail every request the scheduler knows about, waiting ones included."""
        sched = self.scheduler
        rids = {s.req.request_id for s in sched.slots if s is not None}
        rids.update(r.request_id for r in sched.waiting)
        sched.in_flight.clear()
        for rid in rids:
            sched.cancel(rid)
            self._post(rid, exc)
