"""Decode-side disaggregation: the DisaggDecodeEngine wraps a local
AsyncTorchEngine and conditionally offloads prefill to remote prefill workers
(port of ``dynamo_tpu/disagg/decode_worker.py``).

Flow (mirrors reference: examples/llm/components/worker.py:148-189):
  1. estimate prefix-cache hit; ask the DisaggregatedRouter local-vs-remote
  2. remote: allocate decode-side pages, push a RemotePrefillRequest onto the
     broker work queue, await the PrefillResult on our ``prefill_result``
     endpoint (KV rides the TCP call-home data plane — the NIXL WRITE +
     notification analogue), inject + adopt
  3. local: plain engine.generate; a decode pool too full to allocate the
     remote prefill's pages falls back here too, counted in
     ``local_prefill_fallbacks``

LoRA requests prefill locally, as in the reference, and the prefix-cache
estimate of step 1 is salted with the adapter's uid (``lora_uid``): an
adapter's cached blocks count only for that adapter.
"""

from __future__ import annotations

import asyncio
import time
from typing import AsyncIterator, Optional

import numpy as np

from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.scheduler import EngineRequest, StepOutput
from dynamo_tpu_torch.llm.disagg_router import DisaggregatedRouter
from dynamo_tpu_torch.llm.remote_prefill import (
    PrefillResult,
    RemotePrefillRequest,
    prefill_queue_name,
)
from dynamo_tpu_torch.utils import get_logger, tracing

log = get_logger("disagg.decode")

PREFILL_RESULT_ENDPOINT = "prefill_result"


class DisaggDecodeEngine:
    """Same generate() contract as AsyncTorchEngine; routes prefill conditionally."""

    def __init__(
        self,
        engine: AsyncTorchEngine,
        drt,
        namespace: str,
        component: str,
        model: str,
        disagg_router: Optional[DisaggregatedRouter] = None,
        remote_prefill_timeout: float = 120.0,
    ):
        self.engine = engine
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.model = model
        self.router = disagg_router or DisaggregatedRouter(model, cplane=drt.cplane)
        self.queue_name = prefill_queue_name(namespace, model)
        self.remote_prefill_timeout = remote_prefill_timeout
        self._pending: dict[str, asyncio.Future] = {}
        self._served = None
        self.kv_server = None  # KvDataPlaneServer, started in start()
        # disagg stats
        self.remote_prefills = 0
        self.local_prefills = 0
        self.remote_prefill_wait_s = 0.0  # queue push -> KV adopted (transfer leg)
        self.remote_prefill_waits: list[float] = []  # the same, per remote prefill
        # remote prefills that found the decode pool too full to allocate
        # their pages and prefilled locally (counted in local_prefills too)
        self.local_prefill_fallbacks = 0
        self.parts_scattered = 0  # streamed KV parts injected before adoption

    # ---------------- lifecycle ----------------

    async def start(self) -> "DisaggDecodeEngine":
        """Serve the prefill_result endpoint prefill workers call home to."""
        from dynamo_tpu_torch.disagg import ici
        from dynamo_tpu_torch.disagg.dataplane import KvDataPlaneServer

        ep = (
            self.drt.namespace(self.namespace)
            .component(self.component)
            .endpoint(PREFILL_RESULT_ENDPOINT)
        )
        self._served = await ep.serve_endpoint(self._on_prefill_result)
        await self.router.start_watching()
        # dedicated bulk-KV listener: cross-process prefill workers stream
        # block payloads here, off the control plane (disagg/dataplane.py)
        self.kv_server = await KvDataPlaneServer().start()
        # same-pod prefill workers discover us here and use the device-to-device
        # (ICI) KV handoff instead of host-staged bytes
        ici.register_worker(self.worker_id)
        return self

    async def shutdown(self) -> None:
        from dynamo_tpu_torch.disagg import ici

        ici.unregister_worker(self.worker_id)
        if self._served is not None:
            await self._served.stop()
        if self.kv_server is not None:
            await self.kv_server.stop()
        await self.router.stop()
        await self.engine.shutdown()

    @property
    def worker_id(self) -> int:
        return self.drt.primary_lease.lease_id

    def metrics(self):
        return self.engine.metrics()

    def stage_snapshot(self) -> dict:
        snap = getattr(self.engine, "stage_snapshot", dict)()
        return snap

    def render_stage_metrics(self) -> str:
        """Inner engine stage histograms + the KV data-plane stream counters
        (parts/bytes/checksums on the receive side) — one exposition blob for
        whichever /metrics surface hosts this engine."""
        parts = []
        inner = getattr(self.engine, "render_stage_metrics", None)
        if inner is not None:
            parts.append(inner())
        if self.kv_server is not None:
            parts.append(self.kv_server.render_metrics())
        return "".join(parts)

    # ---------------- prefill result ingestion ----------------

    async def _on_prefill_result(self, request: dict):
        result = PrefillResult.from_wire(request)
        fut = self._pending.pop(result.request_id, None)
        if fut is None:
            log.warning("prefill result for unknown request %s", result.request_id)
            yield {"ok": False, "error": "unknown request"}
            return
        fut.set_result(result)
        yield {"ok": True}

    # ---------------- generate ----------------

    async def generate(self, request: EngineRequest) -> AsyncIterator[StepOutput]:
        async for batch in self.generate_batched(request):
            for item in batch:
                yield item

    async def generate_batched(self, request: EngineRequest) -> AsyncIterator[list[StepOutput]]:
        """Window-batched variant (see AsyncTorchEngine.generate_batched): the
        serving Backend consumes this to collapse per-token overhead."""
        # submission/trace stamps happen HERE (not only in the inner engine):
        # the remote path adopts via _register_stream and never goes through
        # engine.generate_batched, yet its queue-wait/TTFT/spans must exist
        self.engine._stamp_submission(request)
        prompt = list(request.token_ids)
        salt = 0
        if getattr(request, "lora_name", ""):
            from dynamo_tpu_torch.lora.adapter import lora_uid

            salt = lora_uid(request.lora_name)
        prefix_hit = await self.engine.run_on_engine(
            lambda: self.engine.sync_lookup_prefix(prompt, salt=salt)
        )
        try:
            queue_depth = await self.drt.cplane.queue_depth(self.queue_name)
        except Exception:
            queue_depth = 0

        # multimodal, logprobs, penalty, and seeded prompts prefill locally:
        # the remote-prefill wire protocol carries token ids only (no pixel
        # data, no first-token logprobs) and the remote engine has no access
        # to this worker's per-slot penalty state or seed stream
        if (
            request.images
            or request.logprobs is not None
            or request.sampling.needs_penalties
            or request.sampling.seed is not None
            or request.sampling.min_p > 0  # remote wire carries no min_p
            # ...nor EOS suppression state for min_tokens' first token
            or (
                request.sampling.min_tokens > 1
                and not request.sampling.ignore_eos
                and bool(request.eos_token_ids)
            )
            # LoRA requests prefill locally: the remote engine would need the
            # same adapter pinned and the salted block identity carried over
            # the wire — the local scheduler already has both
            or bool(getattr(request, "lora_name", ""))
            or not self.router.prefill_remote(len(prompt), prefix_hit, queue_depth)
        ):
            self.local_prefills += 1
            async for batch in self.engine.generate_batched(request):
                yield batch
            return

        self.remote_prefills += 1
        log.debug(
            "remote prefill for %s (len=%d hit=%d depth=%d)",
            request.request_id, len(prompt), prefix_hit, queue_depth,
        )
        from dynamo_tpu_torch.disagg import ici

        rid = request.request_id
        tkey = ici.transfer_key(self.worker_id, rid)
        # a retry reusing this request id must not be swallowed by a tombstone
        # left behind by an earlier cancelled attempt
        ici.clear_tombstone(tkey)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        # register interest on the data plane BEFORE the work is queued, so a
        # fast prefill worker's payload parks instead of being dropped
        kv_token = self.kv_server.expect(rid)
        self.engine._register_stream(request)
        adopted = False
        pool_full = False
        # streamed (v2) transfers: every part that lands on the data plane is
        # scattered into this sequence's pages while later parts (and the
        # prefill itself) are still in flight — the final adopt only waits on
        # the tail part. scatter_tasks orders those engine-thread writes
        # before adoption/abort.
        scatter_tasks: list[asyncio.Task] = []
        injected_pages = [0]
        try:
            # inside the protected region: the engine thread allocates pages
            # even if this coroutine is cancelled mid-await, and the abort in
            # the finally is queued behind it (FIFO), so it always cleans up
            try:
                cached_len, shared_pages, page_ids = await self.engine.run_on_engine(
                    lambda: self.engine.sync_allocate_remote(rid, prompt)
                )
            except MemoryError:
                # remote-prefill allocation has no admission control (the
                # pages must exist before the prefill worker writes into
                # them); under page pressure fall back to the LOCAL path,
                # whose scheduler queues the request until pages free up
                # instead of failing it
                pool_full = True
            if not pool_full:
                ps = self.engine.config.page_size
                n_pages = -(-len(prompt) // ps)
                start_page = shared_pages

                def on_kv_part(part):
                    # runs on the event loop as each part lands; sentinel
                    # ranges (v1 monolithic frames) cover everything pending
                    pf = part.page_from if part.page_from >= 0 else start_page
                    pt = part.page_to if part.page_to >= 0 else n_pages
                    ids = np.asarray(page_ids[pf:pt], np.int32)
                    if len(ids) == 0:
                        return
                    # int8 parts carry their scale plane; wire_data() is the
                    # {"q","s"} dict inject_pages scatters directly (the
                    # reference pads a part's ids to a power of two so its
                    # jitted scatter compiles once a size; eager indexing
                    # takes any count)
                    data = part.wire_data()
                    self.parts_scattered += 1
                    scatter_tasks.append(asyncio.create_task(
                        self.engine.run_on_engine(lambda: self.engine.runner.inject_pages(ids, data))
                    ))
                    injected_pages[0] += len(ids)

                self.kv_server.set_consumer(rid, on_kv_part)
                rp = RemotePrefillRequest(
                    request_id=rid,
                    token_ids=prompt,
                    temperature=request.sampling.temperature,
                    top_k=request.sampling.top_k,
                    top_p=request.sampling.top_p,
                    decode_worker_id=self.worker_id,
                    decode_endpoint=f"dyn://{self.namespace}.{self.component}.{PREFILL_RESULT_ENDPOINT}",
                    skip_leading_tokens=shared_pages * self.engine.config.page_size,
                    kv_addr=self.kv_server.address,
                    kv_token=kv_token,
                    trace_id=request.trace_id or "",
                    # the router's holder hint rides along: the prefill
                    # worker pulls the prefix from the holder before
                    # recomputing (its own min-advantage gate applies)
                    kv_holder_addr=getattr(request, "kv_holder_addr", ""),
                    kv_holder_blocks=getattr(request, "kv_holder_blocks", 0),
                )
                t_hop = time.monotonic()
                await self.drt.cplane.queue_push(self.queue_name, rp.to_wire())
                # one deadline covers BOTH waits (result notification + socket
                # payload): charging each a full timeout would double the
                # worst-case stall when the payload connection dies right
                # after the notification was delivered
                deadline = asyncio.get_running_loop().time() + self.remote_prefill_timeout
                result: PrefillResult = await asyncio.wait_for(fut, self.remote_prefill_timeout)
                kv_data = None
                if result.kv_mode == "socket" and (result.kv_shape or result.kv_parts):
                    # the result message is the notification; the payload
                    # rides the dedicated socket and may land just after it.
                    # Streamed transfers resolve to None here (the parts were
                    # consumed on arrival) — this await is the tail-part gate.
                    remaining = max(0.05, deadline - asyncio.get_running_loop().time())
                    with tracing.span(
                        "disagg.kv_receive", request_id=rid,
                        trace_id=request.trace_id, mode="socket",
                        parts=result.kv_parts,
                    ):
                        kv_data = await self.kv_server.receive(rid, timeout=remaining)
                if scatter_tasks:
                    # every incremental scatter must be on the page table
                    # before adoption enters the sequence into decode
                    await asyncio.gather(*scatter_tasks)
                await self.engine.run_on_engine(
                    lambda: self.engine.sync_adopt_prefilled(
                        request, result, cached_len, kv_data=kv_data,
                        injected_pages=injected_pages[0],
                    )
                )
                adopted = True
                dt = time.monotonic() - t_hop
                self.remote_prefill_wait_s += dt
                self.remote_prefill_waits.append(dt)
                tracing.record_span(
                    "disagg.remote_prefill", t_hop, duration=dt,
                    request_id=rid, trace_id=request.trace_id,
                    attrs={"prompt_len": len(prompt), "mode": result.kv_mode},
                )
        finally:
            # finally (not except Exception): client cancellation raises
            # CancelledError, which must run the same cleanup — dropping any
            # parked (or still in-flight) ici transfer and aborting through
            # the scheduler, since adoption may have completed on the engine
            # thread even though our await was cancelled
            self.kv_server.abandon(rid)
            if scatter_tasks and not adopted:
                # flush in-flight part scatters BEFORE freeing the pages: a
                # scatter landing after the abort would write into pages the
                # allocator may already have handed to another sequence
                await asyncio.gather(*scatter_tasks, return_exceptions=True)
            if not adopted:
                self._pending.pop(rid, None)
                ici.discard_transfer(tkey)
                await self.engine.run_on_engine(
                    lambda: self.engine.sync_abort_remote(rid, request.submission)
                )
                self.engine._outputs.pop(rid, None)

        if pool_full:
            self.remote_prefills -= 1
            self.local_prefills += 1
            self.local_prefill_fallbacks += 1
            log.warning(
                "decode pool full; remote prefill for %s falls back to local", rid
            )
            async for batch in self.engine.generate_batched(request):
                yield batch
            return

        async for batch in self.engine._drain_stream_batched(rid):
            yield batch
