"""Processor: KV-aware routing tier between frontends and workers.

Serves ``generate``: takes a PreprocessedRequest wire dict, picks the best
worker via the KvRouter (radix overlap + load cost), forwards with direct
routing, and relays the BackendOutput stream.

Mirrors the reference Processor/Router pair (reference: examples/llm/
components/{processor.py,kv_router.py}). Port of
``dynamo_tpu/components/processor.py``: the same endpoints and wire dicts, so
it routes to the reference's workers as to the port's. A request that names
``lora_name`` routes with the adapter's uid as its salt (``lora_uid``, the
reference's value), so it scores overlap only against that adapter's cached
blocks, as the engines salt them. The reference's processor has no
command line; neither has this one (start it from Python, README).
"""

from __future__ import annotations

from typing import Optional

from dynamo_tpu_torch.llm.kv_router.router import KvRouter
from dynamo_tpu_torch.llm.kv_router.scheduler import AllWorkersBusyError, NoWorkersError
from dynamo_tpu_torch.utils import get_logger, tracing

log = get_logger("components.processor")


class ProcessorService:
    def __init__(
        self,
        drt,
        namespace: str,
        component: str = "processor",
        worker_component: str = "backend",
        kv_block_size: int = 16,
        routing: str = "kv",  # kv | random | round_robin
    ):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.worker_component = worker_component
        self.kv_block_size = kv_block_size
        self.routing = routing
        self.router: Optional[KvRouter] = None
        self._worker_client = None
        self._served = None

    async def start(self) -> "ProcessorService":
        from dynamo_tpu_torch.components.worker import GENERATE_ENDPOINT

        self._worker_client = await self.drt.client(
            self.namespace, self.worker_component, GENERATE_ENDPOINT
        )
        if self.routing == "kv":
            self.router = KvRouter(
                self.drt, self.namespace, self.worker_component, self.kv_block_size
            )
            await self.router.start()
        ep = self.drt.namespace(self.namespace).component(self.component).endpoint("generate")
        self._served = await ep.serve_endpoint(self._handle)
        return self

    async def stop(self) -> None:
        if self._served is not None:
            await self._served.stop()
        if self.router is not None:
            await self.router.stop()
        if self._worker_client is not None:
            await self._worker_client.stop()

    async def _handle(self, request: dict):
        token_ids = request.get("token_ids", [])
        instance_id = None
        # multi-LoRA: the adapter uid salts every hash the routing decision
        # uses, as the engines salt their block identity
        salt = 0
        if request.get("lora_name"):
            from dynamo_tpu_torch.lora.adapter import lora_uid

            salt = lora_uid(str(request["lora_name"]))
        if self.router is not None:
            try:
                # routing-decision time is hop overhead a trace should see
                with tracing.span("processor.schedule", tokens=len(token_ids)):
                    instance_id, overlap = await self.router.schedule_with_overlap(
                        token_ids, salt=salt
                    )
                # fleet-wide prefix cache: when a peer's cached prefix beats
                # the chosen worker's, attach it so the worker can PULL the
                # pages over the dataplane instead of recomputing them — the
                # same OverlapScores the placement used, no second radix walk
                holder = self.router.best_remote_holder(overlap, instance_id)
                if holder is not None:
                    addr = self.router.pull_address(holder[0])
                    if addr:
                        request = dict(request)
                        request["kv_holder_addr"] = addr
                        request["kv_holder_blocks"] = holder[1]
            except (NoWorkersError, AllWorkersBusyError) as e:
                log.warning("kv scheduling failed (%s); falling back to random", e)

        if instance_id is not None:
            stream = await self._worker_client.direct(request, instance_id)
        elif self.routing == "round_robin":
            stream = await self._worker_client.round_robin(request)
        else:
            stream = await self._worker_client.random(request)
        async for item in stream:
            yield item
