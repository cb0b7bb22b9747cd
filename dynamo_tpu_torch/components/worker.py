"""Worker service: the torch engine behind a runtime endpoint (port of
``dynamo_tpu/components/worker.py``).

Tokens-in/tokens-out over the wire: PreprocessedRequest dict -> stream of
BackendOutput dicts (detokenization happens here, next to the engine, so text
deltas stream back ready to serve; reference: examples/llm/components/
worker.py VllmWorker, lib/llm/src/backend.rs). The wire dicts, subjects and
keys are the reference's, so a reference processor or frontend drives a port
worker and the other way round.

Publishes KV events (``kv_events`` subject) and ForwardPassMetrics (stats
handler) so KV routers can target it; runs the fleet prefix cache's pull
server (its address rides the stats broadcast under ``kv_pull``) and pull
client; optionally wraps the engine in the disagg decode path.

Live migration (``disagg/migrate.py``): the worker serves a ``migrate``
endpoint that adopts a peer's sequence manifest and streams its
continuation back, keeps a client to its peers' ``migrate`` endpoints (the
scheduler's QoS shed hands a victim to a peer through it), and
``drain`` hands every in-flight sequence to a peer; ``--admin-port`` serves
``POST /admin/drain`` on 127.0.0.1 (standard-library HTTP, as the port's
HTTP service).

    python -m dynamo_tpu_torch.components.worker 'tiny:{...}' \
        --namespace dynamo --component backend --cplane 127.0.0.1:4222 \
        --host-cache-blocks 1024 --disk-cache-bytes 8000000000 --admin-port 0

Multi-LoRA: with ``--lora-adapters`` every adapter registers as its own
model ``<base>:<adapter>`` on the same endpoint (lease-tied like the base
card), and a request naming such a model gets the adapter as its
``lora_name`` (``resolve_adapter``).

The engine runs on the card unless ``--device cpu``. Not ported, and refused
with ``NotPorted`` by ``main``: ``--tp`` above 1 and SLO targets.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
from typing import Optional

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.model_registry import ModelEntry, ModelRegistration
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.llm.tokenizer import get_tokenizer
from dynamo_tpu_torch.lora.adapter import parse_adapter_specs
from dynamo_tpu_torch.utils import get_logger

log = get_logger("components.worker")

GENERATE_ENDPOINT = "generate"
MIGRATE_ENDPOINT = "migrate"
SHUTDOWN_WAIT_S = 5.0  # each control-plane call of the process's shutdown


class WorkerService:
    def __init__(
        self,
        drt,
        namespace: str,
        component: str,
        card: ModelDeploymentCard,
        engine_config: EngineConfig,
        enable_disagg_decode: bool = False,
        register: bool = True,
        engine_factory=None,
        admin_port: int | None = None,
    ):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.card = card
        self.engine_config = engine_config
        self.enable_disagg_decode = enable_disagg_decode
        self.register = register
        # optional (kv_event_sink) -> engine: hosts another engine (an
        # AsyncTorchEngine on given weights, a scripted test engine) behind
        # this worker instead of one built from engine_config
        self.engine_factory = engine_factory
        self.engine = None  # AsyncTorchEngine or DisaggDecodeEngine
        self._inner_engine = None
        self.backend: Optional[Backend] = None
        self._served = None
        self._registration = None
        self._lora_registrations: list = []
        self._adapters = parse_adapter_specs(getattr(engine_config, "lora_adapters", ()))  # {name: source}
        self._kv_publisher: Optional[KvEventPublisher] = None
        # fleet-wide prefix cache: peers pull OUR cached prefixes from this
        # export server; its address rides the stats broadcast so the KV
        # router can attach us as a holder (disagg/prefix_fetch.py)
        self.kv_pull_server = None
        # live migration: the peer-facing `migrate` endpoint adopts
        # manifests; /admin/drain on the admin port drains THIS worker
        self.admin_port = admin_port
        self._admin = None
        self._migrate_served = None
        self._migrate_client = None

    async def start(self) -> "WorkerService":
        loop = asyncio.get_running_loop()
        worker_id = self.drt.primary_lease.lease_id
        subject = f"{self.namespace}|{self.component}.kv_events"
        self._kv_publisher = KvEventPublisher(self.drt.cplane, subject, worker_id, loop=loop)

        if self.engine_factory is not None:
            inner = self.engine_factory(self._kv_publisher.publish)
            starter = getattr(inner, "start", None)
            if starter is not None:
                result = starter()
                if asyncio.iscoroutine(result):
                    await result
        else:
            inner = AsyncTorchEngine(self.engine_config, kv_event_sink=self._kv_publisher.publish)
            await inner.start()
        if self.engine_config.prefix_fetch and isinstance(inner, AsyncTorchEngine):
            from dynamo_tpu_torch.disagg.prefix_fetch import KvPullServer, PrefixFetchClient

            # both directions of the fleet prefix cache: serve our prefixes
            # to pulling peers, and pull theirs when the router attaches a
            # holder to an incoming request
            self.kv_pull_server = await KvPullServer(inner).start()
            inner.kv_pull_server = self.kv_pull_server
            inner.attach_prefix_fetch(PrefixFetchClient(loop, timeout_s=self.engine_config.prefix_fetch_timeout_s))
        engine = inner
        if self.enable_disagg_decode:
            from dynamo_tpu_torch.disagg.decode_worker import DisaggDecodeEngine

            engine = DisaggDecodeEngine(inner, self.drt, self.namespace, self.component, self.card.display_name)
            await engine.start()
        self.engine = engine
        self._inner_engine = inner

        tokenizer = get_tokenizer(self.card.tokenizer)
        self.backend = Backend(engine, tokenizer)

        ep = self.drt.namespace(self.namespace).component(self.component).endpoint(GENERATE_ENDPOINT)
        self._served = await ep.serve_endpoint(self._handle, metrics=self._stats)

        # live migration: adopt peers' manifests on `migrate`, and keep a
        # client to the same endpoint so OUR drain can hand sequences out
        if self.engine_config.migration and isinstance(inner, AsyncTorchEngine):
            mep = self.drt.namespace(self.namespace).component(self.component).endpoint(MIGRATE_ENDPOINT)
            # the same stats as `generate`: every endpoint of the component
            # answers the aggregator's scrape, and an empty answer would
            # overwrite this worker's view (its health and load) for the round
            self._migrate_served = await mep.serve_endpoint(self._handle_migrate, metrics=self._stats)
            self._migrate_client = await self.drt.client(self.namespace, self.component, MIGRATE_ENDPOINT)
            if inner.scheduler is not None:
                inner.scheduler.migrate_shed = self._shed_hook(inner, loop)
        if self.admin_port is not None:
            await self._start_admin(self.admin_port)

        if self.register:
            entry = ModelEntry(
                name=self.card.display_name,
                endpoint=f"dyn://{self.namespace}.{self.component}.{GENERATE_ENDPOINT}",
                model_type="chat",
                card=self.card,
            )
            # lease-tied + refreshed: the card dies with this worker's lease
            # and any surviving co-worker's refresh restores it (MDC TTL
            # semantics, reference: model_card/model.rs)
            self._registration = await ModelRegistration(
                self.drt.cplane, entry, lease_id=self.drt.primary_lease.lease_id
            ).start()
            # multi-LoRA: every adapter is a servable model <base>:<adapter>
            # on the same endpoint and card; _handle maps the suffix back
            for name in self._adapters:
                a_entry = ModelEntry(name=f"{self.card.display_name}:{name}", endpoint=entry.endpoint,
                                     model_type="chat", card=self.card)
                self._lora_registrations.append(await ModelRegistration(
                    self.drt.cplane, a_entry, lease_id=self.drt.primary_lease.lease_id
                ).start())
        return self

    async def stop(self) -> None:
        """Stop serving; the pull server and the engine stop even when the
        control plane is already gone (a runtime shut down first)."""
        try:
            if self._admin is not None:
                await self._admin.stop()
            if self._migrate_served is not None:
                await self._migrate_served.stop()
            if self._migrate_client is not None:
                await self._migrate_client.stop()
            for reg in self._lora_registrations:
                await reg.stop(unregister=False)
            if self._registration is not None:
                # unregister=False: the card key is lease-tied, so OUR lease
                # revoke (runtime shutdown) removes it if we were the owner,
                # while a clean scale-down of one worker of a multi-worker
                # model must NOT blip the shared card for the survivors
                await self._registration.stop(unregister=False)
            if self._served is not None:
                await self._served.stop()
        except ConnectionError as e:
            log.warning("worker endpoint not deregistered (%s); its lease takes the keys", e)
        finally:
            if self.kv_pull_server is not None:
                await self.kv_pull_server.stop()
            if self.engine is not None:
                await self.engine.shutdown()

    def _stats(self) -> dict:
        inner = self._inner_engine
        stats = {"kv_metrics": inner.metrics().to_wire()}
        # fleet health plane: lifecycle state + heartbeat age (routers skip
        # draining/dead workers) and resource gauges ride the same stats
        # broadcast the aggregator already scrapes
        health = getattr(inner, "health", None)
        if health is not None:
            stats["health"] = health.snapshot()
        resources = getattr(inner, "resource_snapshot", None)
        if resources is not None:
            snap = resources()
            if snap:
                stats["resources"] = snap
        # live migration: whether this worker adopts peers' sequences (the
        # planner's rebalance targets only migration-enabled pairs)
        stats["migration"] = {
            "enabled": bool(getattr(self.engine_config, "migration", False)) and self._migrate_client is not None,
        }
        if self._admin is not None:
            # where an operator (or the planner's executor) POSTs /admin/drain
            stats["admin"] = {"address": f"127.0.0.1:{self.admin_port}"}
        if self.kv_pull_server is not None:
            # the fleet prefix cache's discovery channel: routers read the
            # pull address out of this broadcast to attach us as a holder
            srv = self.kv_pull_server
            stats["kv_pull"] = {
                "address": srv.address,
                "served": srv.served,
                "gone": srv.gone,
                "served_blocks": dict(srv.served_blocks),
                "bytes_sent": srv.bytes_sent,
            }
        if self.enable_disagg_decode and self.engine is not None:
            stats["disagg"] = {
                "remote_prefills": self.engine.remote_prefills,
                "local_prefills": self.engine.local_prefills,
            }
            if self.engine.kv_server is not None:
                kv = self.engine.kv_server
                stats["disagg"]["kv_dataplane"] = {
                    "received": kv.received,
                    "parts_received": kv.parts_received,
                    "bytes_received": kv.bytes_received,
                    "dropped": kv.dropped,
                    "rejected": kv.rejected,
                    "checksum_failures": kv.checksum_failures,
                    "parts_scattered": self.engine.parts_scattered,
                    "address": kv.address,
                }
        return stats

    async def _handle(self, request: dict):
        pre = PreprocessedRequest.from_wire(request)
        if not pre.lora_name:
            pre.lora_name = resolve_adapter(pre.model, self.card.display_name, self._adapters)
        async for out in self.backend.generate(pre):
            yield output_wire(out)

    # ---------------- live migration (disagg/migrate.py) ----------------

    async def _handle_migrate(self, request: dict):
        """Peer-facing adoption endpoint: a draining or shedding peer ships
        one sequence's manifest here; we adopt it (seq_handoff KV pull,
        recompute as the fallback) and stream the continuation back, which
        the peer relays into its still-open client stream."""
        from dynamo_tpu_torch.disagg.migrate import SequenceManifest

        manifest = SequenceManifest.from_wire(request)
        async for out in self._inner_engine.adopt_migrated(manifest):
            yield {
                "request_id": out.request_id,
                "token": out.token,
                "finished": out.finished,
                "finish_reason": out.finish_reason,
                "cached_tokens": out.cached_tokens,
            }

    def _peer_adopter(self, instance_id: int):
        """The peer's `migrate` stream in the StepOutput shape that
        ``AsyncTorchEngine.migrate_out`` relays."""
        from dynamo_tpu_torch.engine.scheduler import StepOutput

        async def adopter(manifest):
            stream = await self._migrate_client.direct(manifest.to_wire(), instance_id)
            async for item in stream:
                yield StepOutput(
                    request_id=item.get("request_id", manifest.request_id),
                    token=item.get("token"),
                    finished=bool(item.get("finished")),
                    finish_reason=item.get("finish_reason"),
                    cached_tokens=int(item.get("cached_tokens", 0) or 0),
                )

        return adopter

    def _peers(self) -> list[int]:
        me = self.drt.primary_lease.lease_id
        return [i for i in self._migrate_client.instance_ids() if i != me]

    def _shed_hook(self, engine, loop):
        """The scheduler's QoS shed hook (called on the engine thread): hand
        the victim to a servable peer through live migration instead of
        preempting it; False (preempt) when no peer is there."""

        def shed(request_id: str) -> bool:
            try:
                peers = self._peers()
            except Exception:
                return False
            if not peers:
                return False
            asyncio.run_coroutine_threadsafe(engine.migrate_out(request_id, self._peer_adopter(peers[0])), loop)
            return True

        return shed

    async def drain(self, target_instance: int | None = None) -> dict:
        """Operator drain, migrate-then-die instead of drain-by-attrition:
        mark this worker draining (routers stop sending it work), hand every
        in-flight sequence to a peer of the same component, and report what
        moved. A sequence whose handoff fails keeps decoding here. The
        caller stops the worker once this returns."""
        eng = self._inner_engine
        health = getattr(eng, "health", None)
        if health is not None:
            health.set_state("draining", "operator drain requested")
        results = {"migrated": 0, "resumed": 0, "failed": 0, "skipped": 0}
        if not getattr(self.engine_config, "migration", True) or self._migrate_client is None:
            return {**results, "migration": "disabled"}
        if target_instance is None:
            peers = self._peers()
            target_instance = peers[0] if peers else None
        if target_instance is None:
            log.warning("drain: no migration peer available; draining by attrition")
            return {**results, "migration": "no-peer"}
        if health is not None:
            health.set_state("migrating", "drain: handing sequences to peer")
        adopter = self._peer_adopter(target_instance)
        rids = [s.req.request_id for s in eng.scheduler.slots if s is not None and not s.finished]
        for rid in rids:
            try:
                res = await eng.migrate_out(rid, adopter)
            except Exception:
                log.exception("drain: migration of %s crashed", rid)
                results["failed"] += 1
                continue
            status = res.get("status", "failed")
            results["migrated" if status == "ok" else status if status in results else "failed"] += 1
        if health is not None:
            health.set_state("draining", "drain: migration pass complete")
        results["migration"] = "done"
        results["target_instance"] = f"{target_instance:x}"
        log.info("drain complete: %s", results)
        return results

    async def _start_admin(self, port: int) -> None:
        """The operator plane on 127.0.0.1: ``POST /admin/drain {target?:
        "<instance hex>"}`` runs the migrate-then-die drain. Served by the
        port's standard-library HTTP server (``llm/http/service.py``) with
        this one route."""
        from dynamo_tpu_torch.llm.http.service import HttpService, json_response

        async def drain(request, conn):
            try:
                body = json.loads(request.body or b"{}")
            except ValueError:
                body = {}
            target = None
            if isinstance(body, dict) and body.get("target"):
                target = int(str(body["target"]), 16)
            return json_response(await self.drain(target_instance=target))

        admin = HttpService(host="127.0.0.1", port=port)
        admin.routes = {("POST", "/admin/drain"): drain}
        self.admin_port = await admin.start()
        self._admin = admin
        log.info("worker admin endpoint on 127.0.0.1:%d", self.admin_port)


def output_wire(out) -> dict:
    """The worker's wire dict of one BackendOutput (the reference's keys)."""
    return {
        "request_id": out.request_id,
        "text": out.text,
        "token_ids": out.token_ids,
        "finish_reason": out.finish_reason,
        "cumulative_tokens": out.cumulative_tokens,
        "cached_tokens": out.cached_tokens,
        "logprobs": out.logprobs,
    }


def resolve_adapter(model, display_name: str, adapters) -> str:
    """The adapter a request's model name ``<display_name>:<adapter>`` names,
    when ``adapters`` holds it, else "" (an exact display-name prefix
    match, so a tiny override JSON holding ':' does not misparse)."""
    prefix = display_name + ":"
    if model and str(model).startswith(prefix):
        suffix = str(model)[len(prefix):]
        if suffix in adapters:
            return suffix
    return ""


def refuse_unported(args) -> None:
    """``NotPorted`` for the reference's worker options whose features the
    port does not run: ``--tp`` above 1 and the SLO targets."""
    from dynamo_tpu_torch.launch._run_impl import NotPorted

    if args.tp not in (None, 1):
        raise NotPorted("--tp")
    for flag, value in (("--slo-ttft-ms", args.slo_ttft_ms), ("--slo-itl-ms", args.slo_itl_ms)):
        if value is not None:
            raise NotPorted(flag)


def engine_config_for(args) -> EngineConfig:
    """The worker engine's EngineConfig from its arguments (the reference's
    defaults where the flag is left out)."""
    refuse_unported(args)
    kwargs = dict(
        model_id=args.model,
        device=args.device,
        page_size=args.page_size,
        num_pages=args.num_pages,
        max_seqs=args.max_seqs,
        max_model_len=args.max_model_len,
        quantize=args.quantize,
        kv_cache_dtype=args.kv_cache_dtype,
        speculative=args.speculative,
        kv_stream=not args.no_kv_stream,
        kv_stream_lanes=args.kv_stream_lanes,
        prefix_fetch=not args.no_prefix_fetch,
        prefix_fetch_timeout_s=args.prefix_fetch_timeout_s,
        prefix_fetch_min_blocks=args.prefix_fetch_min_blocks,
        qos=not args.no_qos,
        qos_preempt_wait_ms=args.qos_preempt_wait_ms,
        prefill_flat_depth=args.prefill_flat_depth,
        migration=not args.no_migration,
        migration_timeout_s=args.migration_timeout_s,
        host_cache_blocks=args.host_cache_blocks,
        host_cache_bytes=args.host_cache_bytes,
        disk_cache_bytes=args.disk_cache_bytes,
        disk_cache_dir=args.disk_cache_dir,
        offload_watermark=args.offload_watermark,
        lora_adapters=args.lora_adapters or (),
        max_loras=args.max_loras,
        lora_rank=args.lora_rank,
    )
    if args.prefill_buckets:
        kwargs["prefill_buckets"] = tuple(int(b) for b in args.prefill_buckets.split(",") if b)
    if args.prefill_pipeline_depth:
        kwargs["prefill_pipeline_depth"] = args.prefill_pipeline_depth
    return EngineConfig(**kwargs)


async def _main(args) -> None:
    from dynamo_tpu_torch.frontends.pipeline import card_for_model
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    config = engine_config_for(args)
    # the card carries the engine's context length and block size, so a
    # frontend's preprocessor and a router's kv_block_size match the engine
    card = card_for_model(args.model, args.max_model_len)
    card.kv_block_size = args.page_size
    drt = DistributedRuntime(cplane_address=args.cplane)
    await drt.connect()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, drt.runtime.shutdown)
    svc = WorkerService(drt, args.namespace, args.component, card, config, enable_disagg_decode=args.disagg,
                        admin_port=args.admin_port)
    await svc.start()
    log.info("worker up: model=%s endpoint=dyn://%s.%s.%s disagg=%s", card.display_name, args.namespace,
             args.component, GENERATE_ENDPOINT, args.disagg)
    try:
        await drt.runtime.cancellation.cancelled()
    finally:
        # the control plane may be gone: bound the calls that need it, so a
        # lost broker does not hold the exit for its reconnect window
        try:
            await asyncio.wait_for(svc.stop(), SHUTDOWN_WAIT_S + config.prefix_fetch_timeout_s)
        except asyncio.TimeoutError:
            log.warning("worker stop timed out")
        try:
            await asyncio.wait_for(drt.runtime.run_shutdown_hooks(), SHUTDOWN_WAIT_S)
        except asyncio.TimeoutError:
            log.warning("runtime shutdown (lease revoke) timed out")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", help="model path or tiny:{...} spec")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--cplane", default=None, help="broker host:port (default $DYNTPU_CPLANE)")
    p.add_argument("--device", default="cuda", help="cuda (the default; no card raises) or cpu")
    p.add_argument("--tp", type=int, default=1, help="tensor parallelism: only 1 is ported")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--max-seqs", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--quantize", choices=["int8_wo"], default=None,
                   help="weight-only quantization applied at load time")
    p.add_argument("--kv-cache-dtype", choices=["bf16", "int8"], default=None,
                   help="KV cache storage dtype (int8: per-row scales)")
    p.add_argument("--speculative", default=None, metavar="KIND:...",
                   help="speculative decoding: ngram:<k> or draft:<model>:<k>")
    p.add_argument("--disagg", action="store_true", help="wrap in the disagg decode path")
    p.add_argument("--kv-stream-lanes", type=int, default=2,
                   help="parallel KV data-plane connections per destination (disagg)")
    p.add_argument("--no-kv-stream", action="store_true",
                   help="disable chunk-streamed KV transfer (one monolithic send)")
    p.add_argument("--no-prefix-fetch", action="store_true",
                   help="disable the fleet-wide prefix cache (don't serve KV pulls or fetch "
                        "remote prefixes from peers)")
    p.add_argument("--prefix-fetch-timeout-s", type=float, default=5.0,
                   help="remote prefix pull deadline; on expiry the request degrades to "
                        "recompute (never an error)")
    p.add_argument("--prefix-fetch-min-blocks", type=int, default=1,
                   help="minimum holder advantage (blocks) over the local prefix cache "
                        "before a pull is worth issuing")
    p.add_argument("--no-migration", action="store_true",
                   help="disable live sequence migration (a drain degrades to attrition and the frontend "
                        "answers retriable 503s while draining)")
    p.add_argument("--migration-timeout-s", type=float, default=10.0,
                   help="deadline belt on one sequence handoff (KV pull + first continuation token); on "
                        "expiry the sequence resumes decoding locally")
    p.add_argument("--admin-port", type=int, default=None,
                   help="operator admin HTTP port on 127.0.0.1 (0 = ephemeral): POST /admin/drain migrates "
                        "in-flight sequences to a peer and marks this worker draining")
    p.add_argument("--host-cache-blocks", type=int, default=0,
                   help="host-DRAM KV offload tier capacity in blocks (0 disables)")
    p.add_argument("--host-cache-bytes", type=int, default=0,
                   help="host-DRAM KV tier budget in bytes, resolved to blocks at the model's actual "
                        "per-page wire cost (the larger of the two knobs wins)")
    p.add_argument("--disk-cache-bytes", type=int, default=0,
                   help="disk KV tier budget in bytes (0 disables; requires a host tier: host-pool LRU "
                        "victims demote to disk int8-compressed instead of dropping)")
    p.add_argument("--disk-cache-dir", default="",
                   help="directory for disk-tier block files (default: $DYNTPU_KV_DISK_DIR, else a fresh "
                        "temporary directory the store owns and removes)")
    p.add_argument("--offload-watermark", type=float, default=0.90,
                   help="page-pool occupancy fraction that triggers the batched cold-block drain to the "
                        "host tier (>= 1.0 disables the drain)")
    p.add_argument("--no-qos", action="store_true",
                   help="disable multi-tenant QoS scheduling (FIFO admission)")
    p.add_argument("--qos-preempt-wait-ms", type=float, default=250.0,
                   help="how long a critical request waits with no free slot before the "
                        "scheduler evicts a lower-class lane for it")
    p.add_argument("--no-metering", action="store_true",
                   help="accepted: cost metering is not ported, so it is always off")
    p.add_argument("--prefill-buckets", default="",
                   help="comma-separated padded prefill chunk lengths; empty = the engine default")
    p.add_argument("--prefill-flat-depth", type=int, default=8192,
                   help="context depth past which prefill chunks shrink (0 disables)")
    p.add_argument("--prefill-pipeline-depth", type=int, default=None,
                   help="packed prefill calls dispatched ahead of result materialization")
    p.add_argument("--lora-adapters", default="",
                   help="comma-separated LoRA adapter specs served as <model>:<name> (name, name=<dir>, "
                        "name=random:<seed>); a mixed-adapter batch decodes in one pass")
    p.add_argument("--max-loras", type=int, default=4,
                   help="device adapter slots; more adapters than slots evict LRU (host copy kept)")
    p.add_argument("--lora-rank", type=int, default=8,
                   help="adapter pool rank (smaller adapters zero-pad; larger ones are rejected)")
    # the reference's options whose features are not ported: NotPorted
    for flag in ("--slo-ttft-ms", "--slo-itl-ms"):
        p.add_argument(flag, type=float, default=None, help="not ported (raises NotPorted)")
    return p


def main(argv=None) -> None:
    asyncio.run(_main(build_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
