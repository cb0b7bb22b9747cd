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

Disaggregation commands (the reference's, run on the engine thread through
``run_on_engine``): the decode side allocates a remote prefill's pages
(``sync_allocate_remote``), adopts its KV and first token
(``sync_adopt_prefilled``) or aborts it at any stage (``sync_abort_remote``);
the prefill side runs the chunked prefill in its own cache and exports the
pages (``sync_remote_prefill``: inline bytes, an in-process device block for
the ici hub, or host blocks for the socket data plane, whole or streamed a
chunk at a time). ``disagg/`` drives them.

The fleet prefix cache (``disagg/prefix_fetch.py``), the reference's: a
worker attaches its pull client (``attach_prefix_fetch``), and the scheduler
pulls the prefix a request names a holder for (``kv_holder_addr``) instead of
recomputing it; ``sync_remote_prefill`` pulls the same way before a remote
prefill (``_pull_remote_prefix``). ``sync_export_prefix`` serves a peer's
pull from the HBM pages, then from the host tier.

The KV tier ladder (the reference's): ``host_cache_blocks`` /
``host_cache_bytes`` build a ``HostKvPool`` (``engine/offload.py``: a pinned
slab on the card) under the page allocator, and ``disk_cache_bytes`` a
``DiskKvStore`` (``engine/kv_store.py``) under it, closed at shutdown;
``resource_snapshot`` carries their ``offload_*`` / ``disk_*`` counters.

Live migration (``disagg/migrate.py``, the reference's): ``migrate_out``
freezes an in-flight sequence (``sync_snapshot_for_migration``), hands its
manifest to an adopter (another engine's ``adopt_migrated``, or a worker's
peer client) and relays the continuation into the original stream, with the
reference's failure ladder (unfreeze before the first continuation token,
local resume over the relayed tokens after it). ``sync_export_sequence``
serves the ``seq_handoff`` pull from the live sequence's own pages.
``render_stage_metrics`` renders the tier and migration families.

Multi-LoRA (``config.lora_adapters``): ``resource_snapshot`` carries the
adapter store's ``lora_*`` keys (slots resident and capacity, evictions,
host loads and their seconds, admissions per adapter, the hottest) and
``render_stage_metrics`` the ``dynamo_lora_*`` families, the reference's
names, types and help.

The health plane (``utils/health.py``), wired as the reference wires it:
``health`` goes ``ready`` when the engine is initialized, ``draining`` at
shutdown and ``dead`` when the loop has stopped; the step loop stamps a
heartbeat and runs the stuck-request watchdog once a second.

Not ported yet: the SLO, goodput, metering and events planes, the rest of
the resource snapshot and the rest of the stage metrics.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import queue as thread_queue
import threading
import time
from dataclasses import dataclass
from typing import AsyncIterator, Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.engine.scheduler import EngineRequest, Scheduler, StepOutput
from dynamo_tpu_torch.llm.kv_events import KvCacheEvent
from dynamo_tpu_torch.runtime.context import current_context
from dynamo_tpu_torch.utils import get_logger, tracing
from dynamo_tpu_torch.utils.health import HealthMonitor
from dynamo_tpu_torch.utils.prometheus import Histogram, render_family
from dynamo_tpu_torch.utils.qos import DrainRateEstimator

log = get_logger("engine")

_WATCHDOG_INTERVAL_S = 1.0
_MIGRATION_PAUSE_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


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
        # fleet health plane: lifecycle state + engine-loop heartbeats +
        # stuck-request watchdog (utils/health.py)
        self.health = HealthMonitor("engine")
        self._next_watchdog = 0.0
        # fleet-wide prefix cache (disagg/prefix_fetch.py): the pull client
        # the scheduler issues FETCHING_KV pulls through (attach_prefix_fetch)
        self.prefix_fetcher = None
        self.kv_pull_server = None
        self.offload = None  # the host KV tier (engine/offload.py), when configured
        # live migration: pause = freeze -> the destination's first
        # continuation token reaches the client stream
        self.migration_pause_hist = Histogram(
            "dynamo_migration_pause_seconds",
            "client-visible stream pause of one live migration, sequence "
            "freeze to the destination's first relayed token",
            _MIGRATION_PAUSE_BUCKETS,
        )

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
        self.offload = self._build_tiers()
        # the sink itself, not a bound method of this engine (the reference's
        # _on_kv_event): a cycle through the allocator would keep a dropped
        # engine's weights and pools on the card until the cyclic GC ran
        self.allocator = PageAllocator(self.config.num_pages, self.config.page_size,
                                       event_sink=self._extra_kv_sink, offload=self.offload)
        self.scheduler = Scheduler(self.config, self.runner, self.allocator)
        self.scheduler.prefix_fetcher = self.prefix_fetcher
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
        self.health.set_state("ready", "engine initialized")

    def _build_tiers(self):
        """The host tier (and the disk tier under it) the config asks for,
        or None. A byte budget resolves at the model's actual per-page wire
        cost."""
        from dynamo_tpu_torch.engine.offload import HostKvPool, resolve_host_capacity_blocks

        cfg = self.config
        if cfg.host_cache_blocks <= 0 and cfg.host_cache_bytes <= 0:
            return None
        page_bytes = self.model.kv_page_bytes(cfg.page_size)
        blocks = resolve_host_capacity_blocks(cfg.host_cache_blocks, cfg.host_cache_bytes, page_bytes)
        if blocks <= 0:
            return None
        offload = HostKvPool(self.runner, blocks, block_bytes=page_bytes)
        if cfg.disk_cache_bytes > 0:
            from dynamo_tpu_torch.engine.kv_store import DiskKvStore, disk_block_bytes

            mcfg = self.model.config
            block_bytes = (
                disk_block_bytes(cfg.page_size, mcfg.num_kv_heads, mcfg.head_dim, mcfg.num_layers)
                if all(hasattr(mcfg, a) for a in ("num_kv_heads", "head_dim", "num_layers")) else 0
            )
            offload.disk = DiskKvStore(directory=cfg.disk_cache_dir or None, budget_bytes=cfg.disk_cache_bytes,
                                       page_axis=offload.axis, block_bytes=block_bytes,
                                       pin=self.device.type == "cuda")
        log.info("KV tiers: host %d blocks (%.1f MiB pinned=%s)%s", blocks, offload.pinned_bytes / 2**20,
                 offload.cuda, f", disk {cfg.disk_cache_bytes} bytes" if offload.disk is not None else "")
        return offload

    async def shutdown(self, join_timeout: float = 120.0) -> None:
        self.health.set_state("draining", "shutdown requested")
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
        disk = getattr(self.offload, "disk", None)
        if disk is not None:
            # drain the disk tier's write queue and stop its thread (a store
            # that owns its directory also removes it)
            await asyncio.get_running_loop().run_in_executor(None, disk.close)
        store = getattr(self.runner, "lora_store", None)
        if store is not None:
            store.close()  # the adapter host-load thread
        self.health.set_state("dead", "shutdown complete")

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
        """The preemption, prefix-pull and QoS counters, under the
        reference's ``resource_snapshot`` keys: preemptions, pressure
        drains, the fleet prefix pulls, and per class the running lanes and
        preemption victims, and the critical sheds. {} before start."""
        sched = self.scheduler
        if sched is None:
            return {}
        running: dict = {}
        for s in sched.slots:
            if s is not None and not s.finished:
                cls = s.req.priority or "standard"
                running[cls] = running.get(cls, 0) + 1
        snap = {
            "preemptions": sched.preempt_count,
            "pressure_drains": sched.pressure_drain_count,
            # fleet prefix cache: pulls that landed / fell back, and what
            # they carried
            "prefix_fetch_hits": sched.prefix_fetch_hits,
            "prefix_fetch_fallbacks": sched.prefix_fetch_fallbacks,
            "prefix_fetch_blocks": sched.prefix_fetch_blocks,
            "prefix_fetch_bytes": sched.prefix_fetch_bytes,
            "prefix_fetch_tokens": sched.prefix_fetch_tokens,
            # live migration: both roles' counters
            "migration_out": sched.migration_out,
            "migration_out_failed": sched.migration_out_failed,
            "migration_in": sched.migration_in,
            "migration_in_pulled": sched.migration_in_pulled,
            "migration_in_recomputed": sched.migration_in_recomputed,
            "migration_tokens_salvaged": sched.migration_tokens_salvaged,
            "qos": {
                "enabled": self.config.qos,
                "running": running,
                "preempted": dict(sched.qos_preempted),
                "sheds": sched.qos_sheds,
                "shed_migrations": sched.qos_shed_migrations,
            },
            "offload_pressure_blocks": sched.offload_pressure_blocks,
        }
        store = getattr(self.runner, "lora_store", None)
        if store is not None:
            # multi-LoRA: device slot occupancy, eviction and load churn, and
            # per-adapter demand
            ls = store.metrics_snapshot()
            snap.update(
                lora_resident=ls["resident"],
                lora_capacity=ls["capacity"],
                lora_evictions=ls["evictions"],
                lora_loads=ls["loads"],
                lora_load_seconds=ls["load_seconds"],
                lora_requests=ls["requests"],
                lora_hot=ls["hot"],
            )
        offload = self.offload
        if offload is not None:
            snap.update(
                offload_saves=offload.saves,
                offload_loads=offload.loads,
                offload_drops=offload.drops,
                offload_blocks_resident=len(offload),
                offload_capacity_blocks=offload.capacity_blocks,
                # at the actual wire dtype (int8 host blocks are about half of bf16)
                offload_block_bytes=offload.block_bytes,
                offload_bytes_resident=offload.bytes_resident,
            )
            disk = offload.disk
            if disk is not None:
                snap.update(
                    disk_spills=disk.spills,
                    disk_restores=disk.restores,
                    disk_drops=disk.drops,
                    disk_io_errors=disk.io_errors,
                    disk_blocks_resident=len(disk),
                    disk_bytes_resident=disk.bytes_resident,
                    disk_budget_bytes=disk.budget_bytes,
                    disk_restore_s=round(disk.restore_s, 4),
                    disk_restore_hits=sched.disk_restore_hits,
                    disk_restore_fallbacks=sched.disk_restore_fallbacks,
                    disk_restore_blocks=sched.disk_restore_blocks,
                    disk_restore_tokens=sched.disk_restore_tokens,
                )
        return snap

    def render_stage_metrics(self) -> str:
        """Prometheus text of the engine's KV tier, live-migration and LoRA
        families (the reference's names, types and help; the rest of its
        stage families are not ported). "" before start."""
        r = self.resource_snapshot()
        if not r:
            return ""
        parts = [
            render_family(
                "dynamo_migration_requests_total", "counter",
                "live sequence migrations by role and terminal result",
                [({"role": "out", "result": "ok"}, r["migration_out"]),
                 ({"role": "out", "result": "failed"}, r["migration_out_failed"]),
                 ({"role": "in", "result": "pulled"}, r["migration_in_pulled"]),
                 ({"role": "in", "result": "recomputed"}, r["migration_in_recomputed"])],
            ),
            render_family(
                "dynamo_migration_tokens_salvaged_total", "counter",
                "history tokens whose prefill recompute a seq_handoff KV "
                "pull skipped at adoption",
                [({}, r["migration_tokens_salvaged"])],
            ),
            self.migration_pause_hist.render(),
            render_family(
                "dynamo_engine_offload_pressure_blocks_total", "counter",
                "cold refcount-0 KV blocks drained to the host tier by the "
                "occupancy-watermark pressure path (batched gathers)",
                [({}, r["offload_pressure_blocks"])],
            ),
        ]
        if "offload_saves" in r:
            parts.append(render_family(
                "dynamo_engine_offload_blocks_total", "counter",
                "host-DRAM KV tier block movement by operation",
                [({"op": "save"}, r["offload_saves"]),
                 ({"op": "load"}, r["offload_loads"]),
                 ({"op": "drop"}, r["offload_drops"])],
            ))
            parts.append(render_family(
                "dynamo_engine_offload_bytes_resident", "gauge",
                "host-DRAM KV tier bytes resident at the ACTUAL wire dtype "
                "(int8 blocks cost ~half of bf16)",
                [({}, r["offload_bytes_resident"])],
            ))
        if "disk_blocks_resident" in r:
            parts.append(render_family(
                "dynamo_engine_disk_blocks", "gauge",
                "disk KV tier blocks resident (int8-compressed block files "
                "keyed by chained sequence hash)",
                [({}, r["disk_blocks_resident"])],
            ))
            parts.append(render_family(
                "dynamo_engine_disk_bytes", "gauge",
                "disk KV tier bytes: resident payload vs the configured "
                "byte budget (disk_cache_bytes)",
                [({"kind": "resident"}, r["disk_bytes_resident"]),
                 ({"kind": "budget"}, r["disk_budget_bytes"])],
            ))
            parts.append(render_family(
                "dynamo_engine_disk_spills_total", "counter",
                "disk KV tier block writes by outcome (spill = host-pool "
                "victim demoted; drop = budget eviction — the block left "
                "its last tier)",
                [({"op": "spill"}, r["disk_spills"]),
                 ({"op": "drop"}, r["disk_drops"])],
            ))
            parts.append(render_family(
                "dynamo_engine_disk_restores_total", "counter",
                "disk KV tier blocks restored (ok = verified + promoted to "
                "device; error = read/checksum failures that fell back to "
                "recompute)",
                [({"outcome": "ok"}, r["disk_restores"]),
                 ({"outcome": "error"}, r["disk_io_errors"])],
            ))
            parts.append(render_family(
                "dynamo_engine_disk_restore_seconds", "counter",
                "cumulative wall seconds the disk worker spent reading, "
                "verifying, and dequantizing restore runs (off the engine "
                "loop — restores park in FETCHING_KV)",
                [({}, r["disk_restore_s"])],
            ))
        if "lora_resident" in r:
            # the adapter pool: slot occupancy, LRU eviction and host-load
            # churn, and per-adapter demand
            parts.append(render_family(
                "dynamo_lora_slots", "gauge",
                "LoRA adapter device slots (resident = adapters currently "
                "holding a slot; capacity excludes the reserved zero slot)",
                [({"state": "resident"}, r["lora_resident"]),
                 ({"state": "capacity"}, r["lora_capacity"])],
            ))
            parts.append(render_family(
                "dynamo_lora_evictions_total", "counter",
                "adapters LRU-evicted from device slots (host copy kept; a "
                "hot-swap back costs one scatter, not a reload)",
                [({}, r["lora_evictions"])],
            ))
            parts.append(render_family(
                "dynamo_lora_loads_total", "counter",
                "adapter host-weight loads (async; requests wait without "
                "blocking other traffic)",
                [({}, r["lora_loads"])],
            ))
            parts.append(render_family(
                "dynamo_lora_load_seconds_total", "counter",
                "cumulative seconds spent loading adapter host weights",
                [({}, round(r["lora_load_seconds"], 4))],
            ))
            parts.append(render_family(
                "dynamo_lora_requests_total", "counter",
                "sequences admitted per adapter (slot acquisitions)",
                [({"adapter": name}, n) for name, n in sorted(r["lora_requests"].items())]
                or [({"adapter": ""}, 0)],
            ))
        return "".join(parts)

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

    # ---------------- fleet-wide prefix cache (disagg/prefix_fetch.py) ----------------

    def attach_prefix_fetch(self, fetcher) -> None:
        """Wire the fleet prefix-cache pull client into the scheduler (safe
        before or after start: _initialize copies it through)."""
        self.prefix_fetcher = fetcher
        if self.scheduler is not None:
            self.scheduler.prefix_fetcher = fetcher

    def sync_export_prefix(self, hashes: list[int]):
        """Engine thread: serve a peer's prefix pull (``KvPullServer``).
        Walks the contiguous leading run of the requested chained block
        hashes down the tier ladder: HBM pages (the gather and its copy to
        the host are enqueued HERE, atomically with the lookup, so no later
        step reuses a page before the gather read it), then host-tier
        blocks (copies). Returns ``(n_dev_blocks, host_future_or_None,
        host_blocks, cat_axis)``; None when the leading block is in no tier
        (the server answers a clean "gone")."""
        alloc, runner = self.allocator, self.runner
        if alloc is None or runner is None:
            return None
        pages: list[int] = []
        for h in hashes:
            page = alloc.cached_page(h)
            if page is None:
                break
            pages.append(page)
        host_blocks: list = []
        if self.offload is not None:
            for h in hashes[len(pages):]:
                data = self.offload.peek(h)
                if data is None:
                    break
                host_blocks.append(data)
        if not pages and not host_blocks:
            return None
        fut = runner.extract_pages_async(np.asarray(pages, np.int32)) if pages else None
        axis = getattr(runner.model, "wire_n_axis", 2)
        return len(pages), fut, host_blocks, axis

    # ---------------- live migration (disagg/migrate.py) ----------------
    # MIGRATING_OUT: the source freezes a sequence, ships its manifest and
    # relays the destination's continuation into the original output
    # stream. ADOPTING: the destination re-enters the sequence through normal
    # admission, pulling its committed KV with the seq_handoff kind
    # (FETCHING_KV), with recompute from history as the fallback.

    def _running(self, request_id: str):
        return next((s for s in self.scheduler.slots if s is not None and s.req.request_id == request_id), None)

    def sync_export_sequence(self, seq_id: str, hashes: list[int]):
        """Engine thread: serve a ``seq_handoff`` pull: the named LIVE
        sequence's own page run for the requested chained hashes (decode
        blocks whose registration deduplicated onto another sequence's page
        still export OUR copy). A sequence already released falls back to
        the prefix cache, which usually still holds its committed blocks."""
        alloc, runner = self.allocator, self.runner
        if alloc is None or runner is None or not hashes:
            return None
        state = alloc._seqs.get(seq_id)
        if state is None or state.token_seq is None:
            return self.sync_export_prefix(hashes)
        chain = [b.sequence_hash for b in state.token_seq.blocks]
        try:
            start = chain.index(hashes[0])
        except ValueError:
            # the requested run is not this sequence's (the destination
            # cached a different leading run): the prefix cache may hold it
            return self.sync_export_prefix(hashes)
        pages: list[int] = []
        for i, h in enumerate(hashes):
            j = start + i
            if j >= len(chain) or chain[j] != h or j >= len(state.pages):
                break
            pages.append(state.pages[j])
        if not pages:
            return None
        fut = runner.extract_pages_async(np.asarray(pages, np.int32))
        axis = getattr(runner.model, "wire_n_axis", 2)
        return len(pages), fut, [], axis

    def sync_snapshot_for_migration(self, request_id: str):
        """Engine thread: freeze one in-flight decode sequence (MIGRATING_OUT)
        and build its manifest. None = not migratable now (unknown,
        finished, already migrating, still prefilling or fetching: the
        second of two racing migrations gets None); "multimodal" = never
        (its vision context does not ride the manifest). The outputs the
        pipeline drain materializes are posted to their streams here."""
        sched = self.scheduler
        seq = self._running(request_id)
        if (seq is None or seq.finished or seq.migrating or seq.prefill_pos is not None or seq.fetch is not None
                or not seq.generated):
            return None
        if seq.req.images:
            return "multimodal"
        # drain the dispatch-ahead pipeline: seq.generated must be the whole
        # materialized history before it becomes the manifest
        self._post_grouped(sched._reconcile(block=True, drain=True))
        if seq.finished:
            return None  # EOS / length landed during the drain
        seq.migrating = True
        return self._build_manifest(seq)

    def _build_manifest(self, seq):
        from dynamo_tpu_torch.disagg.migrate import SequenceManifest

        req = seq.req
        ps = self.config.page_size
        hist_len = seq.prompt_len + len(seq.generated)
        state = self.allocator._seqs.get(req.request_id)
        kv_blocks = 0
        if state is not None and state.token_seq is not None:
            # exportable = full blocks whose KV is complete (the newest
            # token's KV is not written: it is the next decode input)
            kv_blocks = min((hist_len - 1) // ps, len(state.token_seq.blocks), len(state.pages))
        addr = self.kv_pull_server.address if self.kv_pull_server is not None else ""
        age = max(0.0, time.monotonic() - req.enqueue_ts) if req.enqueue_ts else 0.0
        return SequenceManifest(
            request_id=req.request_id,
            prompt_tokens=list(req.token_ids),
            generated=list(seq.generated),
            sampling=dataclasses.asdict(req.sampling),
            eos_token_ids=list(req.eos_token_ids),
            lora_name=req.lora_name,
            logprobs=req.logprobs,
            penalty_output_from=req.penalty_output_from if req.penalty_output_from is not None else seq.prompt_len,
            trace_id=req.trace_id,
            tenant=req.tenant,
            scenario=req.scenario,
            priority=req.priority,
            source_addr=addr if kv_blocks > 0 else "",
            kv_blocks=kv_blocks,
            age_s=age,
        )

    def sync_commit_migration(self, request_id: str) -> bool:
        """Engine thread: the destination's continuation is live: release
        the frozen local sequence WITHOUT a finish output. False when the
        sequence already ended here (a cancel raced the handoff): the caller
        drops the destination's stream."""
        seq = self._running(request_id)
        if seq is None or seq.finished or not seq.migrating:
            return False
        self.scheduler._release(seq)
        return True

    def sync_abort_migration(self, request_id: str) -> bool:
        """Engine thread: the handoff failed before any continuation token:
        unfreeze the sequence, so local decode resumes."""
        seq = self._running(request_id)
        if seq is None or seq.finished or not seq.migrating:
            return False
        seq.migrating = False
        return True

    def sync_resume_migration(self, manifest, relayed: list) -> bool:
        """Engine thread: the destination died AFTER continuation tokens
        were relayed to the client: requeue a preempt-style resume over
        history + relayed tokens, so the stream goes on here,
        token-identically (the prefix cache usually still holds the
        committed blocks). It keeps the stream's submission number, so the
        client's cancel still reaches it."""
        req = manifest.to_resume_request(list(relayed), time.monotonic())
        entry = self._outputs.get(req.request_id)
        if entry is not None:
            req.submission = entry[2]
        self.scheduler.waiting.appendleft(req)
        return True

    async def migrate_out(self, request_id: str, adopter, timeout_s=None) -> dict:
        """Hand one in-flight sequence to a peer mid-decode and re-pin its
        output stream to the peer's continuation.

        ``adopter(manifest)`` is an async iterator of StepOutputs: another
        engine's ``adopt_migrated`` in process, or the worker's wrapper of
        its peer's ``migrate`` endpoint. The failure ladder: a handoff that
        dies before the first continuation token unfreezes the sequence
        (local decode resumes); one that dies after relaying tokens requeues
        a preempt-style resume over history + relayed tokens. Returns a
        status dict; "ok" means the stream now lives on the destination."""
        timeout = timeout_s or self.config.migration_timeout_s
        sched = self.scheduler
        if not self.config.migration:
            return {"status": "skipped", "reason": "migration disabled"}
        manifest = await self.run_on_engine(lambda: self.sync_snapshot_for_migration(request_id))
        if manifest == "multimodal":
            return {"status": "rejected", "reason": "multimodal_sequence",
                    "detail": "mm_embeds do not ride the manifest; migrating would silently drop vision context"}
        if manifest is None:
            return {"status": "skipped", "reason": "not migratable"}
        t0 = time.monotonic()
        gen = None
        try:
            gen = adopter(manifest).__aiter__()
            first = await asyncio.wait_for(gen.__anext__(), timeout)
            if first.finished and first.finish_reason == "error":
                raise RuntimeError("destination rejected the adoption")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._aclose(gen)
            await self.run_on_engine(lambda: self.sync_abort_migration(request_id))
            sched.migration_out_failed += 1
            log.warning("migration of %s failed before handoff: %s", request_id, e)
            return {"status": "failed", "error": f"{type(e).__name__}: {e}"}
        pause = time.monotonic() - t0
        if not await self.run_on_engine(lambda: self.sync_commit_migration(request_id)):
            # a cancel raced the handoff: the local stream already ended, and
            # the destination's adopted copy is orphaned
            await self._aclose(gen)
            return {"status": "skipped", "reason": "sequence ended locally"}
        self.migration_pause_hist.observe(pause)
        tracing.record_span("engine.migrate_out", t0, duration=pause, request_id=request_id,
                            trace_id=manifest.trace_id,
                            attrs={"kv_blocks": manifest.kv_blocks, "generated": len(manifest.generated)})
        relayed: list[int] = []
        item = first
        try:
            while True:
                if item.finished and item.finish_reason == "error":
                    raise RuntimeError("destination errored mid-continuation")
                if item.token is not None:
                    relayed.append(item.token)
                self._post(request_id, item)
                if item.finished:
                    sched.migration_out += 1
                    return {"status": "ok", "pause_s": pause, "tokens_relayed": len(relayed),
                            "kv_blocks": manifest.kv_blocks}
                item = await gen.__anext__()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # StopAsyncIteration without a finish too
            await self._aclose(gen)
            sched.migration_out_failed += 1
            if request_id in self._outputs:
                # the destination died mid-stream: continue here from history
                # + everything relayed (never worse than preempt + recompute)
                log.warning("migration of %s lost the destination after %d relayed tokens (%s); resuming locally",
                            request_id, len(relayed), e)
                await self.run_on_engine(lambda: self.sync_resume_migration(manifest, relayed))
                return {"status": "resumed", "tokens_relayed": len(relayed)}
            return {"status": "failed", "error": f"{type(e).__name__}: {e}"}  # the client is gone too

    @staticmethod
    async def _aclose(gen) -> None:
        if gen is not None:
            try:
                await gen.aclose()
            except Exception:
                pass

    async def adopt_migrated(self, manifest) -> AsyncIterator[StepOutput]:
        """ADOPTING side: re-enter a migrated sequence through normal
        admission. The manifest's history is the prompt; its committed KV is
        pulled from the source over seq_handoff (FETCHING_KV) with recompute
        as the fallback; sampling continues positionally, so the
        continuation is token-identical for greedy and seeded lanes."""
        if not self.config.migration:
            raise RuntimeError("migration is disabled on this engine")
        req = manifest.to_engine_request(now=time.monotonic())
        self._stamp_submission(req)
        self._register_stream(req)
        self._inbox.put(req)
        async for batch in self._drain_stream_batched(req.request_id):
            for item in batch:
                yield item

    def _pull_remote_prefix(self, holder_addr: str, holder_blocks: int, state, cached_len: int,
                            prompt_len: int, trace_id=None) -> int:
        """Prefill-side fleet prefix pull: fetch the contiguous leading
        blocks past our local cache from ``holder_addr`` and scatter them
        into the sequence's pre-allocated pages. Returns the new cached_len;
        ANY failure (no fetcher, timeout, gone, partial scatter) returns the
        original: the caller recomputes, never errors."""
        sched, cfg = self.scheduler, self.config
        fetcher = self.prefix_fetcher
        if fetcher is None or not cfg.prefix_fetch or holder_blocks <= 0:
            return cached_len
        ps = cfg.page_size
        base = cached_len // ps
        # the final prompt token must prefill so the model emits logits
        want_to = min(holder_blocks, (prompt_len - 1) // ps)
        if want_to - base < max(1, cfg.prefix_fetch_min_blocks):
            return cached_len
        hashes = [b.sequence_hash for b in state.token_seq.blocks[base:want_to]]
        if not hashes:
            return cached_len
        t0 = time.monotonic()
        try:
            fut = fetcher.fetch(holder_addr, hashes, timeout_s=cfg.prefix_fetch_timeout_s)
            res = fut.result(timeout=cfg.prefix_fetch_timeout_s + 2.0)
        except Exception:
            log.exception("prefill-side prefix pull from %s failed", holder_addr)
            sched.prefix_fetch_fallbacks += 1
            return cached_len
        dt = time.monotonic() - t0
        sched.prefix_fetch_hist.observe(dt)
        applied = 0
        if getattr(res, "status", "") == "hit" and res.blocks:
            try:
                for part in res.parts:
                    if part.block_from != applied:
                        break  # hole: only the contiguous leading run counts
                    ids = np.asarray(state.pages[base + part.block_from: base + part.block_to], np.int32)
                    if len(ids) != part.block_to - part.block_from:
                        break
                    self.runner.inject_pages(ids, part.data)
                    applied = part.block_to
            except Exception:
                log.exception("scatter of pulled prefix failed; recomputing")
                applied = 0
        if not applied:
            sched.prefix_fetch_fallbacks += 1
            return cached_len
        new_cached = (base + applied) * ps
        sched.prefix_fetch_hits += 1
        sched.prefix_fetch_blocks += applied
        sched.prefix_fetch_bytes += res.bytes
        sched.prefix_fetch_tokens += max(0, new_cached - cached_len)
        tracing.record_span(
            "engine.prefix_fetch", t0, duration=dt, trace_id=trace_id,
            attrs={"blocks": applied, "bytes": res.bytes, "holder": holder_addr, "side": "prefill"},
        )
        return max(cached_len, new_cached)

    # ---------------- request API ----------------

    async def generate(self, request: EngineRequest) -> AsyncIterator[StepOutput]:
        """Submit a request; yields StepOutputs until finished."""
        async for batch in self.generate_batched(request):
            for item in batch:
                yield item

    async def generate_batched(self, request: EngineRequest) -> AsyncIterator[list[StepOutput]]:
        """Submit a request; yields LISTS of StepOutputs (one list per
        reconciled window for this request)."""
        self._stamp_submission(request)
        self._register_stream(request)
        self._inbox.put(request)
        async for batch in self._drain_stream_batched(request.request_id):
            yield batch

    def _stamp_submission(self, request: EngineRequest) -> None:
        """Stamps at the engine boundary: the submission time (the TTFT zero
        point, kept when already set), the edge trace id of the ambient
        request context, and this engine's submission number."""
        if not request.enqueue_ts:
            request.enqueue_ts = time.monotonic()
        if request.trace_id is None:
            ctx = current_context()
            if ctx is not None:
                request.trace_id = ctx.trace_id
        request.submission = next(self._submissions)

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

    # ---------------- disaggregation (run via run_on_engine) ----------------

    def sync_allocate_remote(self, request_id: str, token_ids: list[int]) -> tuple[int, int, list[int]]:
        """Decode side: allocate pages for a remote-prefill sequence.
        Returns (cached_len, shared_prefix_pages, page_ids), the page ids in
        logical order, so streamed KV parts can be scattered into them as
        they land, before adoption. Raises MemoryError when the pool is
        short."""
        cached_len, state = self.allocator.allocate_sequence(request_id, token_ids)
        return cached_len, state.shared_prefix_pages, list(state.pages)

    def sync_abort_remote(self, request_id: str, submission: int | None = None) -> None:
        """Abort a remote-prefill request at any stage: adoption may have
        completed on this thread although the caller saw a cancellation, and
        then only the scheduler's cancel frees both the slot and the pages
        (freeing pages a slot still decodes into would corrupt their next
        owner)."""
        if not self.scheduler.cancel(request_id, submission):
            if request_id in self.allocator._seqs:
                self.allocator.free_sequence(request_id)

    def _page_table_for(self, state) -> np.ndarray:
        """The sequence's pages at its ladder width (the traces the local
        scheduler dispatches)."""
        width = self.config.table_bucket_for(max(1, len(state.pages)))
        page_table = np.zeros(width, np.int32)
        page_table[: len(state.pages)] = state.pages
        return page_table

    def sync_remote_prefill(self, rp, device: bool = False, mode: str | None = None, on_part=None):
        """Prefill side: the full chunked prefill in this engine's cache (the
        prefix cache applies), then the requested page range exported.

        Returns ``(PrefillResult, host_data_or_None)``. ``mode``:
          - "inline": KV staged to host and carried in the result's bytes;
          - "ici": same process: the gathered device block (``DeviceKv``)
            parked in the ici hub, the result carries ``kv_transfer_id``;
          - "socket": KV staged to host and returned beside the result; the
            caller ships it over the data plane, and the result is the
            completion notification.

        ``on_part`` (socket mode) streams the export: the pages each prefill
        chunk finalizes are gathered right after its dispatch
        (``runner.extract_pages_async``, the host copy resolved off this
        thread) and handed to ``on_part(part_seq, part_total, page_from,
        page_to, host_future)`` while the next chunk computes; the result
        then carries ``kv_parts`` and no host data."""
        from dynamo_tpu_torch.disagg import ici
        from dynamo_tpu_torch.disagg.dataplane import stream_part_plan
        from dynamo_tpu_torch.engine.sampling import SamplingParams
        from dynamo_tpu_torch.llm.remote_prefill import PrefillResult, tensor_bytes, wire_dtype_name
        from dynamo_tpu_torch.quant.kv import is_quantized_wire

        if mode is None:
            mode = "ici" if device else "inline"
        rid = f"rp-{rp.request_id}"
        prompt_len = len(rp.token_ids)
        cached_len, state = self.allocator.allocate_sequence(rid, list(rp.token_ids))
        # fleet prefix pull BEFORE recomputing: when the router attached a
        # holder whose cached prefix beats ours, pull the missing leading
        # blocks over the data plane, with the scheduler's timeout ->
        # recompute fallback; synchronous here (this engine thread has
        # nothing to interleave with a remote prefill)
        if getattr(rp, "kv_holder_addr", ""):
            cached_len = self._pull_remote_prefix(
                rp.kv_holder_addr, int(getattr(rp, "kv_holder_blocks", 0) or 0), state, cached_len, prompt_len,
                trace_id=rp.trace_id or None,
            )
        ps = self.config.page_size
        start_page = rp.skip_leading_tokens // ps
        n_pages = -(-prompt_len // ps)
        plan = (
            stream_part_plan(start_page, cached_len, prompt_len, ps, self.config.max_prefill_chunk)
            if (mode == "socket" and on_part is not None) else []
        )
        try:
            page_table = self._page_table_for(state)
            req = EngineRequest(
                request_id=rid,
                token_ids=list(rp.token_ids),
                sampling=SamplingParams(temperature=rp.temperature, top_k=rp.top_k, top_p=rp.top_p, max_tokens=1),
                trace_id=rp.trace_id or None,
            )
            data = None
            if plan:
                total = len(plan)
                next_part = [0]

                def flush(tokens_final: int, last: bool) -> None:
                    limit = n_pages if last else tokens_final // ps
                    while next_part[0] < total and plan[next_part[0]][1] <= limit:
                        pf, pt = plan[next_part[0]]
                        ids = np.asarray(state.pages[pf:pt], np.int32)
                        with tracing.span("disagg.kv_extract", request_id=rp.request_id, trace_id=req.trace_id,
                                          pages=len(ids), mode="socket", part=next_part[0]):
                            fut = self.runner.extract_pages_async(ids)
                        on_part(next_part[0], total, pf, pt, fut)
                        next_part[0] += 1

                # prefix-cached pages below cached_len are final already;
                # everything else ships as its finalizing chunk is dispatched
                flush(cached_len, False)
                first_token = self.scheduler.run_prefill_chunks(
                    req, page_table, cached_len, prompt_len, on_chunk=lambda s, e: flush(e, e == prompt_len),
                )
                self.allocator.commit_prefilled(rid, prompt_len)
            else:
                first_token = self.scheduler.run_prefill_chunks(req, page_table, cached_len, prompt_len)
                self.allocator.commit_prefilled(rid, prompt_len)
                ids = state.pages[start_page:n_pages]
                if ids:
                    with tracing.span("disagg.kv_extract", request_id=rp.request_id, trace_id=req.trace_id,
                                      pages=len(ids), mode=mode):
                        if mode == "ici":
                            data = self.runner.extract_pages_device(np.asarray(ids, np.int32))
                        else:
                            data = self.runner.extract_pages(np.asarray(ids, np.int32))
        finally:
            self.allocator.free_sequence(rid)  # full blocks stay cached for reuse

        transfer_id = ""
        payload = None
        if data is not None:
            payload = data.data if mode == "ici" else data
            payload = payload["q"] if is_quantized_wire(payload) else payload
        if mode == "ici" and data is not None:
            transfer_id = ici.transfer_key(rp.decode_worker_id, rp.request_id)
            if not ici.put_transfer(transfer_id, data):
                transfer_id = ""  # the consumer abandoned the request already
        # int8 caches export the {"q", "s"} wire dict: shape / dtype describe
        # the int8 payload; the scale plane rides its own result fields on
        # the inline path (sockets carry it in part headers instead)
        inline = data is not None and mode == "inline"
        scales = data["s"] if (inline and is_quantized_wire(data)) else None
        result = PrefillResult(
            request_id=rp.request_id,
            first_token=int(first_token),
            prompt_len=prompt_len,
            skip_leading_tokens=start_page * ps,
            kv_shape=tuple(payload.shape) if payload is not None else (),
            kv_dtype=wire_dtype_name(payload.dtype) if payload is not None else "",
            kv_bytes=bytes(tensor_bytes(payload)) if inline else b"",
            kv_transfer_id=transfer_id,
            kv_mode="socket" if plan else (mode if data is not None else "inline"),
            kv_parts=len(plan),
            kv_scales_bytes=bytes(tensor_bytes(scales)) if scales is not None else b"",
            kv_scales_shape=tuple(scales.shape) if scales is not None else (),
            kv_scales_dtype=wire_dtype_name(scales.dtype) if scales is not None else "",
        )
        return result, (data if mode == "socket" else None)

    def sync_adopt_prefilled(self, req: EngineRequest, result, cached_len: int, kv_data=None,
                             injected_pages: int = 0) -> None:
        """Decode side: write the received KV into the pre-allocated pages
        and enter the sequence into decode (its first output is posted to
        its stream here). KV arrives as inline bytes, as a device block
        through the ici hub, as host blocks the caller pulled off the data
        plane (``kv_data``), or, streamed, already scattered part by part,
        where ``injected_pages`` says how many pages the caller wrote and
        this only checks the count. A missing ici transfer raises."""
        from dynamo_tpu_torch.disagg import ici

        state = self.allocator._seqs[req.request_id]
        ps = self.config.page_size
        data = kv_data
        if data is None and result.kv_transfer_id:
            data = ici.pop_transfer(result.kv_transfer_id)
            if data is None:
                raise RuntimeError(f"ici transfer {result.kv_transfer_id} missing for {req.request_id}")
        elif data is None and result.kv_bytes:
            data = result.kv_array()
        start_page = result.skip_leading_tokens // ps
        n_pages = -(-result.prompt_len // ps)
        ids = state.pages[start_page:n_pages]
        if data is not None:
            with tracing.span("disagg.kv_inject", request_id=req.request_id, trace_id=req.trace_id,
                              pages=len(ids), mode=result.kv_mode):
                self.runner.inject_pages(np.asarray(ids, np.int32), data)
        elif injected_pages:
            # streamed adoption: a count short of the range means a part was
            # lost, and decoding from the hole would be silent corruption
            if injected_pages != len(ids):
                raise RuntimeError(
                    f"streamed KV for {req.request_id} injected {injected_pages} pages, expected {len(ids)}"
                )
        elif ids:
            raise RuntimeError(
                f"prefill result for {req.request_id} carried no KV for {len(ids)} pending pages"
            )
        self.allocator.commit_prefilled(req.request_id, result.prompt_len)
        self._post_grouped(self.scheduler.adopt_prefilled(req, result.first_token, cached_len))

    # ---------------- engine thread ----------------

    def _run_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stopping.is_set():
            self.health.beat()
            now = time.monotonic()
            if now >= self._next_watchdog:
                # stuck-request watchdog: degrade (and auto-recover) on a
                # too-old waiting queue or a frozen progress marker while
                # work exists: the signals a wedged device op produces
                self._next_watchdog = now + _WATCHDOG_INTERVAL_S
                self.health.check(
                    oldest_waiting_age=self.scheduler.oldest_waiting_age(now),
                    has_work=self.scheduler.has_work(),
                    progress_marker=self.scheduler.progress_marker(),
                )
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
