"""Live migration's failure ladder and the worker drain on the CPU (the
rest of the port of ``tests/test_migration.py``; the manifest, the fault
plans and the parity cases are ``tests/test_torch_migration.py``):

  - injected ``seq_handoff`` pull faults (a dropped part: the destination's
    ``migration_timeout_s`` fires; a corrupt checksum: the part is refused)
    degrade the ADOPTION to recompute from history, with the uninterrupted
    run's tokens;
  - a destination that dies before its first continuation token unfreezes
    the source, one that dies after relaying tokens makes the source resume
    over history + relayed tokens, and of two racing migrations of one
    sequence exactly one goes: the same tokens in every arm;
  - a source whose pull server dies after the manifest: the destination
    recomputes the whole history and continues with the same tokens;
  - ``POST /admin/drain`` on one of two ``WorkerService`` replicas on one
    broker while its streams decode: every client stream ends at full length
    with ``AsyncJaxEngine``'s tokens, the drain reports ``migrated`` > 0, the
    drained worker reports ``draining`` and leaves the KV router's index;
  - a waiting critical request sheds a batch lane through the scheduler's
    ``migrate_shed`` hook (the lane finishes on a peer), with the shed
    cooldown.
"""

import asyncio
import http.client
import json
import time

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu_torch.components.processor import ProcessorService
from dynamo_tpu_torch.components.worker import WorkerService
from dynamo_tpu_torch.cplane.broker import Broker
from dynamo_tpu_torch.disagg.prefix_fetch import KvPullServer, PrefixFetchClient
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.frontends.pipeline import card_for_model
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

torch.set_num_threads(2)

N_OUT = 32
ENGINE = dict(page_size=4, num_pages=96, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32),
              decode_steps=2, pipeline_depth=1)
PROMPTS = {name: [(k * 131 + j * 7) % 250 + 1 for j in range(24)]
           for k, name in enumerate(("drop", "corrupt", "dead", "flaky", "double", "source", "d0", "d1", "d2"))}


@pytest.fixture(scope="module")
def reference():
    """AsyncJaxEngine's greedy tokens ({prompt: tokens}) and its weights."""

    async def run():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, **ENGINE))
        await engine.start()
        try:
            outs = {}
            for i, p in enumerate(PROMPTS.values()):
                toks = []
                async for o in engine.generate(JaxEngineRequest(f"j{i}", list(p), JaxSamplingParams(
                        temperature=0.0, max_tokens=N_OUT, ignore_eos=True))):
                    if o.token is not None:
                        toks.append(o.token)
                outs[tuple(p)] = toks
            return outs, jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
        finally:
            await engine.shutdown()

    return asyncio.run(run())


def port_engine(params, sink=None, **over):
    cfg = LlamaConfig.tiny()
    model = LlamaModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    return AsyncTorchEngine(EngineConfig(device="cpu", **dict(ENGINE, **over)), model=model, kv_event_sink=sink)


def _req(rid, prompt, n=N_OUT, priority=""):
    return EngineRequest(rid, list(prompt), SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True),
                         priority=priority)


async def _collect(engine, req):
    toks, finish = [], None
    async for out in engine.generate(req):
        if out.token is not None:
            toks.append(out.token)
        if out.finished:
            finish = out.finish_reason
    return toks, finish


async def _wait_generated(engine, rid, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        seq = next((s for s in engine.scheduler.slots if s is not None and s.req.request_id == rid), None)
        if seq is not None and not seq.finished and len(seq.generated) >= n:
            return True
        await asyncio.sleep(0.002)
    return False


async def _wire_pair(src, dst, timeout_s=30.0):
    srv = await KvPullServer(src, host="127.0.0.1").start()
    src.kv_pull_server = srv
    dst.attach_prefix_fetch(PrefixFetchClient(asyncio.get_running_loop(), timeout_s=timeout_s))
    return srv


def test_pull_faults_degrade_to_recompute(reference, monkeypatch):
    outs, params = reference

    async def body():
        src, dst = port_engine(params), port_engine(params, migration_timeout_s=1.0)
        await src.start()
        await dst.start()
        srv = await _wire_pair(src, dst)
        try:
            for arm, fault in (("drop", "seq_handoff=drop-part"), ("corrupt", "seq_handoff=corrupt-checksum")):
                prompt = PROMPTS[arm]
                monkeypatch.setenv("DYNTPU_FAULT_DATAPLANE", fault)
                try:
                    task = asyncio.ensure_future(_collect(src, _req(arm, prompt)))
                    assert await _wait_generated(src, arm, 6)
                    t0 = time.monotonic()
                    res = await src.migrate_out(arm, dst.adopt_migrated)
                    assert res["status"] == "ok", (fault, res)  # only the KV pull degraded
                    got, finish = await task
                    assert finish == "length" and got == outs[tuple(prompt)], fault
                    assert time.monotonic() - t0 < 30.0  # the belt held
                finally:
                    monkeypatch.delenv("DYNTPU_FAULT_DATAPLANE", raising=False)
            d = dst.scheduler
            assert (d.migration_in, d.migration_in_recomputed, d.migration_in_pulled) == (2, 2, 0)
            assert dst.prefix_fetcher.results == {"timeout": 1, "error": 1}
        finally:
            await srv.stop()
            await src.shutdown()
            await dst.shutdown()

    asyncio.run(body())


def test_destination_death_and_double_migration(reference):
    outs, params = reference

    async def body():
        src, dst = port_engine(params), port_engine(params)
        await src.start()
        await dst.start()
        srv = await _wire_pair(src, dst)
        try:
            async def dead_adopter(manifest):
                raise ConnectionError("destination gone")
                yield  # pragma: no cover

            task = asyncio.ensure_future(_collect(src, _req("dead", PROMPTS["dead"])))
            assert await _wait_generated(src, "dead", 8)
            res = await src.migrate_out("dead", dead_adopter)
            assert res["status"] == "failed"
            assert await task == (outs[tuple(PROMPTS["dead"])], "length")
            assert (src.scheduler.migration_out_failed, src.scheduler.migration_out) == (1, 0)

            async def flaky_adopter(manifest):
                n = 0
                async for out in dst.adopt_migrated(manifest):
                    yield out
                    n += out.token is not None
                    if n >= 2:
                        raise ConnectionError("destination crashed mid-stream")

            task = asyncio.ensure_future(_collect(src, _req("flaky", PROMPTS["flaky"])))
            assert await _wait_generated(src, "flaky", 8)
            res = await src.migrate_out("flaky", flaky_adopter)
            assert res == {"status": "resumed", "tokens_relayed": 2}
            assert await task == (outs[tuple(PROMPTS["flaky"])], "length")  # relayed tokens not emitted twice
            assert src.scheduler.migration_out_failed == 2

            task = asyncio.ensure_future(_collect(src, _req("double", PROMPTS["double"])))
            assert await _wait_generated(src, "double", 8)
            r1, r2 = await asyncio.gather(src.migrate_out("double", dst.adopt_migrated),
                                          src.migrate_out("double", dst.adopt_migrated))
            assert sorted([r1["status"], r2["status"]]) == ["ok", "skipped"], (r1, r2)
            assert await task == (outs[tuple(PROMPTS["double"])], "length")
            assert src.allocator.active_pages == 0 and dst.allocator.active_pages == 0
        finally:
            await srv.stop()
            await src.shutdown()
            await dst.shutdown()

    asyncio.run(body())


def test_source_death_after_the_manifest(reference):
    outs, params = reference
    prompt = PROMPTS["source"]
    expected = outs[tuple(prompt)]

    async def body():
        src, dst = port_engine(params), port_engine(params, migration_timeout_s=2.0)
        await src.start()
        await dst.start()
        srv = await _wire_pair(src, dst)
        try:
            task = asyncio.ensure_future(_collect(src, _req("s1", prompt)))
            assert await _wait_generated(src, "s1", 8)
            manifest = await src.run_on_engine(lambda: src.sync_snapshot_for_migration("s1"))
            assert manifest is not None and manifest.kv_blocks > 0
            k = len(manifest.generated)
            await srv.stop()  # the source's pull server goes away mid-handoff
            cont = [out async for out in dst.adopt_migrated(manifest)]
            assert [o.token for o in cont if o.token is not None] == expected[k:]
            assert cont[-1].finished and cont[-1].finish_reason == "length"
            assert (dst.scheduler.migration_in_recomputed, dst.scheduler.migration_in_pulled) == (1, 0)
            assert await src.run_on_engine(lambda: src.sync_abort_migration("s1"))
            assert await task == (expected, "length")
        finally:
            await src.shutdown()
            await dst.shutdown()

    asyncio.run(body())


def test_admin_drain_migrates_streams_to_the_peer(reference):
    outs, params = reference

    async def body():
        cleanups = []
        broker = Broker()
        addr = f"127.0.0.1:{await broker.start()}"
        cleanups.append(broker.stop)

        async def runtime():
            rt = DistributedRuntime(cplane_address=addr)
            await rt.connect()
            cleanups.append(rt._shutdown_hook)
            return rt

        card = card_for_model("tiny", ENGINE["max_model_len"])
        card.kv_block_size = ENGINE["page_size"]
        try:
            workers = []
            for admin in (0, None):
                rt = await runtime()
                svc = WorkerService(rt, "m", "backend", card, EngineConfig(device="cpu", **ENGINE),
                                    engine_factory=lambda sink: port_engine(params, sink), admin_port=admin)
                await svc.start()
                cleanups.append(svc.stop)
                workers.append((svc, rt.primary_lease.lease_id))
            (a, a_id), (b, b_id) = workers
            assert a._stats()["migration"] == {"enabled": True} and a._stats()["admin"]["address"].startswith("127.")
            proc = ProcessorService(await runtime(), "m", component="processor", worker_component="backend",
                                    kv_block_size=ENGINE["page_size"], routing="kv")
            await proc.start()
            proc.router.aggregator.interval = 0.1
            cleanups.append(proc.stop)
            client = await (await runtime()).client("m", "backend", "generate")
            await client.wait_for_instances(10)
            while len(client.instance_ids()) < 2:
                await asyncio.sleep(0.02)

            async def stream(name):
                pre = PreprocessedRequest(name, list(PROMPTS[name]), SamplingParams(temperature=0.0, max_tokens=N_OUT,
                                                                                     ignore_eos=True))
                toks, finish = [], None
                async for item in await client.direct(pre.to_wire(), a_id):
                    toks += item.get("token_ids") or []
                    finish = item.get("finish_reason") or finish
                return toks, finish

            names = ("d0", "d1", "d2")
            tasks = [asyncio.ensure_future(stream(n)) for n in names]
            for n in names:
                assert await _wait_generated(a._inner_engine, n, 4)

            def post_drain():
                conn = http.client.HTTPConnection("127.0.0.1", a.admin_port, timeout=60)
                try:
                    conn.request("POST", "/admin/drain", body=json.dumps({"target": f"{b_id:x}"}).encode(),
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    return resp.status, json.loads(resp.read())
                finally:
                    conn.close()

            status, report = await asyncio.get_running_loop().run_in_executor(None, post_drain)
            assert status == 200 and report["migration"] == "done" and report["migrated"] > 0, report
            assert report["target_instance"] == f"{b_id:x}" and report["failed"] == 0
            for n, t in zip(names, tasks):
                assert await t == (outs[tuple(PROMPTS[n])], "length"), n
            assert a._inner_engine.health.state == "draining"
            assert b._inner_engine.scheduler.migration_in == report["migrated"]
            assert a._inner_engine.scheduler.migration_out == report["migrated"]
            deadline = time.monotonic() + 10
            while a_id not in proc.router._pruned_unservable and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            assert a_id in proc.router._pruned_unservable  # the drained worker left the router's index
        finally:
            for stop in reversed(cleanups):
                try:
                    await stop()
                except Exception:
                    pass

    asyncio.run(body())


def test_qos_shed_migrates_the_victim(reference):
    """Every slot held by batch lanes: a waiting critical request past the
    wait gate sheds the most recent batch lane through ``migrate_shed``
    (here: straight to a peer engine); the lane ends on the peer with its
    baseline tokens, the critical request is served, and the cooldown keeps
    a second shed from firing while the first is in flight."""
    outs, params = reference

    async def body():
        src = port_engine(params, max_seqs=2, qos_preempt_wait_ms=10.0)
        dst = port_engine(params)
        await src.start()
        await dst.start()
        srv = await _wire_pair(src, dst)
        loop = asyncio.get_running_loop()
        handoffs = []

        def shed(rid):
            handoffs.append(asyncio.run_coroutine_threadsafe(src.migrate_out(rid, dst.adopt_migrated), loop))
            return True

        src.scheduler.migrate_shed = shed
        try:
            lanes = [asyncio.ensure_future(_collect(src, _req(n, PROMPTS[n], priority="batch"))) for n in ("d0", "d1")]
            for n in ("d0", "d1"):
                assert await _wait_generated(src, n, 4)
            crit = await _collect(src, _req("crit", PROMPTS["d2"], n=8, priority="critical"))
            assert crit == (outs[tuple(PROMPTS["d2"])][:8], "length")
            for n, t in zip(("d0", "d1"), lanes):
                assert await t == (outs[tuple(PROMPTS[n])], "length"), n
            assert len(handoffs) >= 1 and all(h.result(30)["status"] == "ok" for h in handoffs)
            s = src.scheduler
            assert s.qos_shed_migrations == len(handoffs) and s.preempt_count == 0
            assert src.resource_snapshot()["qos"]["shed_migrations"] == len(handoffs)
        finally:
            await srv.stop()
            await src.shutdown()
            await dst.shutdown()

    asyncio.run(body())
