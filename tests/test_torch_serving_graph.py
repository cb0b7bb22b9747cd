"""The port's aggregated serving graph on the CPU (port of
``tests/test_serving_graph.py`` and the routing cases around it): the port's
broker, the discovery frontend (``components/frontend.py``), a KV-aware
processor (``components/processor.py``) and two worker replicas
(``components/worker.py``) on tiny f32 CPU engines built on the JAX
engine's weights (``params_from_jax``), each component on its own
``DistributedRuntime``.

  - greedy completions over HTTP give ``AsyncJaxEngine``'s tokens, and a
    session's second turn through the ``kv`` processor lands on the worker
    that served its first, with the cached tokens the allocation rule
    gives (the processor's stream carries the worker's output dicts);
  - models attach when a worker registers and detach when its lease goes;
    ``/ready`` answers 503 with no model or no live instance and 200 with
    the instances, ``/live`` always 200;
  - a worker's death: the router drops it from its index, the next requests
    over HTTP all land on the survivor and none fails, ``/ready`` follows;
  - the port's processor routes to a reference ``WorkerService`` (over an
    ``AsyncJaxEngine``) and the reference's processor to a port worker,
    over one broker, with the reference's tokens;
  - the worker refuses what is not ported (``NotPorted``), takes the KV
    tier and migration flags, and the processor refuses a LoRA request.
"""

import asyncio
import http.client
import json

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu_torch.components.frontend import FrontendService
from dynamo_tpu_torch.components.processor import ProcessorService
from dynamo_tpu_torch.components.worker import WorkerService, build_parser, engine_config_for
from dynamo_tpu_torch.cplane.broker import Broker
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.frontends.pipeline import card_for_model
from dynamo_tpu_torch.launch._run_impl import NotPorted
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, get_tokenizer
from dynamo_tpu_torch.llm.tokens import TokenSequence
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

torch.set_num_threads(2)

PS = 4
ENGINE = dict(page_size=PS, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
N_OUT = 6
FIRST = [[(11 * s + 7 * i) % 200 + 20 for i in range(14 + 3 * s)] for s in range(3)]  # three sessions' turn 1


def detok(prompt: list, toks: list) -> str:
    """The text the worker's detokenizer streams for ``toks`` after
    ``prompt`` (byte vocabulary: an incomplete UTF-8 tail is held back)."""
    d = DecodeStream(get_tokenizer("byte"), prompt_ids=prompt)
    return "".join(d.step(t) or "" for t in toks)


def second_turn(first: list, out: list) -> list:
    """A session's next prompt: the history, its output and one more token."""
    return list(first) + list(out) + [5]


def expected_cached(served: list, prompt: list) -> int:
    """The prefix-cache hit the allocation rule gives ``prompt`` after
    ``served`` [(prompt, generated)] on one worker (``chip_smoke.py``'s
    helper)."""
    registered = set()
    for p, gen in served:
        blocks = TokenSequence(list(p) + list(gen), PS).blocks
        n = max(len(p) // PS, (len(p) + len(gen) - 1) // PS)
        registered |= {b.sequence_hash for b in blocks[:n]}
    hits = 0
    for block in TokenSequence(prompt, PS).blocks:
        if block.sequence_hash not in registered:
            break
        hits += 1
    if hits and hits * PS >= len(prompt):
        hits -= 1
    return hits * PS


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    yield lp
    lp.close()


@pytest.fixture(scope="module")
def reference(loop):
    """The JAX engine, left running on the module's loop, its greedy tokens
    for every session's two turns ({prompt: tokens}) and its params."""

    async def run():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, **ENGINE))
        await engine.start()

        async def greedy(rid, prompt):
            toks = []
            async for o in engine.generate(JaxEngineRequest(rid, list(prompt), JaxSamplingParams(max_tokens=N_OUT))):
                if o.token is not None:
                    toks.append(o.token)
            return toks

        outs = {}
        for s, p in enumerate(FIRST):
            outs[tuple(p)] = await greedy(f"a{s}", p)
            p2 = second_turn(p, outs[tuple(p)])
            outs[tuple(p2)] = await greedy(f"b{s}", p2)
        return engine, outs, jax.tree.map(np.asarray, jax.device_get(engine.runner.params))

    engine, outs, params = loop.run_until_complete(run())
    yield engine, outs, params
    loop.run_until_complete(engine.shutdown())


def port_engine(params, sink=None) -> AsyncTorchEngine:
    cfg = LlamaConfig.tiny()
    model = LlamaModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    return AsyncTorchEngine(EngineConfig(device="cpu", **ENGINE), model=model, kv_event_sink=sink)


def card():
    c = card_for_model("tiny", ENGINE["max_model_len"])
    c.kv_block_size = PS
    return c


class Graph:
    """A broker and the components on it, each on its own runtime; ``close``
    stops everything in reverse order."""

    def __init__(self):
        self.cleanups = []
        self.served: dict[int, list] = {}  # worker id -> request ids it served

    async def start_broker(self):
        self.broker = Broker()
        self.addr = f"127.0.0.1:{await self.broker.start()}"
        self.cleanups.append(self.broker.stop)
        return self

    async def runtime(self):
        rt = DistributedRuntime(cplane_address=self.addr)
        await rt.connect()
        self.cleanups.append(rt._shutdown_hook)
        return rt

    async def worker(self, params, register=True, component="backend"):
        rt = await self.runtime()
        svc = WorkerService(rt, "g", component, card(), EngineConfig(device="cpu", **ENGINE), register=register,
                            engine_factory=lambda sink: port_engine(params, sink))
        await svc.start()
        self.cleanups.append(svc.stop)
        wid = rt.primary_lease.lease_id
        self.served[wid] = []
        generate = svc.backend.generate

        async def recording(pre):  # which worker served which request
            self.served[wid].append(pre.request_id)
            async for out in generate(pre):
                yield out

        svc.backend.generate = recording
        return svc, rt

    async def processor(self, routing="kv", component="processor", worker_component="backend"):
        proc = ProcessorService(await self.runtime(), "g", component=component, worker_component=worker_component,
                                kv_block_size=PS, routing=routing)
        await proc.start()
        if proc.router is not None:
            proc.router.aggregator.interval = 0.1
        self.cleanups.append(proc.stop)
        return proc

    async def frontend(self):
        fe = FrontendService(await self.runtime(), host="127.0.0.1", port=0)
        self.port = await fe.start()
        self.cleanups.append(fe.stop)
        return fe

    async def close(self):
        for stop in reversed(self.cleanups):
            try:
                await stop()
            except Exception:
                pass


def http_call(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, json.dumps(body) if body is not None else None)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def completion(prompt):
    return {"model": "tiny", "prompt": list(prompt), "max_tokens": N_OUT, "temperature": 0,
            "ext": {"ignore_eos": True}}


async def call(port, method, path, body=None):
    return await asyncio.to_thread(http_call, port, method, path, body)


async def through(client, rid: str, prompt: list, **route):
    """One greedy request through a processor's endpoint: (tokens, first
    output's cached tokens, finish reason)."""
    pre = PreprocessedRequest(rid, list(prompt), SamplingParams(temperature=0.0, max_tokens=N_OUT, ignore_eos=True))
    toks, cached, finish = [], None, None
    async for item in await client.random(pre.to_wire()):
        toks += item.get("token_ids") or []
        cached = item.get("cached_tokens", 0) if cached is None else cached
        finish = item.get("finish_reason") or finish
    return toks, cached, finish


async def until(pred, what: str, timeout: float = 10.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.05)


def test_greedy_http_and_second_turns_land_on_their_holders(loop, reference):
    _, outs, params = reference

    async def body():
        g = await Graph().start_broker()
        try:
            workers = [await g.worker(params, register=False) for _ in range(2)]
            proc = await g.processor()
            fe = await g.frontend()
            # the model is served through the processor tier
            from dynamo_tpu_torch.llm.model_registry import ModelEntry, register_model

            await register_model(proc.drt.cplane, ModelEntry("tiny", "dyn://g.processor.generate", card=card()))
            await until(lambda: fe.service.manager.list_models() == ["tiny"], "model attach")
            client = await proc.drt.client("g", "processor", "generate")
            await client.wait_for_instances(5)
            for s, p in enumerate(FIRST):
                status, body = await call(g.port, "POST", "/v1/completions", completion(p))
                assert status == 200 and body["usage"]["completion_tokens"] == N_OUT, body
                assert body["choices"][0]["text"] == detok(p, outs[tuple(p)])
                holder = next(w for w, rids in g.served.items() if rids)
                assert sum(map(len, g.served.values())) == 1
                # the holder's KV events reach the index before the next turn
                wanted = len(p) // PS
                await until(lambda: proc.router.indexer.find_matches_for_request(p).scores.get(holder, 0) >= wanted,
                            "kv events indexed")
                p2 = second_turn(p, outs[tuple(p)])
                toks, cached, finish = await through(client, f"t2-{s}", p2)
                assert toks == outs[tuple(p2)] and finish == "length"
                assert len(g.served[holder]) == 2, g.served
                assert cached == expected_cached([(p, outs[tuple(p)])], p2) > 0
                for rids in g.served.values():
                    rids.clear()
            assert proc.router.indexer.backend == "native"
            r = proc.router.indexer.radix_stats()
            assert r["hits_total"] >= len(FIRST) and r["workers"] >= 1
            for svc, _ in workers:
                stats = svc._stats()
                assert stats["health"]["state"] == "ready" and stats["migration"] == {"enabled": True}
                assert stats["kv_pull"]["address"] and "kv_metrics" in stats and "resources" in stats
        finally:
            await g.close()

    loop.run_until_complete(body())


def test_model_attach_detach_and_readiness(loop, reference):
    _, outs, params = reference

    async def body():
        g = await Graph().start_broker()
        try:
            fe = await g.frontend()
            status, ready = await call(g.port, "GET", "/ready")
            assert status == 503 and ready["status"] == "unready" and ready["reason"] == "no models attached"
            assert (await call(g.port, "GET", "/live")) == (200, {"status": "live"})
            svc, rt = await g.worker(params)  # registers "tiny" under its lease
            await until(lambda: fe.service.manager.list_models() == ["tiny"], "model attach")
            status, ready = await call(g.port, "GET", "/ready")
            assert status == 200 and ready["instances"] == {"tiny": 1} and ready["models"] == ["tiny"]
            status, models = await call(g.port, "GET", "/v1/models")
            assert [m["id"] for m in models["data"]] == ["tiny"]
            status, body = await call(g.port, "POST", "/v1/completions", completion(FIRST[0]))
            assert status == 200 and body["usage"]["completion_tokens"] == N_OUT
            await rt._shutdown_hook()  # the worker's lease goes: its card and instance with it
            await until(lambda: fe.service.manager.list_models() == [], "model detach")
            status, ready = await call(g.port, "GET", "/ready")
            assert status == 503 and ready["reason"] == "no models attached"
            assert (await call(g.port, "GET", "/live"))[0] == 200
            assert (await call(g.port, "POST", "/v1/completions", completion(FIRST[0])))[0] == 404
        finally:
            await g.close()

    loop.run_until_complete(body())


def test_worker_death_routes_to_the_survivor(loop, reference):
    _, outs, params = reference

    async def body():
        g = await Graph().start_broker()
        try:
            (a, rt_a), (b, rt_b) = [await g.worker(params) for _ in range(2)]
            id_a, id_b = rt_a.primary_lease.lease_id, rt_b.primary_lease.lease_id
            proc = await g.processor()
            fe = await g.frontend()
            await until(lambda: fe.service.manager.list_models() == ["tiny"], "model attach")
            client = await proc.drt.client("g", "processor", "generate")
            await client.wait_for_instances(5)
            # each worker holds a prefix in the kv router's index
            for s in range(4):
                await through(client, f"w{s}", FIRST[s % 3] + [s])
            await until(lambda: {id_a, id_b} <= {w.worker_id for w in proc.router.scheduler.endpoints.workers},
                        "both workers scraped")
            await until(lambda: all(g.served.values()), "both workers served")
            await rt_b._shutdown_hook()  # revokes B's lease
            await until(lambda: not any(id_b in proc.router.indexer.find_matches_for_request(FIRST[s % 3] + [s]).scores
                                        for s in range(4)), "B dropped from the index", timeout=1.0)
            # the card key is lease-tied to whichever worker put it last: if
            # that was B it goes with B, and A's refresh restores it within
            # one interval (the reference's MDC semantics)
            for _ in range(300):
                backend = fe._backends.get("tiny")
                if backend is not None and await backend.live_instances() == 1:
                    break
                await asyncio.sleep(0.05)
            assert backend._client.instance_ids() == [id_a], "B left the frontend"
            for rids in g.served.values():
                rids.clear()
            statuses = await asyncio.gather(*(call(g.port, "POST", "/v1/completions", completion(FIRST[i % 3]))
                                              for i in range(8)))
            assert [s for s, _ in statuses] == [200] * 8
            assert all(b_["usage"]["completion_tokens"] == N_OUT for _, b_ in statuses)
            assert len(g.served[id_a]) == 8 and g.served[id_b] == []
            status, ready = await call(g.port, "GET", "/ready")
            assert status == 200 and ready["instances"] == {"tiny": 1}
            # the kv router stops placing on B once its scrapes age it out
            await until(lambda: id_b not in [w.worker_id for w in proc.router.scheduler.endpoints.workers],
                        "B aged out of the routing view")
            toks, _, finish = await through(client, "after", FIRST[0])
            assert toks == outs[tuple(FIRST[0])] and finish == "length"
            await rt_a._shutdown_hook()
            await until(lambda: fe.service.manager.list_models() == [], "model detach")
            status, ready = await call(g.port, "GET", "/ready")
            assert status == 503 and (await call(g.port, "GET", "/live"))[0] == 200
        finally:
            await g.close()

    loop.run_until_complete(body())


class _KeepAlive:
    """The fixture's JAX engine behind a reference worker, which must not
    shut it down when the worker stops."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    async def shutdown(self):
        self._engine._extra_kv_sink = None


def test_processors_route_across_packages(loop, reference):
    """The port's kv processor in front of a reference WorkerService, the
    reference's kv processor in front of a port worker, on the port's
    broker: the reference's tokens both ways, and each router indexes the
    other package's KV events."""
    from dynamo_tpu.components.processor import ProcessorService as RefProcessor
    from dynamo_tpu.components.worker import WorkerService as RefWorker
    from dynamo_tpu.frontends.pipeline import card_for_model as ref_card
    from dynamo_tpu.runtime.distributed import DistributedRuntime as RefRuntime

    jax_engine, outs, params = reference

    async def body():
        g = await Graph().start_broker()
        try:
            ref_rt = RefRuntime(cplane_address=g.addr)
            await ref_rt.connect()
            g.cleanups.append(ref_rt._shutdown_hook)

            def factory(sink):
                jax_engine._extra_kv_sink = sink
                return _KeepAlive(jax_engine)

            ref_worker = RefWorker(ref_rt, "g", "rw", ref_card("tiny"),
                                   JaxEngineConfig(model_id="tiny", tp=1, prefix_fetch=False, migration=False,
                                                   **ENGINE),
                                   register=False, engine_factory=factory)
            await ref_worker.start()
            g.cleanups.append(ref_worker.stop)
            port_worker, _ = await g.worker(params, register=False, component="pw")
            port_proc = await g.processor(component="to-ref", worker_component="rw")
            ref_proc_rt = RefRuntime(cplane_address=g.addr)
            await ref_proc_rt.connect()
            g.cleanups.append(ref_proc_rt._shutdown_hook)
            ref_proc = RefProcessor(ref_proc_rt, "g", component="to-port", worker_component="pw", kv_block_size=PS)
            await ref_proc.start()
            g.cleanups.append(ref_proc.stop)
            for proc_name, router in (("to-ref", port_proc.router), ("to-port", ref_proc.router)):
                client = await port_proc.drt.client("g", proc_name, "generate")
                await client.wait_for_instances(5)
                p = [x + 1 for x in FIRST[1]]
                want = None
                for turn in range(2):
                    toks, cached, finish = await through(client, f"{proc_name}-{turn}", p)
                    assert finish == "length" and len(toks) == N_OUT
                    if turn == 0:
                        want = toks
                    else:
                        assert toks == want and cached == expected_cached([(p, want)], p) > 0
                    await until(lambda: router.indexer.find_matches_for_request(p).scores, "events indexed")
            ref_toks, _, _ = await through(await port_proc.drt.client("g", "to-ref", "generate"), "x", FIRST[2])
            assert ref_toks == outs[tuple(FIRST[2])]
            port_toks, _, _ = await through(await port_proc.drt.client("g", "to-port", "generate"), "y", FIRST[2])
            assert port_toks == outs[tuple(FIRST[2])]
            assert port_worker._stats()["kv_metrics"]["request_total_slots"] == ENGINE["max_seqs"]
        finally:
            await g.close()

    loop.run_until_complete(body())


def test_lora_request_is_refused_by_the_processor(loop, reference):
    """Since the port serves LoRA, the processor routes a request naming an
    adapter with the adapter's uid as the routing salt (the reference's
    value), and a worker whose engine has no adapters refuses it: the
    stream ends with finish "error" and the worker serves on."""
    from dynamo_tpu.lora.adapter import lora_uid as ref_lora_uid

    _, outs, params = reference

    async def body():
        g = await Graph().start_broker()
        try:
            await g.worker(params, register=False)
            proc = await g.processor()
            salts = []
            schedule = proc.router.schedule_with_overlap

            async def recording(token_ids, salt=0):
                salts.append(salt)
                return await schedule(token_ids, salt=salt)

            proc.router.schedule_with_overlap = recording
            client = await proc.drt.client("g", "processor", "generate")
            await client.wait_for_instances(5)
            pre = PreprocessedRequest("l", FIRST[0], SamplingParams(max_tokens=2), lora_name="adapter")
            items = [item async for item in await client.random(pre.to_wire())]
            assert items[-1]["finish_reason"] == "error" and not any(i.get("token_ids") for i in items)
            assert salts == [ref_lora_uid("adapter")]
            toks, _, finish = await through(client, "b", FIRST[0])
            assert finish == "length" and toks == outs[tuple(FIRST[0])]
        finally:
            await g.close()

    loop.run_until_complete(body())


@pytest.mark.parametrize("flag", [
    ["--tp", "2"], ["--slo-ttft-ms", "100"], ["--slo-itl-ms", "20"],
], ids=lambda f: f[0].lstrip("-"))
def test_worker_refuses_what_is_not_ported(flag):
    with pytest.raises(NotPorted, match="not ported"):
        engine_config_for(build_parser().parse_args(["tiny", "--device", "cpu", *flag]))


@pytest.mark.parametrize("flag,field,value", [
    (["--host-cache-blocks", "8"], "host_cache_blocks", 8),
    (["--host-cache-bytes", "1024"], "host_cache_bytes", 1024),
    # the reference's rule: the ladder never skips a rung
    (["--disk-cache-bytes", "1024"], "disk_cache_bytes", ValueError),
    (["--disk-cache-dir", "/tmp/x"], "disk_cache_dir", "/tmp/x"),
    (["--offload-watermark", "0.8"], "offload_watermark", 0.8),
    (["--admin-port", "0"], "admin_port", 0),
    (["--migration-timeout-s", "3"], "migration_timeout_s", 3.0),
], ids=lambda f: f[0].lstrip("-") if isinstance(f, list) else "")
def test_worker_takes_the_tier_and_migration_flags(flag, field, value):
    """The KV tier and migration flags reach the engine config (or, the
    admin port, the worker's arguments); disk without a host tier raises
    the reference's ValueError, and with one it is taken."""
    args = build_parser().parse_args(["tiny", "--device", "cpu", *flag])
    if value is ValueError:
        with pytest.raises(ValueError, match="requires a host cache tier"):
            engine_config_for(args)
        args = build_parser().parse_args(["tiny", "--device", "cpu", *flag, "--host-cache-blocks", "4"])
        value = 1024
    cfg = engine_config_for(args)
    assert getattr(args if field == "admin_port" else cfg, field) == value
    defaults = engine_config_for(build_parser().parse_args(["tiny", "--device", "cpu"]))
    assert (defaults.host_cache_blocks, defaults.disk_cache_bytes, defaults.offload_watermark,
            defaults.migration, defaults.migration_timeout_s) == (0, 0, 0.90, True, 10.0)


def test_worker_arguments_reach_the_engine_config():
    cfg = engine_config_for(build_parser().parse_args(
        ["tiny", "--device", "cpu", "--page-size", "8", "--num-pages", "40", "--max-seqs", "3",
         "--max-model-len", "96", "--kv-cache-dtype", "int8", "--no-prefix-fetch", "--prefix-fetch-timeout-s", "2",
         "--prefix-fetch-min-blocks", "3", "--no-migration", "--no-qos", "--no-metering",
         "--prefill-buckets", "8,16", "--prefill-pipeline-depth", "1", "--no-kv-stream"]))
    assert (cfg.page_size, cfg.num_pages, cfg.max_seqs, cfg.max_model_len) == (8, 40, 3, 96)
    assert cfg.kv_cache_dtype == "int8" and not cfg.prefix_fetch and cfg.prefix_fetch_timeout_s == 2.0
    assert cfg.prefix_fetch_min_blocks == 3 and not cfg.qos and cfg.prefill_buckets == (8, 16)
    assert cfg.prefill_pipeline_depth == 1 and not cfg.kv_stream and cfg.device == "cpu" and not cfg.migration
