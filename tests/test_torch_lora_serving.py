"""Multi-LoRA across the port's serving layers on the CPU (the tiny model,
f32): adapter model names over HTTP (``/v1/models``, the adapter stamped on
the request, a structured 404 before any SSE byte for an unknown adapter,
unary and stream), the worker's adapter registrations and ``base:adapter``
resolution behind the runtime, the decode worker's salted prefix lookup
(the reference's salt), the fleet prefix pull between two engines (an
adapter's prefix serves the same adapter, never the base model) and a
migrated LoRA lane (the manifest carries the adapter, the destination pins
its own slot and the salted handoff pull lands), after the reference's
``tests/test_multi_lora.py`` and ``tests/test_migration.py:572``."""

import asyncio
import http.client
import json
import threading
import time

import pytest
import torch

from dynamo_tpu.lora.adapter import lora_uid as ref_lora_uid
from dynamo_tpu_torch.components.worker import WorkerService
from dynamo_tpu_torch.cplane.broker import Broker
from dynamo_tpu_torch.disagg.prefix_fetch import KvPullServer, PrefixFetchClient
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.frontends.pipeline import card_for_model
from dynamo_tpu_torch.llm.model_registry import list_models
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

torch.set_num_threads(2)

ENGINE = dict(page_size=4, num_pages=128, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
LORA = dict(lora_adapters=("a1=random:7", "a2=random:8"), max_loras=2, lora_rank=4)
PROMPT = list(range(1, 25))  # 6 full blocks at page size 4


def engine(**over) -> AsyncTorchEngine:
    return AsyncTorchEngine(EngineConfig(device="cpu", **{**ENGINE, **LORA, **over}))


def req(rid, prompt=PROMPT, n=8, lora="", holder="", blocks=0):
    return EngineRequest(rid, list(prompt), SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True),
                         lora_name=lora, kv_holder_addr=holder, kv_holder_blocks=blocks)


async def collect(eng, r):
    toks, cached, finish = [], 0, None
    async for out in eng.generate(r):
        if out.token is not None:
            toks.append(out.token)
        cached = max(cached, out.cached_tokens)
        finish = out.finish_reason or finish
    return toks, cached, finish


# ---------------- HTTP: adapter model names ----------------


class Service:
    """``run --in http``'s service (``frontends/http.py build_service``) on a
    LoRA engine, on a background loop; records the adapter every request
    reached the engine with."""

    def __init__(self):
        from argparse import Namespace

        from dynamo_tpu_torch.frontends.http import build_service

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.seen = []

        async def boot():
            self.engine = engine()
            await self.engine.start()
            generate = self.engine.generate_batched

            def recording(request):
                self.seen.append(request.lora_name)
                return generate(request)

            self.engine.generate_batched = recording
            self.service = build_service(self.engine, Namespace(model="tiny", http_port=0, max_model_len=64),
                                         host="127.0.0.1")
            return await self.service.start()

        self.port = self.run(boot())

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(120)

    def close(self):
        async def stop():
            await self.service.stop()
            await self.engine.shutdown()

        self.run(stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.fixture(scope="module")
def service():
    s = Service()
    yield s
    s.close()


def call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type") or "", resp.read()
    finally:
        conn.close()


def chat(model, stream=False):
    return {"model": model, "messages": [{"role": "user", "content": "hello"}], "max_tokens": 6, "temperature": 0,
            "stream": stream}


def test_http_models_list_the_adapters_and_each_reaches_the_engine(service):
    status, _, body = call(service.port, "GET", "/v1/models")
    assert status == 200
    assert {m["id"] for m in json.loads(body)["data"]} == {"tiny", "tiny:a1", "tiny:a2"}
    texts = {}
    for model in ("tiny", "tiny:a1", "tiny:a1", "tiny:a2"):
        service.seen.clear()
        status, _, body = call(service.port, "POST", "/v1/chat/completions", chat(model))
        assert status == 200
        out = json.loads(body)
        assert out["model"] == model and out["usage"]["completion_tokens"] == 6
        assert service.seen == [model.partition(":")[2]]
        texts.setdefault(model, set()).add(out["choices"][0]["message"]["content"])
    assert all(len(t) == 1 for t in texts.values())  # greedy: deterministic per model name
    assert len({next(iter(t)) for t in texts.values()}) == 3  # the adapters bite


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", chat("tiny:nope")),
    ("/v1/chat/completions", chat("tiny:nope", stream=True)),
    ("/v1/completions", {"model": "tiny:nope", "prompt": "hi", "max_tokens": 4, "stream": True}),
], ids=["chat-unary", "chat-stream", "completion-stream"])
def test_http_unknown_adapter_is_a_404_before_any_sse_byte(service, path, body):
    status, ctype, raw = call(service.port, "POST", path, body)
    assert status == 404 and "text/event-stream" not in ctype and not raw.startswith(b"data:")
    err = json.loads(raw)["error"]
    assert err["code"] == "model_not_found" and "tiny:nope" in err["message"]


# ---------------- the worker behind the runtime ----------------


def test_worker_registers_each_adapter_and_resolves_the_suffix():
    """Each adapter registers as model ``tiny:<name>`` on the worker's
    endpoint; a request naming ``tiny:a1`` (no lora_name on the wire) is
    served with adapter a1, as the same request with lora_name a1 is."""

    async def body():
        broker = Broker()
        addr = f"127.0.0.1:{await broker.start()}"
        rt = DistributedRuntime(cplane_address=addr)
        await rt.connect()
        card = card_for_model("tiny", ENGINE["max_model_len"])
        card.kv_block_size = ENGINE["page_size"]
        svc = WorkerService(rt, "g", "backend", card, EngineConfig(device="cpu", **ENGINE, **LORA))
        await svc.start()
        try:
            names = sorted(e.name for e in await list_models(rt.cplane))
            assert names == ["tiny", "tiny:a1", "tiny:a2"]
            client = await rt.client("g", "backend", "generate")
            await client.wait_for_instances(5)

            async def through(rid, **kw):
                pre = PreprocessedRequest(rid, PROMPT, SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True),
                                          **kw)
                toks = []
                async for item in await client.random(pre.to_wire()):
                    toks += item.get("token_ids") or []
                return toks

            by_name = await through("n", model="tiny:a1")
            assert by_name == await through("l", model="tiny", lora_name="a1")
            assert by_name != await through("b", model="tiny")
            assert svc.engine.resource_snapshot()["lora_requests"]["a1"] == 2
            await client.stop()
        finally:
            await svc.stop()
            await rt._shutdown_hook()
            await broker.stop()

    asyncio.run(body())


# ---------------- salted prefix identity: decode worker, fleet pull, migration ----------------


class _Cplane:
    async def queue_depth(self, name):
        return 0


class _Drt:
    cplane = _Cplane()


class _LocalRouter:
    def prefill_remote(self, prompt_len, prefix_hit, queue_depth):
        return False


def test_decode_worker_prefix_lookup_is_salted():
    """The disagg decode worker estimates the prefix hit with the adapter's
    uid (the reference's salt): an adapter's cached prefix counts for that
    adapter only, and the request still prefills locally."""
    from dynamo_tpu_torch.disagg.decode_worker import DisaggDecodeEngine

    async def body():
        inner = engine()
        await inner.start()
        try:
            decode = DisaggDecodeEngine(inner, _Drt(), "ns", "decoder", "tiny", disagg_router=_LocalRouter())
            lookups = []
            lookup = inner.sync_lookup_prefix

            def recording(token_ids, salt=0):
                hit = lookup(token_ids, salt=salt)
                lookups.append((salt, hit))
                return hit

            inner.sync_lookup_prefix = recording

            async def through(rid, lora):
                out = []
                async for batch in decode.generate_batched(req(rid, lora=lora)):
                    out += [o.token for o in batch if o.token is not None]
                return out

            first = await through("a", "a1")
            again = await through("b", "a1")
            base = await through("c", "")
            assert first == again != base
            salt = ref_lora_uid("a1")
            assert lookups == [(salt, 0), (salt, 24), (0, 0)]
            assert decode.local_prefills == 3 and decode.remote_prefills == 0
        finally:
            await inner.shutdown()

    asyncio.run(body())


def test_fleet_pull_is_salted():
    """A holder's adapter prefix serves a peer's request for the same
    adapter (a hit, its tokens), while a base request for the same tokens
    falls back to recompute (the holder has no unsalted blocks)."""

    async def body():
        holder, puller = engine(), engine()
        for e in (holder, puller):
            await e.start()
        srv = None
        try:
            expected, _, _ = await collect(holder, req("seed", lora="a1"))
            base_expected, _, _ = await collect(holder, req("seed-base"))
            srv = await KvPullServer(holder, host="127.0.0.1").start()
            puller.attach_prefix_fetch(PrefixFetchClient(asyncio.get_running_loop(), timeout_s=30.0))
            await holder.run_on_engine(holder.allocator.reset_prefix_cache)  # the base blocks go
            await collect(holder, req("seed-again", lora="a1"))
            got, cached, _ = await collect(puller, req("pull", lora="a1", holder=srv.address, blocks=6))
            assert got == expected and cached == 20
            s = puller.scheduler
            assert (s.prefix_fetch_hits, s.prefix_fetch_blocks) == (1, 5)
            got, cached, _ = await collect(puller, req("pull-base", holder=srv.address, blocks=6))
            assert got == base_expected != expected and cached == 0
            assert (s.prefix_fetch_hits, s.prefix_fetch_fallbacks) == (1, 1)
        finally:
            if srv is not None:
                await srv.stop()
            for e in (holder, puller):
                await e.shutdown()

    asyncio.run(body())


def test_migrate_lora_lane_token_parity():
    """A LoRA lane migrates mid-decode: the destination pins its own slot at
    admission, the salted handoff pull lands, and the stream ends with the
    tokens of an unmigrated run (which differ from the base model's)."""

    async def body():
        # two-step windows, one in flight: the lane is caught mid-decode
        base, src, dst = (engine(decode_steps=2, pipeline_depth=1) for _ in range(3))
        for e in (base, src, dst):
            await e.start()
        srv = await KvPullServer(src, host="127.0.0.1").start()
        src.kv_pull_server = srv
        dst.attach_prefix_fetch(PrefixFetchClient(asyncio.get_running_loop(), timeout_s=30.0))
        try:
            expected, _, _ = await collect(base, req("b1", n=32, lora="a1"))
            assert expected != (await collect(base, req("b2", n=32)))[0]
            await collect(dst, req("warm", n=4, lora="a2"))
            task = asyncio.ensure_future(collect(src, req("m1", n=32, lora="a1")))
            deadline = time.monotonic() + 60
            while not any(s is not None and len(s.generated) >= 8 for s in src.scheduler.slots):
                assert time.monotonic() < deadline
                await asyncio.sleep(0.002)
            res = await src.migrate_out("m1", dst.adopt_migrated)
            assert res["status"] == "ok", res
            got, _, finish = await task
            assert finish == "length" and got == expected
            assert dst.scheduler.migration_in_pulled == 1
            src_store, dst_store = src.runner.lora_store, dst.runner.lora_store
            assert src_store.refs == {} and dst_store.refs == {}
            assert dst_store.requests == {"a1": 1, "a2": 1}
        finally:
            await srv.stop()
            for e in (base, src, dst):
                await e.shutdown()

    asyncio.run(body())
