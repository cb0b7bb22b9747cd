"""Multi-LoRA through the port's engine on the CPU (f32, the tiny model):
greedy tokens against ``AsyncJaxEngine`` on the same weights and adapters
(``params_from_jax``; ``random:<seed>`` adapters are the same numpy arrays in
both packages), a mixed batch against each request alone (full precision
and int8_wo), LRU eviction and hot-swap with pinned slots, unknown adapters,
the adapter-salted prefix cache, speculative verify with mixed adapters,
preemption's release and re-acquire of the pin, the config and CLI
surfaces, and the ``dynamo_lora_*`` families (the port of the cases of
``tests/test_multi_lora.py``)."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu.utils.prometheus import check_exposition
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel

torch.set_num_threads(2)

ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
LORA = dict(lora_adapters=("a1=random:7", "a2=random:8"), max_loras=2, lora_rank=4)
PROMPTS = [np.random.default_rng(5).integers(1, 250, 9).tolist() for _ in range(4)]
LORAS = ["", "a1", "a2", "a1"]
N_OUT = 10
PROMPT = [3, 1, 4, 1, 5, 9, 2]


def req(rid, prompt, n=N_OUT, lora=""):
    return EngineRequest(rid, list(prompt), SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True),
                         lora_name=lora)


async def collect(engine, r):
    toks, cached, finish = [], 0, None
    async for out in engine.generate(r):
        if out.token is not None:
            toks.append(out.token)
        cached = max(cached, out.cached_tokens)
        finish = out.finish_reason or finish
    return toks, cached, finish


@pytest.fixture(scope="module")
def reference():
    """AsyncJaxEngine's greedy tokens for the mixed batch (base, a1, a2,
    a1) and its weights."""

    async def run():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, **ENGINE, **LORA))
        await engine.start()
        try:
            outs = []
            for i, (p, lora) in enumerate(zip(PROMPTS, LORAS)):
                outs.append(engine.generate(JaxEngineRequest(
                    f"j{i}", list(p), JaxSamplingParams(temperature=0.0, max_tokens=N_OUT, ignore_eos=True),
                    lora_name=lora)))

            async def drain(gen):
                return [o.token async for o in gen if o.token is not None]

            toks = await asyncio.gather(*(drain(g) for g in outs))
            return toks, jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
        finally:
            await engine.shutdown()

    return asyncio.run(run())


def port_model(params, **over) -> LlamaModel:
    cfg = LlamaConfig.tiny(**over)
    model = LlamaModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    return model.quantize_()


def port_engine(params, model_over=None, **over) -> AsyncTorchEngine:
    model_over = model_over or {}
    config = EngineConfig(device="cpu", **{**ENGINE, **LORA, **model_over, **over})
    return AsyncTorchEngine(config, model=port_model(params, **model_over))


def run(coro_fn):
    return asyncio.run(coro_fn())


def test_mixed_batch_equals_jax_engine(reference):
    """The concurrent mixed batch gives AsyncJaxEngine's tokens, lane by
    lane, and the adapters bite."""
    want, params = reference

    async def body():
        engine = port_engine(params)
        await engine.start()
        try:
            outs = await asyncio.gather(*(collect(engine, req(f"m{i}", p, lora=lora))
                                          for i, (p, lora) in enumerate(zip(PROMPTS, LORAS))))
        finally:
            await engine.shutdown()
        assert [t for t, _, _ in outs] == want
        assert all(f == "length" for _, _, f in outs)

    run(body)
    assert len({tuple(t) for t in want[:3]}) == 3


@pytest.mark.parametrize("quantize", [None, "int8_wo"], ids=["fp", "int8_wo"])
def test_alone_equals_mixed(reference, quantize):
    """Each request served alone gives its mixed-batch tokens (full
    precision: AsyncJaxEngine's too); int8_wo base weights ride the same
    gate (the delta sits on qlinear's output)."""
    want, params = reference
    over = {"quantize": quantize} if quantize else {}

    async def body():
        engine = port_engine(params, model_over=over)
        await engine.start()
        try:
            mixed = await asyncio.gather(*(collect(engine, req(f"m{i}", p, lora=lora))
                                           for i, (p, lora) in enumerate(zip(PROMPTS, LORAS))))
            await engine.run_on_engine(engine.allocator.reset_prefix_cache)
            alone = []
            for i, (p, lora) in enumerate(zip(PROMPTS, LORAS)):
                alone.append(await collect(engine, req(f"s{i}", p, lora=lora)))
        finally:
            await engine.shutdown()
        return [t for t, _, _ in mixed], [t for t, _, _ in alone]

    mixed, alone = run(body)
    assert alone == mixed
    if quantize is None:
        assert alone == want
    else:
        assert len({tuple(t) for t in mixed[:3]}) == 3


def test_lru_eviction_hot_swap_and_pinned_slots(reference):
    """Four adapters through two slots: LRU evicts, a reloaded adapter gives
    its first tokens again, host loads happen once an adapter; with one slot
    a long a1 stream keeps its slot while a2 and a3 wait for it, and its
    tokens equal an uncontended run."""
    _, params = reference
    four = dict(lora_adapters=("a1=random:1", "a2=random:2", "a3=random:3", "a4=random:4"))

    async def churn():
        engine = port_engine(params, **four)
        await engine.start()
        try:
            first = {n: (await collect(engine, req(f"f-{n}", PROMPT, lora=n)))[0] for n in ("a1", "a2", "a3", "a4")}
            store = engine.runner.lora_store
            assert store.evictions >= 2 and store.resident_count == 2
            for n in ("a1", "a2", "a3", "a4"):
                assert (await collect(engine, req(f"r-{n}", PROMPT, lora=n)))[0] == first[n], n
            snap = store.metrics_snapshot()
            assert snap["evictions"] >= 4 and snap["loads"] == 4 and store.slot_loads >= 6
            assert len(set(map(tuple, first.values()))) == 4
        finally:
            await engine.shutdown()

    async def pinned():
        one = dict(four, max_loras=1)
        ref = port_engine(params, **one)
        await ref.start()
        try:
            want = (await collect(ref, req("ref-a1", PROMPT, n=24, lora="a1")))[0]
        finally:
            await ref.shutdown()
        engine = port_engine(params, **one)
        await engine.start()
        try:
            results = await asyncio.gather(collect(engine, req("long-a1", PROMPT, n=24, lora="a1")),
                                           collect(engine, req("q-a2", PROMPT, n=6, lora="a2")),
                                           collect(engine, req("q-a3", PROMPT, n=6, lora="a3")))
            assert all(len(t) == n for (t, _, _), n in zip(results, (24, 6, 6)))
            assert results[0][0] == want
            assert engine.runner.lora_store.evictions == 2
        finally:
            await engine.shutdown()

    run(churn)
    run(pinned)


def test_unknown_adapter_fails_the_request_not_the_engine(reference):
    """An unknown adapter, and any adapter on an engine without them, end
    that request with "error"; the engine serves on. A model without LoRA
    support (DeepSeek) refuses adapters at start."""
    _, params = reference

    async def body():
        engine = port_engine(params)
        plain = AsyncTorchEngine(EngineConfig(device="cpu", **ENGINE), model=port_model(params))
        for e in (engine, plain):
            await e.start()
        try:
            for e, good in ((engine, "a1"), (plain, "")):
                toks, _, finish = await collect(e, req("bad", PROMPT, lora="nope"))
                assert finish == "error" and toks == []
                toks, _, finish = await collect(e, req("ok", PROMPT, lora=good))
                assert finish == "length" and len(toks) == N_OUT
        finally:
            for e in (engine, plain):
                await e.shutdown()
        mla = AsyncTorchEngine(EngineConfig(device="cpu", model_id="tiny-mla", **ENGINE, **LORA))
        with pytest.raises(ValueError, match="does not support LoRA"):
            await mla.start()

    run(body)


def test_prefix_cache_no_cross_adapter_hit(reference):
    """The same prompt under another adapter (or the base) is a miss; the
    same adapter again is a hit."""
    _, params = reference
    prompt = list(range(1, 25))  # 6 full blocks at page size 4

    async def body():
        engine = port_engine(params)
        await engine.start()
        try:
            cached = [(await collect(engine, req(rid, prompt, n=2, lora=lora)))[1]
                      for rid, lora in (("b0", ""), ("a1-first", "a1"), ("a1-again", "a1"), ("a2-first", "a2"),
                                        ("b1", ""))]
        finally:
            await engine.shutdown()
        assert cached[0] == 0 and cached[1] == 0 and cached[2] > 0 and cached[3] == 0 and cached[4] > 0

    run(body)


def test_spec_verify_mixed_adapters_token_identical(reference):
    """n-gram verify rounds carry each slot's adapter: a mixed-adapter spec
    engine emits the classic engine's tokens, with drafts accepted."""
    _, params = reference
    prompt = [7, 8, 9, 7, 8, 9, 7, 8]

    async def run_all(**over):
        engine = port_engine(params, **over)
        await engine.start()
        try:
            outs = await asyncio.gather(*(collect(engine, req(rid, prompt, n=16, lora=lora))
                                          for rid, lora in (("r1", "a1"), ("r2", "a2"), ("r0", ""))))
            return [t for t, _, _ in outs], engine.scheduler.stage.spec_accepted
        finally:
            await engine.shutdown()

    spec, accepted = run(lambda: run_all(speculative="ngram:3"))
    classic, _ = run(lambda: run_all())
    assert spec == classic and accepted > 0


def test_preemption_releases_and_reacquires_the_pin(reference):
    """On a pool the outputs outgrow, preempted LoRA lanes give up their pin
    and take it again at re-admission; every stream equals a roomy run's and
    every pin is released at the end."""
    _, params = reference
    prompts = [np.random.default_rng(20 + i).integers(1, 250, 24).tolist() for i in range(4)]
    loras = ["a1", "a2", "a1", "a2"]

    async def serve(**over):
        engine = port_engine(params, watermark=0.0, **over)
        await engine.start()
        try:
            outs = await asyncio.gather(*(collect(engine, req(f"p{i}", p, n=24, lora=lora))
                                          for i, (p, lora) in enumerate(zip(prompts, loras))))
            store = engine.runner.lora_store
            return [t for t, _, _ in outs], engine.scheduler.preempt_count, dict(store.refs), dict(store.requests)
        finally:
            await engine.shutdown()

    tight, preempted, refs, requests = run(lambda: serve(num_pages=24))
    roomy, none, _, _ = run(lambda: serve(num_pages=256))
    assert preempted >= 1 and none == 0
    assert tight == roomy and all(len(t) == 24 for t in tight)
    assert refs == {} and sum(requests.values()) == 4 + preempted


def test_config_validation_and_cli_passthrough():
    from dynamo_tpu_torch.components import worker
    from dynamo_tpu_torch.launch import run as run_cli
    from dynamo_tpu_torch.launch._run_impl import engine_config_for

    cfg = EngineConfig(model_id="tiny", lora_adapters="a1, a2=random:3")
    assert cfg.lora_adapters == ("a1", "a2=random:3") and cfg.lora_enabled
    assert not EngineConfig(model_id="tiny").lora_enabled
    for bad in (dict(lora_adapters=("dup", "dup")), dict(lora_adapters=("a1",), max_loras=0),
                dict(lora_adapters=("a1",), lora_rank=0), dict(lora_adapters=("bad name",))):
        with pytest.raises(ValueError):
            EngineConfig(model_id="tiny", **bad)
    args = run_cli.build_parser().parse_args(["run", "tiny", "--lora-adapters", "a1,a2=random:9", "--max-loras", "3",
                                              "--lora-rank", "16", "--device", "cpu"])
    cfg = engine_config_for(args)
    assert (cfg.lora_adapters, cfg.max_loras, cfg.lora_rank) == (("a1", "a2=random:9"), 3, 16)
    args.lora_adapters, args.max_loras, args.lora_rank = ["a1", "a2"], None, None  # a graph's list form
    cfg = engine_config_for(args)
    assert (cfg.lora_adapters, cfg.max_loras, cfg.lora_rank) == (("a1", "a2"), 4, 8)
    cfg = worker.engine_config_for(worker.build_parser().parse_args(
        ["tiny", "--device", "cpu", "--lora-adapters", "a1,a2", "--max-loras", "2", "--lora-rank", "4"]))
    assert (cfg.lora_adapters, cfg.max_loras, cfg.lora_rank) == (("a1", "a2"), 2, 4)
    cfg = worker.engine_config_for(worker.build_parser().parse_args(["tiny", "--device", "cpu"]))
    assert not cfg.lora_enabled and (cfg.max_loras, cfg.lora_rank) == (4, 8)
    assert worker.resolve_adapter("tiny:a1", "tiny", {"a1": "random:1"}) == "a1"
    assert worker.resolve_adapter("tiny:a9", "tiny", {"a1": "random:1"}) == ""
    assert worker.resolve_adapter('tiny:{"a1": 1}', "tiny:{\"a1\": 1}", {"a1": "x"}) == ""


def test_lora_metric_families(reference):
    """resource_snapshot's lora_* keys and the dynamo_lora_* families after
    serving, conformant to the reference's exposition checker."""
    _, params = reference

    async def body():
        engine = port_engine(params)
        await engine.start()
        try:
            await collect(engine, req("x", PROMPT, n=2, lora="a1"))
            return engine.resource_snapshot(), engine.render_stage_metrics()
        finally:
            await engine.shutdown()

    snap, text = run(body)
    assert (snap["lora_resident"], snap["lora_capacity"], snap["lora_loads"], snap["lora_hot"]) == (1, 2, 1, "a1")
    assert snap["lora_requests"] == {"a1": 1, "a2": 0}
    for line in ("# TYPE dynamo_lora_slots gauge", 'dynamo_lora_slots{state="resident"} 1',
                 'dynamo_lora_slots{state="capacity"} 2', "# TYPE dynamo_lora_evictions_total counter",
                 "# TYPE dynamo_lora_loads_total counter", "# TYPE dynamo_lora_load_seconds_total counter",
                 "# TYPE dynamo_lora_requests_total counter", 'dynamo_lora_requests_total{adapter="a1"} 1'):
        assert line in text, line
    assert check_exposition(text) == []
