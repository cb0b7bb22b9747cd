"""The runner's compiled step functions (``dynamo_tpu_torch/engine/graphs.py``
and ``ModelRunner``'s graph path), the engine's warmup and the
cancellation of reused request ids, on the CPU. A CUDA graph needs the
card, so the graph path runs here behind :class:`FakeGraphs`, a backend
whose capture records the body and runs nothing and whose replay runs the
body on the static inputs into the static outputs: what the runner copies
in, draws and keeps between calls is then checked against the eager engine
token for token. The ``cuda``-marked tests replay real graphs against the
eager bodies and skip without a card (this file imports no JAX at module
level, so they run on the card's machine with ``--noconftest``)."""

import asyncio
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import model_runner
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.graphs import GraphCache, add_tally, kernel_launchers, launch_counts, take_tally
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.utils.compile_monitor import CompileMonitor

torch.set_num_threads(2)

ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
PROMPTS = [[5, 9, 2, 77, 31], list(range(40, 51)), [200 - i for i in range(20)], list(range(1, 41))]


class FakeGraph:
    def __init__(self, body, inputs, outputs, launchers):
        self.body, self.inputs, self.outputs, self.launchers = body, inputs, outputs, launchers

    def replay(self):
        """The body's work on the static inputs into the static outputs; a
        replay runs no Python, so the launchers it reaches do not count."""
        counts = launch_counts(self.launchers)
        for out, got in zip(self.outputs, self.body(*self.inputs)):
            out.copy_(got)
        for fn, n in zip(self.launchers, counts):
            fn.launches = n


class FakeGraphs:
    """A graph backend without the card: the eager run is the body's; a
    capture allocates the static outputs and executes nothing (with
    ``trace``, it runs the Python of a body that keeps no state, so its
    launchers count as a real capture's do); a replay runs the body on the
    static inputs into them."""

    def __init__(self, launchers=(), trace: bool = False):
        self.launchers, self.trace = launchers, trace

    def eager(self, body, inputs):
        return body(*inputs)

    def record(self, body, inputs, like):
        if self.trace:
            body(*inputs)
        outputs = tuple(torch.empty_like(t) for t in like)
        return FakeGraph(body, inputs, outputs, self.launchers), outputs


class FakeGraphRunner(ModelRunner):
    def __init__(self, config, model):
        super().__init__(config, model)
        self.graphs = GraphCache(FakeGraphs(), self.compile_monitor)


async def collect(engine, req):
    toks, reason = [], None
    async for out in engine.generate(req):
        if out.token is not None:
            toks.append(out.token)
        reason = out.finish_reason
    return toks, reason


def serve(requests, graphs: bool, monkeypatch=None, **over):
    """(outputs per request, the engine) of a tiny CPU engine; ``graphs``:
    its runner takes the graph path behind FakeGraphs."""
    if graphs:
        monkeypatch.setattr(model_runner, "ModelRunner", FakeGraphRunner)

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", model_id="tiny", **dict(ENGINE, **over)))
        await engine.start()
        try:
            await engine.wait_warmup()
            before = engine.runner.compile_monitor.compiles
            outs = await asyncio.wait_for(asyncio.gather(*(collect(engine, r) for r in requests())), 120)
            return outs, engine, before
        finally:
            await engine.shutdown()

    out = asyncio.run(run())
    if graphs:
        monkeypatch.undo()
    return out


def greedy_requests():
    return [EngineRequest(f"g{i}", p, SamplingParams(max_tokens=10)) for i, p in enumerate(PROMPTS)]


def mixed_requests():
    """Greedy, unseeded sampled, seeded sampled and filtered requests."""
    params = [SamplingParams(max_tokens=9), SamplingParams(temperature=0.9, max_tokens=9),
              SamplingParams(temperature=1.1, seed=7, max_tokens=9),
              SamplingParams(temperature=0.8, top_k=5, top_p=0.9, seed=3, max_tokens=9)]
    return [EngineRequest(f"m{i}", p, s) for i, (p, s) in enumerate(zip(PROMPTS, params))]


# ---------------------------------------------------------------- counters


def test_compile_monitor_counts_as_the_reference():
    from dynamo_tpu.utils.compile_monitor import CompileMonitor as JaxCompileMonitor

    now = [10.0]
    got, ref = CompileMonitor(clock=lambda: now[0]), JaxCompileMonitor(clock=lambda: now[0])
    assert got.snapshot() == ref.snapshot()
    for label, seconds, count in (("decode_window", 0.5, 1), ("prefill_packed", 1.25, 2), ("prefill", 3.0, 1),
                                  ("decode_window", 0.125, 1)):
        now[0] += 1.5
        got.record(label, seconds, count)
        ref.record(label, seconds, count)
    now[0] += 2.25
    assert got.snapshot() == ref.snapshot() == {
        "compiles": 5, "compile_s": 4.875, "last_label": "decode_window", "last_compile_age_s": 2.25,
        "per_label": {"decode_window": 2, "prefill_packed": 2, "prefill": 1},
    }


def fake_launcher(name):
    def launcher():
        launcher.launches += 1

    launcher.__name__ = name
    launcher.launches = 0
    return launcher


def test_replays_add_the_capture_tally_to_the_launch_counters():
    """A capture runs the body's Python (its launchers count) but launches
    nothing: the tally is taken back off, and each replay adds it. The
    eager run's launches count as they ran; a second key has its own
    tally; each capture is charged to the monitor under its label."""
    k1, k2, other = fake_launcher("k1"), fake_launcher("k2"), fake_launcher("other")
    cache = GraphCache(FakeGraphs((k1, k2, other), trace=True), CompileMonitor(), launchers=(k1, k2, other))

    def body(x, n1, n2):
        for _ in range(n1):
            k1()
        for _ in range(n2):
            k2()
        return (x * 2,)

    x = torch.ones(3)

    def run(key, n1, n2):
        return cache.run(key[0], key, lambda: (torch.zeros(3),), lambda inp: inp[0].copy_(x),
                         functools.partial(body, n1=n1, n2=n2))

    out = run(("decode_window", 1), 3, 2)  # eager 3 + 2, the capture's taken back off
    assert torch.equal(out[0], 2 * x) and (k1.launches, k2.launches, other.launches) == (3, 2, 0)
    assert [(fn.__name__, n) for fn, n in cache.entries[("decode_window", 1)].tally] == [("k1", 3), ("k2", 2)]
    for i in range(4):
        x = torch.full((3,), float(i))
        out = run(("decode_window", 1), 3, 2)
        assert torch.equal(out[0], 2 * x)
    assert (k1.launches, k2.launches) == (3 + 4 * 3, 2 + 4 * 2)
    run(("prefill_packed", 4), 1, 0)
    run(("prefill_packed", 4), 1, 0)
    assert (k1.launches, k2.launches, other.launches) == (17, 10, 0)
    assert len(cache) == 2 and [e.replays for e in cache.entries.values()] == [4, 1]
    assert [(fn.__name__, n) for fn, n in cache.entries[("prefill_packed", 4)].tally] == [("k1", 1)]
    snap = cache.monitor.snapshot()
    assert snap["compiles"] == 2 and snap["per_label"] == {"decode_window": 1, "prefill_packed": 1}
    assert snap["last_label"] == "prefill_packed"


def test_tally_arithmetic_and_the_launchers_it_counts():
    a, b = fake_launcher("a"), fake_launcher("b")
    a.launches, b.launches = 5, 7
    before = launch_counts((a, b))
    a.launches += 64
    tally = take_tally((a, b), before)
    assert [(fn.__name__, n) for fn, n in tally] == [("a", 64)] and (a.launches, b.launches) == (5, 7)
    add_tally(tally)
    add_tally(tally)
    assert (a.launches, b.launches) == (133, 7)
    names = {fn.__name__ for fn in kernel_launchers()}
    assert {"paged_decode_attention_kernel", "paged_prefill_attention_kernel", "paged_decode_attention_folded_kernel",
            "paged_prefill_attention_folded_kernel", "paged_decode_attention_chunked_kernel",
            "paged_decode_attention_grouped_kernel", "paged_mla_decode_attention_kernel",
            "paged_mla_prefill_attention_kernel", "paged_decode_dmaonly_kernel", "paged_prefill_dmaonly_kernel",
            "paged_decode_perseq_variant_kernel"} == names


def test_a_failed_capture_raises_and_keeps_the_counters():
    k = fake_launcher("k")

    class Broken(FakeGraphs):
        def record(self, body, inputs, like):
            body(*inputs)
            raise RuntimeError("capture failed")

    cache = GraphCache(Broken(), CompileMonitor(), launchers=(k,))

    def body(x):
        k()
        return (x,)

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.run("decode_window", ("w",), lambda: (torch.zeros(1),), lambda inp: None, body)
    assert k.launches == 1 and len(cache) == 0 and cache.monitor.compiles == 0


# ---------------------------------------------------------------- the graph path


@pytest.mark.parametrize("prefill_lanes", [4, 1], ids=["packed", "per-request"])
@pytest.mark.parametrize("requests", [greedy_requests, mixed_requests], ids=["greedy", "sampled"])
def test_graph_path_gives_the_eager_tokens(monkeypatch, requests, prefill_lanes):
    """The same requests through the eager engine and through the graph
    path (FakeGraphs): equal tokens, sampled and seeded ones included (the
    noise is drawn into the static input in the eager order); each shape
    captured once, the rest replayed."""
    over = dict(prefill_lanes=prefill_lanes, decode_steps=2)  # windows of 2 steps: several a request
    eager, _, _ = serve(requests, False, **over)
    graphed, engine, _ = serve(requests, True, monkeypatch, **over)
    assert graphed == eager and all(len(t) == 9 or len(t) == 10 for t, _ in eager)
    cache = engine.runner.graphs
    assert len(cache) == engine.runner.compile_monitor.compiles >= 2
    # every dispatch captured its shape or replayed it
    replays = sum(e.replays for e in cache.entries.values())
    assert replays >= 2 and len(cache) + replays == sum(engine.scheduler.anatomy.dispatch_counts.values())
    labels = {key[0] for key in cache.entries}
    assert labels == {"decode_window", "prefill_packed" if prefill_lanes > 1 else "prefill"}


@pytest.mark.parametrize("warmup", [True, "background"])
def test_warmup_captures_every_shape_the_serve_reaches(monkeypatch, warmup):
    """With warmup the graph path captures nothing while serving (the
    monitor's count is unchanged) and gives the eager engine's tokens,
    sampled requests included."""
    eager, _, _ = serve(mixed_requests, False)
    graphed, engine, before = serve(mixed_requests, True, monkeypatch, warmup=warmup)
    assert graphed == eager
    assert engine.runner.compile_monitor.compiles == before == len(engine.runner.graphs)
    widths = EngineConfig(device="cpu", **ENGINE).table_buckets
    assert {key[2] for key in engine.runner.graphs.entries if key[0] == "decode_window"} == set(widths)


def test_warmup_writes_only_the_trash_page():
    """Every warmup call's KV rows land on each layer's trash page and the
    slot tokens stay as they were (the drop slot excepted)."""
    from dynamo_tpu_torch.models.registry import load_model

    cfg = EngineConfig(device="cpu", **ENGINE)
    model = load_model("tiny", device="cpu")
    runner = ModelRunner(cfg, model)
    runner.write_token_slots(np.arange(4), np.array([11, 22, 33, 44]))
    runner.warmup()
    P = cfg.num_pages
    for name in ("k", "v"):
        pool = runner.kv_cache[name].reshape(model.config.num_layers, P, -1)
        assert pool[:, 0].abs().sum() > 0  # the trash pages took the writes
        assert not pool[:, 1:].any()
    assert runner.slot_state["tokens"][:4].tolist() == [11, 22, 33, 44]


def test_engine_with_warmup_matches_the_jax_engine():
    """The CPU engine with warmup=True and without serve the greedy tokens
    of AsyncJaxEngine on the same weights (the warmup touched only the
    trash page)."""
    import jax

    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import AsyncJaxEngine
    from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
    from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
    from dynamo_tpu_torch.models.convert import params_from_jax
    from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel

    async def jax_run():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, **ENGINE))
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                collect(engine, JaxEngineRequest(f"j{i}", p, JaxSamplingParams(max_tokens=10)))
                for i, p in enumerate(PROMPTS)
            ))
            params = jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
        finally:
            await engine.shutdown()
        return outs, params

    ref, params = asyncio.run(jax_run())

    def port(warmup):
        cfg = LlamaConfig.tiny()
        model = LlamaModel(cfg)
        model.load_state_dict(params_from_jax(params, cfg))

        async def run():
            engine = AsyncTorchEngine(EngineConfig(device="cpu", warmup=warmup, **ENGINE), model=model)
            await engine.start()
            try:
                return await asyncio.gather(*(collect(engine, r) for r in greedy_requests()))
            finally:
                await engine.shutdown()

        return asyncio.run(run())

    with_warmup, without = port(True), port(False)
    assert with_warmup == without == [(list(t), r) for t, r in ref]
    assert all(len(t) == 10 and r == "length" for t, r in with_warmup)


def test_warmup_option_is_validated_as_the_reference():
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig

    for ok in (True, False, "background"):
        assert EngineConfig(device="cpu", warmup=ok).warmup == JaxEngineConfig(warmup=ok).warmup == ok
    for bad in ("bg", "true", 1):
        with pytest.raises(ValueError, match="warmup"):
            EngineConfig(device="cpu", warmup=bad)
        with pytest.raises(ValueError, match="warmup"):
            JaxEngineConfig(warmup=bad)


def test_run_warms_up_in_the_background():
    """The port's ``run`` builds its engine with warmup="background", as the
    reference's checkpoint path does (the reference's tiny path does not
    warm up; the port's tiny card serves full-width models on the card)."""
    from argparse import Namespace

    from dynamo_tpu_torch.launch._run_impl import engine_config_for

    for model in ("tiny", "tiny-mla"):
        args = Namespace(model=model, max_model_len=None, num_pages=None, max_seqs=None, device="cpu")
        assert engine_config_for(args).warmup == "background"
    assert 'warmup="background"' in (Path(__file__).parents[1] / "dynamo_tpu/launch/_run_impl.py").read_text()


def test_a_failed_background_warmup_fails_the_engine(monkeypatch):
    """A capture that fails in the background warmup is an error: the task
    raises it and the engine refuses new requests (no eager fallback)."""

    class Failing(ModelRunner):
        def warmup_extra_thunks(self):
            def thunk():
                raise RuntimeError("capture failed")

            return [thunk]

    monkeypatch.setattr(model_runner, "ModelRunner", Failing)

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", warmup="background", **ENGINE))
        await engine.start()
        try:
            with pytest.raises(RuntimeError, match="capture failed"):
                await engine.wait_warmup()
            with pytest.raises(RuntimeError, match="background warmup failed"):
                await collect(engine, EngineRequest("x", [1, 2, 3], SamplingParams(max_tokens=2)))
        finally:
            await engine.shutdown()

    asyncio.run(run())


@pytest.mark.parametrize("model_id", ["tiny", "tiny-mla"])
def test_graph_against_eager_check_on_the_cpu(model_id):
    """``tools/checks.py graph_against_eager`` behind FakeGraphs: the graph
    run replays (captures nothing after the warmup) and gives the eager
    run's tokens, KV pages and logits exactly; the prompts' pages hold
    their rows."""
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.checks import graph_against_eager

    cfg = EngineConfig(device="cpu", model_id=model_id, **ENGINE)
    runner = FakeGraphRunner(cfg, load_model(model_id, device="cpu"))
    got = graph_against_eager(runner, [list(range(3, 16)), list(range(40, 47)), [9] * 30])
    g, e = got["graph"], got["eager"]
    assert got["captures"] == 0 and g["window"].shape == (cfg.decode_steps, 3)
    assert np.array_equal(g["first"], e["first"]) and np.array_equal(g["window"], e["window"])
    assert all(torch.equal(a, b) for a, b in zip(g["pools"], e["pools"])) and torch.equal(g["logits"], e["logits"])
    assert all(p[:, :20].abs().sum(-1).gt(0).all() for p in g["pools"])  # pages 1..20 written


# ---------------------------------------------------------------- reused ids


def test_reused_request_ids_all_end():
    """The same 16 ids through one engine twice: all 32 streams end (a
    finished stream cancels its own submission, not a later one with its
    id)."""

    def requests(round_):
        return [EngineRequest(f"serve-{i}", [3 + i, 7, 11 + round_, 2 * i + 1], SamplingParams(max_tokens=4 + i % 3))
                for i in range(16)]

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", model_id="tiny", **ENGINE))
        await engine.start()
        try:
            first = await asyncio.wait_for(asyncio.gather(*(collect(engine, r) for r in requests(0))), 120)
            second = await asyncio.wait_for(asyncio.gather(*(collect(engine, r) for r in requests(1))), 120)
            # one at a time too: each request submitted right after its namesake ended
            third = [await asyncio.wait_for(collect(engine, r), 60) for r in requests(0)[:4] * 2]
        finally:
            await engine.shutdown()
        return first, second, third

    first, second, third = asyncio.run(run())
    for outs in (first, second):
        assert [(len(t), r) for t, r in outs] == [(4 + i % 3, "length") for i in range(16)]
    assert third[:4] == third[4:] == first[:4]


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model_id", [
    "tiny:" + json.dumps(dict(dtype="bf16", head_dim=128, num_heads=4, num_kv_heads=2)),
    "tiny-mla:" + json.dumps(dict(dtype="bf16")),
], ids=["llama-K1-K2", "mla-K5-K6"])
def test_replay_equals_the_eager_body_on_the_card(cuda, model_id):
    """A tiny bf16 runner on the card (K1 / K2, or K5 / K6): a prefill call
    and a decode window replayed from their graphs give the eager bodies'
    tokens and KV pages exactly, and their last-step logits within
    TOL["bf16"] (``tools/checks.py graph_against_eager``)."""
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.checks import TOL, graph_against_eager, tol_share

    cfg = EngineConfig(model_id=model_id, **ENGINE)
    runner = ModelRunner(cfg, load_model(model_id, device="cuda"))
    got = graph_against_eager(runner, [list(range(3, 16)), list(range(40, 47)), [9] * 30])
    g, e = got["graph"], got["eager"]
    assert got["captures"] == 0
    assert np.array_equal(g["first"], e["first"]) and np.array_equal(g["window"], e["window"])
    for a, b in zip(g["pools"], e["pools"]):
        assert torch.equal(a, b)
    assert tol_share(g["logits"], e["logits"], "bf16")[1] <= 1 and TOL["bf16"] == (1e-4, 2.0**-6)
