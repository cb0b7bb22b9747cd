"""Multi-tenant QoS and the depth-aware chunk planner in the port against the
JAX package, on the CPU:

  - ``utils/qos.py``: the reference's unit tests (priority parsing and
    order, token-bucket arithmetic, Retry-After clamps, the drain-rate
    estimator, policy specs and env, the admission controller) run on both
    modules, and the port's ``dynamo_qos_*`` exposition equals the
    reference's and passes its conformance checker;
  - the scheduler's QoS choices, on the reference's ``Scheduler`` and the
    port's from the same states: admission order by class (FIFO with QoS
    off), priority weights under the fairness cap, victim order, the tags
    a preemption carries, and the critical shed (its wait gate, never
    critical for critical, the preemption); a ``hypothesis`` test draws
    slot and queue states and holds ``_next_waiting_index`` and
    ``_pick_victim`` to the reference's;
  - ``EngineConfig.chunk_len_for`` equals the reference's over drawn
    depths, backlogs, bucket sets and flat depths (0 included), and a long
    prompt's prefill calls in the port's engine take the reference engine's
    rows, call for call;
  - HTTP: the port's stdlib service and the reference's aiohttp service
    behind one scripted engine answer ``x-priority: urgent`` with a 400
    ``invalid_priority``, an exhausted tenant budget with a 429
    ``rate_limited`` and ``Retry-After`` before any SSE byte (unary and
    stream), and batch-class backpressure with a 429 ``overloaded`` while a
    standard request is served.
"""

import asyncio
import http.client
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import dynamo_tpu.utils.qos as ref_qos
import dynamo_tpu_torch.utils.qos as port_qos
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.page_table import PageAllocator as JaxPageAllocator
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu.engine.scheduler import RunningSeq as JaxRunningSeq
from dynamo_tpu.engine.scheduler import Scheduler as JaxScheduler
from dynamo_tpu.frontends.pipeline import build_pipeline as ref_build_pipeline
from dynamo_tpu.frontends.pipeline import card_for_model as ref_card_for_model
from dynamo_tpu.llm.http.service import HttpService as RefHttpService
from dynamo_tpu.utils.prometheus import check_exposition
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest, RunningSeq, Scheduler, StepOutput
from dynamo_tpu_torch.frontends.pipeline import build_pipeline, card_for_model
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel

QOS = {"reference": ref_qos, "port": port_qos}

# ---------------------------------------------------------------- utils/qos.py


@pytest.fixture(params=list(QOS))
def qos(request):
    return QOS[request.param]


def test_parse_priority_and_ordering(qos):
    assert qos.parse_priority(None) == "standard"
    assert qos.parse_priority("") == "standard"
    assert qos.parse_priority(" Critical ") == "critical"
    assert qos.parse_priority("BATCH") == "batch"
    with pytest.raises(ValueError):
        qos.parse_priority("urgent")
    rank, weight = qos.priority_rank, qos.priority_weight
    assert rank("critical") < rank("standard") < rank("batch")
    assert rank("") == rank("standard") == rank(None) == rank("unknown")
    assert weight("critical") > weight("standard") > weight("batch")
    assert weight("") == 1.0
    assert qos.PRIORITY_CLASSES == ref_qos.PRIORITY_CLASSES and qos.PRIORITY_WEIGHTS == ref_qos.PRIORITY_WEIGHTS


def test_token_bucket_arithmetic(qos):
    clock = {"t": 0.0}
    b = qos.TokenBucket(rate=10.0, burst=30.0, clock=lambda: clock["t"])
    assert b.fill_fraction() == pytest.approx(1.0)
    assert b.try_consume(20)
    assert b.try_consume(10)
    assert not b.try_consume(1)
    clock["t"] = 1.0
    assert b.fill_fraction() == pytest.approx(10.0 / 30.0)
    assert b.try_consume(10)
    clock["t"] = 100.0
    assert b.fill_fraction() == pytest.approx(1.0)
    # a request larger than the whole burst admits when FULL (drains to 0)
    assert b.try_consume(10_000)
    assert not b.try_consume(1)
    assert b.seconds_until(20) == pytest.approx(2.0)
    clock["t"] = 101.0
    assert b.seconds_until(20) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        qos.TokenBucket(rate=0.0)
    assert qos.TokenBucket(rate=5.0).burst == 10.0  # default: 2 s of rate


def test_retry_after_from_queue_clamps(qos):
    f = qos.retry_after_from_queue
    assert f(100, 10.0) == 10
    assert f(1000, 1.0) == 30  # clamped high
    assert f(0, 10.0) == 1  # clamped low
    assert f(2, 10.0) == 1
    assert f(5, None) == 10  # no measured rate: the clamped default
    assert f(5, 0.0) == 10


def test_drain_rate_estimator(qos):
    clock = {"t": 0.0}
    est = qos.DrainRateEstimator(window_s=60.0, clock=lambda: clock["t"])
    assert est.rate_rps() is None  # cold: no fake rate
    assert est.retry_after_s(50) == 10
    for i in range(10):
        clock["t"] = float(i)
        est.note_finish()
    clock["t"] = 10.0
    assert est.rate_rps() == pytest.approx(1.0)
    assert est.retry_after_s(15) == 15
    assert est.retry_after_s(500) == 30
    est.note_finish(3)  # a batch of finishes at one instant
    assert est.rate_rps() == pytest.approx(13 / 10.0)
    clock["t"] = 200.0  # old samples age out of the window
    assert est.rate_rps() is None


def test_qos_policy_specs(qos):
    p = qos.QosPolicy.from_specs("tenant-a=500,tenant-b=4000:8000,*=1000",
                                 "tenant-a=batch,tenant-b=critical,adapter:a1=batch")
    assert p.budgets["tenant-a"] == (500.0, None)
    assert p.budgets["tenant-b"] == (4000.0, 8000.0)
    assert p.default_budget == (1000.0, None)
    assert p.priority_for("tenant-a") == "batch"
    assert p.priority_for("tenant-b") == "critical"
    assert p.priority_for("unknown") == "standard"
    assert p.priority_for("unknown", adapter="a1") == "batch"
    for budgets, prios in (("tenant-a", ""), ("", "tenant-a=urgent"), ("", "tenant-a")):
        with pytest.raises(ValueError):
            qos.QosPolicy.from_specs(budgets, prios)
    with pytest.raises(ValueError):
        qos.QosPolicy.from_specs("", "", fleet_replicas=0)


def test_qos_policy_from_env(qos):
    assert qos.QosPolicy.from_env({}) is None
    p = qos.QosPolicy.from_env({"DYNTPU_QOS_BUDGETS": "t1=100", "DYNTPU_QOS_SHED_WAIT_S": "3.5",
                                "DYNTPU_QOS_FLEET_REPLICAS": "2"})
    assert p.budgets["t1"] == (100.0, None)
    assert p.shed_wait_s == 3.5 and p.fleet_replicas == 2
    assert qos.QosPolicy.from_env({"DYNTPU_QOS_PRIORITIES": "t2=batch"}).priority_for("t2") == "batch"


def _controller_run(qos):
    """(snapshot, exposition, decisions) of one fixed admission sequence."""
    clock = {"t": 0.0}
    ctl = qos.AdmissionController(qos.QosPolicy.from_specs("t1=10:40,t2=4", ""), clock=lambda: clock["t"])
    decisions = [ctl.admit("t1", "batch", 30), ctl.admit("t1", "batch", 30)]
    decisions.append(ctl.admit("other", "standard", 10 ** 6))  # unbudgeted: never throttled
    clock["t"] = 1.5
    decisions += [ctl.admit("t2", "critical", 5), ctl.admit("t2", "critical", 5)]
    ctl.record_shed("t1", "batch")
    return ctl.snapshot(), ctl.render_metrics(), [(d.admitted, d.action, d.retry_after_s, d.reason) for d in decisions]


def test_admission_controller_throttles_and_renders(qos):
    snap, text, decisions = _controller_run(qos)
    assert decisions[0][:2] == (True, "admitted")
    assert decisions[1][:3] == (False, "throttled", 2)  # deficit 20 tokens at 10/s
    assert decisions[2][0]
    assert snap["classes"]["batch"]["t1"] == {"admitted": 1, "throttled": 1, "shed": 1}
    assert 0.0 <= snap["budget_fill"]["t1"] <= 1.0
    assert check_exposition(text) == []
    assert 'dynamo_qos_requests_total{action="throttled",class="batch",tenant="t1"} 1' in text
    assert "dynamo_qos_budget_fill" in text
    # an empty controller still renders both families
    empty = qos.AdmissionController().render_metrics()
    assert check_exposition(empty) == [] and "dynamo_qos_budget_fill" in empty


def test_admission_controller_equals_the_reference():
    assert _controller_run(port_qos) == _controller_run(ref_qos)


# ---------------------------------------------------------------- scheduler


class _StubRunner:
    packed_prefill_mode = False
    lora_store = None

    def write_token_slots(self, slots, tokens):  # pragma: no cover
        pass

    def set_slot_lora(self, slot, lora_slot):  # pragma: no cover
        pass


IMPLS = {
    "reference": SimpleNamespace(Config=JaxEngineConfig, Allocator=JaxPageAllocator, Scheduler=JaxScheduler,
                                 Request=JaxEngineRequest, Seq=JaxRunningSeq),
    "port": SimpleNamespace(Config=EngineConfig, Allocator=PageAllocator, Scheduler=Scheduler,
                            Request=EngineRequest, Seq=RunningSeq),
}


@pytest.fixture(params=list(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _scheduler(impl, qos=True, max_seqs=4, cap=2, wait_ms=0.0):
    cfg = impl.Config(model_id="tiny", page_size=4, num_pages=64, max_seqs=max_seqs, max_model_len=64,
                      prefill_batches_per_step=cap, qos=qos, qos_preempt_wait_ms=wait_ms)
    return impl.Scheduler(cfg, _StubRunner(), impl.Allocator(cfg.num_pages, cfg.page_size))


def _fake_start(impl, sched, started):
    def start(req, slot, **_):
        sched.slots[slot] = impl.Seq(req=req, slot=slot, prompt_len=len(req.token_ids), cached_len=0,
                                     prefill_pos=None, admitted_order=sched._admit_counter)
        sched._admit_counter += 1
        started.append(req.request_id)

    return start


def _running(impl, sched, rid, slot, priority="standard", generated=(9,)):
    """A running decode sequence with real allocator state (preemption
    frees it)."""
    sched.allocator.allocate_sequence(rid, [1, 2, 3, 4])
    sched.allocator.commit_prefilled(rid, 4)
    seq = impl.Seq(req=impl.Request(rid, [1, 2, 3, 4], priority=priority, tenant=f"tn-{rid}"), slot=slot,
                   prompt_len=4, cached_len=0, prefill_pos=None, generated=list(generated),
                   admitted_order=sched._admit_counter)
    sched._admit_counter += 1
    sched.slots[slot] = seq
    return seq


@pytest.mark.parametrize("on", [True, False], ids=["qos", "fifo"])
def test_priority_admission_order(impl, monkeypatch, on):
    sched = _scheduler(impl, qos=on)
    started = []
    monkeypatch.setattr(sched, "_start_sequence", _fake_start(impl, sched, started))
    sched.add_request(impl.Request("b", [1] * 4, priority="batch"))
    sched.add_request(impl.Request("s", [1] * 4))  # standard by default
    sched.add_request(impl.Request("c", [1] * 4, priority="critical"))
    sched._admit()
    assert started == (["c", "s", "b"] if on else ["b", "s", "c"])


@pytest.mark.parametrize("classes,expect", [
    (["standard", "standard"], 1), (["critical", "critical", "critical"], 2), (["batch", "batch"], 1),
    (["batch", "critical", "standard"], 2),
], ids=["standard", "critical", "batch", "mixed"])
def test_priority_weights_compose_with_fairness_cap(impl, monkeypatch, classes, expect):
    """cap 1 with a running decode slot, off the packed path: one standard
    start a step, two critical (0.5 cap units each), one batch (the cap is
    checked before the start)."""
    sched = _scheduler(impl, cap=1)
    _running(impl, sched, "dec", 0)
    started = []
    monkeypatch.setattr(sched, "_start_sequence", _fake_start(impl, sched, started))
    for i, cls in enumerate(classes):
        sched.add_request(impl.Request(f"r{i}", [1] * 4, priority=cls))
    sched._admit()
    assert len(started) == expect, (classes, started)


def test_priority_victim_ordering(impl):
    sched = _scheduler(impl)
    crit = _running(impl, sched, "crit", 0, priority="critical")
    _running(impl, sched, "std", 1, priority="standard")
    _running(impl, sched, "b-old", 2, priority="batch")
    _running(impl, sched, "b-new", 3, priority="batch")
    order = []
    while (victim := sched._pick_victim(exclude=crit)) is not None:
        order.append(victim.req.request_id)
        sched.slots[victim.slot] = None
    assert order == ["b-new", "b-old", "std"]  # critical only as the excluded
    off = _scheduler(impl, qos=False)
    crit2 = _running(impl, off, "crit", 0, priority="critical")
    _running(impl, off, "b", 1, priority="batch")
    newest = _running(impl, off, "new-crit", 2, priority="critical")
    assert off._pick_victim(exclude=crit2) is newest  # pure recency


def test_preempt_carries_qos_tags(impl):
    sched = _scheduler(impl)
    seq = _running(impl, sched, "v1", 0, priority="batch", generated=(9, 8, 7))
    seq.req.sampling.max_tokens, seq.req.sampling.min_tokens = 10, 5
    seq.req.enqueue_ts, seq.req.logprobs = 123.0, 2
    sched._preempt(seq)
    requeued = sched.waiting[0]
    assert (requeued.priority, requeued.tenant) == ("batch", "tn-v1")
    assert requeued.token_ids == [1, 2, 3, 4, 9, 8, 7]
    assert (requeued.sampling.max_tokens, requeued.sampling.min_tokens) == (7, 2)
    assert (requeued.enqueue_ts, requeued.logprobs, requeued.penalty_output_from) == (123.0, 2, 4)
    assert sched.qos_preempted == {"batch": 1} and sched.preempt_count == 1
    assert sched.slots[0] is None and "v1" not in sched.allocator._seqs


def test_preempt_keeps_the_submission():
    """The port cancels by (id, submission): the requeued request keeps its
    number, so its stream's cancel still reaches it."""
    sched = _scheduler(IMPLS["port"])
    seq = _running(IMPLS["port"], sched, "v1", 0)
    seq.req.submission = 7
    sched._preempt(seq)
    assert sched.waiting[0].submission == 7
    assert not sched.cancel("v1", submission=8) and sched.cancel("v1", submission=7)
    assert not sched.waiting


def test_critical_shed_waits_for_the_gate_and_preempts(impl, monkeypatch):
    """Every slot held by batch lanes: a waiting critical request past the
    wait gate preempts the most recent batch lane and admits in the same
    step; before the gate it waits; a critical request never sheds another
    critical one."""
    sched = _scheduler(impl, max_seqs=2, wait_ms=250.0)
    _running(impl, sched, "b1", 0, priority="batch")
    _running(impl, sched, "b2", 1, priority="batch")
    started = []
    monkeypatch.setattr(sched, "_start_sequence", _fake_start(impl, sched, started))
    sched.add_request(impl.Request("crit", [1] * 4, priority="critical", enqueue_ts=time.monotonic()))
    sched._admit()
    assert started == [] and sched.qos_sheds == 0  # inside the gate: no thrash
    sched.waiting[0].enqueue_ts = time.monotonic() - 1.0
    sched._admit()
    assert started == ["crit"]
    assert sched.qos_sheds == 1 and sched.preempt_count == 1 and sched.qos_preempted == {"batch": 1}
    assert [r.request_id for r in sched.waiting] == ["b2"] and sched.waiting[0].priority == "batch"

    sched2 = _scheduler(impl, max_seqs=1)
    _running(impl, sched2, "c1", 0, priority="critical")
    sched2.add_request(impl.Request("c2", [1] * 4, priority="critical", enqueue_ts=time.monotonic() - 1.0))
    sched2._admit()
    assert sched2.qos_sheds == 0 and sched2.preempt_count == 0
    assert [r.request_id for r in sched2.waiting] == ["c2"]


CLASSES = st.sampled_from(["critical", "standard", "batch", ""])


@settings(max_examples=60, deadline=None)
@given(slots=st.lists(st.one_of(st.none(), CLASSES), min_size=1, max_size=6),
       waiting=st.lists(CLASSES, max_size=6), exclude=st.integers(0, 5), on=st.booleans(),
       orders=st.permutations(range(6)))
def test_qos_choices_equal_the_reference(slots, waiting, exclude, on, orders):
    """Random slot and queue states, built the same in both schedulers:
    the next admission and the preemption victim are the same request."""
    picks = []
    for impl in IMPLS.values():
        sched = _scheduler(impl, qos=on, max_seqs=len(slots))
        for i, cls in enumerate(slots):
            if cls is not None:
                seq = _running(impl, sched, f"s{i}", i, priority=cls)
                seq.admitted_order = orders[i]
        for i, cls in enumerate(waiting):
            sched.add_request(impl.Request(f"w{i}", [1] * 4, priority=cls))
        ex = sched.slots[exclude % len(slots)]
        victim = sched._pick_victim(exclude=ex)
        picks.append((sched._next_waiting_index() if waiting else None,
                      None if victim is None else victim.req.request_id))
    assert picks[0] == picks[1]


# ---------------------------------------------------------------- chunk planner


@settings(max_examples=300, deadline=None)
@given(buckets=st.lists(st.integers(1, 1024), min_size=1, max_size=6, unique=True),
       flat=st.one_of(st.just(0), st.integers(0, 20000)), depth=st.integers(0, 200_000),
       backlog=st.integers(0, 10_000))
def test_chunk_len_for_equals_the_reference(buckets, flat, depth, backlog):
    buckets = tuple(sorted(buckets))
    got = EngineConfig(prefill_buckets=buckets, prefill_flat_depth=flat).chunk_len_for(depth, backlog)
    want = JaxEngineConfig(prefill_buckets=buckets, prefill_flat_depth=flat).chunk_len_for(depth, backlog)
    assert got == want and got in buckets


PLANNER = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=128, prefill_buckets=(8, 16, 32),
               prefill_flat_depth=8)
LONG = [(7 * i) % 211 + 5 for i in range(120)]


def _prefill_rows(anatomy, kind):
    return [r.tokens for r in anatomy.ring if r.kind == kind]


def test_long_prompt_chunks_equal_the_reference_engine():
    """A 120-token prompt at flat depth 8 (buckets 8 / 16 / 32): on the
    packed path the backlog first doubles the budget (32, 32), then the
    chunks shrink with depth; the port's prefill calls take the reference
    engine's rows, call for call, and its greedy tokens. Off the packed
    path each chunk is chunk_len_for(depth) with no backlog."""

    async def jax_run():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, **PLANNER))
        await engine.start()
        try:
            out = [o.token async for o in engine.generate(JaxEngineRequest("j", LONG, JaxSamplingParams(max_tokens=4)))
                   if o.token is not None]
            params = jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
            return out, _prefill_rows(engine.scheduler.anatomy, "prefill_packed"), params
        finally:
            await engine.shutdown()

    want, want_rows, params = asyncio.run(jax_run())
    model = LlamaModel(LlamaConfig.tiny())
    model.load_state_dict(params_from_jax(params, model.config))

    async def port_run(**over):
        engine = AsyncTorchEngine(EngineConfig(device="cpu", **dict(PLANNER, **over)), model=model)
        await engine.start()
        try:
            out = [o.token async for o in engine.generate(EngineRequest("p", LONG, SamplingParams(max_tokens=4)))
                   if o.token is not None]
            return out, engine.scheduler.anatomy
        finally:
            await engine.shutdown()

    got, anatomy = asyncio.run(port_run())
    assert want_rows == [32, 32] + [8] * 7
    assert _prefill_rows(anatomy, "prefill_packed") == want_rows and got == want
    got, anatomy = asyncio.run(port_run(prefill_lanes=1))
    cfg, plan, start = EngineConfig(**PLANNER), [], 0
    while start < len(LONG):
        plan.append(min(cfg.chunk_len_for(start), len(LONG) - start))
        start += plan[-1]
    assert _prefill_rows(anatomy, "prefill_chunk") == plan == [32, 16, 16, 8, 8, 8, 8, 8, 8, 8]
    assert got == want


# ---------------------------------------------------------------- HTTP


class ScriptedEngine:
    """Tokens out of a fixed script, two a window; ``backpressure_snapshot``
    reports what the test sets."""

    def __init__(self):
        self.bp = None

    def backpressure_snapshot(self):
        return self.bp

    async def generate_batched(self, request):
        n = request.sampling.max_tokens
        for i in range(0, n, 2):
            await asyncio.sleep(0)
            outs = [StepOutput(request.request_id, token=72 + (j % 20)) for j in range(i, min(i + 2, n))]
            if i + 2 >= n:
                outs[-1].finished, outs[-1].finish_reason = True, "length"
            yield outs


@pytest.fixture(scope="module")
def services():
    """(reference port, port port, the scripted engine) of one reference and
    one port service on a background loop, each with a budget of 80 tokens
    at 1 token/s for tenant t1."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    engine = ScriptedEngine()

    async def boot():
        ref = RefHttpService(host="127.0.0.1", port=0,
                             qos=ref_qos.AdmissionController(ref_qos.QosPolicy.from_specs("t1=1:80", "")))
        ref.manager.add(ref_build_pipeline(engine, ref_card_for_model("tiny")))
        port = HttpService(host="127.0.0.1", port=0,
                           qos=port_qos.AdmissionController(port_qos.QosPolicy.from_specs("t1=1:80", "")))
        port.manager.add(build_pipeline(engine, card_for_model("tiny")))
        return ref, port, await ref.start(), await port.start()

    ref, port, ref_port, port_port = asyncio.run_coroutine_threadsafe(boot(), loop).result(60)
    yield ref_port, port_port, engine, port
    async def stop():
        await ref.stop()
        await port.stop()

    asyncio.run_coroutine_threadsafe(stop(), loop).result(60)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)
    loop.close()


BODY = {"model": "tiny", "messages": [{"role": "user", "content": "hello"}], "max_tokens": 64, "temperature": 0}


def _post(port, body, headers=None):
    """(status, content type, Retry-After, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def _answer(port, body, headers=None):
    """(status, error code or None, Retry-After) of one request; an error is
    JSON, never SSE bytes."""
    status, ctype, retry, raw = _post(port, body, headers)
    if status == 200:
        return status, None, retry
    assert ctype.startswith("application/json") and not raw.startswith(b"data:")
    return status, json.loads(raw)["error"].get("code"), retry


def test_http_qos_answers_equal_the_reference(services):
    ref_port, port_port, engine, port_service = services
    answers = {}
    for name, port in (("reference", ref_port), ("port", port_port)):
        got = [_answer(port, BODY, {"x-priority": "urgent"})]  # unknown class: 400
        engine.bp = {"queue_depth": 40, "drain_rps": 0.5, "est_wait_s": 80.0, "retry_after_s": 30}
        got.append(_answer(port, BODY, {"x-priority": "batch"}))  # shed: 429 overloaded
        got.append(_answer(port, BODY))  # standard: served
        got.append(_answer(port, BODY, {"x-priority": "critical"}))
        engine.bp = None
        got.append(_answer(port, BODY, {"x-tenant": "t1"}))  # drains t1's 80-token burst
        got.append(_answer(port, BODY, {"x-tenant": "t1"}))  # unary: 429 rate_limited
        got.append(_answer(port, dict(BODY, stream=True), {"x-tenant": "t1"}))  # stream: the same, no SSE
        answers[name] = got
    assert answers["port"] == answers["reference"]
    got = answers["port"]
    assert got[0][:2] == (400, "invalid_priority")
    assert got[1] == (429, "overloaded", "30")
    assert [g[0] for g in got[2:5]] == [200, 200, 200]
    for status, code, retry in got[5:]:
        assert (status, code) == (429, "rate_limited") and 1 <= int(retry) <= 30
    snap = port_service.qos.snapshot()
    assert snap["classes"]["standard"]["t1"] == {"admitted": 1, "throttled": 2}
    assert snap["classes"]["batch"][""] == {"shed": 1}
    conn = http.client.HTTPConnection("127.0.0.1", port_port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    assert 'dynamo_qos_requests_total{action="throttled",class="standard",tenant="t1"} 2' in text
    assert "dynamo_qos_budget_fill" in text


def test_http_stamps_the_class_on_the_engine_request(services):
    """The admitted class and tenant reach the engine's request; the
    policy's tenant default applies without the header."""
    _, port_port, engine, port_service = services
    seen = []
    orig = engine.generate_batched

    async def spy(request):
        seen.append((request.priority, request.tenant))
        async for out in orig(request):
            yield out

    engine.generate_batched = spy
    old_policy = port_service.qos.policy
    port_service.qos.policy = port_qos.QosPolicy.from_specs("", "t9=batch")
    try:
        assert _answer(port_port, dict(BODY, max_tokens=4), {"x-priority": "critical", "x-tenant": "t7"})[0] == 200
        assert _answer(port_port, dict(BODY, max_tokens=4), {"x-tenant": "t9"})[0] == 200
    finally:
        del engine.generate_batched
        port_service.qos.policy = old_policy
    assert seen == [("critical", "t7"), ("batch", "t9")]
