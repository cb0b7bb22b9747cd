"""The port's step anatomy (``dynamo_tpu_torch/utils/step_anatomy.py``) on the
CPU: one scripted sequence of calls gives the reference's ``StepAnatomy``
numbers, records and metric families; ``roofline_for_runner`` prices the
tiny Llama and the tiny DeepSeek as the reference does; and the port's
scheduler records its dispatches at the reference's seams."""

import asyncio
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.registry import load_model as jax_load_model
from dynamo_tpu.utils.step_anatomy import KINDS as JAX_KINDS
from dynamo_tpu.utils.step_anatomy import PHASES as JAX_PHASES
from dynamo_tpu.utils.step_anatomy import PREFILL_KINDS as JAX_PREFILL_KINDS
from dynamo_tpu.utils.step_anatomy import RooflineModel as JaxRooflineModel
from dynamo_tpu.utils.step_anatomy import StepAnatomy as JaxStepAnatomy
from dynamo_tpu.utils.step_anatomy import roofline_for_runner as jax_roofline_for_runner
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.models.convert import deepseek_params_from_jax, params_from_jax
from dynamo_tpu_torch.models.deepseek import DeepseekConfig, DeepseekModel
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.utils.step_anatomy import KINDS, PHASES, PREFILL_KINDS, RooflineModel, StepAnatomy, \
    roofline_for_runner

torch.set_num_threads(2)

ROOF = dict(param_bytes=2_600_000_000, page_bytes=24 * 2 * 128 * 8 * 16 * 2, page_size=16, param_count=1_300_000_000,
            hbm_bw=3.35e12)
PEAK = 989e12


def script(anatomy, ring_sizes_seen: list) -> None:
    """One sequence of recording calls: packed and per-request prefill,
    decode windows priced at their occupancy, a one-shot record, a
    None-safe phase, a negative delta (clamped), a no-op floor, and enough
    records to evict the ring's oldest."""
    t = 100.0
    rec = anatomy.begin("prefill_packed", ts=t)
    anatomy.add_phase(rec, "host_prep", 0.0012)
    anatomy.add_phase(rec, "dispatch", 0.0041)
    anatomy.note_steps(rec, tokens=700, participants=3)
    anatomy.note_prefill_floor(rec, 700)
    windows = []
    for i in range(5):
        w = anatomy.begin("decode_window", ts=t + 0.013 * (i + 1) + 0.001 * i * i)
        anatomy.add_phase(w, "host_prep", 0.0003 + 1e-5 * i)
        anatomy.add_phase(w, "dispatch", 0.0021 + 2e-4 * i)
        anatomy.note_steps(w, steps=8, tokens=40 - i, participants=5 - i % 2,
                           floor_bytes=anatomy.decode_floor_bytes(37 + 3 * i, 8))
        windows.append(w)
        ring_sizes_seen.append(len(anatomy.ring))
    anatomy.add_phase(rec, "device_wait", 0.0207)
    anatomy.add_phase(rec, "reconcile", 0.00031)
    for i, w in enumerate(windows):
        anatomy.add_phase(w, "device_wait", 0.011 * (i % 3))
        anatomy.add_phase(w, "reconcile", 0.00042 + 1e-5 * i)
    anatomy.add_phase(None, "device_wait", 0.0015)
    anatomy.add_phase(windows[0], "reconcile", -0.5)
    chunk = anatomy.begin("prefill_chunk", ts=t + 0.2)
    anatomy.add_phase(chunk, "host_prep", 0.0008)
    anatomy.add_phase(chunk, "dispatch", 0.0197)
    anatomy.note_steps(chunk, tokens=96, participants=1)
    anatomy.note_prefill_floor(chunk, 96)
    anatomy.note_prefill_floor(chunk, 0)
    anatomy.note_prefill_floor(None, 50)
    anatomy.record("prefill_chunk", dispatch_s=0.0123, host_prep_s=0.0004, device_wait_s=0.002,
                   reconcile_s=0.0001, tokens=31, participants=1, ts=t + 0.25)
    anatomy.record("spec_verify", dispatch_s=0.003, steps=1, tokens=4, participants=2, floor_bytes=12345,
                   ts=t + 0.3)


def families(text: str) -> tuple[dict, dict]:
    """({family: type}, {sample name with labels: value}) of an exposition."""
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    return types, samples


@pytest.mark.parametrize("ring_size", [512, 4])
def test_anatomy_agrees_with_the_reference_on_a_scripted_sequence(ring_size):
    ref = JaxStepAnatomy(ring_size=ring_size, roofline=JaxRooflineModel(**ROOF, mxu_flops=PEAK))
    got = StepAnatomy(ring_size=ring_size, roofline=RooflineModel(**ROOF, peak_flops=PEAK))
    seen_ref, seen_got = [], []
    script(ref, seen_ref)
    script(got, seen_got)
    assert seen_got == seen_ref
    assert (KINDS, PHASES, PREFILL_KINDS) == (JAX_KINDS, JAX_PHASES, JAX_PREFILL_KINDS)
    for kinds in (None, ("decode_window",), PREFILL_KINDS):
        assert got.host_fraction(kinds) == pytest.approx(ref.host_fraction(kinds), abs=1e-12, rel=1e-12)
    for name in ("roofline_fraction", "prefill_roofline_fraction", "prefill_fixed_ms"):
        want = getattr(ref, name)()
        assert want is not None and getattr(got, name)() == pytest.approx(want, abs=1e-12, rel=1e-12), name
    for kind in ("decode_window", "prefill_chunk"):
        for q in (0.0, 0.5, 0.9):
            assert got.dispatch_gap_ms(kind, q) == pytest.approx(ref.dispatch_gap_ms(kind, q), abs=1e-12)
    assert got.records() == ref.records() and got.records(limit=2, kind="decode_window") == \
        ref.records(limit=2, kind="decode_window")
    snap_got, snap_ref = got.snapshot(), ref.snapshot()
    assert snap_got.pop("roofline")["peak_flops_s"] == snap_ref.pop("roofline")["mxu_flops_s"] == PEAK
    assert snap_got == snap_ref
    (types_got, samples_got), (types_ref, samples_ref) = families(got.render_metrics()), \
        families(ref.render_metrics())
    assert types_got == types_ref and len(types_got) == 5
    assert samples_got.keys() == samples_ref.keys()
    for name, value in samples_ref.items():
        assert samples_got[name] == pytest.approx(value, abs=1e-12, rel=1e-12), name


def test_empty_anatomy_reports_nothing_as_the_reference_does():
    got, ref = StepAnatomy(), JaxStepAnatomy()
    for name in ("host_fraction", "roofline_fraction", "prefill_roofline_fraction", "prefill_fixed_ms",
                 "dispatch_gap_ms"):
        assert getattr(got, name)() is getattr(ref, name)() is None
    assert families(got.render_metrics()) == families(ref.render_metrics())


@pytest.mark.parametrize("live_pages", [0, 1, 37, 4096])
def test_decode_floor_does_the_reference_arithmetic(live_pages):
    ref = JaxRooflineModel(**ROOF, mxu_flops=PEAK)
    got = RooflineModel(**ROOF)
    assert got.step_floor_bytes(live_pages) == ref.step_floor_bytes(live_pages)
    assert got.step_floor_seconds(live_pages) == ref.step_floor_seconds(live_pages)
    assert StepAnatomy(roofline=got).decode_floor_bytes(live_pages, 8) == \
        JaxStepAnatomy(roofline=ref).decode_floor_bytes(live_pages, 8)


def _jax_runner(model, params):
    class JaxRunner:
        pass

    runner = JaxRunner()
    runner.model, runner.params = model, params
    return runner


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_floor_bytes_of_the_tiny_llama_equal_the_reference(kv_cache_dtype):
    """The tiny Llama's weights from ``params_from_jax`` in a port runner:
    its roofline's floor bytes equal the reference runner's at every
    occupancy (parameter bytes and count from the leaves, page bytes at the
    cache's dtype)."""
    jax_model, jax_params = jax_load_model("tiny", kv_cache_dtype=kv_cache_dtype)
    cfg = LlamaConfig.tiny(kv_cache_dtype=kv_cache_dtype)
    model = LlamaModel(cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params), cfg))
    ecfg = EngineConfig(device="cpu", num_pages=16, max_seqs=2, max_model_len=64, kv_cache_dtype=kv_cache_dtype)
    got = roofline_for_runner(ModelRunner(ecfg, model), ecfg)
    ref = jax_roofline_for_runner(_jax_runner(jax_model, jax_params), ecfg)
    for live in (0, 1, 9, 15):
        assert got.step_floor_bytes(live) == ref.step_floor_bytes(live)
    assert (got.param_count, got.page_bytes) == (ref.param_count, ref.page_bytes)


def test_floor_bytes_of_the_tiny_deepseek_equal_the_reference():
    """The tiny DeepSeek's weights from ``deepseek_params_from_jax``. The
    reference's DeepseekModel prices no KV page (its roofline_for_runner
    gives None: no step-anatomy roofline on MLA); given the latent row of
    its own config as the page price, its estimator's floor bytes equal the
    port runner's at every occupancy: the parameter bytes and count agree."""
    jax_model, jax_params = jax_load_model("tiny-mla")
    assert jax_roofline_for_runner(_jax_runner(jax_model, jax_params), EngineConfig(device="cpu")) is None
    jc = jax_model.config
    cfg = DeepseekConfig.tiny_mla()
    model = DeepseekModel(cfg)
    model.load_state_dict(deepseek_params_from_jax(jax.tree.map(np.asarray, jax_params), cfg))
    ecfg = EngineConfig(device="cpu", model_id="tiny-mla", num_pages=16, max_seqs=2, max_model_len=64)
    got = roofline_for_runner(ModelRunner(ecfg, model), ecfg)

    class Priced:
        config = jc

        def kv_page_bytes(self, page_size):
            return jc.num_layers * page_size * jc.latent_dim * jnp.dtype(jc.dtype).itemsize

    ref = jax_roofline_for_runner(_jax_runner(Priced(), jax_params), ecfg)
    for live in (0, 1, 9, 15):
        assert got.step_floor_bytes(live) == ref.step_floor_bytes(live)
    assert got.param_count == ref.param_count and got.page_bytes == ref.page_bytes


ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))


@pytest.mark.parametrize("prefill_lanes,kind", [(4, "prefill_packed"), (1, "prefill_chunk")],
                         ids=["packed", "per-request"])
def test_scheduler_records_each_dispatch_at_its_seams(prefill_lanes, kind):
    """The CPU engine's anatomy: one decode_window record per window and one
    prefill record per call, in dispatch order; every phase >= 0; the
    windows' tokens sum to the tokens they emitted, the prefill records'
    rows to the prompts; each record priced."""
    prompts = [list(range(3, 3 + n)) for n in (5, 11, 20, 40)]
    max_tokens = 10

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", model_id="tiny", prefill_lanes=prefill_lanes, **ENGINE))
        await engine.start()
        runner = engine.runner
        calls = []
        for name in ("prefill_chunk_batch", "dispatch_decode_window"):
            inner = getattr(runner, name)

            def wrapped(*a, _inner=inner, _name=name, **kw):
                calls.append(_name)
                return _inner(*a, **kw)

            setattr(runner, name, wrapped)

        async def one(i, p):
            n = 0
            async for out in engine.generate(EngineRequest(f"r{i}", p, SamplingParams(max_tokens=max_tokens))):
                n += out.token is not None
            return n

        try:
            emitted = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
        finally:
            await engine.shutdown()
        return emitted, calls, engine.scheduler.anatomy

    emitted, calls, anatomy = asyncio.run(run())
    assert emitted == [max_tokens] * len(prompts)
    records = anatomy.records(limit=10_000)
    assert [r["kind"] for r in records] == ["decode_window" if c == "dispatch_decode_window" else kind
                                             for c in calls]
    for r in records:
        assert min(r[p + "_ms"] for p in ("host_prep", "dispatch", "device_wait", "reconcile")) >= 0
    windows = [r for r in records if r["kind"] == "decode_window"]
    prefills = [r for r in records if r["kind"] == kind]
    assert sum(r["tokens"] for r in windows) == sum(emitted) - len(prompts)  # first tokens: prefill's
    assert sum(r["tokens"] for r in prefills) == sum(len(p) for p in prompts)
    assert all(r["steps"] == ENGINE.get("decode_steps", 8) and r["floor_bytes"] > 0 for r in windows)
    assert all(r["floor_ms"] > 0 for r in prefills)
    assert anatomy.dispatch_counts == {k: v for k, v in (("decode_window", len(windows)), (kind, len(prefills)))}
    assert 0 < anatomy.host_fraction() <= 1 and anatomy.roofline_fraction() > 0
    assert anatomy.prefill_roofline_fraction() > 0 and anatomy.prefill_fixed_ms() > 0
    assert re.search(r'dynamo_step_dispatch_total\{kind="decode_window"\} ' + str(len(windows)),
                     anatomy.render_metrics())
