"""Preemption under page pressure in the port against the JAX package, on the
CPU at f32 and tiny widths: a page pool too small for every sequence's
growth makes both schedulers drain, preempt the most recent sequence back
to the waiting queue and resume it from prompt + generated tokens.

  - greedy tokens and finish reasons equal ``AsyncJaxEngine``'s on the same
    weights and the same pool, with preemption seen on both engines, at
    decode_steps 1 and 4 and prefill_lanes 1 and 4, for Llama and for a
    tiny DeepSeek (MLA + MoE);
  - penalties, ``min_tokens`` past an EOS id and logprobs survive a
    preemption of their own request and match the reference (logprobs
    within 1e-4);
  - seeded sampled streams under the tight pool equal the same streams in
    a roomy pool (port against port: the JAX engine's threefry bits are not
    the port's Philox bits);
  - speculation (n-gram and draft-model) under the tight pool gives the
    roomy pool's streams and the engine's without speculation; a lone
    sequence whose pool cannot hold a full proposal runs truncated rounds
    and ends with "length".
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu.engine.scheduler import Scheduler as JaxScheduler
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest, Scheduler
from dynamo_tpu_torch.models import registry
from dynamo_tpu_torch.models.convert import deepseek_params_from_jax, params_from_jax
from dynamo_tpu_torch.models.deepseek import DeepseekConfig, DeepseekModel
from dynamo_tpu_torch.models.llama import LlamaModel

torch.set_num_threads(2)

ENGINE = dict(page_size=4, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32), watermark=0.0)
# 23 usable pages: the four prompts take 14 at admission, their growth to
# 24 tokens each would take 38
TIGHT, ROOMY = 24, 64
PROMPTS = {"a": [5, 9, 2, 77, 31], "b": list(range(40, 51)), "c": [200 - i for i in range(20)],
           "d": [7 * i % 97 + 3 for i in range(14)]}
MAX_TOKENS = 24
# the pressure configurations: (decode_steps, prefill_lanes)
SHAPES = [(1, 1), (1, 4), (4, 1), (4, 4)]


async def collect(engine, req):
    toks, reason, lps = [], None, []
    async for out in engine.generate(req):
        if out.token is not None:
            toks.append(out.token)
            if out.logprob is not None:
                lps.append((out.logprob, out.top_logprobs))
        reason = out.finish_reason
    return toks, reason, lps


def _record_victims(monkeypatch, cls) -> list:
    """Request ids ``cls._preempt`` takes, in order."""
    victims = []
    orig = cls._preempt

    def preempt(self, seq):
        victims.append(seq.req.request_id)
        return orig(self, seq)

    monkeypatch.setattr(cls, "_preempt", preempt)
    return victims


def _jax_run(model_id, requests, num_pages, decode_steps=4, prefill_lanes=4):
    """(outputs by id, preemptions, numpy params)."""

    async def run():
        engine = AsyncJaxEngine(JaxEngineConfig(
            model_id=model_id, tp=1, num_pages=num_pages, decode_steps=decode_steps, prefill_lanes=prefill_lanes,
            **ENGINE))
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                collect(engine, JaxEngineRequest(rid, list(p), JaxSamplingParams(**s), **kw))
                for rid, p, s, kw in requests
            ))
            params = jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
            return dict(zip([r[0] for r in requests], outs)), engine.scheduler.preempt_count, params
        finally:
            await engine.shutdown()

    return asyncio.run(run())


def _port_model(model_id, np_params):
    cfg = registry.config_for(model_id)
    if isinstance(cfg, DeepseekConfig):
        model = DeepseekModel(cfg)
        model.load_state_dict(deepseek_params_from_jax(np_params, cfg))
    else:
        model = LlamaModel(cfg)
        model.load_state_dict(params_from_jax(np_params, cfg))
    return model


def _port_run(model, requests, num_pages, **over):
    """(outputs by id, the engine that served them)."""

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", num_pages=num_pages, **dict(ENGINE, **over)),
                                  model=model)
        await engine.start()
        try:
            await engine.wait_warmup()
            outs = await asyncio.wait_for(asyncio.gather(*(
                collect(engine, EngineRequest(rid, list(p), SamplingParams(**s), **kw))
                for rid, p, s, kw in requests
            )), 120)
            return dict(zip([r[0] for r in requests], outs)), engine
        finally:
            await engine.shutdown()

    return asyncio.run(run())


def _greedy(max_tokens=MAX_TOKENS):
    return [(rid, p, dict(max_tokens=max_tokens), {}) for rid, p in PROMPTS.items()]


def _tokens(outs):
    return {rid: (toks, reason) for rid, (toks, reason, _) in outs.items()}


@pytest.fixture(scope="module")
def llama_reference():
    """The JAX engine's greedy streams on the tight pool (preempting), and
    its weights."""
    outs, preempts, params = _jax_run("tiny", _greedy(), TIGHT)
    assert preempts >= 1
    return outs, params


@pytest.mark.parametrize("decode_steps,prefill_lanes", SHAPES, ids=[f"ds{d}-lanes{n}" for d, n in SHAPES])
def test_greedy_streams_under_page_pressure_equal_jax_engine(llama_reference, decode_steps, prefill_lanes):
    want, params = llama_reference
    got, engine = _port_run(_port_model("tiny", params), _greedy(), TIGHT, decode_steps=decode_steps,
                            prefill_lanes=prefill_lanes)
    assert engine.scheduler.preempt_count >= 1
    assert engine.resource_snapshot()["preemptions"] == engine.scheduler.preempt_count
    assert _tokens(got) == _tokens(want)
    assert all(r == "length" and len(t) == MAX_TOKENS for t, r, _ in got.values())


def test_jax_engine_preempts_at_every_shape(llama_reference):
    """The reference preempts on this pool at each pressure shape too, and
    gives the same streams: the port's runs above are compared with a
    preempting reference at each of their shapes."""
    want, _ = llama_reference
    for decode_steps, prefill_lanes in SHAPES[:3]:
        outs, preempts, _ = _jax_run("tiny", _greedy(), TIGHT, decode_steps, prefill_lanes)
        assert preempts >= 1, (decode_steps, prefill_lanes)
        assert _tokens(outs) == _tokens(want)


def test_deepseek_greedy_streams_under_page_pressure_equal_jax_engine():
    """tiny-mla (MLA latent cache, MoE): the per-request prefill path under
    page pressure."""
    requests = _greedy(16)
    want, preempts, params = _jax_run("tiny-mla", requests, 18)
    assert preempts >= 1
    got, engine = _port_run(_port_model("tiny-mla", params), requests, 18)
    assert not engine.runner.packed_prefill_mode
    assert engine.scheduler.preempt_count >= 1
    assert _tokens(got) == _tokens(want)


# (id, prompt, sampling, request kwargs) of the feature requests; "min"
# takes its EOS id from the reference's plain stream (see feature_runs)
FEATURES = {
    "pen": ([11, 12, 13, 14, 15], dict(max_tokens=14, ignore_eos=True, frequency_penalty=0.9,
                                       presence_penalty=0.4), {}),
    "min": (list(range(60, 71)), dict(max_tokens=14, min_tokens=10), {}),
    "lp": ([150 - i for i in range(22)], dict(max_tokens=14), dict(logprobs=3)),
}
# 15 usable pages: the long request alone grows to 15, beside it a feature
# request outgrows the pool before its 14th token
FEATURE_PAGES = 16


def _scenario(name, eos):
    """A long greedy request that outgrows the pool, then the feature
    request ``name``, admitted after it: the most recent sequence, so the
    victim."""
    prompt, sampling, kw = FEATURES[name]
    if name == "min":
        kw = dict(kw, eos_token_ids=(eos,))
    bg = [(f"bg-{name}", [(37 * i + 11 * len(name)) % 251 + 1 for i in range(30)],
           dict(max_tokens=30, ignore_eos=True), {})]
    return bg + [(name, prompt, sampling, kw)]


async def _serial(engine, make_request, scenarios, victims):
    """Serve each scenario's requests concurrently, one scenario after the
    other on one engine; returns {scenario: (outputs by id, victims)}."""
    out = {}
    for name, requests in scenarios.items():
        before = len(victims)
        outs = await asyncio.gather(*(collect(engine, make_request(*r)) for r in requests))
        out[name] = dict(zip([r[0] for r in requests], outs)), victims[before:]
    return out


@pytest.fixture(scope="module")
def feature_runs():
    """Both engines on one tight pool, one scenario per feature after a
    plain greedy run of the min_tokens prompt that picks its EOS id (the
    stream's third token): {scenario: ((reference outputs, victims), (port
    outputs, victims))}, and the reference's weights."""
    mp = pytest.MonkeyPatch()
    j_victims, p_victims = _record_victims(mp, JaxScheduler), _record_victims(mp, Scheduler)

    def j_request(rid, p, s, kw):
        return JaxEngineRequest(rid, list(p), JaxSamplingParams(**s), **kw)

    def p_request(rid, p, s, kw):
        return EngineRequest(rid, list(p), SamplingParams(**s), **kw)

    async def jax_side():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, num_pages=FEATURE_PAGES, **ENGINE))
        await engine.start()
        try:
            plain, _, _ = await collect(engine, j_request("plain", FEATURES["min"][0], dict(max_tokens=8), {}))
            eos = plain[2]
            runs = await _serial(engine, j_request, {n: _scenario(n, eos) for n in FEATURES}, j_victims)
            return runs, eos, jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
        finally:
            await engine.shutdown()

    async def port_side(params, eos):
        engine = AsyncTorchEngine(EngineConfig(device="cpu", num_pages=FEATURE_PAGES, **ENGINE),
                                  model=_port_model("tiny", params))
        await engine.start()
        try:
            return await _serial(engine, p_request, {n: _scenario(n, eos) for n in FEATURES}, p_victims)
        finally:
            await engine.shutdown()

    try:
        want, eos, params = asyncio.run(jax_side())
        got = asyncio.run(port_side(params, eos))
    finally:
        mp.undo()
    return {n: (want[n], got[n]) for n in FEATURES}, eos


@pytest.mark.parametrize("name", list(FEATURES))
def test_features_survive_preemption(feature_runs, name):
    """Penalties (their counts restored from the resume prompt's output
    tail), min_tokens (EOS banned until the 10th token across the resume)
    and logprobs survive a preemption of their own request: tokens, finish
    reasons and logprobs equal the reference's on the same pool, where it
    preempted the same request."""
    runs, eos = feature_runs
    (want, j_victims), (got, p_victims) = runs[name]
    assert name in p_victims and name in j_victims
    assert _tokens(got) == _tokens(want)
    toks, reason, lps = got[name]
    if name == "min":
        assert eos not in toks[:10]
        assert reason == "length" or (reason == "stop" and toks[-1] == eos and len(toks) > 10)
    if name == "lp":
        want_lps = want[name][2]
        assert len(lps) == len(toks) == len(want_lps)
        for (lp, top), (want_lp, want_top) in zip(lps, want_lps):
            assert lp == pytest.approx(want_lp, abs=1e-4)
            assert [t for t, _ in top] == [t for t, _ in want_top]
            np.testing.assert_allclose([v for _, v in top], [v for _, v in want_top], atol=1e-4)


def test_seeded_sampled_streams_survive_preemption():
    """Seeded sampled requests draw their noise from (seed, position): a
    preempted stream resumes with the tokens it would have drawn, so the
    tight pool's streams equal the roomy pool's (port against port)."""
    model = registry.load_model("tiny", device="cpu")
    requests = [(rid, p, dict(max_tokens=MAX_TOKENS, temperature=0.8, seed=7 + i, top_k=20 if i % 2 else 0), {})
                for i, (rid, p) in enumerate(PROMPTS.items())]
    tight, engine = _port_run(model, requests, TIGHT)
    assert engine.scheduler.preempt_count >= 1
    roomy, engine = _port_run(model, requests, ROOMY)
    assert engine.scheduler.preempt_count == 0
    assert _tokens(tight) == _tokens(roomy)


@pytest.mark.parametrize("spec", ["ngram:4", "draft:tiny:3"])
def test_speculation_under_page_pressure(spec):
    """Spec rounds under the tight pool: the pressure ladder preempts (the
    draft cache is rebuilt from the resume prompt), and every stream equals
    the roomy pool's and the engine's without speculation."""
    model = registry.load_model("tiny", device="cpu")
    requests = _greedy()
    base, _ = _port_run(model, requests, ROOMY)
    roomy, _ = _port_run(model, requests, ROOMY, speculative=spec)
    tight, engine = _port_run(model, requests, TIGHT, speculative=spec)
    sched = engine.scheduler
    assert sched.preempt_count >= 1 and sched.stage.spec_rounds > 0
    assert _tokens(tight) == _tokens(roomy) == _tokens(base)


def test_spec_round_truncates_its_proposal_when_no_victim_is_left(monkeypatch):
    """A lone sequence whose pool ends a few positions past the EOS its
    stream stops on: near the end a full proposal does not fit and there is
    no victim to preempt, so the round shrinks its proposal to the
    allocated pages, and the stream stops on its EOS with the plain
    engine's tokens (no "error")."""
    picks = []
    orig = Scheduler._pick_victim
    monkeypatch.setattr(Scheduler, "_pick_victim", lambda self, exclude: picks.append(orig(self, exclude)) or picks[-1])
    model = registry.load_model("tiny", device="cpu")
    prompt = [3, 4, 5, 3, 4, 5, 3, 4, 5, 3, 4, 5]  # repetitive: the n-gram proposer has drafts
    base, _ = _port_run(model, [("r", prompt, dict(max_tokens=30, ignore_eos=True), {})], ROOMY)
    toks = base["r"][0]
    # the first token at index >= 16 that the stream has not emitted before
    j = next(i for i in range(16, len(toks)) if toks[i] not in toks[:i])
    # token j is sampled at fed position 11 + j: the pool's pages hold just that
    got, engine = _port_run(model, [("r", prompt, dict(max_tokens=30), dict(eos_token_ids=(toks[j],)))],
                            -(-(len(prompt) + j) // 4) + 1, speculative="ngram:4")
    assert engine.scheduler.stage.spec_rounds > 0 and engine.scheduler.preempt_count == 0
    assert picks and all(p is None for p in picks)  # the pool ran short, with no victim
    assert _tokens(got) == {"r": (toks[: j + 1], "stop")}
