"""Penalties, min_tokens and logprobs in the port, on the CPU, against the
reference:

  - ``apply_penalties``, the EOS ban and ``sample_tokens_with_logprobs``
    against ``dynamo_tpu.engine.sampling`` at f32 on the same seeded logits
    (penalized logits within atol 1e-5; tokens and top ids equal, logprobs
    within atol 1e-4);
  - the engine against ``AsyncJaxEngine`` on the same weights (f32):
    greedy requests with penalties, with ``min_tokens`` past an EOS the
    greedy stream would stop at, with logprobs, and with all three, packed
    and per-request, in windows of 8 and of 1: equal tokens and finish
    reasons, logprobs within atol 1e-4;
  - a seeded sampled request with penalties and logprobs reproduces token
    for token whatever shares its batch;
  - the same requests through the graph path behind test_torch_compiled's
    fake backend equal the eager engine's, and the warmup captures the
    feature variants, writing only the trash page and the drop slot;
  - ``tools/checks.py graph_against_eager``'s feature calls, graph against
    eager, bit for bit;
  - the HTTP completions and chat logprobs cases of the reference's
    ``tests/test_logprobs.py`` against the reference's service, as
    ``tests/test_torch_http.py`` runs them.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import model_runner
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.sampling import (
    LOGPROBS_K,
    MAX_EOS_IDS,
    SamplingParams,
    apply_penalties,
    ban_eos,
    sample_tokens_with_logprobs,
)
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from test_torch_compiled import FakeGraphRunner

torch.set_num_threads(2)

ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
PROMPTS = [[5, 9, 2, 77, 31], list(range(40, 51)), [200 - i for i in range(20)], [3, 3, 3, 4, 4, 9, 9, 9, 1]]
PENALTIES = dict(repetition_penalty=1.3, frequency_penalty=0.5, presence_penalty=0.5)
LP_ATOL = 1e-4  # f32 log-softmax of logits that agree to ~1e-6


# ---------------------------------------------------------------- functions


@pytest.mark.parametrize("pres,freq,rep", [(0.0, 0.0, 1.0), (0.5, 0.5, 1.3), (-0.3, 1.2, 0.8), (2.0, 0.0, 1.0)])
def test_apply_penalties_matches_reference(pres, freq, rep):
    import jax.numpy as jnp

    from dynamo_tpu.engine.sampling import apply_penalties as ref_apply

    rng = np.random.default_rng(4)
    B, V = 5, 300
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)
    counts = rng.integers(0, 4, (B, V)).astype(np.int32) * (rng.random((B, V)) < 0.2)
    seen = (counts > 0) | (rng.random((B, V)) < 0.1)
    vec = [np.full(B, x, np.float32) for x in (pres, freq, rep)]
    want = np.asarray(ref_apply(jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(seen), *map(jnp.asarray, vec)))
    got = apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts), torch.from_numpy(seen),
                          *map(torch.from_numpy, vec)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if (pres, freq, rep) == (0.0, 0.0, 1.0):
        assert np.array_equal(got, logits)  # the neutral row is bit for bit its logits


def test_ban_eos_matches_the_reference_drop_scatter():
    """The per-slot EOS ban: rows padded with V (the reference's dropped
    out-of-range scatter), repeated ids, and a row allowed (penalty 0)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    B, V = 4, 50
    logits = rng.standard_normal((B, V)).astype(np.float32)
    ids = np.full((B, MAX_EOS_IDS), V, np.int32)
    ids[0, :2] = (3, 49)
    ids[1, :3] = (0, 0, 7)  # a repeated id adds twice, as the reference's scatter-add does
    ids[2, :1] = 12
    pen = np.array([-1e30, -1e30, 0.0, -1e30], np.float32)
    rows = jnp.arange(B)[:, None]
    want = np.asarray(jnp.asarray(logits).at[rows, jnp.asarray(ids)].add(jnp.asarray(pen)[:, None], mode="drop"))
    got = ban_eos(torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(pen)).numpy()
    assert np.array_equal(got, want)
    assert got[0, 3] < -1e29 and got[0, 49] < -1e29 and got[2, 12] == logits[2, 12] and np.array_equal(got[3], logits[3])


def test_sample_tokens_with_logprobs_matches_reference():
    import jax
    import jax.numpy as jnp

    from dynamo_tpu.engine.sampling import sample_tokens_with_logprobs as ref_sample

    rng = np.random.default_rng(6)
    B, V = 6, 257
    raw = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    masked = raw.copy()
    masked[:, :40] -= 5.0  # what the sampler sees differs from the raw distribution
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    want = ref_sample(jnp.asarray(masked), jax.random.key(0), jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
                      jnp.asarray(ones), raw_logits=jnp.asarray(raw))
    got = sample_tokens_with_logprobs(torch.from_numpy(masked), torch.from_numpy(zeros),
                                      torch.zeros(B, dtype=torch.int32), torch.from_numpy(ones),
                                      raw_logits=torch.from_numpy(raw))
    w, g = [np.asarray(x) for x in want], [x.numpy() for x in got]
    assert np.array_equal(g[0], w[0]) and np.array_equal(g[2], w[2]) and g[2].shape == (B, LOGPROBS_K)
    np.testing.assert_allclose(g[1], w[1], atol=LP_ATOL, rtol=0)
    np.testing.assert_allclose(g[3], w[3], atol=LP_ATOL, rtol=0)
    assert np.all(g[3][:, :-1] >= g[3][:, 1:]) and np.all(g[3] <= 0)


# ---------------------------------------------------------------- engines


async def collect(engine, req):
    outs = []
    async for out in engine.generate(req):
        if out.token is not None:
            outs.append(out)
        last = out
    return ([o.token for o in outs], last.finish_reason,
            [o.logprob for o in outs], [o.top_logprobs for o in outs])


def feature_requests(make_req, make_params, eos):
    """(name, request) of the feature mix: penalties, min_tokens past an
    EOS at the greedy stream's second token, logprobs, and all three."""
    return [
        make_req("pen", PROMPTS[0], make_params(max_tokens=12, **PENALTIES)),
        make_req("min", PROMPTS[1], make_params(max_tokens=12, min_tokens=6), eos_token_ids=(eos[1],)),
        make_req("lp", PROMPTS[2], make_params(max_tokens=10), logprobs=5),
        make_req("all", PROMPTS[3], make_params(max_tokens=12, min_tokens=4, **PENALTIES),
                 eos_token_ids=(eos[3], 1000), logprobs=3),
    ]


@pytest.fixture(scope="module")
def reference():
    """{(decode_steps, prefill_lanes): the JAX engine's outputs of the
    feature requests}, the plain greedy streams (whose tokens pick the EOS
    ids) and the params."""
    import jax

    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import AsyncJaxEngine
    from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
    from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest

    async def run(**over):
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, **dict(ENGINE, **over)))
        await engine.start()
        try:
            plain = await asyncio.gather(*(collect(engine, JaxEngineRequest(f"p{i}", p, JaxSamplingParams(
                max_tokens=12))) for i, p in enumerate(PROMPTS)))
            eos = [toks[1] for toks, *_ in plain]
            outs = await asyncio.gather(*(collect(engine, r) for r in feature_requests(
                JaxEngineRequest, JaxSamplingParams, eos)))
            params = jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
        finally:
            await engine.shutdown()
        return plain, outs, params

    results = {key: run_sync(run(decode_steps=key[0], prefill_lanes=key[1])) for key in ((8, 4), (1, 1))}
    plain, _, params = results[(8, 4)]
    return {key: r[1] for key, r in results.items()}, plain, params


def run_sync(coro):
    return asyncio.run(coro)


def port_model(params):
    from dynamo_tpu_torch.models.convert import params_from_jax
    from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel

    model = LlamaModel(LlamaConfig.tiny())
    model.load_state_dict(params_from_jax(params, model.config))
    return model


def run_port(requests, model=None, **over):
    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", model_id="tiny", **dict(ENGINE, **over)), model=model)
        await engine.start()
        try:
            await engine.wait_warmup()
            before = engine.runner.compile_monitor.compiles
            outs = await asyncio.wait_for(asyncio.gather(*(collect(engine, r) for r in requests)), 120)
            return outs, engine, before
        finally:
            await engine.shutdown()

    return run_sync(run())


def assert_outputs_match(got, want):
    for (toks, reason, lps, tops), (rtoks, rreason, rlps, rtops) in zip(got, want):
        assert (toks, reason) == (rtoks, rreason)
        if rlps[0] is None:
            assert all(x is None for x in lps) and all(t is None for t in tops)
            continue
        np.testing.assert_allclose(lps, rlps, atol=LP_ATOL, rtol=0)
        for t, r in zip(tops, rtops):
            assert [i for i, _ in t] == [i for i, _ in r]
            np.testing.assert_allclose([v for _, v in t], [v for _, v in r], atol=LP_ATOL, rtol=0)


@pytest.mark.parametrize("decode_steps,prefill_lanes", [(8, 4), (1, 1)], ids=["window8-packed", "window1-lanes1"])
def test_feature_requests_equal_the_jax_engine(reference, decode_steps, prefill_lanes):
    outs_by_key, plain, params = reference
    want = outs_by_key[(decode_steps, prefill_lanes)]
    eos = [toks[1] for toks, *_ in plain]
    got, engine, _ = run_port(feature_requests(EngineRequest, SamplingParams, eos), model=port_model(params),
                              decode_steps=decode_steps, prefill_lanes=prefill_lanes)
    assert engine.runner.packed_prefill_mode == (prefill_lanes > 1)
    assert_outputs_match(got, want)
    pen, mn, lp, al = got
    # the penalties changed the greedy stream; min_tokens held the EOS the
    # plain stream emits second until past 6 tokens
    assert pen[0] != plain[0][0][:12]
    assert eos[1] not in mn[0][:6] and (mn[1] == "length" or len(mn[0]) > 6)
    assert len(lp[2]) == 10 and all(len(t) == 5 and t[0][0] == tok for t, tok in zip(lp[3], lp[0]))
    assert all(c == t[0][1] for c, t in zip(lp[2], lp[3]))  # greedy: the chosen logprob is the top one
    assert all(len(t) == 3 for t in al[3]) and eos[3] not in al[0][:4]


def test_seeded_requests_with_features_reproduce(reference):
    """A sampled, seeded request with penalties and logprobs gives the same
    tokens alone and beside other traffic, and its logprobs within
    LP_ATOL."""
    _, _, params = reference
    seeded = SamplingParams(max_tokens=12, temperature=0.9, seed=77, **PENALTIES)
    model = port_model(params)
    alone, _, _ = run_port([EngineRequest("s", PROMPTS[1], seeded, logprobs=2)], model=model)
    busy, _, _ = run_port([
        EngineRequest("o1", PROMPTS[2], SamplingParams(max_tokens=12, temperature=1.0), logprobs=1),
        EngineRequest("s", PROMPTS[1], seeded, logprobs=2),
        EngineRequest("o2", PROMPTS[0], SamplingParams(max_tokens=5, min_tokens=3), eos_token_ids=(1,)),
    ], model=model)
    assert alone[0][:2] == busy[1][:2] and len(alone[0][0]) == 12
    # a batch of another shape may round the logits' last bits otherwise
    assert_outputs_match([alone[0]], [busy[1]])


def graph_serve(monkeypatch, requests, **over):
    monkeypatch.setattr(model_runner, "ModelRunner", FakeGraphRunner)
    try:
        return run_port(requests, **over)
    finally:
        monkeypatch.undo()


def mixed_feature_requests():
    return [
        EngineRequest("a", PROMPTS[0], SamplingParams(max_tokens=9, **PENALTIES), logprobs=2),
        EngineRequest("b", PROMPTS[1], SamplingParams(max_tokens=9, min_tokens=4), eos_token_ids=(7, 8)),
        EngineRequest("c", PROMPTS[2], SamplingParams(max_tokens=9, temperature=0.8, seed=5, **PENALTIES),
                      logprobs=4),
        EngineRequest("d", PROMPTS[3], SamplingParams(max_tokens=9)),
    ]


@pytest.mark.parametrize("prefill_lanes", [4, 1], ids=["packed", "per-request"])
def test_graph_path_gives_the_eager_feature_outputs(monkeypatch, prefill_lanes):
    """The feature mix through the graph path (test_torch_compiled's fake
    backend) equals the eager engine, logprobs bit for bit; with warmup
    nothing is captured while serving."""
    over = dict(prefill_lanes=prefill_lanes, decode_steps=2)
    eager, _, _ = run_port(mixed_feature_requests(), **over)
    graphed, engine, before = graph_serve(monkeypatch, mixed_feature_requests(), warmup=True, **over)
    assert graphed == eager
    assert engine.runner.compile_monitor.compiles == before == len(engine.runner.graphs)
    keys = engine.runner.graphs.entries
    window_flags = {key[-2:] for key in keys if key[0] == "decode_window"}
    assert {(False, True), (True, False), (True, True)} <= window_flags


def test_warmup_captures_the_feature_variants_on_the_trash_page():
    """warmup() captures windows with penalties, logprobs and both, and
    prefill calls with logprobs, extras and both at every bucket and lane
    count; the KV pools change only on the trash page, the slot tokens and
    the slots' penalty rows not at all (the drop row takes the dropped
    lanes' updates)."""
    from dynamo_tpu_torch.models.registry import load_model

    cfg = EngineConfig(device="cpu", **ENGINE)
    model = load_model("tiny", device="cpu")
    runner = FakeGraphRunner(cfg, model)
    runner.write_token_slots(np.arange(4), np.array([11, 22, 33, 44]))
    runner.warmup()
    P, B = cfg.num_pages, cfg.max_seqs
    for name in ("k", "v"):
        pool = runner.kv_cache[name].reshape(model.config.num_layers, P, -1)
        assert pool[:, 0].abs().sum() > 0 and not pool[:, 1:].any()
    assert runner.slot_state["tokens"][:B].tolist() == [11, 22, 33, 44]
    assert not runner.slot_state["counts"][:B].any() and not runner.slot_state["seen"][:B].any()
    keys = set(runner.graphs.entries)
    windows = {k[4:6] + k[-2:] for k in keys if k[0] == "decode_window"}  # (sampled, filter, lp, extras)
    assert {(False, False, False, True), (False, False, True, False), (False, False, True, True),
            (True, False, True, True)} <= windows
    for b in cfg.prefill_buckets:
        for n in runner._lane_counts(b):
            flags = {k[4:] for k in keys if k[0] == "prefill_packed" and k[1] == n and k[2] == b}
            assert {(False, False, True, False), (False, False, False, True), (False, False, True, True),
                    (True, False, True, True)} <= flags, (b, n, flags)
    assert runner.compile_monitor.compiles == len(keys)


@pytest.mark.parametrize("model_id", ["tiny", "tiny-mla"])
def test_graph_against_eager_feature_calls_on_the_cpu(model_id):
    """``tools/checks.py graph_against_eager`` behind the fake backend: the
    feature prefill and windows replay (no capture) and equal the eager
    run's tokens, logprobs, KV pools and penalty state bit for bit; the
    penalties moved the counts."""
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.checks import graph_against_eager, same_run

    cfg = EngineConfig(device="cpu", model_id=model_id, **ENGINE)
    runner = FakeGraphRunner(cfg, load_model(model_id, device="cpu"))
    prompts = [list(range(3, 16)), list(range(40, 47)), [9] * 30]
    got = graph_against_eager(runner, prompts)
    g, e = got["graph"], got["eager"]
    assert got["captures"] == 0 and same_run(g, e) == []
    counts, seen = g["penalty"]
    assert counts.sum().item() == 3 * (1 + cfg.decode_steps)  # the extras prefill's token + the extras window's
    assert all(seen[i, p].all() for i, p in enumerate(prompts))
    toks, chosen, ids, vals = g["window_lp"]
    assert toks.shape == chosen.shape == (cfg.decode_steps, 3) and ids.shape == (cfg.decode_steps, 3, LOGPROBS_K)
    assert np.array_equal(ids[..., 0], toks) and np.array_equal(vals[..., 0], chosen)
    first_both = g["first_both"][0]
    assert all(first_both[i] != p[0] for i, p in enumerate(prompts))  # min_tokens 2 banned each EOS id


# ---------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def servers():
    from test_torch_http import Servers

    s = Servers()
    yield s
    s.close()


def post_both(servers, path, body):
    from test_torch_http import call

    ref, port = servers.pairs["engine"]
    return [call(s.port, "POST", path, body) for s in (ref, port)]


def assert_close_json(got, want, path="$"):
    """Equal JSON, floats within LP_ATOL (logprobs), ids and timestamps
    aside at the top level, and completions' ``text_offset`` aside: it
    repeats each streamed chunk's offset for the chunk's tokens, and where a
    window ends is each engine's timing (test_torch_http's note on stream
    boundaries)."""
    if isinstance(want, dict):
        skip = ("id", "created") if path == "$" else ("text_offset",)
        assert set(got) == set(want), path
        for k in want:
            if k not in skip:
                assert_close_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_close_json(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=LP_ATOL), path
    else:
        assert got == want, path


def test_http_completions_logprobs(servers):
    body = {"model": "tiny", "prompt": "hi", "max_tokens": 3, "temperature": 0.0, "logprobs": 2,
            "ext": {"ignore_eos": True}}
    (rs, _, rbody), (gs, _, gbody) = post_both(servers, "/v1/completions", body)
    assert rs == gs == 200
    want, got = json.loads(rbody), json.loads(gbody)
    assert_close_json(got, want)
    lp = got["choices"][0]["logprobs"]
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 3
    assert all(isinstance(x, float) for x in lp["token_logprobs"])
    assert all(len(d) == 2 for d in lp["top_logprobs"]) and lp["text_offset"] == sorted(lp["text_offset"])


def test_http_chat_logprobs_stream_and_unary(servers):
    body = {"model": "tiny", "messages": [{"role": "user", "content": "hello"}], "max_tokens": 3,
            "temperature": 0.0, "logprobs": True, "top_logprobs": 2, "ext": {"ignore_eos": True}}
    (rs, _, rbody), (gs, _, gbody) = post_both(servers, "/v1/chat/completions", body)
    assert rs == gs == 200
    want, got = json.loads(rbody), json.loads(gbody)
    assert_close_json(got, want)
    lp = got["choices"][0]["logprobs"]
    assert len(lp["content"]) == 3 and {"token", "logprob", "bytes", "top_logprobs"} <= set(lp["content"][0])
    assert len(lp["content"][0]["top_logprobs"]) == 2
    (rs, _, rbody), (gs, _, gbody) = post_both(servers, "/v1/chat/completions", dict(body, stream=True))
    assert rs == gs == 200

    def lp_entries(raw):
        frames = [json.loads(line[6:]) for line in raw.decode().splitlines() if line.startswith("data: {")]
        return [e for f in frames if f["choices"] for e in (f["choices"][0].get("logprobs") or {}).get("content", [])]

    assert len(lp_entries(gbody)) == 3
    assert_close_json(lp_entries(gbody), lp_entries(rbody))


def test_http_chat_no_logprobs_field_absent(servers):
    body = {"model": "tiny", "messages": [{"role": "user", "content": "hello"}], "max_tokens": 2,
            "temperature": 0.0, "ext": {"ignore_eos": True}}
    (rs, _, rbody), (gs, _, gbody) = post_both(servers, "/v1/chat/completions", body)
    assert rs == gs == 200
    assert "logprobs" not in json.loads(gbody)["choices"][0] and "logprobs" not in json.loads(rbody)["choices"][0]


def test_http_penalties_and_cached_tokens(servers):
    """A repetition-penalty completion equals the reference's text; the
    same prompt again reports its cached tokens in the timing event on
    both services."""
    from test_torch_http import call

    prompt = "The quick brown fox jumps over the lazy dog, then the dog"
    body = {"model": "tiny", "prompt": prompt, "max_tokens": 6, "temperature": 0.0, "repetition_penalty": 1.5,
            "ext": {"ignore_eos": True}}
    (rs, _, rbody), (gs, _, gbody) = post_both(servers, "/v1/completions", body)
    assert rs == gs == 200 and json.loads(gbody)["choices"] == json.loads(rbody)["choices"]
    stream = dict(body, stream=True, ext={"ignore_eos": True, "annotations": ["timing"]})
    cached = []
    for s in servers.pairs["engine"]:
        status, _, raw = call(s.port, "POST", "/v1/completions", stream)
        assert status == 200
        timing = [json.loads(line[6:]) for line in raw.decode().splitlines() if line.startswith("data: {")
                  and "cached_tokens" in line]
        cached.append(timing[0]["cached_tokens"])
    assert cached[0] == cached[1] > 0
