"""Speculative decoding in the port against the JAX package, on the CPU at
f32 and tiny widths (2 layers):

  - ``parse_speculative`` / ``make_proposer`` / ``EngineConfig.speculative``
    give the reference's results and errors on the reference tests' strings;
  - ``NgramIndex`` / ``NgramProposer`` give the reference's proposals,
    statelessly and incrementally, on 200 seeded histories;
  - ``accept_speculative``: greedy slots exactly as the reference (with and
    without draft probabilities, with fewer drafts than k, beside sampled
    batch mates); sampled slots statistically (JAX's threefry bits are not
    torch's Philox bits): chi-square at V = 8 for one-hot and real q, top-k,
    the residual's renormalization, q == p always accepting;
  - ``LlamaModel.verify`` / ``DeepseekModel.verify`` against the reference's
    on a prefilled context with invalid rows: logits of the valid rows
    within the models' f32 tolerance, pools equal off the trash pages;
  - ``AsyncTorchEngine`` with ``ngram:4``, a self-draft and a different
    draft against ``AsyncJaxEngine`` on the same weights (the port's draft
    model takes the reference's draft weights): greedy tokens, finish
    reasons and the proposed / accepted / emitted counts equal, for Llama
    and tiny-mla, over repetitive and arbitrary prompts, EOS mid-chunk,
    exact max_tokens, concurrent requests and penalty / logprobs /
    min_tokens requests, which ride windows; seeded sampled requests
    reproduce across batch mates;
  - through ``test_torch_compiled.FakeGraphRunner`` the verify and draft
    steps give the eager tokens, the warmup captures every speculative shape
    the serve reaches and writes only the trash pages;
  - ``run --speculative ngram:4`` serves; a bad spec raises the reference's
    error.

K2 and K5 at the verify pass's shapes are held to their plain versions on
the card in tests/test_torch_kernels_cuda.py (``-k verify``)."""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.sampling import accept_speculative as j_accept
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu.models.deepseek import DeepseekConfig as JaxDeepseekConfig
from dynamo_tpu.models.deepseek import DeepseekModel as JaxDeepseekModel
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.spec import make_proposer as j_make_proposer
from dynamo_tpu.spec import parse_speculative as j_parse
from dynamo_tpu.spec.proposer import NgramIndex as JNgramIndex
from dynamo_tpu.spec.proposer import NgramProposer as JNgramProposer
from dynamo_tpu_torch.engine import model_runner
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SPEC_STREAM, SamplingParams, accept_speculative, seeded_uniform
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.models import registry
from dynamo_tpu_torch.models.convert import ckv_from_jax, deepseek_params_from_jax, kv_from_jax, params_from_jax
from dynamo_tpu_torch.models.deepseek import DeepseekConfig, DeepseekModel
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.spec import NgramIndex, NgramProposer, SpecConfig, make_proposer, parse_speculative
from dynamo_tpu_torch.spec.draft import DRAFT_STREAM

torch.set_num_threads(2)

ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
ATOL_LLAMA, ATOL_MLA = 1e-4, 2e-4  # the models' parity tests' f32 limits (tests/test_torch_llama.py, _mla.py)
JS = '{"num_layers": 2, "hidden_size": 64}'


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _outcome(fn, *args):
    """(fields, None) of a result or (None, (error type, message))."""
    try:
        got = fn(*args)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return None, (type(e).__name__, str(e))
    if dataclasses.is_dataclass(got):
        return dataclasses.asdict(got), None
    return (None if got is None else type(got).__name__), None


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("spec", [
    None, "", "off", "none", " ngram:3 ", "ngram", "ngram:4", "ngram:2", "ngram:0", "ngram:99", "ngram:x",
    "draft:4", "draft:tiny:3", "draft:tiny", f"draft:tiny:{JS}:2", f"draft:tiny:{JS}", "draft:/ckpt/dir:8",
    "draft", "draft:tiny:0", "bogus:1", "eagle",
])
def test_parse_speculative_as_the_reference(spec):
    assert _outcome(parse_speculative, spec) == _outcome(j_parse, spec)


@pytest.mark.parametrize("kind,model", [("ngram", None), ("draft", "tiny"), ("eagle", None)])
def test_make_proposer_as_the_reference(kind, model):
    got = _outcome(make_proposer, SpecConfig(kind=kind, model=model))
    import dynamo_tpu.spec as jspec

    assert got == _outcome(j_make_proposer, jspec.SpecConfig(kind=kind, model=model))
    assert isinstance(make_proposer(SpecConfig()), NgramProposer)


@pytest.mark.parametrize("spec", ["ngram:3", None, "bogus:1", "ngram:0"])
def test_engine_config_validates_speculative_as_the_reference(spec):
    def port(s):
        return EngineConfig(device="cpu", speculative=s).spec

    def ref(s):
        return JaxEngineConfig(speculative=s).spec

    assert _outcome(port, spec) == _outcome(ref, spec)


# ---------------------------------------------------------------- n-gram proposer


def _histories(n=200):
    rng = np.random.default_rng(42)
    for i in range(n):
        length = int(rng.integers(0, 80))
        vocab = int(rng.integers(2, 9))
        hist = rng.integers(0, vocab, length).tolist()
        max_n = int(rng.integers(1, 5))
        yield i, hist, max_n, int(rng.integers(1, max_n + 1)), int(rng.integers(1, 7))


def test_ngram_proposals_equal_the_reference_on_200_histories():
    """Stateless proposals at the whole history, and an incremental index
    seeded with the first third and extended a token at a time, proposing
    at every prefix: the reference's proposals each time, with its work
    counter."""
    for i, hist, max_n, min_n, k in _histories():
        assert NgramProposer(max_n, min_n).propose(hist, k) == JNgramProposer(max_n, min_n).propose(hist, k), i
        cut = len(hist) // 3
        idx, jidx = NgramIndex(hist[:cut], max_n, min_n), JNgramIndex(hist[:cut], max_n, min_n)
        for t in hist[cut:]:
            idx.append(t)
            jidx.append(t)
            assert idx.propose(k) == jidx.propose(k), i
        assert idx.work == jidx.work and len(idx) == len(hist)


def test_ngram_index_rejects_bad_bounds_as_the_reference():
    for lo, hi in ((0, 3), (3, 2)):
        assert _outcome(NgramIndex, [1, 2], hi, lo) == _outcome(JNgramIndex, [1, 2], hi, lo)
        assert _outcome(NgramProposer, hi, lo) == _outcome(JNgramProposer, hi, lo)


# ---------------------------------------------------------------- acceptance


def _ref_accept(logits, drafts, n_drafts, temps, draft_probs=None, top_k=None):
    B = logits.shape[0]
    out, n = jax.jit(j_accept)(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32), jnp.asarray(n_drafts, jnp.int32), jax.random.key(0),
        jnp.asarray(temps, jnp.float32), jnp.asarray(np.zeros(B) if top_k is None else top_k, jnp.int32),
        jnp.ones(B, jnp.float32), min_p=jnp.zeros(B, jnp.float32), seeds=jnp.zeros(B, jnp.int32),
        positions=jnp.zeros(B, jnp.int32),
        draft_probs=None if draft_probs is None else jnp.asarray(draft_probs, jnp.float32),
    )
    return np.asarray(out), np.asarray(n)


def _accept(logits, drafts, n_drafts, temps, draft_probs=None, top_k=None, seed=0, need_filter=None):
    B, K1, V = logits.shape
    temps = np.asarray(temps, np.float32)
    top_k = np.zeros(B, np.int32) if top_k is None else np.asarray(top_k, np.int32)
    gen = torch.Generator().manual_seed(seed)
    uniform = torch.rand((B, K1 - 1 + V), generator=gen) if (temps > 0).any() else None
    out, n = accept_speculative(
        _t(logits.astype(np.float32)), _t(np.asarray(drafts, np.int32)), _t(np.asarray(n_drafts, np.int32)),
        _t(temps), _t(top_k), torch.ones(B), min_p=torch.zeros(B),
        draft_probs=None if draft_probs is None else _t(np.asarray(draft_probs, np.float32)), uniform=uniform,
        need_filter=bool((top_k > 0).any()) if need_filter is None else need_filter,
    )
    return out.numpy(), n.numpy()


def _greedy_case(rng, B=8, K=4, V=32):
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    argmax = logits.argmax(-1)
    drafts = rng.integers(0, V, (B, K)).astype(np.int32)
    for b in range(B):  # the first b % (K + 1) drafts equal the argmax chain
        drafts[b, : b % (K + 1)] = argmax[b, : b % (K + 1)]
    n_drafts = np.array([K, K, K, K, 2, 3, 0, 1][:B], np.int32)
    return logits, drafts, n_drafts


@pytest.mark.parametrize("with_q", [False, True], ids=["one-hot", "draft-probs"])
def test_accept_greedy_equals_the_reference(with_q):
    """Greedy slots: the same tokens (all K+1 rows) and n_emit as the
    reference, with n_drafts < k in some slots; and again beside sampled
    batch mates (odd slots sample; the greedy slots are unchanged)."""
    rng = np.random.default_rng(1 + with_q)
    logits, drafts, n_drafts = _greedy_case(rng)
    B, K, V = drafts.shape + logits.shape[-1:]
    q = rng.random((B, K, V)).astype(np.float32) if with_q else None
    if q is not None:
        q /= q.sum(-1, keepdims=True)
    temps = np.zeros(B, np.float32)
    got, want = _accept(logits, drafts, n_drafts, temps, q), _ref_accept(logits, drafts, n_drafts, temps, q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].tolist() == [1, 2, 3, 4, 3, 1, 1, 2]
    temps[1::2] = 0.7
    mixed = _accept(logits, drafts, n_drafts, temps, q)
    np.testing.assert_array_equal(mixed[0][::2], want[0][::2])
    np.testing.assert_array_equal(mixed[1][::2], want[1][::2])
    assert all(1 <= n <= d + 1 for n, d in zip(mixed[1], n_drafts))


#: chi-square critical value at alpha = 0.001 for df = 7 (the reference's)
CHI2_CRIT_DF7_P001 = 24.322
ROW = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5, -2.0], np.float32)


def _chi2(tokens, p):
    counts = np.bincount(tokens, minlength=len(p))
    return float((((counts - len(tokens) * p) ** 2) / (len(tokens) * p)).sum())


@pytest.mark.parametrize("with_q", [False, True], ids=["one-hot", "draft-probs"])
def test_accept_sampled_marginal_is_the_target(with_q):
    """The emitted first token's marginal is the target distribution,
    whatever the proposal: one-hot drafts of token 1, or drafts sampled
    from a sharper, shifted q (both accept and residual branches taken)."""
    B = 4096
    p = np.exp(ROW) / np.exp(ROW).sum()
    logits = np.tile(ROW, (B, 2, 1))
    rng = np.random.default_rng(11)
    q = None
    if with_q:
        q_row = np.roll(np.exp(2.0 * ROW), 2)
        q_row /= q_row.sum()
        drafts = rng.choice(8, size=(B, 1), p=q_row).astype(np.int32)
        q = np.tile(q_row.astype(np.float32), (B, 1, 1))
    else:
        drafts = np.ones((B, 1), np.int32)
    out, n_emit = _accept(logits, drafts, np.ones(B, np.int32), np.ones(B), q, seed=5)
    assert _chi2(out[:, 0], p) < CHI2_CRIT_DF7_P001
    assert 0 < int((n_emit == 2).sum()) < B  # both branches taken


def test_accept_sampled_respects_top_k():
    B = 4000
    logits = np.tile(ROW, (B, 2, 1))
    drafts = np.full((B, 1), 5, np.int32)  # outside the top 2: p(d) = 0, always rejected
    out, n_emit = _accept(logits, drafts, np.ones(B, np.int32), np.ones(B), top_k=np.full(B, 2), seed=3)
    assert set(np.unique(out[:, 0])) <= {0, 1} and (n_emit == 1).all()
    target = np.exp(ROW[:2]) / np.exp(ROW[:2]).sum()
    np.testing.assert_allclose(np.bincount(out[:, 0], minlength=2) / B, target, atol=0.04)


def test_accept_residual_renormalizes():
    """q all on token 0 where p is [.5, .5, ~0...]: token-0 drafts are
    accepted half the time, and every rejection emits token 1 (the
    residual max(0, p - q) holds no token 0)."""
    B = 2048
    row = np.array([1.0, 1.0] + [-9.0] * 6, np.float32)
    q = np.zeros((B, 1, 8), np.float32)
    q[..., 0] = 1.0
    out, n_emit = _accept(np.tile(row, (B, 2, 1)), np.zeros((B, 1), np.int32), np.ones(B, np.int32), np.ones(B), q,
                          seed=9)
    rejected = n_emit == 1
    assert set(np.unique(out[rejected, 0]).tolist()) == {1}
    assert abs(float((~rejected).mean()) - 0.5) < 0.05


def test_accept_q_equal_to_p_always_accepts():
    B = 512
    row = np.linspace(1.5, -1.5, 8).astype(np.float32)
    p = np.exp(row) / np.exp(row).sum()
    drafts = np.random.default_rng(3).choice(8, size=(B, 1), p=p).astype(np.int32)
    _, n_emit = _accept(np.tile(row, (B, 2, 1)), drafts, np.ones(B, np.int32), np.ones(B),
                        np.tile(p.astype(np.float32), (B, 1, 1)))
    assert n_emit.tolist() == [2] * B


def test_spec_streams_differ_from_the_window_sampler():
    """A seeded slot's acceptance and draft draws are streams of their own
    (the reference's distinct key bases), each reproducible."""
    a = seeded_uniform(7, 30, 64, "cpu")
    b = seeded_uniform(7, 30, 64, "cpu", SPEC_STREAM)
    c = seeded_uniform(7, 30, 64, "cpu", DRAFT_STREAM)
    assert not torch.equal(a, b) and not torch.equal(b, c) and not torch.equal(a, c)
    assert torch.equal(b, seeded_uniform(7, 30, 64, "cpu", SPEC_STREAM))


# ---------------------------------------------------------------- model verify

PS, NUM_PAGES = 4, 16


def _verify_inputs(rng, vocab):
    """Three lanes of T = 5 rows at unit-stride positions over a prefilled
    context: lane 0 anchored at 9 with all rows valid, lane 1 anchored at 6
    with two valid rows (the rest invalid: trash page), lane 2 inactive
    (position 0, zero table)."""
    tokens = rng.integers(0, vocab, (3, 5)).astype(np.int32)
    anchors = np.array([9, 6, 0], np.int32)
    positions = (anchors[:, None] + np.arange(5)[None]).astype(np.int32)
    tables = np.zeros((3, 8), np.int32)
    tables[0, :4] = (3, 7, 1, 5)
    tables[1, :3] = (2, 9, 4)
    valid = np.zeros((3, 5), bool)
    valid[0] = True
    valid[1, :2] = True
    return tokens, positions, tables, valid


def _prefill_both(jm, params, tm, jkv, tkv, rng, vocab):
    """Prefill lane 0's first 9 and lane 1's first 6 tokens on both sides."""
    jprefill = jax.jit(jm.prefill)  # one compile for both chunks
    for n, table in ((9, (3, 7, 1, 5)), (6, (2, 9, 4))):
        toks = np.zeros(16, np.int32)
        toks[:n] = rng.integers(0, vocab, n)
        pos = np.arange(16, dtype=np.int32)
        tab = np.zeros(8, np.int32)
        tab[: len(table)] = table
        valid = np.arange(16) < n
        _, jkv = jprefill(params, jkv, *map(jnp.asarray, (toks, pos, tab, valid)), n - 1)
        tm.prefill(tkv, _t(toks), _t(pos), _t(tab), _t(valid), n - 1)
    return jkv


def test_llama_verify_equals_the_reference():
    jm = JaxLlamaModel(JaxLlamaConfig.tiny())
    params = jm.init_params(jax.random.key(0))
    cfg = LlamaConfig.tiny()
    tm = LlamaModel(cfg)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    rng = np.random.default_rng(0)
    jkv, tkv = jm.init_kv_cache(NUM_PAGES, PS), tm.init_kv_cache(NUM_PAGES, PS)
    jkv = _prefill_both(jm, params, tm, jkv, tkv, rng, cfg.vocab_size)
    args = _verify_inputs(rng, cfg.vocab_size)
    jlogits, jkv = jax.jit(jm.verify)(params, jkv, *map(jnp.asarray, args))
    tlogits, tkv = tm.verify(tkv, *map(_t, args))
    valid = args[3]
    assert tlogits.shape == (3, 5, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy()[valid], np.asarray(jlogits)[valid], atol=ATOL_LLAMA)
    keep = np.ones(cfg.num_layers * NUM_PAGES, bool)
    keep[::NUM_PAGES] = False  # per-layer trash pages, where the invalid rows land
    for name in ("k", "v"):
        want = kv_from_jax(np.asarray(jkv[name]), cfg).numpy()[keep]
        np.testing.assert_allclose(tkv[name].numpy()[keep], want, atol=ATOL_LLAMA)


def test_deepseek_verify_equals_the_reference():
    jm = JaxDeepseekModel(JaxDeepseekConfig.tiny_mla())
    params = jm.init_params(jax.random.key(1))
    cfg = DeepseekConfig.tiny_mla()
    tm = DeepseekModel(cfg)
    tm.load_state_dict(deepseek_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    rng = np.random.default_rng(1)
    jkv, tkv = jm.init_kv_cache(NUM_PAGES, PS), tm.init_kv_cache(NUM_PAGES, PS)
    jkv = _prefill_both(jm, params, tm, jkv, tkv, rng, cfg.vocab_size)
    args = _verify_inputs(rng, cfg.vocab_size)
    jlogits, jkv = jax.jit(jm.verify)(params, jkv, *map(jnp.asarray, args))
    tlogits, tkv = tm.verify(tkv, *map(_t, args))
    valid = args[3]
    np.testing.assert_allclose(tlogits.numpy()[valid], np.asarray(jlogits)[valid], atol=ATOL_MLA)
    keep = np.ones(cfg.num_layers * NUM_PAGES, bool)
    keep[::NUM_PAGES] = False
    want = ckv_from_jax(np.asarray(jkv["ckv"]), cfg).numpy()[keep]
    np.testing.assert_allclose(tkv["ckv"].numpy()[keep], want, atol=ATOL_MLA)


# ---------------------------------------------------------------- engines

REPETITIVE = [5, 9, 2, 7, 5, 9, 2, 7, 5, 9]
ARBITRARY = [200 - 3 * i for i in range(14)]
OTHER = list(range(40, 51))


async def collect(engine, req):
    toks, reason = [], None
    async for out in engine.generate(req):
        if out.token is not None:
            toks.append(out.token)
        reason = out.finish_reason
    return toks, reason


def _requests(eos: int | None, features: bool = True):
    """(id, prompt, sampling kwargs, request kwargs): greedy repetitive and
    arbitrary prompts, an exact max_tokens, EOS mid-stream (``eos``: a token
    the greedy repetitive stream emits) and, with ``features``, the
    requests that ride windows (penalties, logprobs, min_tokens)."""
    out = [("rep", REPETITIVE, dict(max_tokens=16), {}), ("arb", ARBITRARY, dict(max_tokens=16), {}),
           ("short", OTHER, dict(max_tokens=7), {})]
    if features:
        out += [("pen", OTHER, dict(max_tokens=8, repetition_penalty=1.3, presence_penalty=0.5), {}),
                ("lp", ARBITRARY, dict(max_tokens=8), dict(logprobs=3)),
                ("min", REPETITIVE, dict(max_tokens=8, min_tokens=4), dict(eos_token_ids=(0,)))]
    if eos is not None:
        out.append(("eos", REPETITIVE, dict(max_tokens=16), dict(eos_token_ids=(eos,))))
    return out


def _jax_run(model_id, speculative, requests):
    """(outputs by id, (proposed, accepted, emitted), numpy params of the
    target and of the draft or None)."""

    async def run():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id=model_id, tp=1, speculative=speculative, **ENGINE))
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                collect(engine, JaxEngineRequest(rid, list(p), JaxSamplingParams(**s), **kw))
                for rid, p, s, kw in requests
            ))
            st = engine.scheduler.stage
            params = jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
            draft = engine.runner.draft
            dparams = None if draft is None else jax.tree.map(np.asarray, jax.device_get(draft.params))
        finally:
            await engine.shutdown()
        return (dict(zip([r[0] for r in requests], outs)), (st.spec_proposed, st.spec_accepted, st.spec_emitted),
                params, dparams)

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


def _port_run(model, speculative, requests, monkeypatch=None, draft_model=None, runner_cls=None, **over):
    """(outputs by id, (proposed, accepted, emitted), engine); the draft
    model id loads ``draft_model`` and the runner class is ``runner_cls``
    when given."""
    if draft_model is not None:
        monkeypatch.setattr(registry, "load_model", lambda *a, **k: draft_model)
    if runner_cls is not None:
        monkeypatch.setattr(model_runner, "ModelRunner", runner_cls)

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", speculative=speculative, **dict(ENGINE, **over)),
                                  model=model)
        await engine.start()
        try:
            await engine.wait_warmup()
            outs = await asyncio.wait_for(asyncio.gather(*(
                collect(engine, EngineRequest(rid, list(p), SamplingParams(**s), **kw))
                for rid, p, s, kw in requests
            )), 120)
            st = engine.scheduler.stage
        finally:
            await engine.shutdown()
        return dict(zip([r[0] for r in requests], outs)), (st.spec_proposed, st.spec_accepted, st.spec_emitted), engine

    try:
        return asyncio.run(run())
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()


@pytest.fixture(scope="module")
def eos_token():
    """A token the greedy repetitive stream of tiny's reference weights
    emits mid-stream (the port's plain engine on the reference registry's
    weights)."""
    from dynamo_tpu.models.registry import load_model as j_load_model

    params = jax.tree.map(np.asarray, j_load_model("tiny")[1])
    outs, _, _ = _port_run(_port_model("tiny", params), None, _requests(None, False)[:1])
    return outs["rep"][0][5]


SPEC_CASES = {  # (model, speculative, with the feature requests)
    "llama-ngram": ("tiny", "ngram:4", True),
    "llama-self-draft": ("tiny", "draft:tiny:3", False),
    "llama-other-draft": ("tiny", 'draft:tiny:{"num_layers": 1, "intermediate_size": 64}:4', False),
    "mla-ngram": ("tiny-mla", "ngram:4", False),
    "mla-self-draft": ("tiny-mla", "draft:tiny-mla:3", False),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_engine_equals_the_jax_engine(monkeypatch, eos_token, case):
    """Every request's tokens and finish reason equal the reference spec
    engine's, and so do the proposed / accepted / emitted counts (n-gram
    proposals and greedy acceptance depend on the token histories alone;
    the port's draft model takes the reference's draft weights). A self
    draft accepts every proposal."""
    model_id, spec, features = SPEC_CASES[case]
    requests = _requests(eos_token if model_id == "tiny" else None, features)
    want, want_counts, params, dparams = _jax_run(model_id, spec, requests)
    draft = None
    if dparams is not None:
        draft = _port_model(parse_speculative(spec).model, dparams)
    got, counts, engine = _port_run(_port_model(model_id, params), spec, requests, monkeypatch, draft)
    assert got == want
    assert counts == want_counts and counts[0] > 0
    if "self-draft" in case:
        assert counts[0] == counts[1]
    if model_id == "tiny":
        assert want["eos"][1] == "stop" and len(want["eos"][0]) < 16
    assert want["short"][1] == "length" and len(want["short"][0]) == 7
    assert engine.scheduler.anatomy.dispatch_counts.get("spec_verify", 0) > 0


def test_spec_engine_gives_the_plain_engine_tokens():
    """The port's spec engines (n-gram, self-draft) against the port's own
    non-speculative engine on the registry's weights."""
    requests = _requests(None)
    model = registry.load_model("tiny", device="cpu")
    base, _, _ = _port_run(model, None, requests)
    for spec in ("ngram:4", "draft:tiny:2"):
        got, counts, _ = _port_run(registry.load_model("tiny", device="cpu"), spec, requests)
        assert got == base and counts[2] > 0


def test_seeded_sampled_requests_reproduce_across_batch_mates():
    """A seeded sampled request gives the same tokens alone and beside other
    requests (other slots, other rounds), n-gram and draft-model, filtered
    and not."""
    for spec in ("ngram:4", "draft:tiny:3"):
        for sampling in (dict(temperature=0.8, seed=11, max_tokens=12),
                         dict(temperature=0.9, top_k=20, top_p=0.9, seed=5, max_tokens=12)):
            req = [("s", REPETITIVE, sampling, {})]
            mates = [("a", ARBITRARY, dict(max_tokens=10), {}), ("b", OTHER, dict(temperature=1.0, max_tokens=9), {})]
            alone, _, _ = _port_run(registry.load_model("tiny", device="cpu"), spec, req)
            crowded, _, _ = _port_run(registry.load_model("tiny", device="cpu"), spec, mates + req)
            assert alone["s"] == crowded["s"] and len(alone["s"][0]) == 12


# ---------------------------------------------------------------- graphs, warmup


def test_graph_path_gives_the_eager_spec_tokens(monkeypatch):
    """Verify and draft steps through the graph cache (FakeGraphRunner) give
    the eager engine's tokens, sampled and seeded requests included, with
    each shape captured once; with warmup nothing is captured while
    serving."""
    from test_torch_compiled import FakeGraphRunner

    requests = [("g", REPETITIVE, dict(max_tokens=12), {}), ("u", ARBITRARY, dict(temperature=0.9, max_tokens=12), {}),
                ("s", OTHER, dict(temperature=0.8, top_k=6, seed=3, max_tokens=12), {})]
    for spec in ("ngram:4", "draft:tiny:3"):
        eager, _, _ = _port_run(registry.load_model("tiny", device="cpu"), spec, requests)
        graphed, _, engine = _port_run(registry.load_model("tiny", device="cpu"), spec, requests, monkeypatch,
                                       runner_cls=FakeGraphRunner)
        assert graphed == eager
        labels = {key[0] for key in engine.runner.graphs.entries}
        assert "verify" in labels and ("draft_step" in labels) == spec.startswith("draft")
        warmed, _, engine = _port_run(registry.load_model("tiny", device="cpu"), spec, requests, monkeypatch,
                                      runner_cls=FakeGraphRunner, warmup=True)
        assert warmed == eager
        monitor = engine.runner.compile_monitor
        assert monitor.compiles == len(engine.runner.graphs)
        captured = set(engine.runner.graphs.entries)
        assert {k for k in captured if k[0] in ("verify", "draft_step", "draft_prefill")}


def test_spec_warmup_writes_only_the_trash_pages():
    """The warmup's verify, draft step and draft prefill calls write only
    each layer's trash page, in the target pool and in the draft pool."""
    from test_torch_compiled import FakeGraphRunner

    cfg = EngineConfig(device="cpu", speculative="draft:tiny:3", **ENGINE)
    runner = FakeGraphRunner(cfg, registry.load_model("tiny", device="cpu"))
    runner.warmup()
    keys = set(runner.compile_monitor.snapshot()["per_label"])
    assert {"verify", "draft_step", "draft_prefill"} <= keys
    for pools, L in ((runner.kv_cache, 2), (runner.draft.kv, 2)):
        for name in ("k", "v"):
            pool = pools[name].reshape(L, cfg.num_pages, -1)
            assert pool[:, 0].abs().sum() > 0
            assert not pool[:, 1:].any()


# ---------------------------------------------------------------- run


def test_run_serves_with_speculative(tmp_path):
    """`run --speculative ngram:4` (and the tiny JSON's "speculative" key)
    reach the engine and serve; a bad spec raises the reference's error."""
    from dynamo_tpu.launch._run_impl import engine_config_for as j_engine_config_for
    from dynamo_tpu_torch.launch import run
    from dynamo_tpu_torch.launch._run_impl import engine_config_for

    args = run.build_parser().parse_args(["run", "tiny", "--out", "torch", "--device", "cpu",
                                          "--speculative", "ngram:4"])
    assert engine_config_for(args).spec.k == 4
    args = run.build_parser().parse_args(["run", 'tiny:{"num_layers": 2, "speculative": "ngram:3"}', "--out",
                                          "torch", "--device", "cpu"])
    cfg = engine_config_for(args)
    assert (cfg.spec.k, cfg.model_id) == (3, 'tiny:{"num_layers": 2}')
    assert cfg.model_id == j_engine_config_for(args).model_id
    bad = run.build_parser().parse_args(["run", "tiny", "--out", "torch", "--device", "cpu", "--speculative",
                                         "bogus"])
    assert _outcome(engine_config_for, bad) == _outcome(j_engine_config_for, bad)
    src = tmp_path / "p.jsonl"
    src.write_text(json.dumps({"text": "abab", "max_tokens": 6}) + "\n")
    assert run.main(["run", "tiny", "--in", f"batch:{src}", "--out", "torch", "--device", "cpu",
                     "--speculative", "ngram:4"]) == 0
    out = [json.loads(line) for line in (tmp_path / "p.out.jsonl").read_text().splitlines()]
    assert len(out) == 1 and 1 <= out[0]["tokens_out"] <= 6
