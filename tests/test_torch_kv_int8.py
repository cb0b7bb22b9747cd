"""The port's int8 KV cache (``dynamo_tpu_torch/quant/kv.py`` and the int8
paths of ``ops/attention.py``, ``models/llama.py`` and the engine) against
the JAX package on the same numpy-seeded inputs.

Quantization is compared exactly: both sides divide in IEEE f32 and round
half to even, so codes and scales are bit-equal. Attention over the same
int8 pools is held to 1e-5 in f32 (the same algebra in another order: the
plain versions dequantize the gathered rows, the Pallas kernels scale score
and probability columns). The Pallas kernels run in interpret mode through
their per-program twins, as in tests/test_torch_ops.py. Model logits through
two layers are held to 1e-4, greedy engine tokens exactly."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.ops import attention as jref
from dynamo_tpu.ops.pallas.paged_attention import paged_decode_attention_pallas
from dynamo_tpu.ops.pallas.prefill_attention import paged_prefill_attention_pallas
from dynamo_tpu.quant import kv as jkv
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.models.convert import kv_from_jax, params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.models.registry import load_model
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.quant import kv as tkv

torch.set_num_threads(2)

ATOL = 1e-5
LOGIT_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def rows(rng, shape, lo=0.01, hi=10.0):
    """K/V-like rows with per-row magnitudes spread over [lo, hi] (three
    decades by default) and one all-zero (padding) row."""
    x = rng.standard_normal(shape) * rng.uniform(lo, hi, (shape[0],) + (1,) * (len(shape) - 1))
    x[0] = 0.0
    return x.astype(np.float32)


def quantized_pair(rng, P, ps, Hkv, D):
    """The same int8 pools on both sides: (JAX QuantizedPages pair, port
    QuantizedPages pair), codes drawn from the JAX quantizer; rows of unit
    magnitude, so the outputs are O(1) and 1e-5 is an f32-sized limit."""
    out_j, out_t = [], []
    for _ in range(2):
        q, s = jkv.quantize_kv_rows(jnp.asarray(rows(rng, (P * ps, Hkv, D), 0.5, 2.0)))
        q = np.asarray(q).reshape(P, ps, Hkv, D)
        s = np.asarray(s).reshape(P, ps)
        out_j.append(jkv.QuantizedPages(jnp.asarray(q), jnp.asarray(s)))
        out_t.append(tkv.QuantizedPages(_t(q.copy()), _t(s.copy())))
    return out_j, out_t


@pytest.mark.parametrize("shape", [(64, 4, 16), (64, 256), (33, 8, 128)], ids=["unfolded", "folded", "d128"])
def test_quantize_kv_rows_matches_reference_bit_for_bit(shape):
    x = rows(np.random.default_rng(len(shape) + shape[-1]), shape)
    jq, js = jkv.quantize_kv_rows(jnp.asarray(x))
    q, s = tkv.quantize_kv_rows(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert not q[0].any()  # the zero row quantizes to zeros
    np.testing.assert_array_equal(
        tkv.dequantize_rows(q, s).numpy(), np.asarray(jkv.dequantize_rows(jq, js))
    )
    np.testing.assert_array_equal(
        tkv.dequantize_rows(q, s, torch.bfloat16).float().numpy(),
        np.asarray(jkv.dequantize_rows(jq, js, jnp.bfloat16).astype(jnp.float32)),
    )


@pytest.mark.parametrize(
    "ps,Hkv,D,L,itemsize",
    [(16, 8, 128, 32, 2), (16, 4, 64, 22, 2), (4, 2, 16, 2, 4), (128, 1, 64, 1, 2)],
    ids=["llama3-8b", "tinyllama", "tiny-f32", "mqa"],
)
def test_page_bytes_and_budget_match_reference(ps, Hkv, D, L, itemsize):
    for dtype in (None, "bf16", "int8"):
        want = jkv.kv_page_bytes(ps, Hkv, D, L, dtype, itemsize)
        assert tkv.kv_page_bytes(ps, Hkv, D, L, dtype, itemsize) == want
        for budget in (0, 1 << 20, 3 << 30, 80 << 30):
            assert tkv.pages_for_hbm_budget(budget, ps, Hkv, D, L, dtype, itemsize) == \
                jkv.pages_for_hbm_budget(budget, ps, Hkv, D, L, dtype, itemsize)
    if ps == 16 and Hkv == 4:  # TinyLlama's cache: 11,440 B a token in int8, 22,528 in bf16
        assert tkv.kv_page_bytes(ps, Hkv, D, L, "int8") == 11440 * ps
        assert tkv.kv_page_bytes(ps, Hkv, D, L, None) == 22528 * ps


def test_scatter_kv_int8_matches_reference():
    rng = np.random.default_rng(4)
    LP, ps, Hkv, D, T = 12, 4, 2, 8, 7
    k_new, v_new = rows(rng, (T, Hkv, D)), rows(rng, (T, Hkv, D))
    phys = np.array([3, 3, 5, 7, 11, 1, 2], np.int32)
    offs = np.array([0, 1, 3, 2, 0, 1, 3], np.int32)
    jk, jv = jkv.init_quantized_pages((LP, ps, Hkv, D)), jkv.init_quantized_pages((LP, ps, Hkv, D))
    jk, jv = jref.scatter_kv(jk, jv, *map(jnp.asarray, (k_new, v_new, phys, offs)))
    tk, tv = tkv.init_quantized_pages((LP, ps, Hkv, D)), tkv.init_quantized_pages((LP, ps, Hkv, D))
    out_k, out_v = tatt.scatter_kv(tk, tv, _t(k_new), _t(v_new), _t(phys), _t(offs))
    assert out_k is tk and out_v is tv  # in place
    for got, want in ((tk, jk), (tv, jv)):
        assert got.shape == tuple(want.shape) and got.dtype == torch.int8 and got.ndim == 4
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    # the plain gather dequantizes exactly as the reference's
    pt = np.array([3, 5, 7], np.int32)
    np.testing.assert_array_equal(
        tatt.gather_pages(tk, _t(pt)).numpy(), np.asarray(jref.gather_pages(jk, jnp.asarray(pt)))
    )


def decode_case(rng, B=4, Hq=4, Hkv=2, D=128, P=24, ps=4, max_pages=6):
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    positions = np.array([0, 9, 14, max_pages * ps - 1][:B], np.int32)
    pt = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        used = positions[b] // ps + 1
        pt[b, :used] = rng.choice(np.arange(1, P), size=used, replace=False)
    return q, pt, positions


@pytest.mark.parametrize("Hq,Hkv,D", [(4, 2, 128), (8, 2, 64)], ids=["d128", "d64"])
def test_int8_decode_plain_matches_reference_and_pallas(Hq, Hkv, D):
    rng = np.random.default_rng(D)
    P, ps = 24, 4
    q, pt, pos = decode_case(rng, Hq=Hq, Hkv=Hkv, D=D, P=P, ps=ps)
    (jk, jv), (tk, tv) = quantized_pair(rng, P, ps, Hkv, D)
    got = tatt.paged_decode_attention(_t(q), tk, tv, _t(pt), _t(pos)).numpy()
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(jref.paged_decode_attention(*jargs)), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(paged_decode_attention_pallas(*jargs, interpret=True)),
                               atol=ATOL)
    dispatched = tatt.dispatch_paged_decode_attention(_t(q), tk, tv, _t(pt), _t(pos)).numpy()
    np.testing.assert_array_equal(dispatched, got)


@pytest.mark.parametrize("Hq,Hkv,D,start", [(4, 2, 128, 0), (8, 2, 64, 37)], ids=["d128", "d64-cached-prefix"])
def test_int8_prefill_plain_matches_reference_and_pallas(Hq, Hkv, D, start):
    rng = np.random.default_rng(D + start)
    T, P, ps, max_pages = 128, 20, 16, 12
    q = rng.standard_normal((T, Hq, D)).astype(np.float32)
    used = -(-(start + T) // ps)
    pt = np.zeros(max_pages, np.int32)
    pt[:used] = rng.choice(np.arange(1, P), size=used, replace=False)
    pos = (start + np.arange(T)).astype(np.int32)
    (jk, jv), (tk, tv) = quantized_pair(rng, P, ps, Hkv, D)
    got = tatt.paged_prefill_attention(_t(q), tk, tv, _t(pt), _t(pos)).numpy()
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(jref.paged_prefill_attention(*jargs)), atol=ATOL)
    pallas = paged_prefill_attention_pallas(*jargs, interpret=True, lookahead=False)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL)
    lanes = tatt.dispatch_paged_prefill_attention(_t(q), tk, tv, _t(pt)[None], _t(pos)[None]).numpy()
    np.testing.assert_array_equal(lanes, got)


# ---------------- model and engine ----------------

PS, NUM_PAGES = 4, 16
SEED_D64 = 1


def chunk_inputs(tokens, start, bucket, pages, table_width=8):
    n = len(tokens)
    toks = np.zeros(bucket, np.int32)
    toks[:n] = tokens
    table = np.zeros(table_width, np.int32)
    table[: len(pages)] = pages
    return toks, (start + np.arange(bucket)).astype(np.int32), table, np.arange(bucket) < n


@pytest.mark.parametrize("head_dim,seed", [(16, 16), (64, SEED_D64)], ids=["d16", "d64"])
def test_llama_int8_logits_match_reference(head_dim, seed):
    """Prefill two sequences, then 8 decode steps over a batch of 3 with an
    inactive slot, on int8 pools; logits at 1e-4, the pools' codes equal the
    reference's and their scales to f32 rounding.

    The two packages compute K and V in another summation order, so the
    rows differ in their last bits; a value within that distance of a
    rounding tie (k + 0.5 code steps) can round to the neighbouring code, and
    one code step moves these logits by ~1e-3. The prompts are seeded so
    that no such tie arises, which the exact code comparison shows."""
    over = dict(head_dim=head_dim, kv_cache_dtype="int8")
    jm = JaxLlamaModel(JaxLlamaConfig.tiny(**over))
    params = jm.init_params(jax.random.key(0))
    cfg = LlamaConfig.tiny(**over)
    assert cfg.kv_quantized and cfg.kv_folded
    tm = LlamaModel(cfg)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    jcache, tcache = jm.init_kv_cache(NUM_PAGES, PS), tm.init_kv_cache(NUM_PAGES, PS)
    assert isinstance(tcache["k"], tkv.QuantizedPages)
    assert tm.kv_page_bytes(PS) == jm.kv_page_bytes(PS)
    rng = np.random.default_rng(seed)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)
    seqs = [(rng.integers(0, 256, 6), (1, 2, 3, 4, 5, 6)), (rng.integers(0, 256, 3), (8, 9, 10, 11, 12))]
    first = []
    for prompt, pages in seqs:
        toks, pos, table, valid = chunk_inputs(prompt, 0, 8, pages)
        last = len(prompt) - 1
        jlogits, jcache = prefill(params, jcache, *map(jnp.asarray, (toks, pos, table, valid)), last)
        tlogits, tcache = tm.prefill(tcache, _t(toks), _t(pos), _t(table), _t(valid), last)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
        first.append(int(jnp.argmax(jlogits)))
    tables = np.zeros((3, 8), np.int32)
    tables[0, :6] = seqs[0][1]
    tables[2, :5] = seqs[1][1]
    tokens = np.array([first[0], 0, first[1]], np.int32)
    positions = np.array([6, 0, 3], np.int32)
    active = np.array([True, False, True])
    for _ in range(8):
        jlogits, jcache = decode(params, jcache, *map(jnp.asarray, (tokens, positions, tables, active)))
        tlogits, tcache = tm.decode(tcache, _t(tokens), _t(positions), _t(tables), _t(active))
        np.testing.assert_allclose(tlogits.numpy()[active], np.asarray(jlogits)[active], atol=LOGIT_ATOL)
        tokens = np.where(active, np.asarray(jnp.argmax(jlogits, axis=-1)), 0).astype(np.int32)
        positions = positions + active
    keep = np.ones(cfg.num_layers * NUM_PAGES, bool)
    keep[::NUM_PAGES] = False  # per-layer trash pages
    for name in ("k", "v"):
        want = kv_from_jax(jax.tree.map(np.asarray, jcache[name]), cfg)
        np.testing.assert_array_equal(tcache[name].q.numpy()[keep], want.q.numpy()[keep])
        np.testing.assert_allclose(tcache[name].s.numpy()[keep], want.s.numpy()[keep], rtol=1e-6)


ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
PROMPTS = [[5, 9, 2, 77, 31], list(range(40, 51)), [200 - i for i in range(20)]]


async def _collect(engine, req):
    toks = []
    async for out in engine.generate(req):
        if out.token is not None:
            toks.append(out.token)
    return toks


def test_engine_int8_greedy_tokens_equal_jax_engine():
    async def reference():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, kv_cache_dtype="int8", **ENGINE))
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                _collect(engine, JaxEngineRequest(f"j{i}", p, JaxSamplingParams(max_tokens=8)))
                for i, p in enumerate(PROMPTS)
            ))
            params = jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
        finally:
            await engine.shutdown()
        return outs, params

    ref_outs, params = asyncio.run(reference())
    cfg = LlamaConfig.tiny(kv_cache_dtype="int8")
    model = LlamaModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))

    async def port():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", kv_cache_dtype="int8", **ENGINE), model=model)
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                _collect(engine, EngineRequest(f"t{i}", p, SamplingParams(max_tokens=8)))
                for i, p in enumerate(PROMPTS)
            ))
            return outs, engine.runner.kv_cache["k"]
        finally:
            await engine.shutdown()

    outs, k_pool = asyncio.run(port())
    assert isinstance(k_pool, tkv.QuantizedPages)
    assert outs == ref_outs and all(len(t) == 8 for t in outs)


def test_kv_cache_dtype_is_validated_and_refused_by_mla():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        EngineConfig(device="cpu", kv_cache_dtype="fp8")
    assert EngineConfig(device="cpu", kv_cache_dtype="bf16").kv_cache_dtype == "bf16"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        load_model("tiny-mla", device="cpu", kv_cache_dtype="int8")
    with pytest.raises(ValueError):
        JaxEngineConfig(kv_cache_dtype="fp8")  # the reference refuses the same value
    model = load_model("tiny", device="cpu", kv_cache_dtype="int8")
    assert model.config.kv_quantized
    assert not load_model("tiny", device="cpu", kv_cache_dtype="bf16").config.kv_quantized

    async def mismatched():
        await AsyncTorchEngine(EngineConfig(device="cpu", **ENGINE), model=model).start()

    with pytest.raises(ValueError, match="kv_cache_dtype"):
        asyncio.run(mismatched())


@pytest.mark.parametrize("folded", [True, False], ids=["folded", "unfolded"])
def test_kv_from_jax_round_trips_quantized_pages(folded):
    rng = np.random.default_rng(9)
    P, ps, Hkv, D = 6, 4, 2, 16
    q, s = jkv.quantize_kv_rows(jnp.asarray(rows(rng, (P * ps, Hkv, D))))
    shape = (P, ps, Hkv * D) if folded else (P, ps, Hkv, D)
    pages = jkv.QuantizedPages(q.reshape(shape), s.reshape(P, ps))
    got = kv_from_jax(jax.tree.map(np.asarray, pages), LlamaConfig.tiny())
    assert isinstance(got, tkv.QuantizedPages) and got.shape == (P, ps, Hkv, D)
    np.testing.assert_array_equal(got.q.numpy().reshape(shape), np.asarray(pages.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(pages.s))
    with pytest.raises(ValueError, match="int8"):
        kv_from_jax(jkv.QuantizedPages(np.zeros(shape, np.float32), np.zeros((P, ps), np.float32)),
                    LlamaConfig.tiny())
