"""The port's MLA + MoE slice against the JAX package on the same numpy-seeded
inputs and the same weights (``deepseek_params_from_jax``), at f32:

  - the plain K5/K6 versions against the Pallas kernels in interpret mode
    (``paged_mla_decode_attention_pallas`` with ``lookahead=False``, the
    per-program twin: the lookahead variant pins ``pltpu.TPUCompilerParams``,
    which the installed JAX no longer has), atol 2e-5;
  - ``moe_block`` against the reference's, routing exact, outputs atol 1e-5;
  - ``DeepseekModel`` prefill / two-chunk prefill / 16 decode steps against
    the JAX model, logits atol 2e-4 (the reference's own MLA tests'
    tolerance: the same f32 algebra summed in another order through two
    layers), pools after ``ckv_from_jax``;
  - the engine's greedy tokens against ``AsyncJaxEngine`` on ``tiny-mla``.

The kernels K5/K6 themselves run only on the card
(tests/test_torch_kernels_cuda.py)."""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu.models.deepseek import DeepseekConfig as JaxDeepseekConfig
from dynamo_tpu.models.deepseek import DeepseekModel as JaxDeepseekModel
from dynamo_tpu.ops.moe import moe_block as j_moe_block
from dynamo_tpu.ops.moe import topk_routing as j_topk_routing
from dynamo_tpu.ops.pallas.mla_attention import (
    paged_mla_decode_attention_pallas,
    paged_mla_prefill_attention_pallas,
)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.models.convert import ckv_from_jax, deepseek_params_from_jax
from dynamo_tpu_torch.models.deepseek import DeepseekConfig, DeepseekModel
from dynamo_tpu_torch.models.registry import load_model
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops.kernels.mla_attention import (
    check_mla_args,
    paged_mla_decode_attention_kernel,
    paged_mla_prefill_attention_kernel,
)
from dynamo_tpu_torch.ops.moe import moe_block, topk_routing

torch.set_num_threads(2)

ATOL_KERNEL = 2e-5
ATOL_LOGITS = 2e-4
H, DC, DR = 4, 32, 8
LATENT = DC + DR


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- K5 / K6 plain


def test_mla_decode_plain_matches_pallas():
    """Lengths on and across page boundaries, a full table, an inactive slot
    (trash table, position 0) and a row at position -1, which attends index 0
    only: it is held against the Pallas kernel at position 0 (the kernel
    spreads a uniform softmax over the first page there instead)."""
    rng = np.random.default_rng(0)
    P, ps, mp = 64, 4, 8
    positions = np.array([3, 4, 8, 17, mp * ps - 1, 0, -1], np.int32)
    B = len(positions)
    inactive = 5
    q = (rng.standard_normal((B, H, LATENT)) / np.sqrt(DC // 2 + DR)).astype(np.float32)
    pages = rng.standard_normal((P, ps, LATENT)).astype(np.float32)
    pt = np.zeros((B, mp), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        used = max(positions[b], 0) // ps + 1
        pt[b, :used] = perm[b * mp : b * mp + used]
    pt[inactive] = 0
    got = tatt.paged_mla_decode_attention(_t(q), _t(pages), _t(pt), _t(positions), DC).numpy()
    want = np.asarray(paged_mla_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(pt), jnp.asarray(np.maximum(positions, 0)),
        d_c=DC, lookahead=False, interpret=True,
    ))
    assert got.shape == (B, H, DC) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL_KERNEL)
    dispatched = tatt.dispatch_paged_mla_decode_attention(_t(q), _t(pages), _t(pt), _t(positions), DC)
    np.testing.assert_array_equal(dispatched.numpy(), got)


def test_mla_decode_plain_negative_position_equals_position_zero():
    """The negative-position rule of K1 and K5: position -1 gives exactly
    the position-0 result, in the MLA plain version and in K1's."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, H, LATENT)).astype(np.float32)
    pages = rng.standard_normal((6, 4, LATENT)).astype(np.float32)
    pt = np.array([[3, 5], [3, 5]], np.int32)
    out = tatt.paged_mla_decode_attention(_t(q), _t(pages), _t(pt), _t(np.array([-1, 0], np.int32)), DC)
    np.testing.assert_array_equal(out[0].numpy(), tatt.paged_mla_decode_attention(
        _t(q[:1]), _t(pages), _t(pt[:1]), _t(np.array([0], np.int32)), DC)[0].numpy())
    np.testing.assert_array_equal(out[0].numpy(), pages[3, 0, :DC][None].repeat(H, 0))


@pytest.mark.parametrize("T,start", [(128, 0), (128, 37), (256, 0)])
def test_mla_prefill_plain_matches_pallas(T, start):
    """As tests/test_deepseek_mla.py's kernel test: a chunk from 0, one after
    a cached prefix, and two query blocks."""
    rng = np.random.default_rng(T + start)
    P, ps, mp = 64, 4, 48
    pages = rng.standard_normal((P, ps, LATENT)).astype(np.float32)
    pt = rng.choice(np.arange(1, P), size=mp, replace=False).astype(np.int32)
    q = rng.standard_normal((T, H, LATENT)).astype(np.float32)
    positions = (start + np.arange(T)).astype(np.int32)
    got = tatt.paged_mla_prefill_attention(_t(q), _t(pages), _t(pt), _t(positions), DC).numpy()
    want = np.asarray(paged_mla_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(pt), jnp.asarray(positions), d_c=DC, interpret=True,
    ))
    np.testing.assert_allclose(got, want, atol=ATOL_KERNEL)
    dispatched = tatt.dispatch_paged_mla_prefill_attention(_t(q), _t(pages), _t(pt), _t(positions), DC)
    np.testing.assert_array_equal(dispatched.numpy(), got)


def test_mla_kernel_arg_checks_raise_on_shapes_the_kernels_do_not_take():
    """The launchers' checks (run here on CPU tensors: the checks precede any
    launch)."""
    B, Hs, L, dc, P, ps, mp = 3, 16, 576, 512, 4, 16, 2
    q = torch.zeros((B, Hs, L))
    pages = torch.zeros((P, ps, L), dtype=torch.bfloat16)
    pt = torch.zeros((B, mp), dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    check_mla_args(q, pages, pt, pos, dc, decode=True)  # the serving shapes pass
    check_mla_args(q, pages.float(), pt[0], pos, dc, decode=False)
    # any latent width and any 0 < d_c <= latent launch (rows that start off
    # 16 bytes take the FMA body, which reads them an element at a time): a
    # width that is no multiple of 8, a d_c that is no multiple of 4
    check_mla_args(q[..., :572], pages[..., :572].contiguous(), pt, pos, dc, decode=True)
    check_mla_args(q[..., :504], pages[..., :504].contiguous(), pt, pos, 502, decode=True)
    with pytest.raises(ValueError, match="d_c"):
        check_mla_args(q, pages, pt, pos, 0, decode=True)
    check_mla_args(q[:, :4], pages, pt, pos, dc, decode=True)  # any H: tiny-mla's 4 heads
    check_mla_args(q[:, :5], pages, pt[0], pos, dc, decode=False)
    # rows past 768 (scored in column chunks) and d_c past 512 (sliced over
    # blocks) launch: d_c 1024 + d_r 64
    check_mla_args(torch.zeros((B, Hs, 1088)), torch.zeros((P, ps, 1088)), pt, pos, 1024, decode=True)
    check_mla_args(torch.zeros((B, Hs, 776)), torch.zeros((P, ps, 776)), pt[0], pos, dc, decode=False)
    with pytest.raises(ValueError, match="d_c"):  # values past the latent row
        check_mla_args(q, pages, pt, pos, 584, decode=True)
    with pytest.raises(ValueError, match="float32 q_cat"):
        check_mla_args(q.bfloat16(), pages, pt, pos, dc, decode=True)
    with pytest.raises(ValueError, match="int32"):
        check_mla_args(q, pages, pt, pos.long(), dc, decode=True)
    with pytest.raises(ValueError, match="page_table"):
        check_mla_args(q, pages, pt, pos, dc, decode=False)
    # the launchers take CUDA tensors only; the dispatchers send a device that
    # is neither the CPU nor a card to them, and they refuse it
    with pytest.raises(ValueError, match="CUDA"):
        paged_mla_decode_attention_kernel(q, pages, pt, pos, dc)
    with pytest.raises(ValueError, match="CUDA"):
        paged_mla_prefill_attention_kernel(q, pages, pt[0], pos, dc)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.dispatch_paged_mla_decode_attention(*(t.to("meta") for t in (q, pages, pt, pos)), dc)


# ---------------------------------------------------------------- MoE


def _slot_major_kept(idx: np.ndarray, E: int, capacity: int) -> int:
    """Pairs the reference's rule keeps: experts fill in slot-major order."""
    count = np.zeros(E, int)
    kept = 0
    for k in range(idx.shape[1]):
        for t in range(idx.shape[0]):
            e = idx[t, k]
            kept += count[e] < capacity
            count[e] += 1
    return kept


@pytest.mark.parametrize("renormalize", [True, False], ids=["renorm", "no-renorm"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["no-drop", "drops"])
def test_moe_block_matches_reference(renormalize, capacity_factor):
    rng = np.random.default_rng(int(capacity_factor * 10) + renormalize)
    T, D, E, K, F = 24, 16, 8, 2, 12
    hidden = rng.standard_normal((T, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32)
    w_gate, w_up = (rng.standard_normal((E, D, F)).astype(np.float32) / 4 for _ in range(2))
    w_down = rng.standard_normal((E, F, D)).astype(np.float32) / 4
    logits = hidden @ router
    jw, jidx = j_topk_routing(jnp.asarray(logits), K, renormalize=renormalize)
    tw, tidx = topk_routing(_t(logits), K, renormalize=renormalize)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    args = (hidden, router, w_gate, w_up, w_down)
    want = np.asarray(j_moe_block(*map(jnp.asarray, args), num_experts_per_tok=K,
                                  capacity_factor=capacity_factor, renormalize=renormalize))
    got = moe_block(*map(_t, args), num_experts_per_tok=K, capacity_factor=capacity_factor,
                    renormalize=renormalize).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    capacity = max(1, int(-(-T * K * capacity_factor // E)))
    kept = _slot_major_kept(np.asarray(jidx), E, capacity)
    assert (kept < T * K) == (capacity_factor < 1.0)


# ---------------------------------------------------------------- model

PS, NUM_PAGES = 4, 16
CONFIGS = {"q-plain": {}, "q-lora": dict(q_lora_rank=24)}


def port_model(params, over) -> DeepseekModel:
    cfg = DeepseekConfig.tiny_mla(**over)
    model = DeepseekModel(cfg)
    model.load_state_dict(deepseek_params_from_jax(params, cfg))
    return model


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def models(request):
    over = CONFIGS[request.param]
    jm = JaxDeepseekModel(JaxDeepseekConfig.tiny_mla(**over))
    params = jm.init_params(jax.random.key(1))
    return jm, params, port_model(jax.tree.map(np.asarray, params), over)


def fresh_pools(jm, tm):
    return jm.init_kv_cache(NUM_PAGES, PS), tm.init_kv_cache(NUM_PAGES, PS)


def assert_pools_match(jkv, tkv, cfg):
    keep = np.ones(cfg.num_layers * NUM_PAGES, bool)
    keep[::NUM_PAGES] = False  # per-layer trash pages
    want = ckv_from_jax(np.asarray(jkv["ckv"]), cfg).numpy()[keep]
    np.testing.assert_allclose(tkv["ckv"].numpy()[keep], want, atol=ATOL_LOGITS)


def chunk_inputs(tokens, start, bucket, table_width=8, pages=(3, 7, 1, 5)):
    n = len(tokens)
    toks = np.zeros(bucket, np.int32)
    toks[:n] = tokens
    positions = (start + np.arange(bucket)).astype(np.int32)
    valid = np.arange(bucket) < n
    table = np.zeros(table_width, np.int32)
    table[: len(pages)] = pages
    return toks, positions, table, valid


def test_prefill_logits_and_pool(models):
    jm, params, tm = models
    jkv, tkv = fresh_pools(jm, tm)
    toks, pos, table, valid = chunk_inputs(np.random.default_rng(0).integers(0, 256, 13), 0, 16)
    jlogits, jkv2 = jax.jit(jm.prefill)(params, jkv, *map(jnp.asarray, (toks, pos, table, valid)), 12)
    tlogits, tkv2 = tm.prefill(tkv, _t(toks), _t(pos), _t(table), _t(valid), 12)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL_LOGITS)
    assert_pools_match(jkv2, tkv2, tm.config)


def test_two_chunk_prefill(models):
    jm, params, tm = models
    jkv, tkv = fresh_pools(jm, tm)
    prompt = np.random.default_rng(1).integers(0, 256, 13)
    prefill = jax.jit(jm.prefill)
    for start, end in ((0, 8), (8, 13)):
        toks, pos, table, valid = chunk_inputs(prompt[start:end], start, 8)
        last = end - start - 1
        jlogits, jkv = prefill(params, jkv, *map(jnp.asarray, (toks, pos, table, valid)), last)
        tlogits, tkv = tm.prefill(tkv, _t(toks), _t(pos), _t(table), _t(valid), last)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL_LOGITS)
    assert_pools_match(jkv, tkv, tm.config)


def test_sixteen_decode_steps(models):
    """Prefill two sequences, then 16 decode steps over a batch of 3 with one
    inactive slot, feeding the reference's greedy tokens to both sides."""
    jm, params, tm = models
    jkv, tkv = fresh_pools(jm, tm)
    rng = np.random.default_rng(3)
    prefill = jax.jit(jm.prefill)
    seqs = [(rng.integers(0, 256, 6), (1, 2, 3, 4, 5, 6)), (rng.integers(0, 256, 3), (8, 9, 10, 11, 12))]
    first = []
    for prompt, pages in seqs:
        toks, pos, table, valid = chunk_inputs(prompt, 0, 8, pages=pages)
        last = len(prompt) - 1
        jlogits, jkv = prefill(params, jkv, *map(jnp.asarray, (toks, pos, table, valid)), last)
        tlogits, tkv = tm.prefill(tkv, _t(toks), _t(pos), _t(table), _t(valid), last)
        first.append(int(jnp.argmax(jlogits)))
    tables = np.zeros((3, 8), np.int32)
    tables[0, :6] = seqs[0][1]
    tables[2, :5] = seqs[1][1]
    tokens = np.array([first[0], 0, first[1]], np.int32)
    positions = np.array([6, 0, 3], np.int32)
    active = np.array([True, False, True])
    decode = jax.jit(jm.decode)
    for _ in range(16):
        jlogits, jkv = decode(params, jkv, *map(jnp.asarray, (tokens, positions, tables, active)))
        tlogits, tkv = tm.decode(tkv, _t(tokens), _t(positions), _t(tables), _t(active))
        np.testing.assert_allclose(tlogits.numpy()[active], np.asarray(jlogits)[active], atol=ATOL_LOGITS)
        tokens = np.where(active, np.asarray(jnp.argmax(jlogits, axis=-1)), 0).astype(np.int32)
        positions = positions + active
    assert_pools_match(jkv, tkv, tm.config)


def test_converters_reject_mismatched_trees(models):
    _, params, tm = models
    np_params = jax.tree.map(np.asarray, params)
    same_q = {"q_lora_rank": tm.config.q_lora_rank}
    over = {"q_lora_rank": None if tm.config.q_lora_rank else 24}
    with pytest.raises(ValueError, match="leaves"):  # the other query path
        deepseek_params_from_jax(np_params, DeepseekConfig.tiny_mla(**over))
    with pytest.raises(ValueError, match="layers"):
        deepseek_params_from_jax(np_params, DeepseekConfig.tiny_mla(num_layers=3, **same_q))
    with pytest.raises(ValueError, match="shape"):
        deepseek_params_from_jax(np_params, DeepseekConfig.tiny_mla(num_heads=2, **same_q))
    with pytest.raises(ValueError, match="latent pool"):
        ckv_from_jax(np.zeros((8, 4, 64), np.float32), tm.config)


def test_registry_builds_tiny_mla():
    """``tiny-mla[:{json}]`` builds a DeepseekModel from the seed at the
    reference's scales: norms 1, router f32, each weight over sqrt(fan)."""
    model = load_model('tiny-mla:' + json.dumps({"q_lora_rank": 16}), device="cpu")
    again = load_model('tiny-mla:' + json.dumps({"q_lora_rank": 16}), device="cpu")
    assert isinstance(model, DeepseekModel) and model.config.q_lora_rank == 16
    moe = model.moe_layers[0]
    assert moe.router.dtype == torch.float32 and moe.w_gate.dtype == torch.float32
    assert torch.equal(moe.w_down, again.moe_layers[0].w_down)
    assert torch.all(model.dense_layers[0].kv_norm == 1)
    c = model.config
    assert abs(float(moe.w_gate.std()) * c.hidden_size**0.5 - 1) < 0.05
    assert abs(float(model.dense_layers[0].w_kb.std()) * c.kv_lora_rank**0.5 - 1) < 0.05


# ---------------------------------------------------------------- engine

ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
PROMPTS = [[5, 9, 2, 77, 31], list(range(40, 51)), [200 - i for i in range(20)]]


async def collect(engine, req):
    toks, reason = [], None
    async for out in engine.generate(req):
        if out.token is not None:
            toks.append(out.token)
        reason = out.finish_reason
    return toks, reason


def test_greedy_tokens_equal_jax_engine_on_tiny_mla():
    """3 concurrent greedy requests: the port's engine (per-request prefill,
    K5/K6 plain versions) gives the JAX engine's tokens on its weights."""

    async def reference():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny-mla", tp=1, **ENGINE))
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

    async def port(params):
        engine = AsyncTorchEngine(EngineConfig(device="cpu", **ENGINE), model=port_model(params, {}))
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                collect(engine, EngineRequest(f"t{i}", p, SamplingParams(max_tokens=10)))
                for i, p in enumerate(PROMPTS)
            ))
        finally:
            await engine.shutdown()
        return outs, engine.runner.packed_prefill_mode

    ref_outs, params = asyncio.run(reference())
    outs, packed = asyncio.run(port(params))
    assert not packed  # DeepseekModel has no prefill_packed: the per-request path
    for (toks, reason), (ref_toks, ref_reason) in zip(outs, ref_outs):
        assert reason == ref_reason == "length"
        assert toks == ref_toks and len(toks) == 10


# a latent row that is no multiple of 8 and a d_c that is no multiple of 4
# (kv_lora_rank 30 + qk_rope_head_dim 6 = 36): the reference pads the row to
# 128 lanes, the port keeps the logical width and its FMA bodies read such
# rows an element at a time on the card
NARROW_LATENT = {"kv_lora_rank": 30, "qk_rope_head_dim": 6}


def test_greedy_tokens_equal_jax_engine_at_a_narrow_latent_width():
    """3 concurrent greedy requests on tiny-mla at latent width 36 (d_c 30):
    the port's engine gives the JAX engine's tokens on its weights."""
    model_id = "tiny-mla:" + json.dumps(NARROW_LATENT)

    async def reference():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id=model_id, tp=1, **ENGINE))
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

    async def port(params):
        model = port_model(params, NARROW_LATENT)
        assert model.config.latent_dim == 36
        engine = AsyncTorchEngine(EngineConfig(device="cpu", **ENGINE), model=model)
        await engine.start()
        try:
            return await asyncio.gather(*(
                collect(engine, EngineRequest(f"t{i}", p, SamplingParams(max_tokens=10)))
                for i, p in enumerate(PROMPTS)
            ))
        finally:
            await engine.shutdown()

    ref_outs, params = asyncio.run(reference())
    outs = asyncio.run(port(params))
    for (toks, reason), (ref_toks, ref_reason) in zip(outs, ref_outs):
        assert reason == ref_reason == "length"
        assert toks == ref_toks and len(toks) == 10


def test_profile_classes_mla_kernels():
    """The profile tool classes K5's launches as K5 (either body, and in a
    window where a K5 body runs, the split merge they share with the paged
    decode kernels) and K6's as K6, and counts decode steps by K5's first
    launch."""
    from dynamo_tpu_torch.tools.profile_serve import DECODE_STEP_KERNEL, kernel_class, window_stats

    names = [
        "void (anonymous namespace)::mla_decode_tc<64>(float const*, ...)",
        "void (anonymous namespace)::mla_decode_partial<__nv_bfloat16>(float const*, ...)",
        "void dtt::merge_splits<float>(float const*, ...)",
        "void (anonymous namespace)::mla_prefill<__nv_bfloat16>(float const*, ...)",
        "void (anonymous namespace)::paged_prefill_kernel<__nv_bfloat16, 128>(...)",
    ]
    assert [kernel_class(n) for n in (names[0], names[1], names[3], names[4])] == ["K5", "K5", "K6", "K2"]
    assert all(DECODE_STEP_KERNEL["K5"] in n for n in names[:2]) and DECODE_STEP_KERNEL["K5"] not in names[2]
    window = [{"name": n, "ts": 10.0 * i, "dur": 5.0} for i, n in enumerate(names[:3])]
    assert window_stats(window, 0.0, 100.0)["device_ms_by_class"] == {"K5": 0.015}
