"""AsyncTorchEngine end to end on the CPU: greedy tokens equal the JAX
reference engine's (AsyncJaxEngine, f32) on the same weights for concurrent
requests, and the stop conditions, admission rejections and device rule of
the port's engine hold."""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel

torch.set_num_threads(2)

ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
PROMPTS = [[5, 9, 2, 77, 31], list(range(40, 51)), [200 - i for i in range(20)]]


async def collect(engine, req):
    toks, reason = [], None
    async for out in engine.generate(req):
        if out.token is not None:
            toks.append(out.token)
        reason = out.finish_reason
    return toks, reason


@pytest.fixture(scope="module")
def reference():
    """(greedy tokens of the JAX engine per prompt, its params as numpy)."""

    async def run():
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

    return asyncio.run(run())


def port_model(params) -> LlamaModel:
    cfg = LlamaConfig.tiny()
    model = LlamaModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    return model


def run_port_engine(params, requests, **over):
    """(outputs per request, the engine that served them)."""

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", **dict(ENGINE, **over)), model=port_model(params))
        await engine.start()
        try:
            return await asyncio.gather(*(collect(engine, r) for r in requests)), engine
        finally:
            await engine.shutdown()

    return asyncio.run(run())


def run_port(params, requests, **over):
    return run_port_engine(params, requests, **over)[0]


@pytest.mark.parametrize("decode_steps,prefill_lanes", [(8, 4), (1, 1)], ids=["window8-packed", "window1-lanes1"])
def test_greedy_tokens_equal_jax_engine(reference, decode_steps, prefill_lanes):
    ref_outs, params = reference
    outs, engine = run_port_engine(
        params,
        [EngineRequest(f"t{i}", p, SamplingParams(max_tokens=10)) for i, p in enumerate(PROMPTS)],
        decode_steps=decode_steps, prefill_lanes=prefill_lanes,
    )
    # one prefill lane takes the per-request path (runner.prefill_chunk)
    assert engine.runner.packed_prefill_mode == (prefill_lanes > 1)
    for (toks, reason), (ref_toks, ref_reason) in zip(outs, ref_outs):
        assert reason == ref_reason == "length"
        assert toks == ref_toks and len(toks) == 10


@pytest.mark.parametrize("num_heads,num_kv_heads", [(6, 2), (14, 2)], ids=["g3", "g7"])
def test_greedy_tokens_equal_jax_engine_at_odd_groups(num_heads, num_kv_heads):
    """A tiny Llama whose GQA group (3; 7, Qwen2-VL's 28 / 4) the port's
    first launchers refused on the card: the port's engine (plain versions
    on the CPU) gives the JAX engine's greedy tokens on the same weights."""
    over = dict(num_heads=num_heads, num_kv_heads=num_kv_heads)

    async def jax_run():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny:" + json.dumps(over), tp=1, **ENGINE))
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                collect(engine, JaxEngineRequest(f"j{i}", p, JaxSamplingParams(max_tokens=8)))
                for i, p in enumerate(PROMPTS)
            ))
            params = jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
        finally:
            await engine.shutdown()
        return outs, params

    ref_outs, params = asyncio.run(jax_run())
    cfg = LlamaConfig.tiny(**over)
    model = LlamaModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))

    async def port_run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", **ENGINE), model=model)
        await engine.start()
        try:
            return await asyncio.gather(*(
                collect(engine, EngineRequest(f"t{i}", p, SamplingParams(max_tokens=8)))
                for i, p in enumerate(PROMPTS)
            ))
        finally:
            await engine.shutdown()

    outs = asyncio.run(port_run())
    assert outs == ref_outs and all(len(t) == 8 for t, _ in outs)


def test_eos_stop_and_max_model_len(reference):
    ref_outs, params = reference
    stream = ref_outs[0][0]
    eos = stream[3]
    want = stream[: stream.index(eos) + 1]
    long_prompt = list(range(1, 61))  # 60 of max_model_len 64: room for 4 tokens
    (toks, reason), (toks2, reason2), (toks3, reason3) = run_port(params, [
        EngineRequest("eos", PROMPTS[0], SamplingParams(max_tokens=10), eos_token_ids=(eos,)),
        EngineRequest("ignore", PROMPTS[0], SamplingParams(max_tokens=10, ignore_eos=True),
                      eos_token_ids=(eos,)),
        EngineRequest("long", long_prompt, SamplingParams(max_tokens=50)),
    ])
    assert (toks, reason) == (want, "stop")
    assert (toks2, reason2) == (stream, "length")
    assert reason3 == "length" and len(toks3) == 4


def test_rejects_what_the_port_does_not_run(reference):
    """Oversized prompts, images and LoRA finish with "error"; penalties,
    min_tokens and logprobs, which the port runs, are served."""
    _, params = reference
    outs = run_port(params, [
        EngineRequest("big", list(range(70)), SamplingParams(max_tokens=2)),
        EngineRequest("img", [1, 2], SamplingParams(max_tokens=2), images=[object()]),
        EngineRequest("lora", [1, 2], SamplingParams(max_tokens=2), lora_name="adapter"),
        EngineRequest("pen", [1, 2], SamplingParams(max_tokens=2, presence_penalty=0.5, min_tokens=1),
                      eos_token_ids=(3,)),
        EngineRequest("lp", [1, 2], SamplingParams(max_tokens=2), logprobs=1),
        EngineRequest("ok", [1, 2], SamplingParams(max_tokens=2)),
    ])
    assert [r for _, r in outs] == ["error", "error", "error", "length", "length", "length"]
    assert [len(t) for t, _ in outs] == [0, 0, 0, 2, 2, 2]


def test_sampling_seeded_streams_are_reproducible(reference):
    """Seeded requests repeat token for token whatever else shares the batch;
    top-k=1 sampling equals greedy."""
    _, params = reference
    seeded = SamplingParams(max_tokens=12, temperature=0.9, top_p=0.9, min_p=0.05, seed=1234)
    a = run_port(params, [EngineRequest("s", PROMPTS[1], seeded)])
    b = run_port(params, [
        EngineRequest("other", PROMPTS[2], SamplingParams(max_tokens=12, temperature=1.0)),
        EngineRequest("s", PROMPTS[1], seeded),
    ])
    assert a[0] == b[1] and len(a[0][0]) == 12
    topk1 = run_port(params, [EngineRequest("k", PROMPTS[0], SamplingParams(max_tokens=10, temperature=0.7, top_k=1))])
    assert topk1[0][0] == reference[0][0][0]


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")

    async def run():
        await AsyncTorchEngine(EngineConfig(device="cuda", **ENGINE)).start()

    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(run())


# ---------------- sampling, config and allocator parity ----------------


@pytest.mark.parametrize(
    "temp,top_k,top_p,min_p",
    [(1.0, 0, 1.0, 0.0), (0.7, 3, 1.0, 0.0), (1.3, 0, 0.8, 0.0), (0.9, 5, 0.9, 0.1), (0.0, 2, 0.5, 0.2)],
)
def test_filter_keep_mask_matches_reference(temp, top_k, top_p, min_p):
    import jax.numpy as jnp

    from dynamo_tpu.engine.sampling import filter_keep_mask as j_filter
    from dynamo_tpu_torch.engine.sampling import filter_keep_mask

    logits = np.random.default_rng(7).standard_normal((4, 50)).astype(np.float32) * 3
    B = logits.shape[0]
    args = [np.full(B, temp, np.float32), np.full(B, top_k, np.int32), np.full(B, top_p, np.float32),
            np.full(B, min_p, np.float32)]
    want = np.asarray(j_filter(jnp.asarray(logits), *map(jnp.asarray, args[:3]), min_p=jnp.asarray(args[3])))
    got = filter_keep_mask(torch.from_numpy(logits), *map(torch.from_numpy, args[:3]),
                           min_p=torch.from_numpy(args[3])).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_tokens_draws_the_filtered_distribution():
    """Gumbel-max over the engine noise samples softmax(logits / T) restricted
    to the keep-mask: empirical frequencies within 0.015 of the target over
    40000 draws (about 6 standard errors at p = 0.5)."""
    from dynamo_tpu_torch.engine.sampling import sample_tokens

    V, n = 6, 40000
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]]).repeat(n, 1)
    gen = torch.Generator().manual_seed(0)
    for temp, top_k in ((1.0, 0), (0.5, 0), (1.0, 3)):
        toks = sample_tokens(
            logits, torch.full((n,), temp), torch.full((n,), top_k, dtype=torch.int32), torch.ones(n),
            uniform=torch.rand((n, V), generator=gen), need_filter=top_k > 0,
        )
        target = torch.softmax(logits[0] / temp, dim=-1)
        if top_k:
            target[top_k:] = 0
            target /= target.sum()
        freq = torch.bincount(toks.long(), minlength=V).double() / n
        assert (freq - target.double()).abs().max() < 0.015, (temp, top_k, freq, target)
    greedy = sample_tokens(logits[:4], torch.zeros(4), torch.zeros(4, dtype=torch.int32), torch.ones(4))
    assert greedy.tolist() == [0, 0, 0, 0]


def test_fold_seed_and_config_match_reference():
    from dynamo_tpu.engine.sampling import fold_seed as j_fold_seed
    from dynamo_tpu_torch.engine.sampling import fold_seed

    for seed in (None, 0, 1, -5, 2**40 + 3, 0x7FFFFFFD):
        assert fold_seed(seed) == j_fold_seed(seed)
    for over in ({}, dict(max_model_len=128 * 1024), dict(page_table_buckets=(8, 64), max_model_len=4096),
                 dict(page_size=128, max_model_len=2048)):
        ref, port = JaxEngineConfig(**over), EngineConfig(device="cpu", **over)
        assert port.table_buckets == ref.table_buckets
        assert port.max_pages_per_seq == ref.max_pages_per_seq
        for b in (1, 64, 65, 512):
            assert port.bucket_for(b) == ref.bucket_for(b)
            assert port.lanes_for(port.bucket_for(b)) == ref.lanes_for(ref.bucket_for(b))
    with pytest.raises(ValueError, match="device"):
        EngineConfig(device="tpu")


def test_page_allocator_matches_reference_without_prefix_cache():
    from dynamo_tpu.engine.page_table import PageAllocator as JaxPageAllocator
    from dynamo_tpu_torch.engine.page_table import PageAllocator

    ref, port = JaxPageAllocator(24, 4), PageAllocator(24, 4)
    rng = np.random.default_rng(8)
    live = []
    for step in range(40):
        if live and rng.random() < 0.35:
            sid = live.pop(int(rng.integers(len(live))))
            ref.free_sequence(sid)
            port.free_sequence(sid)
        elif live and rng.random() < 0.5:
            sid = live[int(rng.integers(len(live)))]
            n = int(rng.integers(1, 40))
            assert port.ensure_capacity(sid, n) == ref.ensure_capacity(sid, n)
        else:
            sid = f"s{step}"
            prompt = rng.integers(0, 1000, int(rng.integers(1, 20))).tolist()
            try:
                want = ref.allocate_sequence(sid, prompt)
            except MemoryError:
                with pytest.raises(MemoryError):
                    port.allocate_sequence(sid, prompt)
                continue
            got = port.allocate_sequence(sid, prompt)
            assert got[0] == want[0] == 0
            live.append(sid)
        for sid in live:
            assert port._seqs[sid].pages == ref._seqs[sid].pages
        assert port.free_pages == ref.free_pages and port.used_pages == ref.used_pages


def test_profile_window_stats_union_and_classes():
    """The profile tool's busy share is the union of kernel intervals, and
    kernels are classed by name (K1, K2, GEMM, other)."""
    from dynamo_tpu_torch.tools.profile_serve import kernel_class, window_stats

    kernels = [
        dict(name="void (anonymous namespace)::paged_decode_kernel<bf16,128,4>", ts=0.0, dur=10.0),
        dict(name="sm90_xmma_gemm_bf16", ts=5.0, dur=10.0),  # overlaps the first
        dict(name="elementwise_kernel", ts=30.0, dur=10.0),
        dict(name="paged_prefill_kernel<float,128>", ts=95.0, dur=10.0),  # clipped at hi
    ]
    w = window_stats(kernels, 0.0, 100.0)
    assert w["device_busy_ms"] == pytest.approx((15 + 10 + 5) / 1e3)
    assert w["idle_share"] == pytest.approx(0.7)
    assert w["device_ms_by_class"] == pytest.approx({"K1": 0.01, "K2": 0.01, "gemm": 0.01, "other": 0.01})
    assert [kernel_class(k["name"]) for k in kernels] == ["K1", "gemm", "other", "K2"]


def test_write_token_slots_feeds_the_next_window(reference):
    """A host-written slot token is what the next decode window feeds."""
    from dynamo_tpu_torch.engine.model_runner import ModelRunner

    _, params = reference
    model = port_model(params)
    runner = ModelRunner(EngineConfig(device="cpu", **ENGINE), model)
    B, W = ENGINE["max_seqs"], 4
    runner.write_token_slots(np.array([2]), np.array([123]))
    tables = np.zeros((B, W), np.int32)
    tables[2, 0] = 5
    active = np.zeros(B, bool)
    active[2] = True
    zeros = np.zeros(B, np.float32)
    got = runner.dispatch_decode_window(
        np.zeros(B, np.int32), tables, active, np.zeros(B, np.int32), zeros,
        np.zeros(B, np.int32), np.ones(B, np.float32), 1,
    ).numpy()
    kv = model.init_kv_cache(ENGINE["num_pages"], ENGINE["page_size"])
    logits, _ = model.decode(
        kv, torch.tensor([0, 0, 123, 0], dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
        torch.from_numpy(tables), torch.from_numpy(active),
    )
    assert got[0, 2] == int(logits[2].argmax())


def test_page_exhaustion_finishes_instead_of_hanging(reference):
    """A pool too small for two growing sequences: the pressure ladder
    drains the pipeline and preempts the most recent sequence back to the
    waiting queue, and both requests end with "length" and the JAX
    engine's tokens on the same pool (it preempts too)."""
    _, params = reference
    over = dict(num_pages=15, watermark=0.0)  # 14 pages: one 42-token sequence fits (11), two do not
    prompts = [list(range(1 + i, 13 + i)) for i in range(2)]

    async def jax_run():
        engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, **dict(ENGINE, **over)))
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                collect(engine, JaxEngineRequest(f"j{i}", p, JaxSamplingParams(max_tokens=30)))
                for i, p in enumerate(prompts)
            ))
            return outs, engine.scheduler.preempt_count
        finally:
            await engine.shutdown()

    ref_outs, ref_preempts = asyncio.run(jax_run())
    outs, engine = run_port_engine(params, [
        EngineRequest(f"p{i}", p, SamplingParams(max_tokens=30)) for i, p in enumerate(prompts)
    ], **over)
    assert ref_preempts >= 1 and engine.scheduler.preempt_count >= 1
    for (toks, reason), (ref_toks, ref_reason) in zip(outs, ref_outs):
        assert reason == ref_reason == "length"
        assert toks == ref_toks and len(toks) == 30
