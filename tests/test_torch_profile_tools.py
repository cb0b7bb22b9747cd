"""The port's profilers (``dynamo_tpu_torch/tools/profile_attn.py``,
``profile_prefill.py``, ``profile_http.py``, ``profile_decode.py``) and its checkpoint writer
(``make_hf_checkpoint.py``) on the CPU: they import without a card and refuse to run on the card
without one; ``profile_attn`` times the
reference's variant set; their geometry is the reference bench's; the
roofline copy (``utils/step_anatomy.py``) does the reference's arithmetic;
and ``profile_http`` drives a tiny CPU engine in each of its modes."""

import ast
import importlib
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from dynamo_tpu.models.registry import load_model as jax_load_model
from dynamo_tpu.ops.pallas import paged_attention as jax_pa
from dynamo_tpu.utils.step_anatomy import RooflineModel as JaxRooflineModel
from dynamo_tpu.utils.step_anatomy import roofline_for_runner as jax_roofline_for_runner
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.models.registry import load_model
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.quant.kv import QuantizedPages
from dynamo_tpu_torch.tools import profile_attn
from dynamo_tpu_torch.tools.checks import TOL, exact_pools, tol_share
from dynamo_tpu_torch.tools.workload import BENCH_1_3B, bench_config
from dynamo_tpu_torch.utils.step_anatomy import BF16_FLOPS_S, HBM_BYTES_S, RooflineModel, roofline_for_runner

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["profile_attn", "profile_prefill", "profile_http", "profile_decode",
                                  "make_hf_checkpoint"])
def test_tools_import_and_refuse_without_a_card(monkeypatch, tmp_path, name):
    module = importlib.import_module(f"dynamo_tpu_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path / "ckpt")] if name == "make_hf_checkpoint" else []
    with pytest.raises(SystemExit, match="CUDA device"):
        module.main(argv)
    assert not (tmp_path / "ckpt").exists()


def reference_variants() -> list[str]:
    """The keys of ``variants`` in the reference's ``tools/profile_attn.py
    main``: its dict literal, then the unconditional item assignments (the
    ``fused`` one sits under a hasattr test of a kernel the reference no
    longer has)."""
    tree = ast.parse((ROOT / "tools" / "profile_attn.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = []
    for node in main.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "variants" and isinstance(node.value, ast.Dict):
            keys += [k.value for k in node.value.keys]
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and isinstance(node.targets[0].value, ast.Name) and node.targets[0].value.id == "variants":
            keys.append(node.targets[0].slice.value)
    return keys


def test_profile_attn_times_the_reference_variants():
    assert not hasattr(jax_pa, "paged_decode_attention_pallas_fused")
    assert list(profile_attn.VARIANTS) == reference_variants()
    assert list(profile_attn.variant_launchers()) == list(profile_attn.VARIANTS)


def test_profile_attn_holds_each_variant_to_its_plain_version():
    plains = profile_attn.plain_versions()
    assert list(plains) == list(profile_attn.VARIANTS)
    assert plains["perseq"] is plains["lookahead"] is tatt.paged_decode_attention
    assert plains["dmaonly"] is tatt.paged_decode_dmaonly
    assert plains["chunked"] is tatt.paged_decode_attention_chunked
    assert plains["grouped"] is tatt.paged_decode_attention_grouped
    assert plains["perseq_bf16"] is tatt.paged_decode_perseq_variant


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_exact_pools_sum_exactly_in_any_order(kind):
    """The load-only twins' checksums are held exactly: every value is a
    multiple of 1/8 (int8: a code times 2^-7) in [-1, 1], so f32 sums in
    different orders agree bit for bit."""
    gen = torch.Generator().manual_seed(3)
    pools = exact_pools((40, 16, 2, 64), kind, "cpu", gen)
    assert len(pools) == 2
    for pool in pools:
        if kind == "int8":
            assert isinstance(pool, QuantizedPages) and pool.q.dtype == torch.int8
            assert (pool.s == 2.0**-7).all()
            x = pool.q.float() * pool.s[..., None, None]
        else:
            assert pool.dtype == getattr(torch, kind)
            x = pool.float()
        assert x.abs().max() <= 1 and ((x * 128).round() == x * 128).all()
        rows = x.reshape(-1, 2 * 64)
        assert torch.equal(rows.sum(0), rows.flip(0).cumsum(0)[-1])
        assert torch.equal(rows.sum(0), rows[torch.randperm(len(rows), generator=gen)].sum(0))


@pytest.mark.parametrize("tol", ["f32", "bf16"])
def test_tol_share_is_the_elementwise_limit(tol):
    atol, rtol = TOL[tol]
    ref = torch.tensor([0.0, 1.0, -3.0])
    limit = atol + rtol * ref.abs()
    err, share = tol_share(ref + limit * torch.tensor([0.5, -0.25, 1.0]), ref, tol)
    assert share == pytest.approx(1.0, rel=1e-2) and err == pytest.approx(limit.max().item(), rel=1e-2)
    assert tol_share(ref + 2 * limit, ref, tol)[1] == pytest.approx(2.0, rel=1e-2)
    assert tol_share(ref.to(torch.bfloat16), ref, tol)[1] == 0.0
    assert tol_share(torch.tensor([0.0, float("nan"), 0.0]), ref, tol) == (float("inf"), float("inf"))


def test_profile_attn_arguments_default_to_the_headline():
    assert profile_attn.parse_args([]) == (64, 128, 256)
    assert profile_attn.parse_args(["8", "16", "512"]) == (8, 16, 512)


def test_bench_geometry_is_the_reference_bench():
    spec = importlib.util.spec_from_file_location("reference_bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert BENCH_1_3B == json.loads(bench.json_model_id().split(":", 1)[1])
    for batch, ps in (bench.HEADLINE, bench.CONTINUITY):
        ref, got = bench.bench_config(batch, ps), bench_config(batch, ps)
        for field in ("page_size", "num_pages", "max_seqs", "max_model_len", "prefill_buckets",
                      "decode_steps", "pipeline_depth"):
            assert getattr(got, field) == getattr(ref, field), field
    assert got.model_id == bench.json_model_id()


@pytest.mark.parametrize("rows", [0, 1, 127, 128, 512, 4096])
def test_roofline_copy_does_the_reference_arithmetic(rows):
    args = dict(param_bytes=2_600_000_000, page_bytes=24 * 2 * 128 * 8 * 128 * 2, page_size=128,
                param_count=1_300_000_000, hbm_bw=HBM_BYTES_S)
    ref = JaxRooflineModel(**args, mxu_flops=BF16_FLOPS_S)
    got = RooflineModel(**args)
    assert got.peak_flops == BF16_FLOPS_S and got.hbm_bw == 3.35e12
    assert got.prefill_floor_bytes(rows) == ref.prefill_floor_bytes(rows)
    assert got.prefill_floor_seconds(rows) == ref.prefill_floor_seconds(rows)


def test_roofline_for_runner_prices_the_reference_model():
    """Parameter bytes, count and page bytes of a port runner equal the
    reference's for the same tiny config."""
    cfg = EngineConfig(device="cpu", model_id="tiny", num_pages=16, max_seqs=2, max_model_len=64)
    got = roofline_for_runner(ModelRunner(cfg, load_model("tiny", device="cpu")), cfg)
    jax_model, jax_params = jax_load_model("tiny")

    class JaxRunner:
        model, params = jax_model, jax_params

    ref = jax_roofline_for_runner(JaxRunner, cfg)
    assert (got.param_bytes, got.param_count, got.page_bytes, got.page_size) == \
        (ref.param_bytes, ref.param_count, ref.page_bytes, ref.page_size)


@pytest.mark.parametrize("body", ["tc_prefill_kernel<__nv_bfloat16, 64>", "fma_prefill_kernel<float, 64>",
                                  "tc_prefill_kernel<signed char, 128>"])
def test_profile_serve_classes_the_shared_prefill_bodies(body):
    """K2 and K3b share their kernel bodies: profile_serve counts a prefill
    body as K2 in a Llama workload and as K3b in a folded one, and never as
    another class."""
    from dynamo_tpu_torch.tools.profile_serve import PREFILL_CLASSES, kernel_class, window_stats

    name = f"void (anonymous namespace)::{body}(...)"
    assert kernel_class(name) == "K2" and kernel_class(name, folded=True) == "K3b"
    assert kernel_class("void (anonymous namespace)::mla_prefill<__nv_bfloat16>(...)", folded=True) == "K6"
    kernels = [dict(name=name, ts=0.0, dur=10.0)]
    assert window_stats(kernels, 0.0, 20.0, folded=True)["device_ms_by_class"] == {"K3b": 0.01}
    assert {"K2", "K3b"} <= set(PREFILL_CLASSES)
    # K3a's split bodies (K1's tensor-core body in a folded workload) and its merge are K3a's
    for k3a in ("paged_decode_tc<signed char, 64>", "folded_decode_fma<float>", "merge_splits<__nv_bfloat16>"):
        assert kernel_class(f"void (anonymous namespace)::{k3a}(...)", folded=True) == "K3a"
    # K4b's passes; the merge it shares with K3a is K4b's in a window where K4b's scores run
    for k4b in ("grouped_scores<128>", "grouped_pv<128>"):
        assert kernel_class(f"void (anonymous namespace)::{k4b}(...)") == "K4b"
    merge = dict(name="void (anonymous namespace)::merge_splits<__nv_bfloat16>(...)", ts=5.0, dur=2.0)
    scores = dict(name="void (anonymous namespace)::grouped_scores<128>(...)", ts=0.0, dur=4.0)
    assert window_stats([scores, merge], 0.0, 20.0)["device_ms_by_class"] == {"K4b": 0.006}
    assert window_stats([merge], 0.0, 20.0)["device_ms_by_class"] == {"K3a": 0.002}


def test_profile_serve_gives_k1_its_split_body_and_merge():
    """K1's bf16 body (paged_decode_tc) and f32 body are K1's; the merge it
    shares with K3a and K4b is K1's in a window where paged_decode_tc runs,
    and a decode step is counted by K1's split body, not by its merge."""
    from dynamo_tpu_torch.tools.profile_serve import DECODE_STEP_KERNEL, kernel_class, window_stats

    body = dict(name="void (anonymous namespace)::paged_decode_tc<__nv_bfloat16, 128>(...)", ts=0.0, dur=4.0)
    merge = dict(name="void dtt::merge_splits<__nv_bfloat16, 8>(...)", ts=5.0, dur=1.0)
    assert kernel_class(body["name"]) == "K1"
    assert kernel_class("void (anonymous namespace)::paged_decode_kernel<float, float, 512, 4>(...)") == "K1"
    assert window_stats([body, merge], 0.0, 20.0)["device_ms_by_class"] == {"K1": 0.005}
    # K3a runs the same body at TinyLlama's head dim: in a folded workload, body and merge are K3a's
    assert window_stats([body, merge], 0.0, 20.0, folded=True)["device_ms_by_class"] == {"K3a": 0.005}
    assert DECODE_STEP_KERNEL["K1"] in body["name"] and DECODE_STEP_KERNEL["K1"] not in merge["name"]


@pytest.mark.parametrize("body", ["w8a16_wgmma<16, true>", "w8a16_wgmma<128, false>",
                                  "w8a16_kernel<__nv_bfloat16, 8>", "w8a16_reduce<float>"])
def test_profile_serve_classes_k8(body):
    """Every body of K8 (the wgmma body, the mma body and its reduce)
    is K8's, not a GEMM's, in every workload; the int8_wo workload is
    profiled by name and selectable on the command line."""
    from dynamo_tpu_torch.tools.profile_serve import WORKLOADS, kernel_class, main, window_stats

    name = f"void (anonymous namespace)::wg::{body}(CUtensorMap, CUtensorMap, (anonymous namespace)::wg::Call)"
    assert kernel_class(name) == "K8" and kernel_class(name, folded=True) == "K8"
    gemm = dict(name="nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", ts=12.0, dur=3.0)
    assert window_stats([dict(name=name, ts=0.0, dur=10.0), gemm], 0.0, 20.0)["device_ms_by_class"] == {
        "K8": 0.01, "gemm": 0.003}
    assert "llama_int8_wo" in WORKLOADS
    with pytest.raises(SystemExit, match="unknown workloads"):
        main(["--workloads", "llama,nope"])


def test_profile_http_runs_each_mode_on_the_cpu():
    """profile_http's run_modes on a tiny CPU engine behind the port's
    service (the tiny card's engine defaults): each mode serves every request
    its max_tokens, in process, from client threads and from a client
    process, and each run counts its packed prefill calls and stamps its
    requests' arrival and first token."""
    import asyncio
    import threading
    from argparse import Namespace

    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.frontends.http import build_service
    from dynamo_tpu_torch.launch._run_impl import engine_config_for
    from dynamo_tpu_torch.tools import profile_http

    args = Namespace(model="tiny", max_model_len=None, num_pages=None, max_seqs=None, device="cpu", http_port=0)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(120)

    async def boot():
        engine = AsyncTorchEngine(engine_config_for(args))
        await engine.start()
        service = build_service(engine, args, host="127.0.0.1")
        return engine, service, await service.start()

    engine, service, port = on_loop(boot())
    try:
        requests = lambda: [EngineRequest(f"r{i}", list(range(10 + i, 30 + 5 * i)), SamplingParams(max_tokens=6))
                            for i in range(4)]
        result = profile_http.run_modes(engine, port, on_loop, requests, rounds=1)
    finally:
        on_loop(service.stop())
        on_loop(engine.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
    assert [r["mode"] for r in result["runs"]] == list(profile_http.MODES)
    for r in result["runs"]:
        assert r["prefill_calls"] > 0 and 0 < r["ttft_p50_ms"] <= r["ttft_max_ms"] <= r["engine_wall_s"] * 1e3, r
        assert r["engine_wall_s"] <= r["wall_s"] and r["output_tok_s"] == pytest.approx(24 / r["engine_wall_s"])
        assert 0 <= r["arrival_spread_ms"] <= r["engine_wall_s"] * 1e3
        # the run's own step anatomy: its packed prefill calls and their host cost
        anatomy = r["anatomy"]
        assert anatomy["dispatches"]["prefill_packed"] == r["prefill_calls"] and anatomy["prefill_fixed_ms"] > 0
        assert 0 < anatomy["host_fraction"] <= 1
    assert set(result["median"]) == set(profile_http.MODES)


def test_profile_decode_differences_windows_on_the_cpu():
    """profile_decode's arithmetic at a tiny geometry on the CPU (eager
    only: graphs need the card): the reference's page layout, per-step
    costs by differencing two window lengths, sampling and feedback as the
    window less the model alone, and the floor from roofline_for_runner,
    which equals the reference estimator's on the same numbers."""
    from dynamo_tpu_torch.tools import profile_decode

    cfg = EngineConfig(device="cpu", model_id="tiny", page_size=4, num_pages=64, max_seqs=3, max_model_len=64)
    runner = ModelRunner(cfg, load_model("tiny", device="cpu"))
    st = profile_decode.decode_state(cfg, 3, 10)
    assert st["page_tables"][:, :4].tolist() == [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
    assert st["live_pages"] == 9 and st["limits"].tolist() == [14, 14, 14]
    times = profile_decode.measure(runner, cfg, 3, 10, steps=(2, 6), reps=1)
    assert list(times) == ["eager"] and all(t[1] > 0 and t[0] > 0 for t in times["eager"].values())
    roof = roofline_for_runner(runner, cfg)
    fake = {"graph": {"window": (0.010, 0.038), "model_only": (0.006, 0.026)},
            "eager": {"window": (0.050, 0.250), "model_only": (0.040, 0.200)}}
    out = profile_decode.summarize(fake, roof, 9, 3, steps=(2, 6))
    assert out["per_step_ms"]["graph"] == pytest.approx({"window": 7.0, "model_only": 5.0,
                                                         "sampling_and_feedback": 2.0})
    assert out["per_step_ms"]["eager"] == pytest.approx({"window": 50.0, "model_only": 40.0,
                                                         "sampling_and_feedback": 10.0})
    assert out["window_tok_s"] == pytest.approx({"graph": 3 / 0.007, "eager": 3 / 0.05})
    ref = JaxRooflineModel(param_bytes=roof.param_bytes, page_bytes=roof.page_bytes, page_size=4,
                           hbm_bw=HBM_BYTES_S, param_count=roof.param_count, mxu_flops=BF16_FLOPS_S)
    assert out["hbm_floor_ms"] == pytest.approx(ref.step_floor_seconds(9) * 1e3, rel=1e-12)
    assert out["pct_of_roofline"]["graph"] == pytest.approx(100 * ref.step_floor_seconds(9) / 0.007)
    assert out["kv_bytes_per_step"] == 9 * roof.page_bytes

