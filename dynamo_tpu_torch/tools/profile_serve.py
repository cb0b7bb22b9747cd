"""Where the serving time goes on the card: torch.profiler over the serve
workloads of ``chip_smoke.py`` (``tools/workload.py``: 16 concurrent greedy
requests on Llama-3-8B geometry, on DeepSeek-V2-Lite geometry, on
TinyLlama-1.1B geometry with the int8 KV cache, on Llama-3-8B geometry with
``DYNTPU_DECODE_KERNEL=grouped`` (K4b decode), and on Llama-3-8B geometry
with int8_wo weights (every linear through K8); seeded random weights,
bf16 but for the last), each split at its last prefill-attention launch
(K2, K6 or K3b) into a prefill window and a decode window.

    python -m dynamo_tpu_torch.tools.profile_serve [--out profile_serve.json] [--workloads llama,llama_int8_wo]

For each workload and window it reports the wall time, the device's busy
and idle share (union of kernel intervals), device time by kernel class
(K1, K2, K3a, K3b, K4b, K5, K6, K8, GEMM, other) and the top kernels; for the decode window
also the time per decode step; and, where the engine records it, the
profiled serve's step anatomy (host fraction, roofline fractions, prefill
fixed ms, decode dispatch gap) and its graph captures. The engine warms up
(``EngineConfig.warmup=True``, where the tree has it: every step graph is
captured before the profile). Needs one CUDA device. The profiler adds
host overhead, so walls here run longer than chip_smoke.py's unprofiled
serve numbers; shares and device times are the point.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path

import torch

from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.ops.attention import DECODE_KERNEL_ENV
from dynamo_tpu_torch.tools.timing import card
from dynamo_tpu_torch.tools.workload import (
    DEEPSEEK_V2_LITE,
    LLAMA3_8B,
    TINYLLAMA_1_1B,
    folded_serve_config,
    folded_serve_requests,
    mla_serve_config,
    serve_config,
    serve_requests,
)
from dynamo_tpu_torch.utils.step_anatomy import HBM_BYTES_S

GEMM_MARKS = ("gemm", "GEMM", "nvjet", "cutlass", "xmma", "sm90_")
# the workloads profiled, in order: (engine config, requests, layers,
# DYNTPU_DECODE_KERNEL or None for the default)
WORKLOADS = {
    "llama": (serve_config, serve_requests, LLAMA3_8B["num_layers"], None),
    "mla": (mla_serve_config, lambda: serve_requests(DEEPSEEK_V2_LITE["vocab_size"]),
            DEEPSEEK_V2_LITE["num_layers"], None),
    "folded_int8": (lambda: folded_serve_config("int8"), folded_serve_requests,
                    TINYLLAMA_1_1B["num_layers"], None),
    "grouped": (serve_config, serve_requests, LLAMA3_8B["num_layers"], "grouped"),
    "llama_int8_wo": (lambda: serve_config(quantize="int8_wo"), serve_requests, LLAMA3_8B["num_layers"], None),
}
# kernel class by a mark in its name; K1, K3a, K4b and K5 count all of their
# launches (K1's bodies, paged_decode_tc (bf16 queries) or
# paged_decode_kernel (f32), and its merge, merge_splits; K3a's FMA body,
# folded_decode_fma, and the same merge; K4b's grouped_scores, grouped_pv
# and the same merge; K5's bodies, mla_decode_tc (bf16 pages) or
# mla_decode_partial, and the same merge: a window where grouped_scores runs
# gives merge_splits to K4b, one where a K5 body runs to K5, else K1 or K3a
# take it as the workload's decode kernel). K8 is every launch of the
# weight-only int8 linear's bodies (w8a16_wgmma, w8a16_kernel and
# w8a16_reduce). K2 and
# K3b share their kernel bodies (tc_prefill_kernel, fma_prefill_kernel), and
# K1 and K3a share paged_decode_tc: a folded workload's prefill kernels are
# K3b's launches and its decode kernels K3a's
KERNEL_MARKS = (
    ("K1", "paged_decode_"), ("K2", "_prefill_kernel"),
    ("K3a", "folded_decode_"), ("K3a", "merge_splits"), ("K4b", "grouped_"), ("K5", "mla_decode_"),
    ("K6", "mla_prefill"), ("K8", "w8a16_"),
)
PREFILL_CLASSES = ("K2", "K3b", "K6")
DECODE_STEP_KERNEL = {"K1": "paged_decode_", "K3a": "folded_decode_", "K4b": "grouped_scores",
                      "K5": "mla_decode_"}


def kernel_class(name: str, folded: bool = False) -> str:
    """The class of a kernel by its name; ``folded``: the workload's prefill
    bodies are K3b's and its decode bodies K3a's."""
    for cls, mark in KERNEL_MARKS:
        if mark in name:
            return {"K2": "K3b", "K1": "K3a"}.get(cls, cls) if folded else cls
    if any(m in name for m in GEMM_MARKS):
        return "gemm"
    return "other"


def window_stats(kernels: list, lo: float, hi: float, top: int = 8, folded: bool = False) -> dict:
    """Busy share and device time by class for kernels inside [lo, hi) (us);
    ``folded``: the workload's head_dim takes K3b for prefill."""
    inside = sorted((k for k in kernels if lo <= k["ts"] < hi), key=lambda k: k["ts"])
    busy, cur_s, cur_e = 0.0, None, None
    for k in inside:  # union of intervals
        s, e = k["ts"], min(k["ts"] + k["dur"], hi)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_class: dict = {}
    by_name: dict = {}
    names = {k["name"] for k in inside}
    merge = ("K4b" if any("grouped_scores" in n for n in names)
             else "K5" if any("mla_decode_" in n for n in names)
             else "K1" if not folded and any("paged_decode_tc" in n for n in names) else "K3a")
    for k in inside:
        c = merge if "merge_splits" in k["name"] else kernel_class(k["name"], folded)
        by_class[c] = by_class.get(c, 0.0) + k["dur"]
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"]
    wall = hi - lo
    return {
        "wall_ms": wall / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / wall if wall > 0 else None,
        "kernels": len(inside),
        "device_ms_by_class": {c: v / 1e3 for c, v in sorted(by_class.items())},
        "top_kernels_ms": {
            n[:80]: v / 1e3 for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        },
    }


def anatomy_summary(anatomy) -> dict:
    """The step anatomy's headline numbers (host fraction, roofline
    fractions, prefill fixed ms, decode dispatch gap, dispatches)."""
    return {
        "host_fraction": anatomy.host_fraction(),
        "decode_host_fraction": anatomy.host_fraction(("decode_window",)),
        "roofline_fraction": anatomy.roofline_fraction(),
        "prefill_roofline_fraction": anatomy.prefill_roofline_fraction(),
        "prefill_fixed_ms": anatomy.prefill_fixed_ms(),
        "dispatch_gap_ms": anatomy.dispatch_gap_ms(),
        "dispatches": dict(anatomy.dispatch_counts),
    }


async def profiled_serve(config, requests: list, trace_path: Path) -> tuple[float, int, dict]:
    """Serve ``requests`` under the profiler; returns (wall seconds, bytes of
    weights a decode step reads: every parameter but the embedding table,
    the profiled serve's step anatomy and captures where the engine has
    them)."""
    if any(f.name == "warmup" for f in dataclasses.fields(config)):
        config = dataclasses.replace(config, warmup=True)
    engine = AsyncTorchEngine(config)
    await engine.start()
    step_bytes = sum(
        t.numel() * t.element_size() for n, t in engine.model.named_parameters() if n != "embed"
    )

    async def drain(req):
        async for _ in engine.generate(req):
            pass

    try:
        # warm-up outside the trace: kernel build, cuBLAS handles, allocator
        await drain(EngineRequest("warm", list(range(1, 200)), SamplingParams(max_tokens=9)))
        torch.cuda.synchronize()
        anatomy = getattr(engine.scheduler, "anatomy", None)
        if anatomy is not None:  # the profiled serve's own
            anatomy = engine.scheduler.anatomy = type(anatomy)(roofline=anatomy.roofline)
        monitor = getattr(engine.runner, "compile_monitor", None)
        captures = monitor.compiles if monitor is not None else None
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        )
        prof.start()
        t0 = time.monotonic()
        await asyncio.gather(*(drain(r) for r in requests))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        prof.stop()
    finally:
        await engine.shutdown()
    prof.export_chrome_trace(str(trace_path))
    extra = {}
    if anatomy is not None:
        extra["anatomy"] = anatomy_summary(anatomy)
    if monitor is not None:
        extra["captures_before"], extra["captures_during"] = captures, monitor.compiles - captures
        extra["warmup_s"] = getattr(engine, "warmup_s", None)
        extra["graph_pool_bytes"] = engine.runner.graphs.pool_bytes()
    return wall, step_bytes, extra


def profile_workload(name: str, smi: str) -> dict:
    """Profile one of ``WORKLOADS`` and print its windows; returns the summary."""
    make_config, make_requests, layers, decode_kernel = WORKLOADS[name]
    requests = make_requests()
    old = os.environ.pop(DECODE_KERNEL_ENV, None)
    if decode_kernel is not None:
        os.environ[DECODE_KERNEL_ENV] = decode_kernel
    try:
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            wall, step_bytes, extra = asyncio.run(profiled_serve(make_config(), requests, trace))
            events = json.loads(trace.read_text())["traceEvents"]
    finally:
        os.environ.pop(DECODE_KERNEL_ENV, None)
        if old is not None:
            os.environ[DECODE_KERNEL_ENV] = old
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    del events
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    start = min(k["ts"] for k in kernels)
    end = max(k["ts"] + k["dur"] for k in kernels)
    split = max((k["ts"] + k["dur"] for k in kernels if kernel_class(k["name"]) in PREFILL_CLASSES),
                default=start)
    folded = name == "folded_int8"
    prefill = window_stats(kernels, start, split, folded=folded)
    decode = window_stats(kernels, split, end + 1, folded=folded)
    marks = tuple(DECODE_STEP_KERNEL.values())
    step_launches = sum(1 for k in kernels if k["ts"] >= split and any(m in k["name"] for m in marks))
    steps = step_launches / layers
    if steps:
        decode["steps"] = steps
        decode["ms_per_step"] = decode["wall_ms"] / steps
        decode["device_ms_per_step"] = decode["device_busy_ms"] / steps
    summary = {
        "device": smi, "workload": name, "layers": layers, "requests": len(requests),
        "prompt_tokens": sum(len(r.token_ids) for r in requests),
        "profiled_wall_s": wall, "prefill_window": prefill, "decode_window": decode,
        # the decode step's floor: its weight bytes read once at the H100 SXM rate
        "decode_weight_bytes": step_bytes, "decode_floor_ms": step_bytes / HBM_BYTES_S * 1e3,
        **extra,
    }
    print(f"profile_serve {name} [{smi}]: {len(requests)} requests, {summary['prompt_tokens']} "
          f"prompt tokens, profiled wall {wall:.3f} s", flush=True)
    for window, w in (("prefill", prefill), ("decode", decode)):
        print(f"  {window} window: {w['wall_ms']:.1f} ms, device busy {w['device_busy_ms']:.1f} ms "
              f"(idle share {w['idle_share']:.3f}), by class {json.dumps(w['device_ms_by_class'])}",
              flush=True)
    if steps:
        print(f"  decode: {steps:.0f} steps, {decode['ms_per_step']:.2f} ms/step wall, "
              f"{decode['device_ms_per_step']:.2f} ms/step device busy; floor "
              f"{summary['decode_floor_ms']:.2f} ms ({step_bytes / 1e9:.2f} GB of weights)", flush=True)
    if "anatomy" in extra:
        print(f"  step anatomy: {json.dumps(extra['anatomy'])}", flush=True)
    if "captures_during" in extra:
        print(f"  graphs: {extra['captures_before']} captured before the profile ({extra['warmup_s']:.1f} s of "
              f"warmup), {extra['captures_during']} during it; pool {extra['graph_pool_bytes']} bytes", flush=True)
    print(json.dumps(summary), flush=True)
    torch.cuda.empty_cache()
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="", help="write the summaries' JSON here too")
    p.add_argument("--workloads", default=",".join(WORKLOADS),
                   help=f"comma-separated, in order, of {', '.join(WORKLOADS)} (default: all)")
    args = p.parse_args(argv)
    names = [n for n in args.workloads.split(",") if n]
    unknown = [n for n in names if n not in WORKLOADS]
    if unknown:
        raise SystemExit(f"unknown workloads {unknown}; choose from {list(WORKLOADS)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.cuda.set_device(0)
    smi = card()
    summaries = {name: profile_workload(name, smi) for name in names}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summaries, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
