"""Where a packed prefill call's time goes on the card: the port of
``tools/profile_prefill.py``, its three measurements on the reference
bench's headline engine (``tools/workload.py bench_config``: the ~1.3B
Llama shape, B 64, page size 128, bf16, seeded random weights).

    python -m dynamo_tpu_torch.tools.profile_prefill [batch] [page_size]

  1. Call-count differencing through the port's
     ``ModelRunner.prefill_chunk_batch`` (lanes ``(tokens, start, page_table,
     slot, sampling, eos_ids, is_final)``): the walls of 2 and 8 back-to-back calls at
     the 128- and 512-row buckets give each bucket's cost per call, and the
     two buckets fit cost(rows) = fixed + slope * rows.
  2. The fixed cost split at the 512-row bucket: host prep
     (``pack_prefill_lanes``), H2D staging of the packed arrays, and one
     call after a full synchronize, timed twice: its host span (until it
     returns) and its device span (CUDA events around it on the stream).
     dispatch = host span - prep - H2D; device after return = device span -
     host span (about 0 when the device waited on the host); device residue
     = the differenced cost of a call - its host span. None is clamped: a
     negative value says the split does not add up. Last one call under
     torch.profiler: its device busy time (the union of its kernels'
     intervals); a host span above it means the device waits on the host,
     and 1 - busy / host span is the device's idle share of the call.
  3. K2 against K7a, its load-only twin (K2's grid and tile loads, no math),
     on the last 512-row chunk of a 3072-row prompt at the model's heads:
     first K2 is held to its plain version (``tools/checks.py TOL``) and
     K7a's checksum to its plain version's exactly (pools of multiples of
     1/8); then the twin's time is the share of K2 its load stream explains.
     One chunk's 26-page pool is 13.6 MB and would sit in the 50 MB L2, so
     the launches rotate over 8 copies (109 MB).

Then the roofline at 512 rows (``utils/step_anatomy.py``, H100 constants)
against the measured call. Prints one JSON object and returns it. Needs one
CUDA device.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dynamo_tpu_torch.engine.model_runner import ModelRunner
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.models.registry import load_model
from dynamo_tpu_torch.ops import attention as plain
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention_kernel,
    paged_prefill_dmaonly_kernel,
)
from dynamo_tpu_torch.tools.checks import TOL, exact_pools, tol_share
from dynamo_tpu_torch.tools.profile_serve import window_stats
from dynamo_tpu_torch.tools.timing import card, device_us
from dynamo_tpu_torch.tools.workload import HEADLINE, bench_config
from dynamo_tpu_torch.utils.step_anatomy import roofline_for_runner

M_SHORT, M_LONG = 2, 8  # runner-path call counts (differenced)
ROWS_A, ROWS_B = 128, 512  # prefill buckets measured (both in bench_config)
T, CTX = 512, 3072  # part 3: the last 512-row chunk of a 3072-row prompt
COPIES = 8  # part 3: pool copies the launches rotate over (> the L2)
ITERS = 4 * COPIES


def best_wall(fn, reps: int = 3) -> float:
    fn()  # warm caches
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def kernel_ab(mc, ps: int, dev, gen) -> dict:
    """Part 3: K2 held to its plain version and K7a to its checksum (over
    pools of multiples of 1/8) on one copy, then each one's device time a
    call (us), the launches rotated over 8 pool copies."""
    Hq, Hkv, D = mc.num_heads, mc.num_kv_heads, mc.head_dim
    n_pages = -(-CTX // ps)
    per_copy = n_pages + 2
    shape = (COPIES * per_copy, ps, Hkv, D)
    k_pages = (torch.randn(shape, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    v_pages = (torch.randn(shape, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    q = (torch.randn((T, Hq, D), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    tables = [c * per_copy + 1 + torch.arange(n_pages, dtype=torch.int32, device=dev) for c in range(COPIES)]
    pos = torch.arange(CTX - T, CTX, dtype=torch.int32, device=dev)
    held, failed = {}, {}
    err, share = tol_share(paged_prefill_attention_kernel(q, k_pages, v_pages, tables[0], pos),
                           plain.paged_prefill_attention(q, k_pages, v_pages, tables[0], pos), "bf16")
    held["K2"] = {"max_abs_err": err, "tol_share": share}
    if not share <= 1.0:
        failed["K2"] = f"{share:.3f}x the limit {TOL['bf16']} against its plain version"
    exact = exact_pools((per_copy, ps, Hkv, D), "bfloat16", dev, gen)
    err = (paged_prefill_dmaonly_kernel(q, *exact, tables[0], pos)
           - plain.paged_prefill_dmaonly(q, *exact, tables[0], pos)).abs().max().item()
    held["K7a"] = {"max_abs_err": err, "tol_share": 0.0 if err == 0 else float("inf")}
    if err != 0:
        failed["K7a"] = f"checksum differs from its plain version by {err}"
    print(f"K2 vs its plain version: {held['K2']['max_abs_err']:.3e}, {held['K2']['tol_share']:.3f} of the "
          f"limit; K7a checksum vs plain: {err:.3e} (must be 0)", flush=True)
    us = {
        name: device_us(lambda i, fn=fn: fn(q, k_pages, v_pages, tables[i % COPIES], pos), ITERS)
        for name, fn in (("K2", paged_prefill_attention_kernel), ("K7a", paged_prefill_dmaonly_kernel))
    }
    pool_mb = 2 * per_copy * ps * Hkv * D * 2 / 1e6
    return {
        "geometry": f"T={T} ctx={CTX} Hq={Hq} Hkv={Hkv} D={D} ps={ps}, {COPIES} copies of a {pool_mb:.1f} MB pool",
        "held_to_plain": held,
        "failed": failed,
        "attn_us_per_layer": us["K2"],
        "dma_floor_us_per_layer": us["K7a"],
        "attn_minus_dma_us": us["K2"] - us["K7a"],
        "load_share_of_k2": us["K7a"] / us["K2"],
        "per_chunk_ms_x_layers": us["K2"] * mc.num_layers / 1e3,
    }


def call_spans(call, reps: int = 5) -> dict:
    """Part 2: the best of ``reps`` single calls, each after a full
    synchronize: the host span (until the call returns) and the device span
    (CUDA events recorded on the stream just before the call and just after
    it returns: from the call's start to the end of the device work it
    enqueued). Then one call under torch.profiler: its device busy time, the
    union of its kernels' intervals, and their count. A host span above the
    busy time means the device waits on the host. (A call of many launches
    cannot be queued whole behind a sleep kernel to time its device work:
    the launch queue fills and the host blocks.)"""
    call()  # warm caches
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        call()
        host_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        device_s = start.elapsed_time(end) / 1e3
        if best is None or device_s < best[1]:
            best = (host_s, device_s)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        with torch.profiler.profile(activities=activities) as prof:
            call()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    busy = window_stats(kernels, min(k["ts"] for k in kernels), max(k["ts"] + k["dur"] for k in kernels) + 1)
    return {"host_s": best[0], "device_s": best[1], "busy_s": busy["device_busy_ms"] / 1e3,
            "kernels": busy["kernels"]}


def main(argv: list[str] | None = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_prefill needs a CUDA device")
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if len(argv) > 0 else HEADLINE[0]
    PS = int(argv[1]) if len(argv) > 1 else HEADLINE[1]
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    smi = card()
    cfg = bench_config(B, PS)
    model = load_model(cfg.model_id, device="cuda")
    runner = ModelRunner(cfg, model)
    mc = model.config

    rng = np.random.default_rng(0)
    pages_b = -(-ROWS_B // cfg.page_size)
    if 1 + pages_b > cfg.num_pages:
        raise SystemExit(f"pool too small: need {1 + pages_b} pages")
    # one table length for both widths, so only the row bucket differs
    page_table = 1 + np.arange(pages_b, dtype=np.int32)
    greedy = SamplingParams()

    def lane(rows):
        # the final chunk of a rows-long prompt: samples its first token
        # into slot 0
        return (rng.integers(1, mc.vocab_size, size=rows, dtype=np.int32), 0, page_table, 0, greedy, (), True)

    lanes = {rows: [lane(rows)] for rows in (ROWS_A, ROWS_B)}

    # ---- 1. call-count differencing through the production path ----
    def run_calls(m, rows):
        toks = None
        for _ in range(m):
            toks = runner.prefill_chunk_batch(lanes[rows], N=1)
        return int(toks.numpy()[0])  # waits for the last call only

    per_call = {}
    for rows in (ROWS_A, ROWS_B):
        t_short = best_wall(lambda r=rows: run_calls(M_SHORT, r))
        t_long = best_wall(lambda r=rows: run_calls(M_LONG, r))
        per_call[rows] = (t_long - t_short) / (M_LONG - M_SHORT)
    slope = (per_call[ROWS_B] - per_call[ROWS_A]) / (ROWS_B - ROWS_A)
    fixed_s = per_call[ROWS_A] - slope * ROWS_A

    # ---- 2. the fixed cost split at the wide bucket ----
    host_prep_s = best_wall(lambda: runner.pack_prefill_lanes(lanes[ROWS_B], 1))
    ints, flts = runner.pack_prefill_lanes(lanes[ROWS_B], 1)[:2]

    def h2d():
        runner._to_device(ints)
        runner._to_device(flts)
        torch.cuda.synchronize()

    h2d_s = best_wall(h2d)
    spans = call_spans(lambda: runner.prefill_chunk_batch(lanes[ROWS_B], N=1))
    # unclamped: a negative residue says the split does not add up
    dispatch_s = spans["host_s"] - host_prep_s - h2d_s
    device_after_return_s = spans["device_s"] - spans["host_s"]
    device_residue_s = per_call[ROWS_B] - spans["host_s"]

    # ---- 3. K2 against its load-only twin K7a ----
    ab = kernel_ab(mc, PS, dev, torch.Generator(device=dev).manual_seed(0))

    roof = roofline_for_runner(runner, cfg)
    out = {
        "device": smi, "B": B, "page_size": PS, "model": "bench 1.3B (tools/workload.py BENCH_1_3B)",
        "per_call_ms": {r: per_call[r] * 1e3 for r in per_call},
        "fixed_ms": fixed_s * 1e3,
        "per_row_us": slope * 1e6,
        "fixed_split_ms": {
            "host_prep": host_prep_s * 1e3, "h2d_staging": h2d_s * 1e3,
            "call_host_span": spans["host_s"] * 1e3, "call_device_span": spans["device_s"] * 1e3,
            "call_device_busy": spans["busy_s"] * 1e3, "call_kernels": spans["kernels"],
            "call_idle_share": 1.0 - spans["busy_s"] / spans["host_s"],
            "dispatch": dispatch_s * 1e3, "device_after_return": device_after_return_s * 1e3,
            "device_residue": device_residue_s * 1e3,
        },
        "attn_kernel_ab": ab,
        "failed": ab["failed"],
    }
    if roof is not None:
        floor_s = roof.prefill_floor_seconds(ROWS_B)
        out["roofline"] = {
            "floor_ms_512rows": floor_s * 1e3, "pct_of_roofline": 100 * floor_s / per_call[ROWS_B],
            "param_count": roof.param_count, "peak_flops_s": roof.peak_flops,
        }
    split = out["fixed_split_ms"]
    print(f"profile_prefill [{smi}]: a 512-row call costs {per_call[ROWS_B] * 1e3:.2f} ms (differenced); one "
          f"call after a synchronize: host span {split['call_host_span']:.2f} ms, device span "
          f"{split['call_device_span']:.2f} ms ({split['device_after_return']:+.2f} ms after the return); "
          f"device busy {split['call_device_busy']:.2f} ms in {spans['kernels']} kernels (idle "
          f"{100 * split['call_idle_share']:.1f}% of the host span); host prep {host_prep_s * 1e3:.3f} ms, "
          f"H2D {h2d_s * 1e3:.3f} ms", flush=True)
    print(f"profile_prefill [{smi}]: K2 {ab['attn_us_per_layer']:.1f} us, K7a {ab['dma_floor_us_per_layer']:.1f} "
          f"us: the load stream explains {100 * ab['load_share_of_k2']:.1f}% of K2", flush=True)
    print(json.dumps(out), flush=True)
    del runner, model
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
