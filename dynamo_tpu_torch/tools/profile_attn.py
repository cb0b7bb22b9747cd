"""Decode-kernel A/B on the card: the port of ``tools/profile_attn.py``.

    python -m dynamo_tpu_torch.tools.profile_attn [B] [ps] [ctx]

The reference bench's headline geometry (``tools/workload.py BENCH_1_3B``,
``bench_config``): B 64, Hq 16 / Hkv 8 / D 128, page size 128, a context of
256 rows (2 pages a sequence), a 24-layer flat bf16 pool of ``bench_config``'s
224 pages a layer, pages allocated in order (the allocator's steady state),
table width 1024 / ps.

Variants, the reference's set: ``perseq`` and ``lookahead`` (both K1, the
kernel that stands for both TPU kernels), ``dmaonly`` (K7b: K1's grid and page
stream with no math), ``perseq_bf16`` (K7c without cast_f32: one page an
iteration, probabilities rounded to bf16), ``chunked`` (K4a) and ``grouped``
(K4b). On this card each K7c toggle runs on the body that computes its
function: ``perseq_bf16`` on K4b's exact split at one page a unit (scores
and page maxima, then one bf16 P.V product at the rounded P), ``perseq``
(K1, the cast_f32 function) on K1's split body (P split into bf16 hi + lo,
two products, one pass). Their difference is what f32-exact probabilities
cost against rounded ones on these two designs. Before it is timed, every variant but ``dmaonly`` must agree with
``perseq`` within 0.05 (the reference's gate) and with its own plain version
(``ops/attention.py``) within ``tools/checks.py TOL["bf16"]`` elementwise, on
these inputs; ``dmaonly``'s checksum must equal its plain version's exactly
over pools of multiples of 1/8 of one layer's shape. A variant that fails or
raises is printed and skipped, as in the reference, and ``main`` returns it
under ``failed``.

Timing: device time over back-to-back launches (``tools/timing.py``: the host
enqueues them behind a sleep kernel, so its launch overhead stays out; the
reference differenced two scan lengths to cancel a dispatch round trip that
does not exist here). Launch i reads layer i mod 24's pages, as a decode step
walks its layers: one call reads 64 x 2 pages x 2 x 262,144 B = 67.1 MB at the
defaults, and the card's 50 MB L2 would serve repeated calls on one layer's
pages partly from cache. Prints us a call, ms a step (x 24 layers), the
dmaonly floor against the byte bound at 3.35 TB/s and the share of K1's time
it explains, and the card's name and power limit; then the reference's matmul
pair, [B, 2048] x [2048, 5632] and back (the MLP gate shape), with
``torch.matmul``: its 23 MB bf16 weight stays in L2 across iterations, so its
time is an L2-resident one.
"""

from __future__ import annotations

import functools
import json
import sys

import torch

from dynamo_tpu_torch.ops import attention as plain
from dynamo_tpu_torch.ops.kernels import paged_attention as pa
from dynamo_tpu_torch.tools.checks import TOL, exact_pools, tol_share
from dynamo_tpu_torch.tools.timing import card, device_us
from dynamo_tpu_torch.tools.workload import BENCH_1_3B, HEADLINE, bench_config
from dynamo_tpu_torch.utils.step_anatomy import HBM_BYTES_S

LAYERS = BENCH_1_3B["num_layers"]
HQ, HKV, D = BENCH_1_3B["num_heads"], BENCH_1_3B["num_kv_heads"], BENCH_1_3B["head_dim"]
MAX_MODEL_LEN = 1024
GATE = 0.05  # max |variant - perseq| (the reference's numerics gate)
ITERS = 4 * LAYERS
VARIANTS = ("perseq", "dmaonly", "perseq_bf16", "chunked", "grouped", "lookahead")


def variant_launchers() -> dict:
    """{variant: launcher(q, k_pages, v_pages, page_tables, positions)}."""
    return {
        "perseq": pa.paged_decode_attention_kernel,
        "dmaonly": pa.paged_decode_dmaonly_kernel,
        "perseq_bf16": functools.partial(pa.paged_decode_perseq_variant_kernel, cast_f32=False),
        "chunked": pa.paged_decode_attention_chunked_kernel,
        "grouped": pa.paged_decode_attention_grouped_kernel,
        "lookahead": pa.paged_decode_attention_kernel,
    }


def plain_versions() -> dict:
    """{variant: its plain version}, each variant held to it on the
    profiler's own inputs (``dmaonly`` exactly, over exact pools)."""
    return {
        "perseq": plain.paged_decode_attention,
        "dmaonly": plain.paged_decode_dmaonly,
        "perseq_bf16": plain.paged_decode_perseq_variant,
        "chunked": plain.paged_decode_attention_chunked,
        "grouped": plain.paged_decode_attention_grouped,
        "lookahead": plain.paged_decode_attention,
    }


def parse_args(argv: list[str]) -> tuple[int, int, int]:
    """[B] [ps] [ctx], defaults the headline's 64, 128, 256."""
    B = int(argv[0]) if len(argv) > 0 else HEADLINE[0]
    ps = int(argv[1]) if len(argv) > 1 else HEADLINE[1]
    ctx = int(argv[2]) if len(argv) > 2 else 256
    return B, ps, ctx


def main(argv: list[str] | None = None) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn needs a CUDA device")
    B, PS, CTX = parse_args(sys.argv[1:] if argv is None else argv)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    smi = card()
    per_layer = bench_config(B, PS).num_pages
    max_pages = -(-MAX_MODEL_LEN // PS)
    n_pages = -(-CTX // PS)
    if n_pages > max_pages or 1 + B * n_pages > per_layer:
        raise SystemExit(f"ctx {CTX} at B {B}, ps {PS} needs {n_pages} pages a sequence; the table "
                         f"holds {max_pages} and a layer {per_layer - 1}")
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (LAYERS * per_layer, PS, HKV, D)
    k_pages = (torch.randn(shape, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    v_pages = (torch.randn(shape, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    q = (torch.randn((B, HQ, D), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    # sequential allocation; layer l's tables are layer 0's plus its offset
    pt = torch.zeros((B, max_pages), dtype=torch.int32, device=dev)
    pt[:, :n_pages] = 1 + torch.arange(B * n_pages, dtype=torch.int32, device=dev).reshape(B, n_pages)
    tables = [pt + layer * per_layer for layer in range(LAYERS)]
    positions = torch.full((B,), CTX - 1, dtype=torch.int32, device=dev)

    launchers, plains = variant_launchers(), plain_versions()
    ref = launchers["perseq"](q, k_pages, v_pages, tables[0], positions).float()
    # dmaonly's checksum is held exactly over pools of multiples of 1/8 of
    # one layer's shape, on layer 0's tables
    exact = exact_pools((per_layer, PS, HKV, D), "bfloat16", dev, gen)
    diffs, held, failed = {}, {}, {}
    for name, fn in launchers.items():
        try:
            if name == "dmaonly":
                got = fn(q, *exact, tables[0], positions)
                err = (got - plains[name](q, *exact, tables[0], positions)).abs().max().item()
                held[name] = {"max_abs_err": err, "tol_share": 0.0 if err == 0 else float("inf")}
                print(f"{name:14s}: checksum max|diff vs plain| = {err:.3e} (must be 0)", flush=True)
                if err != 0:
                    failed[name] = f"checksum differs from its plain version by {err}"
                continue
            out = fn(q, k_pages, v_pages, tables[0], positions)
            err, share = tol_share(out, plains[name](q, k_pages, v_pages, tables[0], positions), "bf16")
        except Exception as e:  # noqa: BLE001 - the reference prints and skips a failed variant
            print(f"{name:14s}: NUMERICS FAILED {type(e).__name__}: {str(e)[:160]}", flush=True)
            failed[name] = f"{type(e).__name__}: {e}"
            continue
        held[name] = {"max_abs_err": err, "tol_share": share}
        diffs[name] = (out.float() - ref).abs().max().item()
        print(f"{name:14s}: max|diff vs perseq| = {diffs[name]:.4f}; vs its plain version {err:.3e}, "
              f"{share:.3f} of the limit", flush=True)
        if not share <= 1.0:
            failed[name] = f"{share:.3f}x the limit {TOL['bf16']} against its plain version"
        elif not diffs[name] <= GATE:
            failed[name] = f"max|diff vs perseq| {diffs[name]:.4f} > {GATE}"

    us = {}
    for name, fn in launchers.items():
        if name in failed:
            print(f"{name:10s}: SKIPPED (failed numerics gate)", flush=True)
            continue
        try:
            us[name] = device_us(lambda i, fn=fn: fn(q, k_pages, v_pages, tables[i % LAYERS], positions), ITERS)
        except Exception as e:  # noqa: BLE001
            print(f"{name:10s}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)
            failed[name] = f"{type(e).__name__}: {e}"
            continue
        print(f"{name:10s}: {us[name]:8.1f} us/call -> {us[name] * LAYERS / 1e3:6.3f} ms/step "
              f"(x{LAYERS} layers) [{smi}]", flush=True)

    kv_bytes = B * n_pages * PS * HKV * D * 2 * 2
    bound_us = kv_bytes / HBM_BYTES_S * 1e6
    print(f"\nKV traffic/call: {kv_bytes / 1e6:.1f} MB -> at {HBM_BYTES_S / 1e12:.2f} TB/s: {bound_us:.1f} us",
          flush=True)
    floor = {}
    if "dmaonly" in us:
        floor = {"dmaonly_us": us["dmaonly"], "bound_us": bound_us,
                 "dmaonly_vs_bound": us["dmaonly"] / bound_us}
        print(f"dmaonly floor {us['dmaonly']:.1f} us = {floor['dmaonly_vs_bound']:.2f}x the byte bound", flush=True)
        if "perseq" in us:
            floor["perseq_share_explained"] = us["dmaonly"] / us["perseq"]
            print(f"K1 (perseq) {us['perseq']:.1f} us: the load stream explains "
                  f"{100 * floor['perseq_share_explained']:.1f}% of it", flush=True)

    # matmul reference: one [B,2048]x[2048,5632] (the MLP gate shape) and back
    hidden, inter = BENCH_1_3B["hidden_size"], BENCH_1_3B["intermediate_size"]
    w = (torch.randn((hidden, inter), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    h = [(torch.randn((B, hidden), generator=gen, device=dev) * 0.1).to(torch.bfloat16)]

    def mm_pair(_):
        h[0] = ((h[0] @ w) @ w.T * 1e-3).to(torch.bfloat16)

    mm_us = device_us(mm_pair, ITERS)
    mm_bytes = hidden * inter * 2 * 2
    print(f"matmul pair [B,2048]x[2048,5632]x2: {mm_us:.1f} us/iter (weight bytes {mm_bytes / 1e6:.0f} MB -> "
          f"HBM floor {mm_bytes / HBM_BYTES_S * 1e6:.1f} us; the 23 MB weight stays in the 50 MB L2)", flush=True)
    out = {"device": smi, "geometry": dict(B=B, ps=PS, ctx=CTX, Hq=HQ, Hkv=HKV, D=D, layers=LAYERS),
           "us_per_call": us, "max_abs_diff_vs_perseq": diffs, "held_to_plain": held, "failed": failed, "floor": floor,
           "matmul_pair_us": mm_us}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
