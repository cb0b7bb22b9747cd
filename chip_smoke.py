#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device and nvcc (CUDA_HOME
or PATH). Phases, each of which raises on failure (exit code != 0):

  1. device: the card's name and power limit as nvidia-smi reports them
  2. build the three kernel sources (one nvcc per source, started together)
  3. K1 paged decode and K3a, its folded variant, against their plain
     PyTorch versions (B 64, ps 16, ragged contexts 1..2048, inactive slots,
     a row at position -1; K1 at Hq 32 / Hkv 8 / D 128, K3a at TinyLlama's
     Hq 32 / Hkv 4 / D 64) in three mixes: f32, bf16, and bf16 queries over
     the int8 cache; kernel / plain / SDPA times and the bound
  4. K2 chunked-prefill flash and K3b the same way (512-row lanes at cached
     prefixes 0 and 1024, plus a pad lane, in one launch)
  5. K5 MLA latent decode against its plain version (B 16, H 16, latent
     576, d_c 512, ps 16, ragged contexts 1..2048, inactive slots, a row at
     position -1), f32 queries over f32 and over bf16 pages; kernel / plain /
     SDPA times and the SDPA backends that take the inputs
  6. K6 MLA latent prefill the same way (512-row chunks at cached prefixes 0
     and 1536)
  7. serve paths (tools/workload.py: 16 concurrent greedy requests of
     64-2048 prompt tokens and 64 output tokens, bf16, seeded random
     weights, full width and depth); every stream must finish with exactly
     64 tokens, the path's kernels must launch and the others' must not:
       serve / int8 serve: Llama-3-8B geometry, bf16 / int8 KV cache, K1 K2;
       MLA serve: DeepSeek-V2-Lite geometry (MLA + 64-expert MoE), K5 K6;
       folded serve / folded int8 serve: TinyLlama-1.1B geometry (head_dim
       64, prompts clipped to 1984), bf16 / int8 KV cache, K3a K3b
  8. refusals: an int8 cache on tiny-mla, and K3 launches at a head dim or
     dtype they do not take, raise on the card
  9. 2-layer f32 greedy parity: the engine's tokens must equal a dense
     no-paging forward's on Llama-3-8B geometry, on TinyLlama geometry with
     an f32 and with an int8 KV cache (the dense forward quantizes and
     dequantizes each K/V row), and on V2-Lite geometry (capacity factor 11,
     nothing drops) against a dense non-absorbed forward

Then a {"kernels": [...]} summary line, and as the last line
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# Kernel vs plain, elementwise |got - ref| <= atol + rtol * |ref|. Both sides
# compute in f32 from the same inputs and differ there only in summation order
# (max 1e-6 for K1, 6e-6 for K2 at f32 on an H100); a bf16 output is rounded
# once at the end, and two roundings of nearly equal values differ by at most
# one bf16 step, <= 2^-7 |value|. So bf16 gets rtol 2^-6 (two steps) on top of
# the f32 atol: at the ~0.03 outputs of 2048-key rows the limit is ~6e-4, below
# the ~1e-3 that one dropped page of keys moves them.
TOL = {"f32": (1e-4, 0.0), "bf16": (1e-4, 2.0**-6)}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after warm-up)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def held_to_plain(what: str, dtype: str, got, ref, tol: str | None = None) -> float:
    """Raise unless ``got`` is finite and within ``TOL[tol or dtype]`` of
    ``ref`` elementwise; returns the max abs error."""
    import torch

    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what} {dtype}: non-finite output")
    atol, rtol = TOL[tol or dtype]
    diff = (got.float() - ref.float()).abs()
    share = (diff / (atol + rtol * ref.float().abs())).max().item()
    err = diff.max().item()
    log(f"{what} {dtype}: max_abs_err {err:.3e}; max |got-ref| / (atol + rtol*|ref|) = "
        f"{share:.3f} (must be <= 1; atol {atol:g}, rtol {rtol:g})")
    if share > 1.0:
        raise AssertionError(f"{what} {dtype}: error {share:.3f}x its tolerance")
    return err


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_backends(fn) -> list[str]:
    """The SDPA backends that accept the call ``fn`` makes (PyTorch's
    default call takes the first of them in its priority order)."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    took = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                fn()
            torch.cuda.synchronize()
            took.append(backend.name)
        except RuntimeError:
            continue
    return took


# ---------------------------------------------------------------- K1 / K3a, K2 / K3b

# (Hq, Hkv, D) of each paged kernel's check: K1/K2 at Llama-3-8B's attention
# geometry, K3a/K3b at TinyLlama-1.1B's (head_dim 64, the folded kernels)
GEOMETRY = {"K1": (32, 8, 128), "K2": (32, 8, 128), "K3a": (32, 4, 64), "K3b": (32, 4, 64)}
# (name, query dtype, pool kind): plain pools of the query's dtype, and bf16
# queries over the int8 cache. The int8 mix is held to the bf16 limit (bf16
# output; both sides read the same codes and scales) and bounded at the bf16
# peak (its products take bf16 queries).
MIXES = (("f32", "float32", "plain"), ("bf16", "bfloat16", "plain"), ("int8", "bfloat16", "int8"))


def mix_pools(torch, k32, v32, qdt, kind):
    """(k, v, k_dense, v_dense, bytes a K/V element, bytes a row of scales):
    the pools a mix runs on, and plain pools of the same values for the SDPA
    yardstick (int8: dequantized to bf16, outside any timing)."""
    from dynamo_tpu_torch.quant.kv import QuantizedPages, dequantize_rows, quantize_kv_rows

    if kind == "plain":
        k, v = k32.to(qdt), v32.to(qdt)
        return k, v, k, v, k.element_size(), 0
    pools = []
    for x in (k32, v32):
        P, ps = x.shape[:2]
        q, s = quantize_kv_rows(x.reshape(P * ps, *x.shape[2:]))
        pools.append(QuantizedPages(q.reshape(x.shape), s.reshape(P, ps)))
    k, v = pools
    dense = [dequantize_rows(p.q, p.s, torch.bfloat16) for p in pools]
    return k, v, dense[0], dense[1], 1, 4


def check_decode(torch, dev, rng, which: str) -> dict:
    """K1 or K3a against the plain version at B 64, ps 16, ragged contexts
    1..2048, inactive slots and a row at position -1, in every mix."""
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import paged_attention as pa

    kernel = {"K1": pa.paged_decode_attention_kernel, "K3a": pa.paged_decode_attention_folded_kernel}[which]
    Hq, Hkv, D = GEOMETRY[which]
    B, ps, max_pages = 64, 16, 128
    lengths = rng.integers(1, max_pages * ps + 1, B)
    lengths[:2] = (1, max_pages * ps)
    inactive = np.zeros(B, bool)
    picked = rng.choice(np.arange(2, B), 7, replace=False)
    inactive[picked[:6]] = True
    negative = int(picked[6])  # a row at position -1: attends index 0 only
    pages_needed = [-(-int(n) // ps) for n in lengths]
    P = 1 + sum(pages_needed)
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((B, max_pages), np.int32)
    off = 0
    for b in range(B):
        pt[b, : pages_needed[b]] = perm[off : off + pages_needed[b]]
        off += pages_needed[b]
    pos = (lengths - 1).astype(np.int32)
    pt[inactive] = 0  # inactive slots: trash-page tables, position 0
    pos[inactive] = 0
    pos[negative] = -1
    live_len = np.where(inactive, 1, lengths)
    live_len[negative] = 1
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    k32 = torch.randn((P, ps, Hkv, D), device=dev)
    v32 = torch.randn((P, ps, Hkv, D), device=dev)
    q32 = torch.randn((B, Hq, D), device=dev)
    S = max_pages * ps
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(S, device=dev)[None, :] <= pos_t[:, None].long().clamp(min=0))[:, None, None, :]
    ctx_tokens = sum(-(-int(n) // ps) * ps for n in live_len)
    extra = ""
    if which == "K3a":
        blocks = sum(-(-int(n) // pa.SPLIT_ROWS) for n in live_len)
        extra = f"; {blocks} split blocks of {pa.FOLDED_THREADS} threads + {B * Hq} merge blocks"
    res = {}
    for name, qdt_name, kind in MIXES:
        qdt = getattr(torch, qdt_name)
        q = q32.to(qdt)
        k, v, kd, vd, kv_bytes, scale_bytes = mix_pools(torch, k32, v32, qdt, kind)
        got = kernel(q, k, v, pt_t, pos_t)
        ref = plain.paged_decode_attention(q, k, v, pt_t, pos_t)
        tol = "f32" if qdt == torch.float32 else "bf16"
        err = held_to_plain(f"{which} paged decode", name, got, ref, tol)
        ms = cuda_ms(lambda: kernel(q, k, v, pt_t, pos_t), 50)
        plain_ms = cuda_ms(lambda: plain.paged_decode_attention(q, k, v, pt_t, pos_t), 5)
        # yardstick only: one SDPA call on the gathered, masked context
        kc = plain.gather_pages(kd, pt_t).permute(0, 2, 1, 3).contiguous()  # [B, Hkv, S, D]
        vc = plain.gather_pages(vd, pt_t).permute(0, 2, 1, 3).contiguous()
        qs = q.to(kc.dtype)[:, :, None, :]
        lib_ms = cuda_ms(lambda: sdpa(qs, kc, vc, attn_mask=mask, enable_gqa=True), 20)
        itemsize = q.element_size()
        nbytes = (ctx_tokens * (Hkv * D * kv_bytes + scale_bytes) * 2 + 2 * q.numel() * itemsize
                  + pt.nbytes + pos.nbytes)
        flops = 4 * Hq * D * int(live_len.sum())
        b_ms, b_by = bound(nbytes, flops, tol)
        note = " (SDPA over the dequantized bf16 context, dequantization untimed)" if kind == "int8" else ""
        log(f"{which} paged decode {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms{note}, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB){extra}")
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
    return res


def check_prefill(torch, dev, rng, which: str) -> dict:
    """K2 or K3b against the plain version: three 512-row lanes in one launch
    (cached prefixes 0 and 1024, and a pad lane: n=0, all-zero table), in
    every mix."""
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import prefill_attention as pf

    kernel = {"K2": pf.paged_prefill_attention_kernel, "K3b": pf.paged_prefill_attention_folded_kernel}[which]
    Hq, Hkv, D = GEOMETRY[which]
    T, ps, max_pages = 512, 16, 128
    starts = [0, 1024, 0]  # lane 2 is a pad lane: n=0, all-zero table
    P = 1 + (512 + 1536) // ps
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((3, max_pages), np.int32)
    pt[0, : 512 // ps] = perm[: 512 // ps]
    pt[1, : 1536 // ps] = perm[512 // ps : 512 // ps + 1536 // ps]
    pos = np.stack([s + np.arange(T) for s in starts]).astype(np.int32)
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    k32 = torch.randn((P, ps, Hkv, D), device=dev)
    v32 = torch.randn((P, ps, Hkv, D), device=dev)
    q32 = torch.randn((3 * T, Hq, D), device=dev)
    S = max_pages * ps
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(S, device=dev)[None, None, :] <= pos_t[:, :, None].long())[:, None]
    # the bound counts the useful work, the two real lanes; the pad lane's
    # output is discarded (its causal pairs are reported apart)
    real = pos[:2]
    ctx_tokens = sum(int(p[-1]) + 1 for p in real)
    pairs = sum(int((p + 1).sum()) for p in real)
    pad_pairs = int((pos[2] + 1).sum())
    res = {}
    for name, qdt_name, kind in MIXES:
        qdt = getattr(torch, qdt_name)
        q = q32.to(qdt)
        k, v, kd, vd, kv_bytes, scale_bytes = mix_pools(torch, k32, v32, qdt, kind)
        got = kernel(q, k, v, pt_t, pos_t)
        ref = plain.paged_prefill_attention_lanes(q, k, v, pt_t, pos_t)
        tol = "f32" if qdt == torch.float32 else "bf16"
        err = held_to_plain(f"{which} prefill flash", name, got, ref, tol)
        ms = cuda_ms(lambda: kernel(q, k, v, pt_t, pos_t), 20)
        plain_ms = cuda_ms(lambda: plain.paged_prefill_attention_lanes(q, k, v, pt_t, pos_t), 3)
        kc = plain.gather_pages(kd, pt_t).permute(0, 2, 1, 3).contiguous()  # [3, Hkv, S, D]
        vc = plain.gather_pages(vd, pt_t).permute(0, 2, 1, 3).contiguous()
        qs = q.to(kc.dtype).reshape(3, T, Hq, D).permute(0, 2, 1, 3)
        lib_ms = cuda_ms(lambda: sdpa(qs, kc, vc, attn_mask=mask, enable_gqa=True), 10)
        itemsize = q.element_size()
        nbytes = (ctx_tokens * (Hkv * D * kv_bytes + scale_bytes) * 2 + 2 * real.size * Hq * D * itemsize
                  + pt.nbytes + pos.nbytes)
        flops = 4 * Hq * D * pairs
        b_ms, b_by = bound(nbytes, flops, tol)
        note = " (SDPA over the dequantized bf16 context, dequantization untimed)" if kind == "int8" else ""
        log(f"{which} prefill flash {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms{note}, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP in the "
            f"real lanes, pad lane {4 * Hq * D * pad_pairs / 1e9:.2f} GFLOP more)")
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
    return res


# ---------------------------------------------------------------- K5 / K6

# DeepSeek-V2-Lite's attention geometry: 16 heads, latent rows of d_c 512 +
# d_r 64. K5/K6 take f32 queries and return f32 in both page dtypes; both
# sides read the same page values, so both mixes are held to TOL["f32"]. The
# bound counts f32 FMA work at the f32 peak (the queries are f32).
MLA_H, MLA_LATENT, MLA_DC = 16, 576, 512
MLA_MIXES = (("f32", "float32"), ("bf16", "bfloat16"))


def mla_tables(rng, lengths, ps, max_pages):
    """Distinct pages per sequence (page 0 stays the trash page)."""
    need = [-(-int(n) // ps) for n in lengths]
    P = 1 + sum(need)
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((len(lengths), max_pages), np.int32)
    off = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[off : off + n]
        off += n
    return pt, P


def check_mla_decode(torch, dev, rng) -> dict:
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_decode_attention_kernel as k5

    B, H, L, dc, ps, max_pages = 16, MLA_H, MLA_LATENT, MLA_DC, 16, 128
    lengths = rng.integers(1, max_pages * ps + 1, B)
    lengths[:2] = (1, max_pages * ps)
    pt, P = mla_tables(rng, lengths, ps, max_pages)
    pos = (lengths - 1).astype(np.int32)
    picked = rng.choice(np.arange(2, B), 4, replace=False)
    pt[picked[:3]] = 0  # inactive slots: trash-page tables, position 0
    pos[picked[:3]] = 0
    pos[picked[3]] = -1  # attends row 0 only
    live = np.where(pos <= 0, 1, lengths)
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    q = torch.randn((B, H, L), device=dev) / L**0.5
    pages32 = torch.randn((P, ps, L), device=dev)
    res = {}
    for name, dt in MLA_MIXES:
        pages = pages32.to(getattr(torch, dt))
        got = k5(q, pages, pt_t, pos_t, dc)
        ref = plain.paged_mla_decode_attention(q, pages, pt_t, pos_t, dc)
        err = held_to_plain("K5 MLA decode", f"f32 q / {name} pages", got, ref, tol="f32")
        ms = cuda_ms(lambda: k5(q, pages, pt_t, pos_t, dc), 50)
        plain_ms = cuda_ms(lambda: plain.paged_mla_decode_attention(q, pages, pt_t, pos_t, dc), 5)
        # yardstick only: one SDPA call on the gathered latent context (keys
        # the 576-wide rows, values their first 512 columns, one kv head)
        S = max_pages * ps
        ctx = plain.gather_pages(pages, pt_t)[:, None]  # [B, 1, S, L]
        vc = ctx[..., :dc].contiguous()
        qs = q.to(pages.dtype)[:, :, None, :]
        mask = (torch.arange(S, device=dev)[None, :] <= pos_t[:, None].long().clamp(min=0))[:, None, None, :]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ctx, vc, attn_mask=mask, scale=1.0, enable_gqa=True)

        backends = sdpa_backends(sdpa)
        lib_ms = cuda_ms(sdpa, 10)
        nbytes = int(live.sum()) * L * pages.element_size() + q.numel() * 4 + B * H * dc * 4 + pt.nbytes + pos.nbytes
        flops = 2 * H * (L + dc) * int(live.sum())
        b_ms, b_by = bound(nbytes, flops, "f32")
        log(f"K5 MLA decode f32 q / {name} pages: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms (backends taking it: {backends}), bound {b_ms:.4f} ms ({b_by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
    return res


def check_mla_prefill(torch, dev, rng) -> dict:
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_prefill_attention_kernel as k6

    T, H, L, dc, ps, max_pages = 512, MLA_H, MLA_LATENT, MLA_DC, 16, 128
    starts = (0, 1536)  # one sequence's chunks: from 0, and after a 1536-row prefix
    pt_np, P = mla_tables(rng, [max_pages * ps], ps, max_pages)
    pt = torch.from_numpy(pt_np[0]).to(dev)
    pos = [torch.arange(s, s + T, dtype=torch.int32, device=dev) for s in starts]
    qs = [torch.randn((T, H, L), device=dev) / L**0.5 for _ in starts]
    pages32 = torch.randn((P, ps, L), device=dev)
    res = {}
    for name, dt in MLA_MIXES:
        pages = pages32.to(getattr(torch, dt))
        errs = []
        for c, s in enumerate(starts):
            got = k6(qs[c], pages, pt, pos[c], dc)
            ref = plain.paged_mla_prefill_attention(qs[c], pages, pt, pos[c], dc)
            errs.append(held_to_plain(f"K6 MLA prefill (prefix {s})", f"f32 q / {name} pages", got, ref, tol="f32"))
        ms = cuda_ms(lambda: [k6(qs[c], pages, pt, pos[c], dc) for c in range(2)], 20)
        plain_ms = cuda_ms(lambda: [plain.paged_mla_prefill_attention(qs[c], pages, pt, pos[c], dc)
                                    for c in range(2)], 3)
        S = max_pages * ps
        ctx = plain.gather_pages(pages, pt)[None, None]  # [1, 1, S, L]
        vc = ctx[..., :dc].contiguous()
        q4 = [q.to(pages.dtype).permute(1, 0, 2)[None] for q in qs]  # [1, H, T, L]
        masks = [(torch.arange(S, device=dev)[None, :] <= p[:, None].long())[None, None] for p in pos]

        def sdpa():
            return [torch.nn.functional.scaled_dot_product_attention(
                q4[c], ctx, vc, attn_mask=masks[c], scale=1.0, enable_gqa=True) for c in range(2)]

        backends = sdpa_backends(sdpa)
        lib_ms = cuda_ms(sdpa, 5)
        rows = sum(s + T for s in starts)  # context rows each chunk reads
        pairs = sum(int((p.long() + 1).sum()) for p in pos)
        nbytes = rows * L * pages.element_size() + 2 * T * H * (L + dc) * 4 + 2 * (pt_np[0].nbytes + T * 4)
        flops = 2 * H * (L + dc) * pairs
        b_ms, b_by = bound(nbytes, flops, "f32")
        log(f"K6 MLA prefill f32 q / {name} pages (both chunks): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (backends taking it: {backends}), bound "
            f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP)")
        res[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
    return res


def phase_refusals(torch, dev) -> None:
    """What the port does not take raises on the card and falls back to
    nothing: an int8 cache on the MLA family, and K3a/K3b launches on a head
    dim or query dtype they do not take."""
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.ops import attention as att

    pt = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    cases = {
        "tiny-mla with an int8 KV cache": lambda: load_model("tiny-mla", device="cuda", kv_cache_dtype="int8"),
        "K3a at head_dim 96": lambda: att.dispatch_paged_decode_attention(
            torch.zeros((2, 8, 96), device=dev), *[torch.zeros((5, 16, 2, 96), device=dev)] * 2, pt, pos),
        "K3b over float16": lambda: att.dispatch_paged_prefill_attention(
            torch.zeros((16, 32, 64), device=dev, dtype=torch.float16),
            *[torch.zeros((5, 16, 4, 64), device=dev, dtype=torch.float16)] * 2, pt[0], pos.repeat(8)),
    }
    for what, call in cases.items():
        try:
            call()
        except ValueError as e:
            log(f"refused on the card: {what} ({e})")
            continue
        raise AssertionError(f"{what} did not raise")


# ---------------------------------------------------------------- engine


async def serve(config, requests, model=None):
    """Run ``requests`` concurrently through a fresh AsyncTorchEngine; returns
    ({rid: (tokens, finish_reason, ttft_s)}, wall_s)."""
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine

    engine = AsyncTorchEngine(config, model=model)
    await engine.start()

    async def one(req):
        t0 = time.monotonic()
        toks, reason, ttft = [], None, None
        async for out in engine.generate(req):
            if out.token is not None:
                if ttft is None:
                    ttft = time.monotonic() - t0
                toks.append(out.token)
            reason = out.finish_reason
        return req.request_id, (toks, reason, ttft)

    try:
        t0 = time.monotonic()
        results = dict(await asyncio.gather(*(one(r) for r in requests)))
        wall = time.monotonic() - t0
    finally:
        await engine.shutdown()
    return results, wall, engine


def phase_serve(torch, gpu_name: str, what: str, config, requests, kernels: dict,
                forbidden: dict | None = None) -> dict:
    """Serve ``requests`` on ``config``; every stream must end with exactly
    MAX_TOKENS tokens, each of ``kernels`` ({name: launcher}) must have
    launched and none of ``forbidden``; an int8 config must have served from
    int8 pools. Returns {name: launches in this run}."""
    from dynamo_tpu_torch.quant.kv import QuantizedPages
    from dynamo_tpu_torch.tools.workload import MAX_TOKENS as max_tokens

    forbidden = forbidden or {}
    lens = np.array([len(r.token_ids) for r in requests])
    for fn in (*kernels.values(), *forbidden.values()):
        fn.launches = 0
    results, wall, engine = asyncio.run(serve(config, requests))
    launches = {name: fn.launches for name, fn in kernels.items()}
    stray = {name: fn.launches for name, fn in forbidden.items() if fn.launches}
    for rid, (toks, reason, _) in results.items():
        if len(toks) != max_tokens or reason != "length":
            raise AssertionError(f"{what} {rid}: {len(toks)} tokens, finish {reason!r} (want {max_tokens}, 'length')")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{what}: main path skipped a kernel: launches {launches}")
    if stray:
        raise AssertionError(f"{what}: kernels off this path launched: {stray}")
    quantized = any(isinstance(pool, QuantizedPages) for pool in engine.runner.kv_cache.values())
    if quantized != (config.kv_cache_dtype == "int8"):
        raise AssertionError(f"{what}: kv_cache_dtype {config.kv_cache_dtype!r} but int8 pools: {quantized}")
    n_out = sum(len(t) for t, _, _ in results.values())
    ttfts = sorted(t for _, _, t in results.values())
    log(f"{what}: {len(results)}/{len(requests)} streams finished with {max_tokens} tokens; prompts "
        f"{int(lens.min())}-{int(lens.max())} (sum {int(lens.sum())}); KV cache "
        f"{'int8' if quantized else 'bf16'}; launches " + " ".join(f"{k} {v}" for k, v in launches.items())
        + (" (none of " + ", ".join(forbidden) + ")" if forbidden else ""))
    log(f"{what} [{gpu_name}]: {n_out / wall:.1f} output tok/s, "
        f"{(n_out + int(lens.sum())) / wall:.1f} total tok/s, wall {wall:.2f} s, "
        f"TTFT p50 {np.median(ttfts) * 1e3:.1f} ms, max {ttfts[-1] * 1e3:.1f} ms")
    # after the last first token only decode windows run: the decode rate
    n_after = n_out - len(results)
    log(f"{what} decode phase [{gpu_name}]: {n_after / (wall - ttfts[-1]):.1f} tok/s over "
        f"{wall - ttfts[-1]:.3f} s ({n_after} tokens, batch {len(results)})")
    del engine
    torch.cuda.empty_cache()
    return launches


def naive_greedy(torch, model, prompt: list[int], steps: int) -> list[int]:
    """Dense no-paging forward (attention_with_positions on the whole
    sequence, recomputed every step) on the model's own weights. With an int8
    KV cache in the model's config, every K/V row goes through the port's
    quantize_kv_rows and back before it is attended, as the pool stores it."""
    from dynamo_tpu_torch.ops.attention import attention_with_positions
    from dynamo_tpu_torch.ops.norms import rms_norm
    from dynamo_tpu_torch.ops.rotary import apply_rope
    from dynamo_tpu_torch.quant.kv import dequantize_rows, quantize_kv_rows

    c = model.config
    toks = list(prompt)
    out = []
    with torch.no_grad():
        for _ in range(steps):
            ids = torch.tensor(toks, device=model.device)
            pos = torch.arange(len(toks), device=model.device, dtype=torch.int32)
            h = model.embed[ids]
            for lp in model.layers:
                x = rms_norm(h, lp.input_norm, c.rms_norm_eps)
                q = apply_rope((x @ lp.wq).reshape(len(toks), -1, c.head_dim), pos, c.rope_theta)
                k = apply_rope((x @ lp.wk).reshape(len(toks), -1, c.head_dim), pos, c.rope_theta)
                v = (x @ lp.wv).reshape(len(toks), -1, c.head_dim)
                if c.kv_quantized:
                    k = dequantize_rows(*quantize_kv_rows(k))
                    v = dequantize_rows(*quantize_kv_rows(v))
                h = h + attention_with_positions(q, k, v, pos).reshape(len(toks), -1) @ lp.wo
                x = rms_norm(h, lp.post_norm, c.rms_norm_eps)
                h = h + (torch.nn.functional.silu(x @ lp.gate) * (x @ lp.up)) @ lp.down
            nxt = int(model._unembed(h[-1:]).argmax(dim=-1)[0])
            toks.append(nxt)
            out.append(nxt)
    return out


def phase_engine_vs_naive(torch, rng, what: str, geometry: dict, kv_cache_dtype: str | None = None) -> None:
    """``geometry`` at 2 layers in f32: the engine's greedy tokens (3
    requests x 16) must equal naive_greedy's."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.models.registry import load_model

    steps = 16
    cfg = dict(geometry, num_layers=2, dtype="f32")
    config = EngineConfig(
        model_id="tiny:" + json.dumps(cfg), device="cuda", page_size=16, num_pages=256,
        max_seqs=4, max_model_len=1024, decode_steps=4, kv_cache_dtype=kv_cache_dtype,
    )
    model = load_model(config.model_id, device="cuda", kv_cache_dtype=kv_cache_dtype)
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist() for n in (100, 37, 600)]
    requests = [
        EngineRequest(f"naive-{i}", p, SamplingParams(temperature=0.0, max_tokens=steps))
        for i, p in enumerate(prompts)
    ]
    results, _, _ = asyncio.run(serve(config, requests, model=model))
    for i, p in enumerate(prompts):
        got = results[f"naive-{i}"][0]
        want = naive_greedy(torch, model, p, steps)
        if got != want:
            raise AssertionError(f"{what} request {i}: engine {got} != naive {want}")
    log(f"{what} engine vs naive forward (2 layers, f32, {kv_cache_dtype or 'f32'} KV): "
        f"{len(prompts)} requests x {steps} greedy tokens identical")
    del model
    torch.cuda.empty_cache()


def mla_naive_logits(torch, model, toks: list[int]):
    """Last-row logits of a dense NON-absorbed MLA forward on the model's own
    weights (tests/test_deepseek_mla.py's naive_forward in torch): per-head
    K = [W_kb c ; k_rope] and V = W_vb c materialized from the latents,
    standard causal attention, and each routed expert run on the tokens
    whose top-k chose it (no capacity, no dispatch slots)."""
    from dynamo_tpu_torch.ops.norms import rms_norm
    from dynamo_tpu_torch.ops.rotary import apply_rope

    c = model.config
    T, H = len(toks), c.num_heads
    dn, dr, dc = c.qk_nope_head_dim, c.qk_rope_head_dim, c.kv_lora_rank
    dev = model.device
    pos = torch.arange(T, device=dev, dtype=torch.int32)
    silu = torch.nn.functional.silu
    h = model.embed[torch.tensor(toks, device=dev)]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    for lp in model.layers():
        x = rms_norm(h, lp.input_norm, c.rms_norm_eps)
        if c.q_lora_rank:
            x_q = rms_norm(x @ lp.w_dq, lp.q_norm, c.rms_norm_eps) @ lp.w_uq
        else:
            x_q = x @ lp.w_q
        q = x_q.reshape(T, H, dn + dr)
        q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], pos, c.rope_theta)], dim=-1)
        ckv = x @ lp.w_dkv
        latent = rms_norm(ckv[:, :dc], lp.kv_norm, c.rms_norm_eps)
        k_rope = apply_rope(ckv[:, None, dc:], pos, c.rope_theta)
        k = torch.cat([torch.einsum("sc,chn->shn", latent, lp.w_kb), k_rope.expand(T, H, dr)], dim=-1)
        v = torch.einsum("sc,chv->shv", latent, lp.w_vb)
        s = torch.einsum("thd,shd->hts", q.float(), k.float()) / (dn + dr) ** 0.5
        s = torch.where(causal[None], s, -1e30)
        a = torch.einsum("hts,shv->thv", torch.softmax(s, -1), v.float()).to(c.dtype)
        h = h + a.reshape(T, -1) @ lp.wo
        x = rms_norm(h, lp.post_norm, c.rms_norm_eps)
        if lp.moe:
            probs = torch.softmax(x.float() @ lp.router.float(), dim=-1)
            top_w, top_i = torch.topk(probs, c.num_experts_per_tok, dim=-1)
            if c.norm_topk_prob:
                top_w = top_w / top_w.sum(-1, keepdim=True)
            routed = torch.zeros_like(h, dtype=torch.float32)
            for e in range(c.n_routed_experts):
                chose = top_i == e  # [T, K]
                rows = chose.any(-1).nonzero()[:, 0]
                if rows.numel():
                    xe = x[rows]
                    y = (silu(xe @ lp.w_gate[e]) * (xe @ lp.w_up[e])) @ lp.w_down[e]
                    routed[rows] += (top_w * chose).sum(-1)[rows, None] * y.float()
            shared = (silu(x @ lp.shared_gate) * (x @ lp.shared_up)) @ lp.shared_down
            h = h + shared + c.routed_scaling_factor * routed.to(c.dtype)
        else:
            h = h + (silu(x @ lp.gate) * (x @ lp.up)) @ lp.down
    return model._unembed(h[-1:])[0]


def phase_mla_vs_naive(torch, rng) -> None:
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.workload import DEEPSEEK_V2_LITE

    steps = 16
    # capacity factor 11 >= E/K = 64/6: every expert holds every token, so
    # nothing drops whatever the batch, and the capacity dispatch equals the
    # plain top-k mixture
    cfg = dict(DEEPSEEK_V2_LITE, num_layers=2, dtype="f32", moe_capacity_factor=11.0)
    config = EngineConfig(
        model_id="tiny-mla:" + json.dumps(cfg), device="cuda",
        page_size=16, num_pages=256, max_seqs=4, max_model_len=1024, decode_steps=4,
    )
    model = load_model(config.model_id, device="cuda")
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist() for n in (100, 37, 600)]
    requests = [
        EngineRequest(f"mla-naive-{i}", p, SamplingParams(temperature=0.0, max_tokens=steps))
        for i, p in enumerate(prompts)
    ]
    results, _, _ = asyncio.run(serve(config, requests, model=model))
    with torch.no_grad():
        for i, p in enumerate(prompts):
            got = results[f"mla-naive-{i}"][0]
            want, toks = [], list(p)
            for _ in range(steps):
                want.append(int(mla_naive_logits(torch, model, toks).argmax()))
                toks.append(want[-1])
            if got != want:
                raise AssertionError(f"MLA request {i}: engine {got} != naive {want}")
    log(f"MLA engine vs naive non-absorbed forward (2 layers, f32, capacity factor 11): "
        f"{len(prompts)} requests x {steps} greedy tokens identical")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "dynamo_tpu_torch").is_dir():
        print(f"chip_smoke: no dynamo_tpu_torch package next to {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    t_start = time.monotonic()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gpu_name = torch.cuda.get_device_name(0)

    from dynamo_tpu_torch.ops.kernels import _build
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_decode_attention_kernel as k5
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_prefill_attention_kernel as k6
    from dynamo_tpu_torch.ops.kernels.paged_attention import paged_decode_attention_folded_kernel as k3a
    from dynamo_tpu_torch.ops.kernels.paged_attention import paged_decode_attention_kernel as k1
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention_folded_kernel as k3b
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention_kernel as k2
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

    t0 = time.monotonic()
    _build.build(["paged_attention", "prefill_attention", "mla_attention"])
    log(f"build: three kernel sources in {time.monotonic() - t0:.1f} s")

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    checks = {name: check_decode(torch, dev, rng, name) for name in ("K1", "K3a")}
    checks |= {name: check_prefill(torch, dev, rng, name) for name in ("K2", "K3b")}
    checks["K5"] = check_mla_decode(torch, dev, rng)
    checks["K6"] = check_mla_prefill(torch, dev, rng)
    # each serve path runs with the counts set to 0 just before it and read
    # just after it: {path: {kernel: launches}}
    paged, folded = {"K1": k1, "K2": k2}, {"K3a": k3a, "K3b": k3b}
    runs = {
        "serve": phase_serve(torch, smi, "serve", serve_config(), serve_requests(), paged, folded),
        "int8 serve": phase_serve(torch, smi, "int8 serve", serve_config("int8"), serve_requests(), paged,
                                  folded),
        "MLA serve": phase_serve(torch, smi, "MLA serve", mla_serve_config(),
                                 serve_requests(DEEPSEEK_V2_LITE["vocab_size"]), {"K5": k5, "K6": k6}),
        "folded serve": phase_serve(torch, smi, "folded serve", folded_serve_config(), folded_serve_requests(),
                                    folded, paged),
        "folded int8 serve": phase_serve(torch, smi, "folded int8 serve", folded_serve_config("int8"),
                                         folded_serve_requests(), folded, paged),
    }
    phase_refusals(torch, dev)
    phase_engine_vs_naive(torch, rng, "Llama-3-8B geometry", LLAMA3_8B)
    phase_engine_vs_naive(torch, rng, "TinyLlama geometry", TINYLLAMA_1_1B)
    phase_engine_vs_naive(torch, rng, "TinyLlama geometry", TINYLLAMA_1_1B, kv_cache_dtype="int8")
    phase_mla_vs_naive(torch, rng)

    csrc = "dynamo_tpu_torch/ops/kernels/csrc/"
    pallas = "dynamo_tpu/ops/pallas/"
    # name, check, source, the TPU kernel, the serve path of its bf16 numbers,
    # the serve path of its int8 numbers (None: the kernel takes no int8)
    table = (
        ("paged_decode_attention", "K1", "paged_attention.cu", "paged_attention.py:536", "serve", "int8 serve"),
        ("paged_prefill_attention", "K2", "prefill_attention.cu", "prefill_attention.py:686", "serve",
         "int8 serve"),
        ("paged_decode_attention_folded", "K3a", "paged_attention.cu", "paged_attention.py:741",
         "folded serve", "folded int8 serve"),
        ("paged_prefill_attention_folded", "K3b", "prefill_attention.cu", "prefill_attention.py:615",
         "folded serve", "folded int8 serve"),
        ("paged_mla_decode_attention", "K5", "mla_attention.cu", "mla_attention.py:221", "MLA serve", None),
        ("paged_mla_prefill_attention", "K6", "mla_attention.cu", "mla_attention.py:396", "MLA serve", None),
    )
    kernels = []
    for name, key, src, tpu, path, int8_path in table:
        entry = dict(name=name, route="cuda", source=csrc + src, replaces=pallas + tpu,
                     launches=runs[path][key], **checks[key]["bf16"])
        if int8_path:
            entry["int8"] = dict(launches=runs[int8_path][key], **checks[key]["int8"])
        kernels.append(entry)
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": gpu_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
