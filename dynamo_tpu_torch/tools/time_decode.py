"""The attention launchers timed three ways, for an A/B of two trees on one
card: K1 (bf16, int8 and f32), K3a (bf16 and int8, at batch 64 and at the
serve engine's 16), K4a, K4b and K7c's two toggles (bf16, at K1's check
geometry and at the reference bench's G 2 / page 128), K1's bf16 body at
each split size ``k1_split_rows`` chooses from (``SPLIT_SHAPES``), K5 (MLA
decode over bf16 and over f32 pages at chip_smoke.py's check shape, and its
tensor-core body at each candidate split length, ``MLA_SPLIT_SHAPES``) and
K6 (MLA prefill over bf16 pages at chip_smoke.py's check shape), each beside
one SDPA call over the same context, with ``tools/timing.py
launch_times``: device time (the host's enqueueing hidden behind a sleep
kernel), back-to-back time (the host's enqueueing counts where it is the
longer) and the host's time to enqueue one call.

    python -m dynamo_tpu_torch.tools.time_decode

The decode inputs are chip_smoke.py's decode check shapes unless a case
says otherwise: batch 64, contexts 1..2048 rows in distinct pages, every
case drawn from seed 0 (so cases of one shape, K1, K4a and K4b at K1's,
read the same inputs), bf16 queries and pools (int8: the pools quantized by
row, SDPA over their bf16 dequantization; f32: f32 queries and pools, SDPA
in f32). K5's are its check shape: batch 16 of DeepSeek-V2-Lite's 16 heads
over latent rows of 576 (d_c 512), contexts 1..2048 rows in distinct pages
of 16, three inactive slots (trash tables, position 0) and a row at -1, f32
pre-scaled queries; SDPA takes the queries in the pages' dtype over the
gathered context, one kv head, values its first 512 columns. K6's are its
check shape: DeepSeek-V2-Lite's 16 heads,
latent rows of 576 (d_c 512), two 512-row chunks of one sequence at
prefixes 0 and 1536, f32 pre-scaled queries over bf16 pages, both chunks a
call; SDPA takes the bf16 queries over the gathered context with the causal
mask (its math backend: no fused one takes these shapes).
K8, the weight-only int8 linear (``int8_linear_kernel``,
``int8_linear_expert_kernel``): Llama-3-8B's seven products at T 16, 512
and 2048 and DeepSeek-V2-Lite's expert bank [64, C, 2048] x [64, 2048,
1408] at C 3 and 96 (chip_smoke.py's K8_LLAMA and K8_EXPERTS), bf16, each
beside ``torch.matmul`` over the dequantized bf16 weight; at T 16 and C 3
also cold (each call reads another copy of the weight, the copies together
past the 50 MB L2, as a decode step reads each layer's weights).

    python -m dynamo_tpu_torch.tools.time_decode k8    # the K8 cases alone

To time another tree's launchers on the same inputs, copy this file and
``tools/timing.py`` into that tree's ``dynamo_tpu_torch/tools/`` and run it
there: it calls the launchers by their public names, which are the same in
every tree since K4b was ported (K8's since it was written). Prints one JSON line.
Needs one CUDA device.
"""

from __future__ import annotations

import functools
import json
import sys

import numpy as np
import torch

from dynamo_tpu_torch.ops.attention import gather_pages
from dynamo_tpu_torch.ops.kernels import paged_attention as pa
from dynamo_tpu_torch.ops.kernels import mla_attention as mla
from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_prefill_attention_kernel
from dynamo_tpu_torch.quant.kv import QuantizedPages, dequantize_rows, quantize_kv_rows
from dynamo_tpu_torch.tools.timing import card, device_us, launch_times

B, ROWS, ITERS = 64, 2048, 50
K7C = functools.partial(pa.paged_decode_perseq_variant_kernel, cast_f32=False)
K7C_CAST = functools.partial(pa.paged_decode_perseq_variant_kernel, cast_f32=True)


def case(launcher, Hq: int, Hkv: int, D: int, ps: int, pools: str, batch: int = B, rows: int = ROWS,
         full: bool = False) -> tuple:
    """A case: the launcher, its geometry, pools ("bf16", "int8" or "f32"),
    the batch, the table's capacity in rows, and whether every context
    fills it (else contexts 1..rows)."""
    return launcher, Hq, Hkv, D, ps, pools, batch, rows, full


CASES = {
    "K1 bf16": case(pa.paged_decode_attention_kernel, 32, 8, 128, 16, "bf16"),
    "K1 int8": case(pa.paged_decode_attention_kernel, 32, 8, 128, 16, "int8"),
    "K1 f32": case(pa.paged_decode_attention_kernel, 32, 8, 128, 16, "f32"),
    "K3a bf16": case(pa.paged_decode_attention_folded_kernel, 32, 4, 64, 16, "bf16"),
    "K3a int8": case(pa.paged_decode_attention_folded_kernel, 32, 4, 64, 16, "int8"),
    "K3a bf16 B 16": case(pa.paged_decode_attention_folded_kernel, 32, 4, 64, 16, "bf16", 16),
    "K3a int8 B 16": case(pa.paged_decode_attention_folded_kernel, 32, 4, 64, 16, "int8", 16),
    "K4b bf16": case(pa.paged_decode_attention_grouped_kernel, 32, 8, 128, 16, "bf16"),
    "K4b bf16 G2 ps128": case(pa.paged_decode_attention_grouped_kernel, 16, 8, 128, 128, "bf16"),
    "K4a bf16": case(pa.paged_decode_attention_chunked_kernel, 32, 8, 128, 16, "bf16"),
    "K4a bf16 G2 ps128": case(pa.paged_decode_attention_chunked_kernel, 16, 8, 128, 128, "bf16"),
    "K7c bf16": case(K7C, 32, 8, 128, 16, "bf16"),
    "K7c cast_f32 bf16": case(K7C_CAST, 32, 8, 128, 16, "bf16"),
    "K7c bf16 G2 ps128": case(K7C, 16, 8, 128, 128, "bf16"),
    "K7c cast_f32 bf16 G2 ps128": case(K7C_CAST, 16, 8, 128, 128, "bf16"),
}


def k1_at_split(rows: int):
    """K1's bf16 launch at a fixed split of ``rows`` context rows, in place
    of ``k1_split_rows``' choice: the split sizes the rule picks between."""
    def launch(q, k, v, page_tables, positions):
        return pa._split_launch("paged_decode_attention", q, (k, v, None, None, pa.Q_DTYPES[q.dtype]),
                                page_tables, positions, rows)
    return launch


# K1's bf16 body at each split size: K1's geometry at batch 64 and 16 over
# contexts 1..2048, at batch 8, 4 and 1 with every context 2048 rows, at
# batch 64 in a 256-row table; K3a's TinyLlama geometry at batch 16 and 64
SPLIT_SHAPES = {"B 64": (32, 8, 128, 64, ROWS, False), "B 16": (32, 8, 128, 16, ROWS, False),
                "B 8 full": (32, 8, 128, 8, ROWS, True), "B 4 full": (32, 8, 128, 4, ROWS, True),
                "B 1 full": (32, 8, 128, 1, ROWS, True), "B 64 table 256": (32, 8, 128, 64, 256, False),
                "K3a's shape B 16": (32, 4, 64, 16, ROWS, False),
                "K3a's shape B 64": (32, 4, 64, 64, ROWS, False)}
if hasattr(pa, "K1_SPLIT_CHOICES"):  # trees since K1's split body
    for shape, (Hq, Hkv, D, batch, rows, full) in SPLIT_SHAPES.items():
        for split in pa.K1_SPLIT_CHOICES:
            CASES[f"K1 bf16 {shape} split {split}"] = case(k1_at_split(split), Hq, Hkv, D, 16, "bf16", batch,
                                                           rows, full)
# K6's check shape: (T, H, latent, d_c, page size, prefixes)
MLA_PREFILL = (512, 16, 576, 512, 16, (0, 1536))
# K5's: (batch, H, latent, d_c, page size, table rows, every context full)
MLA_DECODE = (16, 16, 576, 512, 16, 2048, False)
# K5's tensor-core body at each candidate split length: the check (and
# serve) shape, batch 4 and 1 with every context 2048 rows, batch 16 in a
# 256-row table
MLA_SPLIT_SHAPES = {"B 16": (16, 2048, False), "B 4 full": (4, 2048, True), "B 1 full": (1, 2048, True),
                    "B 16 table 256": (16, 256, False)}
MLA_SPLIT_CHOICES = (64, 128, 256)


def case_inputs(rng, Hq: int, Hkv: int, D: int, ps: int, pools: str, dev, B: int = B, rows: int = ROWS,
                full: bool = False) -> dict:
    """Queries, pools (bf16, f32 or int8 QuantizedPages), tables, positions,
    and the dense context (bf16; f32 for f32 pools) and mask SDPA reads."""
    max_pages = rows // ps
    lengths = np.full(B, rows) if full else rng.integers(1, rows + 1, B)
    need = [-(-int(n) // ps) for n in lengths]
    P = 1 + sum(need)
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((B, max_pages), np.int32)
    off = 0
    for b in range(B):
        pt[b, : need[b]] = perm[off : off + need[b]]
        off += need[b]
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    k32, v32 = (torch.randn((P, ps, Hkv, D), device=dev, generator=gen) for _ in range(2))
    q = torch.randn((B, Hq, D), device=dev, generator=gen)
    q = q if pools == "f32" else q.bfloat16()
    if pools == "f32":
        k, v = kd, vd = k32, v32
    elif pools == "int8":
        qs = [quantize_kv_rows(x.reshape(P * ps, Hkv, D)) for x in (k32, v32)]
        k, v = (QuantizedPages(c.reshape(P, ps, Hkv, D), s.reshape(P, ps)) for c, s in qs)
        kd, vd = (dequantize_rows(p.q, p.s, torch.bfloat16) for p in (k, v))
    else:
        k, v = kd, vd = k32.bfloat16(), v32.bfloat16()
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy((lengths - 1).astype(np.int32)).to(dev)
    return dict(
        q=q, k=k, v=v, pt=pt_t, pos=pos_t,
        kc=gather_pages(kd, pt_t).permute(0, 2, 1, 3).contiguous(),  # [B, Hkv, S, D]
        vc=gather_pages(vd, pt_t).permute(0, 2, 1, 3).contiguous(),
        mask=(torch.arange(max_pages * ps, device=dev)[None, :] <= pos_t[:, None].long())[:, None, None, :],
    )


def mla_prefill_inputs(rng, dev) -> dict:
    """K6's check inputs: one sequence's table of distinct pages, two
    chunks' f32 pre-scaled queries and positions, bf16 pages, and SDPA's
    bf16 queries, gathered context and causal masks."""
    T, H, L, dc, ps, starts = MLA_PREFILL
    max_pages = (starts[-1] + T) // ps
    P = 1 + max_pages
    pt = torch.from_numpy((1 + rng.permutation(max_pages)).astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    qs = [torch.randn((T, H, L), device=dev, generator=gen) / L**0.5 for _ in starts]
    pages = torch.randn((P, ps, L), device=dev, generator=gen).bfloat16()
    pos = [torch.arange(s, s + T, dtype=torch.int32, device=dev) for s in starts]
    ctx = gather_pages(pages, pt)[None, None]  # [1, 1, S, L]
    S = ctx.shape[2]
    return dict(
        qs=qs, pages=pages, pt=pt, pos=pos, dc=dc, ctx=ctx, vc=ctx[..., :dc].contiguous(),
        q4=[q.bfloat16().permute(1, 0, 2)[None] for q in qs],  # [1, H, T, L]
        masks=[(torch.arange(S, device=dev)[None, :] <= p[:, None].long())[None, None] for p in pos],
    )


def mla_decode_inputs(rng, dev, pages_dtype, batch: int, rows: int, full: bool) -> dict:
    """K5's inputs at chip_smoke.py's check shape (``MLA_DECODE``, with
    ``batch`` sequences in a table of ``rows`` rows, contexts 1..rows or
    all ``rows`` long): distinct pages, three inactive slots and a row at -1
    (batch 16), f32 pre-scaled queries, and
    SDPA's queries, gathered context, values and mask."""
    _, H, L, dc, ps, _, _ = MLA_DECODE
    max_pages = rows // ps
    lengths = np.full(batch, rows) if full else rng.integers(1, rows + 1, batch)
    if not full:
        lengths[: min(batch, 2)] = (1, rows)[: min(batch, 2)]
    need = [-(-int(n) // ps) for n in lengths]
    P = 1 + sum(need)
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((batch, max_pages), np.int32)
    off = 0
    for b in range(batch):
        pt[b, : need[b]] = perm[off : off + need[b]]
        off += need[b]
    pos = (lengths - 1).astype(np.int32)
    if batch >= 10:
        pt[[3, 5, 7]] = 0  # inactive slots: trash tables, position 0
        pos[[3, 5, 7]] = 0
        pos[9] = -1  # attends row 0 only
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    q = torch.randn((batch, H, L), device=dev, generator=gen) / L**0.5
    pages = torch.randn((P, ps, L), device=dev, generator=gen).to(pages_dtype)
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    ctx = gather_pages(pages, pt_t)[:, None]  # [B, 1, S, L]
    return dict(q=q, pages=pages, pt=pt_t, pos=pos_t, dc=dc, ctx=ctx, vc=ctx[..., :dc].contiguous(),
                qs=q.to(pages_dtype)[:, :, None, :],
                mask=(torch.arange(rows, device=dev)[None, :] <= pos_t[:, None].long().clamp(min=0))[:, None, None, :])


# K8's shapes, as chip_smoke.py's: Llama-3-8B's products (in, out), the
# row counts of a 16-slot decode step and of 512- and 2048-row prefill
# calls, and DeepSeek-V2-Lite's gate / up expert bank (E, C, in, out)
K8_LLAMA = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
            "gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
K8_ROWS = (16, 512, 2048)
K8_EXPERTS = {"E64 C3": (64, 3, 2048, 1408), "E64 C96": (64, 96, 2048, 1408)}
L2_BYTES = 50 * 2**20


def k8_cases(dev) -> dict:
    """K8 and torch.matmul over the dequantized bf16 weight at K8's shapes,
    inputs from a seeded generator (the same in every tree); at decode
    sizes also cold: one copy of the weight a call, the copies past the
    L2."""
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_expert_kernel, int8_linear_kernel
    from dynamo_tpu_torch.quant.int8 import dequantize_int8, quantize_int8

    shapes = [(f"K8 {name} T{T}", int8_linear_kernel, (T,), K, N) for name, (K, N) in K8_LLAMA.items()
              for T in K8_ROWS]
    shapes += [(f"K8 experts {key}", int8_linear_expert_kernel, (E, C), K, N)
               for key, (E, C, K, N) in K8_EXPERTS.items()]
    res = {}
    for name, kernel, lead, K, N in shapes:
        gen = torch.Generator(device=dev).manual_seed(K + N + lead[-1])
        qw = quantize_int8(torch.randn((*lead[:-1], K, N), device=dev, generator=gen) / K**0.5)
        h = torch.randn((*lead, K), device=dev, generator=gen).bfloat16()
        wb = dequantize_int8(qw, torch.bfloat16)
        q, s = qw.q, qw.s
        row = {"kernel": times(lambda: kernel(h, q, s)), "matmul": times(lambda: torch.matmul(h, wb))}
        if lead[-1] <= 16:
            qs = [q] + [q.clone() for _ in range(L2_BYTES // q.numel() + 1)]
            wbs = [wb] + [wb.clone() for _ in range(L2_BYTES // (2 * wb.numel()) + 1)]
            row["kernel cold"] = {"ms": device_us(lambda i: kernel(h, qs[i % len(qs)], s), ITERS) / 1e3}
            row["matmul cold"] = {"ms": device_us(lambda i: torch.matmul(h, wbs[i % len(wbs)]), ITERS) / 1e3}
            del qs, wbs
        res[name] = row
        print(f"{name}: {row}", flush=True)
        del qw, h, wb, q, s
        torch.cuda.empty_cache()
    return res


def times(launch, iters: int = ITERS) -> dict:
    dev_us, b2b_us, host_us = launch_times(lambda i: launch(), iters)
    return {"ms": dev_us / 1e3, "b2b_ms": b2b_us / 1e3, "host_ms": host_us / 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_decode needs a CUDA device")
    dev = torch.device("cuda", 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {"device": card()}
    res |= k8_cases(dev)
    if sys.argv[1:2] == ["k8"]:
        print(json.dumps(res), flush=True)
        return 0
    for name, (launcher, Hq, Hkv, D, ps, pools, batch, rows, full) in CASES.items():
        x = case_inputs(np.random.default_rng(0), Hq, Hkv, D, ps, pools, dev, batch, rows, full)
        qs = x["q"][:, :, None, :]
        kernel = times(lambda: launcher(x["q"], x["k"], x["v"], x["pt"], x["pos"]))
        library = times(lambda: sdpa(qs, x["kc"], x["vc"], attn_mask=x["mask"], enable_gqa=True))
        res[name] = {"kernel": kernel, "sdpa": library}
        print(f"{name}: kernel {kernel}, sdpa {library}", flush=True)
    batch, _, _, _, _, rows, full = MLA_DECODE
    for name, dt in (("K5 bf16", torch.bfloat16), ("K5 f32", torch.float32)):
        x = mla_decode_inputs(np.random.default_rng(0), dev, dt, batch, rows, full)
        kernel = times(lambda: mla.paged_mla_decode_attention_kernel(x["q"], x["pages"], x["pt"], x["pos"], x["dc"]))
        library = times(lambda: sdpa(x["qs"], x["ctx"], x["vc"], attn_mask=x["mask"], scale=1.0, enable_gqa=True), 10)
        res[name] = {"kernel": kernel, "sdpa": library}
        print(f"{name}: kernel {kernel}, sdpa {library}", flush=True)
    if hasattr(mla, "TC_SPLIT_CHOICES"):  # trees since K5's tensor-core body
        for shape, (batch, rows, full) in MLA_SPLIT_SHAPES.items():
            x = mla_decode_inputs(np.random.default_rng(0), dev, torch.bfloat16, batch, rows, full)
            for split in MLA_SPLIT_CHOICES:
                kernel = times(lambda: mla._decode_launch(x["q"], x["pages"], x["pt"], x["pos"], x["dc"], split))
                res[f"K5 bf16 {shape} split {split}"] = {"kernel": kernel}
                print(f"K5 bf16 {shape} split {split}: kernel {kernel}", flush=True)
    x = mla_prefill_inputs(np.random.default_rng(0), dev)
    k6 = paged_mla_prefill_attention_kernel
    # 20 and 5 calls, as chip_smoke.py times K6 and SDPA: SDPA-math's host
    # enqueueing of 50 calls outlasts the timer's sleep
    kernel = times(lambda: [k6(q, x["pages"], x["pt"], p, x["dc"]) for q, p in zip(x["qs"], x["pos"])], 20)
    library = times(lambda: [sdpa(q, x["ctx"], x["vc"], attn_mask=m, scale=1.0, enable_gqa=True)
                             for q, m in zip(x["q4"], x["masks"])], 5)
    res["K6 bf16"] = {"kernel": kernel, "sdpa": library}
    print(f"K6 bf16: kernel {kernel}, sdpa {library}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
