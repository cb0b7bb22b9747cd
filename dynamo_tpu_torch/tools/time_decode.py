"""The attention launchers timed three ways, for an A/B of two trees on one
card: K1, K3a (bf16 and int8), K4a and K4b (bf16, at K1's check geometry and
at the reference bench's G 2 / page 128), and K6 (MLA prefill over bf16
pages at chip_smoke.py's check shape), each beside one SDPA call over the
same context, with ``tools/timing.py launch_times``: device time (the host's
enqueueing hidden behind a sleep kernel), back-to-back time (the host's
enqueueing counts where it is the longer) and the host's time to enqueue one
call.

    python -m dynamo_tpu_torch.tools.time_decode

The decode inputs are chip_smoke.py's decode check shapes: batch 64,
contexts 1..2048 rows in distinct pages, every case drawn from seed 0 (so
cases of one geometry, K1, K4a and K4b at K1's, read the same inputs), bf16
queries and
pools (int8: the pools quantized by row, SDPA over their bf16
dequantization). K6's are its check shape: DeepSeek-V2-Lite's 16 heads,
latent rows of 576 (d_c 512), two 512-row chunks of one sequence at
prefixes 0 and 1536, f32 pre-scaled queries over bf16 pages, both chunks a
call; SDPA takes the bf16 queries over the gathered context with the causal
mask (its math backend: no fused one takes these shapes).
To time another tree's launchers on the same inputs, copy this file and
``tools/timing.py`` into that tree's ``dynamo_tpu_torch/tools/`` and run it
there: it calls the launchers by their public names, which are the same in
every tree since K4b was ported. Prints one JSON line. Needs one CUDA device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dynamo_tpu_torch.ops.attention import gather_pages
from dynamo_tpu_torch.ops.kernels import paged_attention as pa
from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_prefill_attention_kernel
from dynamo_tpu_torch.quant.kv import QuantizedPages, dequantize_rows, quantize_kv_rows
from dynamo_tpu_torch.tools.timing import card, launch_times

B, ROWS, ITERS = 64, 2048, 50
# name: (launcher, Hq, Hkv, D, page size, pools)
CASES = {
    "K1 bf16": (pa.paged_decode_attention_kernel, 32, 8, 128, 16, "bf16"),
    "K3a bf16": (pa.paged_decode_attention_folded_kernel, 32, 4, 64, 16, "bf16"),
    "K3a int8": (pa.paged_decode_attention_folded_kernel, 32, 4, 64, 16, "int8"),
    "K4b bf16": (pa.paged_decode_attention_grouped_kernel, 32, 8, 128, 16, "bf16"),
    "K4b bf16 G2 ps128": (pa.paged_decode_attention_grouped_kernel, 16, 8, 128, 128, "bf16"),
    "K4a bf16": (pa.paged_decode_attention_chunked_kernel, 32, 8, 128, 16, "bf16"),
    "K4a bf16 G2 ps128": (pa.paged_decode_attention_chunked_kernel, 16, 8, 128, 128, "bf16"),
}
# K6's check shape: (T, H, latent, d_c, page size, prefixes)
MLA_PREFILL = (512, 16, 576, 512, 16, (0, 1536))


def case_inputs(rng, Hq: int, Hkv: int, D: int, ps: int, pools: str, dev) -> dict:
    """Queries, pools (bf16 or int8 QuantizedPages), tables, positions, and
    the dense bf16 context and mask SDPA reads."""
    max_pages = ROWS // ps
    lengths = rng.integers(1, ROWS + 1, B)
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
    q = torch.randn((B, Hq, D), device=dev, generator=gen).bfloat16()
    if pools == "int8":
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


def times(launch, iters: int = ITERS) -> dict:
    dev_us, b2b_us, host_us = launch_times(lambda i: launch(), iters)
    return {"ms": dev_us / 1e3, "b2b_ms": b2b_us / 1e3, "host_ms": host_us / 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_decode needs a CUDA device")
    dev = torch.device("cuda", 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {"device": card()}
    for name, (launcher, Hq, Hkv, D, ps, pools) in CASES.items():
        x = case_inputs(np.random.default_rng(0), Hq, Hkv, D, ps, pools, dev)
        qs = x["q"][:, :, None, :]
        kernel = times(lambda: launcher(x["q"], x["k"], x["v"], x["pt"], x["pos"]))
        library = times(lambda: sdpa(qs, x["kc"], x["vc"], attn_mask=x["mask"], enable_gqa=True))
        res[name] = {"kernel": kernel, "sdpa": library}
        print(f"{name}: kernel {kernel}, sdpa {library}", flush=True)
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
