"""Kernel-against-plain checks shared by ``chip_smoke.py`` and the kernel
profilers (``tools/profile_attn.py``, ``tools/profile_prefill.py``): the
elementwise tolerance a kernel is held to, and pools whose checksums are
exact.

Kernel vs plain, elementwise |got - ref| <= atol + rtol * |ref|. Both sides
compute in f32 from the same inputs and differ there only in summation order
(max 1e-6 for K1, 6e-6 for K2 at f32 on an H100); a bf16 output is rounded
once at the end, and two roundings of nearly equal values differ by at most
one bf16 step, <= 2^-7 |value|. So bf16 gets rtol 2^-6 (two steps) on top of
the f32 atol: at the ~0.03 outputs of 2048-key rows the limit is ~6e-4, below
the ~1e-3 that one dropped page of keys moves them.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.quant.kv import QuantizedPages

TOL = {"f32": (1e-4, 0.0), "bf16": (1e-4, 2.0**-6)}


def tol_share(got: torch.Tensor, ref: torch.Tensor, tol: str) -> tuple[float, float]:
    """(max |got - ref|, the largest share of the limit ``TOL[tol]`` any
    element uses): the check passes iff the share is <= 1. A non-finite
    output gives an infinite share."""
    atol, rtol = TOL[tol]
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    return diff.max().item(), (diff / (atol + rtol * ref.abs())).max().item()


def exact_pools(shape, kind: str, device, generator: torch.Generator | None = None) -> list:
    """K and V pools of ``kind`` (float32, bfloat16 or int8) holding
    multiples of 1/8 in [-1, 1] (int8: codes times the scale 2^-7, as
    ``QuantizedPages``), so that every f32 sum of up to 2^16 of their values
    is exact in any order and the load-only twins' checksums (K7a, K7b) can
    be held exactly."""
    out = []
    for _ in range(2):
        if kind == "int8":
            codes = torch.randint(-127, 128, shape, device=device, dtype=torch.int8, generator=generator)
            out.append(QuantizedPages(codes, torch.full(shape[:2], 2.0**-7, device=device)))
        else:
            x = torch.randint(-8, 9, shape, device=device, generator=generator).float() / 8
            out.append(x.to(getattr(torch, kind)))
    return out
