"""The arithmetic of the tensor-core prefill kernels K2 and K3b
(``dynamo_tpu_torch/ops/kernels/csrc/prefill_attention.cu``
``tc_prefill_kernel``), modelled in plain PyTorch on the CPU and held
against the port's plain prefill (``ops/attention.py
paged_prefill_attention_lanes``) under the unchanged ``TOL["bf16"]``
(``tools/checks.py``).

The model does what the kernel does, in its order: 64-key tiles from key 0
up to the context bound; bf16 operands (queries, K and V, int8 codes
converted exactly to bf16) with f32 products and sums, as the tensor cores
take them; scores times the int8 K row scale, then times log2(e)/sqrt(D);
masked scores at -1e30; a running max per tile and exp2; the running sum
takes the f32 probabilities, which are then multiplied by the int8 V row
scale and split as P = bf16(P) + bf16(P - bf16(P)) into two products with
V; output divided by max(l, 1e-20) and rounded once to bf16.

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``);
this file fixes what it must compute, and records why P is split: a single
bf16 rounding of P leaves the limit at small outputs of short rows.
"""

import math

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.quant.kv import QuantizedPages, quantize_kv_rows
from dynamo_tpu_torch.tools.checks import tol_share

torch.set_num_threads(2)

TILE = 64  # keys a context tile
LOG2E = 1.4426950408889634
NEG_INF = -1e30


def tc_model(q, k_pages, v_pages, page_tables, positions, split: bool = True) -> torch.Tensor:
    """The tensor-core kernel's arithmetic, lanes form: q [N*T, Hq, D] bf16,
    pools [P, ps, Hkv, D] bf16 or int8 ``QuantizedPages``, page_tables [N,
    max_pages], positions [N, T] unit-stride. ``split=False`` rounds P once
    to bf16 instead of splitting it."""
    N, T = positions.shape
    _, Hq, D = q.shape
    quant = isinstance(k_pages, QuantizedPages)
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    G = Hq // Hkv
    scale = LOG2E / math.sqrt(D)
    out = torch.empty(q.shape, dtype=q.dtype)
    for n in range(N):
        pt = page_tables[n].long()
        n_ctx = min(int(positions[n, -1]) + 1, pt.numel() * ps)
        tok = (pt[:, None] * ps + torch.arange(ps)).reshape(-1)[:n_ctx]

        def rows(pages):
            if quant:  # codes, |code| <= 127, are exact in bf16
                return pages.q.reshape(-1, Hkv, D)[tok].bfloat16().float(), pages.s.reshape(-1)[tok]
            return pages.reshape(-1, Hkv, D)[tok].bfloat16().float(), None

        K, ks = rows(k_pages)
        V, vs = rows(v_pages)
        qn = q[n * T : (n + 1) * T].bfloat16().float().reshape(T, Hkv, G, D).permute(1, 2, 0, 3)
        qpos = positions[n].long()
        m = torch.full((Hkv, G, T), NEG_INF)
        l = torch.zeros((Hkv, G, T))
        o = torch.zeros((Hkv, G, T, D))
        for kt0 in range(0, n_ctx, TILE):
            j = torch.arange(kt0, min(kt0 + TILE, n_ctx))
            s = torch.einsum("hgtd,jhd->hgtj", qn, K[j])
            if quant:
                s = s * ks[j]
            s = torch.where(j[None, :] <= qpos[:, None], s * scale, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            m = m_new
            if quant:
                p = p * vs[j]
            hi = p.bfloat16().float()
            parts = [hi, (p - hi).bfloat16().float()] if split else [hi]
            o = o * corr[..., None] + sum(torch.einsum("hgtj,jhd->hgtd", x, V[j]) for x in parts)
        res = o / l.clamp(min=1e-20)[..., None]
        out[n * T : (n + 1) * T] = res.permute(2, 0, 1, 3).reshape(T, Hq, D).to(q.dtype)
    return out


def _pools(rng, P, ps, Hkv, D, int8: bool):
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((P, ps, Hkv, D)).astype(np.float32))
        if int8:
            c, s = quantize_kv_rows(x.reshape(P * ps, Hkv, D))
            out.append(QuantizedPages(c.reshape(P, ps, Hkv, D), s.reshape(P, ps)))
        else:
            out.append(x.bfloat16())
    return out


def _lanes(rng, starts, T, ps, max_pages, P):
    """Tables and unit-stride positions for lanes starting at ``starts``; a
    lane whose start is None is a pad lane (positions 0.., all-zero table)."""
    pt = np.zeros((len(starts), max_pages), np.int32)
    perm = 1 + rng.permutation(P - 1)
    off = 0
    for n, s in enumerate(starts):
        if s is None:
            continue
        used = -(-(s + T) // ps)
        pt[n, :used] = perm[off : off + used]
        off += used
    pos = np.stack([(s or 0) + np.arange(T) for s in starts]).astype(np.int32)
    return torch.from_numpy(pt), torch.from_numpy(pos)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_tc_model_matches_plain_ragged_lanes(G, int8):
    """Lanes from position 0, after a prefix that ends mid-page (the
    context ends mid-page too), after a prefix over several tiles, and a pad
    lane; T is no multiple of the 64-key tile or of a block's positions."""
    rng = np.random.default_rng(G + 10 * int8)
    Hkv, D, ps, T, max_pages = 2, 64, 16, 75, 24
    starts = [0, 37, 230, None]
    P = 1 + sum(-(-(s + T) // ps) for s in starts if s is not None)
    k, v = _pools(rng, P, ps, Hkv, D, int8)
    pt, pos = _lanes(rng, starts, T, ps, max_pages, P)
    q = torch.from_numpy(rng.standard_normal((len(starts) * T, G * Hkv, D)).astype(np.float32)).bfloat16()
    got = tc_model(q, k, v, pt, pos)
    ref = tatt.paged_prefill_attention_lanes(q, k, v, pt, pos)
    _, share = tol_share(got, ref, "bf16")
    assert share <= 1.0, f"share {share:.3f} of TOL['bf16']"


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_tc_model_dominant_key_and_near_zero_rows(int8):
    """A row whose softmax is one key (score ~40 above the rest: the
    running max jumps in a later tile and the earlier tiles' sums scale to
    ~0), and a lane whose V rows are ~1e-3, so its outputs sit where the
    limit is nearly all its atol."""
    rng = np.random.default_rng(5 + int8)
    Hkv, G, D, ps, T, max_pages = 2, 4, 32, 16, 64, 16
    Hq = G * Hkv
    starts = [100, 0]
    P = 1 + sum(-(-(s + T) // ps) for s in starts)
    k32 = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v32 = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    q32 = rng.standard_normal((2 * T, Hq, D)).astype(np.float32)
    pt, pos = _lanes(rng, starts, T, ps, max_pages, P)
    # lane 0, row 50 (position 150), head 5 (kv head 1): key 140 (second
    # tile) aligned with the query, 1/sqrt(D) * 6 |q|^2 ~ 34 above the rest
    page, row = int(pt[0, 140 // ps]), 140 % ps
    k32[page, row, 1] = 6.0 * q32[50, 5]
    # lane 1: tiny values
    for j in range(-(-T // ps)):
        v32[int(pt[1, j])] *= 1e-3
    if int8:
        pools = []
        for x in (k32, v32):
            c, s = quantize_kv_rows(torch.from_numpy(x).reshape(P * ps, Hkv, D))
            pools.append(QuantizedPages(c.reshape(P, ps, Hkv, D), s.reshape(P, ps)))
        k, v = pools
    else:
        k, v = (torch.from_numpy(x).bfloat16() for x in (k32, v32))
    q = torch.from_numpy(q32).bfloat16()
    got = tc_model(q, k, v, pt, pos)
    ref = tatt.paged_prefill_attention_lanes(q, k, v, pt, pos)
    dominant = ref[50, 5].float()
    vrow = (v.q[page, row, 1].float() * v.s[page, row]) if int8 else v[page, row, 1].float()
    assert torch.allclose(dominant, vrow, atol=1e-2), "the row is not one key's"
    assert ref[T:].float().abs().max() < 5e-3, "lane 1 outputs are not near zero"
    _, share = tol_share(got, ref, "bf16")
    assert share <= 1.0, f"share {share:.3f} of TOL['bf16']"


def test_single_bf16_rounding_of_p_leaves_the_limit():
    """Why P is split: rounding it once to bf16 before P.V (what flash
    kernels usually do) puts short rows' small outputs outside TOL["bf16"];
    the split model on the same inputs stays inside."""
    rng = np.random.default_rng(0)
    Hkv, G, D, ps, T, max_pages = 2, 4, 128, 16, 128, 8
    k, v = _pools(rng, 1 + T // ps, ps, Hkv, D, False)
    pt, pos = _lanes(rng, [0], T, ps, max_pages, 1 + T // ps)
    q = torch.from_numpy(rng.standard_normal((T, G * Hkv, D)).astype(np.float32)).bfloat16()
    ref = tatt.paged_prefill_attention_lanes(q, k, v, pt, pos)
    _, rounded = tol_share(tc_model(q, k, v, pt, pos, split=False), ref, "bf16")
    _, split = tol_share(tc_model(q, k, v, pt, pos), ref, "bf16")
    assert rounded > 1.0, f"one rounding used {rounded:.3f} of the limit"
    assert split <= 1.0, f"the split used {split:.3f} of the limit"
