"""K1's split tensor-core body (``csrc/paged_attention.cu paged_decode_tc``)
modelled on the CPU: the kernel cannot run here, so a torch model of its
schedule and arithmetic is held against the plain version and against the
reference's ``paged_decode_attention_pallas`` in interpret mode on the same
numpy-seeded inputs, at head_dim 64, 128, 256, 384 and 512, over bf16 pools
and over the int8 cache.

The model follows the body step by step: the context splits into blocks of
``split_rows`` rows (not whole pages: splits fall mid-page), each block
walks ring stages of 64 rows (32 past D 128), warp w takes rows 16 w .. 16 w
+ 15 of a stage with a softmax state of its own in log2 units (exp2, the
scale folded into log2(e) / sqrt(D) in f32), skips a stage whose rows it
does not reach, and splits P into bf16 hi + lo for two products; int8 scales
multiply S's columns and P after the running sum took it. The warps merge
at the block's end, the splits in ``merge_splits``' order. Inactive slots
(trash tables, position 0) and a row at position -1 (context index 0 only)
are in the batch; the reference's rule for a negative position differs (its
plain version spreads a uniform softmax), so that row is compared with the
plain version only.

Tolerances: against the plain version (f32 from the same bf16 / int8
inputs) and the reference kernel, atol 1e-4 (``tools/checks.py TOL["f32"]``):
the hi + lo split keeps each probability to ~2^-17 of itself, far inside it.
One bf16 rounding of P instead moves outputs by up to 2^-9 of their terms,
which the last test shows leaves that limit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas.paged_attention import paged_decode_attention_pallas
from dynamo_tpu.quant import kv as jkv
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops.kernels import paged_attention as pa
from dynamo_tpu_torch.quant import kv as tkv

torch.set_num_threads(2)

NEG = -1e30  # the kernels' kNegInf
SPLIT_ROWS = 256  # one of the launcher's choices (k1_split_rows): two splits of the 288-row table
LOG2E = np.float32(1.4426950408889634)


def stage_rows(D: int) -> int:
    """The body's ring stage: 64 context rows up to D 128, 32 past it."""
    return 64 if D <= 128 else 32


def k1_split_model(q, k, v, ks, vs, pt, pos, split_rows: int, round_p: bool = False) -> torch.Tensor:
    """f32 [B, Hq, D]: the body's output before its bf16 store. ``k``, ``v``
    [P, ps, Hkv, D] float (int8 codes as floats), ``ks``, ``vs`` [P, ps] row
    scales or None; ``round_p``: one bf16 rounding of P instead of hi + lo."""
    B, Hq, D = q.shape
    ps, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    S = pt.shape[1] * ps
    rows = (pt.long()[:, :, None] * ps + torch.arange(ps)).reshape(B, S)  # pool row of each context index
    kc = k.reshape(-1, Hkv, D)[rows].float()  # [B, S, Hkv, D]
    vc = v.reshape(-1, Hkv, D)[rows].float()
    ksc = ks.reshape(-1)[rows] if ks is not None else torch.ones(B, S)
    vsc = vs.reshape(-1)[rows] if vs is not None else torch.ones(B, S)
    ctx = (pos.long() + 1).clamp(1, S)
    scale_log2 = torch.tensor(LOG2E / np.float32(math.sqrt(D)), dtype=torch.float32)
    qg = q.float().reshape(B, Hkv, G, D)
    s_all = torch.einsum("bkgd,bskd->bkgs", qg, kc) * scale_log2 * ksc[:, None, None, :]  # [B, Hkv, G, S]
    tr = stage_rows(D)
    n_split = -(-S // split_rows)
    m_s = torch.full((n_split, B, Hkv, G), NEG)
    l_s = torch.zeros((n_split, B, Hkv, G))
    a_s = torch.zeros((n_split, B, Hkv, G, D))
    for sp in range(n_split):
        r0 = sp * split_rows
        r1 = torch.clamp(ctx, max=r0 + split_rows)  # [B]
        warps = []
        for w in range(tr // 16):
            m = torch.full((B, Hkv, G), NEG)
            l = torch.zeros((B, Hkv, G))
            acc = torch.zeros((B, Hkv, G, D))
            for t0 in range(r0, r0 + split_rows, tr):
                lo = t0 + 16 * w
                if lo >= S:
                    break
                idx = torch.arange(lo, lo + 16)
                live = lo < r1  # [B]: the warp reaches this stage (warp-uniform skip)
                valid = idx[None, :] < r1[:, None]  # [B, 16]
                s = torch.where(valid[:, None, None, :], s_all[..., lo : lo + 16], torch.tensor(NEG))
                new_m = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - new_m)
                p = torch.exp2(s - new_m[..., None])
                l_new = l * corr + p.sum(-1)
                p = p * vsc[:, None, None, lo : lo + 16]
                if round_p:
                    terms = [p.bfloat16().float()]
                else:
                    hi = p.bfloat16().float()
                    terms = [hi, (p - hi).bfloat16().float()]
                pv = sum(torch.einsum("bkgs,bskd->bkgd", t, vc[:, lo : lo + 16]) for t in terms)
                acc_new = acc * corr[..., None] + pv
                keep = live[:, None, None]
                m = torch.where(keep, new_m, m)
                l = torch.where(keep, l_new, l)
                acc = torch.where(keep[..., None], acc_new, acc)
            warps.append((m, l, acc))
        M = torch.stack([w[0] for w in warps]).amax(0)
        wt = [torch.exp2(w[0] - M) for w in warps]
        m_s[sp] = M
        l_s[sp] = sum(x * w[1] for x, w in zip(wt, warps))
        a_s[sp] = sum(x[..., None] * w[2] for x, w in zip(wt, warps))
    # merge_splits: the sequence's ceil(ctx / split_rows) splits
    used = torch.arange(n_split)[:, None] < (-(-ctx // split_rows))[None, :]  # [n_split, B]
    m_s = torch.where(used[..., None, None], m_s, torch.tensor(NEG))
    mx = m_s.amax(0)
    w = torch.where(used[..., None, None], torch.exp2(m_s - mx), torch.tensor(0.0))
    tot = (w * l_s).sum(0)
    out = (w[..., None] * a_s).sum(0) / tot.clamp(min=1e-20)[..., None]
    return out.reshape(B, Hq, D)


def case(D: int, seed: int, B: int = 5, Hq: int = 4, Hkv: int = 2, ps: int = 24, max_pages: int = 12):
    """Distinct pages per sequence; contexts of one row, the full table (288
    rows: two splits at 256, the second mid-page), a ragged one past a split
    edge; an inactive slot (trash table, position 0) and a row at -1."""
    rng = np.random.default_rng(seed)
    P = B * max_pages + 1
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pos = np.array([0, max_pages * ps - 1, 270, 0, -1][:B], np.int32)
    pt = np.zeros((B, max_pages), np.int32)
    perm = 1 + rng.permutation(P - 1)
    for b in range(B):
        used = max(int(pos[b]), 0) // ps + 1
        pt[b, :used] = perm[b * max_pages : b * max_pages + used]
    pt[3] = 0  # the inactive slot
    return q, k, v, pt, pos


def mixed(q, k, v, mix: str):
    """(torch q bf16, torch pools, JAX q f32, JAX pools, model K, model V,
    model K scales, V scales) of one mix: bf16 pools, or the int8 cache (the
    rows quantized by the reference's quantize_kv_rows)."""
    tq = torch.from_numpy(q).bfloat16()
    jq = jnp.asarray(tq.float().numpy())
    if mix == "bf16":
        tk, tv = (torch.from_numpy(x).bfloat16() for x in (k, v))
        jk, jv = (jnp.asarray(x.float().numpy()) for x in (tk, tv))
        return tq, (tk, tv), jq, (jk, jv), tk.float(), tv.float(), None, None
    tp, jp = [], []
    for x in (k, v):
        P, ps, Hkv, D = x.shape
        codes, s = (np.asarray(a) for a in jkv.quantize_kv_rows(jnp.asarray(x.reshape(P * ps, Hkv, D))))
        codes, s = codes.reshape(P, ps, Hkv, D), s.reshape(P, ps)
        jp.append(jkv.QuantizedPages(jnp.asarray(codes), jnp.asarray(s)))
        tp.append(tkv.QuantizedPages(torch.from_numpy(codes.copy()), torch.from_numpy(s.copy())))
    return (tq, tuple(tp), jq, tuple(jp), tp[0].q.float(), tp[1].q.float(), tp[0].s, tp[1].s)


@pytest.mark.parametrize("mix", ["bf16", "int8"])
@pytest.mark.parametrize("D", [64, 128, 256, 384, 512])
def test_k1_split_body_matches_plain_and_pallas(D, mix):
    q, k, v, pt, pos = case(D, seed=D + len(mix))
    tq, (tk, tv), jq, (jk, jv), mk, mv, mks, mvs = mixed(q, k, v, mix)
    tpt, tpos = torch.from_numpy(pt), torch.from_numpy(pos)
    pa.check_decode_args(tq, tk, tv, tpt, tpos)  # the launcher takes this shape
    got = k1_split_model(tq, mk, mv, mks, mvs, tpt, tpos, SPLIT_ROWS)
    plain = tatt.paged_decode_attention(tq.float(), tk if mix == "int8" else tk.float(),
                                        tv if mix == "int8" else tv.float(), tpt, tpos)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4, rtol=0)
    ref = np.asarray(paged_decode_attention_pallas(jq, jk, jv, jnp.asarray(pt), jnp.asarray(pos), interpret=True))
    live = pos >= 0  # the reference's own rule at a negative position differs
    np.testing.assert_allclose(got.numpy()[live], ref[live], atol=1e-4, rtol=0)


@pytest.mark.parametrize("split_rows", [64, 128, 192])
def test_k1_split_edges_do_not_move_the_result(split_rows):
    """Splits of one, two or three stages, falling mid-page (ps 24) and on
    stage edges, give the sequential result up to f32 summation order."""
    q, k, v, pt, pos = case(128, seed=split_rows)
    tq, (tk, tv), _, _, mk, mv, _, _ = mixed(q, k, v, "bf16")
    tpt, tpos = torch.from_numpy(pt), torch.from_numpy(pos)
    one = k1_split_model(tq, mk, mv, None, None, tpt, tpos, 12 * 24 + 64)  # a single split
    got = k1_split_model(tq, mk, mv, None, None, tpt, tpos, split_rows)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=2e-6, rtol=0)


def test_k1_split_needs_the_hi_lo_split():
    """One bf16 rounding of P leaves the f32 limit at these inputs; the
    hi + lo split keeps it (the reason the body runs two P.V products)."""
    q, k, v, pt, pos = case(128, seed=5)
    tq, (tk, tv), _, _, mk, mv, _, _ = mixed(q, k, v, "bf16")
    tpt, tpos = torch.from_numpy(pt), torch.from_numpy(pos)
    plain = tatt.paged_decode_attention(tq.float(), tk.float(), tv.float(), tpt, tpos).numpy()
    split = k1_split_model(tq, mk, mv, None, None, tpt, tpos, SPLIT_ROWS).numpy()
    rounded = k1_split_model(tq, mk, mv, None, None, tpt, tpos, SPLIT_ROWS, round_p=True).numpy()
    assert np.abs(split - plain).max() <= 1e-4 < np.abs(rounded - plain).max()


def test_k1_split_rows_fill_the_card():
    """The launcher's split: the longest whose blocks at the table's
    capacity reach K1_SPLIT_BLOCKS (the serve batch of 64 sequences, the
    engine's 16 slots and 8 of them over 8 kv heads and 2048-row tables take
    512 rows, 4 take 256 and 1 takes 128), 128 / D times as many below D 128
    (TinyLlama's 4 kv heads of 64 at 16 slots take 256 rows); G past 16
    counts its head tiles, D past 256 its two column slices."""
    assert pa.k1_split_rows(64, 8, 4, 128, 2048) == 512 and pa.k1_split_rows(16, 8, 4, 128, 2048) == 512
    assert pa.k1_split_rows(8, 8, 4, 128, 2048) == 512 and pa.k1_split_rows(4, 8, 4, 128, 2048) == 256
    assert pa.k1_split_rows(1, 8, 4, 128, 2048) == 128 and pa.k1_split_rows(5, 2, 2, 128, 288) == 128
    assert pa.k1_split_rows(16, 4, 8, 64, 2048) == 256 and pa.k1_split_rows(64, 4, 8, 64, 2048) == 512
    assert pa.k1_split_rows(4, 8, 32, 128, 2048) == 512 and pa.k1_split_rows(2, 8, 32, 128, 2048) == 256
    assert pa.k1_split_rows(2, 8, 4, 512, 2048) == 256 and pa.k1_split_rows(2, 8, 4, 256, 2048) == 128
    assert all(r % 64 == 0 for r in pa.K1_SPLIT_CHOICES)
