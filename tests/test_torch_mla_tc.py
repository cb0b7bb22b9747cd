"""K6's and K5's tensor-core bodies (``csrc/mla_attention.cu``
``mla_prefill_tc`` and ``mla_decode_tc``) modelled in torch on the CPU.

K6: the chunk's (position, head) pairs flattened position-major into 64-row
tiles, 32-key tiles of the latent context, S = Q_hi.K^T + Q_lo.K^T with q
split into bf16 hi and lo over bf16 pages (exact keys), the causal and
context masks per row, an online softmax in log2 units, and O += P_hi.V +
P_lo.V with P split the same way, V the key tile's first d_c columns.

K5: each sequence's context cut into splits of ``split_rows`` rows (splits
past its length hold nothing and are skipped), the heads in groups of 16
(zero queries past H), tiles of 64 latent rows in each split (rows
past the split's end zero and masked), the same hi + lo products and P
split, one running max a head shared by the warps, and the splits' (m, l,
acc) merged in a fixed order as ``merge_splits`` merges them.

Each model is held to the plain version (``ops/attention.py``) and to the
reference's Pallas kernel in interpret mode at 4, 16 and 20 heads, at
``TOL["f32"]`` (atol 1e-4, no relative term: the limit the kernels are held
to on the card), and one bf16 rounding of q in place of the split is shown
to leave that limit. The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas.mla_attention import paged_mla_decode_attention_pallas, paged_mla_prefill_attention_pallas
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops.kernels import mla_attention as mla
from dynamo_tpu_torch.tools.checks import tol_share

torch.set_num_threads(2)

TILE_ROWS, TILE_KEYS = 64, 32
LOG2E = 1.4426950408889634


def _bf16_split(x: torch.Tensor, split: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = bf16(x), lo = bf16(x - hi), as f32; lo is zero
    without the split."""
    hi = x.bfloat16().float()
    return hi, ((x - hi).bfloat16().float() if split else torch.zeros_like(x))


def k6_tc_model(q_cat, pages, page_table, positions, d_c, split_q: bool = True) -> torch.Tensor:
    """mla_prefill_tc's arithmetic: q_cat [T, H, L] f32 pre-scaled, pages
    [P, ps, L] bf16, page_table [max_pages], positions [T] unit-stride ->
    a_lat [T, H, d_c] f32. ``split_q`` False rounds q once to bf16 instead."""
    T, H, L = q_cat.shape
    ctx = tatt.gather_pages(pages, page_table).float()  # [S, L], bf16 values
    S = ctx.shape[0]
    rows = q_cat.reshape(T * H, L).float()
    qh, ql = _bf16_split(rows, split_q)
    out = torch.empty((T * H, d_c))
    for r0 in range(0, T * H, TILE_ROWS):
        r = torch.arange(r0, min(r0 + TILE_ROWS, T * H))
        pos = positions.long()[r // H]  # each row's own position
        n_ctx = min(int(pos[-1]) + 1, S)  # the tile reads up to its last row's position
        m = torch.full((len(r),), -1e30)
        l = torch.zeros(len(r))
        acc = torch.zeros((len(r), d_c))
        for k0 in range(0, n_ctx, TILE_KEYS):
            keys = torch.arange(k0, k0 + TILE_KEYS)
            kt = torch.where((keys < n_ctx)[:, None], ctx[keys.clamp(max=S - 1)], 0.0)
            s = (qh[r] @ kt.T + ql[r] @ kt.T) * LOG2E
            s = torch.where((keys[None, :] <= pos[:, None]) & (keys[None, :] < n_ctx), s, -1e30)
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[:, None])
            l = l * corr + p.sum(-1)
            ph, pl = _bf16_split(p, True)
            acc = acc * corr[:, None] + ph @ kt[:, :d_c] + pl @ kt[:, :d_c]
            m = mx
        out[r] = acc / l.clamp(min=1e-20)[:, None]
    return out.reshape(T, H, d_c)


def _inputs(rng, T, H, d_c, d_r, start, ps=16, max_pages=8):
    """Pre-scaled f32 queries, a bf16 latent pool in distinct pages, one
    chunk's table and unit-stride positions from ``start``."""
    L = d_c + d_r
    P = 1 + max_pages
    q = torch.from_numpy((rng.standard_normal((T, H, L)) / np.sqrt(L)).astype(np.float32))
    pages = torch.from_numpy(rng.standard_normal((P, ps, L)).astype(np.float32)).bfloat16()
    pt = torch.from_numpy((1 + rng.permutation(max_pages)).astype(np.int32))
    pos = torch.arange(start, start + T, dtype=torch.int32)
    return q, pages, pt, pos


@pytest.mark.parametrize("H", [4, 16, 20])
@pytest.mark.parametrize("start", [0, 37], ids=["prefix0", "prefix37"])
def test_k6_tc_model_matches_plain_and_pallas(H, start):
    """40 positions: 160 / 640 / 800 rows, so the last tile is ragged at 4
    and 20 heads; the latent row 80 wide (5 k-steps of 16), d_c 64; the
    prefix starts mid-page at 37."""
    rng = np.random.default_rng(H + start)
    q, pages, pt, pos = _inputs(rng, 40, H, 64, 16, start)
    got = k6_tc_model(q, pages, pt, pos, 64)
    ref = tatt.paged_mla_prefill_attention(q, pages, pt, pos, 64)
    want = np.asarray(paged_mla_prefill_attention_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(pages.float().numpy()), jnp.asarray(pt.numpy()),
        jnp.asarray(pos.numpy()), d_c=64, interpret=True))
    for other in (ref, torch.from_numpy(np.array(want))):
        _, share = tol_share(got, other, "f32")
        assert share <= 1.0, f"share {share:.3f} of TOL['f32']"


@pytest.mark.parametrize("T,H,d_r", [(37, 16, 8), (5, 20, 16), (1, 4, 8)], ids=["ragged", "short", "one-row"])
def test_k6_tc_model_ragged_chunks_and_pad_columns(T, H, d_r):
    """A chunk length that fills no whole tile, a latent row that is no
    multiple of 16 (d_r 8: the last k-step reads the zero pad chunk) and a
    one-position chunk, against the plain version."""
    rng = np.random.default_rng(T * H)
    q, pages, pt, pos = _inputs(rng, T, H, 32, d_r, 3)
    _, share = tol_share(k6_tc_model(q, pages, pt, pos, 32), tatt.paged_mla_prefill_attention(q, pages, pt, pos, 32),
                         "f32")
    assert share <= 1.0, f"share {share:.3f} of TOL['f32']"


def test_single_bf16_rounding_of_q_leaves_the_limit():
    """Why q is split: rounding the f32 queries once to bf16 before Q.K^T
    (what a bf16 tensor-core kernel does by default) moves the scores by
    ~2^-9 of their terms, which puts outputs at DeepSeek-V2-Lite's width
    (16 heads, d_c 512, d_r 64) outside TOL["f32"]; the split model on the
    same inputs stays inside."""
    rng = np.random.default_rng(0)
    q, pages, pt, pos = _inputs(rng, 16, 16, 512, 64, 0)
    ref = tatt.paged_mla_prefill_attention(q, pages, pt, pos, 512)
    _, rounded = tol_share(k6_tc_model(q, pages, pt, pos, 512, split_q=False), ref, "f32")
    _, split = tol_share(k6_tc_model(q, pages, pt, pos, 512), ref, "f32")
    assert rounded > 1.0, f"one rounding used {rounded:.3f} of the limit"
    assert split <= 1.0, f"the split used {split:.3f} of the limit"


# ---------------------------------------------------------------- K5


K5_TILE = 64  # mla_decode_tc's latent rows a ring stage


def k5_tc_model(q_cat, pages, page_tables, positions, d_c, split_rows=128, split_q: bool = True) -> torch.Tensor:
    """mla_decode_tc's arithmetic and merge_splits': q_cat [B, H, L] f32
    pre-scaled, pages [P, ps, L] bf16, page_tables [B, max_pages], positions
    [B] -> a_lat [B, H, d_c] f32. ``split_q`` False rounds q once to bf16
    instead."""
    B, H, L = q_cat.shape
    ctx = tatt.gather_pages(pages, page_tables).float()  # [B, S, L], bf16 values
    S = ctx.shape[1]
    Hp = -(-H // 16) * 16  # groups of 16 heads, the queries past H zero
    q = torch.zeros((B, Hp, L))
    q[:, :H] = q_cat.float()
    qh, ql = _bf16_split(q, split_q)
    out = torch.empty((B, H, d_c))
    for b in range(B):
        n = min(max(int(positions[b]) + 1, 1), S)  # a position below 0 attends row 0
        parts = []
        for r0 in range(0, -(-S // split_rows) * split_rows, split_rows):
            if r0 >= n:  # a split past the context writes nothing and is not merged
                continue
            r1 = min(r0 + split_rows, n)
            m = torch.full((Hp,), -1e30)
            l = torch.zeros(Hp)
            acc = torch.zeros((Hp, d_c))
            for k0 in range(r0, r1, K5_TILE):
                keys = torch.arange(k0, k0 + K5_TILE)
                kt = torch.where((keys < r1)[:, None], ctx[b, keys.clamp(max=S - 1)], 0.0)
                s = (qh[b] @ kt.T + ql[b] @ kt.T) * LOG2E  # the hi and lo products in their own sums
                s = torch.where(keys[None, :] < r1, s, -1e30)
                mx = torch.maximum(m, s.amax(-1))  # every warp forms the tile's max over all its keys
                corr = torch.exp2(m - mx)
                p = torch.exp2(s - mx[:, None])
                l = l * corr + p.sum(-1)
                ph, pl = _bf16_split(p, True)
                acc = acc * corr[:, None] + ph @ kt[:, :d_c] + pl @ kt[:, :d_c]
                m = mx
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp2(m - M) for m, _, _ in parts]
        lsum = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        asum = sum(wi[:, None] * ai for wi, (_, _, ai) in zip(w, parts))
        out[b] = (asum / lsum.clamp(min=1e-20)[:, None])[:H]
    return out


def _decode_inputs(rng, H, d_c, d_r, positions, ps=16, max_pages=16):
    """Pre-scaled f32 queries, a bf16 latent pool in distinct pages, tables
    covering each position (a trash table for an inactive slot at position
    0 and for a row at -1)."""
    L = d_c + d_r
    B = len(positions)
    P = 1 + B * max_pages
    q = torch.from_numpy((rng.standard_normal((B, H, L)) / np.sqrt(L)).astype(np.float32))
    pages = torch.from_numpy(rng.standard_normal((P, ps, L)).astype(np.float32)).bfloat16()
    pt = np.zeros((B, max_pages), np.int32)
    perm = 1 + rng.permutation(P - 1)
    for b, pos in enumerate(positions):
        used = max(pos, 0) // ps + 1
        pt[b, :used] = perm[b * max_pages : b * max_pages + used]
    pt[-1] = 0  # the last slot inactive: its trash table at position 0
    return q, pages, torch.from_numpy(pt), torch.from_numpy(np.asarray(positions, np.int32))


# contexts of 1 row, one split ending mid-tile, a split edge and one row
# past it, several splits ending mid-page, the full 256-row table; a row at
# -1 and an inactive slot (position 0)
DECODE_POSITIONS = [0, 36, 127, 128, 200, 255, -1, 0]


@pytest.mark.parametrize("H", [4, 16, 20])
def test_k5_tc_model_matches_plain_and_pallas(H):
    """16 heads a group: 4 (one group, 12 zero queries), 16 and 20 (a second
    group of 4); the latent row 80 wide (d_c 64 + d_r 16), the split rows
    the launcher picks for this batch and table, 64-row tiles."""
    rng = np.random.default_rng(100 + H)
    q, pages, pt, pos = _decode_inputs(rng, H, 64, 16, DECODE_POSITIONS)
    got = k5_tc_model(q, pages, pt, pos, 64, mla.tc_split_rows(*q.shape[:2], pt.shape[1] * pages.shape[1]))
    ref = tatt.paged_mla_decode_attention(q, pages, pt, pos, 64)
    want = np.asarray(paged_mla_decode_attention_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(pages.float().numpy()), jnp.asarray(pt.numpy()),
        jnp.asarray(np.maximum(pos.numpy(), 0)), d_c=64, lookahead=False, interpret=True))
    for other in (ref, torch.from_numpy(np.array(want))):
        _, share = tol_share(got, other, "f32")
        assert share <= 1.0, f"share {share:.3f} of TOL['f32']"


def test_k5_split_rows_rule():
    """The tensor-core body's split rows at the shapes they were measured at
    (tools/time_decode.py MLA_SPLIT_SHAPES): 128 at the check and serve
    shape (B 16, a 2048-row table; the serve engine's 2112), 64 at B 4 and 1
    and in a 256-row table; multiples of the 64-row tile."""
    assert mla.tc_split_rows(16, 16, 2048) == 128 and mla.tc_split_rows(16, 16, 2112) == 128
    assert mla.tc_split_rows(4, 16, 2048) == mla.tc_split_rows(1, 16, 2048) == mla.tc_split_rows(16, 16, 256) == 64
    assert all(rows % 64 == 0 for rows in mla.TC_SPLIT_CHOICES)


@pytest.mark.parametrize("split_rows", [64, 128, 256])
def test_k5_tc_splits_match_plain(split_rows):
    """The split lengths the launcher was measured at: splits that start
    mid-context, end mid-tile and fall past the context, against the plain
    version at 16 heads, d_c 32 + d_r 8."""
    rng = np.random.default_rng(split_rows)
    q, pages, pt, pos = _decode_inputs(rng, 16, 32, 8, DECODE_POSITIONS)
    got = k5_tc_model(q, pages, pt, pos, 32, split_rows)
    _, share = tol_share(got, tatt.paged_mla_decode_attention(q, pages, pt, pos, 32), "f32")
    assert share <= 1.0, f"share {share:.3f} of TOL['f32']"


def test_single_bf16_rounding_of_q_leaves_the_limit_in_decode():
    """Why K5 splits q as K6 does: at DeepSeek-V2-Lite's width (16 heads,
    d_c 512, d_r 64) one bf16 rounding of the f32 queries puts decode
    outputs over short contexts outside TOL["f32"]; the split model on the
    same inputs stays inside."""
    rng = np.random.default_rng(1)
    q, pages, pt, pos = _decode_inputs(rng, 16, 512, 64, [0, 3, 9, 30, 63, 0])
    ref = tatt.paged_mla_decode_attention(q, pages, pt, pos, 512)
    _, rounded = tol_share(k5_tc_model(q, pages, pt, pos, 512, split_q=False), ref, "f32")
    _, split = tol_share(k5_tc_model(q, pages, pt, pos, 512), ref, "f32")
    assert rounded > 1.0, f"one rounding used {rounded:.3f} of the limit"
    assert split <= 1.0, f"the split used {split:.3f} of the limit"
