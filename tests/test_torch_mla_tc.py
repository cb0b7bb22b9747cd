"""K6's tensor-core body (``csrc/mla_attention.cu mla_prefill_tc``) modelled
in torch on the CPU: the chunk's (position, head) pairs flattened
position-major into 64-row tiles, 32-key tiles of the latent context, S =
Q_hi.K^T + Q_lo.K^T with q split into bf16 hi and lo over bf16 pages (exact
keys), the causal and context masks per row, an online softmax in log2
units, and O += P_hi.V + P_lo.V with P split the same way, V the key tile's
first d_c columns. The model is held to the plain version
(``ops/attention.py paged_mla_prefill_attention``) and to the reference's
``paged_mla_prefill_attention_pallas`` in interpret mode at 4, 16 and 20
heads, at ``TOL["f32"]`` (atol 1e-4, no relative term: the limit the kernel
is held to on the card), and one bf16 rounding of q in place of the split is
shown to leave that limit. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.pallas.mla_attention import paged_mla_prefill_attention_pallas
from dynamo_tpu_torch.ops import attention as tatt
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
