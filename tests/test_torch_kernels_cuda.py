"""The CUDA kernels K1 (paged decode), K2 (chunked-prefill flash), K3a / K3b
(their folded variants for a head_dim that is no multiple of 128),
K4a / K4b (the chunked and grouped decode variants), K5 (MLA latent
decode), K6 (MLA latent prefill) and the instruments K7a / K7b (load-only
twins of K2 / K1) and K7c (K1's function one page an iteration, with and
without rounded probabilities) against their plain PyTorch versions on the
card, K1-K3 and K7a also over int8 pools (``QuantizedPages``), at the
reference's head geometries: GQA groups of any size (G 3, 6, 7, and past 8
and 16), head_dim 256 to 1024 (past 512 on the runtime-D bodies), folded
head dims 8, 24, 80, 96, 192, 264, 320, 520 and 1000, and 100 and 20 (no
multiple of 8), and MLA at 4, 16 and 20 heads, at a latent row of d_c 1024
+ d_r 64 and at rows that start off 16 bytes (latent 36, d_c 30), and K8
(the weight-only int8 linear, plain and expert-bank forms, bf16 activations
on its wgmma body, f32 activations and out % 16 != 0 on its mma.sync body).
K2 and K5 also run at the speculative verify pass's shapes (16 lanes of
k+1 = 5 rows; 80 MLA query rows, each over its lane's repeated table).
K1 over
bf16 queries (its split tensor-core body and merge), K4a / K4b and K5 (both
bodies) give the same bits twice; K7c's
two toggles give K4b's and K1's bits on the same inputs. Marked ``cuda``: every test skips
where no CUDA device is visible (a CUDA kernel has no CPU mode). On a
machine with an H100 and nvcc (``--noconftest``: tests/conftest.py imports
jax, which the port does not need):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances, elementwise |got - ref| <= atol + rtol * |ref|: f32 atol 1e-4
(the same f32 algebra, summed in another order); bf16 the same atol plus
rtol 2^-6, two bf16 steps (both sides compute in f32 and round the output
once to bf16; two roundings of nearly equal values differ by at most one
step, <= 2^-7 |value|). Over int8 pools both sides read the same codes and
scales (the plain version dequantizes, the kernel scales score and
probability columns), so the limit is that of the query's dtype. K5 and K6 return f32 in both dtype mixes (f32
queries over f32 or bf16 pages; both sides read the same page values), so
both mixes are held to the f32 tolerance. K4a, K4b and K7c round their
probabilities to the pool dtype at the same points as their plain versions,
so they take the same limits; over random inputs at the serve batch (B 64)
the limit adds ``tools/checks.py rounding_slack`` (a probability at a bf16
rounding boundary may round either way). The K7 checksums are held exactly: their pools
hold multiples of 1/8 (int8: codes times the scale 2^-7), whose f32 sums are
exact in any order.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops.kernels.mla_attention import (
    paged_mla_decode_attention_kernel,
    paged_mla_prefill_attention_kernel,
)
from dynamo_tpu_torch.ops.kernels.paged_attention import (
    chunk_pages,
    paged_decode_attention_chunked_kernel,
    paged_decode_attention_folded_kernel,
    paged_decode_attention_grouped_kernel,
    paged_decode_attention_kernel,
    paged_decode_dmaonly_kernel,
    paged_decode_perseq_variant_kernel,
)
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention_folded_kernel,
    paged_prefill_attention_kernel,
    paged_prefill_dmaonly_kernel,
)
from dynamo_tpu_torch.quant.kv import QuantizedPages, quantize_kv_rows
from dynamo_tpu_torch.tools.checks import rounding_slack

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0), torch.bfloat16: dict(atol=1e-4, rtol=2.0**-6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _pools(rng, P, ps, Hkv, D, dtype, device):
    """K and V pools [P, ps, Hkv, D] of ``dtype``; for torch.int8, int8
    QuantizedPages of the same random rows."""
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)).to(device)
        if dtype == torch.int8:
            q, s = quantize_kv_rows(x.reshape(P * ps, Hkv, D))
            out.append(QuantizedPages(q.reshape(P, ps, Hkv, D), s.reshape(P, ps)))
        else:
            out.append(x.to(dtype))
    return out


# (query dtype, pool dtype) mixes: plain pools of the query's dtype, and
# int8 pools under either query dtype
MIXES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.int8), (torch.bfloat16, torch.int8)]
MIX_IDS = ["f32", "bf16", "f32-int8", "bf16-int8"]


def _decode_tables(rng, B, P, ps, max_pages, device):
    """Ragged positions (one-token context, the full table, random), distinct
    pages per sequence, an inactive slot (trash table, position 0) and a row
    at position -1 (attends context index 0 only)."""
    lengths = rng.integers(1, max_pages * ps + 1, B)
    lengths[:2] = (1, max_pages * ps)
    pt = np.zeros((B, max_pages), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        used = -(-lengths[b] // ps)
        pt[b, :used] = perm[b * max_pages : b * max_pages + used]
    pos = (lengths - 1).astype(np.int32)
    pt[-1], pos[-1] = 0, 0
    pos[-2] = -1
    return torch.from_numpy(pt).to(device), torch.from_numpy(pos).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,ps,Hq,Hkv", [(128, 16, 32, 8), (64, 128, 8, 8), (128, 128, 16, 2), (128, 16, 28, 4),
                                         (128, 16, 12, 2), (128, 16, 3, 1), (64, 16, 36, 2), (256, 16, 8, 2),
                                         (384, 16, 8, 2), (512, 16, 8, 2), (512, 16, 40, 2)])
def test_decode_kernel_matches_plain(cuda, dtype, D, ps, Hq, Hkv):
    """G 4, 1 and 2, and G 7, 6, 3 and 18 (three blocks of 6 heads a kv
    head); head_dim 256, 384 and 512 (bf16: two column slices; G 20 at 512:
    two 16-head tiles, f32 five sub-groups of 4)."""
    rng = np.random.default_rng(D + ps + Hq)
    B, max_pages = 12, 8
    P = B * max_pages + 1
    k, v = _pools(rng, P, ps, Hkv, D, dtype, cuda)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32)).to(cuda, dtype)
    lengths = rng.integers(1, max_pages * ps + 1, B)
    lengths[:2] = (1, max_pages * ps)  # one-token context, full table
    pt = np.zeros((B, max_pages), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        used = -(-lengths[b] // ps)
        pt[b, :used] = perm[b * max_pages : b * max_pages + used]
    pos = (lengths - 1).astype(np.int32)
    pt[-1] = 0  # an inactive slot: trash-page table, position 0
    pos[-1] = 0
    pt_t = torch.from_numpy(pt).to(cuda)
    pos_t = torch.from_numpy(pos).to(cuda)
    before = paged_decode_attention_kernel.launches
    got = paged_decode_attention_kernel(q, k, v, pt_t, pos_t)
    torch.cuda.synchronize()
    assert paged_decode_attention_kernel.launches == before + 1
    ref = tatt.paged_decode_attention(q, k, v, pt_t, pos_t)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,ps,Hq,Hkv", [(128, 16, 32, 8), (64, 128, 8, 8), (128, 16, 16, 2), (128, 16, 28, 4),
                                         (128, 16, 12, 2), (256, 16, 8, 2), (384, 16, 8, 2), (512, 16, 8, 2)])
def test_prefill_kernel_matches_plain_per_lane(cuda, dtype, D, ps, Hq, Hkv):
    """Three lanes in one launch: a chunk from position 0 with pad rows, a
    chunk after a cached prefix, and a pad lane (n=0, all-zero table); G 7
    and 6 leave the trailing rows of every 128-row block empty."""
    rng = np.random.default_rng(D + ps + Hq + 1)
    T, max_pages = 96, 16
    P = 2 * max_pages + 1
    k, v = _pools(rng, P, ps, Hkv, D, dtype, cuda)
    q = torch.from_numpy(rng.standard_normal((3 * T, Hq, D)).astype(np.float32)).to(cuda, dtype)
    starts = [0, min(200, max_pages * ps - T), 0]
    pt = np.zeros((3, max_pages), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for j in range(2):
        used = -(-(starts[j] + T) // ps)
        pt[j, :used] = perm[j * max_pages : j * max_pages + used]
    pos = np.stack([s + np.arange(T) for s in starts]).astype(np.int32)
    pt_t = torch.from_numpy(pt).to(cuda)
    pos_t = torch.from_numpy(pos).to(cuda)
    before = paged_prefill_attention_kernel.launches
    got = paged_prefill_attention_kernel(q, k, v, pt_t, pos_t)
    torch.cuda.synchronize()
    assert paged_prefill_attention_kernel.launches == before + 1
    assert torch.isfinite(got.float()).all()
    for j in range(3):
        ref = tatt.paged_prefill_attention(q[j * T : (j + 1) * T], k, v, pt_t[j], pos_t[j])
        torch.testing.assert_close(
            got[j * T : (j + 1) * T].float(), ref.float(), **TOL[dtype],
            msg=lambda m, j=j: f"lane {j}: {m}",
        )


@pytest.mark.parametrize("qdt,kvdt", MIXES[2:], ids=MIX_IDS[2:])
@pytest.mark.parametrize("D,ps,Hq,Hkv", [(128, 16, 32, 8), (64, 128, 8, 8), (256, 16, 8, 2), (384, 16, 8, 2),
                                         (512, 16, 8, 2)])
def test_decode_kernel_int8_matches_plain(cuda, qdt, kvdt, D, ps, Hq, Hkv):
    rng = np.random.default_rng(D + ps + 7)
    B, max_pages = 12, 8
    P = B * max_pages + 1
    k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32)).to(cuda, qdt)
    pt_t, pos_t = _decode_tables(rng, B, P, ps, max_pages, cuda)
    before = paged_decode_attention_kernel.launches
    got = paged_decode_attention_kernel(q, k, v, pt_t, pos_t)
    torch.cuda.synchronize()
    assert paged_decode_attention_kernel.launches == before + 1 and got.dtype == qdt
    torch.testing.assert_close(got.float(), tatt.paged_decode_attention(q, k, v, pt_t, pos_t).float(), **TOL[qdt])


@pytest.mark.parametrize("qdt,kvdt", MIXES[2:], ids=MIX_IDS[2:])
@pytest.mark.parametrize("D,ps,Hq,Hkv", [(128, 16, 32, 8), (64, 16, 8, 2), (128, 16, 28, 4), (256, 16, 8, 2),
                                         (384, 16, 8, 2), (512, 16, 8, 2)])
def test_prefill_kernel_int8_matches_plain(cuda, qdt, kvdt, D, ps, Hq, Hkv):
    rng = np.random.default_rng(D + ps + 8)
    T, max_pages = 96, 16
    P = 2 * max_pages + 1
    k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
    q = torch.from_numpy(rng.standard_normal((2 * T, Hq, D)).astype(np.float32)).to(cuda, qdt)
    pt = torch.from_numpy(rng.permutation(np.arange(1, P))[: 2 * max_pages].reshape(2, max_pages).astype(np.int32)).to(cuda)
    pos = torch.stack([torch.arange(s, s + T, dtype=torch.int32) for s in (0, 130)]).to(cuda)
    got = paged_prefill_attention_kernel(q, k, v, pt, pos)
    torch.cuda.synchronize()
    for j in range(2):
        ref = tatt.paged_prefill_attention(q[j * T : (j + 1) * T], k, v, pt[j], pos[j])
        torch.testing.assert_close(got[j * T : (j + 1) * T].float(), ref.float(), **TOL[qdt])


# (D, Hkv, Hq): TinyLlama's fold, G 1 and 4 at D 16 / 32 / 64, and the
# widened geometries: D 96 at G 3, D 80, D 8 over 16 kv heads, D 24 (K3b:
# tiles padded to 32 columns, over 3 kv heads an int8 row starts off 16
# bytes and arrives in 8-byte copies; K3a: D 8 and 24 are no multiple of 16,
# the FMA body), G 40 (three 16-head tiles a kv head), D 192 (K3b: the
# tensor-core body at 256 columns; K3a: the FMA body), D 100 and 20, no
# multiple of 8, whose rows start off 16 and off 8 bytes (the FMA bodies,
# every mix), and D 264 and 320 past 256 (K3a: the FMA body at 16 columns a
# lane; K3b: the wide body). K3a's bf16 queries at the other head dims below
# 128 run K1's split tensor-core body.
FOLDED = [(16, 8, 16), (32, 4, 32), (64, 4, 32), (64, 2, 16), (96, 4, 12), (80, 8, 16), (8, 16, 32), (24, 4, 8), (24, 3, 9),
          (64, 1, 40), (192, 2, 8), (100, 2, 8), (20, 4, 16), (264, 2, 8), (320, 2, 8)]


@pytest.mark.parametrize("qdt,kvdt", MIXES, ids=MIX_IDS)
@pytest.mark.parametrize("D,Hkv,Hq", FOLDED)
@pytest.mark.parametrize("B", [10, 1, 6, 64])
def test_folded_decode_kernel_matches_plain(cuda, qdt, kvdt, D, Hkv, Hq, B):
    """K3a over ragged contexts spanning several 128-row splits (B > 2: an
    inactive slot and a row at position -1), unfolded and folded pool
    views."""
    rng = np.random.default_rng(D + Hq + 9 + (B != 10) * B)
    ps, max_pages = 16, 40
    if B == 10:
        P = B * max_pages + 1
        k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
        q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32)).to(cuda, qdt)
        pt_t, pos_t = _decode_tables(rng, B, P, ps, max_pages, cuda)
    else:
        P, pt_t, pos_t = _variant_tables(rng, B, ps, max_pages, cuda)
        k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
        q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32)).to(cuda, qdt)
    before = paged_decode_attention_folded_kernel.launches
    got = paged_decode_attention_folded_kernel(q, k, v, pt_t, pos_t)
    torch.cuda.synchronize()
    assert paged_decode_attention_folded_kernel.launches == before + 1 and got.dtype == qdt
    ref = tatt.paged_decode_attention(q, k, v, pt_t, pos_t)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[qdt])
    if kvdt != torch.int8:
        folded = paged_decode_attention_folded_kernel(
            q, k.reshape(P, ps, Hkv * D), v.reshape(P, ps, Hkv * D), pt_t, pos_t)
        torch.testing.assert_close(folded, got, rtol=0, atol=0)


@pytest.mark.parametrize("qdt,kvdt", MIXES, ids=MIX_IDS)
@pytest.mark.parametrize("D,Hkv,Hq", FOLDED)
def test_folded_prefill_kernel_matches_plain(cuda, qdt, kvdt, D, Hkv, Hq):
    """K3b: three lanes in one launch (from position 0 with an odd length,
    after a cached prefix, and a pad lane with an all-zero table)."""
    rng = np.random.default_rng(D + Hq + 10)
    T, ps, max_pages = 75, 16, 24
    P = 2 * max_pages + 1
    k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
    q = torch.from_numpy(rng.standard_normal((3 * T, Hq, D)).astype(np.float32)).to(cuda, qdt)
    pt_np = np.zeros((3, max_pages), np.int32)
    pt_np[:2] = rng.permutation(np.arange(1, P))[: 2 * max_pages].reshape(2, max_pages)
    pt = torch.from_numpy(pt_np).to(cuda)
    pos = torch.stack([torch.arange(s, s + T, dtype=torch.int32) for s in (0, 250, 0)]).to(cuda)
    before = paged_prefill_attention_folded_kernel.launches
    got = paged_prefill_attention_folded_kernel(q, k, v, pt, pos)
    torch.cuda.synchronize()
    assert paged_prefill_attention_folded_kernel.launches == before + 1 and got.dtype == qdt
    assert torch.isfinite(got.float()).all()
    for j in range(3):
        ref = tatt.paged_prefill_attention(q[j * T : (j + 1) * T], k, v, pt[j], pos[j])
        torch.testing.assert_close(got[j * T : (j + 1) * T].float(), ref.float(), **TOL[qdt],
                                   msg=lambda m, j=j: f"lane {j}: {m}")


# (kernel, D, Hq, Hkv, ps, T, lane starts; None: a pad lane) at the edges of
# the 128-row block partition: profile_prefill's G 2 / ps 128, T no multiple
# of the block's positions, prefixes ending mid-page so 64-key tiles cross
# pages mid-tile, G 1 (128 positions a block) and G 8, K3b at D
# 16 and 32
PARTITION = [
    ("K2", 128, 16, 8, 128, 200, (0, 700, None)),
    ("K2", 128, 32, 8, 16, 75, (0, 37, None)),
    ("K2", 128, 8, 8, 32, 150, (3, 301)),
    ("K2", 64, 16, 2, 16, 100, (5, 300, None)),
    ("K3b", 16, 16, 2, 16, 75, (0, 45, None)),
    ("K3b", 32, 8, 4, 128, 90, (0, 200, None)),
]


@pytest.mark.parametrize("qdt,kvdt", MIXES, ids=MIX_IDS)
@pytest.mark.parametrize("which,D,Hq,Hkv,ps,T,starts", PARTITION,
                         ids=["k2-g2-ps128", "k2-ragged-t", "k2-g1", "k2-d64-g8", "k3b-d16", "k3b-d32-ps128"])
def test_prefill_partition_edges(cuda, qdt, kvdt, which, D, Hq, Hkv, ps, T, starts):
    kernel = paged_prefill_attention_kernel if which == "K2" else paged_prefill_attention_folded_kernel
    rng = np.random.default_rng(D + Hq + ps + T)
    max_pages = max(-(-((s or 0) + T) // ps) for s in starts) + 1
    P = len(starts) * max_pages + 1
    k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
    q = torch.from_numpy(rng.standard_normal((len(starts) * T, Hq, D)).astype(np.float32)).to(cuda, qdt)
    pt_np = np.zeros((len(starts), max_pages), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for j, s in enumerate(starts):
        if s is not None:
            pt_np[j] = perm[j * max_pages : (j + 1) * max_pages]
    pt = torch.from_numpy(pt_np).to(cuda)
    pos = torch.stack([torch.arange(s or 0, (s or 0) + T, dtype=torch.int32) for s in starts]).to(cuda)
    before = kernel.launches
    got = kernel(q, k, v, pt, pos)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.dtype == qdt
    assert torch.isfinite(got.float()).all()
    for j in range(len(starts)):
        ref = tatt.paged_prefill_attention(q[j * T : (j + 1) * T], k, v, pt[j], pos[j])
        torch.testing.assert_close(got[j * T : (j + 1) * T].float(), ref.float(), **TOL[qdt],
                                   msg=lambda m, j=j: f"lane {j}: {m}")


def test_launchers_raise_on_what_the_kernels_do_not_take(cuda):
    """Unsupported head dims, dtypes and pool mixes raise on CUDA tensors;
    nothing falls back to a plain version. Past head_dim 512 only the other
    kind of head_dim raises: K3a at 520 (through its launcher and the
    dispatcher) and K1 at 640 launch the runtime-D body and hold their plain
    versions; K1 at 520 and K3a at 640 raise."""
    rng = np.random.default_rng(11)
    pt = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    q520 = torch.from_numpy(rng.standard_normal((2, 8, 520)).astype(np.float32)).to(cuda)
    k520, v520 = _pools(rng, 5, 16, 2, 520, torch.float32, cuda)
    q640 = torch.from_numpy(rng.standard_normal((2, 8, 640)).astype(np.float32)).to(cuda)
    k640, v640 = _pools(rng, 5, 16, 2, 640, torch.float32, cuda)
    for call, args in ((paged_decode_attention_folded_kernel, (q520, k520, v520)),
                       (tatt.dispatch_paged_decode_attention, (q520, k520, v520)),
                       (paged_decode_attention_kernel, (q640, k640, v640))):
        got = call(*args, pt, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, tatt.paged_decode_attention(*args, pt, pos), **TOL[torch.float32])
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention_kernel(q520, k520, v520, pt, pos)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention_folded_kernel(q640, k640, v640, pt, pos)
    q = torch.zeros((2, 8, 64), device=cuda, dtype=torch.float16)
    k, v = _pools(rng, 5, 16, 2, 64, torch.float16, cuda)
    with pytest.raises(ValueError, match="dtype"):
        paged_decode_attention_folded_kernel(q, k, v, pt, pos)
    q = torch.zeros((2, 8, 64), device=cuda)
    k8, _ = _pools(rng, 5, 16, 2, 64, torch.int8, cuda)
    kf, vf = _pools(rng, 5, 16, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="QuantizedPages"):
        paged_decode_attention_folded_kernel(q, k8, vf, pt, pos)
    with pytest.raises(ValueError, match="dtype"):
        paged_decode_attention_kernel(q.repeat(1, 1, 2), kf.bfloat16().repeat(1, 1, 1, 2),
                                      vf.bfloat16().repeat(1, 1, 1, 2), pt, pos)
    qp = torch.zeros((64, 25, 64), device=cuda)  # Hq 25 over Hkv 2 (G 12 launches)
    with pytest.raises(ValueError, match="Hq"):
        paged_prefill_attention_folded_kernel(qp, kf, vf, pt[0], torch.arange(64, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="Hq"):
        paged_decode_attention_kernel(torch.zeros((2, 25, 128), device=cuda), *_pools(rng, 5, 16, 2, 128,
                                                                                       torch.float32, cuda), pt, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_launchers_take_head_dims_past_256(cuda, dtype):
    """What the launchers refused before: K3a at head_dim 264 (through its
    launcher and the dispatcher) and K1 at 512 launch and hold their plain
    versions."""
    rng = np.random.default_rng(11)
    pt = torch.tensor([[1, 2, 0, 0], [3, 0, 0, 0]], dtype=torch.int32, device=cuda)
    pos = torch.tensor([20, 5], dtype=torch.int32, device=cuda)
    for D, kernel in ((264, paged_decode_attention_folded_kernel), (512, paged_decode_attention_kernel)):
        q = torch.from_numpy(rng.standard_normal((2, 8, D)).astype(np.float32)).to(cuda, dtype)
        k, v = _pools(rng, 5, 16, 2, D, dtype, cuda)
        ref = tatt.paged_decode_attention(q, k, v, pt, pos).float()
        for call in (kernel, tatt.dispatch_paged_decode_attention):
            before = kernel.launches
            got = call(q, k, v, pt, pos)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            torch.testing.assert_close(got.float(), ref, **TOL[dtype])


@pytest.mark.parametrize("kvdt", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (64, 8, 2, 16), (256, 8, 2, 16), (512, 8, 2, 16)])
def test_decode_kernel_gives_the_same_bits_twice(cuda, kvdt, D, Hq, Hkv, ps):
    """K1 over bf16 queries merges its splits in fixed order, without
    atomics: two launches on the same inputs (B 64: ragged contexts up to
    2048 rows, an inactive slot, a row at -1) give the same bits."""
    rng = np.random.default_rng(D + Hq + ps + 15)
    P, pt, pos = _variant_tables(rng, 64, ps, 2048 // ps, cuda)
    k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
    q = torch.from_numpy(rng.standard_normal((64, Hq, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    first = paged_decode_attention_kernel(q, k, v, pt, pos)
    second = paged_decode_attention_kernel(q, k, v, pt, pos)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(), tatt.paged_decode_attention(q, k, v, pt, pos).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (128, 16, 8, 128), (512, 8, 2, 16)])
def test_perseq_variant_routes_each_toggle_to_its_body(cuda, D, Hq, Hkv, ps):
    """K7c over bf16 pools at B 64: without cast_f32 it gives K4b's bits (one
    page a unit) and holds its rounded plain version within TOL plus
    ``rounding_slack``; with cast_f32 it gives K1's bits and holds K1's plain
    version. Each toggle counts one K7c launch and none of the other
    kernel."""
    rng = np.random.default_rng(D + Hq + ps + 16)
    P, pt, pos = _variant_tables(rng, 64, ps, 2048 // ps, cuda)
    k, v = _pools(rng, P, ps, Hkv, D, torch.bfloat16, cuda)
    q = torch.from_numpy(rng.standard_normal((64, Hq, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    counts = [paged_decode_perseq_variant_kernel.launches, paged_decode_attention_grouped_kernel.launches,
              paged_decode_attention_kernel.launches]
    rounded = paged_decode_perseq_variant_kernel(q, k, v, pt, pos, cast_f32=False)
    exact = paged_decode_perseq_variant_kernel(q, k, v, pt, pos, cast_f32=True)
    assert [paged_decode_perseq_variant_kernel.launches, paged_decode_attention_grouped_kernel.launches,
            paged_decode_attention_kernel.launches] == [counts[0] + 2, counts[1], counts[2]]
    assert torch.equal(rounded, paged_decode_attention_grouped_kernel(q, k, v, pt, pos))
    assert torch.equal(exact, paged_decode_attention_kernel(q, k, v, pt, pos))
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    ref = tatt.paged_decode_perseq_variant(q, k, v, pt, pos).float()
    limit = tol["atol"] + tol["rtol"] * ref.abs() + rounding_slack(q, k, v, pt, pos, ps)
    assert not ((rounded.float() - ref).abs() > limit).any()
    torch.testing.assert_close(exact.float(), tatt.paged_decode_attention(q, k, v, pt, pos).float(), **tol)


def _variant_tables(rng, B, ps, max_pages, device):
    """Ragged contexts over up to max_pages pages (the first sequence one
    token, the second the full table when B > 1), distinct pages, and for B
    > 2 an inactive slot (trash table, position 0) and a row at -1."""
    lengths = rng.integers(1, max_pages * ps + 1, B)
    lengths[: min(B, 2)] = (1, max_pages * ps)[: min(B, 2)]
    P = B * max_pages + 1
    perm = rng.permutation(np.arange(1, P))
    pt = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        used = -(-lengths[b] // ps)
        pt[b, :used] = perm[b * max_pages : b * max_pages + used]
    pos = (lengths - 1).astype(np.int32)
    if B > 2:
        pt[-1], pos[-1] = 0, 0
        pos[-2] = -1
    return P, torch.from_numpy(pt).to(device), torch.from_numpy(pos).to(device)


def _exact_pools(rng, P, ps, Hkv, D, dtype, device):
    """K and V pools whose values are multiples of 1/8 in [-1, 1] (int8:
    codes times the scale 2^-7): every f32 sum of up to 2^16 of them is
    exact, in any order."""
    out = []
    for _ in range(2):
        if dtype == torch.int8:
            codes = torch.from_numpy(rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8)).to(device)
            out.append(QuantizedPages(codes, torch.full((P, ps), 2.0**-7, device=device)))
        else:
            x = rng.integers(-8, 9, (P, ps, Hkv, D)).astype(np.float32) / 8
            out.append(torch.from_numpy(x).to(device, dtype))
    return out


# (launcher, plain version, extra keyword arguments): K4a, K4b, K7c
ROUNDED = {
    "K4a": (paged_decode_attention_chunked_kernel, tatt.paged_decode_attention_chunked, {}),
    "K4b": (paged_decode_attention_grouped_kernel, tatt.paged_decode_attention_grouped, {}),
    "K7c": (paged_decode_perseq_variant_kernel, tatt.paged_decode_perseq_variant, {"cast_f32": False}),
    "K7c-cast": (paged_decode_perseq_variant_kernel, tatt.paged_decode_attention, {"cast_f32": True}),
}


@pytest.mark.parametrize("which", list(ROUNDED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (64, 8, 8, 16), (128, 16, 8, 128), (128, 28, 4, 16),
                                         (128, 48, 2, 16), (64, 12, 4, 24), (256, 8, 2, 16)])
@pytest.mark.parametrize("B", [1, 6, 16])
def test_decode_variant_matches_plain(cuda, which, dtype, D, Hq, Hkv, ps, B):
    """K4a (two or more 256-row chunks), K4b (splits of whole pages, 256
    rows and more) and K7c against their plain versions; K7c with cast_f32
    against K1's. G 4 and 1 at ps 16, the profilers' G 2 at ps 128 (K4a
    chunks of 2 pages), G 7, G 24 (K4b: two 16-head tiles; K4a, K7c: three
    blocks of 8 heads) and G 3 at page size 24 (K4b's 16-row k-steps span
    pages)."""
    kernel, plain, kw = ROUNDED[which]
    rng = np.random.default_rng(D + B + Hq + ps)
    max_pages = 640 // ps
    P, pt, pos = _variant_tables(rng, B, ps, max_pages, cuda)
    k, v = _pools(rng, P, ps, Hkv, D, dtype, cuda)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32)).to(cuda, dtype)
    before = kernel.launches
    got = kernel(q, k, v, pt, pos, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    ref = plain(q, k, v, pt, pos)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


def _exact_queries(rng, B, Hq, D, dtype, device):
    """Queries of multiples of 1/8 in [-1, 1]: over exact pools every q.k
    (at most 128 products of multiples of 1/64) is exact in f32 in any
    order."""
    return torch.from_numpy((rng.integers(-8, 9, (B, Hq, D)) / 8).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("which", ["K4a", "K4b", "K7c"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (64, 8, 8, 16), (128, 16, 8, 128), (128, 28, 4, 16),
                                         (128, 48, 2, 16), (64, 12, 4, 24), (256, 8, 2, 16), (384, 8, 2, 16),
                                         (512, 8, 2, 16)])
def test_rounded_variants_at_the_serve_batch(cuda, which, dtype, D, Hq, Hkv, ps):
    """K4a, K4b and K7c (rounded probabilities) at B 64 over exact inputs
    (head dims 384 and 512 here and in the next test, where random inputs
    are held with ``rounding_slack``: at D 512, K4b over random B 16 inputs
    rounds 11 of 65536 probabilities at a bf16 boundary the other way on an
    H100, by <= 4.9e-4).
    Over random inputs a probability whose f32 value lies within the dot
    products' summation-order noise of a bf16 rounding boundary rounds one
    way in the kernel and the other in the plain version: one bf16 step of
    that probability, which TOL does not bound where an output is near zero
    (K4a fails so at B 64, G 7 on an H100 in 4 of 229376 elements, by <= 3.1e-4).
    Exact scores give both sides the same f32 probabilities, so this holds
    the kernels' arithmetic to TOL unchanged."""
    kernel, plain, kw = ROUNDED[which]
    rng = np.random.default_rng(D + Hq + ps + 64)
    P, pt, pos = _variant_tables(rng, 64, ps, 640 // ps, cuda)
    k, v = _exact_pools(rng, P, ps, Hkv, D, dtype, cuda)
    q = _exact_queries(rng, 64, Hq, D, dtype, cuda)
    got = kernel(q, k, v, pt, pos, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), plain(q, k, v, pt, pos).float(), **TOL[dtype])


@pytest.mark.parametrize("which", ["K4a", "K4b", "K7c"])
@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (64, 8, 8, 16), (128, 16, 8, 128), (128, 28, 4, 16),
                                         (128, 48, 2, 16), (64, 12, 4, 24), (256, 8, 2, 16), (384, 8, 2, 16),
                                         (512, 8, 2, 16)])
def test_rounded_variants_at_the_serve_batch_over_random_inputs(cuda, which, D, Hq, Hkv, ps):
    """K4a, K4b and K7c at B 64 over random bf16 inputs (contexts up to 2048
    rows, an inactive slot, a row at -1), held to TOL plus
    ``tools/checks.py rounding_slack``: a probability within 2^-16 of a bf16
    rounding boundary may round either way (the scores' summation order),
    every other one must round where the plain version rounds it. Rounding
    at another point (K4a's chunks for K4b's pages, or not at all) breaks
    this bound in many elements
    (``test_rounding_slack_admits_score_noise_and_rejects_other_rounding_points``)."""
    kernel, plain, kw = ROUNDED[which]
    rng = np.random.default_rng(D + Hq + ps + 65)
    max_pages = 2048 // ps
    P, pt, pos = _variant_tables(rng, 64, ps, max_pages, cuda)
    k, v = _pools(rng, P, ps, Hkv, D, torch.bfloat16, cuda)
    q = torch.from_numpy(rng.standard_normal((64, Hq, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    got = kernel(q, k, v, pt, pos, **kw).float()
    torch.cuda.synchronize()
    ref = plain(q, k, v, pt, pos).float()
    chunk_rows = chunk_pages(ps, max_pages) * ps if which == "K4a" else ps
    tol = TOL[torch.bfloat16]
    limit = tol["atol"] + tol["rtol"] * ref.abs() + rounding_slack(q, k, v, pt, pos, chunk_rows)
    over = (got - ref).abs() > limit
    assert torch.isfinite(got).all() and not over.any(), (
        f"{int(over.sum())} of {over.numel()} elements past the limit, by up to "
        f"{float(((got - ref).abs() - limit).max()):.3g}")


@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (64, 8, 2, 16), (128, 16, 8, 128), (256, 8, 2, 16),
                                         (512, 8, 2, 16)])
def test_grouped_decode_gives_the_same_bits_twice(cuda, D, Hq, Hkv, ps):
    """K4b merges its splits in fixed order, without atomics: two launches
    on the same inputs (B 64: ragged contexts, an inactive slot, a row at
    -1) give the same bits."""
    rng = np.random.default_rng(D + Hq + ps + 13)
    P, pt, pos = _variant_tables(rng, 64, ps, 2048 // ps, cuda)
    k, v = _pools(rng, P, ps, Hkv, D, torch.bfloat16, cuda)
    q = torch.from_numpy(rng.standard_normal((64, Hq, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    first = paged_decode_attention_grouped_kernel(q, k, v, pt, pos)
    second = paged_decode_attention_grouped_kernel(q, k, v, pt, pos)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(), tatt.paged_decode_attention_grouped(q, k, v, pt, pos).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (64, 8, 2, 16), (128, 16, 8, 128), (256, 8, 2, 16),
                                         (384, 8, 2, 16)])
def test_chunked_decode_gives_the_same_bits_twice(cuda, D, Hq, Hkv, ps):
    """K4a on K4b's passes merges its splits in fixed order too: two
    launches on the same inputs (B 64) give the same bits."""
    rng = np.random.default_rng(D + Hq + ps + 14)
    P, pt, pos = _variant_tables(rng, 64, ps, 2048 // ps, cuda)
    k, v = _pools(rng, P, ps, Hkv, D, torch.bfloat16, cuda)
    q = torch.from_numpy(rng.standard_normal((64, Hq, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    first = paged_decode_attention_chunked_kernel(q, k, v, pt, pos)
    second = paged_decode_attention_chunked_kernel(q, k, v, pt, pos)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (64, 8, 8, 128), (128, 16, 8, 128), (128, 28, 4, 16),
                                         (256, 8, 2, 16), (384, 8, 2, 16), (512, 8, 2, 16)])
@pytest.mark.parametrize("B", [1, 6, 16])
def test_decode_dmaonly_checksum(cuda, dtype, D, Hq, Hkv, ps, B):
    rng = np.random.default_rng(D + B + 3)
    max_pages = max(2, 1024 // ps)
    P, pt, pos = _variant_tables(rng, B, ps, max_pages, cuda)
    k, v = _exact_pools(rng, P, ps, Hkv, D, dtype, cuda)
    q = torch.zeros((B, Hq, D), device=cuda, dtype=dtype)
    before = paged_decode_dmaonly_kernel.launches
    got = paged_decode_dmaonly_kernel(q, k, v, pt, pos)
    torch.cuda.synchronize()
    assert paged_decode_dmaonly_kernel.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, tatt.paged_decode_dmaonly(q, k, v, pt, pos), rtol=0, atol=0)


@pytest.mark.parametrize("qdt,kvdt", MIXES, ids=MIX_IDS)
@pytest.mark.parametrize("D,Hq,Hkv,ps", [(128, 32, 8, 16), (64, 8, 2, 16), (128, 16, 8, 128), (128, 12, 2, 16),
                                         (128, 28, 4, 16), (256, 8, 2, 16), (384, 8, 2, 16), (512, 8, 2, 16)])
def test_prefill_dmaonly_checksum(cuda, qdt, kvdt, D, Hq, Hkv, ps):
    """K7a over three lanes in one launch (from 0 with an odd length, after a
    cached prefix, a pad lane), K2's block partition; G 4 at ps 16, the
    profilers' G 2 at ps 128, and G 6 and 7 (blocks of 21 and 18
    positions)."""
    rng = np.random.default_rng(D + Hq + ps + 4)
    T, max_pages = 75, 384 // ps
    P = 2 * max_pages + 1
    k, v = _exact_pools(rng, P, ps, Hkv, D, kvdt, cuda)
    q = torch.zeros((3 * T, Hq, D), device=cuda, dtype=qdt)
    pt_np = np.zeros((3, max_pages), np.int32)
    pt_np[:2] = rng.permutation(np.arange(1, P))[: 2 * max_pages].reshape(2, max_pages)
    pt = torch.from_numpy(pt_np).to(cuda)
    pos = torch.stack([torch.arange(s, s + T, dtype=torch.int32) for s in (0, 250, 0)]).to(cuda)
    before = paged_prefill_dmaonly_kernel.launches
    got = paged_prefill_dmaonly_kernel(q, k, v, pt, pos)
    torch.cuda.synchronize()
    assert paged_prefill_dmaonly_kernel.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, tatt.paged_prefill_dmaonly(q, k, v, pt, pos), rtol=0, atol=0)


def test_decode_variants_raise_on_what_they_do_not_take(cuda):
    """An int8 cache, a folded head_dim, a mixed dtype and an oversized
    split raise; nothing falls back. K4a at page size 2048, which its FMA
    body refused (48 KB of scores), now runs on K4b's passes."""
    rng = np.random.default_rng(12)
    pt = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    q = torch.zeros((2, 8, 128), device=cuda, dtype=torch.bfloat16)
    k8, v8 = _pools(rng, 5, 16, 2, 128, torch.int8, cuda)
    for kernel in (paged_decode_attention_chunked_kernel, paged_decode_attention_grouped_kernel,
                   paged_decode_perseq_variant_kernel, paged_decode_dmaonly_kernel):
        with pytest.raises(ValueError, match="int8"):
            kernel(q, k8, v8, pt, pos)
    q32 = torch.zeros((2, 8, 32), device=cuda)
    k32, v32 = _pools(rng, 5, 16, 2, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention_grouped_kernel(q32, k32, v32, pt, pos)
    kb, vb = _pools(rng, 5, 16, 2, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="dtype"):
        paged_decode_attention_chunked_kernel(q.float(), kb, vb, pt, pos)
    kbig, vbig = _pools(rng, 3, 2048, 1, 128, torch.bfloat16, cuda)
    got = paged_decode_attention_chunked_kernel(q, kbig, vbig, pt[:, :1] + 1, pos + 2000)
    torch.testing.assert_close(got.float(), tatt.paged_decode_attention_chunked(
        q, kbig, vbig, pt[:, :1] + 1, pos + 2000).float(), **TOL[torch.bfloat16])
    khuge, vhuge = _pools(rng, 2, 4096, 1, 128, torch.bfloat16, cuda)  # a split's scores past 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        paged_decode_attention_chunked_kernel(q, khuge, vhuge, pt[:, :1], pos)


MLA_H, MLA_LATENT, MLA_DC = 16, 576, 512  # DeepSeek-V2(-Lite) geometry


def _mla_inputs(rng, n_q, P, ps, dtype, device):
    q = rng.standard_normal((n_q, MLA_H, MLA_LATENT)) / np.sqrt(MLA_LATENT)
    pages = rng.standard_normal((P, ps, MLA_LATENT))
    return (torch.from_numpy(q.astype(np.float32)).to(device),
            torch.from_numpy(pages.astype(np.float32)).to(device, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32-pages", "bf16-pages"])
@pytest.mark.parametrize("ps", [16, 128])
def test_mla_decode_kernel_matches_plain(cuda, dtype, ps):
    """Ragged contexts over several 128-row splits, an inactive slot (trash
    table, position 0) and a row at position -1 (attends row 0 only)."""
    rng = np.random.default_rng(ps + (dtype == torch.bfloat16))
    B, max_pages = 10, max(2, 1024 // ps)
    P = B * max_pages + 1
    q, pages = _mla_inputs(rng, B, P, ps, dtype, cuda)
    lengths = rng.integers(1, max_pages * ps + 1, B)
    lengths[:3] = (1, max_pages * ps, 129)
    pt = np.zeros((B, max_pages), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        used = -(-lengths[b] // ps)
        pt[b, :used] = perm[b * max_pages : b * max_pages + used]
    pos = (lengths - 1).astype(np.int32)
    pt[-2], pos[-2] = 0, 0  # inactive slot
    pos[-1] = -1
    pt_t = torch.from_numpy(pt).to(cuda)
    pos_t = torch.from_numpy(pos).to(cuda)
    before = paged_mla_decode_attention_kernel.launches
    got = paged_mla_decode_attention_kernel(q, pages, pt_t, pos_t, MLA_DC)
    torch.cuda.synchronize()
    assert paged_mla_decode_attention_kernel.launches == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    ref = tatt.paged_mla_decode_attention(q, pages, pt_t, pos_t, MLA_DC)
    torch.testing.assert_close(got, ref, **TOL[torch.float32])
    row0 = pages[pt[-1, 0], 0, :MLA_DC].float()
    torch.testing.assert_close(got[-1], row0.expand(MLA_H, -1), **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32-pages", "bf16-pages"])
@pytest.mark.parametrize("ps", [16, 128])
def test_mla_prefill_kernel_matches_plain(cuda, dtype, ps):
    """Chunks from position 0 and after a cached prefix, one of odd length
    (a block with one query position)."""
    rng = np.random.default_rng(ps + 2 + (dtype == torch.bfloat16))
    max_pages = max(2, 1024 // ps)
    P = max_pages + 1
    _, pages = _mla_inputs(rng, 1, P, ps, dtype, cuda)
    pt_t = torch.from_numpy(rng.permutation(np.arange(1, P))[:max_pages].astype(np.int32)).to(cuda)
    for T, start in ((256, 0), (255, 700), (64, 37)):
        q, _ = _mla_inputs(rng, T, 1, ps, dtype, cuda)
        pos_t = torch.arange(start, start + T, dtype=torch.int32, device=cuda)
        before = paged_mla_prefill_attention_kernel.launches
        got = paged_mla_prefill_attention_kernel(q, pages, pt_t, pos_t, MLA_DC)
        torch.cuda.synchronize()
        assert paged_mla_prefill_attention_kernel.launches == before + 1
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        ref = tatt.paged_mla_prefill_attention(q, pages, pt_t, pos_t, MLA_DC)
        torch.testing.assert_close(got, ref, **TOL[torch.float32], msg=lambda m: f"T {T} from {start}: {m}")


@pytest.mark.parametrize("H", [4, 20], ids=["h4-tiny-mla", "h20"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32-pages", "bf16-pages"])
def test_mla_kernels_take_any_head_count(cuda, dtype, H):
    """K5 and K6 at H 4 (the reference's tiny-mla) and 20 (a 16-head block
    and one of 4): the last block's heads past H are masked."""
    rng = np.random.default_rng(H + (dtype == torch.bfloat16))
    B, ps, max_pages = 6, 16, 40
    P = B * max_pages + 1
    pages = torch.from_numpy(rng.standard_normal((P, ps, MLA_LATENT)).astype(np.float32)).to(cuda, dtype)
    q = torch.from_numpy((rng.standard_normal((B, H, MLA_LATENT)) / np.sqrt(MLA_LATENT)).astype(np.float32)).to(cuda)
    pt, pos = _decode_tables(rng, B, P, ps, max_pages, cuda)
    got = paged_mla_decode_attention_kernel(q, pages, pt, pos, MLA_DC)
    torch.cuda.synchronize()
    assert got.shape == (B, H, MLA_DC) and torch.isfinite(got).all()
    torch.testing.assert_close(got, tatt.paged_mla_decode_attention(q, pages, pt, pos, MLA_DC), **TOL[torch.float32])
    T, start = 75, 300
    qp = torch.from_numpy((rng.standard_normal((T, H, MLA_LATENT)) / np.sqrt(MLA_LATENT)).astype(np.float32)).to(cuda)
    pos_p = torch.arange(start, start + T, dtype=torch.int32, device=cuda)
    got = paged_mla_prefill_attention_kernel(qp, pages, pt[1], pos_p, MLA_DC)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tatt.paged_mla_prefill_attention(qp, pages, pt[1], pos_p, MLA_DC),
                               **TOL[torch.float32])


@pytest.mark.parametrize("H", [4, 16, 20])
@pytest.mark.parametrize("T,start", [(37, 0), (512, 1536), (200, 701)], ids=["ragged", "check-shape", "mid-page"])
def test_mla_prefill_tensor_core_body_matches_plain(cuda, H, T, start):
    """K6 over bf16 pages (the tensor-core body: 64-row tiles of flattened
    (position, head) pairs, q and P split into bf16 hi + lo) at 4, 16 and 20
    heads, ragged chunk lengths (T H not a multiple of 64) and prefixes that
    start mid-page, held to TOL["f32"]."""
    rng = np.random.default_rng(H + T + start)
    ps, max_pages = 16, (start + T + 15) // 16
    P = max_pages + 1
    pages = torch.from_numpy(rng.standard_normal((P, ps, MLA_LATENT)).astype(np.float32)).to(cuda, torch.bfloat16)
    pt = torch.from_numpy(rng.permutation(np.arange(1, P)).astype(np.int32)).to(cuda)
    q = torch.from_numpy((rng.standard_normal((T, H, MLA_LATENT)) / np.sqrt(MLA_LATENT)).astype(np.float32)).to(cuda)
    pos = torch.arange(start, start + T, dtype=torch.int32, device=cuda)
    before = paged_mla_prefill_attention_kernel.launches
    got = paged_mla_prefill_attention_kernel(q, pages, pt, pos, MLA_DC)
    torch.cuda.synchronize()
    assert paged_mla_prefill_attention_kernel.launches == before + 1
    assert got.shape == (T, H, MLA_DC) and torch.isfinite(got).all()
    torch.testing.assert_close(got, tatt.paged_mla_prefill_attention(q, pages, pt, pos, MLA_DC), **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32-pages", "bf16-pages"])
def test_mla_kernels_take_wide_latent_rows(cuda, dtype):
    """K5 and K6 at d_c 1024 + d_r 64 (L 1088): the FMA body scores the row
    in 512-column chunks and slices d_c over two blocks."""
    rng = np.random.default_rng(1088 + (dtype == torch.bfloat16))
    H, L, dc, B, ps, max_pages = 4, 1088, 1024, 6, 16, 24
    P = B * max_pages + 1
    pages = torch.from_numpy(rng.standard_normal((P, ps, L)).astype(np.float32)).to(cuda, dtype)
    q = torch.from_numpy((rng.standard_normal((B, H, L)) / np.sqrt(L)).astype(np.float32)).to(cuda)
    pt, pos = _decode_tables(rng, B, P, ps, max_pages, cuda)
    got = paged_mla_decode_attention_kernel(q, pages, pt, pos, dc)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tatt.paged_mla_decode_attention(q, pages, pt, pos, dc), **TOL[torch.float32])
    T, start = 75, 200
    qp = torch.from_numpy((rng.standard_normal((T, H, L)) / np.sqrt(L)).astype(np.float32)).to(cuda)
    pos_p = torch.arange(start, start + T, dtype=torch.int32, device=cuda)
    got = paged_mla_prefill_attention_kernel(qp, pages, pt[1], pos_p, dc)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tatt.paged_mla_prefill_attention(qp, pages, pt[1], pos_p, dc),
                               **TOL[torch.float32])


@pytest.mark.parametrize("H", [4, 16, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32-pages", "bf16-pages"])
def test_mla_decode_gives_the_same_bits_twice(cuda, dtype, H):
    """K5 at DeepSeek-V2-Lite's latent width (bf16 pages: the tensor-core
    body, mla_decode_tc; f32 pages: the FMA body) over B 16 ragged contexts
    up to 2048 rows, an inactive slot and a row at -1: held to its plain
    version at TOL["f32"], and two launches give the same bits (the splits
    merge in a fixed order, without atomics)."""
    from dynamo_tpu_torch.ops.kernels.mla_attention import decode_on_tensor_cores

    rng = np.random.default_rng(H + 40 * (dtype == torch.bfloat16))
    P, pt, pos = _variant_tables(rng, 16, 16, 128, cuda)
    pages = torch.from_numpy(rng.standard_normal((P, 16, MLA_LATENT)).astype(np.float32)).to(cuda, dtype)
    q = torch.from_numpy((rng.standard_normal((16, H, MLA_LATENT)) / np.sqrt(MLA_LATENT)).astype(np.float32)).to(cuda)
    assert decode_on_tensor_cores(MLA_LATENT, MLA_DC, dtype) == (dtype == torch.bfloat16)
    first = paged_mla_decode_attention_kernel(q, pages, pt, pos, MLA_DC)
    second = paged_mla_decode_attention_kernel(q, pages, pt, pos, MLA_DC)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, tatt.paged_mla_decode_attention(q, pages, pt, pos, MLA_DC), **TOL[torch.float32])


@pytest.mark.parametrize("L,dc", [(36, 30), (37, 33), (40, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32-pages", "bf16-pages"])
def test_mla_kernels_take_any_latent_width(cuda, dtype, L, dc):
    """K5 and K6 at latent widths that are no multiple of 8 and d_c that is
    no multiple of 4 or 8 (a tiny-mla config of kv_lora_rank 30 +
    qk_rope_head_dim 6, and 33 + 4; rows that start off 16 bytes take the
    FMA body), and at 40 / 24 (the tensor-core bodies' preconditions)."""
    rng = np.random.default_rng(L + dc + (dtype == torch.bfloat16))
    B, ps, max_pages, H = 6, 16, 24, 4
    P = B * max_pages + 1
    pages = torch.from_numpy(rng.standard_normal((P, ps, L)).astype(np.float32)).to(cuda, dtype)
    q = torch.from_numpy((rng.standard_normal((B, H, L)) / np.sqrt(L)).astype(np.float32)).to(cuda)
    pt, pos = _decode_tables(rng, B, P, ps, max_pages, cuda)
    got = paged_mla_decode_attention_kernel(q, pages, pt, pos, dc)
    torch.cuda.synchronize()
    assert got.shape == (B, H, dc)
    torch.testing.assert_close(got, tatt.paged_mla_decode_attention(q, pages, pt, pos, dc), **TOL[torch.float32])
    T, start = 75, 200
    qp = torch.from_numpy((rng.standard_normal((T, H, L)) / np.sqrt(L)).astype(np.float32)).to(cuda)
    pos_p = torch.arange(start, start + T, dtype=torch.int32, device=cuda)
    got = paged_mla_prefill_attention_kernel(qp, pages, pt[1], pos_p, dc)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tatt.paged_mla_prefill_attention(qp, pages, pt[1], pos_p, dc),
                               **TOL[torch.float32])


WIDE_DECODE = {
    "K1": (paged_decode_attention_kernel, tatt.paged_decode_attention, MIXES),
    "K3a": (paged_decode_attention_folded_kernel, tatt.paged_decode_attention, MIXES),
    "K4a": (paged_decode_attention_chunked_kernel, tatt.paged_decode_attention_chunked, MIXES[:2]),
    "K4b": (paged_decode_attention_grouped_kernel, tatt.paged_decode_attention_grouped, MIXES[:2]),
    "K7c": (paged_decode_perseq_variant_kernel, tatt.paged_decode_attention_grouped, MIXES[:2]),
}


@pytest.mark.parametrize("which,D", [(w, D) for w in ("K1", "K4a", "K4b", "K7c") for D in (640, 768, 1024)]
                         + [("K3a", 520), ("K3a", 1000)])
def test_decode_launchers_take_head_dims_past_512(cuda, which, D):
    """Past 512 every decode launcher runs the runtime-D body in every mix
    it takes (B 12 over contexts up to 512 rows, an inactive slot, a row at
    -1) and holds its plain version; K4a, K4b and K7c round where their TPU
    kernels round (with the rounding slack over random inputs)."""
    kernel, plain, mixes = WIDE_DECODE[which]
    rng = np.random.default_rng(D + len(which))
    Hkv, ps = 2, 16
    P, pt, pos = _variant_tables(rng, 12, ps, 32, cuda)
    for qdt, kvdt in mixes:
        k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
        q = torch.from_numpy(rng.standard_normal((12, 4 * Hkv, D)).astype(np.float32)).to(cuda, qdt)
        before = kernel.launches
        got = kernel(q, k, v, pt, pos)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1 and got.dtype == qdt
        ref = plain(q, k, v, pt, pos).float()
        limit = TOL[qdt]["atol"] + TOL[qdt]["rtol"] * ref.abs()
        if which in ("K4a", "K4b", "K7c"):
            unit = chunk_pages(ps, pt.shape[1]) if which == "K4a" else 1
            limit = limit + rounding_slack(q, k, v, pt, pos, unit * ps)
        assert bool(((got.float() - ref).abs() <= limit).all()), f"{which} D {D} {qdt} / {kvdt}"


@pytest.mark.parametrize("which,D", [("K2", 640), ("K2", 1024), ("K3b", 520), ("K3b", 1000), ("K7a", 640)])
def test_prefill_launchers_take_head_dims_past_512(cuda, which, D):
    """K2 and K3b past 512 on the wide FMA body, and K7a's runtime-D twin
    (its checksums exactly, over exact pools), in every mix: a 96-row lane
    after a 200-row prefix beside a lane from 0."""
    rng = np.random.default_rng(D + len(which) + 7)
    Hkv, ps, T, mp = 2, 16, 96, 24
    P = 2 * mp + 1
    pt = torch.from_numpy((1 + rng.permutation(P - 1)).reshape(2, mp).astype(np.int32)).to(cuda)
    pos = torch.from_numpy(np.stack([s + np.arange(T) for s in (0, 200)]).astype(np.int32)).to(cuda)
    kernel = {"K2": paged_prefill_attention_kernel, "K3b": paged_prefill_attention_folded_kernel,
              "K7a": paged_prefill_dmaonly_kernel}[which]
    for qdt, kvdt in MIXES:
        q = torch.from_numpy(rng.standard_normal((2 * T, 4 * Hkv, D)).astype(np.float32)).to(cuda, qdt)
        if which == "K7a":
            k, v = _exact_pools(rng, P, ps, Hkv, D, kvdt, cuda)
            got = kernel(q, k, v, pt, pos)
            torch.cuda.synchronize()
            assert torch.equal(got, tatt.paged_prefill_dmaonly(q, k, v, pt, pos))
            continue
        k, v = _pools(rng, P, ps, Hkv, D, kvdt, cuda)
        got = kernel(q, k, v, pt, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), tatt.paged_prefill_attention_lanes(q, k, v, pt, pos).float(),
                                   **TOL[qdt])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_dmaonly_takes_head_dims_past_512(cuda, dtype):
    """K7b's runtime-D twin at 640 and 1024: its checksums exactly."""
    rng = np.random.default_rng(64)
    for D in (640, 1024):
        P, pt, pos = _variant_tables(rng, 12, 16, 32, cuda)
        k, v = _exact_pools(rng, P, 16, 2, D, dtype, cuda)
        q = torch.zeros((12, 8, D), device=cuda, dtype=dtype)
        got = paged_decode_dmaonly_kernel(q, k, v, pt, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, tatt.paged_decode_dmaonly(q, k, v, pt, pos))


# ---------------------------------------------------------------- K8


def _int8_inputs(rng, lead, K, N, dtype, cuda):
    from dynamo_tpu_torch.quant.int8 import quantize_int8

    w = torch.from_numpy((rng.standard_normal((*lead[:-1], K, N)) / np.sqrt(K)).astype(np.float32))
    qw = quantize_int8(w)
    h = torch.from_numpy(rng.standard_normal((*lead, K)).astype(np.float32)).to(cuda, dtype)
    return h, qw.q.to(cuda), qw.s.to(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T,K,N", [(1, 64, 48), (16, 4096, 1024), (37, 1024, 576), (64, 512, 1000),
                                   (130, 256, 384), (600, 2048, 256)])
def test_int8_linear_matches_plain(cuda, dtype, T, K, N):
    """K8 (2-D form) against its plain version (the f32 product of the same
    codes times the scale, cast once) at decode sizes (split K), at a width
    that is no multiple of 16 (4-byte copies) or of the 128-column tile,
    and at prefill sizes (64- and 128-row tiles); two launches give the
    same bits."""
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_kernel
    from dynamo_tpu_torch.quant.int8 import qlinear_plain

    h, q, s = _int8_inputs(np.random.default_rng(T + K + N), (T,), K, N, dtype, cuda)
    before = int8_linear_kernel.launches
    got = int8_linear_kernel(h, q, s)
    again = int8_linear_kernel(h, q, s)
    torch.cuda.synchronize()
    assert int8_linear_kernel.launches == before + 2 and got.dtype == dtype and got.shape == (T, N)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), qlinear_plain(h, q, s).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("E,C,K,N", [(4, 3, 256, 128), (8, 40, 512, 96), (64, 3, 2048, 1408)])
def test_int8_linear_expert_matches_plain(cuda, dtype, E, C, K, N):
    """K8's batched form over expert banks [E, C, in] x [E, in, out]."""
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_expert_kernel
    from dynamo_tpu_torch.quant.int8 import qlinear_plain

    h, q, s = _int8_inputs(np.random.default_rng(E + C + K), (E, C), K, N, dtype, cuda)
    got = int8_linear_expert_kernel(h, q, s)
    torch.cuda.synchronize()
    assert got.shape == (E, C, N)
    torch.testing.assert_close(got.float(), qlinear_plain(h, q, s).float(), **TOL[dtype])


def test_int8_linear_refuses_what_it_does_not_take(cuda):
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_kernel

    h, q, s = _int8_inputs(np.random.default_rng(0), (4,), 64, 48, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32 h"):
        int8_linear_kernel(h.half(), q, s)
    with pytest.raises(ValueError, match="out % 4"):
        int8_linear_kernel(h, q[:, :46].contiguous(), s[:46].contiguous())
    with pytest.raises(ValueError, match="in % 8"):
        int8_linear_kernel(h[:, :60].contiguous(), q[:60].contiguous(), s)
    with pytest.raises(ValueError, match="CUDA tensors"):
        int8_linear_kernel(h.cpu(), q.cpu(), s.cpu())


@pytest.mark.parametrize("T", [1, 8, 17, 600, 2048])
@pytest.mark.parametrize("K,N", [(1408, 576), (10944, 1408), (1408, 10944)])
def test_int8_linear_wgmma_body_matches_plain(cuda, T, K, N):
    """K8's wgmma body (bf16 h, out % 16 == 0) against its plain version at
    decode and prefill row counts (T tails at 1, 17 and 600; tiles of 8, 24
    and 128 rows), out 576, 1408 and 10944, in 1408 and 10944 (split over
    clusters where the tiles are few); two launches give the same bits."""
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_kernel, plan
    from dynamo_tpu_torch.quant.int8 import qlinear_plain

    assert plan(T, K, N).body == "wgmma"
    h, q, s = _int8_inputs(np.random.default_rng(T + K + N), (T,), K, N, torch.bfloat16, cuda)
    got = int8_linear_kernel(h, q, s)
    again = int8_linear_kernel(h, q, s)
    torch.cuda.synchronize()
    assert got.shape == (T, N) and torch.equal(got, again)
    torch.testing.assert_close(got.float(), qlinear_plain(h, q, s).float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("C", [3, 96])
@pytest.mark.parametrize("K,N", [(2048, 1408), (1408, 2048)])
def test_int8_linear_expert_wgmma_body_matches_plain(cuda, C, K, N):
    """The expert-bank form on the wgmma body: DeepSeek-V2-Lite's 64-expert
    gate / up and down banks at a decode step's 3 rows an expert and a
    prefill chunk's 96, one launch, the same bits twice."""
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_expert_kernel, plan
    from dynamo_tpu_torch.quant.int8 import qlinear_plain

    assert plan(C, K, N, 64).body == "wgmma"
    h, q, s = _int8_inputs(np.random.default_rng(C + K), (64, C), K, N, torch.bfloat16, cuda)
    got = int8_linear_expert_kernel(h, q, s)
    again = int8_linear_expert_kernel(h, q, s)
    torch.cuda.synchronize()
    assert got.shape == (64, C, N) and torch.equal(got, again)
    torch.testing.assert_close(got.float(), qlinear_plain(h, q, s).float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype,T,K,N", [(torch.float32, 16, 4096, 4096), (torch.float32, 600, 1408, 576),
                                         (torch.bfloat16, 37, 1000, 1000), (torch.bfloat16, 16, 4096, 1000)],
                         ids=["f32-decode", "f32-prefill", "bf16-out1000", "bf16-out1000-split"])
def test_int8_linear_mma_body_stays(cuda, dtype, T, K, N):
    """f32 activations and widths that are no multiple of 16 stay on the
    mma.sync body, within their limits, the same bits twice."""
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_kernel, plan
    from dynamo_tpu_torch.quant.int8 import qlinear_plain

    assert plan(T, K, N, 1, dtype).body == "mma"
    h, q, s = _int8_inputs(np.random.default_rng(T + K + N), (T,), K, N, dtype, cuda)
    got = int8_linear_kernel(h, q, s)
    again = int8_linear_kernel(h, q, s)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), qlinear_plain(h, q, s).float(), **TOL[dtype])


# ---------------------------------------------------------------- the speculative verify pass's shapes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (16, 8)])
def test_prefill_kernel_at_verify_lanes_matches_plain(cuda, dtype, Hq, Hkv):
    """K2 as the verify pass calls it: 16 lanes of k+1 = 5 rows at ragged
    anchors (a lane at position 0, one ending its table, an inactive lane on
    the zero table)."""
    rng = np.random.default_rng(Hq)
    B, T, ps, mp, D = 16, 5, 16, 32, 128
    P = B * mp + 1
    k, v = _pools(rng, P, ps, Hkv, D, dtype, cuda)
    q = torch.from_numpy(rng.standard_normal((B * T, Hq, D)).astype(np.float32)).to(cuda, dtype)
    anchors = rng.integers(0, mp * ps - T, B)
    anchors[:2] = (0, mp * ps - T)
    tables = (1 + np.arange(B * mp).reshape(B, mp)).astype(np.int32)
    tables[-1], anchors[-1] = 0, 0
    pos = (anchors[:, None] + np.arange(T)[None]).astype(np.int32)
    pt, pos_t = torch.from_numpy(tables).to(cuda), torch.from_numpy(pos).to(cuda)
    got = paged_prefill_attention_kernel(q, k, v, pt, pos_t)
    ref = tatt.paged_prefill_attention_lanes(q, k, v, pt, pos_t)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32-pages", "bf16-pages"])
def test_mla_decode_kernel_at_verify_rows_matches_plain(cuda, dtype):
    """K5 as the MLA verify pass calls it: B * (k+1) query rows, each with
    its lane's table (the table repeated k+1 times) and its own position."""
    rng = np.random.default_rng(7)
    B, T, ps, mp = 16, 5, 16, 64
    P = B * mp + 1
    q, pages = _mla_inputs(rng, B * T, P, ps, dtype, cuda)
    anchors = rng.integers(0, mp * ps - T, B)
    tables = (1 + np.arange(B * mp).reshape(B, mp)).astype(np.int32)
    pos = (anchors[:, None] + np.arange(T)[None]).astype(np.int32).reshape(B * T)
    pt = torch.from_numpy(np.repeat(tables, T, axis=0)).to(cuda)
    pos_t = torch.from_numpy(pos).to(cuda)
    got = paged_mla_decode_attention_kernel(q, pages, pt, pos_t, MLA_DC)
    ref = tatt.paged_mla_decode_attention(q, pages, pt, pos_t, MLA_DC)
    torch.testing.assert_close(got, ref, **TOL[torch.float32])
