"""The decode-kernel switch and the decode variants of the port on the CPU.

- The plain versions of K4a (chunked) and K4b (grouped), and the dispatcher
  under ``DYNTPU_DECODE_KERNEL=chunked`` / ``grouped``, against
  ``paged_decode_attention_pallas_chunked`` / ``_grouped`` in interpret mode
  on the same numpy-seeded inputs: contexts over 256 rows (K4a takes two or
  more chunks) and batches of 6 and 3 (K4b takes groups of 2 and 1).
- K7c's plain version against ``tools/profile_attn.py make_perseq_variant``
  under ``pltpu.force_tpu_interpret_mode()`` (that module parses
  ``sys.argv`` when it is imported, so ``sys.argv`` is patched first).
- The routing function, the launchers' refusals, the chunk and split
  choices, and a torch model of K4b's exact split over the context (splits
  combined by the prefix-max formula) against the sequential walk.
- The head dims past 256 that the launchers take (K1, K2, K4a, K4b at 384,
  512, 640 and 1024; K3a, K3b at 264, 320, 520 and 1000 over 2 kv heads):
  each argument check passes, and each plain version holds the reference's
  kernel in interpret mode (or, for a folded row that is no multiple of
  128, the reference's plain XLA version, as the reference routes it); a
  torch model of the runtime-D body the launchers run past 512 (a score
  pass with page maxima, a P.V pass that weighs each row at its unit's
  prefix max in column slices of 512, the merge) against the plain
  versions, with the probabilities rounded as each variant rounds them.
- The K7a / K7b checksums against numpy sums over the same partition.
- The engine's greedy tokens with ``chunked`` and with ``grouped`` against
  ``AsyncJaxEngine``'s on tiny f32 weights at head_dim 128.

Tolerances: f32 atol 2e-5, the reference's own for these kernels
(``tests/test_pallas_paged_attention.py``); bf16 1e-4 + 2^-6 |ref|
elementwise (``chip_smoke.py``'s rule: both sides round the same
probabilities to bf16 and the output once). The checksums run over values
that are multiples of 1/8, whose sums are exact in any order, and are held
exactly.
"""

import asyncio
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import AsyncJaxEngine
from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
from dynamo_tpu.ops import attention as jref
from dynamo_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_pallas,
    paged_decode_attention_pallas_chunked,
    paged_decode_attention_pallas_folded,
    paged_decode_attention_pallas_grouped,
)
from dynamo_tpu.ops.pallas.prefill_attention import (
    paged_prefill_attention_pallas,
    paged_prefill_attention_pallas_folded,
)
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops.kernels import paged_attention as pa
from dynamo_tpu_torch.ops.kernels import prefill_attention as pf
from dynamo_tpu_torch.ops.kernels.prefill_attention import ROWS_PER_BLOCK
from dynamo_tpu_torch.quant.kv import QuantizedPages

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def assert_within(got: np.ndarray, ref: np.ndarray, dtype: str) -> None:
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=2.0**-6)


def variant_case(B, Hq, Hkv, D, seed, ps=16, max_pages=24):
    """Distinct pages per sequence; positions 0 (a one-row context), up to
    the full 384-row table, and ragged ones past 256 rows."""
    rng = np.random.default_rng(seed)
    P = B * max_pages + 1
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pos = rng.integers(257, max_pages * ps, B).astype(np.int32)
    pos[0] = 0
    if B > 1:
        pos[1] = max_pages * ps - 1
    pt = np.zeros((B, max_pages), np.int32)
    perm = 1 + rng.permutation(P - 1)
    for b in range(B):
        used = pos[b] // ps + 1
        pt[b, :used] = perm[b * max_pages : b * max_pages + used]
    return q, k, v, pt, pos


def run_both(case, dtype, pallas_fn, plain_fn, **pallas_kw):
    jdt, tdt = DTYPES[dtype]
    q, k, v, pt, pos = case
    ref = np.asarray(pallas_fn(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(pt), jnp.asarray(pos),
                               **pallas_kw), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = plain_fn(tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(pos))
    return got, ref, (tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(pos))


K4 = {
    "chunked": (paged_decode_attention_pallas_chunked, tatt.paged_decode_attention_chunked),
    "grouped": (paged_decode_attention_pallas_grouped, tatt.paged_decode_attention_grouped),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,D", [(6, 8, 2, 128), (3, 4, 4, 64)], ids=["b6-gqa-d128", "b3-mha-d64"])
@pytest.mark.parametrize("choice", list(K4))
def test_k4_plain_matches_pallas_and_the_switch(monkeypatch, choice, B, Hq, Hkv, D, dtype):
    pallas_fn, plain_fn = K4[choice]
    case = variant_case(B, Hq, Hkv, D, seed=B + D)
    got, ref, args = run_both(case, dtype, pallas_fn, plain_fn, interpret=True)
    assert got.dtype == args[0].dtype
    assert_within(got.float().numpy(), ref, dtype)
    # the dispatcher takes this plain version under the switch (a folded
    # head_dim takes K3a's, the plain K1 function, whatever the switch)
    monkeypatch.setenv(tatt.DECODE_KERNEL_ENV, choice)
    dispatched = tatt.dispatch_paged_decode_attention(*args)
    want = got if not tatt.kv_folded(D) else tatt.paged_decode_attention(*args)
    torch.testing.assert_close(dispatched, want, rtol=0, atol=0)


def test_k4_plain_walks_the_reference_chunks():
    """K4a's chunk is C * ps rows with the reference's C; at ps 16 and 24
    pages that is 16 pages, so a 384-row context takes two chunks, and the
    rounded result differs from one page a chunk (K4b) in bf16."""
    assert pa.chunk_pages(16, 24) == 16 and pa.chunk_pages(128, 8) == 2 and pa.chunk_pages(512, 8) == 1
    assert pa.chunk_pages(16, 4) == 4  # never more pages than the table holds
    case = variant_case(4, 8, 2, 128, seed=3)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in case[:3])
    pt, pos = map(torch.from_numpy, case[3:])
    chunked = tatt.paged_decode_attention_chunked(tq, tk, tv, pt, pos)
    grouped = tatt.paged_decode_attention_grouped(tq, tk, tv, pt, pos)
    assert not torch.equal(chunked, grouped)
    one_chunk = tatt.paged_decode_attention_rounded(tq, tk, tv, pt, pos, 16 * 16)
    torch.testing.assert_close(chunked, one_chunk, rtol=0, atol=0)


@pytest.mark.parametrize("choice", [None, "lookahead", "perseq", "fused"])
def test_other_switch_values_take_k1(monkeypatch, choice):
    if choice is None:
        monkeypatch.delenv(tatt.DECODE_KERNEL_ENV, raising=False)
    else:
        monkeypatch.setenv(tatt.DECODE_KERNEL_ENV, choice)
    q, k, v, pt, pos = (torch.from_numpy(x) for x in variant_case(3, 8, 2, 128, seed=4))
    got = tatt.dispatch_paged_decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), pt, pos)
    want = tatt.paged_decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), pt, pos)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.fixture
def profile_attn(monkeypatch):
    """The reference's tools/profile_attn.py; it reads sys.argv[1:4] when
    imported, so argv is patched first."""
    monkeypatch.setattr(sys, "argv", ["profile_attn"])
    spec = importlib.util.spec_from_file_location("reference_profile_attn", ROOT / "tools" / "profile_attn.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cast_f32", [False, True], ids=["bf16-probs", "cast-f32"])
def test_k7c_plain_matches_perseq_variant(profile_attn, cast_f32, dtype):
    case = variant_case(3, 8, 2, 128, seed=5)
    with pltpu.force_tpu_interpret_mode():
        got, ref, _ = run_both(case, dtype, profile_attn.make_perseq_variant(cast_f32),
                               lambda *a: tatt.paged_decode_perseq_variant(*a, cast_f32=cast_f32))
    assert_within(got.float().numpy(), ref, dtype)


ROUTES = [
    # (head_dim, int8 cache, switch) -> launcher
    (128, False, "lookahead", pa.paged_decode_attention_kernel),
    (128, False, "perseq", pa.paged_decode_attention_kernel),
    (128, False, "anything", pa.paged_decode_attention_kernel),
    (128, False, "chunked", pa.paged_decode_attention_chunked_kernel),
    (128, False, "grouped", pa.paged_decode_attention_grouped_kernel),
    (128, True, "chunked", pa.paged_decode_attention_kernel),
    (128, True, "grouped", pa.paged_decode_attention_kernel),
    (64, False, "chunked", pa.paged_decode_attention_folded_kernel),
    (64, True, "grouped", pa.paged_decode_attention_folded_kernel),
    (256, False, "grouped", pa.paged_decode_attention_grouped_kernel),
]


@pytest.mark.parametrize("head_dim,quantized,choice,want", ROUTES)
def test_decode_routing(head_dim, quantized, choice, want):
    """The reference's rule: a folded head_dim takes K3a, an int8 cache K1,
    chunked / grouped K4a / K4b, every other value K1."""
    assert tatt.decode_kernel(head_dim, quantized, choice) is want
    assert want in tatt.PLAIN_DECODE


def test_decode_variant_launchers_refuse():
    """CPU tensors, an int8 cache, a folded head_dim and a mixed dtype raise;
    nothing falls back."""
    q, k, v, pt, pos = (torch.from_numpy(x) for x in variant_case(2, 4, 2, 128, seed=6))
    for launcher in (pa.paged_decode_attention_chunked_kernel, pa.paged_decode_attention_grouped_kernel,
                     pa.paged_decode_perseq_variant_kernel, pa.paged_decode_dmaonly_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            launcher(q, k, v, pt, pos)
    codes = torch.zeros(k.shape, dtype=torch.int8)
    int8 = QuantizedPages(codes, torch.ones(k.shape[:2]))
    with pytest.raises(ValueError, match="int8"):
        pa.check_variant_args(q, int8, int8, pt, pos, "K4a")
    with pytest.raises(ValueError, match="head_dim"):
        pa.check_variant_args(q[..., :32], k[..., :32], v[..., :32], pt, pos, "K4b")
    with pytest.raises(ValueError, match="dtype"):
        pa.check_variant_args(q, k.bfloat16(), v.bfloat16(), pt, pos, "K4a")


def k4b_split_model(q, k, v, pt, pos, starts, unit: int = 1):
    """The split algebra of K4b (``unit`` 1) and K4a (``unit`` =
    chunk_pages) in torch: every sequence's context cut at the rows
    ``starts`` (split s covers [starts[s], starts[s + 1])), each split
    walked as the kernels' pass 2 walks it, from the prefix max of the pages
    before it and at each page's rounding point M_i, the prefix max through
    the last page of its unit of ``unit`` pages (the page maxima come from
    the whole pages, pass 1; a unit's max is its pages' max), its
    probabilities rounded to the pool dtype before P.V and summed unrounded;
    then the splits merged as merge_splits does. Natural-log units: the
    scores are the plain version's own, so every rounded probability is the
    same value."""
    B, Hq, D = q.shape
    ps, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kc = tatt.gather_pages(k, pt).float()  # [B, S, Hkv, D]
    vc = tatt.gather_pages(v, pt).float()
    S = kc.shape[1]
    s_all = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, G, D), kc) * (1.0 / D**0.5)
    out = torch.empty((B, Hkv, G, D))
    for b in range(B):
        n = int(min(max(int(pos[b]) + 1, 1), S))
        s = s_all[b, ..., :n]
        pages = -(-n // ps)
        page_max = torch.stack([s[..., i * ps : (i + 1) * ps].amax(-1) for i in range(pages)], -1)
        unit_max = torch.stack([page_max[..., u : u + unit].amax(-1) for u in range(0, pages, unit)], -1)
        prefix = torch.cummax(unit_max, -1).values.repeat_interleave(unit, -1)[..., :pages]  # M_i
        parts = []
        for a, e in zip(starts, list(starts[1:]) + [S]):
            a, e = min(a, n), min(e, n)
            if a >= e:
                continue
            first = a // ps
            m = prefix[..., first - 1] if first else torch.full((Hkv, G), -1e30)
            l, acc = torch.zeros((Hkv, G)), torch.zeros((Hkv, G, D))
            for i in range(first, -(-e // ps)):
                lo, hi = max(a, i * ps), min(e, (i + 1) * ps)
                M = prefix[..., i]
                corr = torch.exp(m - M)
                p = torch.exp(s[..., lo:hi] - M[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("kgs,skd->kgd", p.to(k.dtype).float(), vc[b, lo:hi])
                m = M
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - M) for m, _, _ in parts]
        lsum = sum(wi * l for wi, (_, l, _) in zip(w, parts))
        out[b] = sum(wi[..., None] * acc for wi, (_, _, acc) in zip(w, parts)) / lsum.clamp(min=1e-20)[..., None]
    return out.reshape(B, Hq, D)


@pytest.mark.parametrize("starts", [(0,), (0, 160), (0, 64, 128, 256), (0, 37, 200, 201), (0, 256)],
                         ids=["one-split", "page-edge", "page-edges", "mid-page", "kernel-split"])
@pytest.mark.parametrize("ps", [16, 24])
def test_k4b_split_algebra_matches_the_sequential_walk(starts, ps):
    """Splits at page edges (the kernel's: whole pages of grouped_split_rows
    rows), mid-sequence and mid-page, at a page size the 16-row k-steps of
    the kernel divide and one they do not, over bf16 pools (probabilities
    rounded to bf16) with f32 queries (an f32 output): the splits combined
    by the prefix-max formula equal the sequential one-page-a-chunk walk
    (paged_decode_attention_grouped) at the f32 tolerance, atol 2e-5."""
    assert pa.grouped_split_rows(16) == 256 and pa.grouped_split_rows(24) == 264
    assert pa.grouped_split_rows(128) == 256 and pa.grouped_split_rows(512) == 512
    q, k, v, pt, pos = (torch.from_numpy(x) for x in variant_case(5, 8, 2, 64, seed=ps + len(starts), ps=ps))
    # bf16 pools round the probabilities; f32 queries keep the output f32
    q, k, v = q.bfloat16().float(), k.bfloat16(), v.bfloat16()
    pos[2] = -1  # attends row 0 only
    got = k4b_split_model(q, k, v, pt, pos, starts)
    want = tatt.paged_decode_attention_grouped(q, k, v, pt, pos)
    assert want.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("starts", [(0,), (0, 256), (0, 100, 300), (0, 37, 200, 201)],
                         ids=["one-split", "kernel-split", "mid-unit", "mid-page"])
@pytest.mark.parametrize("ps", [16, 24])
def test_k4a_unit_algebra_matches_the_reference_chunked_kernel(starts, ps):
    """K4a on K4b's passes: the split model at K4a's rounding unit
    (chunk_pages: 16 pages at page size 16, 11 at 24; the kernel's splits of
    grouped_split_rows rows, 256 and 264, end on unit edges, the other
    splits fall mid-unit and mid-page) over bf16 pools with bf16-valued f32
    queries equals the plain chunked walk at atol 2e-5, and the reference's
    chunked kernel in interpret mode (all bf16, a bf16 output) at the bf16
    limit."""
    unit = pa.chunk_pages(ps, 24)
    assert unit == -(-256 // ps)
    case = variant_case(5, 8, 2, 64, seed=ps + 7 * len(starts), ps=ps)
    q, k, v, pt, pos = (torch.from_numpy(x) for x in case)
    q, k, v = q.bfloat16().float(), k.bfloat16(), v.bfloat16()
    got = k4b_split_model(q, k, v, pt, pos, starts, unit)
    torch.testing.assert_close(got, tatt.paged_decode_attention_chunked(q, k, v, pt, pos), atol=2e-5, rtol=0)
    want = np.asarray(paged_decode_attention_pallas_chunked(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)), jnp.asarray(pt.numpy()),
        jnp.asarray(pos.numpy()), interpret=True), np.float32)
    assert_within(got.bfloat16().float().numpy(), want, "bf16")


@pytest.mark.parametrize("Hq,Hkv,ps", [(8, 2, 16), (12, 4, 24), (4, 2, 128)])
def test_rounding_slack_admits_score_noise_and_rejects_other_rounding_points(Hq, Hkv, ps):
    """``tools/checks.py rounding_slack``, the card tests' allowance for
    K4a, K4b and K7c over random bf16 inputs at the serve batch: K4b's plain
    version with its scores summed in another order (q's and K's head-dim
    columns permuted alike) or shifted by 1e-6 of themselves stays within
    the bf16 TOL plus the slack; the same inputs rounded at other points
    (chunks of 8 pages, or f32 probabilities) break it in many elements."""
    from dynamo_tpu_torch.tools.checks import rounding_slack

    case = variant_case(16, Hq, Hkv, 128, seed=Hq + ps, ps=ps, max_pages=640 // ps)
    q, k, v, pt, pos = (torch.from_numpy(x) for x in case)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    want = tatt.paged_decode_attention_grouped(q, k, v, pt, pos).float()
    limit = 1e-4 + 2.0**-6 * want.abs() + rounding_slack(q, k, v, pt, pos, ps)
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(ps))
    for same in (tatt.paged_decode_attention_grouped(q[..., perm], k[..., perm].contiguous(), v, pt, pos),
                 tatt.paged_decode_attention_grouped(q.float() * (1 + 1e-6), k, v, pt, pos)):
        assert bool(((same.float() - want).abs() <= limit).all())
    for other in (tatt.paged_decode_attention_rounded(q, k, v, pt, pos, 8 * ps),
                  tatt.paged_decode_attention(q, k, v, pt, pos)):
        assert int(((other.float() - want).abs() > limit).sum()) >= 20


def exact_pools(rng, P, ps, Hkv, D, int8: bool):
    """K and V pools of multiples of 1/8 (int8: codes x 2^-7) as torch, and
    their f64 values as numpy."""
    pools, dense = [], []
    for _ in range(2):
        if int8:
            codes = rng.integers(-127, 128, (P, ps, Hkv, D)).astype(np.int8)
            pools.append(QuantizedPages(torch.from_numpy(codes), torch.full((P, ps), 2.0**-7)))
            dense.append(codes.astype(np.float64) * 2.0**-7)
        else:
            x = rng.integers(-8, 9, (P, ps, Hkv, D)) / 8
            pools.append(torch.from_numpy(x.astype(np.float32)))
            dense.append(x)
    return pools, dense


def test_decode_dmaonly_checksum_matches_numpy():
    """K7b: out[b, h] = sum over j < min(max(pos + 1, 1), S) of (K + V)[j,
    kv(h)], one row per head of each kv head."""
    rng = np.random.default_rng(7)
    B, Hq, Hkv, D, ps, mp = 5, 8, 2, 128, 16, 8
    P = B * mp + 1
    (k, v), (kd, vd) = exact_pools(rng, P, ps, Hkv, D, int8=False)
    pt = (1 + rng.permutation(P - 1)[: B * mp]).reshape(B, mp).astype(np.int32)
    pos = np.array([-1, 0, 17, 127, 200], np.int32)  # 200 is past the table: clipped to 128 rows
    got = tatt.paged_decode_dmaonly(torch.zeros((B, Hq, D)), k, v, torch.from_numpy(pt), torch.from_numpy(pos))
    G = Hq // Hkv
    for b in range(B):
        n = min(max(pos[b] + 1, 1), mp * ps)
        rows = [(pt[b, j // ps], j % ps) for j in range(n)]
        want = sum(kd[p, r] + vd[p, r] for p, r in rows)  # [Hkv, D]
        np.testing.assert_array_equal(got[b].numpy(), np.repeat(want, G, axis=0))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("G", [4, 8])
def test_prefill_dmaonly_checksum_matches_numpy(int8, G):
    """K7a: K2's blocks of ROWS_PER_BLOCK // G query positions; every row
    of a block gets the sums over j < min(block's last position + 1, S),
    int8 rows dequantized. Two lanes (from 0 with an odd length, after a
    prefix) and a pad lane."""
    rng = np.random.default_rng(8 + G)
    Hkv, D, ps, mp, T = 2, 64, 16, 12, 37
    Hq = G * Hkv
    P = 2 * mp + 1
    (k, v), (kd, vd) = exact_pools(rng, P, ps, Hkv, D, int8)
    pt = np.zeros((3, mp), np.int32)
    pt[:2] = (1 + rng.permutation(P - 1)[: 2 * mp]).reshape(2, mp)
    pos = np.stack([s + np.arange(T) for s in (0, 150, 0)]).astype(np.int32)
    got = tatt.paged_prefill_dmaonly(torch.zeros((3 * T, Hq, D)), k, v, torch.from_numpy(pt),
                                     torch.from_numpy(pos)).numpy().reshape(3, T, Hq, D)
    BQ = ROWS_PER_BLOCK // G
    for n in range(3):
        for b0 in range(0, T, BQ):
            last = pos[n, min(b0 + BQ, T) - 1]
            rows = [(pt[n, j // ps], j % ps) for j in range(min(last + 1, mp * ps))]
            want = np.repeat(sum(kd[p, r] + vd[p, r] for p, r in rows), G, axis=0)
            np.testing.assert_array_equal(got[n, b0 : b0 + BQ], np.broadcast_to(want, got[n, b0 : b0 + BQ].shape))


# ---------------------------------------------------------------- engine

D128 = {"head_dim": 128}  # a head_dim the switch reaches (tiny's 16 is folded)
ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
PROMPTS = [[5, 9, 2, 77, 31], list(range(40, 51)), [200 - i for i in range(20)]]


async def collect(engine, req):
    toks = []
    async for out in engine.generate(req):
        if out.token is not None:
            toks.append(out.token)
    return toks


@pytest.fixture(scope="module")
def jax_reference():
    """(greedy tokens of the JAX engine per prompt, its params as numpy) at
    tiny geometry with head_dim 128."""

    async def run():
        cfg = JaxEngineConfig(model_id="tiny:" + json.dumps(D128), tp=1, **ENGINE)
        engine = AsyncJaxEngine(cfg)
        await engine.start()
        try:
            outs = await asyncio.gather(*(
                collect(engine, JaxEngineRequest(f"j{i}", p, JaxSamplingParams(max_tokens=10)))
                for i, p in enumerate(PROMPTS)
            ))
            params = jax.tree.map(np.asarray, jax.device_get(engine.runner.params))
        finally:
            await engine.shutdown()
        return outs, params

    return asyncio.run(run())


@pytest.mark.parametrize("choice", ["chunked", "grouped"])
def test_engine_greedy_tokens_under_the_switch_equal_jax_engine(monkeypatch, jax_reference, choice):
    ref_outs, params = jax_reference
    cfg = LlamaConfig.tiny(**D128)
    model = LlamaModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    launcher = tatt.decode_kernel(cfg.head_dim, False, choice)
    plain = tatt.PLAIN_DECODE[launcher]
    calls = []
    monkeypatch.setitem(tatt.PLAIN_DECODE, launcher, lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setenv(tatt.DECODE_KERNEL_ENV, choice)

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", **ENGINE), model=model)
        await engine.start()
        try:
            return await asyncio.gather(*(
                collect(engine, EngineRequest(f"t{i}", p, SamplingParams(max_tokens=10)))
                for i, p in enumerate(PROMPTS)
            ))
        finally:
            await engine.shutdown()

    outs = asyncio.run(run())
    assert calls, f"the {choice} plain version never ran"
    assert outs == ref_outs and all(len(t) == 10 for t in outs)


def _decode_args(Hq, Hkv, D, dtype=torch.float32):
    return (torch.zeros((2, Hq, D), dtype=dtype), *[torch.zeros((5, 16, Hkv, D), dtype=dtype)] * 2,
            torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int32))


def _prefill_args(Hq, Hkv, D, dtype=torch.float32):
    return (torch.zeros((32, Hq, D), dtype=dtype), *[torch.zeros((5, 16, Hkv, D), dtype=dtype)] * 2,
            torch.zeros((1, 4), dtype=torch.int32), torch.arange(32, dtype=torch.int32)[None])


# the shapes the reference serves that the launchers refused before: head_dim
# 256 and every larger multiple of 128 (384 up to 1024 here) on K1, K2, K4a,
# K4b, K7a-c; folded 192, 100, 20, 264, 320, 520 and 1000 on K3a and K3b
WIDE_SHAPES = {
    "K1-D256": lambda: pa.check_decode_args(*_decode_args(8, 2, 256)),
    "K4a-D256": lambda: pa.check_variant_args(*_decode_args(8, 2, 256, torch.bfloat16), "K4a"),
    "K4b-D256": lambda: pa.check_variant_args(*_decode_args(8, 2, 256, torch.bfloat16), "K4b"),
    "K7b-D256": lambda: pa.check_variant_args(*_decode_args(8, 2, 256), "K7b"),
    "K7c-D256": lambda: pa.check_variant_args(*_decode_args(8, 2, 256), "K7c"),
    "K2-D256": lambda: pf.check_prefill_args(*_prefill_args(8, 2, 256, torch.bfloat16)),
    "K7a-D256": lambda: pf.check_prefill_args(*_prefill_args(8, 2, 256), "K7a"),
    "K3a-D192": lambda: pa.check_folded_decode_args(*_decode_args(8, 2, 192, torch.bfloat16)),
    "K3a-D100": lambda: pa.check_folded_decode_args(*_decode_args(8, 2, 100)),
    "K3a-D20": lambda: pa.check_folded_decode_args(*_decode_args(16, 4, 20, torch.bfloat16)),
    "K3b-D192": lambda: pf.check_folded_prefill_args(*_prefill_args(8, 2, 192)),
    "K3b-D100": lambda: pf.check_folded_prefill_args(*_prefill_args(8, 2, 100, torch.bfloat16)),
    "K3b-D20": lambda: pf.check_folded_prefill_args(*_prefill_args(16, 4, 20)),
    **{f"{name}-D{D}": (lambda check, D=D: lambda: check(D))(check)
       for D in (384, 512, 640, 768, 1024) for name, check in {
           "K1": lambda D: pa.check_decode_args(*_decode_args(8, 2, D, torch.bfloat16)),
           "K4a": lambda D: pa.check_variant_args(*_decode_args(8, 2, D, torch.bfloat16), "K4a"),
           "K4b": lambda D: pa.check_variant_args(*_decode_args(8, 2, D), "K4b"),
           "K7b": lambda D: pa.check_variant_args(*_decode_args(8, 2, D), "K7b"),
           "K7c": lambda D: pa.check_variant_args(*_decode_args(8, 2, D, torch.bfloat16), "K7c"),
           "K2": lambda D: pf.check_prefill_args(*_prefill_args(8, 2, D)),
           "K7a": lambda D: pf.check_prefill_args(*_prefill_args(8, 2, D, torch.bfloat16), "K7a"),
       }.items()},
    **{f"{name}-D{D}": (lambda check, D=D: lambda: check(D))(check)
       for D in (264, 320, 520, 1000) for name, check in {
           "K3a": lambda D: pa.check_folded_decode_args(*_decode_args(8, 2, D, torch.bfloat16)),
           "K3b": lambda D: pf.check_folded_prefill_args(*_prefill_args(8, 2, D)),
       }.items()},
}


@pytest.mark.parametrize("which", list(WIDE_SHAPES))
def test_launcher_checks_take_the_reference_head_geometries(which):
    """Each shape's argument check passes (run here on CPU tensors: the
    checks precede any launch); the launchers then launch a kernel on the
    card (chip_smoke.py WIDENED, tests/test_torch_kernels_cuda.py)."""
    WIDE_SHAPES[which]()


def _wide_decode(which, D, dtype):
    """(port output, reference output) of one decode launcher's plain
    version at D over 2 kv heads (G 2; K4a over two 256-row chunks)."""
    Hkv = 2
    case = variant_case(3, 2 * Hkv, Hkv, D, seed=D + len(which), max_pages=20)
    if which == "K3a":  # the reference reads the folded pools: its kernel where a row is lane-aligned
        q, k, v, pt, pos = case
        fold = lambda x: jnp.asarray(x.reshape(*x.shape[:2], Hkv * D))  # noqa: E731
        jargs = (jnp.asarray(q), fold(k), fold(v), jnp.asarray(pt), jnp.asarray(pos))
        ref = (paged_decode_attention_pallas_folded(*jargs, interpret=True) if Hkv * D % 128 == 0
               else jref.paged_decode_attention(*jargs))
        t = [torch.from_numpy(x) for x in case]
        pa.check_folded_decode_args(*t)
        return tatt.dispatch_paged_decode_attention(*t), np.asarray(ref, np.float32)
    pallas_fn, plain_fn = {
        "K1": (paged_decode_attention_pallas, tatt.paged_decode_attention),
        "K4a": K4["chunked"],
        "K4b": K4["grouped"],
    }[which]
    got, ref, args = run_both(case, dtype, pallas_fn, plain_fn, interpret=True)
    if which == "K1":
        pa.check_decode_args(*args)
    else:
        pa.check_variant_args(*args, which)
    return got, ref


def _wide_prefill(which, D):
    """(port output, reference output) of K2's or K3b's plain version: a
    64-row chunk after a 37-row prefix over 2 kv heads (G 2)."""
    Hkv, T, start, ps, mp = 2, 64, 37, 16, 8
    rng = np.random.default_rng(D + len(which))
    P = mp + 1
    q = rng.standard_normal((T, 2 * Hkv, D)).astype(np.float32)
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pt = (1 + rng.permutation(mp)).astype(np.int32)
    pos = (start + np.arange(T)).astype(np.int32)
    t = [torch.from_numpy(x) for x in (q, k, v, pt, pos)]
    if which == "K2":
        pf.check_prefill_args(t[0], t[1], t[2], t[3][None], t[4][None])
        jargs = [jnp.asarray(x) for x in (q, k, v, pt, pos)]
        ref = paged_prefill_attention_pallas(*jargs, block_q=64, interpret=True, lookahead=False)
    else:
        pf.check_folded_prefill_args(t[0], t[1], t[2], t[3][None], t[4][None])
        fold = lambda x: jnp.asarray(x.reshape(*x.shape[:2], Hkv * D))  # noqa: E731
        jargs = (jnp.asarray(q), fold(k), fold(v), jnp.asarray(pt), jnp.asarray(pos))
        ref = (paged_prefill_attention_pallas_folded(*jargs, block_q=64, interpret=True) if Hkv * D % 128 == 0
               else jref.paged_prefill_attention(*jargs))
    return tatt.dispatch_paged_prefill_attention(*t), np.asarray(ref, np.float32)


@pytest.mark.parametrize("which,D", [(w, D) for w in ("K1", "K2", "K4a", "K4b") for D in (384, 512, 640, 1024)]
                         + [(w, D) for w in ("K3a", "K3b") for D in (264, 320, 520, 1000)])
def test_head_dims_past_256_match_the_reference(which, D):
    """The launchers take head_dim 384, 512, 640 and 1024 (K1, K2, K4a,
    K4b) and the folded 264, 320, 520 and 1000 over 2 kv heads (K3a, K3b):
    each argument check passes, and each plain version, the function the
    kernel is held to on the card, equals the reference's. K4a and K4b in
    bf16 (their rounding at work), the others in f32."""
    if which in ("K2", "K3b"):
        got, ref = _wide_prefill(which, D)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
        return
    dtype = "bf16" if which in ("K4a", "K4b") else "f32"
    got, ref = _wide_decode(which, D, dtype)
    assert_within(got.float().numpy(), ref, dtype)


@pytest.mark.parametrize("D", [520, 640])
def test_head_dims_past_512_stay_refused(D):
    """Past 512 no launcher has a head_dim budget: each takes its own kind
    of head_dim (K1 / K2 / K4 / K7 a multiple of 128, K3a / K3b any other)
    and refuses only the other kind, which the reference routes to the other
    kernels too."""
    own = [(lambda D: pa.check_decode_args(*_decode_args(8, 2, D)), 640),
           (lambda D: pf.check_prefill_args(*_prefill_args(8, 2, D)), 640),
           (lambda D: pa.check_folded_decode_args(*_decode_args(8, 2, D)), 520),
           (lambda D: pf.check_folded_prefill_args(*_prefill_args(8, 2, D)), 520)]
    for check, takes in own:
        if D == takes:
            check(D)
        else:
            with pytest.raises(ValueError, match="head_dim"):
                check(D)


def wide_decode_model(q, k, v, pt, pos, unit: int, round_p: bool, ks=None, vs=None) -> torch.Tensor:
    """The runtime-D body past head_dim 512 (``csrc/paged_attention.cu``
    wide_scores, wide_pv, merge_splits) in torch: splits of
    grouped_split_rows(ps) rows; pass 1 the scores s = q.k / sqrt(D) (int8:
    times the row's K scale) and each page's max; pass 2 page i's rounding
    point M_i, the max of the page maxima through the last page of its unit
    of ``unit`` pages (clipped to the context), M the split's last page's,
    each row weighed by e^(M_i - M) R(e^(s - M_i)) (R: bf16 rounding where
    ``round_p``, else none; int8: times the V scale) with l summing e^(M_i -
    M) e^(s - M_i), in column slices of 512; the splits merged in log2
    units as merge_splits merges them."""
    B, Hq, D = q.shape
    ps, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kc = tatt.gather_pages(k, pt).float()  # [B, S, Hkv, D]
    vc = tatt.gather_pages(v, pt).float()
    S = kc.shape[1]
    s_all = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, G, D), kc) * float(np.float32(1 / np.sqrt(D)))
    if ks is not None:
        s_all = s_all * tatt.gather_pages(ks, pt).float()[:, None, None, :]
    vscale = tatt.gather_pages(vs, pt).float() if vs is not None else torch.ones((B, S))
    split_rows = pa.grouped_split_rows(ps)
    out = torch.empty((B, Hkv, G, D))
    for b in range(B):
        n = min(max(int(pos[b]) + 1, 1), S)
        npc = -(-n // ps)
        s = s_all[b, ..., :n]
        pmax = torch.stack([s[..., i * ps : (i + 1) * ps].amax(-1) for i in range(npc)], -1)
        parts = []
        for r0 in range(0, n, split_rows):
            r1 = min(r0 + split_rows, n)
            point = lambda p: torch.cummax(pmax, -1).values[..., min((p // unit + 1) * unit, npc) - 1]  # noqa: E731
            M = point((r1 - 1) // ps)
            l = torch.zeros((Hkv, G))
            acc = torch.zeros((Hkv, G, D))
            for c0 in range(0, D, 512):  # the column slices: each recomputes the weights
                for j in range(r0, r1):
                    Mi = point(j // ps)
                    e = torch.exp(s[..., j] - Mi)
                    w = torch.exp(Mi - M)
                    if c0 == 0:
                        l = l + w * e
                    c = w * (e.bfloat16().float() if round_p else e) * vscale[b, j]
                    acc[..., c0 : c0 + 512] += c[..., None] * vc[b, j, :, None, c0 : c0 + 512]
            parts.append((M * 1.4426950408889634, l, acc))
        Mx = torch.stack([m for m, _, _ in parts]).amax(0)
        wts = [torch.exp2(m - Mx) for m, _, _ in parts]
        lsum = sum(wi * li for wi, (_, li, _) in zip(wts, parts))
        out[b] = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(wts, parts)) / lsum.clamp(min=1e-20)[..., None]
    return out.reshape(B, Hq, D)


@pytest.mark.parametrize("which,D", [("K1", 640), ("K1 int8", 640), ("K3a", 520), ("K4a", 640), ("K4b", 1024),
                                     ("K7c", 640)])
def test_wide_decode_model_matches_the_plain_versions(which, D):
    """The runtime-D body's algebra at the variants' rounding: K1 and K3a
    with f32 probabilities (K1 also over an int8 cache), K4a at a unit of
    chunk_pages pages, K4b and K7c at one page, over bf16 pools with
    bf16-valued f32 queries (an f32 output), against each plain version at
    atol 2e-5; the contexts span several splits, end mid-page, sit at -1 and
    fill the table."""
    case = variant_case(4, 4, 2, D, seed=D + len(which), max_pages=36)
    q, k, v, pt, pos = (torch.from_numpy(x) for x in case)
    pos[2] = -1
    ks = vs = None
    if which == "K1 int8":
        codes = [torch.from_numpy(np.random.default_rng(D).integers(-127, 128, k.shape).astype(np.int8)) for _ in "kv"]
        scales = [torch.from_numpy(np.random.default_rng(D + i).uniform(0.005, 0.02, k.shape[:2]).astype(np.float32))
                  for i in range(2)]
        kq, vq = QuantizedPages(codes[0], scales[0]), QuantizedPages(codes[1], scales[1])
        got = wide_decode_model(q, codes[0], codes[1], pt, pos, 1, False, *scales)
        want = tatt.paged_decode_attention(q, kq, vq, pt, pos)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        return
    q, k, v = q.bfloat16().float(), k.bfloat16(), v.bfloat16()
    unit = pa.chunk_pages(k.shape[1], pt.shape[1]) if which == "K4a" else 1
    rounded = which in ("K4a", "K4b", "K7c")
    plain_fn = {"K1": tatt.paged_decode_attention, "K3a": tatt.paged_decode_attention,
                "K4a": tatt.paged_decode_attention_chunked, "K4b": tatt.paged_decode_attention_grouped,
                "K7c": tatt.paged_decode_attention_grouped}[which]
    got = wide_decode_model(q, k, v, pt, pos, unit, rounded)
    torch.testing.assert_close(got, plain_fn(q, k, v, pt, pos), atol=2e-5, rtol=0)
