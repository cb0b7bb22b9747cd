"""Kernels K2 (chunked-prefill flash attention over the paged pool) and K3b
(its folded variant for head dims that are not a multiple of 128), CUDA C++ in
``csrc/prefill_attention.cu``.

K2 replaces ``dynamo_tpu/ops/pallas/prefill_attention.py:686``
``paged_prefill_attention_pallas`` (``pallas_call`` at ``:783``;
``_kernel_lookahead`` / ``_kernel``, math in ``_flash_merge``); K3b replaces
``:615`` ``paged_prefill_attention_pallas_folded`` (``pallas_call`` at
``:662``, ``_kernel_folded``), the same function at a head_dim that is no
multiple of 128 (TinyLlama's 64; tiles padded to 16 columns, or to 256
above 128). K2 takes head_dim 64 and every multiple of 128. One launch takes all N packed lanes
of a prefill call; the TPU path launches once per lane. Both take f32 or bf16 queries over pools of the
query's dtype or over an int8 cache (``quant/kv.py QuantizedPages``, scales
applied to score and probability columns).

Bound on an H100: arithmetic at prefill sizes (4·Hq·D FLOP per causal
(row, key) pair against context bytes read once). bf16 queries (over bf16
or int8 pools) take one tensor-core body for K2 and K3b: a block of
``ROWS_PER_BLOCK`` (query, head) rows of one kv head's GQA group, as two
warpgroups of 64 (``ROWS_PER_BLOCK // G`` query positions; any G up to 128,
the rows past them zero); S = Q·Kᵀ and O += P·V through ``wgmma``; K/V tiles of 64
keys in a ``cp.async`` ring, int8 codes converted to bf16 in shared memory.
The probabilities stay f32-exact: P is split into bf16(P) + bf16(P −
bf16(P)) and multiplied twice, because one bf16 rounding of P leaves
``TOL["bf16"]`` at small outputs (``tests/test_torch_prefill_tc.py``). The
reference's folded kernel rounds P to the pool dtype; the port does not, for
K3b as for K3a. f32 queries keep an f32 FMA body in the same block
partition (TF32 would break ``TOL["f32"]``); its narrow form, which reads
rows an element at a time, takes K3b's head dims that are no multiple of 8
(rows that start off 16 bytes) in every mix and K3b's f32 queries above
128. Head dims past 256 (K2 at 384 and every larger multiple of 128, K3b at
every other head dim from 257), in every mix, take a simple wide FMA body
in the same block partition, D a runtime argument: a block owns 128 output
columns and scores Q·Kᵀ in 64-column chunks. See the source
note. Plain
version: ``ops/attention.py paged_prefill_attention`` (per lane); the
dispatcher there picks the plain version for CPU tensors and, for CUDA
tensors, K3b when ``head_dim % 128 != 0``, else K2.

K7a (:func:`paged_prefill_dmaonly_kernel`, the same source) replaces
``:797`` ``paged_prefill_dmaonly`` (``_kernel_dmaonly``), the
null-hypothesis instrument of ``tools/profile_prefill.py``: K2's grid,
causal tile bound and load stream (the ``cp.async`` ring and int8
conversion; f32 pools: the FMA body's staging; past head_dim 256, a
runtime-D twin with the wide FMA body's grid and staging) with no math. The
reference's output is garbage by design and is not matched: a load that
nothing reads is deleted by nvcc, so K7a writes f32 checksums of every value
it loads (plain version ``ops/attention.py paged_prefill_dmaonly``, which
reproduces K2's block partition).
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.ops.kernels.paged_attention import (
    Q_DTYPES,
    folded_geometry,
    folded_head_dim,
    unfolded_head_dim,
    unpack_pools,
)

ROWS_PER_BLOCK = 128  # K2, K3b, K7a: (query, head) rows per block; Hq/Hkv at most this

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 9 + [_P]


def _as_lanes(q, page_tables, positions):
    """Normalize the one-chunk form ([max_pages], [T]) to N=1 lanes."""
    if page_tables.dim() == 1:
        page_tables = page_tables[None]
        positions = positions[None]
    if page_tables.dim() != 2 or positions.dim() != 2 or positions.shape[0] != page_tables.shape[0]:
        raise ValueError(f"expected page_tables [N, max_pages] and positions [N, T]; got "
                         f"{tuple(page_tables.shape)}, {tuple(positions.shape)}")
    N, T = positions.shape
    if q.dim() != 3 or q.shape[0] != N * T:
        raise ValueError(f"expected q [N*T={N * T}, Hq, D]; got {tuple(q.shape)}")
    return page_tables, positions


def _check_group(Hq: int, Hkv: int, name: str) -> None:
    if Hq % Hkv or Hq // Hkv > ROWS_PER_BLOCK:
        raise ValueError(f"{name} needs Hq a multiple of Hkv with Hq/Hkv at most {ROWS_PER_BLOCK}; "
                         f"got Hq={Hq}, Hkv={Hkv}")


def _check_common(q, k, v, page_tables, positions, name: str) -> None:
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_tables and positions must be int32")
    if page_tables.shape[1] * k.shape[1] >= 2**31:
        raise ValueError("context capacity exceeds int32")
    if not k.is_contiguous() or not v.is_contiguous():
        raise ValueError(f"{name} needs contiguous pools")
    for t in (k, v, page_tables, positions):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; got {t.device}")


def check_prefill_args(q, k_pages, v_pages, page_tables, positions, name: str = "K2"):
    """Raise on inputs K2 (or K7a, its twin) does not take (lanes form);
    returns ``unpack_pools``' tuple."""
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected pools [P, ps, Hkv, D]; got {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    pools = unpack_pools(q, k_pages, v_pages, name)
    k, v = pools[:2]
    _, Hq, D = q.shape
    _, ps, Hkv, Dk = k.shape
    if Dk != D or not unfolded_head_dim(D):
        raise ValueError(f"{name} takes head_dim 64 or a multiple of 128; got q D={D}, pool D={Dk}")
    _check_group(Hq, Hkv, name)
    _check_common(q, k, v, page_tables, positions, name)
    return pools


def check_folded_prefill_args(q, k_pages, v_pages, page_tables, positions):
    """Raise on inputs K3b does not take (lanes form); returns
    ``unpack_pools``' tuple."""
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"expected K and V pools of one shape; got {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    pools = unpack_pools(q, k_pages, v_pages, "K3b")
    k, v = pools[:2]
    _, Hq, D = q.shape
    if not folded_head_dim(D):
        raise ValueError(f"K3b takes a head_dim that is no multiple of 128; got {D}")
    Hkv, _ = folded_geometry(q, k)
    _check_group(Hq, Hkv, "K3b")
    _check_common(q, k, v, page_tables, positions, "K3b")
    return pools


def _launch(symbol: str, q, pools, page_tables, positions, out_dtype=None) -> torch.Tensor:
    k, v, ks, vs, code = pools
    q = _build.aligned16(q)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    N, T = positions.shape
    _, Hq, D = q.shape
    Hkv, _ = folded_geometry(q, k)
    out = torch.empty_like(q, dtype=out_dtype or q.dtype)
    err = _build.entry("prefill_attention", symbol, _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), page_tables.data_ptr(), positions.data_ptr(),
        out.data_ptr(), N, T, Hq, Hkv, D, k.shape[1], page_tables.shape[1], Q_DTYPES[q.dtype], code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, symbol)
    return out


def paged_prefill_attention_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """q [N*T, Hq, D], pools [P, ps, Hkv, D] of q's dtype or int8
    QuantizedPages, page_tables [N, max_pages] int32 (layer offset added),
    positions [N, T] int32 unit-stride per lane -> [N*T, Hq, D] in q's dtype.
    ``page_tables`` [max_pages] with ``positions`` [T] is the one-chunk form.

    Launches K2 or raises: CUDA tensors only (``ops/attention.py
    dispatch_paged_prefill_attention`` sends CPU tensors to the plain
    version)."""
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors; got {q.device}")
    page_tables, positions = _as_lanes(q, page_tables, positions)
    pools = check_prefill_args(q, k_pages, v_pages, page_tables, positions)
    out = _launch("paged_prefill_attention", q, pools, page_tables, positions)
    paged_prefill_attention_kernel.launches += 1
    return out


def paged_prefill_attention_folded_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """K3b: K2's contract at a head_dim that is no multiple of 128;
    the pools may also be given folded, [P, ps, Hkv*D] (the same memory).

    Launches K3b or raises: CUDA tensors only."""
    if q.device.type != "cuda":
        raise ValueError(f"K3b runs on CUDA tensors; got {q.device}")
    page_tables, positions = _as_lanes(q, page_tables, positions)
    pools = check_folded_prefill_args(q, k_pages, v_pages, page_tables, positions)
    out = _launch("paged_prefill_attention_folded", q, pools, page_tables, positions)
    paged_prefill_attention_folded_kernel.launches += 1
    return out


def paged_prefill_dmaonly_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """K7a: K2's grid, tile bound and tile loads with no math. K2's contract
    in; out f32 [N*T, Hq, D]: each row gets the column sums of (K + V) of its
    kv head over its block's context (rows j <= the block's last position),
    int8 rows dequantized. q gives the shape and the mix only.

    Launches K7a or raises: CUDA tensors only."""
    if q.device.type != "cuda":
        raise ValueError(f"K7a runs on CUDA tensors; got {q.device}")
    page_tables, positions = _as_lanes(q, page_tables, positions)
    pools = check_prefill_args(q, k_pages, v_pages, page_tables, positions, "K7a")
    out = _launch("paged_prefill_dmaonly", q, pools, page_tables, positions, torch.float32)
    paged_prefill_dmaonly_kernel.launches += 1
    return out


paged_prefill_attention_kernel.launches = 0
paged_prefill_attention_folded_kernel.launches = 0
paged_prefill_dmaonly_kernel.launches = 0
