"""Kernels K1 (paged decode attention) and K3a (its folded variant for head
dims that are not a multiple of 128), CUDA C++ in ``csrc/paged_attention.cu``.

K1 replaces ``dynamo_tpu/ops/pallas/paged_attention.py``
``paged_decode_attention_pallas_lookahead`` (``_kernel_lookahead``) and
``paged_decode_attention_pallas`` (``_kernel``): the two TPU kernels compute
the same function and differ only in TPU DMA scheduling, so this one kernel
stands for both. K3a replaces ``paged_decode_attention_pallas_folded``
(``_kernel_folded``), the same function at head_dim 16, 32 or 64 (TinyLlama).

Both take f32 or bf16 queries over pools of the query's dtype, or over an
int8 cache (``quant/kv.py QuantizedPages``: int8 pools with one f32 scale a
token row, applied to score and probability columns).

Bound on an H100: memory bytes — each sequence's ``ceil(len/ps)`` pages of K
and V are read once, at 4 FLOP per element. K1 gives each (sequence, kv head)
one block whose GQA query heads share every K/V row it loads; K3a reads each
token's whole row of all kv heads once for all query heads, splits each
sequence's context over blocks of ``SPLIT_ROWS`` rows and merges them in a
second launch (see the source note). Plain version: ``ops/attention.py
paged_decode_attention``; the dispatcher there picks the plain version for
CPU tensors and, for CUDA tensors, K3a when ``head_dim % 128 != 0``, else K1.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.quant.kv import QuantizedPages

HEAD_DIMS = (64, 128)  # K1
FOLDED_HEAD_DIMS = (16, 32, 64)  # K3a
GROUP_SIZES = (1, 2, 4, 8)
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT8 = 2  # the C entry points' kv dtype code for int8 pools
# K3a: threads a block (a token row's Hkv*D/VEC lanes must divide it; VEC =
# 4 values a lane for f32 pools, 8 for bf16 and int8) and context rows a
# block. At 128 rows a decode batch of 16 TinyLlama sequences of up to 2048
# rows spreads over about 130 blocks.
FOLDED_THREADS = 128
SPLIT_ROWS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
_FOLDED_ARGTYPES = [_P] * 11 + [_I] * 10 + [_P]


def unpack_pools(q, k_pages, v_pages, name: str):
    """(k, v, k_scale, v_scale, kv dtype code) of a pool pair: plain pools of
    q's dtype (scales None, code Q_DTYPES[q.dtype]) or int8 QuantizedPages
    with f32 [P, ps] scale planes (code INT8). Raises on anything else."""
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"{name} takes a float32 or bfloat16 q dtype; got {q.dtype}")
    quantized = isinstance(k_pages, QuantizedPages)
    if quantized != isinstance(v_pages, QuantizedPages):
        raise ValueError(f"{name}: K and V pools must both be int8 QuantizedPages or neither")
    if not quantized:
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise ValueError(f"{name} takes pools of q's dtype or int8 QuantizedPages; got "
                             f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
        return k_pages, v_pages, None, None, Q_DTYPES[q.dtype]
    k, v, ks, vs = k_pages.q, v_pages.q, k_pages.s, v_pages.s
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"{name}: QuantizedPages pools must be int8; got {k.dtype}, {v.dtype}")
    for s in (ks, vs):
        if s.dtype != torch.float32 or tuple(s.shape) != tuple(k.shape[:2]) or not s.is_contiguous():
            raise ValueError(f"{name}: scale planes must be contiguous float32 [P, ps] = "
                             f"{tuple(k.shape[:2])}; got {s.dtype} {tuple(s.shape)}")
        if s.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; got {s.device}")
    return k, v, ks, vs, INT8


def _check_tables(B, ps, page_tables, positions) -> None:
    if page_tables.dim() != 2 or page_tables.shape[0] != B or positions.shape != (B,):
        raise ValueError(f"expected page_tables [B, max_pages] and positions [B] for B={B}; got "
                         f"{tuple(page_tables.shape)}, {tuple(positions.shape)}")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_tables and positions must be int32")
    if page_tables.shape[1] * ps >= 2**31:
        raise ValueError("context capacity exceeds int32")


def _check_pools(q, k, v, page_tables, positions, name: str) -> None:
    if not k.is_contiguous() or not v.is_contiguous():
        raise ValueError(f"{name} needs contiguous pools")
    for t in (k, v, page_tables, positions):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; got {t.device}")


def check_decode_args(q, k_pages, v_pages, page_tables, positions):
    """Raise on inputs K1 does not take; returns ``unpack_pools``' tuple."""
    if q.dim() != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"expected q [B, Hq, D] and pools [P, ps, Hkv, D]; got {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    pools = unpack_pools(q, k_pages, v_pages, "K1")
    k, v = pools[:2]
    B, Hq, D = q.shape
    _, ps, Hkv, Dk = k.shape
    if Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"K1 takes head_dim in {HEAD_DIMS}; got q D={D}, pool D={Dk}")
    if Hq % Hkv or Hq // Hkv not in GROUP_SIZES:
        raise ValueError(f"K1 takes Hq/Hkv in {GROUP_SIZES}; got Hq={Hq}, Hkv={Hkv}")
    _check_tables(B, ps, page_tables, positions)
    _check_pools(q, k, v, page_tables, positions, "K1")
    return pools


def folded_geometry(q, k) -> tuple[int, int]:
    """(Hkv, F = Hkv * D) of a pool [P, ps, Hkv, D] or folded [P, ps, Hkv*D]."""
    D = q.shape[-1]
    if k.dim() == 4:
        if k.shape[3] != D:
            raise ValueError(f"q head_dim {D} != pool head_dim {k.shape[3]}")
        return k.shape[2], k.shape[2] * D
    if k.dim() != 3 or k.shape[2] % D:
        raise ValueError(f"expected pools [P, ps, Hkv, D] or [P, ps, Hkv*D] for D={D}; got {tuple(k.shape)}")
    return k.shape[2] // D, k.shape[2]


def check_folded_decode_args(q, k_pages, v_pages, page_tables, positions):
    """Raise on inputs K3a does not take; returns ``unpack_pools``' tuple."""
    if q.dim() != 3 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q [B, Hq, D] and pools of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    pools = unpack_pools(q, k_pages, v_pages, "K3a")
    k, v, _, _, code = pools
    B, Hq, D = q.shape
    if D not in FOLDED_HEAD_DIMS:
        raise ValueError(f"K3a takes head_dim in {FOLDED_HEAD_DIMS}; got {D}")
    Hkv, F = folded_geometry(q, k)
    if Hq % Hkv or Hq // Hkv not in GROUP_SIZES:
        raise ValueError(f"K3a takes Hq/Hkv in {GROUP_SIZES}; got Hq={Hq}, Hkv={Hkv}")
    vec = 4 if code == Q_DTYPES[torch.float32] else 8
    lanes = F // vec
    if lanes > FOLDED_THREADS or FOLDED_THREADS % lanes:
        raise ValueError(f"K3a reads a token row with Hkv*D/{vec} lanes, which must divide "
                         f"{FOLDED_THREADS}; got Hkv={Hkv}, D={D}")
    if code == INT8 and F % 16:
        raise ValueError(f"K3a int8 rows must be 16-byte multiples (Hkv*D % 16 == 0); got {F}")
    _check_tables(B, k.shape[1], page_tables, positions)
    _check_pools(q, k, v, page_tables, positions, "K3a")
    return pools


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def paged_decode_attention_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """q [B, Hq, D], pools [P, ps, Hkv, D] of q's dtype or int8
    QuantizedPages, page_tables [B, max_pages] int32 (layer offset added),
    positions [B] int32 -> [B, Hq, D] in q's dtype.

    Launches K1 or raises: CUDA tensors only (``ops/attention.py
    dispatch_paged_decode_attention`` sends CPU tensors to the plain
    version)."""
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors; got {q.device}")
    k, v, ks, vs, code = check_decode_args(q, k_pages, v_pages, page_tables, positions)
    q = _build.aligned16(q)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k.shape
    out = torch.empty_like(q)
    err = _build.entry("paged_attention", "paged_decode_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), page_tables.data_ptr(),
        positions.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, ps, page_tables.shape[1],
        Q_DTYPES[q.dtype], code, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attention")
    paged_decode_attention_kernel.launches += 1
    return out


def paged_decode_attention_folded_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """K3a: K1's contract at head_dim 16, 32 or 64; the pools may also be
    given folded, [P, ps, Hkv*D] (the same memory).

    Launches K3a (a split pass and a merge pass) or raises: CUDA tensors
    only."""
    if q.device.type != "cuda":
        raise ValueError(f"K3a runs on CUDA tensors; got {q.device}")
    k, v, ks, vs, code = check_folded_decode_args(q, k_pages, v_pages, page_tables, positions)
    q = _build.aligned16(q)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    B, Hq, D = q.shape
    Hkv, _ = folded_geometry(q, k)
    ps, mp = k.shape[1], page_tables.shape[1]
    n_split = -(-mp * ps // SPLIT_ROWS)
    dev = q.device
    m_part = torch.empty((B, n_split, Hq), dtype=torch.float32, device=dev)
    l_part = torch.empty((B, n_split, Hq), dtype=torch.float32, device=dev)
    acc_part = torch.empty((B, n_split, Hq, D), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    err = _build.entry("paged_attention", "paged_decode_attention_folded", _FOLDED_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), page_tables.data_ptr(),
        positions.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, D, ps, mp, SPLIT_ROWS, n_split, Q_DTYPES[q.dtype], code,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "paged_decode_attention_folded")
    paged_decode_attention_folded_kernel.launches += 1
    return out


paged_decode_attention_kernel.launches = 0
paged_decode_attention_folded_kernel.launches = 0
