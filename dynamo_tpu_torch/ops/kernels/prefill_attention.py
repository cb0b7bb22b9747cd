"""Kernel K2: chunked-prefill flash attention over the paged pool (CUDA C++,
``csrc/prefill_attention.cu``).

Replaces ``dynamo_tpu/ops/pallas/prefill_attention.py``
``paged_prefill_attention_pallas`` (``_kernel_lookahead`` / ``_kernel``,
math in ``_flash_merge``). One launch takes all N packed lanes of a prefill
call; the TPU path launches once per lane.

Bound on an H100: arithmetic at prefill sizes (4·Hq·D FLOP per causal
(row, key) pair against context bytes read once). The kernel stages K/V
tiles of 32 keys from the pages into shared memory, shares each tile across
the G query heads of a kv head, and runs an f32 online softmax with FMA
micro-tiles (see the source note). Plain version: ``ops/attention.py
paged_prefill_attention`` (per lane); the dispatcher there picks the plain
version for CPU tensors and this launcher for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.kernels import _build

HEAD_DIMS = (64, 128)
ROWS_PER_BLOCK = 64  # (query, head) rows per block: Hq/Hkv must divide it
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 8 + [_P]


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


def check_prefill_args(q, k_pages, v_pages, page_tables, positions) -> None:
    """Raise on inputs the kernel does not take (lanes form)."""
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected pools [P, ps, Hkv, D]; got {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    _, Hq, D = q.shape
    _, ps, Hkv, Dk = k_pages.shape
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"K2 takes float32 or bfloat16 q and pools of the same dtype; got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"K2 takes head_dim in {HEAD_DIMS}; got q D={D}, pool D={Dk}")
    if Hq % Hkv or ROWS_PER_BLOCK % (Hq // Hkv):
        raise ValueError(f"K2 needs Hq/Hkv dividing {ROWS_PER_BLOCK}; got Hq={Hq}, Hkv={Hkv}")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_tables and positions must be int32")
    if page_tables.shape[1] * ps >= 2**31:
        raise ValueError("context capacity exceeds int32")
    if not k_pages.is_contiguous() or not v_pages.is_contiguous():
        raise ValueError("K2 needs contiguous pools")
    for t in (k_pages, v_pages, page_tables, positions):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; got {t.device}")


def paged_prefill_attention_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """q [N*T, Hq, D], pools [P, ps, Hkv, D], page_tables [N, max_pages] int32
    (layer offset added), positions [N, T] int32 unit-stride per lane ->
    [N*T, Hq, D] in q's dtype. ``page_tables`` [max_pages] with ``positions``
    [T] is the one-chunk form.

    Launches K2 or raises: CUDA tensors only (``ops/attention.py
    dispatch_paged_prefill_attention`` sends CPU tensors to the plain
    version)."""
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors; got {q.device}")
    page_tables, positions = _as_lanes(q, page_tables, positions)
    check_prefill_args(q, k_pages, v_pages, page_tables, positions)
    q = _build.aligned16(q)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    N, T = positions.shape
    _, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _build.entry("prefill_attention", "paged_prefill_attention", _ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_tables.data_ptr(),
        positions.data_ptr(), out.data_ptr(), N, T, Hq, Hkv, D, ps, page_tables.shape[1],
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_prefill_attention")
    paged_prefill_attention_kernel.launches += 1
    return out


paged_prefill_attention_kernel.launches = 0
