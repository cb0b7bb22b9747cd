"""Kernel K1: paged decode attention (CUDA C++, ``csrc/paged_attention.cu``).

Replaces ``dynamo_tpu/ops/pallas/paged_attention.py``
``paged_decode_attention_pallas_lookahead`` (``_kernel_lookahead``) and
``paged_decode_attention_pallas`` (``_kernel``): the two TPU kernels compute
the same function and differ only in TPU DMA scheduling, so this one kernel
stands for both.

Bound on an H100: memory bytes — each sequence's ``ceil(len/ps)`` pages of K
and V are read once, at 4 FLOP per element. The kernel gives each
(sequence, kv head) one block whose GQA query heads share every K/V row it
loads, reads rows as 16-byte vectors with several tokens in flight, and
merges per-row-group online-softmax states in shared memory (see the source
note). Plain version: ``ops/attention.py paged_decode_attention``; the
dispatcher there picks the plain version for CPU tensors and this launcher
for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.kernels import _build

HEAD_DIMS = (64, 128)
GROUP_SIZES = (1, 2, 4, 8)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]


def check_decode_args(q, k_pages, v_pages, page_tables, positions) -> None:
    """Raise on inputs the kernel does not take."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"expected q [B, Hq, D] and pools [P, ps, Hkv, D]; got {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    B, Hq, D = q.shape
    _, ps, Hkv, Dk = k_pages.shape
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"K1 takes float32 or bfloat16 q and pools of the same dtype; got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if Dk != D or D not in HEAD_DIMS:
        raise ValueError(f"K1 takes head_dim in {HEAD_DIMS}; got q D={D}, pool D={Dk}")
    if Hq % Hkv or Hq // Hkv not in GROUP_SIZES:
        raise ValueError(f"K1 takes Hq/Hkv in {GROUP_SIZES}; got Hq={Hq}, Hkv={Hkv}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B or positions.shape != (B,):
        raise ValueError(f"expected page_tables [B, max_pages] and positions [B] for B={B}; got "
                         f"{tuple(page_tables.shape)}, {tuple(positions.shape)}")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_tables and positions must be int32")
    if page_tables.shape[1] * ps >= 2**31:
        raise ValueError("context capacity exceeds int32")
    if not k_pages.is_contiguous() or not v_pages.is_contiguous():
        raise ValueError("K1 needs contiguous pools")
    for t in (k_pages, v_pages, page_tables, positions):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; got {t.device}")


def paged_decode_attention_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """q [B, Hq, D], pools [P, ps, Hkv, D], page_tables [B, max_pages] int32
    (layer offset added), positions [B] int32 -> [B, Hq, D] in q's dtype.

    Launches K1 or raises: CUDA tensors only (``ops/attention.py
    dispatch_paged_decode_attention`` sends CPU tensors to the plain
    version)."""
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors; got {q.device}")
    check_decode_args(q, k_pages, v_pages, page_tables, positions)
    q = _build.aligned16(q)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _build.entry("paged_attention", "paged_decode_attention", _ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_tables.data_ptr(),
        positions.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, ps, page_tables.shape[1],
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attention")
    paged_decode_attention_kernel.launches += 1
    return out


paged_decode_attention_kernel.launches = 0
