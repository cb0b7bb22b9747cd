"""Kernels K5 (paged MLA decode) and K6 (MLA chunked prefill), CUDA C++ in
``csrc/mla_attention.cu``.

K5 replaces ``dynamo_tpu/ops/pallas/mla_attention.py``
``paged_mla_decode_attention_pallas`` (``_kernel`` and ``_kernel_lookahead``,
which compute the same function); K6 replaces
``paged_mla_prefill_attention_pallas`` (``_prefill_kernel``). Both take f32
pre-scaled queries ``q_cat [.., H, L]`` against a latent pool ``[P, ps, L]``
of f32 or bf16 rows and return the latent-space output ``a_lat [.., H, d_c]``
in f32.

Bound on an H100: the arithmetic, 2·(L + d_c) FLOP per (row, head, key),
against pages read once and shared by every head.

Which body takes which shapes:

- K6 over bf16 pages at a latent width L <= 576 (the shared-memory budget
  of the 64-row tile's bf16 hi + lo queries, a two-stage ring of 32 latent
  rows and the warps' exchange), L % 8 == 0, d_c % 8 == 0 and d_c <= 512
  (two warps' 256 output columns): the tensor-core body. 64-row tiles of the
  chunk's (position, head) pairs flattened position-major, any H; S = Q·Kᵀ
  and O += P·V by ``mma.sync`` with q and P split into bf16 hi + lo, so both
  stay f32-exact (DeepSeek-V2-Lite's L 576, d_c 512 on the serve path).
- K5, and K6 over f32 pages or past that budget: the f32 FMA body. Blocks
  stage 32-row latent tiles once for 16 heads (any H: the last block masks
  the heads past it); a row wider than 768 is scored in chunks of 512
  columns, and a d_c above 512 in slices of 512 over a grid dimension (each
  slice's block recomputes the scores), so any L % 8 == 0 and d_c % 4 == 0
  launch. K5 splits each sequence's context over blocks of ``SPLIT_ROWS``
  rows and merges their softmax states in a second launch.

See the source note. Plain versions: ``ops/attention.py
paged_mla_decode_attention`` / ``paged_mla_prefill_attention``; the
dispatchers there pick the plain version for CPU tensors and these launchers
for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.kernels import _build

# K5: context rows per block, a multiple of the kernel's 32-row tile. At 64,
# a decode batch of 16 sequences of up to 2048 rows fills the 132 SMs about
# twice over, and two blocks fit an SM's shared memory, so one block's tile
# loads overlap the other's math.
SPLIT_ROWS = 64
PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_DECODE_ARGTYPES = [_P] * 8 + [_I] * 9 + [_P]
_PREFILL_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]


def check_mla_args(q_cat, pages, page_tables, positions, d_c: int, decode: bool) -> None:
    """Raise on inputs the kernels do not take. ``decode``: K5's
    ([B, max_pages], [B]) tables and positions; else K6's ([max_pages],
    [T])."""
    if q_cat.dim() != 3 or pages.dim() != 3:
        raise ValueError(f"expected q_cat [.., H, L] and pages [P, ps, L]; got "
                         f"{tuple(q_cat.shape)}, {tuple(pages.shape)}")
    n, _, L = q_cat.shape
    if q_cat.dtype != torch.float32 or pages.dtype not in PAGE_DTYPES:
        raise ValueError(f"K5/K6 take float32 q_cat and float32 or bfloat16 pages; got "
                         f"{q_cat.dtype}, {pages.dtype}")
    if pages.shape[2] != L:
        raise ValueError(f"q_cat latent width {L} != pool row width {pages.shape[2]}")
    if L % 8:
        raise ValueError(f"K5/K6 take a latent width that is a multiple of 8; got {L}")
    if not 0 < d_c <= L or d_c % 4:
        raise ValueError(f"K5/K6 take 0 < d_c <= latent, d_c % 4 == 0; got d_c={d_c}, latent={L}")
    want_tables = (n, page_tables.shape[-1]) if decode else (page_tables.shape[-1],)
    if page_tables.dim() != len(want_tables) or tuple(page_tables.shape) != want_tables or positions.shape != (n,):
        form = "page_tables [B, max_pages] and positions [B]" if decode else "page_table [max_pages] and positions [T]"
        raise ValueError(f"expected {form} for {n} queries; got {tuple(page_tables.shape)}, "
                         f"{tuple(positions.shape)}")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page tables and positions must be int32")
    if page_tables.shape[-1] * pages.shape[1] >= 2**31:
        raise ValueError("context capacity exceeds int32")
    if not pages.is_contiguous() or pages.data_ptr() % 16:
        raise ValueError("K5/K6 need a contiguous, 16-byte aligned pool")
    for t in (pages, page_tables, positions):
        if t.device != q_cat.device:
            raise ValueError(f"all inputs must be on {q_cat.device}; got {t.device}")


def paged_mla_decode_attention_kernel(q_cat, pages, page_tables, positions, d_c: int) -> torch.Tensor:
    """q_cat [B, H, L] f32 pre-scaled, pages [P, ps, L], page_tables
    [B, max_pages] int32 (layer offset added), positions [B] int32 ->
    a_lat [B, H, d_c] f32.

    Launches K5 or raises: CUDA tensors only (``ops/attention.py
    dispatch_paged_mla_decode_attention`` sends CPU tensors to the plain
    version)."""
    if q_cat.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors; got {q_cat.device}")
    check_mla_args(q_cat, pages, page_tables, positions, d_c, decode=True)
    q_cat = _build.aligned16(q_cat)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    B, H, L = q_cat.shape
    ps = pages.shape[1]
    mp = page_tables.shape[1]
    n_split = -(-mp * ps // SPLIT_ROWS)
    dev = q_cat.device
    m_part = torch.empty((B, H, n_split), dtype=torch.float32, device=dev)
    l_part = torch.empty((B, H, n_split), dtype=torch.float32, device=dev)
    acc_part = torch.empty((B, H, n_split, d_c), dtype=torch.float32, device=dev)
    out = torch.empty((B, H, d_c), dtype=torch.float32, device=dev)
    err = _build.entry("mla_attention", "paged_mla_decode_attention", _DECODE_ARGTYPES)(
        q_cat.data_ptr(), pages.data_ptr(), page_tables.data_ptr(), positions.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(), out.data_ptr(),
        B, H, L, d_c, ps, mp, SPLIT_ROWS, n_split, PAGE_DTYPES[pages.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "paged_mla_decode_attention")
    paged_mla_decode_attention_kernel.launches += 1
    return out


def paged_mla_prefill_attention_kernel(q_cat, pages, page_table, positions, d_c: int) -> torch.Tensor:
    """q_cat [T, H, L] f32 pre-scaled, pages [P, ps, L], page_table
    [max_pages] int32 (layer offset added), positions [T] int32 unit-stride
    -> a_lat [T, H, d_c] f32. bf16 pages within the tensor-core body's
    budget (module docstring) take it, others the FMA body.

    Launches K6 or raises: CUDA tensors only (``ops/attention.py
    dispatch_paged_mla_prefill_attention`` sends CPU tensors to the plain
    version)."""
    if q_cat.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA tensors; got {q_cat.device}")
    check_mla_args(q_cat, pages, page_table, positions, d_c, decode=False)
    q_cat = _build.aligned16(q_cat)
    page_table = page_table.contiguous()
    positions = positions.contiguous()
    T, H, L = q_cat.shape
    out = torch.empty((T, H, d_c), dtype=torch.float32, device=q_cat.device)
    err = _build.entry("mla_attention", "paged_mla_prefill_attention", _PREFILL_ARGTYPES)(
        q_cat.data_ptr(), pages.data_ptr(), page_table.data_ptr(), positions.data_ptr(),
        out.data_ptr(), T, H, L, d_c, pages.shape[1], page_table.shape[0],
        PAGE_DTYPES[pages.dtype], torch.cuda.current_stream(q_cat.device).cuda_stream,
    )
    _build.check(err, "paged_mla_prefill_attention")
    paged_mla_prefill_attention_kernel.launches += 1
    return out


paged_mla_decode_attention_kernel.launches = 0
paged_mla_prefill_attention_kernel.launches = 0
