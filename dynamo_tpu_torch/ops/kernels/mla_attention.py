"""Kernels K5 (paged MLA decode) and K6 (MLA chunked prefill), CUDA C++ in
``csrc/mla_attention.cu``.

K5 replaces ``dynamo_tpu/ops/pallas/mla_attention.py``
``paged_mla_decode_attention_pallas`` (``_kernel`` and ``_kernel_lookahead``,
which compute the same function); K6 replaces
``paged_mla_prefill_attention_pallas`` (``_prefill_kernel``). Both take f32
pre-scaled queries ``q_cat [.., H, L]`` against a latent pool ``[P, ps, L]``
of f32 or bf16 rows and return the latent-space output ``a_lat [.., H, d_c]``
in f32.

Bound on an H100, over bf16 pages: the pages' bytes (K5: 2·H·(L + d_c)
FLOP a (key, head) at the bf16 tensor rate is below them at 16 heads) or
the operations (K6: every position of a chunk reads its whole context);
over f32 pages the f32 arithmetic.

Which body takes which shapes (the dispatch rule; nothing falls back at run
time: a body that does not build or launch raises):

- K5 over bf16 pages at L % 8 == 0, d_c % 8 == 0, d_c <= 512 and L <= 704
  (the shared-memory budget of the 16 heads' bf16 hi + lo queries and a
  two-stage ring of 64 latent rows; :func:`decode_on_tensor_cores`): the
  tensor-core body, ``mla_decode_tc``. A block is (split of
  :func:`tc_split_rows` context rows, group of 16 heads, sequence); S = Q·Kᵀ
  and O += P·V by ``mma.sync`` with q and P split into bf16 hi + lo, so both
  stay f32-exact (DeepSeek-V2-Lite's L 576, d_c 512 on the serve path).
- K6 over bf16 pages at L <= 576 with the same L and d_c rules: its
  tensor-core body, 64-row tiles of the chunk's (position, head) pairs
  flattened position-major, any H, the same hi + lo products.
- f32 pages (the f32 greedy-parity phases), widths past those budgets (L
  1088 / d_c 1024) and rows that start off 16 bytes or a d_c that is no
  multiple of 8 (a latent width of 36, d_c 30): the f32 FMA body. Blocks
  stage 32-row latent tiles once for 16 heads (any H: the last block masks
  the heads past it), in 16-byte vectors or, for rows that start off 16
  bytes, an element at a time; a row wider than 768 is scored in chunks of
  512 columns, and a d_c above 512 in slices of 512 over a grid dimension
  (each slice's block recomputes the scores), so any L and 0 < d_c <= L
  launch. K5 over it splits each sequence's context over blocks of
  ``SPLIT_ROWS`` rows.

K5's splits write their softmax states to one f32 workspace, which a second
launch (``merge_splits``, shared with the paged decode kernels) combines in
a fixed order: two launches on the same inputs give the same bits.

See the source note. Plain versions: ``ops/attention.py
paged_mla_decode_attention`` / ``paged_mla_prefill_attention``; the
dispatchers there pick the plain version for CPU tensors and these launchers
for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.ops.kernels.paged_attention import split_partials

# K5's context rows a split (a multiple of 64). The FMA body's: at 64, a
# decode batch of 16 sequences of up to 2048 rows fills the 132 SMs about
# twice over, and two blocks fit an SM's shared memory, so one block's tile
# loads overlap the other's math. The tensor-core body's: the larger of
# TC_SPLIT_CHOICES whose splits at the table's capacity give at least
# TC_SPLIT_BLOCKS blocks (about two an SM of an H100's 132), else the
# smaller (tc_split_rows).
SPLIT_ROWS = 64
TC_SPLIT_CHOICES = (128, 64)
TC_SPLIT_BLOCKS = 256
PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_DECODE_ARGTYPES = [_P] * 8 + [_I] * 9 + [_P]
_PREFILL_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]


@functools.lru_cache(maxsize=None)
def decode_on_tensor_cores(L: int, d_c: int, page_dtype) -> bool:
    """Whether K5 runs its tensor-core body (``mla_decode_tc``) at latent
    width L, d_c and this page dtype: the C launcher's rule (module
    docstring), asked of the built library."""
    on = _build.entry("mla_attention", "mla_decode_on_tensor_cores", [_I] * 3)(L, d_c, PAGE_DTYPES[page_dtype])
    return bool(on)


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
    if not 0 < d_c <= L:
        raise ValueError(f"K5/K6 take 0 < d_c <= latent; got d_c={d_c}, latent={L}")
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
    out = _decode_launch(q_cat, pages, page_tables, positions, d_c)
    paged_mla_decode_attention_kernel.launches += 1
    return out


def tc_split_rows(B: int, H: int, capacity: int) -> int:
    """The tensor-core body's split rows for B sequences of H heads in
    tables of ``capacity`` context rows (max_pages * ps): two 64-row tiles a
    block where that still gives TC_SPLIT_BLOCKS blocks, else one, so that
    small batches and short tables fill the card. On an H100
    (``tools/time_decode.py`` MLA_SPLIT_SHAPES, PERF.md) this picks the
    fastest of 64, 128 and 256 at B 16 over contexts 1..2048 (128), at B 4
    and 1 over 2048-row contexts and at B 16 in a 256-row table (64). The
    host sees the table's capacity, not the contexts (they are on the
    device)."""
    for rows in TC_SPLIT_CHOICES:
        if B * -(-H // 16) * -(-capacity // rows) >= TC_SPLIT_BLOCKS:
            return rows
    return TC_SPLIT_CHOICES[-1]


def _decode_launch(q_cat, pages, page_tables, positions, d_c: int, split_rows: int | None = None) -> torch.Tensor:
    """K5's launch on checked inputs: splits of ``split_rows`` context rows
    (by default the body's, :func:`decode_on_tensor_cores`), their partials
    in one f32 workspace, the split pass and the merge."""
    q_cat = _build.aligned16(q_cat)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    B, H, L = q_cat.shape
    ps = pages.shape[1]
    mp = page_tables.shape[1]
    if split_rows is None:
        split_rows = tc_split_rows(B, H, mp * ps) if decode_on_tensor_cores(L, d_c, pages.dtype) else SPLIT_ROWS
    n_split = -(-mp * ps // split_rows)
    ws, m_part, l_part, acc_part, _ = split_partials(B, n_split, H, d_c, q_cat.device)  # ws: alive past the launch
    out = torch.empty((B, H, d_c), dtype=torch.float32, device=q_cat.device)
    err = _build.entry("mla_attention", "paged_mla_decode_attention", _DECODE_ARGTYPES)(
        q_cat.data_ptr(), pages.data_ptr(), page_tables.data_ptr(), positions.data_ptr(), m_part, l_part, acc_part,
        out.data_ptr(), B, H, L, d_c, ps, mp, split_rows, n_split, PAGE_DTYPES[pages.dtype],
        torch.cuda.current_stream(q_cat.device).cuda_stream,
    )
    _build.check(err, "paged_mla_decode_attention")
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
