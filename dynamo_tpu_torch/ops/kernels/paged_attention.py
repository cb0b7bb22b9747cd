"""Kernels K1 (paged decode attention) and K3a (its folded variant for head
dims that are not a multiple of 128), CUDA C++ in ``csrc/paged_attention.cu``.

K1 replaces ``dynamo_tpu/ops/pallas/paged_attention.py``
``paged_decode_attention_pallas_lookahead`` (``_kernel_lookahead``) and
``paged_decode_attention_pallas`` (``_kernel``): the two TPU kernels compute
the same function and differ only in TPU DMA scheduling, so this one kernel
stands for both. K3a replaces ``paged_decode_attention_pallas_folded``
(``_kernel_folded``), the same function at a head_dim that is no multiple
of 128 (:func:`folded_head_dim`; TinyLlama's 64). Both take any GQA group G
= Hq / Hkv, as the reference does. K1 takes every head_dim that is a
multiple of 128, and 64 (:func:`unfolded_head_dim`).

Both take f32 or bf16 queries over pools of the query's dtype, or over an
int8 cache (``quant/kv.py QuantizedPages``: int8 pools with one f32 scale a
token row, applied to score and probability columns).

Bound on an H100: memory bytes — each sequence's ``ceil(len/ps)`` pages of K
and V are read once, at 4 FLOP per element. K1 over bf16 queries (bf16 or
int8 pools) splits each sequence's context over blocks of
:func:`k1_split_rows` rows, one block a (split, kv head, 16-head tile,
column slice): the kv head's rows stream through a ``cp.async`` ring, Q.Kᵀ and P.V run on the
tensor cores (``mma.sync``, P split into bf16 hi + lo so the probabilities
stay f32-exact), and the splits merge in a second launch in a fixed order;
past D 256 a block holds half the output columns. K1 over f32 queries keeps
an FMA body: one block a (sequence, kv head, head sub-group) reading rows
straight into registers. K3a over bf16 queries at a head_dim below 128
that is a multiple of 16 runs K1's split tensor-core body
(:func:`folded_on_k1_body`); f32 queries, and bf16 queries at a head_dim
above 128 or no multiple of 16 (rows that start off 16 bytes), take an FMA
body split over ``SPLIT_ROWS`` rows that reads rows an element at a time
(see the source note). Past ``WIDE_HEAD_DIM`` (512) every decode launcher
(K1 and K3a in every mix, K4a, K4b, K7c) runs one runtime-D body
(:func:`_wide_launch`): a score pass, a P.V pass in column slices of 512
that rounds the probabilities where the variant's TPU kernel rounds them,
and the merge; K7b a runtime-D twin. Plain version: ``ops/attention.py
paged_decode_attention``; the dispatcher there picks the plain version for
CPU tensors and, for CUDA tensors, K3a when ``head_dim % 128 != 0``, else K1
(or K4a / K4b, below, as ``DYNTPU_DECODE_KERNEL`` asks).

The decode variants, CUDA C++ in ``csrc/decode_variants.cu`` (f32 and bf16
pools of q's dtype, K1's head dims; no int8 cache, as on the TPU):

- K4a (:func:`paged_decode_attention_chunked_kernel`) replaces
  ``paged_decode_attention_pallas_chunked``: K1's function walked in chunks
  of :func:`chunk_pages` pages, each chunk's probabilities rounded to the pool
  dtype before P.V (``ops/attention.py paged_decode_attention_chunked``).
- K4b (:func:`paged_decode_attention_grouped_kernel`) replaces
  ``paged_decode_attention_pallas_grouped``: one page an iteration, rounded
  the same way (``paged_decode_attention_grouped``).
- K4a and K4b over bf16 pools run one set of passes, an exact split over the
  context whose rounding unit is a parameter (one page for K4b,
  :func:`chunk_pages` pages for K4a): a score pass with each page's max, a
  P.V pass that rounds each probability at its unit's prefix max, a merge
  (:func:`grouped_split_rows`). Over f32 pools (rounding is the identity)
  both take an FMA chunk body at one unit a chunk.
- K7c (:func:`paged_decode_perseq_variant_kernel`) replaces
  ``tools/profile_attn.py make_perseq_variant``: one page an iteration, with
  the probabilities rounded unless ``cast_f32`` (then K1's function). Each
  toggle runs on the body that computes its function: without ``cast_f32``
  K4b's launch at one page a unit (its split over bf16 pools, the FMA
  chunk body over f32), with it K1's.
- K7b (:func:`paged_decode_dmaonly_kernel`) replaces ``tools/profile_attn.py
  paged_decode_dmaonly``: K1's grid and loads with no math, an instrument.
  The reference's twin writes garbage by design; a load nothing reads is
  deleted by nvcc, so this one writes an f32 checksum of every value it
  loads (``ops/attention.py paged_decode_dmaonly``).

All four are bound by the bytes of the pages they read, as K1, and take any
G, as K1 does.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops.kernels import _build
from dynamo_tpu_torch.quant.kv import QuantizedPages

# K1, K4a, K4b, K7b and K7c take every head_dim that is a multiple of 128
# (and 64), K3a every one that is not; past WIDE_HEAD_DIM every decode launcher runs the
# runtime-D body (``paged_decode_attention_wide`` in csrc/paged_attention.cu)
WIDE_HEAD_DIM = 512
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT8 = 2  # the C entry points' kv dtype code for int8 pools
# K3a's FMA body: context rows a block.
SPLIT_ROWS = 128
# K1 over bf16 queries (and K3a's head dims on its body): context rows a
# split (a multiple of 64), the largest of these whose splits at the
# table's capacity give at least K1_SPLIT_BLOCKS blocks at head_dim 128 and
# up (about two an SM of an H100's 132), 128 / D times as many below, else
# the smallest (k1_split_rows)
K1_SPLIT_CHOICES = (512, 256, 128)
K1_SPLIT_BLOCKS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_SPLIT_ARGTYPES = [_P] * 11 + [_I] * 10 + [_P]  # K1 and K3a
_WIDE_ARGTYPES = [_P] * 13 + [_I] * 13 + [_P]
CHUNK_ROWS = 256  # K4a: context rows a chunk, at least (the reference's target)
GROUPED_SPLIT_ROWS = 256  # K4b: context rows a split, at least (whole pages)
_GROUPED_ARGTYPES = [_P] * 6 + [_I] * 6 + [_P] * 5 + [_I] * 5 + [_P]
_DMAONLY_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]


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


def check_decode_args(q, k_pages, v_pages, page_tables, positions, name: str = "K1"):
    """Raise on inputs K1 (or a decode variant ``name``) does not take;
    returns ``unpack_pools``' tuple."""
    if q.dim() != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"expected q [B, Hq, D] and pools [P, ps, Hkv, D]; got {tuple(q.shape)}, "
            f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    pools = unpack_pools(q, k_pages, v_pages, name)
    k, v = pools[:2]
    B, Hq, D = q.shape
    _, ps, Hkv, Dk = k.shape
    if Dk != D or not unfolded_head_dim(D):
        raise ValueError(f"{name} takes head_dim 64 or a multiple of 128; got q D={D}, pool D={Dk}")
    if Hq % Hkv:
        raise ValueError(f"{name} takes Hq a multiple of Hkv; got Hq={Hq}, Hkv={Hkv}")
    _check_tables(B, ps, page_tables, positions)
    _check_pools(q, k, v, page_tables, positions, name)
    return pools


def unfolded_head_dim(D: int) -> bool:
    """K1's, K2's, K4a/b's and K7a-c's head dims: every multiple of 128, as
    the reference sends them to its unfolded kernels, and 64, which their
    bodies also take (the dispatchers send a model's 64 to K3a / K3b, as the
    reference folds it)."""
    return D == 64 or (D > 0 and D % 128 == 0)


def folded_head_dim(D: int) -> bool:
    """K3a's and K3b's head dims: every head dim that is no multiple of 128
    (K1 / K2 take those), as the reference folds (or, for a folded row that
    is no multiple of 128, runs in plain XLA) every head_dim % 128 != 0."""
    return D > 0 and D % 128 != 0


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
    k, v = pools[:2]
    B, Hq, D = q.shape
    if not folded_head_dim(D):
        raise ValueError(f"K3a takes a head_dim that is no multiple of 128; got {D}")
    Hkv, _ = folded_geometry(q, k)
    if Hq % Hkv:
        raise ValueError(f"K3a takes Hq a multiple of Hkv; got Hq={Hq}, Hkv={Hkv}")
    _check_tables(B, k.shape[1], page_tables, positions)
    _check_pools(q, k, v, page_tables, positions, "K3a")
    return pools


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def split_partials(B: int, n_split: int, Hq: int, D: int, device, extra: int = 0):
    """One f32 scratch allocation a launch for the split-K partials of K1,
    K3a and K4b: (the tensor, which the caller holds until it has launched, and
    pointers to m, l [B, n_split, Hq], acc [B, n_split, Hq, D] and ``extra``
    more floats: K4b's scores and page maxima), each part on 16 bytes."""
    ml = -(-B * n_split * Hq // 4) * 4
    acc = -(-B * n_split * Hq * D // 4) * 4
    ws = torch.empty(2 * ml + acc + extra, dtype=torch.float32, device=device)
    base = ws.data_ptr()
    return ws, base, base + 4 * ml, base + 8 * ml, base + 4 * (2 * ml + acc)


def _split_launch(symbol: str, q, pools, page_tables, positions, split_rows: int,
                  partials: bool = True) -> torch.Tensor:
    """Launch K1's or K3a's entry ``symbol`` on checked inputs: splits of
    ``split_rows`` context rows and their f32 partials (``partials``; K1's
    f32 body reads none), then the merge."""
    k, v, ks, vs, code = pools
    q = _build.aligned16(q)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    B, Hq, D = q.shape
    Hkv, _ = folded_geometry(q, k)
    ps, mp = k.shape[1], page_tables.shape[1]
    n_split = -(-mp * ps // split_rows)
    ws, m_part, l_part, acc_part = None, None, None, None
    if partials:  # ws: alive past the launch
        ws, m_part, l_part, acc_part, _ = split_partials(B, n_split, Hq, D, q.device)
    out = torch.empty_like(q)
    err = _build.entry("paged_attention", symbol, _SPLIT_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), page_tables.data_ptr(),
        positions.data_ptr(), m_part, l_part, acc_part, out.data_ptr(), B, Hq, Hkv, D, ps, mp, split_rows,
        n_split, Q_DTYPES[q.dtype], code, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, symbol)
    return out


def _wide_launch(q, pools, page_tables, positions, unit_pages: int = 1, round_p: bool = False) -> torch.Tensor:
    """Launch the runtime-D body past ``WIDE_HEAD_DIM`` on checked inputs
    (K1 and K3a in every mix, K4a, K4b and K7c): a score pass with each
    page's max, a P.V pass in column slices of 512 that weighs each row at
    its unit's prefix max (``unit_pages`` pages a unit), rounding the
    probabilities to the pool dtype where ``round_p`` (a no-op but over bf16
    pools), and the merge; splits of ``grouped_split_rows(ps)`` rows."""
    k, v, ks, vs, code = pools
    q = _build.aligned16(q)
    page_tables = page_tables.contiguous()
    positions = positions.contiguous()
    B, Hq, D = q.shape
    Hkv, _ = folded_geometry(q, k)
    ps, mp = k.shape[1], page_tables.shape[1]
    split_rows = grouped_split_rows(ps)
    n_split = -(-mp * ps // split_rows)
    s_pad = -(-mp * ps // 4) * 4
    # ws (alive past the launch): m, l, acc, then scores [B, Hq, s_pad] and page maxima [B, Hq, mp]
    ws, m_part, l_part, acc_part, tail = split_partials(B, n_split, Hq, D, q.device, B * Hq * (s_pad + mp))
    out = torch.empty_like(q)
    err = _build.entry("paged_attention", "paged_decode_attention_wide", _WIDE_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), page_tables.data_ptr(), positions.data_ptr(),
        tail, tail + 4 * B * Hq * s_pad, m_part, l_part, acc_part, out.data_ptr(), B, Hq, Hkv, D, ps, mp,
        split_rows, n_split, s_pad, unit_pages, int(round_p), Q_DTYPES[q.dtype], code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attention_wide")
    return out


def _k1_rows(q, k, page_tables) -> int:
    Hkv, _ = folded_geometry(q, k)
    return k1_split_rows(q.shape[0], Hkv, q.shape[1] // Hkv, q.shape[2], page_tables.shape[1] * k.shape[1])


def k1_split_rows(B: int, Hkv: int, G: int, D: int, capacity: int) -> int:
    """K1's split rows for B sequences of ``capacity`` context rows at most
    (max_pages * ps), Hkv kv heads of G query heads of head_dim D: blocks of
    longer splits pay the fixed costs (the split's page rows, Q, the warps'
    merge) fewer times, shorter ones fill the card, and a block below D 128
    holds a smaller ring, so more of them fit an SM. On an H100
    (``tools/time_decode.py``, PERF.md) this picks the fastest of the three
    (or one within 1% of it) at K1's geometry at B 64 and 16 over contexts
    1..2048, at B 8, 4 and 1 over 2048-row contexts and at B 64 in a 256-row
    table, and at K3a's TinyLlama geometry (D 64 over 4 kv heads) at B 16
    and 64; past D 128 it is not measured. The host sees the table's
    capacity, not the contexts (they are on the device)."""
    need = K1_SPLIT_BLOCKS * 128 // min(D, 128)
    for rows in K1_SPLIT_CHOICES:
        if B * Hkv * -(-G // 16) * (2 if D > 256 else 1) * -(-capacity // rows) >= need:
            return rows
    return K1_SPLIT_CHOICES[-1]


def paged_decode_attention_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """q [B, Hq, D], pools [P, ps, Hkv, D] of q's dtype or int8
    QuantizedPages, page_tables [B, max_pages] int32 (layer offset added),
    positions [B] int32 -> [B, Hq, D] in q's dtype.

    Launches K1 (bf16 queries: a split pass and a merge) or raises: CUDA
    tensors only (``ops/attention.py dispatch_paged_decode_attention``
    sends CPU tensors to the plain version)."""
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors; got {q.device}")
    out = _k1_launch(q, check_decode_args(q, k_pages, v_pages, page_tables, positions), page_tables, positions)
    paged_decode_attention_kernel.launches += 1
    return out


def _k1_launch(q, pools, page_tables, positions) -> torch.Tensor:
    """K1's launch on checked inputs: its split body and merge (bf16
    queries), its FMA body (f32), or past ``WIDE_HEAD_DIM`` the runtime-D
    body."""
    if q.shape[-1] > WIDE_HEAD_DIM:
        return _wide_launch(q, pools, page_tables, positions)
    return _split_launch("paged_decode_attention", q, pools, page_tables, positions,
                         _k1_rows(q, pools[0], page_tables), q.dtype == torch.bfloat16)


def folded_on_k1_body(q) -> bool:
    """Whether K3a runs K1's split tensor-core body on ``q``: bf16 queries
    at a head dim that is a multiple of 16 below 128 (K1's split rows);
    else its FMA body (``SPLIT_ROWS``)."""
    return q.dtype == torch.bfloat16 and q.shape[-1] % 16 == 0 and q.shape[-1] < 128


def paged_decode_attention_folded_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """K3a: K1's contract at a head_dim that is no multiple of 128;
    the pools may also be given folded, [P, ps, Hkv*D] (the same memory).

    Launches K3a (a split pass and a merge pass) or raises: CUDA tensors
    only."""
    if q.device.type != "cuda":
        raise ValueError(f"K3a runs on CUDA tensors; got {q.device}")
    pools = check_folded_decode_args(q, k_pages, v_pages, page_tables, positions)
    if q.shape[-1] > WIDE_HEAD_DIM:
        out = _wide_launch(q, pools, page_tables, positions)
    else:
        rows = _k1_rows(q, pools[0], page_tables) if folded_on_k1_body(q) else SPLIT_ROWS
        out = _split_launch("paged_decode_attention_folded", q, pools, page_tables, positions, rows)
    paged_decode_attention_folded_kernel.launches += 1
    return out


def chunk_pages(page_size: int, max_pages: int) -> int:
    """K4a's pages a chunk, the reference's C = max(1, min(max_pages,
    ceil(256 / page_size)))."""
    return max(1, min(max_pages, -(-CHUNK_ROWS // page_size)))


def grouped_split_rows(page_size: int) -> int:
    """K4b's context rows a split: whole pages, at least
    ``GROUPED_SPLIT_ROWS`` (one page when a page is longer)."""
    return page_size * -(-GROUPED_SPLIT_ROWS // page_size)


def check_variant_args(q, k_pages, v_pages, page_tables, positions, name: str) -> None:
    """Raise on inputs the decode variants K4a, K4b, K7b and K7c do not take:
    K1's, but plain f32 or bf16 pools of q's dtype only (an int8 cache
    raises)."""
    if isinstance(k_pages, QuantizedPages) or isinstance(v_pages, QuantizedPages):
        raise ValueError(f"{name} takes f32 or bf16 pools, not an int8 cache (K1 serves int8)")
    check_decode_args(q, k_pages, v_pages, page_tables, positions, name)


def _variant_launch(name: str, symbol: str, argtypes, refused: str, q, k, v, page_tables, positions, out, *extra):
    """Launch ``symbol`` of ``csrc/decode_variants.cu`` on checked inputs:
    (q, k, v, tables, positions, out, B, Hq, Hkv, D, ps, max_pages, *extra,
    dtype, stream). The C launcher is the one check of its shared memory: a
    refusal raises ValueError(``refused``), a launch error
    KernelLaunchError."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k.shape
    err = _build.entry("decode_variants", symbol, argtypes)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), page_tables.contiguous().data_ptr(),
        positions.contiguous().data_ptr(), out.data_ptr(), B, Hq, Hkv, D, ps, page_tables.shape[1],
        *extra, Q_DTYPES[k.dtype], torch.cuda.current_stream(k.device).cuda_stream,
    )
    _build.check(err, f"{name} ({symbol})", refused)
    return out


def paged_decode_attention_chunked_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """K4a: K1's contract over f32 / bf16 pools of q's dtype, the context
    walked in chunks of ``chunk_pages(ps, max_pages) * ps`` rows with the
    probabilities rounded to the pool dtype before P.V: K4b's passes with a
    rounding unit of ``chunk_pages`` pages.

    Launches K4a (bf16: three kernels) or raises: CUDA tensors only, no int8
    cache."""
    if q.device.type != "cuda":
        raise ValueError(f"K4a runs on CUDA tensors; got {q.device}")
    check_variant_args(q, k_pages, v_pages, page_tables, positions, "K4a")
    out = _rounded_split("K4a", q, k_pages, v_pages, page_tables, positions,
                         chunk_pages(k_pages.shape[1], page_tables.shape[1]))
    paged_decode_attention_chunked_kernel.launches += 1
    return out


def paged_decode_perseq_variant_kernel(q, k_pages, v_pages, page_tables, positions,
                                       cast_f32: bool = False) -> torch.Tensor:
    """K7c: K1's contract walked one page an iteration (the reference perseq
    kernel's schedule); without ``cast_f32`` the probabilities are rounded to
    the pool dtype before P.V, with it this is K1's function. Each toggle
    runs on the body that computes its function: K4b's launch at one page a
    unit (:func:`_rounded_split`: over bf16 pools its exact split, over f32
    pools, where rounding is the identity, the FMA chunk body), or K1's
    (:func:`_k1_launch`).

    Launches K7c or raises: CUDA tensors only, no int8 cache."""
    if q.device.type != "cuda":
        raise ValueError(f"K7c runs on CUDA tensors; got {q.device}")
    check_variant_args(q, k_pages, v_pages, page_tables, positions, "K7c")
    if cast_f32:
        out = _k1_launch(q, (k_pages, v_pages, None, None, Q_DTYPES[q.dtype]), page_tables, positions)
    else:
        out = _rounded_split("K7c", q, k_pages, v_pages, page_tables, positions, 1)
    paged_decode_perseq_variant_kernel.launches += 1
    return out


def _rounded_split(name: str, q, k_pages, v_pages, page_tables, positions, unit_pages: int) -> torch.Tensor:
    """K4a's and K4b's launch: the probabilities rounded at the running max
    after each unit of ``unit_pages`` pages. bf16: splits of
    ``grouped_split_rows(ps)`` rows, scratch for the scores, the page maxima
    and the splits' partial states; f32: the FMA chunk body at one unit a chunk.
    Past ``WIDE_HEAD_DIM`` the runtime-D body, rounding at the same points."""
    if q.shape[-1] > WIDE_HEAD_DIM:
        return _wide_launch(q, (k_pages, v_pages, None, None, Q_DTYPES[q.dtype]), page_tables, positions,
                            unit_pages, True)
    B, Hq, D = q.shape
    ps, mp = k_pages.shape[1], page_tables.shape[1]
    split_rows = grouped_split_rows(ps)
    n_split = -(-mp * ps // split_rows)
    s_pad = -(-mp * ps // 4) * 4
    ws, ptrs = None, [None] * 5  # f32 pools take K7c's body: no scratch (ws: alive past the launch)
    if q.dtype == torch.bfloat16:  # scratch: m, l, acc, then scores [B, Hq, s_pad] and page maxima [B, Hq, mp]
        ws, m_part, l_part, acc_part, tail = split_partials(B, n_split, Hq, D, q.device, B * Hq * (s_pad + mp))
        ptrs = [tail, tail + 4 * B * Hq * s_pad, m_part, l_part, acc_part]
    refused = (f"page size {ps} at G={Hq // k_pages.shape[2]}, {unit_pages} pages a unit, needs more shared "
               f"memory than a block has (bf16: the split's scores; f32: a unit of scores)")
    q = _build.aligned16(q)
    return _variant_launch(name, "paged_decode_attention_grouped", _GROUPED_ARGTYPES, refused, q, k_pages,
                           v_pages, page_tables, positions, torch.empty_like(q), *ptrs, split_rows, n_split, s_pad,
                           unit_pages)


def paged_decode_attention_grouped_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """K4b: K1's contract over f32 / bf16 pools of q's dtype, one page an
    iteration, each page's probabilities rounded to the pool dtype before
    P.V (:func:`_rounded_split` at one page a unit).

    Launches K4b (bf16: three kernels) or raises: CUDA tensors only, no int8
    cache."""
    if q.device.type != "cuda":
        raise ValueError(f"K4b runs on CUDA tensors; got {q.device}")
    check_variant_args(q, k_pages, v_pages, page_tables, positions, "K4b")
    out = _rounded_split("K4b", q, k_pages, v_pages, page_tables, positions, 1)
    paged_decode_attention_grouped_kernel.launches += 1
    return out


def paged_decode_dmaonly_kernel(q, k_pages, v_pages, page_tables, positions) -> torch.Tensor:
    """K7b: K1's grid and page stream with no math. Returns f32 [B, Hq, D],
    out[b, h] = the sum over context rows j < len of (K + V)[j, kv(h)]
    (``ops/attention.py paged_decode_dmaonly``); q gives the shape only.

    Launches K7b or raises: CUDA tensors only, no int8 cache."""
    if q.device.type != "cuda":
        raise ValueError(f"K7b runs on CUDA tensors; got {q.device}")
    check_variant_args(q, k_pages, v_pages, page_tables, positions, "K7b")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    err = _build.entry("decode_variants", "paged_decode_dmaonly", _DMAONLY_ARGTYPES)(
        k_pages.data_ptr(), v_pages.data_ptr(), page_tables.contiguous().data_ptr(),
        positions.contiguous().data_ptr(), out.data_ptr(), B, Hq, Hkv, D, ps, page_tables.shape[1],
        Q_DTYPES[k_pages.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "K7b (paged_decode_dmaonly)")
    paged_decode_dmaonly_kernel.launches += 1
    return out


paged_decode_attention_kernel.launches = 0
paged_decode_attention_folded_kernel.launches = 0
paged_decode_attention_chunked_kernel.launches = 0
paged_decode_attention_grouped_kernel.launches = 0
paged_decode_perseq_variant_kernel.launches = 0
paged_decode_dmaonly_kernel.launches = 0
