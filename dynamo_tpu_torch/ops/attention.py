"""Paged attention: plain PyTorch versions of the kernels, and the
dispatchers the model calls (port of ``dynamo_tpu/ops/attention.py``).

The KV cache is paged: K and V each live in one flat page pool
``[num_layers * num_pages, page_size, num_kv_heads, head_dim]`` where layer
*l*'s physical page *p* sits at flat index ``l * num_pages + p``. A sequence's
logical block *i* maps to physical page ``page_table[i]``; gathering
``pages[layer_offset + page_table]`` restores logical order, so the flattened
context index *j* IS the token position.

Page 0 of each layer (flat index ``l * num_pages``) is the null/trash page:
padded page-table entries and masked-out scatter rows all target it, so no
valid data is ever clobbered. The port's pool is always unfolded
(``[.., Hkv, D]`` for every head_dim).

The MLA (latent) pool of the DeepSeek family is one flat
``[num_layers * num_pages, page_size, latent]`` pool of rows
``[norm(latent) ; rope(k_rope)]``, ``latent = d_c + d_r`` wide (the logical
width: the reference pads rows to a multiple of 128, a TPU lane rule the
port does not carry). All heads of a token share its row, so latent
attention is MQA with ``latent``-wide keys and ``d_c``-wide values.

Int8 KV cache (``EngineConfig.kv_cache_dtype="int8"``): the pools arrive as
``QuantizedPages`` (``quant/kv.py``), an int8 pool and a per-(page, token row)
f32 scale plane. ``scatter_kv`` quantizes fresh rows on the way in and
``gather_pages`` dequantizes the gathered context on the way out, so every
plain version below takes both pool kinds; the kernels instead read the int8
rows and scale score and probability columns, the same algebra.

``dispatch_paged_decode_attention`` / ``dispatch_paged_prefill_attention``
launch the hand-written CUDA kernels (``ops/kernels/``) for CUDA tensors and
use the chosen kernel's plain version below for CPU tensors. The kernel
follows the reference's routing (``dynamo_tpu/ops/attention.py``): a head_dim
that is not a multiple of 128 (:func:`kv_folded`, TinyLlama's 64) takes the
folded kernels K3a / K3b, every other head_dim K1 / K2. The folded kernels
read the port's unfolded pool, whose memory is the folded ``[P, ps, Hkv*D]``
layout. Decode reads ``DYNTPU_DECODE_KERNEL`` on every call, as the
reference does (:func:`decode_kernel`): ``chunked`` takes K4a and ``grouped``
K4b, whose plain versions round each chunk's (page's) probabilities to the
pool dtype before P.V as those TPU kernels do; ``lookahead`` (the default),
``perseq`` and any other value take K1, the kernel that stands for both TPU
kernels of those names; an int8 cache always takes K1 (the reference's rule:
its K4 kernels have no int8 branch) and a folded head_dim K3a.

The plain versions of the instruments K7a and K7b (``paged_prefill_dmaonly``,
``paged_decode_dmaonly``) compute the checksums those twins write: the
reference's twins write garbage by design, and a twin whose loads feed no
output would lose them to nvcc.

``dispatch_paged_mla_decode_attention`` / ``dispatch_paged_mla_prefill_attention``
launch K5 / K6. A decode position below 0 attends context index 0 only, in
the plain versions as in the kernels (the reference's plain version spreads a
uniform softmax there; the engine never feeds one). The tensor-parallel paths
of the reference are not ported yet.
"""

from __future__ import annotations

import os

import torch

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
)
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    ROWS_PER_BLOCK,
    paged_prefill_attention_folded_kernel,
    paged_prefill_attention_kernel,
)
from dynamo_tpu_torch.quant.kv import QuantizedPages, quantize_kv_rows

_NEG_INF = -1e30
DECODE_KERNEL_ENV = "DYNTPU_DECODE_KERNEL"  # the reference's decode-kernel switch


def scatter_kv(
    k_pages,  # [LP, ps, Hkv, D] flat pool (plain or QuantizedPages)
    v_pages,
    k_new: torch.Tensor,  # [T, Hkv, D]
    v_new: torch.Tensor,
    phys_pages: torch.Tensor,  # [T] int flat page per row (trash page for dropped rows)
    offsets: torch.Tensor,  # [T] int offset within page
):
    """Scatter new K/V rows into their physical pages.

    Unlike the reference, which returns new arrays and relies on XLA buffer
    donation to make the scatter in place, this writes the pools IN PLACE and
    returns them. Invalid rows are routed to a trash page by the caller, so no
    old-value select is needed. Int8 pools quantize each fresh row (one
    absmax over its head values) and write the int8 row and its scale."""
    idx = (phys_pages.long(), offsets.long())
    if isinstance(k_pages, QuantizedPages):
        # K and V rows quantize in one batch: per-row math, half the launches
        T = k_new.shape[0]
        q, s = quantize_kv_rows(torch.cat([k_new, v_new]))
        k_pages.q.index_put_(idx, q[:T])
        k_pages.s.index_put_(idx, s[:T])
        v_pages.q.index_put_(idx, q[T:])
        v_pages.s.index_put_(idx, s[T:])
        return k_pages, v_pages
    k_pages.index_put_(idx, k_new.to(k_pages.dtype))
    v_pages.index_put_(idx, v_new.to(v_pages.dtype))
    return k_pages, v_pages


def write_kv_pages(
    k_pages,  # [LP, ps, Hkv, D] plain or QuantizedPages
    v_pages,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    positions: torch.Tensor,  # [T] absolute positions
    page_table: torch.Tensor,  # [max_pages] flat page ids (entry 0 = trash)
    valid: torch.Tensor,  # [T] bool
    trash_page: int = 0,  # flat index of this layer's trash page
) -> tuple[torch.Tensor, torch.Tensor]:
    """Position-addressed wrapper over scatter_kv for a single sequence."""
    page_size = k_pages.shape[1]
    positions = positions.long()
    phys = torch.where(valid, page_table.long()[positions // page_size], trash_page)
    offsets = torch.where(valid, positions % page_size, 0)
    return scatter_kv(k_pages, v_pages, k_new, v_new, phys, offsets)


def gather_pages(pages, page_table: torch.Tensor) -> torch.Tensor:
    """[P, ps, Hkv, D] gathered by [..., max_pages] -> [..., max_pages * ps, Hkv, D].
    Int8 pools dequantize the gathered context (f32) with their row scales."""
    pt = page_table.long()
    if isinstance(pages, QuantizedPages):
        g = pages.q[pt].float()  # [..., max_pages, ps, Hkv, D]
        s = pages.s[pt]  # [..., max_pages, ps]
        g = g * s.reshape(*s.shape, *(1,) * (g.ndim - s.ndim))
    else:
        g = pages[pt]
    return g.reshape(*page_table.shape[:-1], -1, *pages.shape[2:])


def attention_with_positions(
    q: torch.Tensor,  # [T, Hq, D]
    k_ctx: torch.Tensor,  # [S, Hkv, D] in logical order (index == position)
    v_ctx: torch.Tensor,  # [S, Hkv, D]
    q_positions: torch.Tensor,  # [T] int
) -> torch.Tensor:
    """Causal attention where context index j attends iff j <= q_position[t].

    GQA as [Hkv, G] groups; softmax in float32; output cast back to q.dtype."""
    T, Hq, D = q.shape
    S, Hkv, _ = k_ctx.shape
    G = Hq // Hkv
    scale = 1.0 / (D**0.5)
    qg = q.float().reshape(T, Hkv, G, D)
    scores = torch.einsum("tkgd,skd->kgts", qg, k_ctx.float()) * scale
    ctx_idx = torch.arange(S, device=q.device)
    mask = ctx_idx[None, :] <= q_positions.long()[:, None]  # [T, S]
    scores = torch.where(mask, scores, torch.tensor(_NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("kgts,skd->tkgd", probs, v_ctx.float())
    return out.reshape(T, Hq, D).to(q.dtype)


def paged_prefill_attention(
    q: torch.Tensor,  # [T, Hq, D] (padded chunk)
    k_pages,  # [LP, ps, Hkv, D] plain or QuantizedPages
    v_pages,
    page_table: torch.Tensor,  # [max_pages]
    q_positions: torch.Tensor,  # [T] absolute positions
) -> torch.Tensor:
    """Chunk attention over all cached context + self (already written to pages)."""
    k_ctx = gather_pages(k_pages, page_table)
    v_ctx = gather_pages(v_pages, page_table)
    return attention_with_positions(q, k_ctx, v_ctx, q_positions)


def paged_prefill_attention_lanes(
    q: torch.Tensor,  # [N*T, Hq, D]
    k_pages,  # [LP, ps, Hkv, D] plain or QuantizedPages
    v_pages,
    page_tables: torch.Tensor,  # [N, max_pages]
    positions: torch.Tensor,  # [N, T]
) -> torch.Tensor:
    """N packed lanes, each its own paged_prefill_attention (the reference's
    per-lane loop in ``_packed_forward``)."""
    N, T = positions.shape
    qs = q.reshape(N, T, *q.shape[1:])
    outs = [
        paged_prefill_attention(qs[j], k_pages, v_pages, page_tables[j], positions[j])
        for j in range(N)
    ]
    return torch.cat(outs, dim=0)


def paged_decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k_pages,  # [LP, ps, Hkv, D] plain or QuantizedPages
    v_pages,
    page_tables: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B] the query token's absolute position
) -> torch.Tensor:
    """Single-token-per-sequence attention for the decode batch (the
    reference's vmap written out as a batch dimension). A position below 0
    attends index 0 only, K1's rule."""
    B, Hq, D = q.shape
    k_ctx = gather_pages(k_pages, page_tables).float()  # [B, S, Hkv, D]
    v_ctx = gather_pages(v_pages, page_tables).float()
    S, Hkv = k_ctx.shape[1], k_ctx.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (D**0.5)
    qg = q.float().reshape(B, Hkv, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_ctx) * scale
    ctx_idx = torch.arange(S, device=q.device)
    mask = ctx_idx[None, :] <= positions.long().clamp(min=0)[:, None]  # [B, S]
    scores = torch.where(mask[:, None, None, :], scores, torch.tensor(_NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_ctx)
    return out.reshape(B, Hq, D).to(q.dtype)


def _decode_lengths(positions: torch.Tensor, S: int) -> torch.Tensor:
    """K1's context length per sequence: min(max(pos + 1, 1), S)."""
    return (positions.long() + 1).clamp(1, S)


def paged_decode_attention_rounded(q, k_pages, v_pages, page_tables, positions, chunk_rows: int):
    """K1's function with the reference's rounded chunks: the context is
    walked in chunks of ``chunk_rows`` rows from index 0; each chunk takes one
    running max over its rows, its probabilities exp(s - m) enter the running
    sum in f32 and P.V rounded to the pool dtype (V rows past the length
    zeroed). The plain version of K4a (``chunk_rows`` = C * ps), K4b and K7c
    without ``cast_f32`` (``chunk_rows`` = ps); at f32 it is K1's function.
    Plain pools only: the reference's variants take no int8 cache."""
    B, Hq, D = q.shape
    k_ctx = gather_pages(k_pages, page_tables).float()  # [B, S, Hkv, D]
    v_ctx = gather_pages(v_pages, page_tables).float()
    S, Hkv = k_ctx.shape[1], k_ctx.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (D**0.5)
    valid = torch.arange(S, device=q.device)[None, :] < _decode_lengths(positions, S)[:, None]  # [B, S]
    scores = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, G, D), k_ctx) * scale
    scores = torch.where(valid[:, None, None, :], scores, torch.tensor(_NEG_INF, device=q.device))
    v_ctx = torch.where(valid[:, :, None, None], v_ctx, 0.0)
    m = torch.full((B, Hkv, G), _NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G), device=q.device)
    acc = torch.zeros((B, Hkv, G, D), device=q.device)
    for c0 in range(0, S, chunk_rows):
        s = scores[..., c0 : c0 + chunk_rows]
        new_m = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(s - new_m[..., None])
        l = l * corr + p.sum(-1)
        p = p.to(k_pages.dtype).float()
        acc = acc * corr[..., None] + torch.einsum("bkgs,bskd->bkgd", p, v_ctx[:, c0 : c0 + chunk_rows])
        m = new_m
    out = acc / l.clamp(min=1e-20)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention_chunked(q, k_pages, v_pages, page_tables, positions):
    """K4a's plain version: chunks of ``chunk_pages(ps, max_pages)`` pages."""
    ps = k_pages.shape[1]
    rows = chunk_pages(ps, page_tables.shape[1]) * ps
    return paged_decode_attention_rounded(q, k_pages, v_pages, page_tables, positions, rows)


def paged_decode_attention_grouped(q, k_pages, v_pages, page_tables, positions):
    """K4b's plain version: one page a chunk (the group of sequences a block
    changes the kernel's schedule, not its function)."""
    return paged_decode_attention_rounded(q, k_pages, v_pages, page_tables, positions, k_pages.shape[1])


def paged_decode_perseq_variant(q, k_pages, v_pages, page_tables, positions, cast_f32: bool = False):
    """K7c's plain version: one page a chunk, rounded unless ``cast_f32``
    (then K1's function, :func:`paged_decode_attention`)."""
    if cast_f32:
        return paged_decode_attention(q, k_pages, v_pages, page_tables, positions)
    return paged_decode_attention_grouped(q, k_pages, v_pages, page_tables, positions)


def paged_decode_dmaonly(q, k_pages, v_pages, page_tables, positions):
    """K7b's checksum: f32 [B, Hq, D], out[b, h] = the sum over context rows
    j < len (K1's length rule) of (K + V)[j, kv(h)]; q gives the shape."""
    B, Hq, D = q.shape
    ctx = gather_pages(k_pages, page_tables).float() + gather_pages(v_pages, page_tables).float()
    S, Hkv = ctx.shape[1], ctx.shape[2]
    valid = torch.arange(S, device=q.device)[None, :] < _decode_lengths(positions, S)[:, None]
    sums = torch.where(valid[:, :, None, None], ctx, 0.0).sum(1)  # [B, Hkv, D]
    return sums.repeat_interleave(Hq // Hkv, dim=1)


def paged_prefill_dmaonly(q, k_pages, v_pages, page_tables, positions):
    """K7a's checksum in K2's block partition: the rows of a lane fall in
    blocks of ``ROWS_PER_BLOCK // G`` query positions, and every row gets the
    f32 column sums of (K + V) of its kv head over its block's context, rows
    j < min(block's last position + 1, max_pages * ps) (int8 rows
    dequantized). f32 [N*T, Hq, D]; ``page_tables`` [max_pages] with
    ``positions`` [T] is the one-chunk form."""
    if page_tables.dim() == 1:
        page_tables, positions = page_tables[None], positions[None]
    N, T = positions.shape
    Hq = q.shape[1]
    outs = []
    for n in range(N):
        ctx = gather_pages(k_pages, page_tables[n]).float() + gather_pages(v_pages, page_tables[n]).float()
        S, Hkv, _ = ctx.shape
        G = Hq // Hkv
        BQ = ROWS_PER_BLOCK // G
        block_last = torch.clamp(torch.arange(T, device=q.device) // BQ * BQ + BQ - 1, max=T - 1)
        n_ctx = (positions[n, block_last].long() + 1).clamp(0, S)  # [T]
        csum = torch.cumsum(ctx, 0)  # [S, Hkv, D]
        sums = torch.where((n_ctx > 0)[:, None, None], csum[(n_ctx - 1).clamp(min=0)], 0.0)
        outs.append(sums.repeat_interleave(G, dim=1))
    return torch.cat(outs)


def kv_folded(head_dim: int) -> bool:
    """The reference's routing rule (``LlamaConfig.kv_folded``): a head_dim
    that is not a multiple of 128 takes the folded kernels."""
    return head_dim % 128 != 0


def decode_kernel(head_dim: int, quantized: bool = False, choice: str = "lookahead"):
    """The launcher a decode call takes (the reference's routing,
    ``dynamo_tpu/ops/attention.py``): K3a for a folded head_dim, K1 for an
    int8 cache, K4a for ``choice`` "chunked", K4b for "grouped", and K1 for
    every other choice ("lookahead", "perseq", ...)."""
    if kv_folded(head_dim):
        return paged_decode_attention_folded_kernel
    if quantized:
        return paged_decode_attention_kernel
    return {
        "chunked": paged_decode_attention_chunked_kernel,
        "grouped": paged_decode_attention_grouped_kernel,
    }.get(choice, paged_decode_attention_kernel)


# the plain version of each decode launcher, for CPU tensors
PLAIN_DECODE = {
    paged_decode_attention_kernel: paged_decode_attention,
    paged_decode_attention_folded_kernel: paged_decode_attention,
    paged_decode_attention_chunked_kernel: paged_decode_attention_chunked,
    paged_decode_attention_grouped_kernel: paged_decode_attention_grouped,
}


def prefill_kernel(head_dim: int):
    """The launcher a CUDA prefill call takes: K3b for folded head dims, else K2."""
    return paged_prefill_attention_folded_kernel if kv_folded(head_dim) else paged_prefill_attention_kernel


def dispatch_paged_decode_attention(q, k_pages, v_pages, page_tables, positions):
    """The kernel :func:`decode_kernel` picks for this call's head_dim, pool
    kind and ``DYNTPU_DECODE_KERNEL`` (the launcher launches or raises) for
    CUDA tensors; that kernel's plain version for CPU tensors. Same contract
    either way, plain or int8 pools."""
    kernel = decode_kernel(q.shape[-1], isinstance(k_pages, QuantizedPages),
                           os.environ.get(DECODE_KERNEL_ENV, "lookahead"))
    if q.device.type == "cpu":
        return PLAIN_DECODE[kernel](q, k_pages, v_pages, page_tables, positions)
    return kernel(q, k_pages, v_pages, page_tables, positions)


def dispatch_paged_prefill_attention(q, k_pages, v_pages, page_tables, positions):
    """Kernel K2 or K3b (:func:`prefill_kernel`; the launcher launches or
    raises) for CUDA tensors; the plain versions above for CPU tensors.
    ``page_tables`` [max_pages] with ``positions`` [T] is one chunk;
    [N, max_pages] with [N, T] is N packed lanes over ``q`` [N*T, Hq, D] in
    one launch. Positions must be unit-stride within a lane (the kernels'
    precondition, as on the TPU)."""
    if q.device.type == "cpu":
        if page_tables.dim() == 1:
            return paged_prefill_attention(q, k_pages, v_pages, page_tables, positions)
        return paged_prefill_attention_lanes(q, k_pages, v_pages, page_tables, positions)
    return prefill_kernel(q.shape[-1])(q, k_pages, v_pages, page_tables, positions)


def paged_mla_decode_attention(
    q_cat: torch.Tensor,  # [B, H, latent] f32, pre-scaled by 1/sqrt(d_n + d_r)
    pages: torch.Tensor,  # [P, ps, latent] flat latent pool
    page_tables: torch.Tensor,  # [B, max_pages] (layer offset added)
    positions: torch.Tensor,  # [B] the query token's absolute position
    d_c: int,
) -> torch.Tensor:
    """Latent-space decode attention (K5's function): score = q_cat . row,
    output = the softmax-weighted sum of the rows' first d_c columns,
    a_lat [B, H, d_c] in q_cat's dtype. A position below 0 attends index 0
    only."""
    ctx = gather_pages(pages, page_tables).float()  # [B, S, latent]
    S = ctx.shape[1]
    scores = torch.einsum("bhl,bsl->bhs", q_cat.float(), ctx)
    ctx_idx = torch.arange(S, device=q_cat.device)
    mask = ctx_idx[None, :] <= positions.long().clamp(min=0)[:, None]  # [B, S]
    scores = torch.where(mask[:, None, :], scores, torch.tensor(_NEG_INF, device=q_cat.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsc->bhc", probs, ctx[..., :d_c]).to(q_cat.dtype)


def paged_mla_prefill_attention(
    q_cat: torch.Tensor,  # [T, H, latent] f32, pre-scaled
    pages: torch.Tensor,  # [P, ps, latent]
    page_table: torch.Tensor,  # [max_pages] (layer offset added)
    positions: torch.Tensor,  # [T] absolute positions
    d_c: int,
) -> torch.Tensor:
    """Latent-space chunked-prefill attention (K6's function) over all
    cached context + the chunk itself (already scattered into the pool):
    row t attends context j <= positions[t]. Returns a_lat [T, H, d_c]."""
    ctx = gather_pages(pages, page_table).float()  # [S, latent]
    S = ctx.shape[0]
    scores = torch.einsum("thl,sl->hts", q_cat.float(), ctx)
    ctx_idx = torch.arange(S, device=q_cat.device)
    mask = ctx_idx[None, :] <= positions.long()[:, None]  # [T, S]
    scores = torch.where(mask[None], scores, torch.tensor(_NEG_INF, device=q_cat.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hts,sc->thc", probs, ctx[:, :d_c]).to(q_cat.dtype)


def dispatch_paged_mla_decode_attention(q_cat, pages, page_tables, positions, d_c):
    """Kernel K5 (``ops/kernels/mla_attention.py``, which launches or
    raises) for CUDA tensors; the plain version above for CPU tensors."""
    if q_cat.device.type == "cpu":
        return paged_mla_decode_attention(q_cat, pages, page_tables, positions, d_c)
    return paged_mla_decode_attention_kernel(q_cat, pages, page_tables, positions, d_c)


def dispatch_paged_mla_prefill_attention(q_cat, pages, page_table, positions, d_c):
    """Kernel K6 (``ops/kernels/mla_attention.py``, which launches or
    raises) for CUDA tensors; the plain version above for CPU tensors.
    Positions must be unit-stride (the kernel's precondition, as on the
    TPU)."""
    if q_cat.device.type == "cpu":
        return paged_mla_prefill_attention(q_cat, pages, page_table, positions, d_c)
    return paged_mla_prefill_attention_kernel(q_cat, pages, page_table, positions, d_c)
