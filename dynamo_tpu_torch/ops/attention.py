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
use the plain versions below for CPU tensors. The kernel follows the
reference's routing (``dynamo_tpu/ops/attention.py``): a head_dim that is not
a multiple of 128 (:func:`kv_folded`, TinyLlama's 64) takes the folded
kernels K3a / K3b, every other head_dim K1 / K2. The folded kernels read the
port's unfolded pool, whose memory is the folded ``[P, ps, Hkv*D]`` layout.
``dispatch_paged_mla_decode_attention`` / ``dispatch_paged_mla_prefill_attention``
launch K5 / K6. A decode position below 0 attends context index 0 only, in
the plain versions as in the kernels (the reference's plain version spreads a
uniform softmax there; the engine never feeds one). The tensor-parallel paths
of the reference are not ported yet.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops.kernels.mla_attention import (
    paged_mla_decode_attention_kernel,
    paged_mla_prefill_attention_kernel,
)
from dynamo_tpu_torch.ops.kernels.paged_attention import (
    paged_decode_attention_folded_kernel,
    paged_decode_attention_kernel,
)
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention_folded_kernel,
    paged_prefill_attention_kernel,
)
from dynamo_tpu_torch.quant.kv import QuantizedPages, quantize_kv_rows

_NEG_INF = -1e30


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


def kv_folded(head_dim: int) -> bool:
    """The reference's routing rule (``LlamaConfig.kv_folded``): a head_dim
    that is not a multiple of 128 takes the folded kernels."""
    return head_dim % 128 != 0


def decode_kernel(head_dim: int):
    """The launcher a CUDA decode call takes: K3a for folded head dims, else K1."""
    return paged_decode_attention_folded_kernel if kv_folded(head_dim) else paged_decode_attention_kernel


def prefill_kernel(head_dim: int):
    """The launcher a CUDA prefill call takes: K3b for folded head dims, else K2."""
    return paged_prefill_attention_folded_kernel if kv_folded(head_dim) else paged_prefill_attention_kernel


def dispatch_paged_decode_attention(q, k_pages, v_pages, page_tables, positions):
    """Kernel K1 or K3a (:func:`decode_kernel`; the launcher launches or
    raises) for CUDA tensors; the plain version above for CPU tensors. Same
    contract either way, plain or int8 pools."""
    if q.device.type == "cpu":
        return paged_decode_attention(q, k_pages, v_pages, page_tables, positions)
    return decode_kernel(q.shape[-1])(q, k_pages, v_pages, page_tables, positions)


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
