"""Llama-family model (Llama 2/3) in PyTorch with a paged KV cache (port of
``dynamo_tpu/models/llama.py``).

  - Weights keep the reference's ``[in, out]`` layout, so the hot path is
    ``h @ w`` exactly as in JAX and ``models/convert.py`` copies JAX params
    without transposes. Each layer is an ``nn.Module``; the reference's
    ``lax.scan`` over stacked ``[L, ...]`` weights becomes a Python loop.
  - The KV cache is the reference's flat page pool ``{"k", "v"}``, each
    ``[num_layers * num_pages, page_size, Hkv, D]`` (layer l's page p at
    flat index ``l * num_pages + p``; page 0 of each layer is its trash page),
    always unfolded. With ``kv_cache_dtype="int8"`` each pool is a
    ``QuantizedPages`` (``quant/kv.py``: int8 rows, one f32 scale a token
    row). New rows are scattered in place before attention reads the pool
    (``ops/attention.py scatter_kv``).
  - Attention runs through ``ops/attention.py``'s dispatchers: on the card
    the CUDA kernels K1/K2, or K3a/K3b when ``kv_folded`` (head_dim not a
    multiple of 128, as the reference routes); their plain versions on the
    CPU.
  - ``quantize="int8_wo"``: the seven projections of every layer
    (``QUANT_WEIGHT_NAMES``) become ``quant/int8.py QuantizedLinear``
    containers (:meth:`LlamaModel.quantize_`) and run through ``qlinear``:
    kernel K8 on the card, its plain version on the CPU. Embeddings, the
    lm_head, norms and biases stay in the model dtype.

  - ``verify`` (speculative decoding): B lanes of T = k+1 rows at
    consecutive positions through ``_packed_forward`` in one weight pass,
    every row unembedded; attention is the packed prefill kernel K2 (K3b
    for a folded head_dim), and invalid rows scatter to the trash page.

  - ``gather_pages_wire`` / ``scatter_pages_wire``: the disaggregation
    wire (pages of every layer as one block), see their docstrings.

  - Multi-LoRA (``SUPPORTS_LORA``, ``dynamo_tpu_torch/lora/``): every
    forward takes ``lora`` (the slot-concatenated ``LoraPool``) and the
    rows' adapter slots (``lora_ids``: per lane, per slot, or one
    ``lora_id`` for a single-sequence prefill). ``lora_delta`` adds
    ``scale[id] * (x @ A[id]) @ B[id]`` at the reference's places: on q, k
    and v before the attention bias (so cached K/V rows are adapter-specific,
    which the salted block hashes encode), on wo's output, on gate and up,
    on down's output. It never gathers per token: x multiplies every slot's
    A at once, a per-row mask keeps the row's own slot block (times its
    scale) and zeroes the others (exact zeros), and that multiplies the
    stacked B. Each plane is read once a call whatever the batch, and
    nothing in it depends on the data's values, so it captures into a CUDA
    graph. The delta is f32 (TF32 must stay off for f32 parity) and is
    added in the activations' dtype; int8_wo weights compose (the delta
    rides on qlinear's output).

Not ported yet: M-RoPE, sp/pp/tp.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch
from torch import nn

from dynamo_tpu_torch.lora.adapter import LORA_GROUPS
from dynamo_tpu_torch.ops.attention import (
    dispatch_paged_decode_attention,
    dispatch_paged_prefill_attention,
    kv_folded,
    scatter_kv,
)
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.rotary import apply_rope
from dynamo_tpu_torch.quant.int8 import QUANT_MODES, qlinear, quantize_module_
from dynamo_tpu_torch.quant.kv import QuantizedPages, dequantize_rows, init_quantized_pages, quantize_kv_rows
from dynamo_tpu_torch.quant.kv import kv_page_bytes as _kv_page_bytes

_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "f32": torch.float32,
    "float32": torch.float32,
}


_GROUP_MODULES = dict(LORA_GROUPS)


def lora_mask(ids: torch.Tensor, scales: torch.Tensor, rank: int) -> torch.Tensor:
    """[T, S * rank] f32: row t holds ``scales[ids[t]]`` in its slot's
    ``rank`` columns and 0 in every other slot's."""
    ids = ids.long()
    col_slot = torch.arange(scales.shape[0] * rank, device=ids.device) // rank
    return torch.where(col_slot[None, :] == ids[:, None], scales[ids][:, None], 0.0)


def lora_group_delta(x: torch.Tensor, a: torch.Tensor, bs, mask: torch.Tensor) -> list:
    """The deltas of one module group: ``x`` [T, in], ``a`` [in, n * S * r]
    (the group's n A planes side by side, each slot-concatenated), ``bs`` the
    n B planes [S * r, out_j], ``mask`` from :func:`lora_mask`. Returns the n
    deltas [T, out_j] in x's dtype."""
    xa = (x.float() @ a).view(x.shape[0], len(bs), -1) * mask[:, None, :]
    return [(xa[:, j] @ b).to(x.dtype) for j, b in enumerate(bs)]


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, ids, scales: torch.Tensor) -> torch.Tensor:
    """The reference's ``lora_delta`` on the port's layout: ``scale[ids] *
    (x @ A[ids]) @ B[ids]`` for one module, ``a`` [in, S * r] and ``b`` [S *
    r, out] slot-concatenated (slot s in columns / rows s * r to + r),
    ``ids`` a per-row [T] vector (a mixed batch) or a scalar (a whole
    single-sequence chunk), slot 0 the zero adapter. f32 arithmetic, the
    result in x's dtype."""
    ids = torch.as_tensor(ids, device=x.device).reshape(-1).expand(x.shape[0])
    rank = b.shape[0] // scales.shape[0]
    return lora_group_delta(x, a, [b], lora_mask(ids, scales, rank))[0]


class LoraInputs:
    """One forward's LoRA inputs: the pool and the rows' slot mask (built
    once, read by every layer)."""

    __slots__ = ("pool", "mask")

    def __init__(self, pool, ids: torch.Tensor):
        self.pool = pool
        self.mask = lora_mask(ids, pool.scales, pool.rank)

    def delta(self, layer: int, group: str, x: torch.Tensor) -> list:
        pool = self.pool
        return lora_group_delta(x, pool.a[group][layer], [pool.b[m][layer] for m in _GROUP_MODULES[group]],
                                self.mask)


def parse_dtype(value) -> Any:
    """Accept a torch dtype or its string alias in tiny:{...} config overrides."""
    if isinstance(value, str):
        return _DTYPES[value]
    return value


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-style qkv biases
    # weight-only quantization: None (full precision) or "int8_wo" (int8
    # weights with per-output-channel f32 scales, quant/int8.py)
    quantize: Any = None
    # KV cache storage dtype: None / "bf16" (the model dtype) or "int8":
    # int8 pages with one f32 scale per (page, token row) (quant/kv.py)
    kv_cache_dtype: Any = None
    dtype: Any = torch.bfloat16

    @property
    def kv_quantized(self) -> bool:
        return self.kv_cache_dtype == "int8"

    @property
    def kv_folded(self) -> bool:
        """True when head_dim is not a multiple of 128 (TinyLlama's 64): the
        reference folds such pools to ``[ps, Hkv*D]`` rows and routes their
        attention to its folded kernels; the port keeps the pool unfolded
        (the same memory) and routes to K3a/K3b on the card."""
        return kv_folded(self.head_dim)

    @classmethod
    def from_hf_config(cls, d: dict) -> "LlamaConfig":
        """Build from a HuggingFace config.json dict (Llama / Qwen2 families)."""
        num_heads = d["num_attention_heads"]
        is_qwen = "qwen" in str(d.get("model_type", "")).lower()
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=d.get("num_key_value_heads", num_heads),
            head_dim=d.get("head_dim", d["hidden_size"] // num_heads),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            attention_bias=d.get("attention_bias", is_qwen),
        )

    @classmethod
    def tiny(cls, **overrides) -> "LlamaConfig":
        """Small config for tests; same defaults as the reference's tiny."""
        if "dtype" in overrides:
            overrides["dtype"] = parse_dtype(overrides["dtype"])
        base = cls(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            dtype=torch.float32,
        )
        return replace(base, **overrides)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class LlamaLayer(nn.Module):
    """One transformer layer's weights, ``[in, out]`` layout."""

    def __init__(self, c: LlamaConfig, device=None):
        super().__init__()
        D, H, Hkv, Dh, F = c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim, c.intermediate_size
        dt = c.dtype
        self.input_norm = _weight((D,), dt, device)
        self.wq = _weight((D, H * Dh), dt, device)
        self.wk = _weight((D, Hkv * Dh), dt, device)
        self.wv = _weight((D, Hkv * Dh), dt, device)
        self.wo = _weight((H * Dh, D), dt, device)
        self.post_norm = _weight((D,), dt, device)
        self.gate = _weight((D, F), dt, device)
        self.up = _weight((D, F), dt, device)
        self.down = _weight((F, D), dt, device)
        if c.attention_bias:
            self.bq = _weight((H * Dh,), dt, device)
            self.bk = _weight((Hkv * Dh,), dt, device)
            self.bv = _weight((Hkv * Dh,), dt, device)


class LlamaModel(nn.Module):
    """Forward functions over the module's own weights and a flat KV pool."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.embed = _weight((c.vocab_size, c.hidden_size), c.dtype, device)
        self.layers = nn.ModuleList(LlamaLayer(c, device) for _ in range(c.num_layers))
        self.final_norm = _weight((c.hidden_size,), c.dtype, device)
        if not c.tie_word_embeddings:
            self.lm_head = _weight((c.vocab_size, c.hidden_size), c.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    #: per-layer weights weight-only quantization takes (the decode
    #: weight stream); embeddings, lm_head, norms and biases never quantize
    QUANT_WEIGHT_NAMES = frozenset({"wq", "wk", "wv", "wo", "gate", "up", "down"})

    def quantize_(self) -> "LlamaModel":
        """Apply ``config.quantize`` to the full-precision weights in place
        (the reference's ``quantize_params``; a no-op when unset, and on
        weights already quantized)."""
        mode = self.config.quantize
        if not mode:
            return self
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quantize mode {mode!r} (supported: {QUANT_MODES})")
        for lp in self.layers:
            quantize_module_(lp, self.QUANT_WEIGHT_NAMES)
        return self

    # ---------------- KV cache ----------------

    def kv_cache_shape(self, num_pages: int, page_size: int) -> tuple[int, ...]:
        """Shape of each of the two flat page pools (always unfolded)."""
        c = self.config
        return (c.num_layers * num_pages, page_size, c.num_kv_heads, c.head_dim)

    #: Llama pools take the int8 KV cache (the MLA latent cache does not)
    SUPPORTS_KV_INT8 = True
    #: llama-family layers take the LoRA pass (dynamo_tpu_torch/lora/)
    SUPPORTS_LORA = True

    def init_kv_cache(self, num_pages: int, page_size: int) -> dict:
        shape = self.kv_cache_shape(num_pages, page_size)
        if self.config.kv_quantized:
            return {
                "k": init_quantized_pages(shape, self.device),
                "v": init_quantized_pages(shape, self.device),
            }
        return {
            "k": torch.zeros(shape, dtype=self.config.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.config.dtype, device=self.device),
        }

    def kv_page_bytes(self, page_size: int) -> int:
        """Device bytes one allocator page costs across all layers (K and V
        and, for int8, the scale planes)."""
        c = self.config
        return _kv_page_bytes(
            page_size, c.num_kv_heads, c.head_dim, c.num_layers,
            "int8" if c.kv_quantized else None, itemsize=c.dtype.itemsize,
        )

    # ---------------- disagg wire format ----------------
    # The wire layout is the model's block serialization for the KV transfer
    # between a prefill and a decode engine; flat_ids is [L, n] (per-layer
    # flat page ids). The port's pools are always unfolded, so its wire is
    # the reference's [L, 2, n, ps, Hkv, D] at every head dim (the reference
    # folds the last two at head dims that are no multiple of 128).

    # axis of the per-page (n) dimension in the wire arrays below
    wire_n_axis = 2

    def gather_pages_wire(self, kv: dict, flat_ids: torch.Tensor):
        """-> [L, 2, n, page_size, Hkv, D]. Int8 caches return ``{"q": int8
        [L, 2, n, ps, Hkv, D], "s": f32 [L, 2, n, ps]}``: the scale plane
        travels with the pages."""
        if isinstance(kv["k"], QuantizedPages):
            return {
                "q": torch.stack([kv["k"].q[flat_ids], kv["v"].q[flat_ids]], dim=1),
                "s": torch.stack([kv["k"].s[flat_ids], kv["v"].s[flat_ids]], dim=1),
            }
        return torch.stack([kv["k"][flat_ids], kv["v"][flat_ids]], dim=1)

    def scatter_pages_wire(self, kv: dict, flat_ids: torch.Tensor, data) -> dict:
        """Write a wire block into the pools in place (the reference's donated
        ``.at[].set``). A full-precision block into an int8 cache quantizes
        per token row on the way in; an int8 block into a full-precision
        cache dequantizes, as the reference's do. A block in the reference's
        folded layout ([L, 2, n, ps, Hkv * D], its pools at a head_dim that is
        not a multiple of 128: a reference peer's export) is the same bytes
        and is unfolded by a reshape."""
        pool = kv["k"].q if isinstance(kv["k"], QuantizedPages) else kv["k"]

        def unfold(t):
            return t.reshape(*t.shape[:4], *pool.shape[-2:]) if t.dim() == 5 else t

        data = {"q": unfold(data["q"]), "s": data["s"]} if isinstance(data, dict) else unfold(data)
        if isinstance(kv["k"], QuantizedPages):
            if isinstance(data, dict):
                q, s = data["q"].to(torch.int8), data["s"].float()
            else:
                rows = data.reshape(-1, data.shape[-2] * data.shape[-1])
                qr, sr = quantize_kv_rows(rows)
                q, s = qr.reshape(data.shape), sr.reshape(data.shape[:4])
            for i, name in enumerate(("k", "v")):
                kv[name].q[flat_ids] = q[:, i]
                kv[name].s[flat_ids] = s[:, i]
            return kv
        dt = kv["k"].dtype
        if isinstance(data, dict):
            data = dequantize_rows(data["q"], data["s"])
        kv["k"][flat_ids] = data[:, 0].to(dt)
        kv["v"][flat_ids] = data[:, 1].to(dt)
        return kv

    # ---------------- forward ----------------

    def _unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        """Final norm + lm head, f32 logits accumulated in f32 (the head is
        never materialized in f32 on the card)."""
        c = self.config
        h = rms_norm(hidden, self.final_norm, c.rms_norm_eps)
        head = self.embed if c.tie_word_embeddings else self.lm_head
        if h.dtype == torch.float32:
            return h @ head.t()
        if h.is_cuda:
            return torch.mm(h, head.t(), out_dtype=torch.float32)
        return h.float() @ head.float().t()

    def _layer(
        self,
        lp: LlamaLayer,
        hidden: torch.Tensor,  # [T, D]
        k_pool,  # [LP, ps, Hkv, D] full flat pool (plain or QuantizedPages)
        v_pool,
        positions: torch.Tensor,  # [T] sequential positions (rope)
        flat_phys: torch.Tensor,  # [T] flat page per token (layer trash for invalid)
        offsets: torch.Tensor,  # [T]
        attn_fn,
        lora: LoraInputs | None = None,
        layer_idx: int = 0,
    ) -> torch.Tensor:
        """One transformer layer; scatters the new K/V rows into the pools
        in place, then attends through ``attn_fn(q, k_pool, v_pool)``.
        ``lora``: the forward's LoRA inputs, whose layer ``layer_idx`` deltas
        ride on the projections (the reference's places)."""
        c = self.config
        T = hidden.shape[0]
        h = rms_norm(hidden, lp.input_norm, c.rms_norm_eps)
        q_flat = qlinear(h, lp.wq)
        k_flat = qlinear(h, lp.wk)
        v_flat = qlinear(h, lp.wv)
        if lora is not None:
            # before rope and the pool scatter: cached K/V rows are
            # adapter-specific, which the salted block identity encodes
            dq, dk, dv = lora.delta(layer_idx, "qkv", h)
            q_flat = q_flat + dq
            k_flat = k_flat + dk
            v_flat = v_flat + dv
        if c.attention_bias:
            q_flat = q_flat + lp.bq
            k_flat = k_flat + lp.bk
            v_flat = v_flat + lp.bv
        q = q_flat.reshape(T, -1, c.head_dim)
        k = k_flat.reshape(T, -1, c.head_dim)
        v = v_flat.reshape(T, -1, c.head_dim)
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        scatter_kv(k_pool, v_pool, k, v, flat_phys, offsets)
        attn = attn_fn(q, k_pool, v_pool).reshape(T, -1)
        # without adapters the expressions are the plain layer's, so no
        # intermediate lives longer (a captured graph's pool holds the peak)
        if lora is None:
            hidden = hidden + qlinear(attn, lp.wo)
            h = rms_norm(hidden, lp.post_norm, c.rms_norm_eps)
            prod = torch.nn.functional.silu(qlinear(h, lp.gate)) * qlinear(h, lp.up)
            return hidden + qlinear(prod, lp.down)
        hidden = hidden + (qlinear(attn, lp.wo) + lora.delta(layer_idx, "wo", attn)[0])
        h = rms_norm(hidden, lp.post_norm, c.rms_norm_eps)
        dg, du = lora.delta(layer_idx, "gu", h)
        prod = torch.nn.functional.silu(qlinear(h, lp.gate) + dg) * (qlinear(h, lp.up) + du)
        return hidden + (qlinear(prod, lp.down) + lora.delta(layer_idx, "down", prod)[0])

    def _num_pages(self, kv_cache: dict) -> int:
        return kv_cache["k"].shape[0] // self.config.num_layers

    @torch.no_grad()
    def prefill(
        self,
        kv_cache: dict,  # {"k","v"} flat pools (updated in place)
        tokens: torch.Tensor,  # [T] padded chunk
        positions: torch.Tensor,  # [T] int32 absolute positions
        page_table: torch.Tensor,  # [max_pages] int32 logical (per-layer) page ids
        valid: torch.Tensor,  # [T] bool
        last_idx,  # index of the final real token in chunk (int or 0-d tensor)
        lora=None,  # the adapter pool (lora/store.py LoraPool)
        lora_id=None,  # this chunk's adapter slot (int or 0-d tensor; 0 = base)
    ) -> tuple[torch.Tensor, dict]:
        """One (possibly chunked) prefill pass for a single sequence.
        Returns (logits[V] at last_idx, kv_cache)."""
        lora_ids = None
        if lora is not None:
            lora_ids = torch.as_tensor(0 if lora_id is None else lora_id, device=tokens.device).reshape(1)
        logits, kv_cache = self.prefill_packed(
            kv_cache, tokens[None], positions[None], page_table[None], valid[None],
            torch.as_tensor(last_idx, device=tokens.device).reshape(1), lora=lora, lora_ids=lora_ids,
        )
        return logits[0], kv_cache

    @torch.no_grad()
    def prefill_packed(
        self,
        kv_cache: dict,
        tokens: torch.Tensor,  # [N, T] bucket-padded chunks, one per lane
        positions: torch.Tensor,  # [N, T] int32 absolute positions per lane
        page_tables: torch.Tensor,  # [N, max_pages] int32 logical page ids per lane
        valid: torch.Tensor,  # [N, T] bool
        last_idx: torch.Tensor,  # [N] index of each lane's final real token
        lora=None,  # the adapter pool
        lora_ids: torch.Tensor | None = None,  # [N] per-lane adapter slots
    ) -> tuple[torch.Tensor, dict]:
        """Cross-request packed prefill: N lanes (chunks of N DIFFERENT
        sequences) in one [N*T] token stream, one weight pass; a
        mixed-adapter pack takes each lane's slot over its rows.
        Returns (logits [N, V] at each lane's last_idx, kv_cache)."""
        N, T = tokens.shape
        hidden, kv_cache = self._packed_forward(kv_cache, tokens, positions, page_tables, valid, lora, lora_ids)
        rows = hidden[torch.arange(N, device=hidden.device) * T + last_idx.long()]
        return self._unembed(rows), kv_cache

    def _lora_inputs(self, lora, lora_ids, rows: int, per: int, device) -> LoraInputs | None:
        """The forward's LoRA inputs: ``lora_ids`` [rows // per] (None: all
        base) repeated over each lane's ``per`` rows."""
        if lora is None:
            return None
        if lora_ids is None:
            lora_ids = torch.zeros(rows // per, dtype=torch.int32, device=device)
        return LoraInputs(lora, lora_ids[:, None].expand(-1, per).reshape(rows))

    def _packed_forward(self, kv_cache, tokens, positions, page_tables, valid, lora=None, lora_ids=None):
        """Shared N-lane layer stack: one weight pass over the flattened
        [N*T] token stream; paged prefill attention for all lanes in one
        kernel launch per layer; ``lora_ids`` [N] broadcast over each lane's
        rows. Returns (hidden [N*T, D], kv_cache)."""
        c = self.config
        k_pool, v_pool = kv_cache["k"], kv_cache["v"]
        page_size = k_pool.shape[1]
        N, T = tokens.shape
        mp = page_tables.shape[1]
        pos = positions.long()
        logical = (pos // page_size).clamp(max=mp - 1)
        lane = torch.arange(N, device=tokens.device)[:, None]
        phys = torch.where(valid, page_tables.long()[lane, logical], 0).reshape(N * T)
        offsets = torch.where(valid, pos % page_size, 0).reshape(N * T)
        pos_flat = positions.reshape(N * T)
        num_pages = self._num_pages(kv_cache)
        hidden = self.embed[tokens.reshape(N * T).long()].to(c.dtype)
        lora_in = self._lora_inputs(lora, lora_ids, N * T, T, tokens.device)
        for layer_idx, lp in enumerate(self.layers):
            off = layer_idx * num_pages
            tables = page_tables + off

            def attn_fn(q, kp, vp, tables=tables):
                return dispatch_paged_prefill_attention(q, kp, vp, tables, positions)

            hidden = self._layer(lp, hidden, k_pool, v_pool, pos_flat, off + phys, offsets, attn_fn, lora_in,
                                 layer_idx)
        return hidden, kv_cache

    @torch.no_grad()
    def verify(
        self,
        kv_cache: dict,  # {"k","v"} flat pools (updated in place)
        tokens: torch.Tensor,  # [B, T] anchor + draft tokens per slot
        positions: torch.Tensor,  # [B, T] int32 consecutive fed positions per slot
        page_tables: torch.Tensor,  # [B, max_pages] int32 logical page ids per slot
        valid: torch.Tensor,  # [B, T] bool (invalid rows -> trash page)
        lora=None,  # the adapter pool
        lora_ids: torch.Tensor | None = None,  # [B] per-slot adapter slots
    ) -> tuple[torch.Tensor, dict]:
        """Speculative verification: every slot feeds T = k+1 tokens at
        consecutive positions through its paged context in ONE weight pass
        (the packed-prefill path with tiny chunks, so the causal mask
        against the page table comes with it) and unembeds ALL rows.

        Returns (logits [B, T, V], kv_cache): logits[:, i] is the next-token
        distribution after the token fed at positions[:, i]. KV rows of
        invalid positions land on the trash page; rejected rows are
        overwritten by the next pass at the advanced anchor."""
        B, T = tokens.shape
        hidden, kv_cache = self._packed_forward(kv_cache, tokens, positions, page_tables, valid, lora, lora_ids)
        return self._unembed(hidden).reshape(B, T, -1), kv_cache

    @torch.no_grad()
    def decode(
        self,
        kv_cache: dict,
        tokens: torch.Tensor,  # [B] current token per slot
        positions: torch.Tensor,  # [B] int32 its absolute position
        page_tables: torch.Tensor,  # [B, max_pages] int32 logical (per-layer) page ids
        active: torch.Tensor,  # [B] bool
        lora=None,  # the adapter pool
        lora_ids: torch.Tensor | None = None,  # [B] per-slot adapter slots
    ) -> tuple[torch.Tensor, dict]:
        """One decode step for the whole batch. Returns (logits[B, V], kv_cache)."""
        c = self.config
        k_pool, v_pool = kv_cache["k"], kv_cache["v"]
        page_size = k_pool.shape[1]
        B = tokens.shape[0]
        mp = page_tables.shape[1]
        pos = positions.long()
        logical = (pos // page_size).clamp(0, mp - 1)
        phys = torch.where(
            active, page_tables.long()[torch.arange(B, device=tokens.device), logical], 0
        )
        offsets = torch.where(active, pos % page_size, 0)
        num_pages = self._num_pages(kv_cache)
        hidden = self.embed[tokens.long()].to(c.dtype)
        lora_in = self._lora_inputs(lora, lora_ids, B, 1, tokens.device)
        for layer_idx, lp in enumerate(self.layers):
            off = layer_idx * num_pages
            tables = page_tables + off

            def attn_fn(q, kp, vp, tables=tables):
                return dispatch_paged_decode_attention(q, kp, vp, tables, positions)

            hidden = self._layer(lp, hidden, k_pool, v_pool, positions, off + phys, offsets, attn_fn, lora_in,
                                 layer_idx)
        return self._unembed(hidden), kv_cache
