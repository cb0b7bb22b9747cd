"""DeepSeek-V2/V3-family model: Multi-head Latent Attention (MLA) + MoE with
shared experts, in PyTorch with a paged latent KV cache (port of
``dynamo_tpu/models/deepseek.py``).

  - Absorbed attention everywhere, as in the reference: queries fold through
    the k-up projection into the latent space (``_fold_q``, f32), the
    kernels K5/K6 attend against the cached latent rows and return a_lat
    [.., H, d_c] (f32), and the output folds through the v-up projection in
    f32 before ``wo``. The pool stays in the model dtype.
  - The latent cache is one flat pool ``{"ckv": [L * P, ps, latent]}`` (layer
    l's page p at flat index ``l * num_pages + p``, page 0 of each layer its
    trash page) whose rows are ``[rms_norm(c_latent) ; rope(k_rope)]``. The
    port stores the logical width ``latent = d_c + d_r`` (576 for V2-Lite);
    the reference pads rows to a multiple of 128, a TPU lane rule
    (``models/convert.py ckv_from_jax`` slices the pad away). New rows are
    scattered in place before attention reads the pool.
  - Layers keep the reference's two groups: the first
    ``first_k_dense_replace`` are dense-MLP layers (:class:`MlaDenseLayer`),
    the rest shared + routed-expert MoE layers (:class:`MlaMoeLayer`), with
    weights in the reference's ``[in, out]`` layout and the router in f32.
  - Prefill and decode attention always go through the MLA dispatchers: K6
    on every prefill chunk and K5 on every decode step on the card (the
    reference's ``T % 128`` gate for its Pallas prefill is a Mosaic tiling
    rule and does not carry over), the plain versions on the CPU.

  - ``quantize="int8_wo"``: the reference's ``QUANT_WEIGHT_NAMES`` (query,
    latent down and output projections, dense and shared MLPs, the routed
    expert banks) become ``quant/int8.py QuantizedLinear`` containers
    (:meth:`DeepseekModel.quantize_`) and run through ``qlinear`` /
    ``qlinear_expert``: kernel K8 on the card. The k-up / v-up banks, the
    norms and the f32 router stay full precision.

  - ``verify`` (speculative decoding): the B * T rows of B lanes go through
    K5 as decode queries, each row with its lane's page table and its own
    position, so a row attends to context j <= its position (the
    reference attends each lane through a plain absorbed path,
    ``dynamo_tpu/models/deepseek.py:559-578``; K5 computes the same
    function in one launch a layer).

Not ported yet: tensor parallelism (``attn_mesh``), the wire export, yarn
rope scaling (the reference raises on it too).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional

import torch
from torch import nn

from dynamo_tpu_torch.models.llama import parse_dtype
from dynamo_tpu_torch.ops.attention import (
    dispatch_paged_mla_decode_attention,
    dispatch_paged_mla_prefill_attention,
)
from dynamo_tpu_torch.ops.moe import moe_block
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.rotary import apply_rope
from dynamo_tpu_torch.quant.int8 import QUANT_MODES, qlinear, quantize_module_


@dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int = 102400
    hidden_size: int = 5120
    intermediate_size: int = 12288  # dense layers' MLP width
    num_layers: int = 60
    num_heads: int = 128
    # MLA geometry
    q_lora_rank: Optional[int] = 1536  # None => plain q projection
    kv_lora_rank: int = 512  # d_c
    qk_nope_head_dim: int = 128  # d_n
    qk_rope_head_dim: int = 64  # d_r
    v_head_dim: int = 128  # d_v
    # MoE geometry
    n_routed_experts: int = 160
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    moe_intermediate_size: int = 1536
    first_k_dense_replace: int = 1
    moe_capacity_factor: float = 2.0
    # routed-expert output scale (DeepSeek-V2 uses 16.0; V2-Lite 1.0)
    routed_scaling_factor: float = 1.0
    # False (DeepSeek default): top-k probs from the full softmax, not
    # renormalized over the selected k
    norm_topk_prob: bool = False
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    # weight-only quantization mode (None or "int8_wo"); see LlamaConfig
    quantize: Any = None
    dtype: Any = torch.bfloat16

    @property
    def latent_dim(self) -> int:
        """Cache row width: latent + shared rope key (the port stores no pad)."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @classmethod
    def from_hf_config(cls, d: dict) -> "DeepseekConfig":
        """Build from a HuggingFace deepseek_v2/v3 config.json dict.

        Raises for checkpoint features this implementation does not model
        (wrong numerics would otherwise be silent): sigmoid routing with
        correction bias (V3), group-limited top-k, and yarn rope scaling."""
        unsupported = []
        if d.get("scoring_func", "softmax") != "softmax":
            unsupported.append(f"scoring_func={d['scoring_func']!r} (V3 sigmoid routing)")
        if d.get("topk_method", "greedy") not in ("greedy", None):
            unsupported.append(f"topk_method={d['topk_method']!r} (group-limited top-k)")
        if d.get("rope_scaling"):
            unsupported.append("rope_scaling (yarn + mscale)")
        if unsupported:
            raise ValueError("deepseek checkpoint needs unsupported features: " + ", ".join(unsupported))
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            q_lora_rank=d.get("q_lora_rank"),
            kv_lora_rank=d.get("kv_lora_rank", 512),
            qk_nope_head_dim=d.get("qk_nope_head_dim", 128),
            qk_rope_head_dim=d.get("qk_rope_head_dim", 64),
            v_head_dim=d.get("v_head_dim", 128),
            n_routed_experts=d.get("n_routed_experts", 64),
            num_experts_per_tok=d.get("num_experts_per_tok", 6),
            n_shared_experts=d.get("n_shared_experts", 2),
            moe_intermediate_size=d.get("moe_intermediate_size", 1408),
            first_k_dense_replace=d.get("first_k_dense_replace", 1),
            routed_scaling_factor=d.get("routed_scaling_factor", 1.0),
            norm_topk_prob=d.get("norm_topk_prob", False),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
        )

    @classmethod
    def tiny_mla(cls, **overrides) -> "DeepseekConfig":
        """Small config for tests (1 dense + 1 MoE layer); the reference's
        tiny_mla."""
        if "dtype" in overrides:
            overrides["dtype"] = parse_dtype(overrides["dtype"])
        base = cls(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            q_lora_rank=None,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            n_routed_experts=4,
            num_experts_per_tok=2,
            n_shared_experts=1,
            moe_intermediate_size=32,
            first_k_dense_replace=1,
            moe_capacity_factor=8.0,  # exact (no drops) at test scale
            dtype=torch.float32,
        )
        return replace(base, **overrides)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class MlaLayer(nn.Module):
    """The attention weights every layer has, ``[in, out]`` layout."""

    def __init__(self, c: DeepseekConfig, device=None):
        super().__init__()
        D, H, dt = c.hidden_size, c.num_heads, c.dtype
        dn, dr, dv, dc = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank
        self.input_norm = _weight((D,), dt, device)
        self.w_dkv = _weight((D, dc + dr), dt, device)
        self.kv_norm = _weight((dc,), dt, device)
        # k-up and v-up projections from the latent, per head
        self.w_kb = _weight((dc, H, dn), dt, device)
        self.w_vb = _weight((dc, H, dv), dt, device)
        self.wo = _weight((H * dv, D), dt, device)
        self.post_norm = _weight((D,), dt, device)
        if c.q_lora_rank:
            self.w_dq = _weight((D, c.q_lora_rank), dt, device)
            self.q_norm = _weight((c.q_lora_rank,), dt, device)
            self.w_uq = _weight((c.q_lora_rank, H * (dn + dr)), dt, device)
        else:
            self.w_q = _weight((D, H * (dn + dr)), dt, device)


class MlaDenseLayer(MlaLayer):
    """Attention + a dense SwiGLU MLP (the first ``first_k_dense_replace``)."""

    moe = False

    def __init__(self, c: DeepseekConfig, device=None):
        super().__init__(c, device)
        D, F, dt = c.hidden_size, c.intermediate_size, c.dtype
        self.gate = _weight((D, F), dt, device)
        self.up = _weight((D, F), dt, device)
        self.down = _weight((F, D), dt, device)


class MlaMoeLayer(MlaLayer):
    """Attention + shared experts + routed experts (f32 router)."""

    moe = True

    def __init__(self, c: DeepseekConfig, device=None):
        super().__init__(c, device)
        D, E, Fm, dt = c.hidden_size, c.n_routed_experts, c.moe_intermediate_size, c.dtype
        Fs = c.n_shared_experts * Fm
        self.router = _weight((D, E), torch.float32, device)
        self.w_gate = _weight((E, D, Fm), dt, device)
        self.w_up = _weight((E, D, Fm), dt, device)
        self.w_down = _weight((E, Fm, D), dt, device)
        self.shared_gate = _weight((D, Fs), dt, device)
        self.shared_up = _weight((D, Fs), dt, device)
        self.shared_down = _weight((Fs, D), dt, device)


class DeepseekModel(nn.Module):
    """Forward functions over the module's own weights and a flat latent pool."""

    def __init__(self, config: DeepseekConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        Ld = c.first_k_dense_replace
        self.embed = _weight((c.vocab_size, c.hidden_size), c.dtype, device)
        self.dense_layers = nn.ModuleList(MlaDenseLayer(c, device) for _ in range(Ld))
        self.moe_layers = nn.ModuleList(MlaMoeLayer(c, device) for _ in range(c.num_layers - Ld))
        self.final_norm = _weight((c.hidden_size,), c.dtype, device)
        self.lm_head = _weight((c.vocab_size, c.hidden_size), c.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layers(self):
        """Every layer in forward order (dense group, then MoE group)."""
        return [*self.dense_layers, *self.moe_layers]

    #: quantizable weights in both layer groups (applied by presence); the
    #: k-up / v-up banks w_kb / w_vb (per-head einsum operands, ~1% of the
    #: bytes), the norms and the f32 router stay full precision
    QUANT_WEIGHT_NAMES = frozenset({
        "w_q", "w_dq", "w_uq", "w_dkv", "wo",
        "gate", "up", "down",
        "w_gate", "w_up", "w_down",
        "shared_gate", "shared_up", "shared_down",
    })

    def quantize_(self) -> "DeepseekModel":
        """Apply ``config.quantize`` to both layer groups in place (the
        reference's ``quantize_params``; a no-op when unset)."""
        mode = self.config.quantize
        if not mode:
            return self
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quantize mode {mode!r} (supported: {QUANT_MODES})")
        for lp in self.layers():
            quantize_module_(lp, self.QUANT_WEIGHT_NAMES)
        return self

    # ---------------- KV cache (paged latents) ----------------

    def kv_cache_shape(self, num_pages: int, page_size: int) -> tuple[int, ...]:
        c = self.config
        return (c.num_layers * num_pages, page_size, c.latent_dim)

    def init_kv_cache(self, num_pages: int, page_size: int) -> dict:
        shape = self.kv_cache_shape(num_pages, page_size)
        return {"ckv": torch.zeros(shape, dtype=self.config.dtype, device=self.device)}

    def kv_page_bytes(self, page_size: int) -> int:
        """Device bytes one allocator page costs across all layers: one
        latent row a token (the reference's DeepseekModel prices no pages,
        so its step anatomy has no roofline; ROADMAP "Known differences")."""
        c = self.config
        return c.num_layers * page_size * c.latent_dim * c.dtype.itemsize

    def _num_pages(self, kv_cache: dict) -> int:
        return kv_cache["ckv"].shape[0] // self.config.num_layers

    # ---------------- attention core ----------------

    def _queries(self, lp: MlaLayer, h: torch.Tensor, positions: torch.Tensor):
        """h [T, D] -> (q_nope [T, H, dn], q_rope [T, H, dr] roped)."""
        c = self.config
        T = h.shape[0]
        dn, dr = c.qk_nope_head_dim, c.qk_rope_head_dim
        if c.q_lora_rank:
            ql = rms_norm(qlinear(h, lp.w_dq), lp.q_norm, c.rms_norm_eps)
            q = qlinear(ql, lp.w_uq).reshape(T, c.num_heads, dn + dr)
        else:
            q = qlinear(h, lp.w_q).reshape(T, c.num_heads, dn + dr)
        return q[..., :dn], apply_rope(q[..., dn:], positions, c.rope_theta)

    def _cache_rows(self, lp: MlaLayer, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """h [T, D] -> cache rows [T, latent] = [norm(latent), roped k_rope]."""
        c = self.config
        dc = c.kv_lora_rank
        ckv = qlinear(h, lp.w_dkv)  # [T, dc + dr]
        latent = rms_norm(ckv[:, :dc], lp.kv_norm, c.rms_norm_eps)
        k_rope = apply_rope(ckv[:, None, dc:], positions, c.rope_theta)[:, 0]
        return torch.cat([latent, k_rope], dim=-1).to(c.dtype)

    def _fold_q(self, lp: MlaLayer, q_nope: torch.Tensor, q_rope: torch.Tensor) -> torch.Tensor:
        """(q_nope, q_rope) -> pre-scaled q_cat [.., H, latent] f32 for the
        latent-space kernels (the fold through w_kb stays outside them)."""
        c = self.config
        scale = 1.0 / math.sqrt(c.qk_nope_head_dim + c.qk_rope_head_dim)
        q_eff = torch.einsum("...hn,chn->...hc", q_nope.float(), lp.w_kb.float())
        return torch.cat([q_eff, q_rope.float()], dim=-1) * scale

    def _layer(
        self,
        lp: MlaLayer,
        hidden: torch.Tensor,  # [T, D]
        pool: torch.Tensor,  # [LP, ps, latent] full flat pool
        positions: torch.Tensor,  # [T]
        flat_phys: torch.Tensor,  # [T] flat page per token (layer trash for invalid)
        offsets: torch.Tensor,  # [T]
        attn_fn,
    ) -> torch.Tensor:
        """One layer; scatters the new latent rows into the pool in place,
        then attends through ``attn_fn(q_cat, pool) -> a_lat``."""
        c = self.config
        T = hidden.shape[0]
        h = rms_norm(hidden, lp.input_norm, c.rms_norm_eps)
        q_nope, q_rope = self._queries(lp, h, positions)
        rows = self._cache_rows(lp, h, positions)
        pool.index_put_((flat_phys.long(), offsets.long()), rows)
        a_lat = attn_fn(self._fold_q(lp, q_nope, q_rope), pool)  # [T, H, dc] f32
        # fold through the v-up projection in f32
        out = torch.einsum("thc,chv->thv", a_lat.float(), lp.w_vb.float())
        hidden = hidden + qlinear(out.to(c.dtype).reshape(T, -1), lp.wo)
        h = rms_norm(hidden, lp.post_norm, c.rms_norm_eps)
        silu = torch.nn.functional.silu
        if lp.moe:
            shared = qlinear(silu(qlinear(h, lp.shared_gate)) * qlinear(h, lp.shared_up), lp.shared_down)
            routed = moe_block(
                h, lp.router, lp.w_gate, lp.w_up, lp.w_down,
                num_experts_per_tok=c.num_experts_per_tok,
                capacity_factor=c.moe_capacity_factor,
                renormalize=c.norm_topk_prob,
            )
            return hidden + shared + c.routed_scaling_factor * routed
        return hidden + qlinear(silu(qlinear(h, lp.gate)) * qlinear(h, lp.up), lp.down)

    def _unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        """Final norm + lm head, f32 logits accumulated in f32."""
        h = rms_norm(hidden, self.final_norm, self.config.rms_norm_eps)
        if h.dtype == torch.float32:
            return h @ self.lm_head.t()
        if h.is_cuda:
            return torch.mm(h, self.lm_head.t(), out_dtype=torch.float32)
        return h.float() @ self.lm_head.float().t()

    def _forward(self, pool, hidden, positions, phys, offsets, tables, attend):
        """The layer stack; layer i reads tables + i * num_pages through
        ``attend(q_cat, pool, tables)``."""
        num_pages = pool.shape[0] // self.config.num_layers
        for i, lp in enumerate(self.layers()):
            off = i * num_pages

            def attn_fn(q_cat, pool, tables=tables + off):
                return attend(q_cat, pool, tables)

            hidden = self._layer(lp, hidden, pool, positions, off + phys, offsets, attn_fn)
        return hidden

    # ---------------- public forward API (ModelRunner contract) ----------------

    @torch.no_grad()
    def prefill(
        self,
        kv_cache: dict,  # {"ckv"} flat latent pool (updated in place)
        tokens: torch.Tensor,  # [T] padded chunk
        positions: torch.Tensor,  # [T] int32 absolute positions (unit stride)
        page_table: torch.Tensor,  # [max_pages] int32 logical (per-layer) page ids
        valid: torch.Tensor,  # [T] bool
        last_idx,  # index of the final real token in the chunk (int or 0-d tensor)
    ) -> tuple[torch.Tensor, dict]:
        """One (possibly chunked) prefill pass for a single sequence.
        Returns (logits[V] at last_idx, kv_cache)."""
        c = self.config
        pool = kv_cache["ckv"]
        ps = pool.shape[1]
        mp = page_table.shape[0]
        pos = positions.long()
        phys = torch.where(valid, page_table.long()[(pos // ps).clamp(0, mp - 1)], 0)
        offsets = torch.where(valid, pos % ps, 0)
        hidden = self.embed[tokens.long()].to(c.dtype)

        def attend(q_cat, pool, table):
            return dispatch_paged_mla_prefill_attention(q_cat, pool, table, positions, c.kv_lora_rank)

        hidden = self._forward(pool, hidden, positions, phys, offsets, page_table, attend)
        idx = torch.as_tensor(last_idx, device=hidden.device).reshape(1).long()
        return self._unembed(hidden.index_select(0, idx))[0], kv_cache

    @torch.no_grad()
    def decode(
        self,
        kv_cache: dict,
        tokens: torch.Tensor,  # [B] current token per slot
        positions: torch.Tensor,  # [B] int32 its absolute position
        page_tables: torch.Tensor,  # [B, max_pages] int32 logical (per-layer) page ids
        active: torch.Tensor,  # [B] bool
    ) -> tuple[torch.Tensor, dict]:
        """One decode step for the whole batch. Returns (logits[B, V], kv_cache)."""
        c = self.config
        pool = kv_cache["ckv"]
        ps = pool.shape[1]
        B, mp = page_tables.shape
        pos = positions.long()
        phys = torch.where(
            active,
            page_tables.long()[torch.arange(B, device=tokens.device), (pos // ps).clamp(0, mp - 1)],
            0,
        )
        offsets = torch.where(active, pos % ps, 0)
        hidden = self.embed[tokens.long()].to(c.dtype)

        def attend(q_cat, pool, tables):
            return dispatch_paged_mla_decode_attention(q_cat, pool, tables, positions, c.kv_lora_rank)

        hidden = self._forward(pool, hidden, positions, phys, offsets, page_tables, attend)
        return self._unembed(hidden), kv_cache

    @torch.no_grad()
    def verify(
        self,
        kv_cache: dict,
        tokens: torch.Tensor,  # [B, T] anchor + draft tokens per slot
        positions: torch.Tensor,  # [B, T] int32 consecutive fed positions per slot
        page_tables: torch.Tensor,  # [B, max_pages] int32 logical page ids per slot
        valid: torch.Tensor,  # [B, T] bool (invalid rows -> trash page)
    ) -> tuple[torch.Tensor, dict]:
        """Speculative verification (the ModelRunner contract, see
        LlamaModel.verify): [B, T] anchor + draft tokens at consecutive
        positions, one weight pass, logits at ALL rows. Latent rows of
        invalid positions scatter to the trash page; the B * T rows attend
        through K5, each with its lane's table and its own position.

        Returns (logits [B, T, V], kv_cache)."""
        c = self.config
        pool = kv_cache["ckv"]
        ps = pool.shape[1]
        B, T = tokens.shape
        mp = page_tables.shape[1]
        pos = positions.long()
        lane = torch.arange(B, device=tokens.device)[:, None]
        phys = torch.where(valid, page_tables.long()[lane, (pos // ps).clamp(0, mp - 1)], 0).reshape(B * T)
        offsets = torch.where(valid, pos % ps, 0).reshape(B * T)
        pos_flat = positions.reshape(B * T).contiguous()
        tables = page_tables.repeat_interleave(T, dim=0)  # [B * T, max_pages]: a row reads its lane's pages
        hidden = self.embed[tokens.reshape(B * T).long()].to(c.dtype)

        def attend(q_cat, pool, tables):
            return dispatch_paged_mla_decode_attention(q_cat, pool, tables, pos_flat, c.kv_lora_rank)

        hidden = self._forward(pool, hidden, pos_flat, phys, offsets, tables, attend)
        return self._unembed(hidden).reshape(B, T, -1), kv_cache
