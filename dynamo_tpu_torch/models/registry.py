"""Model registry: model_id -> model (port of ``dynamo_tpu/models/registry.py``,
the ``tiny`` / ``tiny:<json-overrides>`` and ``tiny-mla`` /
``tiny-mla:<json-overrides>`` paths).

A ``tiny:{json}`` id builds a Llama model, a ``tiny-mla:{json}`` id a
DeepSeek (MLA + MoE) model, with random weights from a seeded
``torch.Generator`` on the target device, at the reference's per-tensor
scales (``LlamaModel._init_raw_params``, ``DeepseekModel._attn_params`` /
``_init_raw_params``): normal(0, 1) / sqrt(fan) with the same fan axis,
norms at 1, the DeepSeek router in f32. The numbers differ from JAX's (another random
stream); tests that compare the two packages copy JAX's weights across with
``models/convert.py`` instead. ``kv_cache_dtype="int8"`` sets a Llama
config's KV cache to int8 pages (``quant/kv.py``); the DeepSeek latent cache
takes none and raises, as in the reference. Checkpoint directories are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from dynamo_tpu_torch.models.deepseek import DeepseekConfig, DeepseekModel
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.utils import get_logger

log = get_logger("models.registry")


_FAMILIES = ("tiny", "tiny-mla")


def _family(model_id) -> str | None:
    if model_id is None:
        return "tiny"
    s = str(model_id)
    for fam in _FAMILIES:
        if s == fam or s.startswith(fam + ":"):
            return fam
    return None


def is_tiny_family(model_id) -> bool:
    return _family(model_id) is not None


def config_for(model_id) -> LlamaConfig | DeepseekConfig:
    overrides = {}
    if model_id and ":" in str(model_id):
        overrides = json.loads(str(model_id).split(":", 1)[1])
    if _family(model_id) == "tiny-mla":
        return DeepseekConfig.tiny_mla(**overrides)
    return LlamaConfig.tiny(**overrides)


def _dense_init(gen: torch.Generator):
    """``dense_(w, fan)``: w <- normal(0, 1) / sqrt(fan), drawn in f32 one
    tensor at a time (no f32 copy of the whole model)."""

    def dense_(w: torch.Tensor, fan: int) -> None:
        noise = torch.randn(w.shape, generator=gen, dtype=torch.float32, device=w.device)
        w.copy_(noise.mul_(1.0 / (fan**0.5)))

    return dense_


@torch.no_grad()
def init_random_(model, seed: int = 0):
    """Fill ``model``'s weights in place from a seeded generator on the
    model's device."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    if isinstance(model, DeepseekModel):
        return _init_deepseek_(model, _dense_init(gen))
    c = model.config
    dense_ = _dense_init(gen)
    D, F, L = c.hidden_size, c.intermediate_size, c.num_layers
    dense_(model.embed, D)
    for lp in model.layers:
        lp.input_norm.fill_(1.0)
        lp.post_norm.fill_(1.0)
        dense_(lp.wq, D)
        dense_(lp.wk, D)
        dense_(lp.wv, D)
        dense_(lp.wo, c.num_heads * c.head_dim)
        dense_(lp.gate, D)
        dense_(lp.up, D)
        dense_(lp.down, F)
        if c.attention_bias:
            # the reference's [L, out] bias leaves scale by their axis 0 (L)
            dense_(lp.bq, L)
            dense_(lp.bk, L)
            dense_(lp.bv, L)
    model.final_norm.fill_(1.0)
    if not c.tie_word_embeddings:
        dense_(model.lm_head, D)
    return model


def _init_deepseek_(model: DeepseekModel, dense_) -> DeepseekModel:
    """The reference's DeepSeek scales: each weight over the fan of its
    reference scale axis (for [E, in, out] expert banks, ``in``)."""
    c = model.config
    D, F, H = c.hidden_size, c.intermediate_size, c.num_heads
    dc, dv = c.kv_lora_rank, c.v_head_dim
    Fm, Fs = c.moe_intermediate_size, c.n_shared_experts * c.moe_intermediate_size
    dense_(model.embed, D)
    for lp in model.layers():
        for norm in ("input_norm", "kv_norm", "post_norm", "q_norm"):
            if hasattr(lp, norm):
                getattr(lp, norm).fill_(1.0)
        dense_(lp.w_dkv, D)
        dense_(lp.w_kb, dc)
        dense_(lp.w_vb, dc)
        dense_(lp.wo, H * dv)
        if c.q_lora_rank:
            dense_(lp.w_dq, D)
            dense_(lp.w_uq, c.q_lora_rank)
        else:
            dense_(lp.w_q, D)
        if lp.moe:
            dense_(lp.router, D)
            dense_(lp.w_gate, D)
            dense_(lp.w_up, D)
            dense_(lp.w_down, Fm)
            dense_(lp.shared_gate, D)
            dense_(lp.shared_up, D)
            dense_(lp.shared_down, Fs)
        else:
            dense_(lp.gate, D)
            dense_(lp.up, D)
            dense_(lp.down, F)
    model.final_norm.fill_(1.0)
    dense_(model.lm_head, D)
    return model


def load_model(model_id: str, seed: int = 0, device="cuda",
               kv_cache_dtype: str | None = None) -> LlamaModel | DeepseekModel:
    """Build the model for ``model_id`` on ``device`` with seeded random
    weights. ``kv_cache_dtype`` ("int8"; "bf16" means None, the model dtype)
    sets the KV cache storage on a Llama config and raises ValueError for a
    config without one (DeepSeek's latent cache). Raises for ids other than
    the tiny families."""
    if not is_tiny_family(model_id):
        raise ValueError(f"unknown model id {model_id!r} (only 'tiny[:{{json}}]' and "
                         "'tiny-mla[:{{json}}]' are ported)")
    if kv_cache_dtype == "bf16":
        kv_cache_dtype = None  # the default storage dtype, spelled out
    cfg = config_for(model_id)
    model_cls = DeepseekModel if isinstance(cfg, DeepseekConfig) else LlamaModel
    if kv_cache_dtype:
        if not getattr(model_cls, "SUPPORTS_KV_INT8", False):
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r} is not supported by "
                             f"{model_cls.__name__} (the MLA latent cache is its own "
                             "compression; int8 KV covers the k/v page-pool families)")
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    model = model_cls(cfg, device=torch.device(device))
    init_random_(model, seed)
    log.info("built %s on %s (%d layers, seed %d)", model_id, device, cfg.num_layers, seed)
    return model
