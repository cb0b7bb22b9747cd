"""Carry weights and KV state from the JAX package's layouts to the port's.

Both functions take numpy arrays (``np.asarray`` of the JAX leaves), so this
module needs no JAX.

  - :func:`params_from_jax`: the reference params pytree ``{"embed",
    "layers": {name: [L, ...]}, "final_norm"[, "lm_head"]}`` -> a state dict
    for :class:`LlamaModel`. The port keeps JAX's ``[in, out]`` weight
    layout, so leaves are split per layer and copied, never transposed. An
    int8 weight-only leaf (the reference's ``QuantizedLinear``: numpy ``q``
    int8 and ``s`` f32) becomes ``<name>.q`` / ``<name>.s``, codes and
    scales copied exactly, for a model whose ``quantize_()`` ran first.
  - :func:`kv_from_jax`: a reference pool ``[L*P, ps, Hkv*D]`` (folded, the
    JAX layout when head_dim % 128 != 0; row-major fold) or ``[L*P, ps, Hkv,
    D]`` -> the port's unfolded ``[L*P, ps, Hkv, D]``; a reference int8
    ``QuantizedPages`` (numpy ``q`` / ``s`` leaves) -> the port's
    ``QuantizedPages``, codes and scales copied bit for bit.
  - :func:`deepseek_params_from_jax`: the reference DeepSeek tree ``{"embed",
    "dense_layers": {name: [Ld, ...]}, "moe_layers": {name: [Lm, ...]},
    "final_norm", "lm_head"}`` -> a state dict for :class:`DeepseekModel`
    (either query path: ``w_q``, or ``w_dq``/``q_norm``/``w_uq``).
  - :func:`ckv_from_jax`: the reference latent pool ``[L*P, ps,
    latent_dim_padded]`` -> the port's ``[L*P, ps, latent_dim]`` (the TPU
    lane pad columns dropped).
  - :func:`lora_pool_from_jax`: the reference's LoRA pool ``{"scales": [S],
    "mods": {module: {"a": [L, S, in, r], "b": [L, S, r, out]}}}`` -> the
    port's slot-concatenated :class:`~dynamo_tpu_torch.lora.store.LoraPool`
    (values copied, f32).
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.models.deepseek import DeepseekConfig, DeepseekModel
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.quant.kv import QuantizedPages

_LAYER_LEAVES = ("input_norm", "wq", "wk", "wv", "wo", "post_norm", "gate", "up", "down")
_BIAS_LEAVES = ("bq", "bk", "bv")


def _flat_leaves(group: dict) -> dict:
    """{name: stacked array}; a quantized leaf (the reference's
    ``QuantizedLinear``, duck-typed: this module imports nothing of the JAX
    package) as ``name.q`` and ``name.s``."""
    out = {}
    for name, leaf in group.items():
        if hasattr(leaf, "q") and hasattr(leaf, "s"):
            out[name + ".q"], out[name + ".s"] = np.asarray(leaf.q), np.asarray(leaf.s)
        else:
            out[name] = np.asarray(leaf)
    return out


def _tensor(name: str, a, dtype) -> torch.Tensor:
    """The leaf ``name`` as a torch tensor: int8 codes and f32 scales
    (``.s``) exactly, anything else through f32 to ``dtype``."""
    a = np.asarray(a)
    if a.dtype == np.int8 or name.endswith(".s"):
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def params_from_jax(np_tree: dict, config: LlamaConfig) -> dict[str, torch.Tensor]:
    """JAX params (numpy leaves) -> ``LlamaModel.load_state_dict`` input."""
    sd = {name: _tensor(name, np_tree[name], config.dtype) for name in ("embed", "final_norm")}
    layers = _flat_leaves(np_tree["layers"])
    names = _LAYER_LEAVES + (_BIAS_LEAVES if config.attention_bias else ())
    for name in names:
        for part in [name] if name in layers else [name + ".q", name + ".s"]:
            stacked = layers[part]
            if stacked.shape[0] != config.num_layers:
                raise ValueError(f"layers.{part} has {stacked.shape[0]} layers, config {config.num_layers}")
            for i in range(config.num_layers):
                sd[f"layers.{i}.{part}"] = _tensor(part, stacked[i], config.dtype)
    if not config.tie_word_embeddings:
        sd["lm_head"] = _tensor("lm_head", np_tree["lm_head"], config.dtype)
    return sd


def _unfold(pool: np.ndarray, config: LlamaConfig) -> np.ndarray:
    Hkv, D = config.num_kv_heads, config.head_dim
    if pool.ndim == 3:
        if pool.shape[2] != Hkv * D:
            raise ValueError(f"folded pool lane dim {pool.shape[2]} != Hkv*D {Hkv * D}")
        return pool.reshape(pool.shape[0], pool.shape[1], Hkv, D)
    if pool.ndim != 4 or pool.shape[2:] != (Hkv, D):
        raise ValueError(f"unexpected pool shape {pool.shape}")
    return pool


def kv_from_jax(np_pool, config: LlamaConfig):
    """One reference flat pool (``kv["k"]`` or ``kv["v"]``) -> unfolded, in
    ``config.dtype``; a reference ``QuantizedPages`` (anything with ``q`` and
    ``s`` leaves) -> the port's, int8 codes and f32 scales unchanged."""
    if hasattr(np_pool, "q") and hasattr(np_pool, "s"):
        q = np.array(np_pool.q)
        s = np.array(np_pool.s, dtype=np.float32)
        if q.dtype != np.int8 or s.shape != q.shape[:2]:
            raise ValueError(f"expected int8 q and f32 s [P, ps]; got {q.dtype} {q.shape}, {s.shape}")
        q = np.ascontiguousarray(_unfold(q, config))
        return QuantizedPages(torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(s)))
    pool = np.array(np_pool, dtype=np.float32)  # a writable copy
    return torch.from_numpy(np.ascontiguousarray(_unfold(pool, config))).to(config.dtype)


def deepseek_params_from_jax(np_tree: dict, config: DeepseekConfig) -> dict[str, torch.Tensor]:
    """JAX DeepSeek params (numpy leaves) -> ``DeepseekModel.load_state_dict``
    input. Raises ValueError when a group's leaves, layer counts or shapes do
    not match ``config``."""
    # the port's own parameter names, shapes and dtypes, without allocating
    want = DeepseekModel(config, device="meta").quantize_().state_dict()
    sd = {name: np.asarray(np_tree[name]) for name in ("embed", "final_norm", "lm_head")}
    Ld = config.first_k_dense_replace
    for group, n_layers in (("dense_layers", Ld), ("moe_layers", config.num_layers - Ld)):
        leaves = _flat_leaves(np_tree.get(group, {})) if n_layers else {}
        names = {k.split(".", 2)[2] for k in want if k.startswith(group + ".")}
        if set(leaves) != names:
            raise ValueError(f"{group} has leaves {sorted(leaves)}, config wants {sorted(names)}")
        for name in names:
            stacked = np.asarray(leaves[name])
            if stacked.shape[0] != n_layers:
                raise ValueError(f"{group}.{name} has {stacked.shape[0]} layers, config {n_layers}")
            for i in range(n_layers):
                sd[f"{group}.{i}.{name}"] = stacked[i]
    out = {}
    for key, ref in want.items():
        arr = sd[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key} has shape {tuple(arr.shape)}, config wants {tuple(ref.shape)}")
        out[key] = _tensor(key, arr, ref.dtype)
    return out


def ckv_from_jax(np_pool, config: DeepseekConfig) -> torch.Tensor:
    """The reference latent pool ``kv["ckv"]`` -> the port's unpadded pool."""
    pool = np.asarray(np_pool, dtype=np.float32)
    latent = config.latent_dim
    padded = -(-latent // 128) * 128  # the reference's latent_dim_padded
    if pool.ndim != 3 or pool.shape[2] not in (latent, padded):
        raise ValueError(f"latent pool {pool.shape}: want [L*P, ps, {latent} or {padded}]")
    return torch.from_numpy(np.ascontiguousarray(pool[:, :, :latent])).to(config.dtype)


def lora_pool_from_jax(np_pool: dict, device="cpu"):
    """The reference's stacked LoRA pool (numpy leaves) -> the port's
    ``LoraPool`` on ``device``: module m's A planes go to its group's
    columns ``(j * S + s) * r``, its B planes to rows ``s * r``."""
    from dynamo_tpu_torch.lora.adapter import LORA_GROUPS
    from dynamo_tpu_torch.lora.store import LoraPool

    mods = np_pool["mods"]
    scales = np.asarray(np_pool["scales"], np.float32)
    L, S, _, r = np.asarray(mods["wq"]["a"]).shape
    if S != scales.shape[0]:
        raise ValueError(f"pool has {S} slots, scales {scales.shape[0]}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    a = {}
    for group, names in LORA_GROUPS:
        # [L, S, in, r] -> [L, in, S * r] per module, side by side
        a[group] = t(np.concatenate(
            [np.asarray(mods[m]["a"]).transpose(0, 2, 1, 3).reshape(L, -1, S * r) for m in names], axis=2))
    b = {m: t(np.asarray(mods[m]["b"]).reshape(L, S * r, -1)) for _, names in LORA_GROUPS for m in names}
    return LoraPool(a=a, b=b, scales=t(scales), rank=int(r))
