"""LoRA adapter sources: spec parsing, host-weight loading, identity salts
(port of ``dynamo_tpu/lora/adapter.py``).

An adapter is a per-target-module pair ``A [L, in, r]`` / ``B [L, r, out]``
(layer-stacked numpy f32, the reference's host tree) plus a scalar
``scale = lora_alpha / r``. Two source kinds:

  - ``random:<seed>``: a synthetic adapter at the engine's pool rank, drawn
    from numpy's ``default_rng`` exactly as the reference draws it, so both
    packages build the same arrays from the same seed
  - a directory with ``adapter_config.json`` (``{"r", "lora_alpha",
    "target_modules"}``) and ``adapter_model.npz`` holding ``{module}.a`` /
    ``{module}.b`` arrays, the reference's serving format

An adapter with r below the pool rank zero-pads (A gains zero columns, B
zero rows: the product is exact); r above the pool rank is a config error.

``lora_uid`` is the adapter's identity salt, computed with the port's own
XXH3-64 (``llm/_xxh3.py``), bit-equal to the reference's ``xxhash`` value:
it salts every block hash, so a mixed fleet of port and reference workers
must agree on it.

``LORA_GROUPS`` is the port's own: the modules whose A planes share one
input (q / k / v read the normed hidden, gate / up the post-attention
norm), so the device pool keeps each group's A planes side by side and
shrinks them in one matmul (``lora/store.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from dynamo_tpu_torch.llm import _xxh3
from dynamo_tpu_torch.llm.tokens import XXH3_SEED

#: target modules of the llama-family layer (q/k/v/o + the gated MLP); an
#: adapter may cover any subset: missing modules stay zero in the pool
LORA_MODULES = ("wq", "wk", "wv", "wo", "gate", "up", "down")

#: shrink groups: (name, modules reading the same input), in layer order
LORA_GROUPS = (("qkv", ("wq", "wk", "wv")), ("wo", ("wo",)), ("gu", ("gate", "up")), ("down", ("down",)))


def lora_uid(name: str) -> int:
    """Stable nonzero identity salt for an adapter NAME (not its slot: slots
    are per worker, but the salt must agree across the fleet so a peer
    holding the same adapter's prefix serves the same chained hashes)."""
    return _xxh3.xxh3_64(("lora:" + name).encode(), XXH3_SEED) | 1


def module_dims(model_config) -> dict[str, tuple[int, int]]:
    """(in, out) of each target module's base matmul."""
    c = model_config
    D, F = c.hidden_size, c.intermediate_size
    qkv_out = c.num_heads * c.head_dim
    kv_out = c.num_kv_heads * c.head_dim
    return {
        "wq": (D, qkv_out),
        "wk": (D, kv_out),
        "wv": (D, kv_out),
        "wo": (qkv_out, D),
        "gate": (D, F),
        "up": (D, F),
        "down": (F, D),
    }


def parse_adapter_specs(specs) -> dict[str, str]:
    """``("a1", "a2=/path", "a3=random:7")`` -> {name: source} (order kept).

    A bare name is a deterministic synthetic adapter seeded from the name.
    Names must be filesystem- and URL-safe (they become OpenAI model
    suffixes ``base:adapter``)."""
    out: dict[str, str] = {}
    for spec in specs or ():
        spec = str(spec).strip()
        if not spec:
            continue
        name, _, source = spec.partition("=")
        name = name.strip()
        if not name or not all(ch.isalnum() or ch in "._-" for ch in name):
            raise ValueError(f"invalid LoRA adapter name {name!r}")
        if name in out:
            raise ValueError(f"duplicate LoRA adapter name {name!r}")
        out[name] = source.strip() or f"random:{lora_uid(name) % 100000}"
    return out


def synth_adapter(model_config, rank: int, seed: int, modules=LORA_MODULES) -> tuple[dict, float]:
    """Deterministic random adapter at the pool rank. B is non-zero (a
    trained adapter's shape, not an init) but scaled small, so the delta
    perturbs rather than swamps the base logits."""
    rng = np.random.default_rng(int(seed))
    L = model_config.num_layers
    dims = module_dims(model_config)
    tree = {}
    for m in LORA_MODULES:
        din, dout = dims[m]
        if m in modules:
            a = (rng.standard_normal((L, din, rank)) / np.sqrt(din)).astype(np.float32)
            b = (rng.standard_normal((L, rank, dout)) * 0.05).astype(np.float32)
        else:
            a = np.zeros((L, din, rank), np.float32)
            b = np.zeros((L, rank, dout), np.float32)
        tree[m] = {"a": a, "b": b}
    return tree, 1.0


def load_adapter(source: str, model_config, rank: int) -> tuple[dict, float]:
    """Resolve a source spec to (host tree at the POOL rank, scale)."""
    if source.startswith("random:"):
        return synth_adapter(model_config, rank, int(source.split(":", 1)[1]))
    return _load_adapter_dir(Path(source), model_config, rank)


def _pad_rank(a: np.ndarray, b: np.ndarray, rank: int) -> tuple[np.ndarray, np.ndarray]:
    r = a.shape[-1]
    if r > rank:
        raise ValueError(f"adapter rank {r} exceeds pool lora_rank {rank}")
    if r < rank:
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (rank - r,), a.dtype)], axis=-1)
        b = np.concatenate([b, np.zeros((b.shape[0], rank - r, b.shape[2]), b.dtype)], axis=1)
    return a, b


def _load_adapter_dir(path: Path, model_config, rank: int) -> tuple[dict, float]:
    cfg = json.loads((path / "adapter_config.json").read_text())
    r = int(cfg.get("r", rank))
    alpha = float(cfg.get("lora_alpha", r))
    targets = set(cfg.get("target_modules") or LORA_MODULES)
    data = np.load(path / "adapter_model.npz")
    dims = module_dims(model_config)
    L = model_config.num_layers
    tree = {}
    for m in LORA_MODULES:
        din, dout = dims[m]
        if m in targets and f"{m}.a" in data:
            a = np.asarray(data[f"{m}.a"], np.float32)
            b = np.asarray(data[f"{m}.b"], np.float32)
            if a.shape != (L, din, r) or b.shape != (L, r, dout):
                raise ValueError(
                    f"adapter {path} module {m}: got A{a.shape} B{b.shape}, want A{(L, din, r)} B{(L, r, dout)}"
                )
            a, b = _pad_rank(a, b, rank)
        else:
            a = np.zeros((L, din, rank), np.float32)
            b = np.zeros((L, rank, dout), np.float32)
        tree[m] = {"a": a, "b": b}
    return tree, alpha / max(1, r)


def merge_adapter_into_params(model, tree: dict, scale: float) -> dict:
    """The merged weights ``W' = W + scale * A @ B`` of a full-precision port
    ``LlamaModel`` (the merged-weight arm the LoRA pass is held to):
    ``{"layers.<i>.<module>": tensor}`` on the model's device, computed in f32
    and cast back to the weight's dtype; load them with
    ``model.load_state_dict(merged, strict=False)``. Quantized weights
    cannot merge exactly (quantize(W + sAB) != quantize(W) + sAB), so int8
    parity is held mixed against alone instead."""
    import torch

    out = {}
    for i, lp in enumerate(model.layers):
        for m, entry in tree.items():
            w = getattr(lp, m)
            if not isinstance(w, torch.Tensor) or w.dtype == torch.int8:
                raise ValueError(f"layers.{i}.{m} is not a full-precision weight")
            a = torch.from_numpy(np.ascontiguousarray(entry["a"][i])).to(w.device, torch.float32)
            b = torch.from_numpy(np.ascontiguousarray(entry["b"][i])).to(w.device, torch.float32)
            out[f"layers.{i}.{m}"] = (w.float() + scale * (a @ b)).to(w.dtype)
    return out
