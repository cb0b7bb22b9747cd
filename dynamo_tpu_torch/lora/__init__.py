"""Multi-LoRA serving: M fine-tunes of one base model from one engine (port
of ``dynamo_tpu/lora/``).

Punica / S-LoRA style: every adapter's A/B planes live in one device pool
(slot 0 the zero adapter, so base-only lanes ride the same pass), and a
mixed-adapter batch applies ``y += scale * (x @ A[id]) @ B[id]`` per module
in one pass with no per-adapter matmuls and no branch. The port's pool is
slot-concatenated (``lora/store.py``): the delta is two matmuls a module
group over all slots, the other slots' columns zeroed per row
(``models/llama.py lora_delta``), never a per-token gather. Salting the
chained block hash with the adapter's stable uid (``llm/tokens.py``) keeps
adapter prefixes apart locally, in the router's radix view and over the
fleet pull.
"""

from dynamo_tpu_torch.lora.adapter import (
    LORA_MODULES,
    load_adapter,
    lora_uid,
    merge_adapter_into_params,
    module_dims,
    parse_adapter_specs,
    synth_adapter,
)
from dynamo_tpu_torch.lora.store import LoraPool, LoraStore, init_lora_pool

__all__ = [
    "LORA_MODULES",
    "LoraPool",
    "LoraStore",
    "init_lora_pool",
    "load_adapter",
    "lora_uid",
    "merge_adapter_into_params",
    "module_dims",
    "parse_adapter_specs",
    "synth_adapter",
]
