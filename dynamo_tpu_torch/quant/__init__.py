"""Quantization for the serving hot path (port of ``dynamo_tpu/quant``): the
int8 KV cache (``quant/kv.py``). Int8 weights (``quant/int8.py``) are not
ported yet."""

from dynamo_tpu_torch.quant.kv import (
    KV_CACHE_DTYPES,
    QuantizedPages,
    dequantize_rows,
    init_quantized_pages,
    kv_page_bytes,
    pages_for_hbm_budget,
    quantize_kv_rows,
)

__all__ = [
    "KV_CACHE_DTYPES",
    "QuantizedPages",
    "dequantize_rows",
    "init_quantized_pages",
    "kv_page_bytes",
    "pages_for_hbm_budget",
    "quantize_kv_rows",
]
