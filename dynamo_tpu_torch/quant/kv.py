"""Int8 KV cache: per-(page, token row) symmetric scales (port of
``dynamo_tpu/quant/kv.py``).

An int8 pool stores each token row (all kv heads of one token) as int8
values with one f32 scale, ``absmax(row) / 127``, in a ``[pages, page_size]``
scale plane beside the ``[pages, page_size, Hkv, D]`` int8 pool. A per-row
scale keeps quantization incremental (a decode append never requantizes its
page), and it factors out of the attention algebra exactly:
``q . (s_j k_j) = s_j (q . k_j)`` scales a score column and ``sum_j p_j (s_j
v_j) = sum_j (p_j s_j) v_j`` a probability column, which is how the kernels
apply it after reading the int8 rows. The pool bytes per token drop to
about half of bf16's (``kv_page_bytes``).

:class:`QuantizedPages` stands where the plain pool stood and proxies
``shape`` / ``dtype`` / ``ndim`` / ``device`` to the int8 pool, so geometry
probes (``k_pool.shape[1]``) keep working. The reference's numpy wire helpers
(host offload, disaggregation) wait for the KV tiers.
"""

from __future__ import annotations

import torch

#: EngineConfig.kv_cache_dtype values (None means bf16, the model dtype)
KV_CACHE_DTYPES = ("bf16", "int8")

_INT8_MAX = 127.0


class QuantizedPages:
    """One int8 KV page pool and its per-row f32 scale plane.

    q: int8 ``[pages, page_size, Hkv, D]``
    s: float32 ``[pages, page_size]``, one scale per token row
    """

    __slots__ = ("q", "s")

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        self.q = q
        self.s = s

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def device(self):
        return self.q.device

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"QuantizedPages(q={tuple(self.q.shape)}, s={tuple(self.s.shape)})"


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[T, ...]`` fresh K or V rows -> (int8 rows, f32 per-row scales [T]).

    Symmetric per-row absmax over every non-leading axis; the 1e-12 floor
    keeps an all-zero row (padding) dividing cleanly to zeros. Rounds half to
    even, as the reference's ``jnp.round``."""
    x32 = x.float()
    # max |x| per row in one reduction (the infinity norm)
    absmax = torch.linalg.vector_norm(x32, ord=float("inf"), dim=tuple(range(1, x32.ndim)))  # [T]
    scale = absmax.clamp(min=1e-12) / _INT8_MAX
    bshape = (x32.shape[0],) + (1,) * (x32.ndim - 1)
    q = torch.round(x32 / scale.reshape(bshape)).clamp_(-_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, s: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows` over any leading batch of rows:
    ``s`` broadcasts from the leading axes."""
    s_b = s.float().reshape(*s.shape, *(1,) * (q.ndim - s.ndim))
    return (q.float() * s_b).to(dtype)


def init_quantized_pages(shape: tuple[int, ...], device=None) -> QuantizedPages:
    """Zeroed int8 pool and zeroed scale plane for a ``kv_cache_shape``."""
    return QuantizedPages(
        q=torch.zeros(shape, dtype=torch.int8, device=device),
        s=torch.zeros(tuple(shape[:2]), dtype=torch.float32, device=device),
    )


def kv_page_bytes(page_size: int, num_kv_heads: int, head_dim: int, num_layers: int,
                  kv_cache_dtype: str | None, itemsize: int = 2) -> int:
    """Device bytes ONE allocator page costs across all layers (K and V, the
    int8 scale planes included). ``itemsize`` is the full-precision element
    size (2 for bf16 serving, 4 for f32 test models)."""
    row_vals = num_kv_heads * head_dim
    if kv_cache_dtype == "int8":
        per_row = row_vals + 4  # int8 values + one f32 scale
    else:
        per_row = row_vals * itemsize
    return 2 * num_layers * page_size * per_row  # x2: K and V


def pages_for_hbm_budget(budget_bytes: int, page_size: int, num_kv_heads: int, head_dim: int,
                         num_layers: int, kv_cache_dtype: str | None, itemsize: int = 2) -> int:
    """How many KV pages fit a device-memory budget at a cache dtype (page 0
    is the allocator's trash page, so one fewer is usable)."""
    return budget_bytes // max(
        1, kv_page_bytes(page_size, num_kv_heads, head_dim, num_layers, kv_cache_dtype, itemsize)
    )
