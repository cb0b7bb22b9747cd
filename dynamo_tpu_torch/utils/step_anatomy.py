"""The prefill roofline of one engine dispatch: the port's copy of
``RooflineModel.prefill_floor_bytes`` / ``prefill_floor_seconds`` and
``roofline_for_runner`` from ``dynamo_tpu/utils/step_anatomy.py``, at the
H100 SXM's published peaks (NVIDIA data sheet, dense, at the 700 W limit):
3.35e12 B/s of HBM and 989e12 bf16 FLOP/s. The rest of that module (the
decode floor, step records and the anatomy plane) waits for the engine's
observability planes (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12


@dataclass
class RooflineModel:
    """Floor arithmetic of one prefill dispatch. ``param_bytes``: every
    dispatch reads the parameters once; ``page_bytes``: one allocator page
    across all layers, K and V, at the cache's storage dtype;
    ``param_count``: the FLOP side is ~2 FLOP a parameter a row."""

    param_bytes: int
    page_bytes: int
    page_size: int
    hbm_bw: float = HBM_BYTES_S
    param_count: int = 0
    peak_flops: float = BF16_FLOPS_S

    def prefill_floor_bytes(self, rows: int) -> int:
        """One weight read plus the KV pages the chunk's rows fill (the
        context re-reads of attention are not priced: the floor stays a
        floor)."""
        pages = -(-max(0, rows) // max(1, self.page_size))
        return self.param_bytes + pages * self.page_bytes

    def prefill_floor_seconds(self, rows: int) -> float:
        """max(FLOP bound, bytes bound) of a dispatch computing ``rows``
        prompt rows."""
        bytes_s = self.prefill_floor_bytes(rows) / max(1.0, self.hbm_bw)
        flops_s = 2.0 * self.param_count * max(0, rows) / max(1.0, self.peak_flops)
        return max(bytes_s, flops_s)


def roofline_for_runner(runner, config) -> RooflineModel | None:
    """The estimator of a live ``ModelRunner``: parameter bytes and count
    from the model's parameters, page bytes from ``model.kv_page_bytes``.
    None when the model cannot price its pages."""
    model = getattr(runner, "model", None)
    if model is None or not hasattr(model, "kv_page_bytes"):
        return None
    params = list(model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    page_bytes = int(model.kv_page_bytes(config.page_size))
    if param_bytes <= 0 or page_bytes <= 0:
        return None
    return RooflineModel(
        param_bytes=param_bytes, page_bytes=page_bytes, page_size=config.page_size,
        param_count=sum(p.numel() for p in params),
    )
