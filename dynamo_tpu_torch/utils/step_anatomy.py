"""Step anatomy: per-dispatch host/device time attribution with the live
roofline (port of ``dynamo_tpu/utils/step_anatomy.py``).

Every engine dispatch (a decode window, a packed prefill call, a
per-request prefill chunk) records one :class:`StepRecord` into a bounded
ring, decomposed into four phases:

  host_prep    host time building the dispatch (numpy control arrays,
               capacity passes, table refreshes) before the runner call
  dispatch     host time inside the runner call (graph lookup, H2D, the
               replay's or the eager body's launches; the device may already
               be busy underneath)
  device_wait  host time blocked on device results (the reconcile wait the
               dispatch-ahead pipeline exists to hide)
  reconcile    host time materializing results back into scheduler state
               (token emission, stop checks)

The engine loop is single-threaded, so the phases over all kinds sum to the
engine thread's wall; ``host_fraction`` (everything but device_wait, over
the total) is the share of a serving step the host spends not waiting on
the card.

The roofline prices a decode step's bytes-moved floor from live state:
every step reads the parameters once plus each live sequence's KV pages
(``model.kv_page_bytes`` at the cache's storage dtype). A prefill dispatch's
floor is max(FLOP bound, bytes bound): about 2 FLOP a parameter a row at
the bf16 tensor peak against one weight read plus the KV its rows write.
The constants are the H100 SXM's published peaks (NVIDIA data sheet, dense,
at the 700 W limit): 3.35e12 B/s of HBM and 989e12 bf16 FLOP/s.

Not ported yet (ROADMAP Queue 1, item 12): the cost meter (``meter`` stays
None), ``/debug/steps`` and the engine's metric families, which read
``records`` and ``render_metrics``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

#: dispatch kinds (the label vocabulary of dynamo_step_seconds_total{kind=})
KINDS = (
    "decode_window",
    "prefill_packed",
    "prefill_chunk",
    "spec_draft",
    "spec_verify",
    "lora_slot_load",
    "prefix_fetch_scatter",
    "offload_drain",
)

PHASES = ("host_prep", "dispatch", "device_wait", "reconcile")

#: the prefill-regime kinds (the packed path and the per-request chain)
PREFILL_KINDS = ("prefill_packed", "prefill_chunk")

#: ring capacity: a few seconds of recent history at ms-scale steps
DEFAULT_RING = 512

HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12


@dataclass
class RooflineModel:
    """Floor arithmetic of one engine's dispatches. ``param_bytes``: every
    dispatch reads the parameters once; ``page_bytes``: one allocator page
    across all layers, K and V, at the cache's storage dtype;
    ``param_count``: the FLOP side is ~2 FLOP a parameter a row."""

    param_bytes: int
    page_bytes: int
    page_size: int
    hbm_bw: float = HBM_BYTES_S
    param_count: int = 0
    peak_flops: float = BF16_FLOPS_S

    def step_floor_bytes(self, live_pages: int) -> int:
        """Bytes one decode step must move: the weights plus the live KV
        pages the batch's attention reads."""
        return self.param_bytes + live_pages * self.page_bytes

    def step_floor_seconds(self, live_pages: int) -> float:
        return self.step_floor_bytes(live_pages) / max(1.0, self.hbm_bw)

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

    def to_dict(self) -> dict:
        return {
            "param_bytes": self.param_bytes,
            "page_bytes": self.page_bytes,
            "page_size": self.page_size,
            "hbm_bw_bytes_s": self.hbm_bw,
            "param_count": self.param_count,
            "peak_flops_s": self.peak_flops,
        }


def roofline_for_runner(runner, config) -> RooflineModel | None:
    """The estimator of a live ``ModelRunner``: parameter bytes and count
    from the model's parameters, page bytes from ``model.kv_page_bytes``.
    None when the model cannot price its pages (test fakes)."""
    model = getattr(runner, "model", None)
    if model is None or not hasattr(model, "kv_page_bytes") or not hasattr(model, "parameters"):
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


@dataclass
class StepRecord:
    """One engine dispatch, decomposed. Mutated in place as phases land
    (device_wait and reconcile arrive at the pipelined reconcile, possibly
    several windows after the dispatch)."""

    seq: int  # monotonic record id
    ts: float  # time.monotonic() at dispatch start
    kind: str
    host_prep_s: float = 0.0
    dispatch_s: float = 0.0
    device_wait_s: float = 0.0
    reconcile_s: float = 0.0
    steps: int = 0  # decode steps this dispatch advances
    tokens: int = 0  # tokens scheduled (decode) or rows computed (prefill)
    participants: int = 0
    floor_bytes: int = 0  # bytes-moved floor (decode kinds)
    floor_s: float = 0.0  # max(FLOP, bytes) floor seconds (prefill kinds)
    bill: Optional[list] = None  # cost-attribution rows (the meter is not ported)

    @property
    def total_s(self) -> float:
        return self.host_prep_s + self.dispatch_s + self.device_wait_s + self.reconcile_s

    @property
    def host_s(self) -> float:
        """Host time not blocked on the device."""
        return self.host_prep_s + self.dispatch_s + self.reconcile_s

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts": round(self.ts, 6),
            "kind": self.kind,
            "host_prep_ms": round(self.host_prep_s * 1e3, 4),
            "dispatch_ms": round(self.dispatch_s * 1e3, 4),
            "device_wait_ms": round(self.device_wait_s * 1e3, 4),
            "reconcile_ms": round(self.reconcile_s * 1e3, 4),
            "steps": self.steps,
            "tokens": self.tokens,
            "participants": self.participants,
            "floor_bytes": self.floor_bytes,
            "floor_ms": round(self.floor_s * 1e3, 4),
        }


class StepAnatomy:
    """Bounded ring of StepRecords plus cumulative per-(phase, kind)
    counters. The engine thread is the only writer; the derived views may
    run on other threads, so updates take a lock."""

    def __init__(self, ring_size: int = DEFAULT_RING, roofline: Optional[RooflineModel] = None):
        self._lock = threading.Lock()
        self.ring: deque[StepRecord] = deque(maxlen=ring_size)
        self._seq = 0
        # (phase, kind) -> cumulative seconds; kind -> dispatch count
        self.phase_seconds: dict[tuple[str, str], float] = {}
        self.dispatch_counts: dict[str, int] = {}
        self.steps_total: dict[str, int] = {}
        self.floor_bytes_total = 0
        self._floor_kinds: set[str] = set()
        # prefill floors are seconds (max of two bounds in different units)
        # and accumulate apart from the decode floor bytes
        self.prefill_floor_s_total = 0.0
        self._prefill_floor_kinds: set[str] = set()
        self.roofline = roofline
        self.meter = None  # cost metering: not ported (ROADMAP Queue 1, item 12)

    # ---------------- recording (engine thread) ----------------

    def begin(self, kind: str, ts: Optional[float] = None, bill: Optional[list] = None) -> StepRecord:
        """Open one dispatch record and append it to the ring (it fills in
        place as phases complete)."""
        with self._lock:
            self._seq += 1
            rec = StepRecord(seq=self._seq, ts=ts or time.monotonic(), kind=kind, bill=bill)
            self.ring.append(rec)
            self.dispatch_counts[kind] = self.dispatch_counts.get(kind, 0) + 1
        return rec

    def add_phase(self, rec: Optional[StepRecord], phase: str, dt: float) -> None:
        """Attribute ``dt`` seconds of ``phase`` to a record (None-safe: the
        time still lands in the totals, as a decode window's)."""
        if dt < 0:
            dt = 0.0
        kind = rec.kind if rec is not None else "decode_window"
        with self._lock:
            key = (phase, kind)
            self.phase_seconds[key] = self.phase_seconds.get(key, 0.0) + dt
            if rec is not None:
                setattr(rec, phase + "_s", getattr(rec, phase + "_s") + dt)
        if self.meter is not None and dt > 0:
            self.meter.on_phase(rec, phase, dt)

    def record(self, kind: str, dispatch_s: float, host_prep_s: float = 0.0, device_wait_s: float = 0.0,
               reconcile_s: float = 0.0, steps: int = 0, tokens: int = 0, participants: int = 0,
               floor_bytes: int = 0, ts: Optional[float] = None, bill: Optional[list] = None) -> StepRecord:
        """One-shot record for a synchronous dispatch: all phases known at
        the call site."""
        rec = self.begin(kind, ts=ts, bill=bill)
        for phase, dt in (("host_prep", host_prep_s), ("dispatch", dispatch_s),
                          ("device_wait", device_wait_s), ("reconcile", reconcile_s)):
            if dt:
                self.add_phase(rec, phase, dt)
        self.note_steps(rec, steps=steps, tokens=tokens, participants=participants, floor_bytes=floor_bytes)
        return rec

    def note_steps(self, rec: StepRecord, steps: int = 0, tokens: int = 0, participants: int = 0,
                   floor_bytes: int = 0) -> None:
        with self._lock:
            rec.steps += steps
            rec.tokens += tokens
            rec.participants = max(rec.participants, participants)
            rec.floor_bytes += floor_bytes
            if steps:
                self.steps_total[rec.kind] = self.steps_total.get(rec.kind, 0) + steps
            if floor_bytes:
                self.floor_bytes_total += floor_bytes
                self._floor_kinds.add(rec.kind)

    def decode_floor_bytes(self, live_pages: int, steps: int) -> int:
        """Floor bytes of a K-step decode window at the current occupancy (0
        without a roofline model)."""
        if self.roofline is None:
            return 0
        return self.roofline.step_floor_bytes(live_pages) * max(1, steps)

    def note_prefill_floor(self, rec: Optional[StepRecord], rows: int) -> None:
        """Price one prefill dispatch's max(FLOP, bytes) floor at the
        dispatch site (no-op without a roofline model or rows)."""
        if self.roofline is None or rec is None or rows <= 0:
            return
        floor_s = self.roofline.prefill_floor_seconds(rows)
        with self._lock:
            rec.floor_s += floor_s
            self.prefill_floor_s_total += floor_s
            self._prefill_floor_kinds.add(rec.kind)

    # ---------------- derived views (any thread) ----------------

    def _ring_snapshot(self) -> list[StepRecord]:
        with self._lock:
            return list(self.ring)

    def host_fraction(self, kinds: Optional[tuple] = None) -> Optional[float]:
        """(host_prep + dispatch + reconcile) / total over the cumulative
        counters; None before any data."""
        with self._lock:
            items = list(self.phase_seconds.items())
        host = wait = 0.0
        for (phase, kind), s in items:
            if kinds is not None and kind not in kinds:
                continue
            if phase == "device_wait":
                wait += s
            else:
                host += s
        total = host + wait
        if total <= 0:
            return None
        return host / total

    def roofline_fraction(self) -> Optional[float]:
        """Floor over measured seconds of the priced decode-regime kinds;
        None until a priced dispatch completes."""
        if self.roofline is None:
            return None
        with self._lock:
            floor_bytes = self.floor_bytes_total
            measured = sum(s for (phase, kind), s in self.phase_seconds.items() if kind in self._floor_kinds)
        if floor_bytes <= 0 or measured <= 0:
            return None
        return (floor_bytes / self.roofline.hbm_bw) / measured

    def prefill_roofline_fraction(self) -> Optional[float]:
        """Summed prefill floors over measured prefill engine seconds; None
        until a priced prefill dispatch completes."""
        if self.roofline is None:
            return None
        with self._lock:
            floor_s = self.prefill_floor_s_total
            measured = sum(
                s for (phase, kind), s in self.phase_seconds.items() if kind in self._prefill_floor_kinds
            )
        if floor_s <= 0 or measured <= 0:
            return None
        return floor_s / measured

    def prefill_fixed_ms(self) -> Optional[float]:
        """Mean host-side (host_prep + dispatch) ms per prefill dispatch:
        the live proxy for the per-call fixed cost. None before any prefill
        dispatch."""
        with self._lock:
            host = sum(
                s for (phase, kind), s in self.phase_seconds.items()
                if kind in PREFILL_KINDS and phase in ("host_prep", "dispatch")
            )
            n = sum(self.dispatch_counts.get(k, 0) for k in PREFILL_KINDS)
        if n <= 0:
            return None
        return host / n * 1e3

    def dispatch_gap_ms(self, kind: str = "decode_window", q: float = 0.5) -> Optional[float]:
        """Quantile of the gaps between consecutive same-kind dispatch
        starts in the ring (ms)."""
        ts = [r.ts for r in self._ring_snapshot() if r.kind == kind]
        if len(ts) < 2:
            return None
        gaps = sorted(b - a for a, b in zip(ts, ts[1:]))
        idx = min(len(gaps) - 1, max(0, int(q * (len(gaps) - 1))))
        return gaps[idx] * 1e3

    def records(self, limit: int = 128, kind: Optional[str] = None) -> list[dict]:
        """Most recent records (newest last) as JSON-safe dicts."""
        snap = self._ring_snapshot()
        if kind is not None:
            snap = [r for r in snap if r.kind == kind]
        return [r.to_dict() for r in snap[-max(0, limit):]]

    def snapshot(self) -> dict:
        """Wire-safe summary: per-(phase, kind) seconds, dispatches, the
        fractions and the decode dispatch cadence."""
        with self._lock:
            phase_seconds = {
                f"{phase}.{kind}": round(s, 6) for (phase, kind), s in sorted(self.phase_seconds.items())
            }
            counts = dict(self.dispatch_counts)
            steps = dict(self.steps_total)
            floor_bytes = self.floor_bytes_total
        gap = self.dispatch_gap_ms("decode_window")
        snap = {
            "phase_seconds": phase_seconds,
            "dispatches": counts,
            "steps": steps,
            "host_frac": _round_opt(self.host_fraction()),
            "decode_host_frac": _round_opt(self.host_fraction(kinds=("decode_window",))),
            "roofline_frac": _round_opt(self.roofline_fraction()),
            "prefill_host_frac": _round_opt(self.host_fraction(kinds=PREFILL_KINDS)),
            "prefill_roofline_frac": _round_opt(self.prefill_roofline_fraction()),
            "prefill_fixed_ms": _round_opt(self.prefill_fixed_ms(), 3),
            "dispatch_gap_ms_p50": round(gap, 3) if gap is not None else None,
            "floor_bytes_total": floor_bytes,
            "records": len(self.ring),
        }
        if self.roofline is not None:
            snap["roofline"] = self.roofline.to_dict()
        return snap

    def render_metrics(self) -> str:
        """Prometheus families (the engine's exposition surface, ROADMAP
        Queue 1 item 12, will serve them)."""
        from dynamo_tpu_torch.utils.prometheus import render_family

        with self._lock:
            phase_items = sorted(self.phase_seconds.items())
            counts = sorted(self.dispatch_counts.items())
        parts = [
            render_family(
                "dynamo_step_seconds_total", "counter",
                "engine-thread seconds per step-anatomy phase and dispatch kind (host_prep/dispatch/reconcile = "
                "host overhead; device_wait = host blocked on the device)",
                [({"kind": kind, "phase": phase}, round(s, 6)) for (phase, kind), s in phase_items]
                or [({"kind": "decode_window", "phase": "dispatch"}, 0)],
            ),
            render_family(
                "dynamo_step_dispatch_total", "counter", "engine dispatches by step-anatomy kind",
                [({"kind": k}, n) for k, n in counts] or [({"kind": "decode_window"}, 0)],
            ),
        ]
        frac = self.roofline_fraction()
        if frac is not None:
            parts.append(render_family(
                "dynamo_engine_roofline_fraction", "gauge",
                "HBM bytes-moved floor over measured decode-window engine seconds (1.0 = at the roofline)",
                [({}, round(frac, 4))],
            ))
        pfrac = self.prefill_roofline_fraction()
        if pfrac is not None:
            parts.append(render_family(
                "dynamo_engine_prefill_roofline_fraction", "gauge",
                "summed max(FLOP, HBM-bytes) prefill dispatch floors over measured prefill engine seconds",
                [({}, round(pfrac, 4))],
            ))
        host = self.host_fraction()
        if host is not None:
            parts.append(render_family(
                "dynamo_step_host_fraction", "gauge",
                "host-side share of attributed engine time (1 - device_wait share)",
                [({}, round(host, 4))],
            ))
        return "".join(parts)


def _round_opt(v: Optional[float], nd: int = 4) -> Optional[float]:
    return round(v, nd) if v is not None else None
