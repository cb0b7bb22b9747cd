"""Device-resident adapter slot pool with LRU eviction and async host loads
(port of ``dynamo_tpu/lora/store.py``).

The pool (:class:`LoraPool`, ``init_lora_pool``) holds ``S = max_loras + 1``
slots, f32 (so the delta is exact against a merged-weight f32 reference),
slot 0 the reserved ZERO adapter: base-only lanes take it like any other id,
with no branch in a step body. Its layout is the port's own, slot-
concatenated, so a mixed batch computes the delta with two matmuls a
module group and no per-token gather (``models/llama.py lora_delta``):

  - ``a[group]``: ``[L, in, n * S * r]``, the group's n modules' A planes
    side by side (``LORA_GROUPS``), module j's slot s in columns
    ``(j * S + s) * r`` to ``+ r``
  - ``b[module]``: ``[L, S * r, out]``, slot s in rows ``s * r`` to ``+ r``
  - ``scales``: ``[S]``

(the reference's pool is ``[L, S, in, r]`` / ``[L, S, r, out]`` per module;
``models/convert.py lora_pool_from_jax`` maps it here). A slot load writes
these tensors in place (``ModelRunner.load_lora_slot``): captured CUDA
graphs read their addresses.

The store (engine-thread owner) maps adapter names to slots, as the
reference's does:

  - ``acquire`` on a resident adapter pins its slot (refcounted: a slot is
    never swapped under an in-flight sequence)
  - a non-resident adapter starts an ASYNC host load (one side thread) and
    returns None: the scheduler keeps the request waiting and serves
    everyone else; once the host weights are ready, the next acquire writes
    them into a free (or the least recently used unpinned) slot
  - eviction drops only the DEVICE slot; host weights stay cached (staged
    once on the load thread: pinned host tensors for a runner on the card),
    so a hot-swap back in costs one slot load's copies, not a reload
  - a load that failed fails every later acquire of that adapter
"""

from __future__ import annotations

import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import torch

from dynamo_tpu_torch.lora.adapter import LORA_GROUPS, LORA_MODULES, load_adapter, module_dims, parse_adapter_specs
from dynamo_tpu_torch.utils import get_logger, tracing

log = get_logger("lora.store")


@dataclass
class LoraPool:
    """The device pool (layout above): ``a`` {group: [L, in, n*S*r]}, ``b``
    {module: [L, S*r, out]}, ``scales`` [S], at rank ``rank``."""

    a: dict
    b: dict
    scales: torch.Tensor
    rank: int

    @property
    def slots(self) -> int:
        return self.scales.shape[0]

    def a_columns(self, module: str, slot: int) -> tuple[str, slice]:
        """(group, column slice) of ``module``'s slot ``slot`` in its group's
        A plane."""
        for group, mods in LORA_GROUPS:
            if module in mods:
                start = (mods.index(module) * self.slots + slot) * self.rank
                return group, slice(start, start + self.rank)
        raise KeyError(module)

    def b_rows(self, slot: int) -> slice:
        return slice(slot * self.rank, (slot + 1) * self.rank)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (*self.a.values(), *self.b.values(), self.scales))


def init_lora_pool(model, max_loras: int, rank: int, device=None) -> LoraPool:
    """Zeros for the pool of ``model`` (its config's widths and depth) with
    ``max_loras`` adapter slots plus the zero slot, on ``device`` (the
    model's by default)."""
    c = model.config
    device = model.device if device is None else device
    S = max_loras + 1
    dims = module_dims(c)
    L = c.num_layers
    a = {
        group: torch.zeros((L, dims[mods[0]][0], len(mods) * S * rank), dtype=torch.float32, device=device)
        for group, mods in LORA_GROUPS
    }
    b = {m: torch.zeros((L, S * rank, dims[m][1]), dtype=torch.float32, device=device) for m in LORA_MODULES}
    return LoraPool(a=a, b=b, scales=torch.zeros(S, dtype=torch.float32, device=device), rank=rank)


class LoraStore:
    """Adapter name -> device slot bookkeeping (engine thread only, except
    the host-load worker, which touches nothing but the load futures)."""

    def __init__(self, config, model, load_slot_fn, stage_fn):
        self.max_loras = config.max_loras
        self.rank = config.lora_rank
        self.sources = parse_adapter_specs(config.lora_adapters)
        self.model_config = model.config
        self._load_slot = load_slot_fn  # (slot, host_tree, scale) -> device write
        self._stage = stage_fn  # host tree -> the tree slot loads copy from (load thread)
        self.slot_of: dict[str, int] = {}
        self._free_slots = list(range(config.max_loras, 0, -1))  # 1..max
        self.refs: dict[str, int] = {}
        self._lru: OrderedDict[str, None] = OrderedDict()  # resident, refcount 0
        self._host: dict[str, tuple[dict, float]] = {}
        self._loading: dict[str, object] = {}
        self._failed: dict[str, str] = {}
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="lora-load")
        # step-anatomy sink (utils/step_anatomy.StepAnatomy), attached by the
        # scheduler: slot loads record as lora_slot_load dispatches
        self.anatomy = None
        self.evictions = 0
        self.loads = 0
        self.load_seconds = 0.0
        self.slot_loads = 0
        self.slot_load_seconds = 0.0  # host seconds enqueueing slot loads
        self.requests: dict[str, int] = {name: 0 for name in self.sources}

    # ---------------- queries ----------------

    @property
    def resident_count(self) -> int:
        return len(self.slot_of)

    def hot_adapter(self) -> str:
        if not any(self.requests.values()):
            return ""
        return max(self.requests, key=lambda n: self.requests[n])

    # ---------------- host load ----------------

    def _load_host(self, name: str) -> tuple[dict, float]:
        t0 = time.monotonic()
        with tracing.span("lora.host_load", adapter=name):
            tree, scale = load_adapter(self.sources[name], self.model_config, self.rank)
            tree = self._stage(tree)
        self.load_seconds += time.monotonic() - t0
        self.loads += 1
        return tree, scale

    def _poll_host(self, name: str) -> Optional[tuple[dict, float]]:
        """Host weights if ready; starts or polls the async load otherwise."""
        got = self._host.get(name)
        if got is not None:
            return got
        if name in self._failed:
            raise RuntimeError(f"LoRA adapter {name!r} failed to load: {self._failed[name]}")
        fut = self._loading.get(name)
        if fut is None:
            self._loading[name] = self._pool.submit(self._load_host, name)
            return None
        if not fut.done():
            return None
        del self._loading[name]
        try:
            got = fut.result()
        except Exception as e:
            log.exception("LoRA adapter %s load failed", name)
            self._failed[name] = str(e)
            raise RuntimeError(f"LoRA adapter {name!r} failed to load: {e}") from e
        self._host[name] = got
        return got

    # ---------------- slot lifecycle ----------------

    def acquire(self, name: str) -> Optional[int]:
        """Pin ``name``'s slot for one sequence. Returns the slot id, or None
        while the adapter is still loading or every slot is pinned (the
        caller keeps the request waiting: never an error). Raises KeyError
        for an unknown adapter and RuntimeError for a broken source."""
        if name not in self.sources:
            raise KeyError(f"unknown LoRA adapter {name!r}")
        slot = self.slot_of.get(name)
        if slot is not None:
            self.refs[name] = self.refs.get(name, 0) + 1
            self._lru.pop(name, None)
            self.requests[name] = self.requests.get(name, 0) + 1
            return slot
        host = self._poll_host(name)
        if host is None:
            return None
        slot = self._take_slot()
        if slot is None:
            return None  # every slot pinned by in-flight sequences
        tree, scale = host
        t0 = time.monotonic()
        self._load_slot(slot, tree, scale)
        dt = time.monotonic() - t0
        self.slot_loads += 1
        self.slot_load_seconds += dt
        tracing.record_span("lora.slot_load", t0, duration=dt, attrs={"adapter": name, "slot": slot})
        if self.anatomy is not None:
            self.anatomy.record("lora_slot_load", dispatch_s=dt, participants=1, ts=t0)
        self.slot_of[name] = slot
        self.refs[name] = 1
        self.requests[name] = self.requests.get(name, 0) + 1
        return slot

    def acquire_blocking(self, name: str, timeout_s: float = 30.0) -> Optional[int]:
        """Acquire for paths with no retry loop (adoption): waits for the
        host load, then takes a slot. None only when every slot stays
        pinned for the whole timeout."""
        deadline = time.monotonic() + timeout_s
        while True:
            slot = self.acquire(name)
            if slot is not None or time.monotonic() >= deadline:
                return slot
            time.sleep(0.01)

    def release(self, name: str) -> None:
        """Unpin one sequence's hold; a refcount-0 slot stays resident (LRU
        tail) until a new adapter needs it."""
        rc = self.refs.get(name, 0) - 1
        if rc > 0:
            self.refs[name] = rc
            return
        self.refs.pop(name, None)
        if name in self.slot_of:
            self._lru[name] = None
            self._lru.move_to_end(name)

    def _take_slot(self) -> Optional[int]:
        if self._free_slots:
            return self._free_slots.pop()
        if not self._lru:
            return None
        victim, _ = self._lru.popitem(last=False)
        slot = self.slot_of.pop(victim)
        self.evictions += 1
        log.info("evicting LoRA adapter %s from slot %d (host copy kept)", victim, slot)
        # the incoming load overwrites the slot's planes; no id names the
        # slot until it does (slot_of has no entry for it)
        return slot

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    # ---------------- telemetry ----------------

    def metrics_snapshot(self) -> dict:
        return {
            "resident": self.resident_count,
            "capacity": self.max_loras,
            "evictions": self.evictions,
            "loads": self.loads,
            "load_seconds": round(self.load_seconds, 4),
            "requests": dict(self.requests),
            "hot": self.hot_adapter(),
        }
