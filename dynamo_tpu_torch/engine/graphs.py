"""The runner's compiled step functions: each step body captured once per
shape into a CUDA graph and replayed (the counterpart of the reference's
``jax.jit`` step functions with the KV cache and slot state donated,
``dynamo_tpu/engine/model_runner.py``).

A body takes static input tensors (the packed control arrays and the
sampling noise) and updates the KV pools and the slot-token buffer in
place, so a replay writes the same memory the eager body writes: the
counterpart of donation. :class:`GraphCache` keeps one graph per key:

  - on a key's first call its inputs are filled, the body runs once eagerly
    on a side stream (kernel libraries load, cuBLAS and shared-memory
    attributes are set up outside the capture, and this run's outputs are
    the call's result), then the body is captured on that stream into the
    one memory pool all graphs share (replays are serialized on one
    stream), with ``capture_error_mode="thread_local"`` so other threads'
    CUDA calls cannot break it; the capture is charged to the
    ``CompileMonitor``. A capture that fails raises: nothing falls back to
    the eager body;
  - on later calls the inputs are copied into the static tensors and the
    graph is replayed on the current stream.

Launch counters: every kernel launcher counts its calls in Python
(``<launcher>.launches``), and a replay runs no Python. So the capture
takes a tally, each launcher's count after the capture less before it,
takes it back off (a capture launches nothing), and adds it on every
replay: the counters go on counting what ran on the card.
"""

from __future__ import annotations

import time

import torch

from dynamo_tpu_torch.utils import get_logger
from dynamo_tpu_torch.utils.compile_monitor import CompileMonitor

log = get_logger("engine.graphs")


def kernel_launchers() -> tuple:
    """Every kernel launcher of ``ops/kernels`` (the functions that count
    their calls in ``.launches``)."""
    from dynamo_tpu_torch.ops.kernels import mla_attention, paged_attention, prefill_attention

    found = {}
    for mod in (paged_attention, prefill_attention, mla_attention):
        for name, fn in sorted(vars(mod).items()):
            if callable(fn) and hasattr(fn, "launches") and name.endswith("_kernel"):
                found.setdefault(id(fn), fn)
    return tuple(found.values())


def launch_counts(launchers) -> list[int]:
    return [fn.launches for fn in launchers]


def take_tally(launchers, before: list[int]) -> tuple:
    """((launcher, launches since ``before``), ...) for the launchers that
    counted any, taken back off their counters."""
    tally = tuple((fn, fn.launches - n) for fn, n in zip(launchers, before) if fn.launches != n)
    for fn, n in tally:
        fn.launches -= n
    return tally


def add_tally(tally) -> None:
    for fn, n in tally:
        fn.launches += n


class CudaGraphs:
    """Eager warm-up and capture on one side stream into one shared pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def eager(self, body, inputs):
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = body(*inputs)
        main.wait_stream(self.stream)
        for t in out:
            t.record_stream(main)  # allocated on the side stream, read on the main one
        return out

    def record(self, body, inputs, like):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
            out = body(*inputs)
        return graph, out

    def pool_bytes(self) -> int | None:
        """Device bytes the shared pool holds (its segments in the caching
        allocator's snapshot); None when the snapshot does not say."""
        segments = torch.cuda.memory_snapshot()
        if not segments or "segment_pool_id" not in segments[0]:
            return None
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == pool)


class _Entry:
    __slots__ = ("graph", "inputs", "outputs", "tally", "replays")

    def __init__(self, graph, inputs, outputs, tally):
        self.graph, self.inputs, self.outputs, self.tally = graph, inputs, outputs, tally
        self.replays = 0


class GraphCache:
    """One captured graph per step key. ``backend`` does the eager run and
    the capture (:class:`CudaGraphs` on the card); ``launchers`` are the
    counters the replays keep honest."""

    def __init__(self, backend, monitor: CompileMonitor | None = None, launchers: tuple | None = None):
        self.backend = backend
        self.monitor = monitor or CompileMonitor()
        self.launchers = kernel_launchers() if launchers is None else launchers
        self.entries: dict = {}

    def __len__(self) -> int:
        return len(self.entries)

    def run(self, label: str, key, make_inputs, fill, body) -> tuple:
        """The outputs of ``body(*inputs)`` (a tuple of tensors) for this
        call: ``fill(inputs)`` copies the call's values into the key's
        static inputs (``make_inputs()`` allocates them on the key's first
        call), then the key's graph replays, or, on its first call, the body
        runs eagerly and is captured."""
        entry = self.entries.get(key)
        if entry is not None:
            fill(entry.inputs)
            entry.graph.replay()
            add_tally(entry.tally)
            entry.replays += 1
            return entry.outputs
        inputs = make_inputs()
        fill(inputs)
        t0 = time.monotonic()
        out = self.backend.eager(body, inputs)
        before = launch_counts(self.launchers)
        try:
            graph, static_out = self.backend.record(body, inputs, out)
        finally:
            tally = take_tally(self.launchers, before)
        self.monitor.record(label, time.monotonic() - t0)
        self.entries[key] = _Entry(graph, inputs, static_out, tally)
        log.debug("captured %s %s (%d graphs)", label, key, len(self.entries))
        return out

    def pool_bytes(self) -> int | None:
        fn = getattr(self.backend, "pool_bytes", None)
        return fn() if fn is not None else None
