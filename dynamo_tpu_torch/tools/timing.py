"""Device timing for the port's measurement tools: the card's name and power
limit, and the device time of a launch sequence with the host's launch
overhead kept out of it, beside its back-to-back time and the host's time to
enqueue a launch."""

from __future__ import annotations

import subprocess
import time

import torch

SLEEP_CYCLES = 100_000_000  # ~50-60 ms of an H100 SM clock


def card() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _device_and_host_us(launch, iters: int) -> tuple[float, float]:
    """(device, host) mean microseconds of ``launch(i)`` for i in range(iters),
    run back to back. A sleep kernel holds the stream while the host enqueues
    all of them, so host overhead between launches does not show in the CUDA
    events; if the host took longer than the sleep, the sleep doubles and the
    measurement repeats. The host time is the enqueueing's, a launch."""
    for i in range(iters):  # warm-up: builds, allocator, caches
        launch(i)
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            launch(i)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < slept.elapsed_time(start):
            return start.elapsed_time(end) * 1e3 / iters, host_ms * 1e3 / iters
        cycles *= 2
    raise RuntimeError(f"the host needed {host_ms:.1f} ms to enqueue {iters} launches, longer than the sleep")


def device_us(launch, iters: int) -> float:
    """Mean device microseconds of ``launch(i)`` for i in range(iters), run
    back to back, the host's enqueueing hidden (``_device_and_host_us``)."""
    return _device_and_host_us(launch, iters)[0]


def launch_times(launch, iters: int) -> tuple[float, float, float]:
    """(device, back-to-back, host) mean microseconds of ``launch(i)`` for i
    in range(iters). Device: ``device_us``. Back-to-back: CUDA events around
    the same launches with nothing in front of them, so where the host's
    enqueueing is the longer it is what counts, as for a caller that launches
    and goes on. Host: the enqueueing of one launch, measured behind the
    sleep."""
    dev, host = _device_and_host_us(launch, iters)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        launch(i)
    end.record()
    end.synchronize()
    return dev, start.elapsed_time(end) * 1e3 / iters, host
