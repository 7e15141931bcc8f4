"""Timing on the card: CUDA events around calls, and a kernel's own device
time from ``torch.profiler``.  Shared by ``chip_smoke.py`` and
``cli/profile_serve.py``."""

from __future__ import annotations

import statistics
import time

import torch


def events_ms(fn, inner: int = 1, samples: int = 1) -> float:
    """Time of one call in ms: the median over ``samples`` of CUDA events
    around ``inner`` back-to-back calls, after one warm-up call.  For small
    kernels the host's launch path (wrapper checks, allocation, ctypes) can
    set this time; ``profiled_ms`` gives the kernels' own device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# cycles of the sleep kernel that ``queued_ms`` puts ahead of a burst:
# ~5 ms at the H100's clock, longer than the host takes to queue a burst
SLEEP_CYCLES = 10_000_000


def queued_ms(fn, reps: int = 20, samples: int = 5) -> float:
    """Device time of one call in ms: CUDA events around ``reps`` calls
    queued behind a sleep kernel, so that the device runs them back to back
    without waiting on the host's launch path; the median over
    ``samples``, after one warm-up call.  Unlike ``events_ms`` it does not
    count the host's time per call where that exceeds the kernel's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def is_device_event(evt) -> bool:
    """A device kernel's (or copy's) event: not a user annotation, whose
    device-side range (``Optimizer.step``, say) spans kernels and the gaps
    between them."""
    return (str(getattr(evt, "device_type", "")).endswith("CUDA")
            and not getattr(evt, "is_user_annotation", False))


def device_us(evt) -> float:
    return float(evt.self_device_time_total)


def profile(fn, reps: int):
    """``torch.profiler`` over ``reps`` calls of ``fn``; returns the
    profiler and the host wall time of the window in µs."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def profiled_ms(fn, reps: int, kernel: str) -> float | None:
    """Device time in ms per call of the device kernels whose name holds
    ``kernel``, over ``reps`` profiled calls (None if the profiler reports
    no device time)."""
    prof, _ = profile(fn, reps)
    total = sum(device_us(e) for e in prof.key_averages()
                if kernel in e.key and is_device_event(e))
    return total / reps / 1e3 if total > 0 else None
