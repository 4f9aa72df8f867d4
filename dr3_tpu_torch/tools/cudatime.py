"""Times on the card: host-inclusive rates with CUDA events, and device
time per call with torch.profiler. Used by chip_smoke.py and
dr3_tpu_torch/tools/kernel_time.py; nothing of the port's path calls them.
Every function here but :func:`per_launch` and :func:`uneven` needs a CUDA
device."""

from __future__ import annotations

import statistics

import torch
import torch.profiler


def cuda_ms(fn, reps: int = 20, n: int = 10, warm: int = 3) -> float:
    """Host-inclusive time per call of fn() in ms: the median over ``reps``
    runs, after warm-up, of CUDA events around n calls launched back to
    back, divided by n. For a kernel whose device time is below its
    wrapper's host time this measures the host launch rate, which is what
    the main path pays too."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def device_events(prof) -> dict[str, tuple[int, float]]:
    """{kernel, memcpy or memset name: (count, device us in all)} of a
    finished torch.profiler.profile."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = (e.count, float(us))
    return out


def per_launch(events: dict[str, tuple[int, float]],
               names: dict[str, str]) -> dict[str, tuple[int, float]]:
    """{entry: (launches, device us per launch)} of the kernels in a
    profile's ``events``, ``names`` mapping each entry to a substring of its
    kernels' names; entries with no launch are left out."""
    out = {}
    for entry, kernel in names.items():
        hits = [(c, us) for name, (c, us) in events.items() if kernel in name]
        count = sum(c for c, _ in hits)
        if count:
            out[entry] = (count, sum(us for _, us in hits) / count)
    return out


def uneven(events: dict[str, tuple[int, float]], n: int) -> dict[str, int]:
    """{name: count} of the ``events`` of a window of n calls that were not
    seen a whole number of times per call: the profiler now and then loses a
    few of a window's events (a kernel seen 96 times in 100 calls), and a
    window may hold a stray event that is not the calls' (seen once)."""
    return {name: count for name, (count, _) in events.items() if count % n}


def profile(fn, n: int = 1) -> dict[str, tuple[int, float]]:
    """device_events of n calls of fn() (a synchronize closes the window)."""
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return device_events(prof)


def whole_window(fn, n: int, windows: int = 4):
    """(events, uneven counts) of a profiler window of n calls of fn(): the
    first of up to ``windows`` windows that saw device time and in which
    every kernel was seen a whole number of times per call, else the last
    one taken, with what was :func:`uneven` in it. Now and then the profiler
    records no device event in a whole window; such a window is taken
    again, not read as free."""
    for _ in range(windows):
        events = profile(fn, n)
        odd = uneven(events, n)
        if not odd and sum(us for _, us in events.values()) > 0.0:
            break
    return events, odd


def device_ms(fn, n: int = 100, warm: int = 3) -> tuple[float, str]:
    """Device time per call of fn() in ms, and how it was taken: the summed
    device time of all it runs on the card over n back-to-back calls in one
    profiler window (:func:`whole_window`), divided by n ("profiler", with
    the uneven counts where no window was whole); where no window saw
    device time, CUDA events around n back-to-back calls ("events"), which
    for a kernel shorter than its launch measure the host's launch rate."""
    for _ in range(warm):
        fn()
    events, odd = whole_window(fn, n)
    total_us = sum(us for _, us in events.values())
    if total_us > 0.0:
        return total_us / n / 1e3, f"profiler, uneven counts {odd}" if odd else "profiler"
    return cuda_ms(fn, reps=5, n=n, warm=0), "events"
