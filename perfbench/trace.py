"""Reading a torch.profiler trace of a slice of a run: the device's busy
time, the device operations that took most of it, the idle gaps by what
the host was doing, and the device time of each kernel by name."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def profile(fn, sync) -> dict:
    """Run ``fn`` under torch.profiler (host and device activity) and read
    the trace: ``window_s`` (host clock from before ``fn`` to after the
    device finished), ``busy_s`` (the union of the device's operations, a
    CUDA graph launch's from its first to its last),
    ``device_ops`` and ``idle_gaps`` (top 10 [name, seconds]) and
    ``kernel_s`` (seconds and count of each kernel name)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return read_events(events, window_s)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_events(events, window_s: float) -> dict:
    """The reading of :func:`profile` from chrome-trace events (us)."""
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(ev)
        elif cat in HOST_CATS:
            host.append(ev)
    op_s = defaultdict(float)
    kernel = defaultdict(lambda: [0.0, 0])
    for ev in dev:
        name = ev.get("name", "?")
        op_s[name[:160]] += ev["dur"] * 1e-6
        if ev.get("cat") == "kernel":
            kernel[name][0] += ev["dur"] * 1e-6
            kernel[name][1] += 1
    # A CUDA graph runs its nodes back to back with no host in between, so
    # the device counts as busy from the first of a launch's operations to
    # its last; the profiler does not see every node of a graph with
    # conditional nodes (the frame loop's), only some on either side.
    graph = {ev["args"]["correlation"] for ev in host
             if ev.get("cat") == "cuda_runtime" and ev.get("name", "").startswith("cudaGraphLaunch")
             and "correlation" in ev.get("args", {})}
    spans, intervals = {}, []
    for ev in dev:
        c = ev.get("args", {}).get("correlation")
        if c in graph:
            sp = spans.setdefault(c, [ev["ts"], ev["ts"] + ev["dur"]])
            sp[0], sp[1] = min(sp[0], ev["ts"]), max(sp[1], ev["ts"] + ev["dur"])
        else:
            intervals.append((ev["ts"], ev["ts"] + ev["dur"]))
    busy = _merge(intervals + [tuple(sp) for sp in spans.values()])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = defaultdict(float)
    host.sort(key=lambda ev: ev["ts"])
    starts = [ev["ts"] for ev in host]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        # host calls nest, so the latest one to start before the gap's middle
        # that is still running then is the innermost
        inner = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 2000, -1), -1):
            if host[j]["ts"] + host[j]["dur"] >= mid:
                inner = host[j]
                break
        gaps["host: " + (inner["name"][:150] if inner else "outside any traced call")] += \
            (s1 - e0) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(window_s=window_s, busy_s=busy_s, device_ops=top(op_s), idle_gaps=top(gaps),
                kernel_s={k: v for k, v in kernel.items()}, device_events=len(dev),
                graph_launches=len(spans))


def idle_pct(obs):
    """The device's idle share of a run's profiled slice, 100 (1 - busy /
    window); None where the trace saw no device operation."""
    tr = obs.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
