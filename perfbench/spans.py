"""The program's spans in a torch.profiler trace, and a cell's traced slice
read by them.

    python3 -m perfbench.spans --workload bal-dubrovnik-88 --seed <n> [--seconds 5] [--slices 3]

sets the cell up as ``perfbench.run`` does, runs its window for
``--seconds`` (the driver logs it), then profiles ``--slices`` of its
traced slices and prints one JSON line for each: ``perfbench.trace``'s
reading (window, busy time, top device operations and idle gaps) with the
spans' reading beside it under ``spans`` and the BAL solve's figures under
``figures``; an ``idle by span:`` line goes to stderr. It needs the card
only for the device figures: ``--device cpu`` reads the host's.

The port opens a ``record_function`` range named ``dr3.<stage>`` around
each stage while a profiler records (``dr3_tpu_torch.utils.timing.span``
and every ``Monitor`` tic/toc). Those ranges are host events
(``user_annotation``) on the same clock as the device's operations, and a
device operation carries the ``correlation`` of the host call that
launched it. So the reading charges:

* each device operation (kernel, copy, fill) to the innermost program span
  that was open, on the launching thread, when its launch call ran;
* each host launch call (a CUDA runtime or driver call that enqueues device
  work) to the innermost program span open at its start;
* each idle gap of the device's busy timeline (as ``perfbench.trace``
  counts it) to the innermost program span open at the gap's middle on the
  thread of the innermost host call open then.

Spans nest by time on their thread. Per span name the reading gives its
count, its host seconds, and its device seconds and launches, both its own
(charged to it as the innermost span) and with its children's.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

from perfbench import run, trace

PREFIX = "dr3."
OUTSIDE = "outside any program span"
# the runtime and driver calls that enqueue device work
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
            "cuMemcpy", "cudaMemset", "cuMemset")
# the BAL solve's figures an LM iteration: device milliseconds charged to
# these spans (the solve's stages, section 3 of PERF.md)
BAL_STAGES = {"bal.assembly_ms_per_lm_iter": ("dr3.ba.assemble", "dr3.ba.z_build"),
              "bal.ztz_ms_per_lm_iter": ("dr3.ba.ztz",),
              "bal.step_ms_per_lm_iter": ("dr3.ba.camera_solve", "dr3.ba.back_substitute",
                                          "dr3.ba.accept")}


def _family(name: str) -> str:
    """``dr3.ba.lm_iter`` -> ``dr3.ba``."""
    return ".".join(name.split(".")[:2])


class _Thread:
    """One thread's program spans, nested by time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s["ts"], -s["dur"]))
        self.starts = [s["ts"] for s in self.spans]
        self.parent = []
        stack = []
        for i, s in enumerate(self.spans):
            while stack and self._end(stack[-1]) <= s["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def _end(self, i):
        s = self.spans[i]
        return s["ts"] + s["dur"]

    def innermost(self, t):
        """The index of the innermost span open at ``t``, or None: the latest
        to start at or before ``t``, or the nearest of its ancestors that is
        still open then."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            if self._end(i) > t:
                return i
            i = self.parent[i]
        return None


def _gaps(host, dev):
    """The idle gaps of the device's busy timeline, each (its middle in us,
    its seconds, the innermost host event open at its middle or None), with
    the busy time counted as :func:`perfbench.trace.read_events` counts it: a
    CUDA graph launch busy from its first operation to its last."""
    graph = {ev["args"]["correlation"] for ev in host
             if ev.get("cat") == "cuda_runtime" and ev.get("name", "").startswith("cudaGraphLaunch")
             and "correlation" in ev.get("args", {})}
    launches, intervals = {}, []
    for ev in dev:
        c = ev.get("args", {}).get("correlation")
        if c in graph:
            sp = launches.setdefault(c, [ev["ts"], ev["ts"] + ev["dur"]])
            sp[0], sp[1] = min(sp[0], ev["ts"]), max(sp[1], ev["ts"] + ev["dur"])
        else:
            intervals.append((ev["ts"], ev["ts"] + ev["dur"]))
    busy = trace._merge(intervals + [tuple(sp) for sp in launches.values()])
    host = sorted(host, key=lambda ev: ev["ts"])
    starts = [ev["ts"] for ev in host]
    out = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        inner = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 2000, -1), -1):
            if host[j]["ts"] + host[j]["dur"] >= mid:
                inner = host[j]
                break
        out.append((mid, (s1 - e0) * 1e-6, inner))
    return out


def read(events) -> dict:
    """The spans' reading of chrome-trace events (us):

    ``by_name``: {span name: {n, host_s, device_s, launches, device_s_total,
    launches_total, idle_s}} (``device_s``/``launches`` the span's own,
    ``*_total`` with its children's); ``charged_s``: {family (``dr3.ba``):
    seconds of the busy timeline covered by device operations charged to
    the family's spans}; ``outside_s``: device seconds charged to no span;
    ``idle_gaps``: the top 10 [span name, seconds] of the idle gaps."""
    host = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev
            and ev.get("cat", "") in trace.HOST_CATS]
    dev = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev
           and ev.get("cat", "") in trace.DEVICE_CATS]
    threads = defaultdict(list)
    for ev in host:
        if ev.get("cat") == "user_annotation" and ev.get("name", "").startswith(PREFIX):
            threads[(ev.get("pid"), ev.get("tid"))].append(ev)
    threads = {k: _Thread(v) for k, v in threads.items()}

    def at(key, t):
        th = threads.get(key)
        i = th.innermost(t) if th else None
        return None if i is None else (key, i)

    calls = [ev for ev in host if ev.get("cat") in ("cuda_runtime", "cuda_driver")]
    launch_of = {}
    own_launches = defaultdict(int)
    runtime_end = defaultdict(float)
    for ev in sorted(calls, key=lambda e: e["ts"]):
        key = (ev.get("pid"), ev.get("tid"))
        c = ev.get("args", {}).get("correlation")
        if c is not None:
            launch_of[c] = ev
        # a driver call made inside a runtime call is the same launch
        if ev.get("cat") == "cuda_driver" and ev["ts"] < runtime_end[key]:
            continue
        if ev.get("cat") == "cuda_runtime":
            runtime_end[key] = max(runtime_end[key], ev["ts"] + ev["dur"])
        if ev.get("name", "").startswith(LAUNCHES):
            own_launches[at(key, ev["ts"])] += 1

    own_device = defaultdict(float)
    charged = defaultdict(list)
    for ev in dev:
        call = launch_of.get(ev.get("args", {}).get("correlation"))
        where = at((call.get("pid"), call.get("tid")), call["ts"]) if call else None
        own_device[where] += ev["dur"] * 1e-6
        if where is not None:
            charged[_family(threads[where[0]].spans[where[1]]["name"])].append(
                (ev["ts"], ev["ts"] + ev["dur"]))

    idle = defaultdict(float)
    for t, s, inner in _gaps(host, dev):
        where = at((inner.get("pid"), inner.get("tid")), t) if inner else None
        idle[threads[where[0]].spans[where[1]]["name"] if where else OUTSIDE] += s

    by_name = {}
    for key, th in threads.items():
        total_dev = [own_device.get((key, i), 0.0) for i in range(len(th.spans))]
        total_launch = [own_launches.get((key, i), 0) for i in range(len(th.spans))]
        # children start after their parents, so a reverse pass sums subtrees
        for i in range(len(th.spans) - 1, -1, -1):
            if th.parent[i] is not None:
                total_dev[th.parent[i]] += total_dev[i]
                total_launch[th.parent[i]] += total_launch[i]
        for i, s in enumerate(th.spans):
            e = by_name.setdefault(s["name"], dict(n=0, host_s=0.0, device_s=0.0, launches=0,
                                                   device_s_total=0.0, launches_total=0,
                                                   idle_s=0.0))
            e["n"] += 1
            e["host_s"] += s["dur"] * 1e-6
            e["device_s"] += own_device.get((key, i), 0.0)
            e["launches"] += own_launches.get((key, i), 0)
            e["device_s_total"] += total_dev[i]
            e["launches_total"] += total_launch[i]
    for name, s in idle.items():
        if name in by_name:
            by_name[name]["idle_s"] += s
    return dict(by_name=by_name,
                charged_s={f: _covered(iv) for f, iv in charged.items()},
                outside_s=own_device.get(None, 0.0),
                idle_gaps=[[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]])


def _covered(intervals) -> float:
    """Seconds that the union of ``intervals`` (us) covers."""
    out, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        out += max(0.0, e - max(s, end))
        end = max(end, e)
    return out * 1e-6


def profile(fn, sync) -> dict:
    """:func:`perfbench.trace.profile`'s reading of ``fn()``, under the same
    profiler, with the spans' reading of the same events under ``spans``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return dict(trace.read_events(events, window_s), spans=read(events))


def figures(tr: dict) -> dict:
    """The BAL solve's figures of a :func:`profile` reading, over its
    ``dr3.ba.lm_iter`` spans: ``bal.host_ms_per_lm_iter`` (their mean host
    duration, the profiler's own cost inside it),
    ``bal.launches_per_lm_iter`` (host launch calls inside them; where the
    slice ran something on a device) and the device milliseconds of
    :data:`BAL_STAGES` (where the device operations charged to ``dr3.ba.*``
    spans cover 90% of the busy time or more: the profiler drops events now
    and then). Empty without the spans."""
    sp = tr["spans"]
    it = sp["by_name"].get("dr3.ba.lm_iter")
    if not it or not it["n"]:
        return {}
    out = {"bal.host_ms_per_lm_iter": 1e3 * it["host_s"] / it["n"]}
    if tr["device_events"]:
        out["bal.launches_per_lm_iter"] = it["launches_total"] / it["n"]
    if tr["busy_s"] > 0 and sp["charged_s"].get("dr3.ba", 0.0) >= 0.9 * tr["busy_s"]:
        for name, stages in BAL_STAGES.items():
            out[name] = 1e3 * sum(sp["by_name"][s]["device_s"] for s in stages
                                  if s in sp["by_name"]) / it["n"]
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float, slices: int,
             device) -> list:
    """A cell set up as ``perfbench.run`` sets it up, its window of
    ``seconds``, then ``slices`` profiled traced slices: each slice's
    :func:`profile` reading with its :func:`figures` under ``figures``."""
    import torch

    spec = run.cell_spec(root, workload)
    driver = run.load_module(spec["driver"], "perfbench_driver_" + spec["traffic"]["driver"])
    ctx = run.Ctx(spec, seed, torch.device(device), run.load_program(driver), True)
    if ctx.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    state = driver.setup(ctx)
    driver.window(state, ctx, seconds)
    out = []
    for _ in range(slices):
        tr = profile(lambda: driver.trace_slice(state, ctx), ctx.sync)
        out.append(dict(tr, figures=figures(tr)))
    driver.finish(state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--slices", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(run.ROOT, "build", sub)
    for tr in run_cell(run.ROOT, args.workload, args.seed, args.seconds, args.slices,
                       args.device):
        print("idle by span: " + ", ".join(f"{name} {1e3 * s:.3f} ms"
                                           for name, s in tr["spans"]["idle_gaps"]),
              file=sys.stderr, flush=True)
        print(json.dumps(tr), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
