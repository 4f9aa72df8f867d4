"""Each hand-written kernel's bound per launch, taken at set-up from the
cell's own calls: while the program warms up, the kernel wrappers it calls
outside CUDA graph capture are watched, and each call's bound is worked
out by ``perfbench/roofline.py`` from its inputs and outputs, at most
``SAMPLES`` calls a kernel. The profiled slice then gives each kernel's
device time and launches seen by name (``KERNELS``), and the wrappers'
own counters give the launches made (:func:`counting`)."""

from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict

from perfbench import roofline

SAMPLES = 8
# the least share of the slice's launches the profiler has to see for the
# share of the roofline to be read (it misses most of the launches inside
# the frame loop's conditional graph nodes)
SEEN_MIN = 0.9

# profiler kernel name (a substring of it) -> the wrapper that launches it
KERNELS = {"lk_pyramid_kernel": "track_pyramid", "lk_align_kernel": "align_to_templates",
           "sample_patches_kernel": "sample_patches", "sparse_align_kernel": "sparse_align",
           "corner_response_kernel": "corner_response_pyramid",
           "remap_xy_kernel": "remap_xy"}

# where the VO path looks each wrapper up (module, attribute)
SITES = (("dr3_tpu_torch.ops.lk", "track_pyramid"),
         ("dr3_tpu_torch.ops.lk", "align_to_templates"),
         ("dr3_tpu_torch.ops.lk", "sample_patches"),
         ("dr3_tpu_torch.ops.corners", "corner_response_pyramid"),
         ("dr3_tpu_torch.pipelines.vo", "sparse_align"),
         ("dr3_tpu_torch.pipelines.vo", "remap_xy"),
         ("dr3_tpu_torch.pipelines.loop_closure", "remap_xy"))


def _arg(args, kwargs, i, name, default):
    if name in kwargs:
        return kwargs[name]
    return args[i] if len(args) > i else default


def call_bound(name: str, args, kwargs, out) -> dict:
    """The roofline bound of one wrapper call."""
    if name == "track_pyramid":
        return roofline.k1_pyramid(args[0], args[1], args[2], _arg(args, kwargs, 4, "init", None),
                                   _arg(args, kwargs, 5, "half_window", 15),
                                   _arg(args, kwargs, 6, "iters", 10),
                                   _arg(args, kwargs, 7, "eps", 1e-2))
    if name == "align_to_templates":
        return roofline.k1_align(args[0], args[1], args[2], _arg(args, kwargs, 4, "iters", 8),
                                 _arg(args, kwargs, 5, "eps", 1e-2))
    if name == "sample_patches":
        return roofline.k2_sample(args[0], args[1], _arg(args, kwargs, 2, "half", None))
    if name == "sparse_align":
        cam = args[4]
        return roofline.k2_sparse_align(
            args[0], args[1], (args[2].wxyz, args[2].t), (args[3].wxyz, args[3].t),
            (out.T.wxyz, out.T.t), (cam.fx, cam.fy, cam.cx, cam.cy), args[5],
            _arg(args, kwargs, 7, "level", 2), _arg(args, kwargs, 8, "half_patch", 2),
            _arg(args, kwargs, 9, "iters", 15))
    if name == "corner_response_pyramid":
        return roofline.k3_corners(args[0], args[1])
    if name == "remap_xy":
        xy = args[1]
        return roofline.k4_remap(args[0], xy[..., 0], xy[..., 1], xy.numel() * 4, True)
    raise KeyError(name)


class _Watch:
    """Stands in for a kernel wrapper: calls it, then records the call's
    bound. ``launches`` reads and writes the wrapper's own counter, which
    the wrapper's body increments through its module's name."""

    def __init__(self, fn, name: str, samples: dict):
        self.fn, self.name, self.samples = fn, name, samples
        self.__name__ = fn.__name__

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, v):
        self.fn.launches = v

    def __call__(self, *args, **kwargs):
        import torch

        out = self.fn(*args, **kwargs)
        first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
        if (first.is_cuda and not torch.cuda.is_current_stream_capturing()
                and len(self.samples[self.name]) < SAMPLES):
            self.samples[self.name].append(call_bound(self.name, args, kwargs, out)["bound_ms"])
        return out


@contextlib.contextmanager
def watching(enabled: bool):
    """Yields {wrapper name: [bound ms of each watched call]}; watches only
    when ``enabled`` (a traced run)."""
    samples = defaultdict(list)
    if not enabled:
        yield samples
        return
    saved = []
    try:
        for module, attr in SITES:
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _Watch(fn, attr, samples))
        yield samples
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _counters() -> dict:
    """{wrapper name: its launch counter} over the wrappers at ``SITES``."""
    out = {}
    for module, attr in SITES:
        out[attr] = getattr(importlib.import_module(module), attr).launches
    return out


@contextlib.contextmanager
def counting():
    """Yields {wrapper name: launches made inside}, filled on exit."""
    made = {}
    before = _counters()
    try:
        yield made
    finally:
        made.update({k: v - before[k] for k, v in _counters().items()})


def roofline_pct(obs: dict):
    """Sum of bound time over sum of device time of the hand-written
    kernels seen in the profiled slice, each kernel's launches at its mean
    bound per launch. None where no such kernel was both watched and seen,
    or where the profiler saw fewer than ``SEEN_MIN`` of the launches the
    wrappers made in the slice (``obs["kernel_launches"]``): the reading
    would then stand for a sample of the launches and not for the slice."""
    bounds, tr = obs.get("kernel_bounds_ms"), obs.get("trace")
    made = obs.get("kernel_launches") or {}
    if not bounds or not tr:
        return None
    bound_s = device_s = 0.0
    seen = {}
    for kname, (secs, count) in tr["kernel_s"].items():
        wrapper = next((w for frag, w in KERNELS.items() if frag in kname), None)
        if wrapper is None or not bounds.get(wrapper):
            continue
        per = bounds[wrapper]
        bound_s += 1e-3 * sum(per) / len(per) * count
        device_s += secs
        seen[wrapper] = seen.get(wrapper, 0) + count
    expected = sum(made.get(w, 0) for w in seen)
    if device_s <= 0 or sum(seen.values()) < SEEN_MIN * expected:
        return None
    return 100.0 * bound_s / device_s
