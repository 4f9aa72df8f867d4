"""The benchmark of dr3_tpu_torch, the PyTorch and CUDA port, on one CUDA
card.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: the
cell's configuration in ``perfbench/configs/<config>.json``, its traffic
in ``perfbench/workloads/<traffic>.json`` (which names the driver,
``perfbench/drivers/<driver>.py``), the limits that decide ``correct`` in
``perfbench/limits/<cell>.json`` and each per-layer metric's reader in
``perfbench/layer_metrics/<metric>.py``.

A run: set-up (the driver renders or draws its inputs from the seed, builds
the program's state and warms up every shape the traffic uses), then a
window of ``--seconds``, then, with ``--trace 1``, a profiled slice of the
same traffic; then the program's state is freed and the driver judges what
the window produced against the plain reference (``perfbench/reference``).
The last line of stdout is one JSON object; the numbers compared, each with
its limit, are the last lines of stderr and the result's last key. Without
a CUDA card, or with fewer than the cell asks for, the run prints no result
and exits 2; so it does when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``dr3_tpu`` is loaded (top-level module names compared whole).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "dr3_tpu")
PROGRAM = "dr3_tpu_torch"


def process_age_s() -> float:
    """Seconds since this process started (Linux; 0 where unknown)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T0 = time.perf_counter() - process_age_s()


def load_json(root: str, *parts) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(root: str, workload: str) -> dict:
    """The cell's entries and files: cell, config, traffic, limits, the
    end-to-end and per-layer metrics it reports."""
    bench = load_json(root, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    traffic = load_json(root, "perfbench", "workloads", cell["traffic"] + ".json")
    limits = load_json(root, "perfbench", "limits", workload + ".json")
    return dict(cell=cell, config=load_json(root, conf["file"]), traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer,
                driver=os.path.join(root, "perfbench", "drivers", traffic["driver"] + ".py"),
                readers={m["name"]: os.path.join(root, "perfbench", "layer_metrics",
                                                 m["name"] + ".py") for m in layer})


class SyncCount:
    """Host reads counted with ``torch.cuda.set_sync_debug_mode("warn")``:
    every call that synchronises with the card warns once."""

    def __init__(self):
        self.count = 0

    def show(self, message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            self.count += 1


class Ctx:
    """What a driver gets: the seed, the cell's files, the device, the
    program's entry points, and the harness's clocks, counters and spans."""

    def __init__(self, spec: dict, seed: int, device, program, trace: bool):
        self.seed, self.device, self.program, self.trace = seed, device, program, trace
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.limits_meta = spec["limits"]
        self.limits = spec["limits"]["limits"]
        self.kernel_bounds_ms = {}       # wrapper -> bound ms per watched call
        self.kernel_launches = {}        # wrapper -> launches made in the traced slice

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def count_syncs(self):
        """Counts the host reads inside, with ``--trace 1`` on the card
        (the count costs a Python call per read); else ``count`` is None."""
        counter = SyncCount()
        if not (self.trace and self.device.type == "cuda"):
            counter.count = None
            yield counter
            return
        import torch

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = counter.show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield counter
            finally:
                torch.cuda.set_sync_debug_mode("default")

    @staticmethod
    def span(name: str):
        from torch.profiler import record_function

        return record_function(name)


def load_program(driver) -> object:
    """The driver's entry points of the program, imported from the package
    beside ``perfbench`` (never another copy of it)."""
    from types import SimpleNamespace

    mod = importlib.import_module(PROGRAM)
    here = os.path.dirname(os.path.abspath(mod.__file__))
    if os.path.dirname(here) != ROOT:
        raise SystemExit(f"perfbench: {PROGRAM} imported from {here}, not from {ROOT}")
    out = {}
    for name, where in driver.PROGRAM.items():
        module, attr = where.split(":")
        out[name] = getattr(importlib.import_module(module), attr)
    return SimpleNamespace(**out)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e})"


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             program=None) -> dict:
    """One run of a cell on ``device``; returns the result's dict (its
    ``checks`` last). ``program`` replaces the program's entry points (for
    the harness's own tests)."""
    import torch

    spec = cell_spec(root, workload)
    driver = load_module(spec["driver"], "perfbench_driver_" + spec["traffic"]["driver"])
    if program is None:
        program = load_program(driver)
    ctx = Ctx(spec, seed, torch.device(device), program, trace)
    if ctx.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    state = driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - _T0
    win = driver.window(state, ctx, seconds)
    metrics, obs = {}, dict(win["obs"], kernel_bounds_ms=ctx.kernel_bounds_ms)
    if trace:
        from perfbench import trace as tracing

        obs["trace"] = tracing.profile(lambda: driver.trace_slice(state, ctx), ctx.sync)
        obs["kernel_launches"] = ctx.kernel_launches
    dev_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                "kind": torch.cuda.get_device_name(ctx.device)
                if ctx.device.type == "cuda" else "cpu",
                "count": int(spec["cell"]["chips"]),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(ctx.device))
                if ctx.device.type == "cuda" else 0}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    if trace:
        dev_info["busy_s"] = obs["trace"]["busy_s"]
        dev_info["window_s"] = obs["trace"]["window_s"]
        for name, path in spec["readers"].items():
            value = load_module(path, "perfbench_metric_" + name.replace(".", "_")).read(obs)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
    else:
        for m in spec["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else win["metrics"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    driver.finish(state)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    values = driver.readings(ctx, state)
    checks = [(name, values.get(name, math.inf), lim) for name, lim in ctx.limits.items()]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": obs["trace"]["device_ops"],
                               "idle_gaps": obs["trace"]["idle_gaps"]}
    result["card"] = card_line() if ctx.device.type == "cuda" else "none (CPU run)"
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout (the
    # port builds its kernels into build/ beside the package on its own)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    import torch

    chips = int(cell_spec(ROOT, args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    found = loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 2
    print(f"card: {result['card']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
