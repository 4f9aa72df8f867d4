"""The readings that the limits of ``correct`` are set from, and the
control that has to fail them.

    python -m perfbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 10 [--control]

For each seed, in one process: the cell's set-up and a window of
``--seconds``, then the driver's readings against the plain reference, one
JSON line per seed. With ``--control`` the cell's limits file's
``"control"`` says what stands in the program's place:
``"reference_dtype"``, the reference computed in that type (the driver's
``control_outputs``), or ``"settings"``, the program with these settings
over the configuration's. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from perfbench.run import ROOT, Ctx, cell_spec, load_module, load_program


def calibrate(workload: str, seed: int, seconds: float, control: bool, device="cuda",
              root: str = ROOT, program=None) -> dict:
    import torch

    spec = cell_spec(root, workload)
    driver = load_module(spec["driver"], "perfbench_driver_" + spec["traffic"]["driver"])
    how = spec["limits"]["control"] if control else {}
    if how.get("settings"):
        spec["config"] = dict(spec["config"],
                              settings=dict(spec["config"]["settings"], **how["settings"]))
    ctx = Ctx(spec, seed, torch.device(device), program or load_program(driver), False)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    state = driver.setup(ctx)
    setup_s = time.perf_counter() - t0
    metrics = driver.window(state, ctx, seconds)["metrics"]
    driver.finish(state)
    if how.get("reference_dtype"):
        driver.control_outputs(ctx, state, getattr(torch, how["reference_dtype"]))
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    values = driver.readings(ctx, state)
    return dict(workload=workload, seed=seed, control=control, readings=values,
                metrics=metrics, setup_s=setup_s, reference_s=time.perf_counter() - t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            row = calibrate(args.workload, seed, args.seconds, args.control)
        except Exception as e:                       # a control may crash: that fails it
            row = dict(workload=args.workload, seed=seed, control=args.control,
                       error=f"{type(e).__name__}: {e}")
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
