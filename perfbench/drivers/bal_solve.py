"""Driver ``bal_solve``: a BAL problem solved as ``run_ba`` solves a file,
back to back from the same seeded start, each solve's cost read back on
the host a few solves after it was sent. ``bal_lm_iters_per_s`` is the LM
iterations of every solve sent in the window over the time from its start
to the read that ends the last of them. Every solve's cameras and points
are kept on the device and judged after the window."""

from __future__ import annotations

import gc
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.gen import bal
from perfbench.reference import bal_lm
from perfbench.vo_common import now


# the program's entry points this driver feeds (module:name)
PROGRAM = {"BALData": "dr3_tpu_torch.io.bal:BALData",
           "bal_to_snavely": "dr3_tpu_torch.ba.snavely:bal_to_snavely",
           "bundle_adjust_snavely": "dr3_tpu_torch.ba.snavely:bundle_adjust_snavely"}


def _problem(ctx):
    c = ctx.config["problem"]
    start, _ = bal.bal_case(c["cameras"], c["points"], c["observations"], ctx.seed)
    return start


def _solve(ctx, prob):
    s = ctx.config["solve"]
    return ctx.program.bundle_adjust_snavely(prob, s["lm_iterations"],
                                             huber_delta=s["huber_delta"],
                                             solver=s["solver"])


def setup(ctx):
    start = _problem(ctx)
    p = ctx.program
    prob = p.bal_to_snavely(p.BALData(start["cam_params"], start["points"], start["obs_cam"],
                                      start["obs_pt"], start["obs_uv"]), device=ctx.device)
    for _ in range(int(ctx.traffic["warmup_solves"])):
        float(_solve(ctx, prob).final_cost)
    return SimpleNamespace(start=start, prob=prob, outputs=[])


def _late_read(ctx, res):
    """A read of the solve's cost that waits for that solve alone: the cost
    is copied to pinned host memory behind the solve and an event marks the
    copy's end, so the read does not wait for the solves sent after it (a
    plain ``float`` would, being queued behind them)."""
    if ctx.device.type != "cuda":
        return lambda: float(res.final_cost)
    host = torch.empty((), dtype=res.final_cost.dtype, pin_memory=True)
    host.copy_(res.final_cost, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def read():
        copied.synchronize()
        return float(host)
    return read


def window(state, ctx, seconds: float) -> dict:
    """Solves are sent ``solves_ahead`` ahead of the one whose cost is
    read, so that the card has work queued while the host stands still;
    when the time is up nothing more is sent, every solve sent is read, and
    the clock is read after that. Python's collector is off in the window."""
    iters = int(ctx.config["solve"]["lm_iterations"])
    ahead = int(ctx.traffic["solves_ahead"])
    pending = deque()
    enq, done = [], []

    def read_one():
        res, read = pending.popleft()
        read()                                       # the read that ends the solve
        done.append(now())
        state.outputs.append(res.problem)

    gc.collect()
    gc.disable()
    try:
        ctx.sync()
        t0 = now()
        while now() - t0 < seconds:
            ts = now()
            res = _solve(ctx, state.prob)
            pending.append((res, _late_read(ctx, res)))
            enq.append(now() - ts)
            if len(pending) > ahead:
                read_one()
        while pending:
            read_one()
        t1 = now()
    finally:
        gc.enable()
    n = len(done)
    solve_s = np.diff([t0] + done)
    ctx.log(f"window: {n} solves, {ahead} ahead; between reads s p50 {np.median(solve_s):.4f} "
            f"max {solve_s.max():.4f}; sending a solve s p50 {np.median(enq):.4f} "
            f"max {max(enq):.4f}")
    return dict(metrics={"bal_lm_iters_per_s": n * iters / (t1 - t0)},
                attempted=n, failed=0, obs=dict(solves=n, lm_iterations=iters))


def trace_slice(state, ctx) -> None:
    """One more solve under a ``bundle_adjust_snavely`` range."""
    with ctx.span("bundle_adjust_snavely"):
        float(_solve(ctx, state.prob).final_cost)


def finish(state) -> None:
    """Bring every solve's result to the host and free the program's
    problem."""
    state.results = [
        dict(wxyz=o.cam_wxyz.double().cpu(), t=o.cam_t.double().cpu(),
             fkk=o.cam_fkk.double().cpu(), X=o.points.double().cpu())
        for o in state.outputs]
    state.outputs = state.prob = None


def reference_optimum(ctx, start, device):
    """The reference's solve of the start, run past the program's iteration
    count so that it ends at the minimum."""
    prob = bal_lm.Problem(start, device)
    params, costs, _ = bal_lm.solve(prob, bal_lm.start_params(start, device),
                                    int(ctx.limits_meta.get("reference_lm_iterations", 40)))
    return prob, params, costs[-1]


def readings(ctx, state) -> dict:
    """``cost_excess``: each solve's cost, evaluated by the reference in
    float64 at the solve's cameras and points, above the reference's
    minimum, as a share of it; the worst solve counts."""
    dev = ctx.device
    prob, _, c_ref = reference_optimum(ctx, state.start, dev)
    worst = float("inf") if not state.results else 0.0
    for r in state.results:
        params = (bal_lm.quat_to_matrix(r["wxyz"].to(dev)), r["t"].to(dev), r["fkk"].to(dev),
                  r["X"].to(dev))
        c = float(bal_lm.cost(prob, params))
        worst = max(worst, (c - c_ref) / c_ref if np.isfinite(c) else float("inf"))
    return {"cost_excess": worst}


def control_outputs(ctx, state, dtype) -> None:
    """The control in the program's place: the reference's solve of the
    start in ``dtype``, the configuration's ``lm_iterations`` iterations;
    its result stands where each of the program's solves would."""
    dev = ctx.device
    prob = bal_lm.Problem(state.start, dev, dtype)
    params, _, _ = bal_lm.solve(prob, bal_lm.start_params(state.start, dev, dtype),
                                int(ctx.config["solve"]["lm_iterations"]))
    R, t, fkk, X = (a.double().cpu() for a in params)
    out = dict(wxyz=_matrix_to_quat(R), t=t, fkk=fkk, X=X)
    state.results = [out] * max(1, len(state.results))


def _matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[K, 3, 3] rotations -> [K, 4] (w, x, y, z); no camera here turns
    near 180 degrees, so w stays well above 0."""
    w = torch.sqrt(torch.clamp(1 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2], min=1e-12)) / 2
    return torch.stack([w, (R[:, 2, 1] - R[:, 1, 2]) / (4 * w),
                        (R[:, 0, 2] - R[:, 2, 0]) / (4 * w),
                        (R[:, 1, 0] - R[:, 0, 1]) / (4 * w)], -1)
