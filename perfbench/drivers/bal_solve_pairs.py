"""Driver ``bal_solve_pairs``: ``bal_solve``'s back-to-back BAL solves on
route-shaped problems too large for the dense reference.

The solve, the late read of each solve's cost, the traced solve and the
results' trip to the host are ``perfbench/drivers/bal_solve.py``'s own,
imported. What differs:

* the problems are drawn by ``perfbench/gen/bal_route.py`` from the seed
  (cameras along a route, each point seen by the cameras around it), and
  the window solves a new draw each time: the matrix-free solve's CG
  iterations, and so its time, swing from one draw to the next, so that
  one draw a run would make the run's rate that draw's. Set-up draws as
  many as the window can solve: the benchmark's window (``run_seconds`` in
  ``BENCHMARK.json``) over the time of the warm-up solve, which is the
  first draw's and no faster than the later ones, and one more; a window
  that solves more goes round them again;
* each solve is judged by ``perfbench/reference/bal_lm_pairs.py``, whose
  reduced camera system is summed from pairs of observations, where
  ``bal_lm``'s dense W would not fit on the card;
* the program's own counts: the CG iterations of every solve of the window
  (``SnavelyResult.cg_iters``) and the host reads of the traced solve.
"""

from __future__ import annotations

import gc
import json
import math
import os
from collections import deque
from types import SimpleNamespace

import numpy as np

from perfbench.drivers import bal_solve
from perfbench.drivers.bal_solve import PROGRAM  # noqa: F401
from perfbench.gen import bal_route
from perfbench.reference import bal_lm, bal_lm_pairs
from perfbench.vo_common import now


def _window_s() -> float:
    """The benchmark's window, ``run_seconds``, from the ``BENCHMARK.json``
    of this checkout."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, os.pardir, os.pardir, "BENCHMARK.json")) as f:
        return float(json.load(f)["run_seconds"])


def setup(ctx):
    c = ctx.config["problem"]
    p = ctx.program
    cg_iters = []
    solve = p.bundle_adjust_snavely

    def counted(*args, **kw):
        res = solve(*args, **kw)
        cg_iters.append(int(getattr(res, "cg_iters", 0)))
        return res

    ctx.program = SimpleNamespace(**dict(vars(p), bundle_adjust_snavely=counted))

    def draw(k):
        s = bal_route.route_case(c["cameras"], c["points"], c["observations"], (ctx.seed, k))[0]
        return s, p.bal_to_snavely(p.BALData(s["cam_params"], s["points"], s["obs_cam"],
                                             s["obs_pt"], s["obs_uv"]), device=ctx.device)

    start, prob = draw(0)
    starts, probs = [start], [prob]
    # every draw has the same shapes: the first one's solves warm them all up
    warm = int(ctx.traffic["warmup_solves"])
    t = now()
    for _ in range(warm):
        float(bal_solve._solve(ctx, prob).final_cost)
    n = 1 + math.ceil(_window_s() * warm / (now() - t))
    for k in range(1, n):
        s, prob = draw(k)
        starts.append(s)
        probs.append(prob)
    ctx.log(f"set-up: {n} draws for a {_window_s():g} s window")
    return SimpleNamespace(starts=starts, probs=probs, prob=probs[0], outputs=[], solved=[],
                           cg_iters=cg_iters, traced={})


def window(state, ctx, seconds: float) -> dict:
    """``bal_solve.window`` over the draws in turn: solves are sent
    ``solves_ahead`` ahead of the one whose cost is read; when the time is
    up nothing more is sent, every solve sent is read, and the clock is
    read after that. Python's collector is off in the window."""
    iters = int(ctx.config["solve"]["lm_iterations"])
    ahead = int(ctx.traffic["solves_ahead"])
    pending = deque()
    enq, done = [], []
    state.cg_iters.clear()

    def read_one():
        k, res, read = pending.popleft()
        read()                                       # the read that ends the solve
        done.append(now())
        state.outputs.append(res.problem)
        state.solved.append(k)

    gc.collect()
    gc.disable()
    try:
        ctx.sync()
        t0 = now()
        while now() - t0 < seconds:
            k = len(enq) % len(state.probs)
            ts = now()
            res = bal_solve._solve(ctx, state.probs[k])
            pending.append((k, res, bal_solve._late_read(ctx, res)))
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
    ctx.log(f"window: {n} solves of {len(state.probs)} draws, {ahead} ahead; between reads "
            f"s p50 {np.median(solve_s):.4f} max {solve_s.max():.4f}; sending a solve s p50 "
            f"{np.median(enq):.4f} max {max(enq):.4f}; CG iterations a solve {state.cg_iters}")
    return dict(metrics={"bal_lm_iters_per_s": n * iters / (t1 - t0)},
                attempted=n, failed=0,
                obs=dict(solves=n, lm_iterations=iters, cg_iters=sum(state.cg_iters),
                         traced=state.traced))


def trace_slice(state, ctx) -> None:
    """``bal_solve.trace_slice`` (one solve of the first problem), its host
    reads counted."""
    with ctx.count_syncs() as reads:
        bal_solve.trace_slice(state, ctx)
    state.traced["host_reads"] = reads.count


def finish(state) -> None:
    """``bal_solve.finish``, and the problems freed."""
    bal_solve.finish(state)
    state.probs = None


def reference_optimum(ctx, start, device):
    """The reference's solve of a start, run past the program's iteration
    count so that it ends at the minimum."""
    prob = bal_lm.Problem(start, device)
    params, costs, _ = bal_lm_pairs.solve(
        prob, bal_lm.start_params(start, device),
        int(ctx.limits_meta.get("reference_lm_iterations", 40)))
    ctx.log(f"reference: cost {costs[0]:.6g} -> {costs[-1]:.6g}, the last 5 iterations "
            f"lowered it by {costs[-6] - costs[-1]:.3g}")
    return prob, params, costs[-1]


def readings(ctx, state) -> dict:
    """``cost_excess`` as ``bal_solve`` reads it: each solve's cost,
    evaluated in float64 at the solve's cameras and points, above the
    reference's minimum of its problem, as a share of it; the worst solve
    counts."""
    dev = ctx.device
    worst = float("inf") if not state.results else 0.0
    for k in sorted(set(state.solved)):
        prob, _, c_ref = reference_optimum(ctx, state.starts[k], dev)
        for r, which in zip(state.results, state.solved):
            if which != k:
                continue
            params = (bal_lm.quat_to_matrix(r["wxyz"].to(dev)), r["t"].to(dev),
                      r["fkk"].to(dev), r["X"].to(dev))
            c = float(bal_lm.cost(prob, params))
            worst = max(worst, (c - c_ref) / c_ref if np.isfinite(c) else float("inf"))
    return {"cost_excess": worst}


def control_outputs(ctx, state, dtype) -> None:
    """The control in the program's place: the pair-summed reference's
    solve of each start in ``dtype``, the configuration's ``lm_iterations``
    iterations; its result stands where each of the program's solves of
    that problem would."""
    dev = ctx.device
    out = {}
    for k in sorted(set(state.solved)):
        prob = bal_lm.Problem(state.starts[k], dev, dtype)
        params, _, _ = bal_lm_pairs.solve(
            prob, bal_lm.start_params(state.starts[k], dev, dtype),
            int(ctx.config["solve"]["lm_iterations"]))
        R, t, fkk, X = (a.double().cpu() for a in params)
        out[k] = dict(wxyz=bal_solve._matrix_to_quat(R), t=t, fkk=fkk, X=X)
    state.results = [out[k] for k in state.solved]
