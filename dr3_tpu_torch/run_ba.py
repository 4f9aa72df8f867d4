"""Offline bundle adjustment over BAL problem files (port of
dr3_tpu/run_ba.py; reference Ceres BAL adjuster, tests/ceres/ba.cc:21-167).

    python -m dr3_tpu_torch.run_ba problem.bal --iters 30 --out refined.bal \\
        --render cloud.png
    python -m dr3_tpu_torch.run_ba problem.bal --device cpu     # plain torch on the CPU

Reads Snavely's BAL text format and solves it with the Schur-complement LM.
Two camera models:

* ``--model snavely`` (default): the exact 9-parameter BAL objective,
  per-camera focal + k1/k2 radial (ba/snavely.py), cost-comparable with
  Ceres on the same file (reference ba.cc:105-118);
* ``--model pinhole``: the lossy conversion to the shared-intrinsics
  pinhole problem (median focal, radial dropped), the reference's in-repo
  OptProblem layout (src/optimizer.cpp:29-41); ``--optimize-intrinsics``
  also solves the shared (fx, fy, cx, cy) block (src/optimizer.cpp:144-153).

``--solver auto`` takes the exact square-root dense Schur while its dense
factor fits, and matrix-free PCG with the SCHUR_JACOBI preconditioner
beyond. ``--device`` defaults to cuda and is never replaced silently:
without a card the run stops.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time

import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("bal", help="BAL problem file")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--model", choices=("snavely", "pinhole"), default="snavely")
    ap.add_argument("--huber", type=float, default=0.0,
                    help="Huber scale in pixels (0 = plain L2, Ceres-default parity; the "
                         "reference BA has no robust loss)")
    ap.add_argument("--optimize-intrinsics", action="store_true",
                    help="pinhole model: solve the shared 4-param intrinsics block too")
    ap.add_argument("--solver", choices=("auto", "explicit", "zexplicit", "pcg"),
                    default="auto")
    ap.add_argument("--out", default=None, help="write refined BAL here")
    ap.add_argument("--render", default=None,
                    help="render refined cloud + camera centres to this PNG")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_ba: --device cuda but torch.cuda.is_available() is False; "
                         "pass --device cpu to run the plain versions")

    from dr3_tpu_torch.parallel.mesh import distributed_init

    distributed_init(device=device)  # multi-process launch contract (no-op in one process)

    from dr3_tpu_torch.io.bal import load_bal, save_bal

    data = load_bal(args.bal)
    huber = args.huber if args.huber > 0 else 1e9

    if args.model == "snavely":
        from dr3_tpu_torch.ba.snavely import (bal_to_snavely, bundle_adjust_snavely,
                                              snavely_to_bal)

        prob = bal_to_snavely(data, device=device)
        print(f"loaded {prob.n_cams} cams, {prob.n_points} points, {prob.n_obs} "
              f"observations from {args.bal} (snavely model)")
        t0 = time.perf_counter()
        res = bundle_adjust_snavely(prob, args.iters, huber_delta=huber, solver=args.solver)
        to_bal = snavely_to_bal
    else:
        from dr3_tpu_torch.ba.schur_lm import bundle_adjust
        from dr3_tpu_torch.io.bal import bal_to_problem, problem_to_bal

        prob = bal_to_problem(data, device=device)
        print(f"loaded {prob.n_cams} cams, {prob.n_points} points, {prob.n_obs} "
              f"observations from {args.bal} (pinhole model)")
        t0 = time.perf_counter()
        res = bundle_adjust(prob, args.iters, huber_delta=huber,
                            optimize_intrinsics=args.optimize_intrinsics, solver=args.solver)
        to_bal = problem_to_bal
    final = float(res.final_cost)           # the host read ends the timed run
    dt = time.perf_counter() - t0
    print(f"cost: {float(res.initial_cost):.6g} -> {final:.6g} "
          f"({int(res.n_accepted)}/{args.iters} steps accepted, {dt:.2f}s incl. first-call "
          f"setup, {args.iters / dt:.1f} LM iters/s) on {device}")

    if args.out:
        save_bal(args.out, to_bal(res.problem))
        print(f"wrote {args.out}")
    if args.render:
        if importlib.util.find_spec("matplotlib") is None:
            print(f"{args.render} not written: matplotlib is not installed")
        else:
            from dr3_tpu_torch.geometry.lie import SE3
            from dr3_tpu_torch.viz.draw3d import render_map

            centers = SE3(res.problem.cam_wxyz, res.problem.cam_t).inverse().t
            render_map(centers.cpu().numpy(), res.problem.points.cpu().numpy(),
                       path=args.render)
            print(f"wrote {args.render}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
