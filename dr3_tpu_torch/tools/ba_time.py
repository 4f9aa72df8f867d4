"""Time the port's bundle adjustment on the card, for whichever checkout of
dr3_tpu_torch is first on the path (so two checkouts can be timed in turns
in one call: ``PYTHONPATH=<checkout> python dr3_tpu_torch/tools/ba_time.py``;
run it by path, not with -m). Uses only entry points every checkout of the
port has: ``bundle_adjust`` by keyword, ``pose_only_adjust``,
``convert.ba_problem`` and ``MonoVO``.

* a window problem at the VO path's shape (32 keyframes x 546 track slots
  = 17,472 observations over a 16,384-point map, 2 gauge cameras, two
  thirds of the slots live), built from a seed in numpy: window BA as the
  VO runs it (pcg, 8 LM steps, cg_iters 64, cg_tol 1e-2, q_eta 0.1), host
  wall ms per call with its CG iterations; the cost of one CG iteration,
  from one LM step with the CG loop held to 17 and to 1 iterations
  (cg_tol 0, q_eta 0); the dense solves where the checkout has them;
* pose_only_adjust on one frame's 546 matches (the pose_optimizer's GN);
* with ``--vo``: MonoVO over 40 rendered 1240x376 frames with
  Config(loop_closure=False) (every checkout runs it): the Monitor's
  local_BA and pose_optimizer averages and the CG iterations;
* with ``--bal``: bench.py's BAL problem (120 cameras x 60,000 points x
  480,000 observations, :func:`bal_case`) through ``bal_to_snavely`` and
  ``bundle_adjust_snavely``: bench.py's ba_bal_lm_iters_per_sec for auto
  (zexplicit) and pcg (its default forcing, with the CG iterations) and
  peak device memory. ``--bal-only`` skips the window and VO timings.

Prints one JSON object (and writes it to ``--out``). Wall times include
the host: the CG loop reads one flag per iteration.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def window_case(seed: int = 0, n_cams: int = 32, n_slots: int = 546,
                n_points: int = 16384) -> dict:
    """BAProblem fields (numpy) of a sliding-window problem: cameras 0.25
    apart along x over a slab of points at depth 6-14, each camera
    observing up to ``n_slots`` of the points in its view (the rest of its
    slots padding), pixel noise 0.5, poses and points perturbed."""
    from dr3_tpu_torch.ba.problem import project
    from dr3_tpu_torch.geometry.lie import SE3

    rng = np.random.default_rng(seed)
    n_live = 4000
    span = 0.25 * n_cams
    pts = np.zeros((n_points, 3), np.float32)
    pts[:, 2] = 10.0
    pts[:n_live] = np.stack([rng.uniform(-3.0, span + 3.0, n_live), rng.uniform(-2, 2, n_live),
                             rng.uniform(6, 14, n_live)], -1)
    taus = np.zeros((n_cams, 6), np.float32)
    taus[:, 0] = -0.25 * np.arange(n_cams)
    cams = SE3.exp(torch.as_tensor(taus))
    obs_cam = np.repeat(np.arange(n_cams), n_slots).astype(np.int32)
    obs_pt = np.zeros(n_cams * n_slots, np.int32)
    w = np.zeros(n_cams * n_slots, np.float32)
    for k in range(n_cams):
        seen = np.nonzero(np.abs(pts[:n_live, 0] - 0.25 * k) < 0.35 * pts[:n_live, 2])[0]
        seen = rng.permutation(seen)[: (2 * n_slots) // 3]
        obs_pt[k * n_slots:k * n_slots + seen.size] = seen
        w[k * n_slots:k * n_slots + seen.size] = 1.0
    intr = np.asarray([718.856, 718.856, 607.1928, 185.2157], np.float32)
    xc = cams[torch.as_tensor(obs_cam).long()].apply(torch.as_tensor(pts)[obs_pt])
    uv = project(torch.as_tensor(intr), xc).numpy()
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.01, (n_cams, 3)), rng.normal(0, 0.002, (n_cams, 3))],
                       -1).astype(np.float32)
    d[:2] = 0.0
    cams0 = SE3.exp(torch.as_tensor(d)) @ cams
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    return dict(cam_wxyz=cams0.wxyz.numpy(), cam_t=cams0.t.numpy(),
                points=pts + rng.normal(0, 0.02, pts.shape).astype(np.float32),
                intrinsics=intr, obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv, obs_w=w,
                cam_fixed=fixed, dist=None)


def bal_case(n_cams: int = 120, n_pts: int = 60000, per_cam: int = 4000, seed: int = 0):
    """(perturbed, true) BALData of bench.py's BAL-scale problem
    (``_bench_bal_ba``, bench.py:171-203), drawn from
    ``np.random.default_rng(seed)`` in its order: points in a slab at
    depth 15-30 down -z, cameras 1000 px along x, each seeing a contiguous
    run of ``per_cam`` points, pixel noise 0.5, points perturbed by 0.05."""
    from dr3_tpu_torch.io.bal import BALData

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n_pts), rng.uniform(-6, 6, n_pts),
                    rng.uniform(-30, -15, n_pts)], 1)
    cam = np.zeros((n_cams, 9))
    cam[:, 3] = np.linspace(-8, 8, n_cams)
    cam[:, 6] = 1000.0
    oc = np.repeat(np.arange(n_cams), per_cam).astype(np.int32)
    op = np.concatenate([
        np.arange(int(k * (n_pts - per_cam) / (n_cams - 1)),
                  int(k * (n_pts - per_cam) / (n_cams - 1)) + per_cam)
        for k in range(n_cams)]).astype(np.int32)
    pc = pts[op] + cam[oc, 3:6]
    uv = -1000.0 * pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5, (len(oc), 2))
    return (BALData(cam, pts + rng.normal(0, 0.05, pts.shape), oc, op, uv),
            BALData(cam, pts, oc, op, uv))


def bal_lm_rate(prob, reps: int = 3, iters: int = 5, **kw):
    """bench.py's ba_bal_lm_iters_per_sec on ``prob``: a warm-up run, then
    ``reps`` runs of ``iters`` LM iterations (plain L2), each closed by a
    host read; (LM iterations/s, CG iterations a run)."""
    from dr3_tpu_torch.ba.snavely import bundle_adjust_snavely

    float(bundle_adjust_snavely(prob, iters, huber_delta=1e9, **kw).final_cost)
    t0, cg = time.perf_counter(), 0
    for _ in range(reps):
        r = bundle_adjust_snavely(prob, iters, huber_delta=1e9, **kw)
        float(r.final_cost)
        cg += r.cg_iters
    return reps * iters / (time.perf_counter() - t0), cg / reps


def wall_ms(fn, reps: int = 5):
    """Median host wall ms of fn() over ``reps`` calls after one warm-up,
    each closed by a synchronize; and fn()'s last result."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def vo_run(frames, cam):
    from dr3_tpu_torch.pipelines.vo import MonoVO
    from dr3_tpu_torch.utils.config import Config

    vo = MonoVO(cam, Config(loop_closure=False), device="cuda")
    for f in frames:
        vo.process(f)
    torch.cuda.synchronize()
    m = vo.monitor
    return {"local_BA_ms": 1e3 * m["local_BA"].average, "local_BA_calls": m["local_BA"].n,
            "pose_optimizer_ms": 1e3 * m["pose_optimizer"].average,
            "frame_step_ms": 1e3 * m["frame_step"].average,
            "cg_iters": vo.n_cg_iters, "window_ba": vo.n_window_ba}


def bal_times() -> dict:
    from dr3_tpu_torch.ba.snavely import bal_to_snavely, bundle_adjust_snavely

    prob = bal_to_snavely(bal_case()[0], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = bundle_adjust_snavely(prob, 5, huber_delta=1e9)
    out = {"shape": [prob.n_cams, prob.n_points, prob.n_obs],
           "final_cost": float(r.final_cost), "n_accepted": int(r.n_accepted),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    out["zexplicit_lm_iters_per_sec"], _ = bal_lm_rate(prob)
    out["pcg_lm_iters_per_sec"], out["pcg_cg_iters_per_run"] = bal_lm_rate(prob, solver="pcg")
    return out


def window_times(vo: bool) -> dict:
    from dr3_tpu_torch import convert
    from dr3_tpu_torch.ba.schur_lm import bundle_adjust, pose_only_adjust

    out = {}
    prob = convert.ba_problem(window_case(), device="cuda")
    vo_kw = dict(huber_delta=5.0, lambda0=1e-3, cg_iters=64, cg_tol=1e-2, q_eta=0.1)
    ms, res = wall_ms(lambda: bundle_adjust(prob, max_iters=8, solver="pcg", **vo_kw))
    out["window_pcg"] = {"ms": ms, "cg_iters": res.cg_iters,
                         "initial_cost": float(res.initial_cost),
                         "final_cost": float(res.final_cost)}
    step = {}
    for n in (1, 17):
        step[n], r = wall_ms(lambda n=n: bundle_adjust(prob, max_iters=1, solver="pcg",
                                                       huber_delta=5.0, lambda0=1e-3,
                                                       cg_iters=n, cg_tol=0.0, q_eta=0.0))
        if r.cg_iters != n:
            raise AssertionError(f"the CG loop ran {r.cg_iters} iterations, not {n}")
    out["cg_iteration_ms"] = (step[17] - step[1]) / 16
    out["lm_step_1_cg_ms"] = step[1]
    for solver in ("explicit", "zexplicit"):
        try:
            ms, res = wall_ms(lambda s=solver: bundle_adjust(prob, max_iters=8, solver=s,
                                                             huber_delta=5.0, lambda0=1e-3))
            out[f"window_{solver}"] = {"ms": ms, "final_cost": float(res.final_cost)}
        except NotImplementedError:
            out[f"window_{solver}"] = None
    frame = convert.ba_problem(window_case(n_cams=1), device="cuda")
    frame = frame._replace(cam_fixed=torch.zeros_like(frame.cam_fixed))
    out["pose_only_ms"], _ = wall_ms(lambda: pose_only_adjust(frame, 10, 5.0), reps=20)
    if vo:
        from dr3_tpu_torch.models.camera import Pinhole
        from dr3_tpu_torch.utils.synth import lateral_path, make_textures, render_scene

        cam = Pinhole.kitti()
        tn, tf = make_textures(np.random.default_rng(0), size=2000)
        poses, _ = lateral_path(40, 0.08)
        out["vo"] = vo_run([render_scene(cam, T, tn, tf) for T in poses], cam)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vo", action="store_true", help="also time the VO slice's local_BA")
    ap.add_argument("--bal", action="store_true", help="also time BAL-scale Snavely LM")
    ap.add_argument("--bal-only", action="store_true", help="time only the BAL LM")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ba_time: needs a CUDA device")
    import dr3_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"package": dr3_tpu_torch.__file__, "card": card}
    if args.bal or args.bal_only:
        out["bal"] = bal_times()
    if not args.bal_only:
        out.update(window_times(args.vo))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
