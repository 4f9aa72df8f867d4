"""Export a real-structure BAL problem from a VO run and solve it with the
exact Snavely adjuster (the port's copy of tools/make_real_bal.py).

The forward corridor (continuously novel content, so the keyframe database
keeps growing) runs through ``MonoVO``; the loop database and the map are
flattened into the global-BA observation table
(``pipelines/loop_closure.global_ba_problem``, the reference's
src/optimizer.cpp:29-41 layout), compacted and written as a BAL file; the
file is loaded back, converted to the 9-parameter Snavely objective and
solved with pcg, explicit and zexplicit, whose final costs must agree. The
co-visibility graph, point depths and observation sparsity are what a SLAM
map produces, not a uniform random draw.

    python dr3_tpu_torch/tools/make_real_bal.py --frames 420 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export_bal(vo, path: str):
    """Write ``vo``'s loop database + map as a compact BAL file: only the
    valid cameras, the weight > 0 observations and the points seen at least
    twice (a BAL file carries no masks), pixels recentred on the principal
    point (the Snavely model has no cx, cy). Returns the BALData written."""
    from dr3_tpu_torch.io.bal import problem_to_bal, save_bal
    from dr3_tpu_torch.pipelines import loop_closure as lc

    prob = lc.global_ba_problem(vo.loop_db, vo.map, vo.intr, vo.cam.dist)
    prob = prob._replace(**{k: v.cpu() for k, v in prob._asdict().items() if v is not None})
    w, oc, op = prob.obs_w.numpy(), prob.obs_cam.numpy(), prob.obs_pt.numpy()
    keep = w > 0
    # points need >= 2 observations to be constrained in a standalone file
    cnt = np.bincount(op[keep], minlength=prob.n_points)
    keep &= cnt[op] >= 2
    cam_used = np.zeros(prob.n_cams, bool)
    cam_used[oc[keep]] = True
    pt_used = np.zeros(prob.n_points, bool)
    pt_used[op[keep]] = True
    cam_map = np.cumsum(cam_used) - 1
    pt_map = np.cumsum(pt_used) - 1
    intr = prob.intrinsics.numpy()
    cu, pu, kp = (torch.as_tensor(m) for m in (cam_used, pt_used, keep))
    sub = prob._replace(
        cam_wxyz=prob.cam_wxyz[cu], cam_t=prob.cam_t[cu], points=prob.points[pu],
        intrinsics=torch.tensor([intr[0], intr[1], 0.0, 0.0], dtype=torch.float32),
        obs_cam=torch.as_tensor(cam_map[oc[keep]].astype(np.int32)),
        obs_pt=torch.as_tensor(pt_map[op[keep]].astype(np.int32)),
        obs_uv=prob.obs_uv[kp] - torch.as_tensor(intr[None, 2:4]),
        obs_w=torch.ones(int(keep.sum())), cam_fixed=prob.cam_fixed[cu])
    d = problem_to_bal(sub)
    save_bal(path, d)
    return d


def corridor_frames(n_frames: int, width: int, height: int, seed: int = 11):
    """(camera intrinsics dict, frames) of the forward corridor, as the JAX
    package's tools/run_long_sequence.make_sequence(profile="forward")."""
    from types import SimpleNamespace

    from scipy import ndimage

    from dr3_tpu_torch.utils.synth import corridor_path, make_textures, render_corridor

    f = 0.875 * width
    intr = dict(width=width, height=height, fx=f, fy=f, cx=width / 2.0, cy=height / 2.0)
    tex_g, tex_w = make_textures(np.random.default_rng(seed), size=800)
    tex_g = ndimage.gaussian_filter(tex_g, 1.5)
    tex_w = ndimage.gaussian_filter(tex_w, 1.5)
    poses, _ = corridor_path(n_frames)
    cam = SimpleNamespace(**intr)
    return intr, [render_corridor(cam, T, tex_g, tex_w, px_per_unit=28.0) for T in poses]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--width", type=int, default=1240)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "real_structure.bal"))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    from dr3_tpu_torch.ba.snavely import bal_to_snavely, bundle_adjust_snavely
    from dr3_tpu_torch.io.bal import load_bal
    from dr3_tpu_torch.models.camera import Pinhole
    from dr3_tpu_torch.pipelines.vo import MonoVO
    from dr3_tpu_torch.utils.config import Config
    from dr3_tpu_torch.utils.device import resolve

    device = resolve(args.device, "make_real_bal")
    intr, frames = corridor_frames(args.frames, args.width, args.height)
    cam = Pinhole.create(intr["width"], intr["height"], intr["fx"], intr["fy"], intr["cx"],
                         intr["cy"], device=device)
    cfg = Config(fast_threshold=8.0, init_min_features=60, init_min_tracked=50,
                 init_min_triangulated=30, init_min_disparity=2.0, kf_disparity=12.0,
                 cell_size=20,  # a denser corner grid: the export wants landmark count
                 loop_closure=True, loop_db_capacity=256,
                 loop_min_gap_frames=10 ** 9,  # the database only archives: no closure
                 # rewrites, so the exported problem keeps the raw drift
                 frames_per_dispatch=16)
    vo = MonoVO(cam, cfg, device=device)
    t0 = time.perf_counter()
    vo.process_batch(frames)
    dt = time.perf_counter() - t0
    if vo.db_cursor < 3:
        print(json.dumps({"error": "VO produced too few keyframes", "keyframes": vo.kf_count,
                          "db": vo.db_cursor}))
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    d = export_bal(vo, args.out)

    # round trip: load the file and solve the exact objective with each path;
    # the comparison is between SOLVERS, so pcg runs near-exact (cg_tol 1e-5,
    # q_eta 0), the loose default forcing needing more outer iterations
    sp = bal_to_snavely(load_bal(args.out), device=device)
    res_p = bundle_adjust_snavely(sp, args.iters, huber_delta=2.0, solver="pcg", cg_iters=200,
                                  cg_tol=1e-5, q_eta=0.0)
    cp0, cp1 = float(res_p.initial_cost), float(res_p.final_cost)
    ce1 = float(bundle_adjust_snavely(sp, args.iters, huber_delta=2.0,
                                      solver="explicit").final_cost)
    cz1 = float(bundle_adjust_snavely(sp, args.iters, huber_delta=2.0,
                                      solver="zexplicit").final_cost)
    n_obs = d.obs_cam.shape[0]
    print(json.dumps({
        "frames": args.frames, "vo_fps": args.frames / dt, "bal_file": args.out,
        "device": str(device), "n_cams": int(d.cam_params.shape[0]),
        "n_points": int(d.points.shape[0]), "n_obs": int(n_obs), "cost_initial": cp0,
        "cost_final_pcg": cp1, "cost_final_explicit": ce1, "cost_final_zexplicit": cz1,
        "cost_per_obs_final": cp1 / max(n_obs, 1),
        "paths_agree_pct": 100.0 * max(abs(cp1 - ce1), abs(cz1 - ce1)) / max(cp1, 1e-9)}))
    ok = (np.isfinite(cp1) and cp1 <= cp0 and abs(cp1 - ce1) <= 0.05 * max(cp1, 1e-9)
          and abs(cz1 - ce1) <= 0.05 * max(cp1, 1e-9))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
