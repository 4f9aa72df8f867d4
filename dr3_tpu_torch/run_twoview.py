"""Two-view geometry runner of the port (the JAX package's
dr3_tpu/run_twoview.py; reference tests/test_twoview.cpp:4-22 +
tests/test_init_generalized.cpp:29-79).

    # F estimation + epipolar-line rendering on an image pair
    python -m dr3_tpu_torch.run_twoview left.png right.png --out epipolar.png

    # full SfM bootstrap (KITTI intrinsics by default): relative pose,
    # triangulated map, optional 3D point-cloud render
    python -m dr3_tpu_torch.run_twoview kitti0.png kitti4.png --init --map map.png

    # the plain versions on the CPU
    python -m dr3_tpu_torch.run_twoview left.png right.png --device cpu

``--device`` defaults to cuda and is never replaced silently: without a
card the run stops. One ``torch.Generator`` seeded from ``--seed`` draws
the F RANSAC's minimal sets and then the bootstrap's, so the bootstrap
scores fresh hypotheses (the JAX CLI hands one PRNG key to both, which
draws the same sets twice). The renderings need matplotlib; where it is not
installed the run says so on a line instead. Further ``--key=value`` flags
override Config fields.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("left")
    ap.add_argument("right")
    ap.add_argument("--out", default="epipolar.png",
                    help="epipolar-line rendering output")
    ap.add_argument("--init", action="store_true",
                    help="run the full two-view SfM bootstrap")
    ap.add_argument("--map", default=None,
                    help="with --init: render the triangulated cloud here")
    ap.add_argument("--fx", type=float, default=718.856)
    ap.add_argument("--fy", type=float, default=718.856)
    ap.add_argument("--cx", type=float, default=607.1928)
    ap.add_argument("--cy", type=float, default=185.2157)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def main(argv=None):
    args, unknown = _parser().parse_known_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_twoview: --device cuda but torch.cuda.is_available() is "
                         "False; pass --device cpu to run the plain versions")

    from dr3_tpu_torch.geometry.ransac import ransac_fundamental
    from dr3_tpu_torch.io.image import load_image, to_gray
    from dr3_tpu_torch.pipelines.stitch import find_correspondences
    from dr3_tpu_torch.utils.config import Config

    cfg = Config.from_cli(unknown)
    left = load_image(args.left)
    right = load_image(args.right)
    lg = torch.as_tensor(to_gray(left), device=device)
    rg = torch.as_tensor(to_gray(right), device=device)
    has_mpl = importlib.util.find_spec("matplotlib") is not None

    p1, p2, w = find_correspondences(lg, rg, cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    fr = ransac_fundamental(gen, p1, p2, w, n_samples=cfg.init_ransac_iters,
                            sigma=cfg.init_sigma)
    inl = fr.inliers.cpu().numpy()
    print(f"matches: {int(w.sum())}  F-inliers: {inl.sum()}")
    print("F =\n", fr.model.cpu().numpy())
    if has_mpl:
        from dr3_tpu_torch.viz.draw2d import draw_epipolar

        draw_epipolar(left, right, fr.model, p1.cpu().numpy()[inl], p2.cpu().numpy()[inl],
                      path=args.out)
        print("wrote", args.out)
    else:
        print(f"{args.out} not written: matplotlib is not installed")

    if args.init:
        from dr3_tpu_torch.pipelines.twoview_init import initialize_two_view

        K = torch.tensor([[args.fx, 0, args.cx],
                          [0, args.fy, args.cy],
                          [0, 0, 1.0]], dtype=torch.float32, device=device)
        res = initialize_two_view(gen, p1, p2, w > 0, K, cfg)
        R = res.T_cur_ref.rotation().matrix().cpu().numpy()
        t = res.T_cur_ref.t.cpu().numpy()
        print(f"bootstrap success: {bool(res.success)}  "
              f"triangulated: {int(res.n_good)}  "
              f"parallax: {float(res.parallax):.2f} deg")
        print("R =\n", R)
        print("t =", t)
        if args.map and not has_mpl:
            print(f"{args.map} not written: matplotlib is not installed")
        elif args.map:
            from dr3_tpu_torch.viz.draw3d import render_map

            good = res.good.cpu().numpy()
            traj = np.stack([np.zeros(3, np.float32), -R.T @ t]).astype(np.float32)
            render_map(traj, res.points.cpu().numpy()[good], path=args.map)
            print("wrote", args.map)
    return 0


if __name__ == "__main__":
    sys.exit(main())
