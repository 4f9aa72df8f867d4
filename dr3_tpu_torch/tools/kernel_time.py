"""The kernels' time on the card through the public entry points, at the
VO path's and the panorama path's shapes.

    PYTHONPATH=<checkout> python <checkout>/dr3_tpu_torch/tools/kernel_time.py \
        [--only vo|k4] [--iters N] [--eps E] [--out FILE]

VO (K1, K2, sparse alignment, K3): renders two 1240x376 frames with KITTI
intrinsics, builds their 4-level pyramids, detects frame 0's track slots
(546 at this size), places them on the rendered scene's planes and times:

* ``lk.track_pyramid`` (W=15, ``--iters`` GN steps, ``--eps``) and
  ``lk.align_to_templates`` (W=9 x 8 from its result);
* ``lk.sample_patches`` (K2 alone): 5x5 patches at the slots on frame 1's
  level 2, as chip_smoke.py times it;
* ``sparse_align`` of frame 0 into frame 1 on level 2 (W=5, 12 LM steps)
  from the reference pose, as the VO step calls it;
* ``corner_response`` on the 1240x376 level and ``corner_response_pyramid``
  on the three detection levels, as ``detect_features`` asks for them.

Panorama (K4, ``ops/warp.py``), on seeded noise images, whose values do not
change the work:

* ``warp_perspective`` of a 480x640x3 view onto a 480x2110 canvas shifted by
  630.04 px (the TRANSLATE panorama's paste of its 4th view, 8 views 210 px
  apart) and of a 376x1240x3 view onto the 439x1463 canvas of views 0-1 of
  the HOMOGRAPHY case (KITTI intrinsics, 0.15 rad), with the count of their
  tiles that the kernel writes as fill without sampling, by the kernel's own
  test (``tools/warp_tiles.kernel_shortcut_tiles``);
* ``warp_spherical`` and ``warp_cylindrical`` of a 480x640x3 view, f 600;
* ``remap_xy`` over 352 border-clamped 16x16 patches on a 480x640 image (the
  descriptor patches) and over 1 sample (the launch's fixed cost);
* ``remap_rows`` / ``remap_cols`` at 376x1240 over smooth fields.

For each: device time per call from torch.profiler over back-to-back calls
(all device work of the call, and the hand-written kernels alone, by
:data:`KERNELS`), the device kernels per call, the events the profiler saw
an uneven number of times (tools/cudatime.py), and host-inclusive time per
call (CUDA events, median of runs of 10 calls). Prints one JSON object
with the tracks, pose and corner counts found, and writes it to FILE if
given. chip_smoke.py holds each of these kernels against its plain version;
this file only times them.

It reaches the kernels only through their public wrappers, so it can time
another checkout's package: put that checkout first on PYTHONPATH (a copy
with a constant of csrc/ edited, or a parent commit unpacked with git
archive, with a shim for what it lacks) and run it in turns with this one
in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from dr3_tpu_torch.geometry.lie import SE3
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.ops import corners, lk, pyramid, warp
from dr3_tpu_torch.ops.sparse_align import sparse_align
from dr3_tpu_torch.tools import warp_tiles
from dr3_tpu_torch.tools.cudatime import cuda_ms, per_launch, whole_window
from dr3_tpu_torch.utils import synth
from dr3_tpu_torch.utils.config import Config

# the hand-written __global__ functions these calls may launch
KERNELS = ("lk_pyramid_kernel", "lk_align_kernel", "sparse_align_kernel",
           "sample_patches_kernel", "corner_response_kernel", "warp_homography_kernel",
           "warp_spherical_kernel", "warp_cylindrical_kernel", "remap_xy_kernel",
           "remap_rows_kernel", "remap_cols_kernel")


def timed(fn, n: int, reps: int) -> dict:
    """All device us, the hand-written kernels' device us and the device
    kernels per call of fn() over one profiler window of n calls, and its
    host-inclusive us per call."""
    for _ in range(3):
        fn()
    events, odd = whole_window(fn, n)
    own = per_launch(events, {k: k for k in KERNELS})
    return {"device_us": sum(us for _, us in events.values()) / n,
            "kernel_us": sum(count * us for count, us in own.values()) / n,
            "device_kernels": sum(count for count, _ in events.values()) / n,
            "uneven": odd, "host_us": 1e3 * cuda_ms(fn, reps=reps)}


def vo_times(cfg, iters, eps, dev) -> dict:
    half, thalf = cfg.klt_window // 2, (cfg.feature_align_patch - 1) // 2
    cam = Pinhole.kitti()
    tn, tf = synth.make_textures(np.random.default_rng(0), size=2000)
    poses, _ = synth.lateral_path(2, 0.08)
    frames = [torch.as_tensor(synth.render_scene(cam, T, tn, tf), device=dev) for T in poses]
    pyr0, pyr1 = (pyramid.build_pyramid(f, cfg.klt_levels) for f in frames)
    det = pyr0[:cfg.n_pyr_levels]
    feats = corners.detect_features(det, cfg.cell_size, cfg.min_corner_score,
                                    cfg.fast_threshold)
    pts, valid = feats.xy.contiguous(), feats.valid.contiguous()

    def track():
        return lk.track_pyramid(pyr0, pyr1, pts, valid, half_window=half, iters=iters, eps=eps)

    res = track()
    tmpl = lk.extract_patches(pyr0[0], pts, thalf).contiguous()
    pos, ok_in = res.pos.contiguous(), (res.ok & valid).contiguous()

    def align():
        return lk.align_to_templates(pyr1[0], tmpl, pos, ok_in, iters=cfg.feature_align_iters)

    # frame 0 stands at the world origin: its corners on the scene's planes
    world = torch.as_tensor(synth.scene_points(cam, poses[0], pts.cpu().numpy()), device=dev)
    ident, kitti, lvl = SE3.identity(device=dev), cam.to(dev), cfg.align_level

    def sparse():
        return sparse_align(pyr0[lvl], pyr1[lvl], ident, ident, kitti, world, valid,
                            level=lvl, half_patch=cfg.align_half_patch, iters=cfg.align_iters)

    centers = (pts / 4.0 + 0.37).contiguous()

    def patches():
        return lk.sample_patches(pyr1[lvl], centers, cfg.align_half_patch)

    def one_level():
        return corners.corner_response(det[0], cfg.fast_threshold)

    def levels():
        return corners.corner_response_pyramid(det, cfg.fast_threshold)

    sres = sparse()
    return {
        "n_tracks": int(pts.shape[0]), "levels": len(pyr0), "iters": iters, "eps": eps,
        "tracks_ok": int(res.ok.sum()), "aligned_ok": int(align().ok.sum()),
        "n_used": int(sres.n_used), "pose_t": sres.T.t.tolist(), "cost0": float(sres.cost0),
        "cost": float(sres.cost), "corners": [int((r > 0).sum()) for r in levels()],
        "track_pyramid": timed(track, 100, 20),
        "align_to_templates": timed(align, 100, 20),
        "sparse_align": timed(sparse, 20, 5),
        "sample_patches": timed(patches, 100, 20),
        "corner_response": timed(one_level, 100, 20),
        "corner_response_pyramid": timed(levels, 100, 20),
    }


def _pair_canvas(H, w, h):
    """(T @ H, canvas (h, w)) of a view warped through H onto the canvas of
    itself and the view it is aligned to, as chip_smoke.py builds it."""
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64).T
    t = H @ c
    xs = np.concatenate([t[0] / t[2], [0, w]])
    ys = np.concatenate([t[1] / t[2], [0, h]])
    T = np.eye(3)
    T[0, 2], T[1, 2] = -np.floor(xs.min()), -np.floor(ys.min())
    return ((T @ H).astype(np.float32),
            (int(np.ceil(ys.max()) - np.floor(ys.min())),
             int(np.ceil(xs.max()) - np.floor(xs.min()))))


def k4_times(dev) -> dict:
    rng = np.random.default_rng(5)
    view = torch.as_tensor(rng.uniform(0, 1, (480, 640, 3)).astype(np.float32), device=dev)
    kview = torch.as_tensor(rng.uniform(0, 1, (376, 1240, 3)).astype(np.float32), device=dev)
    gray = torch.as_tensor(rng.uniform(0, 1, (376, 1240)).astype(np.float32), device=dev)
    pgray = torch.as_tensor(rng.uniform(0, 1, (480, 640)).astype(np.float32), device=dev)
    paste = np.asarray([[1.0, 0.0, 630.04], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    paste_hw = (480, 2110)
    cam = Pinhole.kitti()
    pair, pair_hw = _pair_canvas(
        synth.sphere_homography(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), 0.15),
        cam.width, cam.height)
    centres = np.stack([rng.uniform(8, 632, 352), rng.uniform(8, 472, 352)], -1)
    off = np.arange(16, dtype=np.float32) - 8 + 0.5
    oy, ox = np.meshgrid(off, off, indexing="ij")
    coords = torch.as_tensor((centres[:, None, None, :] + np.stack([ox, oy], -1)[None])
                             .astype(np.float32), device=dev)
    one = coords[:1, :1, :1].contiguous()
    gy, gx = torch.meshgrid(torch.arange(376, dtype=torch.float32, device=dev),
                            torch.arange(1240, dtype=torch.float32, device=dev), indexing="ij")
    v = (gy + 6.0 * torch.sin(gx / 40.0) + 2.5).contiguous()
    u = (gx + 5.0 * torch.cos(gy / 25.0) - 3.25).contiguous()
    share = {}
    for name, M, src, hw in (("paste", paste, view, paste_hw), ("pair", pair, kview, pair_hw)):
        tiles = warp_tiles.kernel_shortcut_tiles(warp.homography_inverse(M),
                                                 tuple(src.shape[:2]), hw)
        share[name] = {"tiles": int(tiles.size), "shortcut": int(tiles.sum())}
    return {
        "paste_hw": paste_hw, "pair_hw": pair_hw, "shortcut_tiles": share,
        "warp_perspective_paste": timed(lambda: warp.warp_perspective(view, paste, paste_hw),
                                        100, 20),
        "warp_perspective_pair": timed(lambda: warp.warp_perspective(kview, pair, pair_hw),
                                       100, 20),
        "warp_spherical": timed(lambda: warp.warp_spherical(view, 600.0), 100, 20),
        "warp_cylindrical": timed(lambda: warp.warp_cylindrical(view, 600.0), 100, 20),
        "remap_xy": timed(lambda: warp.remap_xy(pgray, coords, clamp=True), 100, 20),
        "remap_xy_one": timed(lambda: warp.remap_xy(pgray, one, clamp=True), 100, 20),
        "remap_rows": timed(lambda: warp.remap_rows(gray, v), 100, 20),
        "remap_cols": timed(lambda: warp.remap_cols(gray, u), 100, 20),
        # what writing the warped image alone costs on this card: PyTorch's
        # fill of a tensor of the paste's and the spherical warp's shape
        "fill_paste": timed(lambda: torch.empty(paste_hw + (3,), device=dev).fill_(0.5),
                            100, 20),
        "fill_spherical": timed(lambda: torch.empty((480, 640, 3), device=dev).fill_(0.5),
                                100, 20),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", choices=("vo", "k4"), default=None,
                    help="time only the VO kernels or only K4 (default: both)")
    ap.add_argument("--iters", type=int, default=None, help="K1's GN steps per level (Config's)")
    ap.add_argument("--eps", type=float, default=None, help="K1's freeze threshold (Config's)")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_time: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = Config(loop_closure=False)
    iters = cfg.klt_iters if args.iters is None else args.iters
    eps = cfg.klt_eps if args.eps is None else args.eps
    dev = torch.device("cuda")
    result = {"card": card}
    if args.only in (None, "vo"):
        result.update(vo_times(cfg, iters, eps, dev))
    if args.only in (None, "k4"):
        result.update(k4_times(dev))
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
