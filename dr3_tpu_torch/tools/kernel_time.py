"""K1's, sparse alignment's and K3's time on the card through the public
entry points, at the VO path's shapes.

    PYTHONPATH=<checkout> python <checkout>/dr3_tpu_torch/tools/kernel_time.py \
        [--iters N] [--eps E] [--out FILE]

Renders two 1240x376 frames with KITTI intrinsics, builds their 4-level
pyramids, detects frame 0's track slots (546 at this size), places them on
the rendered scene's planes and times, on the card:

* ``lk.track_pyramid`` (W=15, ``--iters`` GN steps, ``--eps``) and
  ``lk.align_to_templates`` (W=9 x 8 from its result);
* ``sparse_align`` of frame 0 into frame 1 on level 2 (W=5, 12 LM steps)
  from the reference pose, as the VO step calls it;
* ``corner_response`` on the 1240x376 level and ``corner_response_pyramid``
  on the three detection levels, as ``detect_features`` asks for them.

For each: device time per call from torch.profiler over back-to-back calls
(all device work of the call, and the hand-written kernels alone, by
:data:`KERNELS`), the device kernels per call, the events the profiler saw
an uneven number of times (tools/cudatime.py), and host-inclusive time per
call (CUDA events, median of runs of 10 calls). Prints one JSON object
with the tracks, pose and corner counts found, and writes it to FILE if
given. chip_smoke.py holds each of these kernels against its plain version;
this file only times them.

It reaches the port only through its public entry points, so it can time
another checkout's package: put that checkout first on PYTHONPATH (a parent
commit unpacked with git archive, or a copy with a constant of csrc/
edited) and run it in turns with this one in one call.
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
from dr3_tpu_torch.ops import corners, lk, pyramid
from dr3_tpu_torch.ops.sparse_align import sparse_align
from dr3_tpu_torch.tools.cudatime import cuda_ms, per_launch, whole_window
from dr3_tpu_torch.utils import synth
from dr3_tpu_torch.utils.config import Config

# the hand-written __global__ functions these calls may launch
KERNELS = ("lk_pyramid_kernel", "lk_align_kernel", "sparse_align_kernel",
           "sample_patches_kernel", "corner_response_kernel")


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
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
    half, thalf = cfg.klt_window // 2, (cfg.feature_align_patch - 1) // 2
    dev = torch.device("cuda")
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

    def one_level():
        return corners.corner_response(det[0], cfg.fast_threshold)

    def levels():
        return corners.corner_response_pyramid(det, cfg.fast_threshold)

    sres = sparse()
    result = {
        "card": card, "n_tracks": int(pts.shape[0]), "levels": len(pyr0), "iters": iters,
        "eps": eps, "tracks_ok": int(res.ok.sum()), "aligned_ok": int(align().ok.sum()),
        "n_used": int(sres.n_used), "pose_t": sres.T.t.tolist(), "cost0": float(sres.cost0),
        "cost": float(sres.cost), "corners": [int((r > 0).sum()) for r in levels()],
        "track_pyramid": timed(track, 100, 20),
        "align_to_templates": timed(align, 100, 20),
        "sparse_align": timed(sparse, 20, 5),
        "corner_response": timed(one_level, 100, 20),
        "corner_response_pyramid": timed(levels, 100, 20),
    }
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
