"""K1's time on the card through its public wrappers, at the VO path's shapes.

    PYTHONPATH=<checkout> python <checkout>/dr3_tpu_torch/tools/k1_time.py \
        [--iters N] [--eps E] [--out FILE]

Renders two 1240x376 frames with KITTI intrinsics, builds their 4-level
pyramids, detects frame 0's track slots (546 at this size) and times
``lk.track_pyramid`` (W=15, ``--iters`` GN steps, ``--eps``) and
``lk.align_to_templates`` (W=9 x 8 from its result) on the card: device
time per call from torch.profiler over 100 back-to-back calls (all device
work of the call, and K1's kernels alone, by :data:`K1_KERNELS`), and
host-inclusive time per call (CUDA events, median of 20 runs of 10 calls).
Each call is first held against the same call on CPU tensors (the plain
version): |d pos| < 1e-2 px where both are ok and, at Config's steps and
eps, >= 80% of the valid tracks ok in both. Prints one JSON object, and
writes it to FILE if given.

It reaches the port only through its public entry points, which have kept
their signatures since the first slice, so this file can time another
checkout's package: put that checkout first on PYTHONPATH (a parent
commit unpacked with git archive, say) and run it in turns with this
one in one call, as the K1 rows of PERF.md were taken.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.profiler

from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.ops import corners, lk, pyramid
from dr3_tpu_torch.utils.config import Config
from dr3_tpu_torch.utils.synth import lateral_path, make_textures, render_scene

# K1's __global__ functions, this one's and the first slice's
K1_KERNELS = ("lk_pyramid_kernel", "lk_track_kernel", "lk_align_kernel")


def device_us(fn, n=100):
    """(all device us, K1 kernels' device us) per call over n calls. Its
    own copy of tools/cudatime.py's profiler sum: an earlier checkout,
    which this file may be timing, has no tools package."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = k1 = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = float(e.self_cuda_time_total if us is None else us)
            total += us
            k1 += us if any(k in e.key for k in K1_KERNELS) else 0.0
    return total / n, k1 / n


def host_us(fn, reps=20, n=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        per.append(1e3 * start.elapsed_time(end) / n)
    return statistics.median(per)


def check(tag, got, want, valid, share=0.8):
    got = [t.cpu() for t in got]
    nv = int(valid.sum())
    ok_g, ok_w = int(got[1].sum()), int(want[1].sum())
    if not (ok_g >= share * nv and ok_w >= share * nv):
        raise AssertionError(f"{tag}: ok {ok_g} / plain {ok_w} of {nv}")
    both = got[1] & want[1]
    err = float((got[0] - want[0])[both].abs().max())
    if not err < 1e-2:
        raise AssertionError(f"{tag}: max |d pos| {err}")
    return {"ok": ok_g, "plain_ok": ok_w, "max_abs_err": err}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=None, help="GN steps per level (Config's)")
    ap.add_argument("--eps", type=float, default=None, help="freeze threshold (Config's)")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_time: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = Config(loop_closure=False)
    iters = cfg.klt_iters if args.iters is None else args.iters
    eps = cfg.klt_eps if args.eps is None else args.eps
    half, thalf = cfg.klt_window // 2, (cfg.feature_align_patch - 1) // 2

    cam = Pinhole.kitti()
    tn, tf = make_textures(np.random.default_rng(0), size=2000)
    poses, _ = lateral_path(2, 0.08)
    pyrs = {}
    for dev in ("cpu", "cuda"):
        frames = [torch.as_tensor(render_scene(cam, T, tn, tf), device=dev) for T in poses]
        pyrs[dev] = [pyramid.build_pyramid(f, cfg.klt_levels) for f in frames]
    feats = corners.detect_features(pyrs["cpu"][0][:cfg.n_pyr_levels], cfg.cell_size,
                                    cfg.min_corner_score, cfg.fast_threshold)
    cpu = dict(pts=feats.xy.contiguous(), valid=feats.valid.contiguous(),
               tmpl=lk.extract_patches(pyrs["cpu"][0][0], feats.xy, thalf).contiguous())
    pts, valid, tmpl = (cpu[k].to("cuda") for k in ("pts", "valid", "tmpl"))
    pyr0, pyr1 = pyrs["cuda"]
    track = lambda: lk.track_pyramid(pyr0, pyr1, pts, valid, half_window=half,  # noqa: E731
                                     iters=iters, eps=eps)
    res = track()
    pos, ok_in = res.pos.contiguous(), (res.ok & valid).contiguous()
    align = lambda: lk.align_to_templates(pyr1[0], tmpl, pos, ok_in,  # noqa: E731
                                          iters=cfg.feature_align_iters)
    # the plain versions on the CPU; the alignment from the card's tracks,
    # so that both refine the same start
    want = lk.track_pyramid(*pyrs["cpu"], cpu["pts"], cpu["valid"], half_window=half,
                            iters=iters, eps=eps)
    want_a = lk.align_to_templates(pyrs["cpu"][1][0], cpu["tmpl"], pos.cpu(), ok_in.cpu(),
                                   iters=cfg.feature_align_iters)
    share = 0.8 if (iters, eps) == (cfg.klt_iters, cfg.klt_eps) else 0.0
    checks = {"pyramid": check("track_pyramid", res, want, cpu["valid"], share),
              "align": check("align_to_templates", align(), want_a, ok_in.cpu(), share)}

    (pyr_dev, pyr_k1), (al_dev, al_k1) = device_us(track), device_us(align)
    result = {"card": card, "n_tracks": int(pts.shape[0]), "levels": len(pyr0),
              "iters": iters, "eps": eps,
              "pyramid_device_us": pyr_dev, "pyramid_k1_us": pyr_k1,
              "pyramid_host_us": host_us(track), "align_device_us": al_dev,
              "align_k1_us": al_k1, "align_host_us": host_us(align), "checks": checks}
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
