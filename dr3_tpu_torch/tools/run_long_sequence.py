"""Full-pipeline evidence run of the port: a LONG synthetic sequence with
ground truth (the port's copy of tools/run_long_sequence.py).

The north-star metric (BASELINE.md) is "frames/sec/chip on KITTI seq-00 at
reference ATE". Without the dataset, this tool renders a 500+-frame
sequence with exact ground truth (dr3_tpu_torch/utils/synth.py, numpy) and
runs the complete ``MonoVO`` over it: detection, tracking, sparse
alignment, pose optimisation, keyframing, triangulation, window BA, map
compaction, loop closure with the loop database's ring compaction, and
relocalisation. It reports the pipeline's frames/s after a warm-up (every
keyframe stage included), the Sim(3) ATE against the ground truth and the
long-horizon counters.

    python -m dr3_tpu_torch.tools.run_long_sequence --frames 500 [--kitti-res]
    python -m dr3_tpu_torch.tools.run_long_sequence --device cpu   # plain versions

``--device`` defaults to cuda and raises without a card. Further
``--key=value`` flags override fields of the run's ``Config`` (as in
``run_slam``), e.g. ``--max_points=2048`` for a smaller map capacity. The
last line of stdout is one JSON object with the JAX tool's keys; the line
before it gives the loop database's ring compactions and, on the card, its
name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_sequence(n_frames: int, width: int, height: int, rng, profile: str = "lateral"):
    """(camera, ground-truth world->cam poses (NpSE3), frames [H, W] float32).

    ``profile``:
    * ``lateral`` — out-and-back sweeps (a period of 100 frames, so later
      periods revisit the content of the first: loop closure) with a gentle
      yaw wobble: maximal-parallax geometry;
    * ``forward`` — KITTI-like forward driving down an endless textured
      corridor with S-curve turns and one rotation-only segment (zero
      parallax while it lasts).

    The same draws and arithmetic as the JAX tool's ``make_sequence``, so
    a seed gives the same frames bit for bit. Frames render on a pool of
    threads (numpy releases the GIL in the renderer's array operations),
    each frame alone, so the pool changes no bit."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy import ndimage

    from dr3_tpu_torch.models.camera import Pinhole
    from dr3_tpu_torch.utils.synth import (NpSE3, corridor_path, make_textures,
                                           render_corridor, render_scene)

    f = 0.875 * width
    # one dict of plain floats feeds both the camera and the renderer's view
    intr = dict(width=width, height=height, fx=f, fy=f, cx=width / 2.0, cy=height / 2.0)
    cam = Pinhole.create(intr["width"], intr["height"], intr["fx"], intr["fy"],
                         intr["cx"], intr["cy"])
    host_cam = SimpleNamespace(**intr)

    def render_all(render, poses):
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            return list(pool.map(render, poses))

    if profile == "forward":
        tex_g, tex_w = make_textures(rng, size=800)
        # soften the tile so far-field texture near the focus of expansion
        # stays resolvable instead of aliasing into noise
        tex_g = ndimage.gaussian_filter(tex_g, 1.5)
        tex_w = ndimage.gaussian_filter(tex_w, 1.5)
        poses, _ = corridor_path(n_frames)
        frames = render_all(lambda T: render_corridor(host_cam, T, tex_g, tex_w,
                                                      px_per_unit=28.0), poses)
        return cam, poses, frames

    tex_near, tex_far = make_textures(rng)
    period, amp = 100, 1.4
    poses = []
    for i in range(n_frames):
        phase = 2.0 * np.pi * i / period
        x = amp * 0.5 * (1.0 - np.cos(phase))      # 0 -> amp -> 0 sweep
        y = 0.08 * np.sin(2.0 * phase)
        yaw = 0.02 * np.sin(phase)
        poses.append(NpSE3.exp(np.asarray([-x, -y, 0.0, 0.0, yaw, 0.0], np.float32)))
    frames = render_all(lambda T: render_scene(host_cam, T, tex_near, tex_far), poses)
    return cam, poses, frames


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--kitti-res", action="store_true", help="render at 1240x376 (slower)")
    ap.add_argument("--profile", choices=("lateral", "forward"), default="lateral",
                    help="motion profile: lateral out-and-back sweeps (max parallax) or "
                         "KITTI-like forward driving with turns + a rotation-only stress "
                         "segment")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--distributed", action="store_true",
                    help="shard the window BA's points over a mesh (one rank per card "
                         "under torchrun)")
    ap.add_argument("--no-loop", action="store_true",
                    help="disable loop closure (debug/ablation)")
    ap.add_argument("--no-sparse-align", action="store_true",
                    help="disable SVO sparse image alignment (on by default here so the "
                         "evidence run exercises every flagship stage)")
    ap.add_argument("--no-fused", action="store_true",
                    help="eager per-stage launches instead of one CUDA graph per general "
                         "frame")
    ap.add_argument("--batch", type=int, default=8,
                    help="frames per upload (MonoVO.process_batch); 1 = per-frame "
                         "process")
    ap.add_argument("--sync", action="store_true",
                    help="synchronise the card after every frame and print its line "
                         "(localises an asynchronous fault to its frame)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return f"not read: nvidia-smi failed ({e})"
    return out.strip().splitlines()[0]


def run(args, overrides=(), on_step=None):
    """The run of :func:`main` on parsed ``args`` and the ``--key=value``
    Config ``overrides``; returns (vo, the JSON line's dict).
    ``on_step(vo)`` is called after every frame (every ``--batch`` frames
    in a batched run)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_long_sequence: --device cuda but torch.cuda.is_available() "
                         "is False; pass --device cpu to run the plain versions")
    if args.kitti_res:
        args.width, args.height = 1240, 376

    from dr3_tpu_torch.parallel.mesh import distributed_init, make_mesh, make_mesh_2d
    from dr3_tpu_torch.pipelines.vo import MonoVO
    from dr3_tpu_torch.utils.config import Config
    from dr3_tpu_torch.viz.ate import ate_rmse

    parsed = Config.from_cli(list(overrides))       # unknown keys raise here
    over = {k: getattr(parsed, k)
            for k in (a[2:].partition("=")[0].replace("-", "_") for a in overrides)}

    # multi-process launch contract (torchrun's; no-op in one process)
    distributed_init(device=device)
    mesh = None
    if args.distributed:
        import torch.distributed as dist

        multi = dist.is_initialized() and dist.get_world_size() > 1
        mesh = make_mesh_2d(device=device) if multi else make_mesh(device=device)
        device = mesh.device                  # an NCCL rank's own card

    rng = np.random.default_rng(args.seed)
    print(f"rendering {args.frames} {args.profile} frames at {args.width}x{args.height}...",
          flush=True)
    cam, poses, frames = make_sequence(args.frames, args.width, args.height, rng,
                                       profile=args.profile)

    # forward profile: ~1/3 of corners sit in the aliased far field near
    # the focus of expansion and die early — the init gate must tolerate it
    min_tracked = 50 if args.profile == "forward" else 60
    cfg = Config(
        fast_threshold=8.0,
        init_min_features=60, init_min_tracked=min_tracked,
        init_min_triangulated=30, init_min_disparity=2.0,
        kf_disparity=12.0,
        max_points=8192,            # the JAX tool's capacity; at 1240x376 a
                                    # keyframe adds ~6 points (--max_points)
        loop_closure=not args.no_loop, loop_db_capacity=64,
        loop_min_gap_frames=60, loop_min_score=0.6,
        loop_min_inliers=20, loop_cooldown_kfs=4,
        fused_frontend=not args.no_fused,
        use_sparse_align=not args.no_sparse_align,
        frames_per_dispatch=args.batch,
    )
    cfg = cfg.replace(**over)
    vo = MonoVO(cam, cfg, mesh=mesh, device=device)

    def sync():
        if vo.device.type == "cuda":
            torch.cuda.synchronize(vo.device)

    warm = min(40, args.frames // 4)
    batched = args.batch > 1 and not args.sync and not args.no_fused and mesh is None

    def drive(lo, hi):
        if batched:
            for s in range(lo, hi, args.batch):
                vo.process_batch(frames[s:min(s + args.batch, hi)])
                if on_step is not None:
                    on_step(vo)
            return
        for i in range(lo, hi):
            vo.process(frames[i])
            if args.sync:
                sync()
                print(f"frame {i} ok (kf={vo.kf_count})", flush=True)
            if on_step is not None:
                on_step(vo)

    sync()
    t_all0 = time.perf_counter()
    drive(0, warm)
    sync()
    t0 = time.perf_counter()
    drive(warm, args.frames)
    sync()
    dt = time.perf_counter() - t0
    dt_all = time.perf_counter() - t_all0
    fps = (args.frames - warm) / dt

    gt = np.stack([p.center() for p in poses])
    est = vo.positions()
    moving = np.nonzero(np.linalg.norm(est, axis=1) > 1e-9)[0]
    i0 = max(int(moving[0]) - 1, 0) if moving.size else 0
    a = ate_rmse(est[i0:], gt[i0:], with_scale=True)
    traj_len = float(np.linalg.norm(np.diff(gt[i0:], axis=0), axis=1).sum())
    out = {
        "frames": args.frames,
        "resolution": f"{args.width}x{args.height}",
        "pipeline_frames_per_sec": fps,
        "wall_clock_total_s": dt_all,
        "ate_rmse": float(a.rmse),
        "ate_pct_of_trajectory": 100.0 * float(a.rmse) / traj_len,
        "trajectory_length": traj_len,
        "keyframes": vo.kf_count,
        "map_compactions": vo.n_compactions,
        "loop_closures": vo.n_loop_closures,
        "relocalizations": vo.n_relocalizations,
        "distributed": bool(mesh),
        "frames_per_dispatch": args.batch if batched else 1,
    }
    return vo, out


def main(argv=None, on_step=None) -> int:
    """Parse ``argv``, run, print the report and the JSON line; returns 0.
    ``on_step`` as in :func:`run`."""
    sys.path.insert(0, ROOT)
    ap = _parser()
    args, unknown = ap.parse_known_args(argv)
    if any(not a.startswith("--") for a in unknown):
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    vo, out = run(args, unknown, on_step)
    print(vo.report())
    card = card_name() if vo.device.type == "cuda" else "none (the CPU's plain versions)"
    print(f"long sequence: {vo.n_db_compactions} loop-database ring compactions, "
          f"{sum(s.is_keyframe for s in vo.stats)} keyframes made; card: {card}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
