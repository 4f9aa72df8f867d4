"""Monocular SLAM runner of the port (the JAX package's dr3_tpu/run_slam.py;
reference tests/slam/test_slam.cc + tests/test_pipeline.cpp + scripts/slam.sh).

    python -m dr3_tpu_torch.run_slam --seq /path/to/kitti/00 --out results/
    python -m dr3_tpu_torch.run_slam --seq ... --checkpoint-every 100
    python -m dr3_tpu_torch.run_slam --seq ... --resume results/checkpoint
    python -m dr3_tpu_torch.run_slam --seq ... --device cpu     # plain versions

Writes the trajectory (TUM format), the map rendering PNG (where
matplotlib is installed; the run says so where it is not), a checkpoint
every ``--checkpoint-every`` frames and a final one, and prints the
per-frame lines, the per-stage Monitor report (SLAM::pprint parity) and
the decoder that read the frames (the port's native one where it builds
against libpng and libjpeg, else PIL).
``--device`` defaults to cuda and is never replaced silently: without a
card the run stops. ``--resume`` loads a checkpoint (of either package)
and continues with the frame after it. Further ``--key=value`` flags
override Config fields. ``--distributed`` shards the window BA's points
over a mesh (parallel/dist_ba.py): in one process one shard on the
device; under torchrun one rank per card, a [hosts, points] mesh over the
group (``torchrun --nproc-per-node=<cards> -m dr3_tpu_torch.run_slam
--distributed ...``), each rank running the whole VO and writing its
outputs under ``<out>/rank<r>`` past rank 0. Batching is off with a mesh.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seq", default=None,
                    help="KITTI odometry sequence dir (image_0/ + times.txt)")
    ap.add_argument("--out", default="results")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="shard the window BA's points over a mesh (one rank per card "
                         "under torchrun)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default=None, help="checkpoint path to resume")
    ap.add_argument("--loop-closure", action="store_true",
                    help="(the default; kept for compatibility)")
    ap.add_argument("--no-loop-closure", action="store_true",
                    help="disable place recognition + pose-graph closure")
    ap.add_argument("--global-ba", action="store_true",
                    help="offline global BA over all keyframes after the run "
                         "(implies loop closure)")
    ap.add_argument("--batch", type=int, default=16,
                    help="frames per upload (MonoVO.process_batch); 1 = per-frame "
                         "process with per-frame stats printing")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def _print_stats(stats) -> None:
    for s in stats:
        print(f"[{s.frame_id:05d}] {s.stage:<10} tracked={s.n_tracked:4d} "
              f"inliers={s.n_inliers:4d} kf={int(s.is_keyframe)} map={s.n_map_points}",
              flush=True)


def write_tum(path: str, trajectory, times=None) -> None:
    """Trajectory in TUM format (timestamp cx cy cz qx qy qz qw): the camera
    centre and the rotation R^T of each world->frame matrix."""
    from dr3_tpu_torch.geometry.lie import matrix_to_quat

    times = times if times is not None else np.arange(len(trajectory))
    with open(path, "w") as f:
        for t, T in zip(times, trajectory):
            R = T[:3, :3]
            c = -R.T @ T[:3, 3]
            q = matrix_to_quat(torch.as_tensor(np.ascontiguousarray(R.T))).numpy()
            f.write(f"{t:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def run(vo, frames, args, out_dir: str, times=None):
    """The loop of :func:`main` without the decoder: ``frames`` (an iterable
    of [H, W] frames) through ``vo`` — in chunks of 4 x ``--batch`` frames
    through ``process_batch``, or frame by frame with ``--batch 1`` — a
    checkpoint every ``--checkpoint-every`` frames of the sequence, the
    global BA with ``--global-ba``, the report, ``trajectory.txt``,
    ``slam_map.png`` and ``final``. ``times`` stamps the trajectory (frame
    numbers without it). Returns ``vo``."""
    from dr3_tpu_torch.io.checkpoint import save_vo
    from dr3_tpu_torch.viz.draw3d import render_vo

    os.makedirs(out_dir, exist_ok=True)
    batched = args.batch > 1 and vo.mesh is None
    chunk: list = []

    def flush_chunk():
        if chunk:
            n0 = len(vo.stats)
            vo.process_batch(chunk)
            _print_stats(vo.stats[n0:])
            chunk.clear()

    for frame in frames:
        if batched:
            chunk.append(frame)
            if len(chunk) >= 4 * args.batch:
                flush_chunk()
        else:
            vo.process(frame)
            _print_stats(vo.stats[-1:])
        i = vo.frame_idx + len(chunk)          # the frame's index in the sequence
        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            flush_chunk()
            save_vo(os.path.join(out_dir, "checkpoint"), vo)
    flush_chunk()

    if args.global_ba:
        costs = vo.global_refine()
        if costs is not None:
            print(f"global BA: cost {costs[0]:.3f} -> {costs[1]:.3f}")
        else:
            print("global BA skipped: fewer than 3 keyframes in the database")

    print(vo.report())
    traj_path = os.path.join(out_dir, "trajectory.txt")
    write_tum(traj_path, vo.trajectory, times)
    print("wrote", traj_path)
    if importlib.util.find_spec("matplotlib") is None:
        print("slam_map.png not written: matplotlib is not installed")
    else:
        print("wrote", render_vo(vo, os.path.join(out_dir, "slam_map.png")))
    save_vo(os.path.join(out_dir, "final"), vo)
    print("wrote", os.path.join(out_dir, "final.npz"))
    return vo


def main(argv=None):
    args, unknown = _parser().parse_known_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_slam: --device cuda but torch.cuda.is_available() is "
                         "False; pass --device cpu to run the plain versions")

    from dr3_tpu_torch.parallel.mesh import distributed_init, make_mesh, make_mesh_2d

    # multi-process launch contract (torchrun's; no-op in one process)
    distributed_init(device=device)
    mesh, out_dir = None, args.out
    if args.distributed:
        import torch.distributed as dist

        # a [hosts, points] mesh when several ranks take part (each rank's
        # shards summed, then one reduction across ranks); one shard alone
        multi = dist.is_initialized() and dist.get_world_size() > 1
        mesh = make_mesh_2d(device=device) if multi else make_mesh(device=device)
        device = mesh.device                  # an NCCL rank's own card
        if mesh.rank > 0:
            out_dir = os.path.join(args.out, f"rank{mesh.rank}")

    from dr3_tpu_torch.io.kitti import KittiSequence, open_fixture_sequence, open_sequence
    from dr3_tpu_torch.pipelines.vo import MonoVO
    from dr3_tpu_torch.utils.config import Config

    cfg = Config.from_cli(unknown)  # --cell_size=30 style overrides
    if args.loop_closure or args.global_ba:
        cfg = cfg.replace(loop_closure=True)
    if args.no_loop_closure and not args.global_ba:
        cfg = cfg.replace(loop_closure=False)
    cfg = cfg.replace(frames_per_dispatch=args.batch)
    seq = open_sequence(args.seq) if args.seq else open_fixture_sequence()
    vo = MonoVO(seq.cam, cfg, mesh=mesh, device=device)
    start = 0
    if args.resume:
        from dr3_tpu_torch.io.checkpoint import load_vo

        load_vo(args.resume, vo)
        start = vo.frame_idx + 1
    stop = args.max_frames if args.max_frames else len(seq)
    todo = KittiSequence(seq.image_paths[start:stop], cam=seq.cam)
    print(f"run_slam: frames {start}..{max(start, stop) - 1} of {len(seq)} on {device}"
          + ("" if mesh is None else f", window BA over a {'x'.join(map(str, mesh.shape))} "
             f"point-shard mesh (rank {mesh.rank} of {mesh.world})"), flush=True)
    run(vo, todo, args, out_dir, seq.times)
    print(f"decoder: {todo.decoder or 'none (no frame to decode)'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
