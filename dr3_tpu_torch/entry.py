"""The system's two driver entry points on the port (counterpart of the
repository's root ``__graft_entry__.py``).

* :func:`entry` — the single-card forward step of the flagship model: the
  monocular VO tracking front end (pyramid -> pyramidal LK (kernel K1) ->
  motion-only pose Gauss-Newton) on KITTI-sized frames, with its seeded
  example inputs. The step is capturable as one CUDA graph
  (:func:`graph_step`, ``utils/cudagraph.StepGraph``).
* :func:`dryrun_multichip` — one step of the point-sharded distributed
  Schur-complement BA on tiny shapes, on the flat mesh and on the 2-level
  [hosts, points] mesh, then the whole ``MonoVO`` with the mesh attached
  against one device. In one process ``n`` point shards share one device;
  under torchrun each rank holds its shards on its own card (NCCL) or on
  the CPU (gloo).

    python -m dr3_tpu_torch.entry [--device cpu]
    torchrun --nproc-per-node 4 -m dr3_tpu_torch.entry

Entry points run on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

from dr3_tpu_torch.utils.device import resolve as resolve_device

N_TRACKS = 546  # ceil(1240 / 30) * ceil(376 / 30) grid cells


def _frontend(device=None):
    """The VO front-end step and its example args, drawn from
    ``np.random.default_rng(0)`` in the JAX package's order (so the numpy
    arrays are bit-equal) and moved to ``device`` (default the card)."""
    from dr3_tpu_torch.ba.problem import make_problem
    from dr3_tpu_torch.ba.schur_lm import pose_only_adjust
    from dr3_tpu_torch.geometry.lie import SE3
    from dr3_tpu_torch.models.camera import Pinhole
    from dr3_tpu_torch.ops import lk, pyramid
    from dr3_tpu_torch.utils.config import Config

    dev = resolve_device(device, "entry")
    cfg = Config()
    cam = Pinhole.kitti(device=dev)
    intr = cam.intrinsics

    def step(pyr_prev, img_cur, track_px, track_valid, track_point,
             map_xyz, map_valid, pose_wxyz, pose_t):
        """One VO tracking step: track all features into the new frame and
        re-optimise the camera pose against the map. Takes the previous
        frame's pyramid and returns the current one for chaining:
        (pyr_cur, pos, valid, wxyz, t, final_cost)."""
        pyr_cur = tuple(pyramid.build_pyramid(img_cur, cfg.klt_levels))
        res = lk.track_pyramid(list(pyr_prev), list(pyr_cur), track_px, track_valid,
                               half_window=cfg.klt_window // 2, iters=cfg.klt_iters,
                               eps=cfg.klt_eps)
        valid = track_valid & res.ok
        has_pt = valid & (track_point >= 0)
        pt_idx = torch.clamp(track_point, min=0)
        w = (has_pt & map_valid[pt_idx.long()]).to(torch.float32)
        prob = make_problem(
            cams=SE3(pose_wxyz[None], pose_t[None]), points=map_xyz, intrinsics=intr,
            obs_cam=torch.zeros_like(track_point), obs_pt=pt_idx, obs_uv=res.pos,
            obs_w=w, cam_fixed=torch.zeros((1,), dtype=torch.bool, device=map_xyz.device))
        ba = pose_only_adjust(prob, 10, cfg.ba_huber_delta)
        return (pyr_cur, res.pos, valid, ba.problem.cam_wxyz[0], ba.problem.cam_t[0],
                ba.final_cost)

    rng = np.random.default_rng(0)
    h, w = cam.height, cam.width

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    img_prev = put(rng.uniform(0, 1, (h, w)).astype(np.float32))
    pyr_prev = tuple(pyramid.build_pyramid(img_prev, cfg.klt_levels))
    img_cur = put(rng.uniform(0, 1, (h, w)).astype(np.float32))
    track_px = put(rng.uniform([20, 20], [w - 20, h - 20], (N_TRACKS, 2)).astype(np.float32))
    track_valid = torch.ones((N_TRACKS,), dtype=torch.bool, device=dev)
    track_point = torch.arange(N_TRACKS, dtype=torch.int32, device=dev)
    map_xyz = put(np.stack([rng.uniform(-5, 5, 2048), rng.uniform(-2, 2, 2048),
                            rng.uniform(4, 30, 2048)], -1).astype(np.float32))
    map_valid = torch.ones((2048,), dtype=torch.bool, device=dev)
    pose_wxyz = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    pose_t = torch.zeros((3,), dtype=torch.float32, device=dev)

    args = (pyr_prev, img_cur, track_px, track_valid, track_point,
            map_xyz, map_valid, pose_wxyz, pose_t)
    return step, args


def entry(device=None):
    """(step, args): the VO front-end step and its nine example inputs
    (module docstring); ``step(*args)`` returns (pyr_cur, pos, valid,
    wxyz, t, final_cost)."""
    return _frontend(device)


def graph_step(step, n_levels: int):
    """``step`` over a flat tuple of tensors, as ``StepGraph`` captures it:
    (*pyr_prev, img_cur, track_px, track_valid, track_point, map_xyz,
    map_valid, pose_wxyz, pose_t) -> (*pyr_cur, pos, valid, wxyz, t,
    final_cost)."""
    def flat(*x):
        pyr, *out = step(tuple(x[:n_levels]), *x[n_levels:])
        return (*pyr, *out)

    return flat


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Distributed-BA steps over an ``n_devices``-shard mesh on tiny
    shapes — both the flat [points] mesh and the 2-level [hosts, points]
    mesh (partial reduced systems summed within a host, then across hosts;
    SURVEY §7 config 5) — then :func:`_dryrun_vo_with_mesh`. Joins the
    process group from torchrun's environment (a no-op in one process)."""
    import torch.distributed as dist

    from dr3_tpu_torch.ba.problem import make_problem, project
    from dr3_tpu_torch.geometry.lie import SE3
    from dr3_tpu_torch.parallel.dist_ba import dist_bundle_adjust
    from dr3_tpu_torch.parallel.mesh import distributed_init, make_mesh, make_mesh_2d

    if not (dist.is_available() and dist.is_initialized()):
        distributed_init(device=device)  # no-op single-process; honours torchrun's env
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device

    rng = np.random.default_rng(0)
    n_cams, n_pts = 4, 8 * n_devices
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0])
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(6, 12, n_pts)], -1).astype(np.float32)
    taus = np.zeros((n_cams, 6), np.float32)
    taus[:, 0] = 0.3 * np.arange(n_cams)
    cams = SE3.exp(torch.as_tensor(taus))
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    xc = cams[torch.as_tensor(obs_cam).long()].apply(torch.as_tensor(pts)[obs_pt])
    uv = project(intr, xc).numpy()
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)

    # perturb and solve one LM step distributed over the mesh
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    prob = make_problem(SE3(cams.wxyz.to(dev), cams.t.to(dev)), torch.as_tensor(pts0).to(dev),
                        intr.to(dev), torch.as_tensor(obs_cam).to(dev),
                        torch.as_tensor(obs_pt).to(dev), torch.as_tensor(uv).to(dev))
    res = dist_bundle_adjust(prob, max_iters=1, mesh=mesh)
    final = float(res.final_cost)
    initial = float(res.initial_cost)
    if not np.isfinite(final):
        raise AssertionError("distributed BA produced non-finite cost")
    if final > initial:
        raise AssertionError(f"one LM step must not increase cost ({initial} -> {final})")
    print(f"dryrun_multichip({n_devices}): cost {initial:.3f} -> {final:.3f} OK", flush=True)

    # 2-level [hosts, points] mesh: the same step, the shards summed within
    # a host, then across hosts; must agree with the flat mesh. In one
    # process the hosts are 2 virtual ones; across ranks a host is a rank.
    if n_devices >= 2 and n_devices % 2 == 0:
        n_hosts = 2 if mesh.world == 1 else mesh.world
        mesh2 = make_mesh_2d(n_hosts=n_hosts, n_devices=n_devices, device=device)
        res2 = dist_bundle_adjust(prob, max_iters=1, mesh=mesh2)
        final2 = float(res2.final_cost)
        if not np.isfinite(final2):
            raise AssertionError("2-level mesh produced non-finite cost")
        if abs(final2 - final) > 1e-2 * max(abs(final), 1.0):
            raise AssertionError(f"2-level mesh cost {final2} against flat {final}")
        print(f"dryrun_multichip 2-level mesh ({n_hosts}x{n_devices // n_hosts}): "
              f"cost {float(res2.initial_cost):.3f} -> {final2:.3f} OK", flush=True)

    _dryrun_vo_with_mesh(mesh, n_devices)


def _dryrun_vo_with_mesh(mesh, n_devices: int) -> None:
    """Drive the whole MonoVO with the mesh attached (the window BA
    map-sharded under MonoVO) for a bootstrap, general frames and at
    least one general keyframe on a small rendered scene, and check the
    distributed trajectory against one device."""
    from dr3_tpu_torch.models.camera import Pinhole
    from dr3_tpu_torch.pipelines.vo import MonoVO, Stage
    from dr3_tpu_torch.utils.config import Config
    from dr3_tpu_torch.utils.synth import NpSE3, make_textures, render_scene

    rng = np.random.default_rng(0)
    w, h = 240, 180
    f = 0.875 * w
    host_cam = SimpleNamespace(width=w, height=h, fx=f, fy=f, cx=w / 2.0, cy=h / 2.0)
    cam = Pinhole.create(w, h, f, f, w / 2.0, h / 2.0)
    tn, tf = make_textures(rng, size=800)
    frames = []
    for i in range(14):
        tau = np.asarray([-0.09 * i, 0.0, 0.0, 0.0, 0.01 * i, 0.0], np.float32)
        frames.append(np.asarray(render_scene(host_cam, NpSE3.exp(tau), tn, tf)))

    cfg = Config(init_min_features=40, init_min_tracked=40, init_min_triangulated=25,
                 init_min_disparity=2.0, kf_disparity=8.0, max_keyframes=8,
                 frames_per_dispatch=4)
    vo_s = MonoVO(cam, cfg, device=mesh.device)
    vo_m = MonoVO(cam, cfg, mesh=mesh, device=mesh.device)
    for img in frames:
        vo_s.process(img)
    vo_m.process_batch(frames)
    if vo_m.stage is not Stage.GENERAL:
        raise AssertionError(f"mesh-attached driver ends in {vo_m.stage}")
    # the port has no scan program (the JAX package asserts its
    # "scan_dispatch" timer here): the witness is that the window BA ran
    # as the mesh-distributed solve, which a mesh-attached driver always
    # takes and which runs no CG iteration
    if vo_m.n_window_ba < 1 or vo_m.n_cg_iters != 0:
        raise AssertionError(f"mesh-attached driver: {vo_m.n_window_ba} window BAs, "
                             f"{vo_m.n_cg_iters} CG iterations (want >= 1 distributed)")
    n_kf = sum(1 for s in vo_m.stats if s.is_keyframe)
    if n_kf < 3:
        raise AssertionError(f"expected bootstrap + general keyframes, got {n_kf}")
    p_s, p_m = vo_s.positions(), vo_m.positions()
    np.testing.assert_allclose(p_m, p_s, atol=5e-3)
    print(f"dryrun_multichip VO-with-mesh ({n_devices} shards): {len(frames)} frames, "
          f"{n_kf} keyframes, {vo_m.n_window_ba} distributed window BAs, trajectory == "
          f"single-device (max |d| = {np.abs(p_m - p_s).max():.2e}) OK", flush=True)


def main(argv=None) -> int:
    """The step once, then :func:`dryrun_multichip` over the ranks (under
    torchrun) or over the cards of one process."""
    import torch.distributed as dist

    from dr3_tpu_torch.parallel.mesh import distributed_init

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    joined = distributed_init(device=args.device)
    try:
        step, step_args = entry(device=args.device)
        out = step(*step_args)
        print("entry() run OK; cost =", float(out[-1]), flush=True)
        if joined:
            n = dist.get_world_size()
        elif torch.device(args.device).type == "cuda":
            n = min(8, torch.cuda.device_count())
        else:
            n = 1
        dryrun_multichip(n, device=args.device)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
