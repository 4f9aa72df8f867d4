"""What the two VO drivers share: the frames, the program's set-up and
warm-up, and the judgement of its trajectory and map against the truth."""

from __future__ import annotations

import time

import numpy as np

from perfbench import kernel_bounds
from perfbench.gen import render
from perfbench.reference import trajectory, window_ba


class Sequence:
    """One rendered period of the path, replayed cyclically: frame k of the
    stream is frame k mod period, and so is its true pose."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        img = config["image"]
        self.cam = render.camera(img["width"], img["height"], img["focal_over_width"])
        path = traffic["path"]
        self.period = int(path["period"])
        poses, frames = render.lateral_sequence(self.period, self.cam,
                                                np.random.default_rng(seed), path)
        self.frames = [render.to_uint8(f) for f in frames]
        self.true_R = np.stack([p.R for p in poses])
        self.true_c = np.stack([(-p.R.T @ p.t) for p in poses])

    def frame(self, k: int) -> np.ndarray:
        return self.frames[k % self.period]

    def chunk(self, k: int, n: int) -> list:
        return [self.frame(k + j) for j in range(n)]


def make_vo(ctx, seq: Sequence):
    """The program's driver with the configuration's settings, on the card."""
    p = ctx.program
    c = seq.cam
    cam = p.Pinhole.create(c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"])
    return p.MonoVO(cam, p.Config(**ctx.config["settings"]), device=ctx.device)


def warmed(vo, require) -> bool:
    """Whether every first use the traffic asks to see before the window
    has happened."""
    have = {"loop_program": len(vo.scan_programs) > 0 or vo.device.type != "cuda",
            "window_ba": vo.n_window_ba > 0,
            "loop_closure": vo.n_loop_closures > 0}
    return all(have[r] for r in require)


def warm_up(ctx, vo, seq: Sequence, step, n_step: int) -> int:
    """Feed ``step(k)`` (``n_step`` frames each) until the traffic's
    warm-up is met; returns the frames fed. Raises if the cap is reached
    first: the window would then hold first uses. In a traced run the
    hand-written kernels' bounds are taken from these calls
    (``ctx.kernel_bounds_ms``)."""
    w = ctx.traffic["warmup"]
    k = 0
    with kernel_bounds.watching(ctx.trace) as samples:
        while k < w["min_frames"] or not warmed(vo, w["require"]):
            if k >= w["max_frames"]:
                raise RuntimeError(
                    f"warm-up: {w['require']} not all seen in {k} frames (window BAs "
                    f"{vo.n_window_ba}, closures {vo.n_loop_closures}, loop programs "
                    f"{len(vo.scan_programs)})")
            step(k)
            k += n_step
    ctx.kernel_bounds_ms = dict(samples)
    return k


RPE_GAP = 10          # frames: a tenth of the path's period
WINDOW_BA_ITERS = 30  # the reference's LM iterations from the program's window


def readings(ctx, state) -> dict:
    """The window's outputs judged.

    Exact: ``missing_poses``, frames handed to the program in the window
    without a finite pose; ``frozen_poses``, frames whose pose is bit for
    bit the previous frame's (the true camera moves every frame).

    Against the reference's minimum of the window BA the program last ran,
    from the state it left (``reference/window_ba.py``):
    ``window_ba_excess``, the cost above that minimum per live observation
    (px^2).

    Against the renderer's truth, read but not held to a limit (PERF.md
    says why): the trajectory with every correction the program made to it
    (``ate_pct``, ``rpe_pct`` over ``RPE_GAP`` frames, ``rot_err_deg_max``,
    aligned over the window) and the map it left (``map_err_median``,
    aligned over the window's last period, whose keyframes hold it)."""
    seq, k0, k1 = state.seq, state.window_start, state.window_end
    mats = np.asarray(state.trajectory[k0:k1], np.float64).reshape(-1, 4, 4)
    finite = np.isfinite(mats).all(axis=(1, 2))
    out = dict(missing_poses=float(k1 - k0 - int(finite.sum())),
               frozen_poses=float((mats[1:] == mats[:-1]).all(axis=(1, 2)).sum()))
    win = window_ba.Window(**state.window, device=ctx.device)
    c_min, c_state = window_ba.minimise(win, WINDOW_BA_ITERS)
    out["window_ba_excess"] = (c_state - c_min) / max(len(win.op), 1)
    if out["missing_poses"] or len(mats) < 3:
        return dict(out, **dict.fromkeys(
            ("ate_pct", "rpe_pct", "rot_err_deg_max", "map_err_median"), float("inf")))
    idx = np.arange(k0, k1) % seq.period
    ate, align = trajectory.ate_pct(mats, seq.true_R[idx], seq.true_c[idx])
    last = slice(-seq.period, None)
    local = trajectory.align(mats[last], seq.true_R[idx[last]], seq.true_c[idx[last]])
    pts = state.map_points
    return dict(
        out, ate_pct=ate,
        rpe_pct=trajectory.rpe_pct(mats, seq.true_c[idx], align, RPE_GAP),
        rot_err_deg_max=float(trajectory.rotation_errors_deg(
            mats, seq.true_R[idx], align[1]).max()),
        map_err_median=float(np.median(trajectory.map_error(pts, local, render.SCENE)))
        if pts is not None and len(pts) else float("inf"))


def keep_outputs(state, vo) -> None:
    """Copy what the judgement reads off the program before it is freed:
    the trajectory (host matrices), the map's live points and the window
    its last BA left (keyframe poses and observations, the map)."""
    state.trajectory = [np.array(m) for m in vo.trajectory]
    m = vo.map
    valid = m.valid.detach().cpu().numpy().astype(bool)
    state.map_points = m.xyz.detach().cpu().numpy()[valid] if vo.n_relocalizations == 0 \
        else None
    k = vo.kfs
    host = lambda a: a.detach().cpu().numpy()
    state.window = dict(kf_wxyz=host(k.wxyz), kf_t=host(k.t), kf_frame_id=host(k.frame_id),
                        kf_valid=host(k.valid), obs_px=host(k.obs_px),
                        obs_point=host(k.obs_point), map_xyz=host(m.xyz),
                        map_valid=host(m.valid), intrinsics=host(vo.intr),
                        huber_delta=float(vo.cfg.ba_huber_delta))


def now() -> float:
    return time.perf_counter()
