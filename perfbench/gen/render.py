"""Frames with exact ground truth for the VO cells, numpy only.

A frozen copy of the port's renderer (``dr3_tpu_torch/utils/synth.py``:
``make_textures``, ``NpSE3``, ``render_scene``) and of the lateral path of
``dr3_tpu_torch/tools/run_long_sequence.make_sequence``, with the path's
numbers taken from the traffic file. A seed gives the same frames bit for
bit as the port's own generator (``perfbench/tests/test_perfbench_frozen.py``
holds it to that). The scene is a textured near plane inside a textured far
plane; the camera slides out and back along x, so each period of the path
revisits the content of the first.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
from scipy import ndimage


def make_textures(rng, size=1600):
    """High-contrast binary-blob textures (FAST-friendly)."""
    def tex():
        base = ndimage.gaussian_filter(rng.uniform(0, 1, (size, size)), 2.5)
        soft = ndimage.gaussian_filter(rng.uniform(0, 1, (size, size)), 1.0)
        return (0.6 * (base > np.median(base)) + 0.4 * soft).astype(np.float32)

    return tex(), tex()


def _np_skew(omega):
    return np.array([[0.0, -omega[2], omega[1]],
                     [omega[2], 0.0, -omega[0]],
                     [-omega[1], omega[0], 0.0]], np.float64)


class NpSE3:
    """World->cam rigid transform (R, t); ``exp`` of a tangent [rho, omega]
    with the left Jacobian."""

    def __init__(self, R, t):
        self.R = np.asarray(R, np.float64)
        self.t = np.asarray(t, np.float64)

    @classmethod
    def exp(cls, tangent):
        tangent = np.asarray(tangent, np.float64)
        rho, omega = tangent[:3], tangent[3:]
        theta = float(np.linalg.norm(omega))
        K = _np_skew(omega)
        if theta < 1e-8:
            R = np.eye(3) + K + 0.5 * (K @ K)
            V = np.eye(3) + 0.5 * K + (K @ K) / 6.0
        else:
            A = np.sin(theta) / theta
            B = (1.0 - np.cos(theta)) / theta ** 2
            C = (theta - np.sin(theta)) / theta ** 3
            R = np.eye(3) + A * K + B * (K @ K)
            V = np.eye(3) + B * K + C * (K @ K)
        return cls(R, V @ rho)

    def center(self):
        return (-self.R.T @ self.t).astype(np.float32)


def render_scene(cam, T, tex_near, tex_far, z_near=6.0, z_far=14.0,
                 near_halfw=2.2, near_halfh=1.6, px_per_unit=60.0):
    """Render the scene from world->cam pose T (NpSE3) with camera ``cam``
    (anything with fx, fy, cx, cy, width, height)."""
    h, w = cam.height, cam.width
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    R_wc = T.R.astype(np.float32)
    t_wc = T.t.astype(np.float32)
    R = R_wc.T                      # cam->world rotation
    t = -R_wc.T @ t_wc              # camera center in world
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    d_w = d_cam @ R.T

    def plane_hit(z_plane):
        lam = (z_plane - t[2]) / np.where(np.abs(d_w[..., 2]) < 1e-9, 1e-9,
                                          d_w[..., 2])
        return t + lam[..., None] * d_w, lam

    pw_n, lam_n = plane_hit(z_near)
    pw_f, _ = plane_hit(z_far)
    near_mask = (np.abs(pw_n[..., 0]) < near_halfw) & \
        (np.abs(pw_n[..., 1]) < near_halfh) & (lam_n > 0)

    def lookup(tex, pw):
        txy = pw[..., :2] * px_per_unit + np.asarray(tex.shape)[::-1] / 2.0
        th, tw = tex.shape
        x = np.clip(txy[..., 0], 0.0, tw - 1.001)
        y = np.clip(txy[..., 1], 0.0, th - 1.001)
        x0 = x.astype(np.int32)
        y0 = y.astype(np.int32)
        ax = (x - x0).astype(np.float32)
        ay = (y - y0).astype(np.float32)
        v00 = tex[y0, x0]
        v01 = tex[y0, x0 + 1]
        v10 = tex[y0 + 1, x0]
        v11 = tex[y0 + 1, x0 + 1]
        return ((1 - ay) * ((1 - ax) * v00 + ax * v01)
                + ay * ((1 - ax) * v10 + ax * v11))

    img = np.where(near_mask, lookup(tex_near, pw_n), lookup(tex_far, pw_f))
    return img.astype(np.float32)


# the scene render_scene draws, for judging a map against it
SCENE = dict(z_near=6.0, z_far=14.0, near_halfw=2.2, near_halfh=1.6)


def camera(width: int, height: int, focal_over_width: float) -> dict:
    """The renderer's pinhole camera: focal ``focal_over_width * width``,
    principal point at the image centre."""
    f = focal_over_width * width
    return dict(width=width, height=height, fx=f, fy=f, cx=width / 2.0, cy=height / 2.0)


def lateral_poses(n_frames: int, period: int, amplitude: float, wobble_y: float,
                  yaw: float) -> list:
    """World->cam poses of the out-and-back sweep: x from 0 to
    ``amplitude`` and back once per ``period`` frames, a vertical wobble of
    ``wobble_y`` at twice that rate and a yaw of ``yaw`` rad."""
    poses = []
    for i in range(n_frames):
        phase = 2.0 * np.pi * i / period
        x = amplitude * 0.5 * (1.0 - np.cos(phase))
        y = wobble_y * np.sin(2.0 * phase)
        ya = yaw * np.sin(phase)
        poses.append(NpSE3.exp(np.asarray([-x, -y, 0.0, 0.0, ya, 0.0], np.float32)))
    return poses


def lateral_sequence(n_frames: int, cam: dict, rng, path: dict, workers: int = 8):
    """(poses, float32 frames [H, W] in [0, 1]) of the lateral path: the
    textures are drawn from ``rng`` first, then each frame renders alone on
    a pool of threads (numpy releases the GIL in the renderer's array
    operations), so the pool changes no bit."""
    tex_near, tex_far = make_textures(rng)
    poses = lateral_poses(n_frames, path["period"], path["amplitude"], path["wobble_y"],
                          path["yaw"])
    host_cam = SimpleNamespace(**cam)
    with ThreadPoolExecutor(max_workers=max(1, min(workers, os.cpu_count() or 1))) as pool:
        frames = list(pool.map(lambda T: render_scene(host_cam, T, tex_near, tex_far),
                               poses))
    return poses, frames


def to_uint8(frame: np.ndarray) -> np.ndarray:
    """A [0, 1] float frame as a camera delivers it: 8-bit grey levels."""
    return np.clip(frame * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
