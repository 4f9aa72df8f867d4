"""Offline 3D result rendering (port of dr3_tpu.viz.draw3d; Viewer3D
parity).

The reference's Viewer3D runs a Pangolin/OpenGL loop — axes, camera frusta
per keyframe, map points as GL_POINTS (reference src/viewer.cpp:157-322).
Here the same artifacts render headlessly: top-down + 3D views of the
trajectory, keyframe frusta and the landmark cloud, written to PNG with
matplotlib, which is imported inside the functions. The driver's tensors
are read through ``.cpu()``.

Coordinate convention matches the reference (x right, y down, z forward,
viewer.hpp:81-87) — plots use (x, z) for the top-down view.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _frustum_segments(T_f_w: np.ndarray, scale: float = 0.1):
    """Line segments of a camera frustum for a world->frame pose 4x4
    (draw_frustum parity, src/viewer.cpp:172-209)."""
    R = T_f_w[:3, :3]
    t = T_f_w[:3, 3]
    C = -R.T @ t
    w, h, z = 1.0 * scale, 0.75 * scale, 0.6 * scale
    pts_c = np.asarray([[0, 0, 0], [-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z]])
    pts_w = pts_c @ R + C           # R^T p + C for each corner
    segs = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts_w[a], pts_w[b]) for a, b in segs]


def render_map(trajectory: np.ndarray, points: Optional[np.ndarray] = None,
               keyframes: Optional[np.ndarray] = None,
               path: str = "map.png", title: str = "trajectory + map") -> str:
    """Top-down (x-z) + 3D rendering.

    trajectory: [T, 4, 4] T_f_w poses (or [T, 3] camera centers);
    points: [P, 3] landmark positions; keyframes: [K, 4, 4] poses to draw
    as frusta.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    traj = np.asarray(trajectory)
    if traj.ndim == 3:
        centers = np.asarray([-(T[:3, :3].T @ T[:3, 3]) for T in traj])
    else:
        centers = traj
    centers = centers.reshape(-1, 3)

    fig = plt.figure(figsize=(14, 6))
    ax1 = fig.add_subplot(1, 2, 1)
    ax2 = fig.add_subplot(1, 2, 2, projection="3d")

    if points is not None and len(points):
        pts = np.asarray(points)
        ax1.scatter(pts[:, 0], pts[:, 2], s=0.5, c="gray", alpha=0.5)
        ax2.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.5, c="gray", alpha=0.4)
    ax1.plot(centers[:, 0], centers[:, 2], "-o", color="tab:blue", ms=2, lw=1)
    ax2.plot(centers[:, 0], centers[:, 2], -centers[:, 1], "-", color="tab:blue")

    if keyframes is not None and len(centers):
        for T in np.asarray(keyframes):
            for a, b in _frustum_segments(T, scale=0.05 * max(
                    1e-6, np.ptp(centers[:, 2]) + 0.1)):
                ax1.plot([a[0], b[0]], [a[2], b[2]], "-", color="tab:red", lw=0.6)
                ax2.plot([a[0], b[0]], [a[2], b[2]], [-a[1], -b[1]],
                         "-", color="tab:red", lw=0.6)

    ax1.set_xlabel("x")
    ax1.set_ylabel("z (forward)")
    ax1.set_aspect("equal", adjustable="datalim")
    ax1.set_title(f"{title} (top-down)")
    ax2.set_title("3D")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def render_vo(vo, path: str = "slam_map.png") -> str:
    """Render a pipelines.vo.MonoVO state (trajectory + keyframes + map)."""
    kf_mats = None
    valid = vo.kfs.valid.cpu().numpy()
    if valid.any():
        kf_mats = vo.kfs.poses().matrix().cpu().numpy()[valid]
    pts = vo.map.xyz.cpu().numpy()[vo.map.valid.cpu().numpy()]
    traj = np.asarray(vo.trajectory) if vo.trajectory else np.zeros((0, 4, 4), np.float32)
    return render_map(traj, pts, kf_mats, path=path)
