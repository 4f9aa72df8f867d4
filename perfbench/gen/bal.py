"""Seeded BAL problems at published counts, numpy only.

A frozen copy of the port's ``dr3_tpu_torch/tools/ba_time.bal_case``,
parameterised by the counts a published problem states: cameras, points
and observations. The draws and their order are the original's, so with
``n_obs = n_cams * per_cam`` a seed gives its arrays bit for bit
(``perfbench/tests/test_perfbench_frozen.py``). The scene: points in a slab
at depth 15-30 down -z, cameras 1000 px along x, camera k seeing a
contiguous run of points (runs of the cameras differ in length by at most
one), pixel noise 0.5, the points of the start perturbed by 0.05.
"""

from __future__ import annotations

import numpy as np


def per_camera(n_cams: int, n_obs: int) -> np.ndarray:
    """Observations of each camera: ``n_obs`` split so that runs differ by
    at most one, the longer runs first."""
    base, extra = divmod(n_obs, n_cams)
    return base + (np.arange(n_cams) < extra).astype(np.int64)


def bal_case(n_cams: int, n_pts: int, n_obs: int, seed: int):
    """(start, truth): dicts of float64 ``cam_params`` [K, 9] (angle-axis,
    translation, focal, k1, k2), ``points`` [P, 3], int32 ``obs_cam`` /
    ``obs_pt`` [O] and ``obs_uv`` [O, 2], drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n_pts), rng.uniform(-6, 6, n_pts),
                    rng.uniform(-30, -15, n_pts)], 1)
    cam = np.zeros((n_cams, 9))
    cam[:, 3] = np.linspace(-8, 8, n_cams)
    cam[:, 6] = 1000.0
    runs = per_camera(n_cams, n_obs)
    oc = np.repeat(np.arange(n_cams), runs).astype(np.int32)
    op = np.concatenate([
        np.arange(int(k * (n_pts - runs[k]) / (n_cams - 1)),
                  int(k * (n_pts - runs[k]) / (n_cams - 1)) + runs[k])
        for k in range(n_cams)]).astype(np.int32)
    pc = pts[op] + cam[oc, 3:6]
    uv = -1000.0 * pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5, (len(oc), 2))
    start = dict(cam_params=cam, points=pts + rng.normal(0, 0.05, pts.shape),
                 obs_cam=oc, obs_pt=op, obs_uv=uv)
    truth = dict(start, points=pts)
    return start, truth
