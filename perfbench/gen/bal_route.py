"""Seeded BAL problems shaped like a route, numpy only.

A sequence taken from a moving vehicle (BAL's Ladybug family): the cameras
lie along a line at a fixed spacing, each sees the points near it, and a
point is seen by the few cameras around it. At the counts a published
problem states (cameras, points, observations):

* camera k sits at x = c_k, the cameras ``SPACING`` apart (Dubrovnik-88's
  spacing in ``perfbench/gen/bal.py``: 16 units over 87 gaps), looking down
  -z with no rotation, focal 1000 px, no radial distortion;
* camera k sees a contiguous run of point ids, the runs differing in length
  by at most one (``bal.per_camera``) and placed as ``bal.bal_case`` places
  them, so consecutive cameras share most of their points;
* point i lies near the cameras that see it: x at their mean centre plus a
  uniform draw in [-1, 1], y uniform in [-6, 6], z uniform in [-30, -15];
* pixel noise 0.5, and the points of the start perturbed by 0.05.

So a point's observers span about 0.6 units at a depth of 15-30: a
parallax of about 1.6 degrees, where ``bal.bal_case`` squeezes every
problem's cameras into 16 units (0.07 degrees at 1,723 cameras).
"""

from __future__ import annotations

import numpy as np

from perfbench.gen.bal import per_camera

SPACING = 16.0 / 87.0


def route_case(n_cams: int, n_pts: int, n_obs: int, seed):
    """(start, truth): dicts of float64 ``cam_params`` [K, 9] (angle-axis,
    translation, focal, k1, k2), ``points`` [P, 3], int32 ``obs_cam`` /
    ``obs_pt`` [O] and ``obs_uv`` [O, 2], drawn from
    ``np.random.default_rng(seed)`` (``seed`` an int or a tuple of ints)."""
    rng = np.random.default_rng(seed)
    centre = SPACING * (np.arange(n_cams) - 0.5 * (n_cams - 1))
    cam = np.zeros((n_cams, 9))
    cam[:, 3] = -centre                     # p = X + t: the centre is -t
    cam[:, 6] = 1000.0
    runs = per_camera(n_cams, n_obs)
    oc = np.repeat(np.arange(n_cams), runs).astype(np.int32)
    op = np.concatenate([
        np.arange(int(k * (n_pts - runs[k]) / max(n_cams - 1, 1)),
                  int(k * (n_pts - runs[k]) / max(n_cams - 1, 1)) + runs[k])
        for k in range(n_cams)]).astype(np.int32)
    seen = np.bincount(op, minlength=n_pts)
    mean_x = np.bincount(op, weights=centre[oc], minlength=n_pts) / np.maximum(seen, 1)
    pts = np.stack([mean_x + rng.uniform(-1, 1, n_pts), rng.uniform(-6, 6, n_pts),
                    rng.uniform(-30, -15, n_pts)], 1)
    pc = pts[op] + cam[oc, 3:6]
    uv = -1000.0 * pc[:, :2] / pc[:, 2:3] + rng.normal(0, 0.5, (len(oc), 2))
    start = dict(cam_params=cam, points=pts + rng.normal(0, 0.05, pts.shape),
                 obs_cam=oc, obs_pt=op, obs_uv=uv)
    truth = dict(start, points=pts)
    return start, truth

