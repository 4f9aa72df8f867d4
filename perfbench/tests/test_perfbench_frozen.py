"""The harness's frozen copies against the port's originals on the same
small inputs: the renderer's frames bit for bit, the BAL draw, and each
kernel's bytes and operations."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import kernel_bounds, roofline
from perfbench.gen import bal, render

PATH = dict(period=100, amplitude=1.4, wobble_y=0.08, yaw=0.02)


def test_frames_bit_for_bit():
    from dr3_tpu_torch.tools.run_long_sequence import make_sequence

    cam, poses, frames = make_sequence(6, 96, 64, np.random.default_rng(2**31 + 9), "lateral")
    c = render.camera(96, 64, 0.875)
    assert (float(cam.fx), float(cam.cx), float(cam.cy)) == (c["fx"], c["cx"], c["cy"])
    p2, f2 = render.lateral_sequence(6, c, np.random.default_rng(2**31 + 9), PATH)
    assert all(np.array_equal(a, b) for a, b in zip(frames, f2))
    assert all(np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t) for a, b in zip(poses, p2))


def test_bal_draw_bit_for_bit():
    from dr3_tpu_torch.tools.ba_time import bal_case

    a, t = bal_case(n_cams=10, n_pts=3000, per_cam=400, seed=11)
    s, st = bal.bal_case(10, 3000, 4000, 11)
    for k in ("cam_params", "points", "obs_cam", "obs_pt", "obs_uv"):
        assert np.array_equal(getattr(a, k), s[k])
    assert np.array_equal(t.points, st["points"])


def test_bal_published_counts():
    runs = bal.per_camera(88, 383937)
    assert runs.sum() == 383937 and runs.max() - runs.min() == 1
    s, _ = bal.bal_case(88, 64298, 383937, 5)
    assert len(s["obs_cam"]) == 383937 and np.unique(s["obs_pt"]).size == 64298


@pytest.fixture(scope="module")
def pyramids():
    from dr3_tpu_torch.ops import pyramid

    c = render.camera(160, 120, 0.875)
    _, fr = render.lateral_sequence(2, c, np.random.default_rng(1), PATH)
    a, b = (torch.from_numpy(f) for f in fr)
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(40, 2, generator=g) * torch.tensor([150.0, 110.0]) + 5
    return pyramid.build_pyramid(a, 3), pyramid.build_pyramid(b, 3), pts, g


def test_bounds_as_the_port_counts_them(pyramids):
    from dr3_tpu_torch.geometry.lie import SE3
    from dr3_tpu_torch.models.camera import Pinhole
    from dr3_tpu_torch.tools import bounds

    pa, pb, pts, g = pyramids
    assert bounds.k1_pyramid(pa, pb, pts, None, 4, 10, 1e-2) == \
        roofline.k1_pyramid(pa, pb, pts, None, 4, 10, 1e-2)
    tm = torch.rand(40, 9, 9, generator=g)
    assert bounds.k1_align(pb[0], tm, pts, 8, 1e-2) == roofline.k1_align(pb[0], tm, pts, 8, 1e-2)
    assert bounds.k2_sample(pa[0], pts, 2) == roofline.k2_sample(pa[0], pts, 2)
    assert bounds.k3_corners(pa, 10.0) == roofline.k3_corners(pa, 10.0)
    x, y = pts[:, 0], pts[:, 1]
    assert bounds.k4_remap(pa[0], x, y, 320, True) == roofline.k4_remap(pa[0], x, y, 320, True)
    cam = Pinhole.create(160, 120, 140, 140, 80, 60)
    pw = torch.rand(40, 3, generator=g) * 2 + torch.tensor([-1.0, -1.0, 5.0])
    T0 = SE3.identity()
    T1 = SE3(torch.tensor([0.999, 0.01, 0.02, 0.0]), torch.tensor([0.05, 0.0, 0.01]))
    assert bounds.k2_sparse_align(pa[1], pb[1], T0, T0, T1, cam, pw, 1, 2, 12) == \
        roofline.k2_sparse_align(pa[1], pb[1], (T0.wxyz, T0.t), (T0.wxyz, T0.t),
                                 (T1.wxyz, T1.t), (cam.fx, cam.fy, cam.cx, cam.cy), pw, 1, 2, 12)


def test_watched_calls_take_the_wrappers_arguments(pyramids):
    """call_bound reads each wrapper's arguments as the wrappers take them."""
    from dr3_tpu_torch.ops import corners, lk

    pa, pb, pts, _ = pyramids
    valid = torch.ones(len(pts), dtype=torch.bool)
    res = lk.track_pyramid(pa, pb, pts, valid, half_window=4)
    assert kernel_bounds.call_bound("track_pyramid", (pa, pb, pts, valid), {"half_window": 4},
                                    res) == roofline.k1_pyramid(pa, pb, pts, None, 4, 10, 1e-2)
    assert kernel_bounds.call_bound("corner_response_pyramid", (pa, 10.0), {}, None) == \
        roofline.k3_corners(pa, 10.0)
    assert corners.corner_response_pyramid.launches >= 0


def test_roofline_pct_reads_the_slice():
    obs = {"kernel_bounds_ms": {"track_pyramid": [0.001, 0.003]},
           "kernel_launches": {"track_pyramid": 2, "sample_patches": 7},
           "trace": {"kernel_s": {"void lk_pyramid_kernel<2>(Levels)": [2e-5, 2],
                                  "some_other_kernel": [1.0, 5]}}}
    assert kernel_bounds.roofline_pct(obs) == pytest.approx(100 * 4e-6 / 2e-5)
    assert kernel_bounds.roofline_pct({"kernel_bounds_ms": {}, "trace": obs["trace"]}) is None
    # the profiler saw 2 of the 3 launches made: too few to stand for the slice
    assert kernel_bounds.roofline_pct(dict(obs, kernel_launches={"track_pyramid": 3})) is None


def test_counting_takes_the_wrappers_launches():
    from dr3_tpu_torch.ops import lk

    with kernel_bounds.counting() as made:
        lk.track_pyramid.launches += 3
    lk.track_pyramid.launches -= 3
    assert made["track_pyramid"] == 3 and made["sample_patches"] == 0
