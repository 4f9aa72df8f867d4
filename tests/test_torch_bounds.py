"""The measurement helpers on the CPU: the touched-pixel count of
tools/bounds.py against a brute-force union, the GN steps the plain LK loop
reports against the steps that move a track, the bounds' arithmetic, and
tools/cudatime.py's per-launch aggregation of a profile."""

import numpy as np
import pytest
import torch

from dr3_tpu_torch.ops import lk
from dr3_tpu_torch.ops.pyramid import build_pyramid
from dr3_tpu_torch.tools import bounds, cudatime
from dr3_tpu_torch.tools.cudatime import per_launch, uneven


def _smooth_pair(rng, h=60, w=80, shift=(0.7, -1.2)):
    from scipy import ndimage

    img = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 2.0).astype(np.float32)
    nxt = ndimage.shift(img, shift, order=1, mode="nearest").astype(np.float32)
    return torch.as_tensor(img), torch.as_tensor(nxt)


@pytest.mark.parametrize("n", [1, 7, 40])
def test_touched_pixels_is_the_union_of_the_boxes(rng, n):
    h, w = 23, 31
    x0 = torch.as_tensor(rng.uniform(-8, w + 4, n).astype(np.float32))
    y0 = torch.as_tensor(rng.uniform(-8, h + 4, n).astype(np.float32))
    x1 = x0 + torch.as_tensor(rng.uniform(0, 9, n).astype(np.float32))
    y1 = y0 + torch.as_tensor(rng.uniform(0, 9, n).astype(np.float32))
    x0[0] = float("nan")                   # a NaN corner clamps to the border
    mask = np.zeros((h, w), bool)
    for a, b, c, d in zip(*(bounds._index(v, m).tolist()
                            for v, m in ((x0, w), (y0, h), (x1, w), (y1, h)))):
        mask[b:d + 1, a:c + 1] = True
    assert bounds.touched_pixels(h, w, x0, y0, x1, y1) == int(mask.sum())


@pytest.mark.parametrize("eps", [1e-2, 1e-3, 0.0])
def test_plain_steps_are_the_steps_that_move_a_track(rng, eps):
    """A track's count is where its freeze falls: rerunning with that many
    steps gives its position bit for bit, the steps after it add zero."""
    img, nxt = _smooth_pair(rng)
    pts = torch.as_tensor(np.stack([rng.uniform(8, 72, 50), rng.uniform(8, 52, 50)],
                                   -1).astype(np.float32))
    pos, _, _, steps = lk._track_level_plain(img, nxt, pts, pts, 4, 10, eps, with_steps=True)
    assert steps.dtype == torch.int64 and bool(((steps >= 1) & (steps <= 10)).all())
    if eps == 0.0:
        assert bool((steps == 10).all())
    for s in steps.unique().tolist():
        again, *_ = lk._track_level_plain(img, nxt, pts, pts, 4, s, eps)
        sel = steps == s
        assert torch.equal(again[sel], pos[sel])
    assert len(lk._track_level_plain(img, nxt, pts, pts, 4, 10, eps)) == 3


def test_k1_bounds_count_the_work(rng):
    img, nxt = _smooth_pair(rng)
    pyr0, pyr1 = build_pyramid(img, 2), build_pyramid(nxt, 2)
    n, half, iters = 30, 3, 10
    pts = torch.as_tensor(np.stack([rng.uniform(8, 72, n), rng.uniform(8, 52, n)],
                                   -1).astype(np.float32))
    levels = bounds.plain_levels(pyr0, pyr1, pts, None, half, iters, 1e-2)
    assert [lvl for lvl, *_ in levels] == [1, 0]
    b = bounds.k1_pyramid(pyr0, pyr1, pts, None, half, iters, 1e-2)
    P = (2 * half + 1) ** 2
    steps = sum(s for *_, s in levels)
    assert b["steps"] == steps and 2 * n <= steps <= 2 * n * iters
    assert b["ops"] == (2 * n * (P * (bounds.OPS_LK_TEMPLATE + bounds.OPS_LK_ERR)
                                 + bounds.OPS_LK_LEVEL)
                        + steps * (P * bounds.OPS_LK_STEP + bounds.OPS_LK_SOLVE))
    # at most every pixel of both pyramids once, and the track arrays
    pixels = sum(t.numel() for t in (*pyr0, *pyr1))
    assert n * 22 < b["bytes"] <= 4 * pixels + n * 22
    assert b["bound_ms"] == pytest.approx(1e3 * max(b["bytes"] / bounds.HBM_BYTES_PER_S,
                                                    b["ops"] / bounds.F32_OPS_PER_S))
    tmpl = lk._sample_patches_plain(img, pts, 4)
    a = bounds.k1_align(nxt, tmpl, pts, 8, 1e-2)
    _, *_, want = lk._solve_2x2_steps(lambda p: lk._sample_patches_plain(nxt, p, 4), tmpl,
                                      lk._gradient(tmpl, -1), lk._gradient(tmpl, -2), pts,
                                      8, 1e-2)
    assert a["steps"] == int(want.sum()) and a["bytes"] > tmpl.numel() * 4


def test_sparse_align_bound_counts_the_work():
    from dr3_tpu_torch.geometry.lie import SE3
    from dr3_tpu_torch.models.camera import Pinhole
    from tests.torch_parity import sparse_align_case

    c = sparse_align_case("nominal", n=50)
    t = torch.as_tensor
    T_ref, T_init = SE3(*map(t, c["T_ref"])), SE3(*map(t, c["T_init"]))
    cam = Pinhole.create(*c["intrinsics"])
    n, half, iters = 50, 2, 12
    b = bounds.k2_sparse_align(t(c["img_ref"]), t(c["img_cur"]), T_ref, T_init, T_init, cam,
                               t(c["points"]), c["level"], half, iters)
    assert b["ops"] == (n * (49 * bounds.OPS_SHARED_SAMPLE + bounds.OPS_CELL
                             + 25 * bounds.OPS_ALIGN_REF_PIXEL + bounds.OPS_ALIGN_PROJECT)
                        + 13 * n * (25 * bounds.OPS_ALIGN_PIXEL + bounds.OPS_ALIGN_POINT)
                        + 12 * bounds.OPS_ALIGN_LM)
    fixed = n * 13 + 4 * 18 + 44
    # the patches' pixels at least once where they do not overlap, at most
    # every pixel of both levels
    pixels = c["img_ref"].size + c["img_cur"].size
    assert fixed + 4 * 49 < b["bytes"] <= fixed + 4 * pixels
    # a start pose elsewhere widens the current level's windows
    far = SE3(T_init.wxyz, T_init.t + torch.tensor([0.3, 0.0, 0.0]))
    wider = bounds.k2_sparse_align(t(c["img_ref"]), t(c["img_cur"]), T_ref, far, T_init, cam,
                                   t(c["points"]), c["level"], half, iters)
    assert wider["bytes"] > b["bytes"] and wider["ops"] == b["ops"]


@pytest.mark.parametrize("threshold", [10.0, 40.0])
def test_k3_bound_counts_what_the_image_needs(rng, threshold):
    """Bytes for every pixel; operations by what each pixel is, nested as
    the kernel's stages are, and summed over the levels of a pyramid."""
    from tests.test_torch_corners import _kind_image

    lv = build_pyramid(torch.as_tensor(_kind_image("blobs", rng, 96, 128)), 2)
    both, one, two = (bounds.k3_corners(x, threshold) for x in (lv, lv[:1], lv[1:]))
    keys = ("pixels", "candidates", "scored", "survivors")
    for b in (one, two):
        assert b["pixels"] > b["candidates"] >= b["scored"] >= b["survivors"]
        assert b["ops"] == (b["pixels"] * bounds.OPS_CORNER_TEST
                            + b["candidates"] * bounds.OPS_CORNER_ARCS
                            + b["scored"] * bounds.OPS_CORNER_NMS
                            + b["survivors"] * bounds.OPS_CORNER_BOX)
    assert one["pixels"] == lv[0].numel() and one["survivors"] > 0
    assert one["survivors"] == int((bounds.corners._corner_response_plain(lv[0], threshold)
                                    != 0).sum())
    assert all(both[k] == one[k] + two[k] for k in keys + ("ops",))
    assert both["bytes"] == 8 * (lv[0].numel() + lv[1].numel())
    # a flat image pays the test alone
    flat = bounds.k3_corners([torch.full((40, 50), 0.5)], threshold)
    assert flat["ops"] == 2000 * bounds.OPS_CORNER_TEST and flat["bound_by"] == "bytes"


def test_bound_takes_the_larger_time():
    assert bounds.bound(3.35e9, 0)["bound_by"] == "bytes"
    b = bounds.bound(3.35e6, 67e9)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1.0)


def test_per_launch_aggregates_a_kernel_across_its_instances():
    events = {"void lk_pyramid_kernel<8>(...)": (3, 60.0),
              "void lk_pyramid_kernel<4>(...)": (1, 20.0),
              "void sample_patches_kernel(...)": (10, 15.0),
              "at::vectorized_elementwise_kernel": (50, 99.0)}
    names = {"lk_pyramid": "lk_pyramid_kernel", "sample_patches": "sample_patches_kernel",
             "lk_align": "lk_align_kernel"}
    assert per_launch(events, names) == {"lk_pyramid": (4, 20.0),
                                         "sample_patches": (10, 1.5)}


def test_uneven_names_lost_and_stray_events():
    """100 calls of one kernel and three copies: a whole window has nothing
    uneven; a window that lost events or holds a stray one names them."""
    whole = {"corner_response_kernel": (100, 1400.0), "memcpy": (300, 600.0)}
    lossy = {"corner_response_kernel": (96, 96 * 14.0), "memcpy": (300, 600.0),
             "never seen": (0, 0.0), "a stray 36 us kernel": (1, 36.0)}
    assert uneven(whole, 100) == {}
    assert uneven(lossy, 100) == {"corner_response_kernel": 96, "a stray 36 us kernel": 1}


def test_whole_window_takes_a_window_without_device_time_again(monkeypatch):
    """A window in which the profiler recorded no device event has nothing
    uneven but is not free: it is taken again, and so is one that lost
    events; the first whole window with device time is kept."""
    whole = {"sample_patches_kernel": (100, 154.0)}
    windows = iter([{}, {"sample_patches_kernel": (97, 150.0)}, whole, {}])
    seen = []
    monkeypatch.setattr(cudatime, "profile", lambda fn, n: seen.append(n) or next(windows))
    assert cudatime.whole_window(lambda: None, 100) == (whole, {})
    assert seen == [100, 100, 100]
