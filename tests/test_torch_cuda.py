"""The port's CUDA kernels against their plain PyTorch twins on the card.

Marked ``cuda``: they need a CUDA device and the toolkit's nvcc (the
kernels build on first use into build/), and skip with a reason elsewhere.
On the machine with the card (which has no JAX, so tests/conftest.py,
which imports it, is skipped):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

The CPU parity of the twins themselves is in tests/test_torch_lk.py,
test_torch_sparse_align.py, test_torch_corners.py and test_torch_warp.py.
"""

import zlib

import numpy as np
import pytest
import torch
from scipy import ndimage

from dr3_tpu_torch.geometry.lie import SE3
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.ops import corners, lk
from dr3_tpu_torch.ops import sparse_align as sa
from dr3_tpu_torch.ops import warp as tw
from dr3_tpu_torch.ops.pyramid import build_pyramid
from dr3_tpu_torch.tools import warp_tiles
# pytest puts this file's directory on sys.path; ``tests.torch_parity`` would
# resolve to an installed package named ``tests`` where there is one
from torch_parity import SPARSE_ALIGN_CASES, sparse_align_case

pytestmark = pytest.mark.cuda


@pytest.fixture()
def rng(request):
    # the repository's name-seeded generator, local so --noconftest runs work
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _pair(rng, h=188, w=620, shift=(1.7, -2.4)):
    img = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 2.0).astype(np.float32)
    nxt = ndimage.shift(img, shift, order=1, mode="nearest").astype(np.float32)
    return img, nxt


def test_track_level_kernel_matches_plain(rng, dev):
    img, nxt = _pair(rng)
    pts = np.stack([rng.uniform(10, 610, 300), rng.uniform(10, 178, 300)], -1).astype(np.float32)
    pts[3] = np.nan                      # NaN slot: ok False, no fault
    pts[4] = [-50.0, 1e9]                # far outside: clamped reads
    a = [torch.as_tensor(x, device=dev) for x in (img, nxt, pts, pts + 0.3)]
    pos, ok, err = lk.track_level(*a, 7, 10, 1e-3)
    pos_p, ok_p, err_p = lk._track_level_plain(*a, 7, 10, 1e-3)
    torch.cuda.synchronize()
    both = ok & ok_p
    assert int(both.sum()) >= 0.8 * 300 and not bool(ok[3]) and not bool(ok[4])
    assert float((pos - pos_p)[both].abs().max()) < 1e-2
    assert not torch.isfinite(pos[3]).all()


# K1 in one launch per pyramid (levels, init given, half window): the
# kernel against the plain per-level loop. The 188x620 pair moves by
# (dx, dy) = (-2.4, 1.7); slot 3 is NaN, slot 4 far outside the image and,
# with init, slot 5 starts far off it. Half 40 and the largest take blocks
# of fewer tracks (3 W^2 + (W + 5)^2 floats of shared memory per track,
# above 48 KB per block).
PYRAMID_CASES = [(1, False, 7), (1, True, 7), (3, False, 7), (3, True, 7), (4, False, 7),
                 (4, True, 7), (3, True, 1), (3, True, 12), (2, True, 40),
                 (1, True, lk.MAX_HALF_WINDOW)]


@pytest.mark.parametrize("n_levels,with_init,half", PYRAMID_CASES)
def test_track_pyramid_kernel_matches_plain(rng, dev, n_levels, with_init, half):
    img, nxt = _pair(rng)
    n = 300
    pts = np.stack([rng.uniform(10, 610, n), rng.uniform(10, 178, n)], -1).astype(np.float32)
    pts[3] = np.nan
    pts[4] = [-50.0, 1e9]
    valid = np.ones(n, bool)
    valid[6] = False
    init = None
    if with_init:
        init = (pts + np.float32([-2.4, 1.7]) + rng.uniform(-0.5, 0.5, (n, 2))).astype(np.float32)
        init[5] = [5000.0, -4000.0]
    pyr0 = build_pyramid(torch.as_tensor(img, device=dev), n_levels)
    pyr1 = build_pyramid(torch.as_tensor(nxt, device=dev), n_levels)
    t_pts = torch.as_tensor(pts, device=dev)
    t_valid = torch.as_tensor(valid, device=dev)
    t_init = None if init is None else torch.as_tensor(init, device=dev)
    # eps 1e-3, as in the level test above: a step whose size rounds to either
    # side of eps freezes in one version and moves once more in the other,
    # so eps bounds that knife edge, and 1e-2 would equal the gate
    before = (lk.track_pyramid.launches, lk.track_level.launches)
    r = lk.track_pyramid(pyr0, pyr1, t_pts, t_valid, init=t_init, half_window=half,
                         iters=10, eps=1e-3)
    torch.cuda.synchronize()
    assert (lk.track_pyramid.launches, lk.track_level.launches) == (before[0] + 1, before[1])
    rp = lk._track_pyramid_plain(pyr0, pyr1, t_pts, t_valid, t_init, half, 10, 1e-3, 40.0)
    both = r.ok & rp.ok
    assert int((r.ok != rp.ok).sum()) <= max(2, n // 50)
    if half >= 7 and (with_init or n_levels >= 3):     # 2.9 px: a level-0 start misses some
        assert int(both.sum()) >= 0.8 * (n - 4)
    d = (r.pos - rp.pos)[both].abs().amax(-1)
    if half >= 3:
        assert float(d.max()) < 1e-2
    else:
        # a 3x3 window's 2x2 system is near singular on flat patches (the
        # min-eigenvalue gate is 1e-4 / 255^2) and amplifies the sums'
        # rounding by its inverse. The kernel divides by det as the plain
        # loop does; what is left is its shared bilinear cell (a window's
        # pixels take its centre's fraction, one ulp from the plain
        # per-pixel coordinate where that sum rounds at a power of two). On
        # an H100 this case then has one track of 295 at 0.022 px and 3
        # beyond 1e-3 px; with other seeds 0-2 tracks of 296 leave 1e-2 px,
        # some by tens of px (a track that converges elsewhere), while half 2
        # and 3 stay within 2e-4 px. So half 1 holds a share, and this
        # seed's maximum.
        assert float((d < 1e-2).float().mean()) >= 0.98 and float(d.max()) < 0.1
    assert not bool(r.ok[[3, 4, 6]].any()) and not (with_init and bool(r.ok[5]))
    assert not torch.isfinite(r.pos[3]).all()


def test_track_pyramid_refuses_a_window_above_the_limit(dev):
    img = torch.rand(64, 64, device=dev)
    pts = torch.full((3, 2), 32.0, device=dev)
    valid = torch.ones(3, dtype=torch.bool, device=dev)
    before = (lk.track_pyramid.launches, lk.align_to_templates.launches)
    big = lk.MAX_HALF_WINDOW + 1
    with pytest.raises(ValueError, match="half window"):
        lk.track_pyramid([img], [img], pts, valid, half_window=big)
    with pytest.raises(ValueError, match="half window"):
        lk.align_to_templates(img, torch.rand(3, 2 * big + 1, 2 * big + 1, device=dev),
                              pts, valid)
    with pytest.raises(ValueError, match="levels"):
        lk.track_pyramid([img] * 9, [img] * 9, pts, valid, half_window=3)
    assert (lk.track_pyramid.launches, lk.align_to_templates.launches) == before


@pytest.mark.parametrize("half", [4, 7])
def test_align_kernel_matches_plain(rng, dev, half):
    img, nxt = _pair(rng, shift=(0.4, 0.8))
    pts = np.stack([rng.uniform(10, 610, 200), rng.uniform(10, 178, 200)], -1).astype(np.float32)
    t_img = torch.as_tensor(img, device=dev)
    t_nxt = torch.as_tensor(nxt, device=dev)
    t_pts = torch.as_tensor(pts, device=dev)
    tmpl = lk._sample_patches_plain(t_img, t_pts, half).contiguous()
    valid = torch.ones(200, dtype=torch.bool, device=dev)
    r = lk.align_to_templates(t_nxt, tmpl, t_pts, valid)
    rp = lk._align_to_templates_plain(t_nxt, tmpl, t_pts, valid, 8, 1e-2, 30.0, 4.0)
    both = r.ok & rp.ok
    assert int(both.sum()) >= 0.8 * 200
    assert float((r.pos - rp.pos)[both].abs().max()) < 1e-2
    assert bool(((r.pos == t_pts).all(-1) | r.ok).all())


@pytest.mark.parametrize("half", [2, 3, 4, 9])
def test_sample_patches_kernel_matches_plain(rng, dev, half):
    img = torch.as_tensor(rng.uniform(0, 1, (94, 310)).astype(np.float32), device=dev)
    c = torch.as_tensor(np.stack([rng.uniform(-5, 315, 546), rng.uniform(-5, 99, 546)],
                                 -1).astype(np.float32), device=dev)
    torch.testing.assert_close(lk.sample_patches(img, c, half),
                               lk._sample_patches_plain(img, c, half), rtol=0, atol=1e-5)


def _response_image(rng, hw, dev):
    base = ndimage.gaussian_filter(rng.uniform(0, 1, hw), 1.5)
    return torch.as_tensor((0.6 * (base > np.median(base))
                            + 0.4 * rng.uniform(0, 1, hw)).astype(np.float32), device=dev)


# K3's tile is 32x32: (64, 96) ends on tile edges, (65, 33) one pixel past
# them, (45, 70) and (7, 9) are smaller than a tile or than the border
@pytest.mark.parametrize("hw", [(376, 1240), (188, 620), (94, 310), (45, 70), (64, 96),
                                (65, 33), (7, 9)])
def test_corner_response_kernel_matches_plain(rng, dev, hw):
    img = _response_image(rng, hw, dev)
    before = corners.corner_response.launches
    got = corners.corner_response(img, 10.0)
    assert corners.corner_response.launches == before + 1
    want = corners._corner_response_plain(img, 10.0)
    assert torch.equal(got > 0, want > 0)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=0.05)
    assert torch.equal(got, corners.corner_response(img, 10.0))      # run to run


@pytest.mark.parametrize("hw,n_levels", [((376, 1240), 3), ((480, 640), 3), ((96, 130), 4),
                                         ((45, 70), 1)])
def test_corner_response_pyramid_kernel_matches_plain(rng, dev, hw, n_levels):
    """All levels in one launch: each level equal to its own launch bit for
    bit, and to the plain version as above."""
    levels = build_pyramid(_response_image(rng, hw, dev), n_levels)
    before = (corners.corner_response_pyramid.launches, corners.corner_response.launches)
    got = corners.corner_response_pyramid(levels, 20.0)
    assert (corners.corner_response_pyramid.launches,
            corners.corner_response.launches) == (before[0] + 1, before[1])
    assert len(got) == n_levels
    for img, g in zip(levels, got):
        want = corners._corner_response_plain(img, 20.0)
        assert g.shape == img.shape and torch.equal(g > 0, want > 0)
        torch.testing.assert_close(g, want, rtol=2e-3, atol=0.05)
        assert torch.equal(g, corners.corner_response(img, 20.0))
    feats = corners.detect_features(levels, 30, 20.0, 20.0)
    plain = corners.detect_features([lv.cpu() for lv in levels], 30, 20.0, 20.0)
    assert torch.equal(feats.valid.cpu(), plain.valid) and torch.equal(feats.xy.cpu(), plain.xy)


# ---------------------------------------------------------------------------
# sparse alignment in one launch (csrc/sparse_align.cu) against the plain
# loop on the same card: pose within 1e-4, cost0 rtol 1e-5, n_used equal.
# The 320x240 level-0 image (307 KB) does not fit a block's shared memory
# and is sampled from global memory; the others are staged.
# ---------------------------------------------------------------------------

def _align_args(c, dev, half_patch=None, iters=None):
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (t(c["img_ref"]), t(c["img_cur"]), SE3(*map(t, c["T_ref"])),
            SE3(*map(t, c["T_init"])), Pinhole.create(*c["intrinsics"], device=dev),
            t(c["points"]), t(c["valid"]), c["level"],
            c["half_patch"] if half_patch is None else half_patch,
            c["iters"] if iters is None else iters)


def _assert_align_close(got, want):
    assert got.n_used.dtype == want.n_used.dtype and int(got.n_used) == int(want.n_used)
    torch.testing.assert_close(got.cost0, want.cost0, rtol=1e-5, atol=1e-12)
    torch.testing.assert_close(got.cost, want.cost, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(got.T.wxyz, want.T.wxyz, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.T.t, want.T.t, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", SPARSE_ALIGN_CASES)
def test_sparse_align_kernel_matches_plain(dev, name):
    c = sparse_align_case(name)
    args = _align_args(c, dev)
    before = (sa.sparse_align.launches, lk.sample_patches.launches)
    got = sa.sparse_align(*args)
    torch.cuda.synchronize()
    assert (sa.sparse_align.launches, lk.sample_patches.launches) == (before[0] + 1, before[1])
    _assert_align_close(got, sa._sparse_align_plain(*args))
    again = sa.sparse_align(*args)                    # fixed-order sums: the same bits
    assert all(torch.equal(a, b) for a, b in zip(
        (got.T.wxyz, got.T.t, got.cost0, got.cost, got.n_used),
        (again.T.wxyz, again.T.t, again.cost0, again.cost, again.n_used)))
    if name == "all_invalid":
        assert torch.equal(got.T.wxyz, args[3].wxyz) and torch.equal(got.T.t, args[3].t)
        assert int(got.n_used) == 0


@pytest.mark.parametrize("half_patch", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("name", ["nominal", "level0"])
def test_sparse_align_kernel_patch_widths(dev, name, half_patch):
    args = _align_args(sparse_align_case(name), dev, half_patch=half_patch)
    _assert_align_close(sa.sparse_align(*args), sa._sparse_align_plain(*args))


@pytest.mark.parametrize("n,half_patch", [(1, 2), (7, 2), (1300, 2), (6000, 4)])
def test_sparse_align_kernel_point_counts(dev, n, half_patch):
    """One point; fewer points than blocks; more points than one pass of a
    block's lanes; patches that do not fit shared memory (global scratch)."""
    args = _align_args(sparse_align_case("nominal", n=n), dev, half_patch=half_patch, iters=6)
    _assert_align_close(sa.sparse_align(*args), sa._sparse_align_plain(*args))


def test_sparse_align_kernel_refuses_a_nan_cost(dev):
    """A NaN point under a valid flag makes every cost NaN: no step is
    accepted, as torch.isfinite refuses it in the plain loop."""
    c = sparse_align_case("nominal")
    c["points"][40] = np.nan
    args = _align_args(c, dev)
    got = sa.sparse_align(*args)
    want = sa._sparse_align_plain(*args)
    assert bool(torch.isnan(got.cost0)) and bool(torch.isnan(want.cost0))
    assert torch.equal(got.T.wxyz, args[3].wxyz) and torch.equal(got.T.t, args[3].t)
    assert int(got.n_used) == int(want.n_used)


def test_sparse_align_rejects_bad_inputs(dev):
    args = list(_align_args(sparse_align_case("nominal"), dev))
    before = sa.sparse_align.launches
    for i, bad in ((0, args[0].double()), (1, args[1].t()), (5, args[5].cpu()),
                   (5, args[5][:, :2]), (6, args[6].to(torch.uint8)),
                   (6, args[6][:-1]), (2, SE3(args[2].wxyz.double(), args[2].t)),
                   (4, Pinhole.create(*sparse_align_case("nominal")["intrinsics"]))):
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            sa.sparse_align(*broken)
    assert sa.sparse_align.launches == before


# ---------------------------------------------------------------------------
# K4 (csrc/warp.cu): remap over a given field, and the warps that compute
# their own field, against the plain versions on the same card. The kernel
# rounds every step as the plain PyTorch ops do and computes a row's or a
# column's terms with the same operations, so values (NaN where both are
# NaN) and validity are bit-equal.
# ---------------------------------------------------------------------------

H_TILT = np.asarray([[1.02, 0.03, 4.0], [-0.02, 0.98, -2.5],
                     [1e-5, -2e-5, 1.0]], np.float32)


def _k4_close(got, want, got_valid=None, want_valid=None):
    if got_valid is not None:
        assert torch.equal(got_valid, want_valid)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _k4_img(rng, dev, hw, c):
    shape = hw if c == 1 else hw + (c,)
    return torch.as_tensor(rng.uniform(0, 1, shape).astype(np.float32), device=dev)


def _k4_perspective(img, H, out_hw, fill=0.3):
    """The kernel's warp_perspective against the plain version, launched once."""
    before = tw.warp_perspective.launches
    got, gv = tw.warp_perspective(img, H, out_hw, fill=fill)
    assert tw.warp_perspective.launches == before + 1
    want, wv = tw._warp_perspective_plain(img, tw.homography_inverse(H), out_hw, fill)
    assert got.shape == want.shape and gv.shape == tuple(out_hw)
    _k4_close(got, want, gv, wv)
    return gv


@pytest.mark.parametrize("hw", [(93, 201), (1, 1)])
@pytest.mark.parametrize("c", [1, 3])
def test_k4_warps_match_plain(rng, dev, hw, c):
    img = _k4_img(rng, dev, hw, c)
    _k4_perspective(img, H_TILT, (hw[0] + 7, hw[1] + 13))
    for f in (150.0, 300.0):
        _k4_close(tw.warp_spherical(img, f), tw._warp_field(img, tw._SPHERICAL, f))
        _k4_close(tw.warp_cylindrical(img, f), tw._warp_field(img, tw._CYLINDRICAL, f))


# the regimes of the whole-tile shortcut (tests/test_torch_warp.py REGIMES)
K4_REGIMES = {
    "paste": (np.asarray([[1.0, 0.0, 63.37], [0.0, 1.0, 0.29], [0.0, 0.0, 1.0]], np.float32),
              (48, 64), (48, 531)),
    "paste_full": (np.asarray([[1.0, 0.0, 630.04], [0.0, 1.0, 0.31], [0.0, 0.0, 1.0]],
                              np.float32), (480, 640), (481, 2111)),
    "horizon": (np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.01, 0.0, 1.0]], np.float32),
                (93, 201), (93, 201)),
    "outside": (np.asarray([[0.9, 0.1, 5000.0], [-0.1, 0.9, 40.0], [1e-5, 0.0, 1.0]],
                           np.float32), (40, 57), (61, 130)),
}


@pytest.mark.parametrize("regime", sorted(K4_REGIMES))
@pytest.mark.parametrize("c", [1, 3, 4])
def test_k4_perspective_regimes_bit_exact(rng, dev, regime, c):
    H, hw, out_hw = K4_REGIMES[regime]
    gv = _k4_perspective(_k4_img(rng, dev, hw, c), H, out_hw, fill=0.4)
    skip = warp_tiles.kernel_shortcut_tiles(tw.homography_inverse(H), hw, out_hw)
    ty, tx = warp_tiles.tile_of_pixels(out_hw)
    assert not gv.cpu().numpy()[skip[ty, tx]].any()
    if regime.startswith("paste"):
        assert skip.mean() > 0.5


def _k4_homographies(seed, n=10):
    """Seeded homographies onto the canvas: tilted similarities, shifts up
    to 300 px, perspective terms that put a horizon on the canvas now and
    then, every fifth nearly singular (rank 1 plus 1e-4 of the identity)."""
    r = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 5 == 4:
            u, v = r.normal(size=3), r.normal(size=3)
            out.append((np.outer(u, v) + 1e-4 * np.eye(3)).astype(np.float32))
            continue
        a, s = r.uniform(-0.5, 0.5), r.uniform(0.5, 2.0)
        out.append(np.asarray([[s * np.cos(a), -s * np.sin(a), r.uniform(-300, 300)],
                               [s * np.sin(a), s * np.cos(a), r.uniform(-80, 80)],
                               [r.normal(0, 2e-3), r.normal(0, 2e-3), 1.0]], np.float32))
    return out


def _k4_shortcut_cases():
    cases = [(name,) + K4_REGIMES[name] for name in sorted(K4_REGIMES)]
    for seed in range(5):
        cases += [(f"random{seed}.{k}", H, (93, 201), (131, 413))
                  for k, H in enumerate(_k4_homographies(seed))]
    return cases + [(f"canvas{hw}", np.asarray([[1.0, 0.0, 0.37 * hw[1]], [0.0, 1.0, -0.21],
                                                [0.0, 0.0, 1.0]], np.float32), hw, hw)
                    for hw in ((1, 1), (7, 33), (93, 201), (481, 2111))]


@pytest.mark.parametrize("case", range(len(_k4_shortcut_cases())))
def test_k4_shortcut_tiles_host_copy_is_the_kernels(dev, case):
    """tools/warp_tiles.py's host copy of the whole-tile test (its tile
    geometry and margin rule) decides as the kernel does, tile for tile, so
    the CPU tests that hold the copy against the plain warp hold the
    kernel's rule."""
    name, H, hw, out_hw = _k4_shortcut_cases()[case]
    Hinv = tw.homography_inverse(H)
    got = warp_tiles.kernel_shortcut_tiles(Hinv, hw, out_hw)
    want = warp_tiles.shortcut_tiles(Hinv, hw, out_hw)
    assert got.shape == want.shape, name
    assert np.array_equal(got, want), (name, int((got != want).sum()))


@pytest.mark.parametrize("seed", range(5))
def test_k4_random_homographies_bit_exact(rng, dev, seed):
    img = _k4_img(rng, dev, (93, 201), 3)
    for H in _k4_homographies(seed):
        _k4_perspective(img, H, (131, 413))


# canvases that do not divide into 8 x 128 tiles, and a row pitch that
# is not a multiple of 4 pixels
@pytest.mark.parametrize("hw", [(1, 1), (7, 33), (93, 201), (481, 2111)])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_k4_canvas_sizes_bit_exact(rng, dev, hw, c):
    img = _k4_img(rng, dev, hw, c)
    shift = np.asarray([[1.0, 0.0, 0.37 * hw[1]], [0.0, 1.0, -0.21], [0.0, 0.0, 1.0]],
                       np.float32)
    _k4_perspective(img, shift, hw)
    _k4_perspective(img, H_TILT, hw)
    f = 0.9 * max(hw)
    _k4_close(tw.warp_spherical(img, f), tw._warp_field(img, tw._SPHERICAL, f))
    _k4_close(tw.warp_cylindrical(img, f), tw._warp_field(img, tw._CYLINDRICAL, f))


@pytest.mark.parametrize("hw", [(93, 201), (1, 1)])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("clamp", [False, True])
def test_k4_remap_matches_plain(rng, dev, hw, c, clamp):
    img = _k4_img(rng, dev, hw, c)
    h, w = hw
    xy = np.stack([rng.uniform(-4, w + 4, (37, 11)), rng.uniform(-4, h + 4, (37, 11))],
                  -1).astype(np.float32)
    xy[0, :6] = [[np.nan, 1.0], [1.0, np.nan], [np.inf, 0.0], [0.0, -np.inf],
                 [1e9, -1e9], [-3e7, 2.0]]
    xy = torch.as_tensor(xy, device=dev)
    got, gv = tw.remap_xy(img, xy, fill=0.7, clamp=clamp)
    want, wv = tw.bilinear_sample(img, xy, fill=0.7, clamp=clamp)
    assert torch.equal(gv, wv) and not bool(gv[0, :6].any())
    _k4_close(got, want)
    if not clamp:                        # out of the image: the fill value
        assert bool((got[~gv] == 0.7).all())
    else:                                # far out: a border pixel, finite
        assert bool(torch.isfinite(got[0, 4:6]).all())
    v = torch.as_tensor(rng.uniform(-3, h + 3, (h + 5, w)).astype(np.float32), device=dev)
    v[0, 0] = float("nan")
    v[-1, -1] = 1e9
    _k4_close(tw.remap_rows(img, v), tw._remap_rows_plain(img, v))
    u = torch.as_tensor(rng.uniform(-3, w + 3, (h, w + 9)).astype(np.float32), device=dev)
    u[0, 0] = -float("inf")
    _k4_close(tw.remap_cols(img, u), tw._remap_cols_plain(img, u))


# widths whose rows are not whole 4-pixel groups, and fields at an offset
# of one float (4-byte aligned: the kernel reads them without vector loads)
@pytest.mark.parametrize("w", [1, 5, 33, 203, 1237])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("offset", [0, 1])
def test_k4_remap_rows_cols_unaligned(rng, dev, w, c, offset):
    h = 37
    img = _k4_img(rng, dev, (h, w), c)
    buf = torch.as_tensor(rng.uniform(-3, h + 3, 2 * h * w + 1).astype(np.float32), device=dev)
    v = buf[offset:offset + (h + 4) * w].view(h + 4, w)
    _k4_close(tw.remap_rows(img, v), tw._remap_rows_plain(img, v))
    ubuf = torch.as_tensor(rng.uniform(-3, w + 3, h * (w + 7) + 1).astype(np.float32),
                           device=dev)
    u = ubuf[offset:offset + h * (w + 7)].view(h, w + 7)
    _k4_close(tw.remap_cols(img, u), tw._remap_cols_plain(img, u))


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("clamp", [False, True])
def test_k4_remap_xy_field_at_a_4_byte_offset(rng, dev, c, clamp):
    """A field that is contiguous but only 4-byte aligned takes two 4-byte
    loads per pair inside the kernel; the samples are those of an aligned
    copy and of the plain version."""
    img = _k4_img(rng, dev, (61, 83), c)
    n = 1001
    pairs = np.stack([rng.uniform(-3, 86, n), rng.uniform(-3, 64, n)], -1).astype(np.float32)
    buf = torch.zeros(2 * n + 1, device=dev)
    buf[1:] = torch.as_tensor(pairs.ravel(), device=dev)
    xy = buf[1:].view(n, 2)
    assert xy.data_ptr() % 8 == 4 and xy.is_contiguous()
    got, gv = tw.remap_xy(img, xy, fill=0.2, clamp=clamp)
    again, av = tw.remap_xy(img, xy.clone(), fill=0.2, clamp=clamp)
    want, wv = tw.bilinear_sample(img, xy, fill=0.2, clamp=clamp)
    assert torch.equal(gv, wv) and torch.equal(av, wv)
    _k4_close(got, want)
    _k4_close(again, want)


def test_k4_fill_against_clamp(rng, dev):
    img = _k4_img(rng, dev, (40, 60), 3)
    xy = torch.as_tensor([[-2.5, 10.0], [30.0, 50.5], [12.25, 7.5]], device=dev)
    filled, v1 = tw.remap_xy(img, xy, fill=-1.0)
    clamped, v2 = tw.remap_xy(img, xy, clamp=True)
    assert torch.equal(v1, v2) and v1.tolist() == [False, False, True]
    assert bool((filled[:2] == -1.0).all())
    torch.testing.assert_close(clamped[0], img[10, 0], rtol=0, atol=0)
    torch.testing.assert_close(clamped[1], img[39, 30], rtol=0, atol=0)
    torch.testing.assert_close(filled[2], clamped[2], rtol=0, atol=0)


def test_k4_wrappers_reject_bad_inputs(rng, dev):
    img = _k4_img(rng, dev, (30, 40), 3)
    field = torch.zeros(30, 40, device=dev)
    with pytest.raises(ValueError):
        tw.warp_spherical(img.double(), 100.0)
    with pytest.raises(ValueError):
        tw.warp_perspective(img.transpose(0, 1), H_TILT, (30, 40))     # not contiguous
    with pytest.raises(ValueError):
        tw.remap_rows(img, field.t().contiguous())                  # wrong shape
    with pytest.raises(ValueError):
        tw.remap_cols(img, field.double())
    with pytest.raises(ValueError):
        tw.remap_xy(img, torch.zeros(5, 2, 2, device=dev)[:, 0])       # not contiguous
    with pytest.raises(ValueError):
        tw.remap_xy(img, torch.zeros(5, 2))                          # field on the CPU


# ---------------------------------------------------------------------------
# bundle adjustment on the card: fixed-order sums, so repeats are bit-equal
# ---------------------------------------------------------------------------

def _ba_problem(dev, seed=0, **kw):
    from dr3_tpu_torch import convert
    from torch_parity import ba_case

    return convert.ba_problem(ba_case(seed, **kw), device=dev)


def _bits_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


@pytest.mark.parametrize("solver", ["pcg", "zexplicit", "explicit"])
@pytest.mark.parametrize("intrinsics", [False, True])
def test_bundle_adjust_repeats_bit_equal(dev, solver, intrinsics):
    """Two bundle_adjust calls on the same problem give the same bits (no
    float atomics: point sums are a fixed-order scan, camera sums a 0/1
    product)."""
    from dr3_tpu_torch.ba.schur_lm import bundle_adjust

    p = _ba_problem(dev)
    kw = dict(optimize_intrinsics=intrinsics, solver=solver, cg_iters=64, cg_tol=1e-2,
              q_eta=0.1)
    a = bundle_adjust(p, 8, 5.0, True, 1e-3, **kw)
    b = bundle_adjust(p, 8, 5.0, True, 1e-3, **kw)
    assert _bits_equal(a.problem, b.problem)
    assert torch.equal(a.final_cost, b.final_cost) and a.cg_iters == b.cg_iters
    assert float(a.final_cost) < float(a.initial_cost)


def test_pose_only_adjust_repeats_bit_equal(dev):
    from dr3_tpu_torch.ba.schur_lm import pose_only_adjust

    p = _ba_problem(dev, n_cams=1, n_pts=546)
    p = p._replace(cam_fixed=torch.zeros_like(p.cam_fixed))
    a = pose_only_adjust(p, 10, 5.0)
    b = pose_only_adjust(p, 10, 5.0)
    assert _bits_equal(a.problem, b.problem) and torch.equal(a.final_cost, b.final_cost)


@pytest.mark.parametrize("solver", ["zexplicit", "explicit", "pcg"])
def test_bundle_adjust_card_matches_cpu(dev, solver):
    """The card's solve against the CPU's on the same problem: final cost
    within rtol 1e-4 (1e-3 for pcg's CG round-off), poses within 2e-3."""
    from dr3_tpu_torch.ba.schur_lm import bundle_adjust

    kw = dict(solver=solver, cg_iters=64, cg_tol=1e-2, q_eta=0.1)
    g = bundle_adjust(_ba_problem(dev), 8, 5.0, True, 1e-3, **kw)
    c = bundle_adjust(_ba_problem("cpu"), 8, 5.0, True, 1e-3, **kw)
    torch.testing.assert_close(g.final_cost.cpu(), c.final_cost,
                               rtol=1e-3 if solver == "pcg" else 1e-4, atol=0.0)
    torch.testing.assert_close(g.problem.cam_t.cpu(), c.problem.cam_t, rtol=0.0, atol=2e-3)


def _bal_problem(dev, padded=False):
    """bench.py's BAL generator at 24 x 6000 x 800 per camera; ``padded``
    appends every observation again as a zero-weight row (clamped ids that
    collide with the live ones in the co-visible block sums)."""
    from dr3_tpu_torch.ba.snavely import bal_to_snavely
    from dr3_tpu_torch.tools.ba_time import bal_case

    p = bal_to_snavely(bal_case(24, 6000, 800)[0], device=dev)
    if padded:
        twice = lambda a: torch.cat([a, a])  # noqa: E731
        p = p._replace(obs_cam=twice(p.obs_cam), obs_pt=twice(p.obs_pt),
                       obs_uv=twice(p.obs_uv),
                       obs_w=torch.cat([p.obs_w, torch.zeros_like(p.obs_w)]))
    return p


def _bal_blocks(p):
    from dr3_tpu_torch.ba.schur_core import cam_onehot_matrix
    from dr3_tpu_torch.ba.snavely import _assemble_direct

    E = cam_onehot_matrix(p.obs_cam, p.n_cams)
    return _assemble_direct(p, E, 1e9), E


def test_bal_schur_blocks_bit_stable(dev):
    """The co-visible block kernels (ops/schur.py) on the card: with every
    observation present again as a zero-weight padding row whose ids
    collide with it, S~ is bit-equal to the unpadded problem's on the same
    Hcc and Hpp; two explicit solves on the padded blocks are bit-equal;
    the kernels match their plain versions run on the card (Hinv9, G and
    dinv within 1e-5 of their scale, each 9x9 block of S~ within 1e-5 of
    its own); an LM run launches each kernel once per iteration."""
    from dr3_tpu_torch.ba.schur_core import _table_reducer
    from dr3_tpu_torch.ba.snavely import _solve_explicit_direct, bundle_adjust_snavely
    from dr3_tpu_torch.ops import schur

    lam = torch.tensor(1e-3, device=dev)
    p, pad = _bal_problem(dev), _bal_problem(dev, padded=True)
    (blocks, _), _ = _bal_blocks(p)
    (blocks2, _), E2 = _bal_blocks(pad)
    Hcc, Hpp9 = blocks.Hcc.contiguous(), blocks.Hpp9.contiguous()

    def build(b):
        pairs = schur.schur_pairs(b.obs_cam, b.obs_pt,
                                  _table_reducer(b.obs_pt, b.Hpp9.shape[0]).table, p.n_cams)
        args = (Hpp9, Hcc, lam, b.Jcu, b.Jcv, b.Jpu, b.Jpv, pairs)
        Hinv9, G, dinv = schur.schur_factor(*args)
        return (Hinv9, G, dinv, schur.schur_blocks(G, dinv, Hcc, lam, pairs)), args, pairs

    one, args, pairs = build(blocks)
    assert torch.equal(build(blocks2)[0][3], one[3])
    a = _solve_explicit_direct(blocks2, lam, pad.cam_fixed, E2)
    b = _solve_explicit_direct(blocks2, lam, pad.cam_fixed, E2)
    assert _bits_equal(a, b)
    assert torch.isfinite(a[0]).all() and float(a[0][1:].abs().max()) > 0
    Hinv9, G, dinv = schur._schur_factor_plain(*args)
    for got, want in zip(one[:3], (Hinv9, G, dinv)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    S = schur._schur_blocks_plain(G, dinv, Hcc, lam, pairs)
    K = p.n_cams
    got4 = one[3].view(K, 9, K, 9)
    want4 = S.view(K, 9, K, 9)
    err = (got4 - want4).abs().amax(dim=(1, 3))
    assert bool((err <= 1e-5 * want4.abs().amax(dim=(1, 3))).all())
    f0, b0 = schur.schur_factor.launches, schur.schur_blocks.launches
    bundle_adjust_snavely(p, 5, huber_delta=1e9, solver="zexplicit")
    assert schur.schur_factor.launches - f0 == 5 and schur.schur_blocks.launches - b0 == 5


def test_bal_assembly_card_matches_cpu(dev):
    """_assemble_direct on the card against the CPU: every block within 1e-5
    of its scale, the cost rtol 1e-5, the same active rows."""
    (gb, gc), _ = _bal_blocks(_bal_problem(dev))
    (cb, cc), _ = _bal_blocks(_bal_problem("cpu"))
    torch.testing.assert_close(gc.cpu(), cc, rtol=1e-5, atol=0.0)
    assert torch.equal(gb.active.cpu(), cb.active)
    for name in ("Hcc", "bc", "Hpp9", "bp", "Jcu", "Jcv", "Jpu", "Jpv"):
        want = getattr(cb, name)
        err = float((getattr(gb, name).cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (name, err)


@pytest.mark.parametrize("solver", ["zexplicit", "pcg", "explicit", "pcg_generic"])
def test_bundle_adjust_snavely_repeats_bit_equal(dev, solver, monkeypatch):
    """Two LM runs give the same bits (the point sums a fixed-order table,
    the camera sums 0/1 products, each co-visible block of S one owner's
    fixed-order sum) and the same CG iterations. ``pcg_generic``: the
    one-hot's limit lowered, so the solve takes the generic pcg path, whose
    operator is the two kernels of csrc/schur_mv.cu, launched twice a CG
    iteration."""
    from dr3_tpu_torch.ba import schur_core, snavely
    from dr3_tpu_torch.ops import schur_mv

    p = _bal_problem(dev)
    if solver == "pcg_generic":
        monkeypatch.setattr(snavely, "_ONEHOT_MAX_ELEMS", 0)
        monkeypatch.setattr(schur_core, "_ONEHOT_MAX_ELEMS", 0)
        solver = "pcg"
        assert snavely._pick_method(p, solver) == ("pcg", False)
    n0 = schur_mv.schur_mv.launches
    a = snavely.bundle_adjust_snavely(p, 5, huber_delta=1e9, solver=solver)
    b = snavely.bundle_adjust_snavely(p, 5, huber_delta=1e9, solver=solver)
    assert _bits_equal(a.problem, b.problem) and torch.equal(a.final_cost, b.final_cost)
    assert a.cg_iters == b.cg_iters and float(a.final_cost) < float(a.initial_cost)
    generic = schur_core._ONEHOT_MAX_ELEMS == 0
    assert schur_mv.schur_mv.launches - n0 == (4 * a.cg_iters if generic else 0)


def _keyed_pcg(dev, case, monkeypatch):
    """A PCG over the keyed tables on the card: ``route``, bal-ladybug-1723's
    route (perfbench/gen/bal_route.py) cut to a tenth of its cameras, points
    and observations, at its first LM iteration; ``long_track``, 40 cameras
    that each see all 2,000 points (random weighted Jacobians, a tenth of
    the rows inactive); ``six_dof``, the same at 6 camera parameters."""
    from dr3_tpu_torch.ba import schur_core
    from dr3_tpu_torch.ba import snavely as sn
    from dr3_tpu_torch.io.bal import BALData
    from perfbench.gen.bal_route import route_case

    monkeypatch.setattr(schur_core, "_ONEHOT_MAX_ELEMS", 0)
    lam = torch.tensor(1e-3, device=dev)
    if case == "route":
        start, _ = route_case(172, 15650, 67872, 3)
        p = sn.bal_to_snavely(BALData(*(start[k] for k in ("cam_params", "points", "obs_cam",
                                                           "obs_pt", "obs_uv"))), device=dev)
        res = sn.linearize(p, 1e9)
        blocks = schur_core.assemble_blocks(res.r, res.Jc, res.Jp, p.obs_cam, p.obs_pt,
                                            (p.obs_w > 0) & res.valid, p.n_cams, p.n_points)
        fixed = p.cam_fixed
    else:
        K, P, C = 40, 2000, (6 if case == "six_dof" else 9)
        g = torch.Generator(device=dev).manual_seed(7)
        active = torch.rand(K * P, generator=g, device=dev) > 0.1
        w = active.float()
        r = torch.randn(K * P, 2, generator=g, device=dev) * w[:, None]
        Jc = torch.randn(K * P, 2, C, generator=g, device=dev) * w[:, None, None]
        Jp = torch.randn(K * P, 2, 3, generator=g, device=dev) * w[:, None, None]
        blocks = schur_core.assemble_blocks(
            r, Jc, Jp, torch.arange(K, device=dev).repeat(P),
            torch.arange(P, device=dev).repeat_interleave(K), active, K, P)
        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[[0, 3]] = True
    red = schur_core.reduce_system(blocks, lam, fixed)
    cg = schur_core.PCG(red, fixed, 100, 1e-2, 0.1)
    assert cg.keyed is not None
    return cg, fixed


@pytest.mark.parametrize("case", ["route", "long_track", "six_dof"])
def test_schur_mv_kernel_matches_plain(dev, case, monkeypatch):
    """csrc/schur_mv.cu against its plain version: bit-equal to it run on
    the card (the same float32 operations in the same order), within 1e-6
    of its largest entry from it run on the CPU; fixed cameras passed
    through bit for bit, the same bits on a repeat, two launches a call."""
    from dr3_tpu_torch.ops import schur_mv

    cg, fixed = _keyed_pcg(dev, case, monkeypatch)
    args = cg.keyed
    if case == "long_track":
        assert args[3].shape[1] == args[6].shape[0]        # a point row as wide as K
    g = torch.Generator(device=dev).manual_seed(11)
    for _ in range(3):
        x = torch.randn(args[6].shape[:2], generator=g, device=dev)
        n0 = schur_mv.schur_mv.launches
        got = schur_mv.schur_mv(*args, x)
        torch.cuda.synchronize()
        assert schur_mv.schur_mv.launches - n0 == 2
        assert torch.equal(got, schur_mv._schur_mv_plain(*args, x))
        want = schur_mv._schur_mv_plain(*(a.cpu() for a in args), x.cpu()).to(dev)
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
        assert torch.equal(got[fixed], x[fixed])
        assert torch.equal(schur_mv.schur_mv(*args, x), got)


def test_schur_mv_rejects_bad_inputs(dev, monkeypatch):
    """The wrapper refuses what the kernels do not take: int32 ids, a
    non-contiguous block table, a camera block size they are not built
    for."""
    from dr3_tpu_torch.ops import schur_mv

    cg, _ = _keyed_pcg(dev, "six_dof", monkeypatch)
    AtB, oc, op, pt_tbl, cam_tbl, Hinv, Hcc, keep = cg.keyed
    x = torch.zeros(Hcc.shape[:2], device=dev)
    with pytest.raises(ValueError, match="obs_cam"):
        schur_mv.schur_mv(AtB, oc.int(), op, pt_tbl, cam_tbl, Hinv, Hcc, keep, x)
    with pytest.raises(ValueError, match="contiguous"):
        schur_mv.schur_mv(AtB, oc, op, pt_tbl.t().contiguous().t(), cam_tbl, Hinv, Hcc, keep, x)
    with pytest.raises(ValueError, match="size 5"):
        schur_mv.schur_mv(AtB[:, :5].contiguous(), oc, op, pt_tbl, cam_tbl, Hinv,
                          Hcc[:, :5, :5].contiguous(), keep, x[:, :5].contiguous())


def test_bal_products_run_in_float32_without_tf32(dev):
    """A run leaves TF32 off (torch's default, which the exact 0/1 products
    need), and on the card the broadcast through E reproduces the gather
    bit for bit, which a TF32 product (10-bit mantissa) would not."""
    from dr3_tpu_torch.ba.schur_core import _camera_reducer, cam_onehot_matrix
    from dr3_tpu_torch.ba.snavely import bundle_adjust_snavely

    assert torch.backends.cuda.matmul.allow_tf32 is False
    p = _bal_problem(dev)
    bundle_adjust_snavely(p, 2, huber_delta=1e9)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    params = torch.cat([p.cam_wxyz, p.cam_t, p.cam_fkk, 1.0 + torch.rand_like(p.cam_t)], 1)
    _, to_obs = _camera_reducer(p.obs_cam.long(), p.n_cams, cam_onehot_matrix(p.obs_cam,
                                                                               p.n_cams))
    assert torch.equal(to_obs(params), params[p.obs_cam.long()])


def test_k4_remap_xy_loop_descriptor_shape(rng, dev, monkeypatch):
    """remap_xy as the loop database calls it: 546 oriented 8x8 descriptor
    grids on pyramid level 2 of a KITTI frame (94x310, clamp) and the four
    rotated query images of level 3 (47x155); bit-exact against the plain
    version, and patch_descriptors' oriented path through the kernel equal
    to the same path through the plain sampler on the card."""
    from dr3_tpu_torch.ops import match

    img = torch.as_tensor(ndimage.gaussian_filter(rng.uniform(0, 1, (94, 310)), 1.0)
                          .astype(np.float32), device=dev)
    xy = torch.as_tensor(np.stack([rng.uniform(-4, 314, 546), rng.uniform(-4, 98, 546)], -1)
                         .astype(np.float32), device=dev)
    off = (torch.arange(8, dtype=torch.float32, device=dev) - 4 + 0.5) * 0.75
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    coords = (xy[:, None, None, :] + torch.stack([ox, oy], -1)[None]).contiguous()
    got, gv = tw.remap_xy(img, coords, clamp=True)
    want, wv = tw.bilinear_sample(img, coords, clamp=True)
    assert torch.equal(got, want) and torch.equal(gv, wv)
    valid = torch.ones(546, dtype=torch.bool, device=dev)
    d = match.patch_descriptors(img, xy, valid, patch=8, spread=0.75, oriented=True)
    monkeypatch.setattr(match, "remap_xy", tw.bilinear_sample)
    assert torch.equal(d, match.patch_descriptors(img, xy, valid, patch=8, spread=0.75,
                                                  oriented=True))
    small = img[::2, ::2].contiguous()[:47, :155].contiguous()
    ys, xs = torch.meshgrid(torch.arange(47, dtype=torch.float32, device=dev),
                            torch.arange(155, dtype=torch.float32, device=dev), indexing="ij")
    a = 6.0 * np.pi / 180.0
    rot = torch.stack([np.cos(a) * (xs - 77) - np.sin(a) * (ys - 23) + 77,
                       np.sin(a) * (xs - 77) + np.cos(a) * (ys - 23) + 23], -1).contiguous()
    got, gv = tw.remap_xy(small, rot, clamp=True)
    want, wv = tw.bilinear_sample(small, rot, clamp=True)
    assert torch.equal(got, want) and torch.equal(gv, wv)


# ---------------------------------------------------------------------------
# the general step as one CUDA graph (utils/cudagraph.py, pipelines/vo.py)
# ---------------------------------------------------------------------------

_VO_CAM = (320, 240, 280.0, 280.0, 160.0, 120.0)
# tests/test_vo_scan.py's _BASE with loop closure off
_VO_CFG = dict(init_min_features=60, init_min_tracked=60, init_min_triangulated=30,
               init_min_disparity=2.0, max_keyframes=16, kf_disparity=10.0,
               loop_closure=False)


@pytest.fixture(scope="module")
def vo_frames():
    from dr3_tpu_torch.utils.synth import NpSE3, make_textures, render_scene

    tn, tf = make_textures(np.random.default_rng(0))
    cam = Pinhole.create(*_VO_CAM)
    xs = [0.09 * i for i in range(14)] + [0.09 * (13 - i) for i in range(8)]
    return [render_scene(cam, NpSE3.exp([-x, 0, 0, 0, 0, 0]), tn, tf) for x in xs]


def _vo_run(frames, batched=False, **cfg):
    from dr3_tpu_torch.pipelines.vo import MonoVO
    from dr3_tpu_torch.utils.config import Config

    vo = MonoVO(Pinhole.create(*_VO_CAM), Config(**_VO_CFG, **cfg), device="cuda")
    out = vo.process_batch(frames) if batched else [vo.process(f) for f in frames]
    return vo, np.stack(out)


def _decisions(vo):
    return [(s.stage, s.is_keyframe, s.n_tracked, s.n_inliers) for s in vo.stats]


def test_vo_graph_replay_matches_eager(dev, vo_frames):
    """Config() replays the captured general step; fused_frontend=False runs
    it eagerly: the same decisions and positions within 1e-5."""
    g, _ = _vo_run(vo_frames)
    e, _ = _vo_run(vo_frames, fused_frontend=False)
    (graph,) = g.graphs.values()
    n_steps = sum(s.stage in ("general", "relocalize") for s in g.stats)
    assert (graph.captures, graph.replays) == (1, n_steps - 1) and n_steps >= 10
    assert not e.graphs
    assert _decisions(g) == _decisions(e)
    assert any(s.is_keyframe for s in g.stats if s.stage == "general")
    np.testing.assert_allclose(g.positions(), e.positions(), rtol=0, atol=1e-5)


def test_vo_launch_counters_count_replays(dev, vo_frames):
    """K1's two launches and sparse alignment's one per general step count
    every replay, and the capture itself adds nothing."""
    counters = (lk.track_pyramid, lk.align_to_templates, sa.sparse_align)
    for c in counters:
        c.launches = 0
    vo, _ = _vo_run(vo_frames)
    stages = [s.stage for s in vo.stats]
    n_tracked = sum(st != "first" for st in stages)
    n_steps = stages.count("general") + stages.count("relocalize")
    assert [c.launches for c in counters] == [n_tracked, n_tracked, n_steps]


def test_vo_process_batch_is_process_on_the_card(dev, vo_frames):
    """process_batch (the device-resident frame loop: one launch of its CUDA
    graph program per batch of 8) gives the bits of per-frame process on
    the card."""
    a, out_a = _vo_run(vo_frames)
    b, out_b = _vo_run(vo_frames, batched=True, frames_per_dispatch=8)
    assert _decisions(a) == _decisions(b)
    np.testing.assert_array_equal(out_a, out_b)
    np.testing.assert_array_equal(np.stack(a.trajectory), np.stack(b.trajectory))


def test_vo_process_batch_is_process_on_the_card_zexplicit(dev, vo_frames, monkeypatch):
    """The same with ``ba_solver="zexplicit"``: window BA's dense solve (Z^T
    Z, its Cholesky and both triangular solves) runs inside the loop
    program's LM pieces, with no CG loop and no keyframe handed back to the
    host for its BA; the bits of per-frame process."""
    from dr3_tpu_torch.pipelines.vo import MonoVO

    host_ba = []
    run_ba = MonoVO._run_local_ba

    def spy(self, slot):
        host_ba.append(self.frame_idx)
        return run_ba(self, slot)

    a, out_a = _vo_run(vo_frames, ba_solver="zexplicit")
    monkeypatch.setattr(MonoVO, "_run_local_ba", spy)
    b, out_b = _vo_run(vo_frames, batched=True, frames_per_dispatch=8, ba_solver="zexplicit")
    assert _decisions(a) == _decisions(b)
    assert b.n_window_ba == a.n_window_ba and b.n_window_ba > len(host_ba)
    assert b.n_cg_iters == a.n_cg_iters == 0 and len(b.scan_programs) == 1
    np.testing.assert_array_equal(out_a, out_b)
    np.testing.assert_array_equal(np.stack(a.trajectory), np.stack(b.trajectory))


def test_dense_camera_step_replays_the_eager_bits(dev):
    """The dense solves' camera step at the VO window's size (32 keyframes
    x 6: the gauge fix, Jacobi scaling, ``cholesky_ex`` and both
    ``solve_triangular``, ba/schur_core.py ``_dense_camera_step``),
    captured in a CUDA graph on a side stream as the loop program's
    ``lm_pre`` piece holds it: no host synchronisation under capture, and
    a replay gives the eager call's bits (the solution within 1e-3 of a
    float64 solve)."""
    from dr3_tpu_torch.ba.schur_core import _dense_camera_step

    rng = np.random.default_rng(0)
    K, C = 32, 6
    A = rng.normal(size=(K * C, 400))
    M = A @ A.T / 400 + np.eye(K * C)
    Hcc = np.stack([M[k * C:(k + 1) * C, k * C:(k + 1) * C] for k in range(K)])
    S_corr = np.zeros((K * C, K * C))
    for k in range(K):
        S_corr[k * C:(k + 1) * C, k * C:(k + 1) * C] = Hcc[k]
    S_corr = (S_corr - M).reshape(K, C, K, C)
    keep = np.ones(K * C)
    keep[:2 * C] = 0.0                       # the two gauge-fixed keyframes
    rhs = rng.normal(size=K * C)
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (S_corr, Hcc, rhs, keep)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = _dense_camera_step(*args, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = _dense_camera_step(*args, True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    S = M * keep[:, None] * keep[None, :] + np.diag(1.0 - keep)
    d = np.sqrt(np.diag(S))
    want = np.linalg.solve(S / d[:, None] / d[None, :] + 1e-6 * np.eye(K * C),
                           rhs * keep / d) / d
    np.testing.assert_allclose(eager.cpu().numpy(), want, atol=1e-3)


def test_step_graph_counts_and_copies(dev):
    """StepGraph on a kernel wrapper: eager first call, then replays on
    fresh inputs; each call counts one launch; outputs are the caller's."""
    from dr3_tpu_torch.utils.cudagraph import StepGraph

    rng = np.random.default_rng(5)
    imgs = [torch.as_tensor(rng.uniform(0, 1, (60, 80)).astype(np.float32), device=dev)
            for _ in range(3)]
    pts = torch.as_tensor(rng.uniform(5, 55, (40, 2)).astype(np.float32), device=dev)
    lk.sample_patches.launches = 0
    g = StepGraph(lambda img, p: (lk.sample_patches(img, p, 2), img + 1.0), (lk.sample_patches,))
    outs = [g(img, pts) for img in imgs]
    assert lk.sample_patches.launches == 3 and (g.captures, g.replays) == (1, 2)
    for img, (patches, plus) in zip(imgs, outs):
        assert torch.equal(patches, lk.sample_patches(img, pts, 2))   # the kernel, eagerly
        assert torch.equal(plus, img + 1.0)
    assert outs[1][0].data_ptr() != outs[2][0].data_ptr()
    with pytest.raises(ValueError, match="captured as"):
        g(imgs[0][:30], pts)


def test_step_graph_capture_raises_on_a_sync(dev):
    """A step that reads a value back to the host cannot be captured: the
    runner raises, and never falls back to running the step eagerly."""
    from dr3_tpu_torch.utils.cudagraph import StepGraph

    x = torch.ones(8, device=dev)
    g = StepGraph(lambda t: (t * float(t.sum()),))
    with pytest.raises(RuntimeError):
        g(x)
    assert g.graph is None and g.captures == 0
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 16.0       # the card still works


def test_entry_step_graph_replays_match_eager(dev):
    """entry()'s step (dr3_tpu_torch/entry.py) in one StepGraph, chained
    over 6 frames as the bench's frontend metric chains it: one capture,
    5 replays, K1 counted once per frame, each frame's outputs bit-equal
    to the eager step's on the same inputs."""
    from dr3_tpu_torch.entry import entry, graph_step
    from dr3_tpu_torch.utils.cudagraph import StepGraph

    step, args = entry(device=dev)
    n_levels = len(args[0])
    flat = graph_step(step, n_levels)
    lk.track_pyramid.launches = 0
    g = StepGraph(flat, (lk.track_pyramid,))
    pyr, px = args[0], args[2]
    for i in range(6):
        x = (*pyr, (args[0][0], args[1])[i % 2], px, *args[3:])
        got, want = g(*x), flat(*x)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        pyr, px = got[:n_levels], got[n_levels].clamp(25.0, 351.0)
    assert (g.captures, g.replays) == (1, 5)
    assert lk.track_pyramid.launches == 12      # 6 in the graph, 6 eager
