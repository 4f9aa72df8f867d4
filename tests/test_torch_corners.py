"""Port parity for kernel K3's function (fused corner response) and the
detection built on it: dr3_tpu.ops.corners (jnp oracle) vs
dr3_tpu_torch.ops.corners on the CPU (plain twin, wrap-around rolls
included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp
from scipy import ndimage

from dr3_tpu.ops import corners as jc
from dr3_tpu.ops.pyramid import build_pyramid as jpyr
from dr3_tpu_torch.ops import corners as tc
from dr3_tpu_torch.ops.pyramid import build_pyramid as tpyr
from tests.torch_parity import nn, tt


def _image(rng, h, w):
    base = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 1.5)
    return (0.6 * (base > np.median(base)) + 0.4 * rng.uniform(0, 1, (h, w))) \
        .astype(np.float32)


@pytest.mark.parametrize("hw", [(48, 64), (94, 310), (61, 77)])
def test_corner_response_exact_corner_set(rng, hw):
    """FAST scores are differences/min/max of the same float32 values, so
    the corner set is exact; Shi-Tomasi box sums may round differently
    (rtol 2e-3, atol 0.05 as tests/test_detect_pallas.py:16-21)."""
    img = _image(rng, *hw)
    for t in (10.0, 20.0):
        fj = nn(jc.fast_score_map(jnp.asarray(img), t))
        ft = nn(tc.fast_score_map(tt(img), t))
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(nn(tc.nms3x3(tt(fj))), nn(jc.nms3x3(jnp.asarray(fj))))
        want = nn(jc.corner_response(jnp.asarray(img), t))
        got = nn(tc.corner_response(tt(img), t))
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.05)
    np.testing.assert_allclose(nn(tc.shi_tomasi_map(tt(img))),
                               nn(jc.shi_tomasi_map(jnp.asarray(img))), rtol=2e-3, atol=0.05)


@pytest.mark.parametrize("with_occupancy", [False, True])
def test_detect_features_matches(rng, with_occupancy):
    img = _image(rng, 120, 160)
    occ_j = occ_t = None
    if with_occupancy:
        xy = rng.uniform([0, 0], [160, 120], (30, 2)).astype(np.float32)
        valid = rng.uniform(size=30) > 0.3
        occ_j = jc.make_occupancy(jnp.asarray(xy), jnp.asarray(valid), (120, 160), 30)
        occ_t = tc.make_occupancy(tt(xy), tt(valid), (120, 160), 30)
        np.testing.assert_array_equal(nn(occ_t), nn(occ_j))
    fj = jc.detect_features(jpyr(jnp.asarray(img), 3), 30, 20.0, 10.0, occupancy=occ_j)
    ft = tc.detect_features(tpyr(tt(img), 3), 30, 20.0, 10.0, occupancy=occ_t)
    np.testing.assert_array_equal(nn(ft.valid), nn(fj.valid))
    np.testing.assert_array_equal(nn(ft.level), nn(fj.level))
    np.testing.assert_array_equal(nn(ft.xy), nn(fj.xy))
    np.testing.assert_allclose(nn(ft.score), nn(fj.score), rtol=2e-3, atol=0.05)
    assert int(ft.n) > 0


# ---------------------------------------------------------------------------
# the plain forms of what kernel K3 does otherwise than the oracle: the
# half-ring test that lets it skip a pixel's arcs (and the compass-pair
# test it implies), and the arc minima by doubling
# ---------------------------------------------------------------------------

def _kind_image(kind, rng, h=40, w=56):
    if kind == "random":
        return rng.uniform(0, 1, (h, w)).astype(np.float32)
    if kind == "step_edge":
        img = np.full((h, w), 0.2, np.float32)
        img[h // 3:, w // 2:] = 0.8          # an L-shaped step: one strong corner
        return img + rng.uniform(0, 0.02, (h, w)).astype(np.float32)
    if kind == "checkerboard":
        ys, xs = np.mgrid[0:h, 0:w]
        return (((ys // 7 + xs // 7) % 2) * 0.7 + 0.1).astype(np.float32)
    return _image(rng, h, w)


def compass_pass_map(img, threshold):
    """The weaker test the half-ring test implies: two adjacent of the ring's
    four compass points (positions 0, 4, 8, 12) on one side of the threshold."""
    d = tc._ring_differences(img)[0::4]
    bright, dark = d > threshold, -d > threshold
    return ((bright & torch.roll(bright, -1, dims=0)).any(0)
            | (dark & torch.roll(dark, -1, dims=0)).any(0))


def _assert_no_corner_rejected(img, threshold):
    score = tc.fast_score_map(tt(img), threshold)
    passed = tc.half_ring_pass_map(tt(img), threshold)
    compass = compass_pass_map(tt(img), threshold)
    inner = tc._border_mask(*img.shape, 3, "cpu")         # the rolls wrap outside it
    assert not bool(((score > 0) & ~passed).any())
    assert not bool((passed & ~compass & inner).any())    # the half ring implies the pair
    return int((score > 0).sum()), int((passed & inner).sum()), int((compass & inner).sum())


@pytest.mark.parametrize("threshold", [5.0, 20.0, 40.0])
@pytest.mark.parametrize("kind", ["random", "step_edge", "checkerboard", "blobs"])
def test_half_ring_test_rejects_no_corner(rng, kind, threshold):
    """Every pixel with a FAST score has 5 consecutive even ring pixels on
    one side of the threshold, so the kernel's early rejection loses none."""
    n_corners, n_passed, n_compass = _assert_no_corner_rejected(_kind_image(kind, rng),
                                                                threshold)
    assert n_compass >= n_passed >= n_corners
    if kind == "checkerboard":
        # an X-junction has no 10-arc: the compass pair passes pixels there
        # that the half ring and the score drop
        assert n_compass > n_passed
    elif kind != "random" or threshold < 40.0:
        assert n_corners > 0                 # the rule is tested on corners, not on none


@settings(max_examples=40, deadline=None)
@given(img=hnp.arrays(np.float32, (14, 15), elements=st.sampled_from(
           [0.0, 0.1, 0.25, 0.3, 0.5, 0.55, 0.8, 1.0]).map(np.float32)),
       threshold=st.sampled_from([5.0, 20.0, 40.0]))
def test_half_ring_test_rejects_no_corner_drawn(img, threshold):
    """The same on drawn images of a few grey levels (where arcs are common)."""
    _assert_no_corner_rejected(img, threshold)


@pytest.mark.parametrize("kind", ["random", "step_edge", "blobs"])
def test_arc_minimum_by_doubling_is_bit_equal(rng, kind):
    d = tc._ring_differences(tt(_kind_image(kind, rng)))
    for sign_d in (d, -d):
        assert torch.equal(tc.arc_min_doubling(sign_d), tc.arc_min_rolled(sign_d))


@pytest.mark.parametrize("n_levels", [1, 3])
def test_corner_response_pyramid_is_the_per_level_call(rng, n_levels):
    levels = tpyr(tt(_image(rng, 96, 128)), n_levels)
    before = (tc.corner_response_pyramid.launches, tc.corner_response.launches)
    got = tc.corner_response_pyramid(levels, 10.0)
    assert len(got) == n_levels
    for img, g in zip(levels, got):
        assert g.shape == img.shape and torch.equal(g, tc.corner_response(img, 10.0))
    assert int((got[0] > 0).sum()) > 0
    # CPU tensors take the plain version: no launch is counted
    assert (tc.corner_response_pyramid.launches, tc.corner_response.launches) == before
