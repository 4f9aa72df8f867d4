"""Port parity for the stitch/panorama slice: dr3_tpu_torch.pipelines.stitch
and .panorama against dr3_tpu's on the CPU, on tests/test_stitch_panorama.py's
scene() at 240x320 and on rendered sphere views (exact ground truth).

The canvas bbox floors and ceils the warped corners. Where a view's true
shift is a whole number of pixels (the strip's crops), a 1e-4 px difference
between the two packages' H may move an edge of the canvas, or its origin,
by one pixel; there the canvases are compared on their common part, placed
by origin_, away from the views' edges, where every pixel sits on that
knife edge of the validity test. Stitch.process runs on a sub-pixel shift
and keeps its shape.

RANSAC's minimal sets are shared: the port's sampler is replaced by one
that follows the JAX Stitch's key chain (PRNGKey(seed), one split per
pair), as tests/test_torch_vo.py does for the two-view init. The JAX
Panorama runs with transfer_uint8=False, the f32 canvas the port returns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from dr3_tpu.geometry import ransac as jransac
from dr3_tpu.pipelines.panorama import Panorama as JPanorama
from dr3_tpu.pipelines.panorama import PanType as JPanType
from dr3_tpu.pipelines.stitch import Stitch as JStitch
from dr3_tpu.utils.config import Config as JConfig
from dr3_tpu_torch.geometry import ransac as transac
from dr3_tpu_torch.pipelines.panorama import Panorama, PanType
from dr3_tpu_torch.pipelines.stitch import Stitch
from dr3_tpu_torch.utils import synth
from dr3_tpu_torch.utils.config import Config
from tests.test_stitch_panorama import scene
from tests.torch_parity import nn

# H as the transfer of the image corners: LK positions agree to ~2e-3 px
# (tests/test_torch_lk.py) and the refit averages them
H_CORNER_PX = 0.05
# canvases: the same warps of the same images through homographies that
# differ by ~1e-3 px; the scene's binary edges step by 0.7 within a pixel
CANVAS_ATOL = 1e-3


class _JaxMinimalSets:
    """The port's RANSAC sampler, drawing with the JAX Stitch's key chain."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, generator, n_points, weights, n_samples, sample_size):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        idx = jransac.sample_minimal_sets(sub, n_points, jnp.asarray(nn(weights)),
                                          n_samples, sample_size)
        return torch.as_tensor(np.array(idx))


@pytest.fixture()
def jax_draws(monkeypatch):
    sampler = _JaxMinimalSets()
    monkeypatch.setattr(transac, "sample_minimal_sets", sampler)
    return sampler


def _registered(a, origin_a, b, origin_b):
    """The common part of two canvases placed by their origins (image-0
    pixels of their (0, 0)), and its own origin; shapes and origins within
    one pixel."""
    assert all(abs(p - q) <= 1 for p, q in zip(a.shape, b.shape))
    assert all(abs(p - q) <= 1 for p, q in zip(origin_a, origin_b))
    x0, y0 = max(origin_a[0], origin_b[0]), max(origin_a[1], origin_b[1])
    x1 = min(origin_a[0] + a.shape[1], origin_b[0] + b.shape[1])
    y1 = min(origin_a[1] + a.shape[0], origin_b[1] + b.shape[0])

    def crop(c, o):
        return c[int(y0 - o[1]):int(y1 - o[1]), int(x0 - o[0]):int(x1 - o[0])]

    return crop(a, origin_a), crop(b, origin_b), (x0, y0)


def _corner_gap(Ha, Hb, w=320, h=240) -> float:
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64).T
    a = np.asarray(Ha, np.float64) @ c
    b = np.asarray(Hb, np.float64) @ c
    return float(np.abs(a[:2] / a[2] - b[:2] / b[2]).max())


@pytest.mark.parametrize("translate_only", [False, True], ids=["homography", "translate"])
def test_align_pair_matches(rng, jax_draws, translate_only):
    img = scene(rng)
    right = ndimage.shift(img, (-6.0, -40.0), order=1, mode="nearest").astype(np.float32)
    aj = JStitch(JConfig(), translate_only=translate_only).align_pair(img, right)
    at = Stitch(Config(), translate_only=translate_only, device="cpu").align_pair(img, right)
    assert jax_draws.calls == 1
    assert at.n_inliers >= 12 and abs(at.n_inliers - aj.n_inliers) <= 2
    assert abs(at.n_matches - aj.n_matches) <= 2
    assert _corner_gap(at.H, aj.H) < H_CORNER_PX
    np.testing.assert_allclose(at.H[:2, 2], [-40.0, -6.0], atol=1.0)
    assert at.H.dtype == np.float32 and at.inliers.shape == at.p_left.shape[:1]


def test_stitch_process_matches(rng, jax_draws):
    img = scene(rng)
    right = ndimage.shift(img, (-0.4, -50.3), order=1, mode="nearest").astype(np.float32)
    out_j, Hj = JStitch(JConfig()).process(img, right)
    out_t, Ht = Stitch(Config(), device="cpu").process(img, right)
    assert tuple(out_t.shape) == out_j.shape
    assert _corner_gap(Ht, Hj) < H_CORNER_PX
    np.testing.assert_allclose(nn(out_t), out_j, rtol=0, atol=CANVAS_ATOL)


def test_panorama_three_views_matches(rng, jax_draws):
    wide = scene(rng, 240, 640)
    views = [wide[:, 0:320], wide[:, 110:430], wide[:, 220:540]]
    pj = JPanorama(feathering_width=20, transfer_uint8=False)
    out_j = pj.process(views)
    pt = Panorama(feathering_width=20, device="cpu")
    out_t = pt.process(views)
    assert jax_draws.calls == 2
    for Ht, Hj in zip(pt.homographies_, pj.homographies_):
        assert _corner_gap(Ht, Hj) < H_CORNER_PX
    got, want, (x0, y0) = _registered(nn(out_t), pt.origin_, out_j, pj.origin_)
    ys, xs = np.mgrid[0:got.shape[0], 0:got.shape[1]]
    xs, ys = xs + x0, ys + y0                   # image-0 pixels
    inner = np.ones(got.shape, bool)
    for e in (0, 110, 220, 319, 429, 539):      # the views' column edges
        inner &= np.abs(xs - e) > 1
    for e in (0, 239):
        inner &= np.abs(ys - e) > 1
    assert inner.mean() > 0.9
    np.testing.assert_allclose(got[inner], want[inner], rtol=0, atol=CANVAS_ATOL)
    assert abs(out_t.shape[1] - 540) < 12


def test_panorama_translate_spherical_matches(jax_draws):
    """TRANSLATE mode with the spherical pre-warp on three rendered views of
    a textured sphere, 0.3 rad apart: after the pre-warp the views are
    exact shifts of f * 0.3 = 90 px."""
    f, yaw, w, h = 300.0, 0.3, 320, 240
    tex = synth.sphere_texture(np.random.default_rng(7), f, lon=(-1.0, 1.6), lat=(-0.7, 0.7))
    views = [synth.render_sphere_view(tex, f, -1.0, -0.7, f, f, w / 2, h / 2, w, h, yaw * k)
             for k in range(3)]
    pj = JPanorama(focal_length=f, pan_type=JPanType.TRANSLATE, transfer_uint8=False)
    out_j = pj.process(views)
    pt = Panorama(focal_length=f, pan_type=PanType.TRANSLATE, device="cpu")
    out_t = pt.process(views)
    assert tuple(out_t.shape) == out_j.shape and pt.origin_ == pj.origin_
    for k, (Ht, Hj) in enumerate(zip(pt.homographies_, pj.homographies_)):
        assert _corner_gap(Ht, Hj) < H_CORNER_PX
        np.testing.assert_allclose(Ht[:2, :2], np.eye(2), atol=0)
        assert abs(Ht[0, 2] - f * yaw * k) < 0.5 and abs(Ht[1, 2]) < 0.5
    np.testing.assert_allclose(nn(out_t), out_j, rtol=0, atol=CANVAS_ATOL)
