"""Port parity for dr3_tpu_torch.ops.match (ZNCC descriptors, matching)
and ops.blend (feathering, accumulation, normalisation) on the CPU, against
dr3_tpu (JAX) on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from dr3_tpu.ops import blend as jb
from dr3_tpu.ops import match as jm
from dr3_tpu_torch.ops import blend as tb
from dr3_tpu_torch.ops import match as tm
from tests.torch_parity import nn, tt

# descriptors: float32 bilinear samples, mean removal and normalisation in
# another summation order; unit-norm rows agree to 1e-5
DESC_ATOL = 1e-5


def _textured(rng, h=96, w=128):
    img = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 1.5).astype(np.float32)
    return (img - img.min()) / (img.max() - img.min())


@pytest.mark.parametrize("oriented", [False, True])
def test_patch_descriptors_match(rng, oriented):
    img = _textured(rng)
    xy = rng.uniform(-3, 100, (40, 2)).astype(np.float32)   # some near / past the border
    valid = rng.uniform(size=40) > 0.2
    kw = dict(patch=8, spread=3.0) if oriented else {}
    dj = jm.patch_descriptors(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid),
                              oriented=oriented, **kw)
    dt = tm.patch_descriptors(tt(img), tt(xy), tt(valid), oriented=oriented, **kw)
    np.testing.assert_allclose(nn(dt), nn(dj), rtol=0, atol=DESC_ATOL)
    assert not nn(dt)[~valid].any()


def test_match_descriptors_match(rng):
    img = _textured(rng)
    img2 = ndimage.shift(img, (2.0, 10.0), order=1, mode="nearest").astype(np.float32)
    xy1 = rng.uniform(12, 110, (64, 2)).astype(np.float32)
    xy2 = (xy1 + np.asarray([10.0, 2.0], np.float32))[rng.permutation(64)]
    v1 = rng.uniform(size=64) > 0.1
    v2 = rng.uniform(size=64) > 0.1
    d1 = tm.patch_descriptors(tt(img), tt(xy1), tt(v1))
    d2 = tm.patch_descriptors(tt(img2), tt(xy2), tt(v2))
    for kw in ({}, dict(min_score=0.7, ratio=0.99, mutual=False)):
        mj = jm.match_descriptors(jnp.asarray(nn(d1)), jnp.asarray(nn(d2)),
                                  jnp.asarray(v1), jnp.asarray(v2), **kw)
        mt = tm.match_descriptors(d1, d2, tt(v1), tt(v2), **kw)
        np.testing.assert_array_equal(nn(mt.ok), nn(mj.ok))
        ok = nn(mj.ok)
        assert ok.sum() > 20
        np.testing.assert_array_equal(nn(mt.idx2)[ok], nn(mj.idx2)[ok])
        np.testing.assert_allclose(nn(mt.score)[ok], nn(mj.score)[ok], atol=1e-5)


@pytest.mark.parametrize("args", [(100, 20.0, 80.0, 10), (50, 10.0, 20.0, 40),
                                  (300, 12.6, 251.3, 40)])
def test_column_feather_matches(args):
    np.testing.assert_allclose(nn(tb.column_feather(*args)), nn(jb.column_feather(*args)),
                               rtol=0, atol=1e-6)


def test_accumulate_normalize_match(rng):
    canvas_j = jnp.zeros((20, 30, 4))
    canvas_t = tt(np.zeros((20, 30, 4), np.float32))
    for k in range(3):
        img = rng.uniform(0, 1, (20, 30, 3)).astype(np.float32)
        valid = rng.uniform(size=(20, 30)) > 0.3
        colw = tb.column_feather(30, 3.0 * k, 20.0 + 3.0 * k, 5)
        canvas_j = jb.accumulate(canvas_j, jnp.asarray(img), jnp.asarray(valid),
                                 jnp.asarray(nn(colw)))
        canvas_t = tb.accumulate(canvas_t, tt(img), tt(valid), colw)
    np.testing.assert_allclose(nn(canvas_t), nn(canvas_j), atol=1e-6)
    out_t = nn(tb.normalize(canvas_t))
    np.testing.assert_allclose(out_t, nn(jb.normalize(canvas_j)), atol=1e-6)
    assert np.isfinite(out_t).all()
    assert (out_t[nn(canvas_t)[..., 3] == 0] == 0).all()
