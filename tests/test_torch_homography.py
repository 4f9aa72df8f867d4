"""Port parity for dr3_tpu_torch.geometry.homography and ransac_homography
on the CPU: the same numpy correspondences through dr3_tpu (JAX) and the
port. RANSAC gets JAX's minimal sets (jax.random and torch.Generator draw
differently), as tests/test_torch_twoview.py does for the F-matrix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.geometry import homography as jh
from dr3_tpu.geometry import ransac as jr
from dr3_tpu_torch.geometry import homography as th
from dr3_tpu_torch.geometry import ransac as tr
from tests.test_homography import apply_np, random_h
from tests.torch_parity import nn, tt

# float32 DLT through 10 inverse-power steps on a 9x9 Gram matrix, summed in
# another order on each side: the normalised entries agree to ~1e-5
# relative; as a transfer of points 500 px away that is 0.05 px.
H_TRANSFER_PX = 0.05
CORNERS = np.array([[0, 0], [500, 0], [0, 500], [500, 500]], np.float32)


def _transfer_gap(Ha, Hb) -> float:
    return float(np.abs(apply_np(nn(Ha), CORNERS) - apply_np(nn(Hb), CORNERS)).max())


def _matches(rng, n=96, noise=0.3, n_out=0):
    H = random_h(rng)
    src = rng.uniform(0, 500, size=(n, 2)).astype(np.float32)
    dst = (apply_np(H, src) + rng.normal(0, noise, (n, 2))).astype(np.float32)
    dst[:n_out] = rng.uniform(0, 500, size=(n_out, 2)).astype(np.float32)
    return H, src, dst


def test_affine_mats_match():
    np.testing.assert_allclose(nn(th.affine_translate(3.0, -2.0)),
                               nn(jh.affine_translate(3.0, -2.0)))
    np.testing.assert_allclose(nn(th.affine_rotate(10.0, -4.0, 33.0, 1.5)),
                               nn(jh.affine_rotate(10.0, -4.0, 33.0, 1.5)), atol=1e-5)
    np.testing.assert_allclose(nn(th.affine_scale(2.0, 0.5)), nn(jh.affine_scale(2.0, 0.5)))


def test_apply_homography_and_transfer_error(rng):
    H, src, dst = _matches(rng)
    np.testing.assert_allclose(nn(th.apply_homography(tt(H), tt(src))),
                               nn(jh.apply_homography(jnp.asarray(H), jnp.asarray(src))),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(nn(th.transfer_error(tt(H), tt(src), tt(dst))),
                               nn(jh.transfer_error(jnp.asarray(H), jnp.asarray(src),
                                                    jnp.asarray(dst))), atol=1e-4)
    np.testing.assert_allclose(
        nn(th.symmetric_transfer_error(tt(H), tt(src), tt(dst))),
        nn(jh.symmetric_transfer_error(jnp.asarray(H), jnp.asarray(src),
                                       jnp.asarray(dst))), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_fit_homography_matches(rng, masked):
    H, src, dst = _matches(rng)
    w = np.ones(len(src), np.float32)
    if masked:
        dst[:10] = 1e5
        w[:10] = 0.0
    hj = jh.fit_homography(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    ht = th.fit_homography(tt(src), tt(dst), tt(w))
    assert _transfer_gap(ht, hj) < H_TRANSFER_PX
    assert _transfer_gap(ht, H) < 1.0          # and both fit the truth (0.3 px noise)


def test_fit_homography_batched(rng):
    """[S, 4, 2] minimal sets in one call == each set fitted alone (JAX)."""
    H, src, dst = _matches(rng, noise=0.0)
    idx = np.stack([rng.choice(len(src), 4, replace=False) for _ in range(12)])
    ht = th.fit_homography(tt(src[idx]), tt(dst[idx]), torch.ones(12, 4))
    assert ht.shape == (12, 3, 3)
    for s in range(12):
        hj = jh.fit_homography(jnp.asarray(src[idx[s]]), jnp.asarray(dst[idx[s]]))
        assert _transfer_gap(ht[s], hj) < H_TRANSFER_PX


def test_fit_translation_matches(rng):
    src = rng.uniform(0, 100, size=(32, 2)).astype(np.float32)
    dst = src + np.asarray([5.0, -3.0], np.float32) + rng.normal(0, 0.2, (32, 2)).astype(np.float32)
    w = (rng.uniform(size=32) > 0.3).astype(np.float32)
    hj = jh.fit_translation(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    ht = th.fit_translation(tt(src), tt(dst), tt(w))
    np.testing.assert_allclose(nn(ht), nn(hj), atol=1e-5)
    hb = th.fit_translation(tt(np.stack([src, src])), tt(np.stack([dst, dst])),
                            tt(np.stack([w, w])))
    np.testing.assert_allclose(nn(hb), np.stack([nn(ht)] * 2), atol=0)


def _jax_sets(seed, n, w, n_samples, k):
    return np.asarray(jr.sample_minimal_sets(jax.random.PRNGKey(seed), n, jnp.asarray(w),
                                             n_samples, k))


@pytest.mark.parametrize("translate_only", [False, True], ids=["homography", "translate"])
def test_ransac_homography_with_injected_sets(rng, translate_only):
    n, n_out = 160, 50
    if translate_only:
        src = rng.uniform(0, 300, size=(n, 2)).astype(np.float32)
        dst = src + np.asarray([12.0, 7.0], np.float32) + \
            rng.normal(0, 0.3, (n, 2)).astype(np.float32)
        dst[:n_out] += rng.uniform(20, 80, size=(n_out, 2)).astype(np.float32)
    else:
        _, src, dst = _matches(rng, n=n, noise=0.3, n_out=n_out)
    w = np.ones(n, np.float32)
    w[-5:] = 0.0                                  # masked rows never sampled
    rj = jr.ransac_homography(jax.random.PRNGKey(4), jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(w), n_samples=500, threshold=3.0,
                              translate_only=translate_only)
    idx = _jax_sets(4, n, w, 500, 1 if translate_only else 4)
    rt = tr.ransac_homography(None, tt(src), tt(dst), tt(w), n_samples=500, threshold=3.0,
                              translate_only=translate_only, sample_idx=tt(idx))
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert int((nn(rt.inliers) != nn(rj.inliers)).sum()) <= 2
    assert _transfer_gap(rt.model, rj.model) < H_TRANSFER_PX
    assert not nn(rt.inliers)[-5:].any()


def test_sampler_draws_on_the_generator_device():
    """A CPU generator gives the same minimal sets whatever device the
    weights are on (the card run uses this to share the CPU run's draws)."""
    w = torch.ones(50)
    w[:5] = 0
    a = tr.sample_minimal_sets(torch.Generator().manual_seed(3), 50, w, 40, 4)
    b = tr.sample_minimal_sets(torch.Generator().manual_seed(3), 50, w, 40, 4)
    assert torch.equal(a, b) and a.shape == (40, 4) and bool((a >= 5).all())
    assert all(len(set(r.tolist())) == 4 for r in a)
