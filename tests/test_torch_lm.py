"""Port parity for the generic LM solver (ba/lm.py) on the reference's
Ceres exercises (Powell's function, curve fitting, robust curve fitting),
and for two small leftovers of the VO slice, ``pyramid.gaussian_blur3``
and ``linalg.solve_psd``: dr3_tpu (JAX on the CPU) vs dr3_tpu_torch (the
CPU) on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.ba.lm import least_squares as jleast_squares
from dr3_tpu.geometry.linalg import solve_psd as jsolve_psd
from dr3_tpu.ops.pyramid import gaussian_blur3 as jblur
from dr3_tpu_torch.ba.lm import least_squares
from dr3_tpu_torch.geometry.linalg import solve_psd
from dr3_tpu_torch.ops.pyramid import gaussian_blur3
from tests.torch_parity import nn, tt


def powell(x, m):
    """Powell's singular function (powell.cc's residual blocks); ``m`` is
    jnp or torch."""
    return m.stack([x[0] + 10.0 * x[1], 5.0 ** 0.5 * (x[2] - x[3]),
                    (x[1] - 2.0 * x[2]) ** 2, 10.0 ** 0.5 * (x[0] - x[3]) ** 2])


def curve_data(rng, n=67, m=0.3, c=0.1, noise=0.01, outlier_frac=0.0):
    """tests/test_lm_bal.py's exponential samples, numpy."""
    x = np.linspace(0.0, 5.0, n).astype(np.float32)
    y = np.exp(m * x + c) + rng.normal(0, noise, n).astype(np.float32)
    k = int(outlier_frac * n)
    if k:
        idx = rng.choice(n, k, replace=False)
        y[idx] += rng.uniform(1.5, 3.0, k).astype(np.float32)
    return x, y


def _check(rt, rj, x_atol):
    np.testing.assert_allclose(nn(rt.x), np.asarray(rj.x), rtol=0, atol=x_atol)
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-6)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-3,
                               atol=1e-10)


def test_powell_matches():
    """60 iterations from (3, -1, 0, 1): the cost below 1e-8 in both, the
    same accepted steps, x within 1e-3 (the minimum is singular: x -> 0
    slowly), final costs rtol 1e-3 or 1e-10 absolute."""
    x0 = np.asarray([3.0, -1.0, 0.0, 1.0], np.float32)
    rj = jleast_squares(lambda x: powell(x, jnp), jnp.asarray(x0), max_iters=60)
    rt = least_squares(lambda x: powell(x, torch), torch.as_tensor(x0), max_iters=60)
    assert float(rt.final_cost) < 1e-8
    assert int(rt.n_accepted) == int(rj.n_accepted)
    _check(rt, rj, 1e-3)
    np.testing.assert_allclose(nn(rt.x), 0.0, atol=2e-2)


@pytest.mark.parametrize("delta", [None, 0.05])
def test_curve_fits_match(rng, delta):
    """Plain (no outliers) and Huber (15% outliers, delta 0.05) fits from 0:
    after 15 iterations (10 rejected while lambda grows, then descent) the
    same accepted steps; after 40, (m, c) within 1e-5 of JAX's and the
    costs. Past convergence the accept test compares costs equal to the
    last few ulps, which exp's rounding in each library decides, so the
    counts there may differ by a step or two; the robust fit recovers the
    slope within 0.02."""
    x, y = curve_data(rng, outlier_frac=0.0 if delta is None else 0.15)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    for iters in (15, 40):
        rj = jleast_squares(lambda p: jnp.exp(p[0] * jnp.asarray(x) + p[1]) - jnp.asarray(y),
                            jnp.zeros(2), max_iters=iters, huber_delta=delta)
        rt = least_squares(lambda p: torch.exp(p[0] * xt + p[1]) - yt, torch.zeros(2),
                           max_iters=iters, huber_delta=delta)
        if iters == 15:
            assert int(rt.n_accepted) == int(rj.n_accepted) > 0
    _check(rt, rj, 1e-5)
    assert abs(float(rt.x[0]) - 0.3) < 0.02
    assert float(rt.final_cost) < float(rt.initial_cost)


def test_robust_fit_beats_plain_fit_on_outliers(rng):
    x, y = curve_data(rng, outlier_frac=0.15)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)

    def fit(delta):
        return float(least_squares(lambda p: torch.exp(p[0] * xt + p[1]) - yt, torch.zeros(2),
                                   max_iters=40, huber_delta=delta).x[0])

    assert abs(fit(0.05) - 0.3) < abs(fit(None) - 0.3)


@pytest.mark.parametrize("shape", [(7, 9), (3, 24, 31), (2, 1, 5, 6)])
def test_gaussian_blur3_matches(rng, shape):
    """The separable [1 2 1]/4 blur with replicated borders: within 1e-6."""
    img = rng.uniform(0, 1, shape).astype(np.float32)
    np.testing.assert_allclose(nn(gaussian_blur3(tt(img))), np.asarray(jblur(jnp.asarray(img))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("rhs", ["vector", "matrix", "batched"])
def test_solve_psd_matches(rng, rhs):
    """(A + damping I) x = b by Cholesky, b a vector, a matrix, or batched:
    within 1e-4 relative of JAX's; a non-PSD system gives NaN in both."""
    batch = (3,) if rhs == "batched" else ()
    G = rng.normal(size=batch + (6, 6)).astype(np.float32)
    A = G @ np.swapaxes(G, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=batch + ((6, 2) if rhs == "matrix" else (6,))).astype(np.float32)
    want = np.asarray(jsolve_psd(jnp.asarray(A), jnp.asarray(b), 0.1))
    got = nn(solve_psd(tt(A), tt(b), 0.1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    bad, b0 = -np.eye(6, dtype=np.float32), np.ones(6, np.float32)
    assert np.isnan(nn(solve_psd(tt(bad), tt(b0)))).all()
    assert np.isnan(np.asarray(jsolve_psd(jnp.asarray(bad), jnp.asarray(b0)))).all()
