"""Generic dense Levenberg-Marquardt with autodiff Jacobians (port of
dr3_tpu.ba.lm).

The reference ships Ceres "exercise" programs beside its bundle adjuster:
Powell's function (tests/ceres/powell.cc), exponential curve fitting
(tests/ceres/curve_fitting.cc) and its Huber-robustified variant
(tests/ceres/robust_curve_fitting.cc). This is their counterpart: one LM
solver for any residual function, Jacobians by ``torch.func.jacfwd`` (the
analogue of Ceres autodiff cost functors, include/optimizer.hpp:82-111).

Dense normal equations (the problems are small; BA has its own Schur
solver), Jacobi scaling of J^T J, multiplicative damping, and a fixed
number of accept/reject iterations selected with ``torch.where`` (no host
read; a rejected step keeps the cached linearisation and only moves
lambda). Optional Huber robustification applies the "triggs" sqrt-weight
to residual and Jacobian rows, as ceres::HuberLoss does to first order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd


class LMResult(NamedTuple):
    x: torch.Tensor             # solution parameters [P]
    initial_cost: torch.Tensor  # 0.5 * ||r(x0)||^2 (robustified)
    final_cost: torch.Tensor
    n_accepted: torch.Tensor    # accepted LM steps
    lambda_final: torch.Tensor


def _robust_weights(r: torch.Tensor, delta: float | None) -> torch.Tensor:
    """Per-residual sqrt IRLS weight for a Huber loss of scale ``delta``."""
    if delta is None:
        return torch.ones_like(r)
    a = r.abs()
    return torch.sqrt(torch.where(a <= delta, torch.ones_like(a),
                                  delta / torch.clamp(a, min=1e-12)))


def least_squares(residual_fn: Callable[[torch.Tensor], torch.Tensor],
                  x0: torch.Tensor,
                  max_iters: int = 50,
                  huber_delta: float | None = None,
                  lambda0: float = 1e-3) -> LMResult:
    """Minimize 0.5*||rho(residual_fn(x))||^2 over x by LM.

    ``residual_fn``: params [P] -> residuals [N], written in torch ops that
    ``torch.func.jacfwd`` can trace. Runs on ``x0``'s device; a fixed
    ``max_iters`` outer iterations (rejected steps count as iterations,
    like Ceres' default reporting).
    """
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    jac = jacfwd(residual_fn)

    def linearize(x):
        r = residual_fn(x)
        w = _robust_weights(r, huber_delta)
        rw = w * r
        # jacfwd can hand back float64 tangents for a float32 function (a
        # pow by a Python number does); the solve stays in the residuals' dtype
        return rw, w[:, None] * jac(x).to(r.dtype), 0.5 * torch.sum(rw * rw)

    r, J, cost = linearize(x0)
    c0 = cost
    x = x0
    lam = torch.tensor(lambda0, dtype=torch.float32, device=x0.device)
    n_acc = torch.zeros((), dtype=torch.int32, device=x0.device)
    eye = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)
    for _ in range(max_iters):
        JtJ = J.T @ J
        g = J.T @ r
        # Jacobi scaling keeps the damped system well-conditioned in float32
        d = torch.sqrt(torch.clamp(torch.diagonal(JtJ), min=1e-12))
        A = JtJ / (d[None, :] * d[:, None]) + lam * eye
        # solve_ex, not solve: a singular system gives non-finite values
        # (rejected by the cost test) instead of raising with a host read
        dx = -torch.linalg.solve_ex(A, g / d)[0] / d
        x_new = x + dx
        r_new, J_new, cost_new = linearize(x_new)
        accept = cost_new < cost
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 2.0, max=1e6))
        x = torch.where(accept, x_new, x)
        r = torch.where(accept, r_new, r)
        J = torch.where(accept, J_new, J)
        cost = torch.where(accept, cost_new, cost)
        n_acc = n_acc + accept.to(torch.int32)
    return LMResult(x=x, initial_cost=c0, final_cost=cost, n_accepted=n_acc,
                    lambda_final=lam)
