"""Plain reference of a BAL solve whose reduced camera system is summed
from pairs of observations, for problems whose dense W does not fit.

The same Levenberg-Marquardt as ``perfbench/reference/bal_lm.py``: its
objective, Jacobians, step update and problem are imported from
there, and its policy is repeated here (damping divided by 3 on a taken
step, doubled on a refused one, camera 0 the gauge). Only the step is
formed another way. ``bal_lm.schur_step`` builds W Hpp^-1 W^T from a dense
[3P, 9K] W; at Ladybug-1723's counts that W is 58 GB in float64. Here the
reduced camera matrix is summed block by block over the ordered pairs of
observations that share a point,

    S = blockdiag(Hcc) - sum_p sum_{i, j in obs(p)} W_i Hpp_p^-1 W_j^T,

with W_i = Jc_i^T Jp_i the [9, 3] coupling of observation i, into a dense
[9K, 9K] S (1.92 GB in float64 at 1,723 cameras), the pairs taken in
chunks so that no temporary holds more than ``CHUNK`` pairs' blocks. S is
factorised by Cholesky and the point steps follow by back-substitution.
Nothing here comes from the program under test.
"""

from __future__ import annotations

import torch

from perfbench.reference.bal_lm import Problem, apply_step, cost, jacobians

# pairs of observations whose 9x9 blocks are formed at once (~170 MB of
# float64 blocks and their gathered factors)
CHUNK = 1 << 18


def obs_pairs(obs_pt: torch.Tensor, n_points: int):
    """(i, j): every ordered pair of observations of one point, (i, i)
    included; sum over points of (observations of the point)^2 pairs."""
    op = obs_pt.long()
    order = torch.argsort(op, stable=True)
    counts = torch.bincount(op, minlength=n_points)
    first = torch.cumsum(counts, 0) - counts             # each point's first slot in order
    n_i = counts[op[order]]                              # partners of each sorted row
    i = torch.repeat_interleave(order, n_i)
    row_start = torch.cumsum(n_i, 0) - n_i
    k = torch.arange(i.shape[0], device=op.device) - torch.repeat_interleave(row_start, n_i)
    j = order[torch.repeat_interleave(first[op[order]], n_i) + k]
    return i, j


def schur_step(r, Jc, Jp, oc, op, P: int, fixed, lam: float, pairs=None):
    """``bal_lm.schur_step`` with the reduced camera system summed over the
    observation pairs ``pairs`` (:func:`obs_pairs`, built here when None):
    the damped Gauss-Newton step (dc [K, C], dX [P, 3]) of residuals r
    [O, 2] with camera Jacobians Jc [O, 2, C] and point Jacobians Jp
    [O, 2, 3], the cameras in ``fixed`` held."""
    K, C = fixed.shape[0], Jc.shape[-1]
    dt, dev = r.dtype, r.device
    if pairs is None:
        pairs = obs_pairs(op, P)
    Hcc = torch.zeros(K, C, C, dtype=dt, device=dev).index_add_(
        0, oc, Jc.transpose(1, 2) @ Jc)
    Hpp = torch.zeros(P, 3, 3, dtype=dt, device=dev).index_add_(
        0, op, Jp.transpose(1, 2) @ Jp)
    gc = torch.zeros(K, C, dtype=dt, device=dev).index_add_(
        0, oc, (Jc.transpose(1, 2) @ r[..., None])[..., 0])
    gp = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(
        0, op, (Jp.transpose(1, 2) @ r[..., None])[..., 0])
    Hcc = Hcc + torch.diag_embed(lam * torch.diagonal(Hcc, dim1=-2, dim2=-1))
    Hpp = Hpp + torch.diag_embed(lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-12)
    # torch factorises in float32 at the least: a half-precision solve
    # factorises its rounded matrices in float32 and rounds the result back
    fdt = torch.promote_types(dt, torch.float32)
    Hpp_inv = torch.linalg.inv(Hpp.to(fdt)).to(dt)
    W = Jc.transpose(1, 2) @ Jp                            # [O, C, 3]
    Y = W @ Hpp_inv[op]                                    # W_i Hpp^-1, [O, C, 3]
    # the blocks of sum W_i Hpp^-1 W_j^T by camera pair, then blockdiag(Hcc)
    S4 = torch.zeros(K * K, C, C, dtype=dt, device=dev)
    pi, pj = pairs
    for s in range(0, pi.shape[0], CHUNK):
        i, j = pi[s:s + CHUNK], pj[s:s + CHUNK]
        S4.index_add_(0, oc[i] * K + oc[j], Y[i] @ W[j].transpose(1, 2), alpha=-1)
    blocks = torch.arange(K, device=dev)
    S4[blocks * K + blocks] += Hcc
    S = S4.view(K, K, C, C).permute(0, 2, 1, 3).reshape(K * C, K * C)
    del S4
    rhs = -(gc - torch.zeros(K, C, dtype=dt, device=dev).index_add_(
        0, oc, (Y @ gp[op][..., None])[..., 0])).reshape(K * C)
    keep = (~fixed).repeat_interleave(C)
    dc = torch.zeros(K * C, dtype=dt, device=dev)
    S = S[keep][:, keep].to(fdt)
    L = torch.linalg.cholesky(S)
    del S
    dc[keep] = torch.cholesky_solve(rhs[keep][:, None].to(fdt), L)[:, 0].to(dt)
    del L
    dc = dc.view(K, C)
    # dX = Hpp^-1 (-gp - sum_i W_i^T dc)
    u = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(
        0, op, (W.transpose(1, 2) @ dc[oc][..., None])[..., 0])
    dX = (Hpp_inv @ (-gp - u)[..., None])[..., 0]
    return dc, dX


def lm_step(prob: Problem, params, lam: float, pairs=None):
    """The damped Gauss-Newton step (dc [K, 9], dX [P, 3]) at ``params``;
    camera 0 is the gauge."""
    r, Jc, Jp = jacobians(prob, params)
    fixed = torch.zeros(prob.n_cams, dtype=torch.bool, device=r.device)
    fixed[0] = True
    return schur_step(r, Jc, Jp, prob.obs_cam, prob.obs_pt, prob.n_points, fixed, lam, pairs)


def solve(prob: Problem, params, max_iters: int, lam0: float = 1e-3):
    """LM from ``params`` as ``bal_lm.solve``: (params, cost per iteration,
    taken steps). TF32 is turned off: every product is in the problem's
    own type."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pairs = obs_pairs(prob.obs_pt, prob.n_points)
    lam = lam0
    best = cost(prob, params)
    costs, taken = [float(best)], 0
    for _ in range(max_iters):
        try:
            dc, dX = lm_step(prob, params, lam, pairs)
        except RuntimeError:                 # a failed factorisation: damp more
            lam = min(lam * 2.0, 1e6)
            costs.append(float(best))
            continue
        cand = apply_step(params, dc, dX)
        c = cost(prob, cand)
        if bool(torch.isfinite(c)) and bool(c < best):
            params, best, lam, taken = cand, c, max(lam / 3.0, 1e-9), taken + 1
        else:
            lam = min(lam * 2.0, 1e6)
        costs.append(float(best))
    return params, costs, taken
