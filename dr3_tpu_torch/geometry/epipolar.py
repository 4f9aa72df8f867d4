"""Two-view epipolar geometry: F/E estimation, triangulation, cheirality
(port of dr3_tpu.geometry.epipolar; reference src/two.cpp:8-298,
src/initialization.cpp:135-541).

Every function takes [N, ...] tensors + a weight/mask vector and batches
over leading axes (RANSAC hypotheses, pose candidates) with static shapes.
SVD sign conventions may differ between backends; every use here is
invariant to them (rank-2 projection, the {R1, R2} x {+t, -t} set).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dr3_tpu_torch.geometry.homography import normalize_points
from dr3_tpu_torch.geometry.linalg import smallest_eigvec_gram


def normalize_mad(pts: torch.Tensor, weights: torch.Tensor):
    """Mean-absolute-deviation normalisation (reference Normalize,
    src/initialization.cpp:365-410), batched over leading axes.
    Returns (pts_n [..., N, 2], T [..., 3, 3])."""
    wsum = torch.clamp(weights.sum(-1), min=1e-9)[..., None]
    mean = torch.sum(pts * weights[..., None], dim=-2) / wsum
    centered = pts - mean[..., None, :]
    mad = torch.sum(centered.abs() * weights[..., None], dim=-2) / wsum
    s = 1.0 / torch.clamp(mad, min=1e-9)
    pts_n = centered * s[..., None, :]
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s[..., 0]
    T[..., 1, 1] = s[..., 1]
    T[..., 2, 2] = 1.0
    T[..., 0, 2] = -mean[..., 0] * s[..., 0]
    T[..., 1, 2] = -mean[..., 1] * s[..., 1]
    return pts_n, T


def enforce_rank2(F: torch.Tensor) -> torch.Tensor:
    """Closest rank-2 matrix (clean_F, src/two.cpp:113-127), batched."""
    U, s, Vh = torch.linalg.svd(F, full_matrices=False)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (U * s[..., None, :]) @ Vh


def fit_fundamental(p1: torch.Tensor, p2: torch.Tensor,
                    weights: torch.Tensor | None = None,
                    normalize: str = "mad") -> torch.Tensor:
    """Weighted 8-point F with x2^T F x1 = 0 (reference ComputeF21,
    src/initialization.cpp:135-169), batched over leading axes of p1/p2
    [..., N, 2]. normalize: 'mad' (the initializer's variant), 'hartley',
    or 'none'."""
    if weights is None:
        weights = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    if normalize == "mad":
        p1n, T1 = normalize_mad(p1, weights)
        p2n, T2 = normalize_mad(p2, weights)
    elif normalize == "hartley":
        p1n, T1 = normalize_points(p1, weights)
        p2n, T2 = normalize_points(p2, weights)
    else:
        p1n, p2n = p1, p2
        T1 = T2 = torch.eye(3, dtype=p1.dtype, device=p1.device).expand(
            p1.shape[:-2] + (3, 3))
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)
    A = A * weights[..., None]
    f = smallest_eigvec_gram(A)
    Fn = enforce_rank2(f.reshape(f.shape[:-1] + (3, 3)))
    F = T2.transpose(-1, -2) @ Fn @ T1
    norm = torch.linalg.norm(F, dim=(-2, -1), keepdim=True)
    return F / torch.where(norm < 1e-12, torch.full_like(norm, 1e-12), norm)


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor,
                               K2: torch.Tensor | None = None) -> torch.Tensor:
    """E = K2^T F K1 (src/two.cpp:139; initialization.cpp:263)."""
    if K2 is None:
        K2 = K1
    return K2.T @ F @ K1


def epipolar_errors(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Squared point-to-epipolar-line distances in both directions
    (CheckFundamental, src/initialization.cpp:171-249); F [..., 3, 3]
    batches against p [N, 2]. Returns (d1, d2) [..., N]."""
    one = torch.ones_like(p1[..., :1])
    x1 = torch.cat([p1, one], dim=-1)
    x2 = torch.cat([p2, one], dim=-1)
    l2 = x1 @ F.transpose(-1, -2)
    l1 = x2 @ F
    num2 = torch.sum(l2 * x2, dim=-1) ** 2
    num1 = torch.sum(l1 * x1, dim=-1) ** 2
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    d2 = num2 / torch.clamp(den2, min=1e-12)
    d1 = num1 / torch.clamp(den1, min=1e-12)
    return d1, d2


def score_fundamental(F, p1, p2, weights, sigma: float = 1.0,
                      th: float = 3.841, th_score: float = 5.991):
    """ORB-SLAM symmetric-transfer chi-square score
    (initialization.cpp:171-249). Returns (score [...], inliers [..., N])."""
    d1, d2 = epipolar_errors(F, p1, p2)
    inv_sigma2 = 1.0 / (sigma * sigma)
    chi1 = d1 * inv_sigma2
    chi2 = d2 * inv_sigma2
    ok1 = chi1 <= th
    ok2 = chi2 <= th
    zero = torch.zeros_like(chi1)
    score = torch.sum(torch.where(ok1, th_score - chi1, zero) * weights, dim=-1) + \
        torch.sum(torch.where(ok2, th_score - chi2, zero) * weights, dim=-1)
    return score, ok1 & ok2 & (weights > 0)


class PoseHypotheses(NamedTuple):
    R: torch.Tensor  # [4, 3, 3]
    t: torch.Tensor  # [4, 3] unit-norm


def decompose_essential(E: torch.Tensor) -> PoseHypotheses:
    """E -> four (R, t) candidates (src/two.cpp:134-156,
    initialization.cpp:522-541), det(R) < 0 fixed by negation."""
    U, _, Vh = torch.linalg.svd(E)
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    u3 = U[:, 2]
    u3 = u3 / torch.clamp(torch.linalg.norm(u3), min=1e-12)
    return PoseHypotheses(R=torch.stack([R1, R1, R2, R2]),
                          t=torch.stack([u3, -u3, u3, -u3]))


def triangulate(P1: torch.Tensor, P2: torch.Tensor, p1: torch.Tensor,
                p2: torch.Tensor) -> torch.Tensor:
    """Batched DLT triangulation (src/two.cpp:238-254): P [..., 3, 4]
    broadcast against p [N, 2]. Returns euclidean points [..., N, 3]."""
    def rows(P, p):
        P = P[..., None, :, :]
        x = p[..., 0][..., None]
        y = p[..., 1][..., None]
        return x * P[..., 2, :] - P[..., 0, :], y * P[..., 2, :] - P[..., 1, :]

    a1, a2 = rows(P1, p1)
    a3, a4 = rows(P2, p2)
    A = torch.stack(torch.broadcast_tensors(a1, a2, a3, a4), dim=-2)
    X = smallest_eigvec_gram(A)
    w = X[..., 3:4]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], batched over leading axes of R/t."""
    Rt = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.einsum("ij,...jk->...ik", K, Rt)


class CheckRTResult(NamedTuple):
    n_good: torch.Tensor      # [...] int
    good: torch.Tensor        # [..., N] bool
    points: torch.Tensor      # [..., N, 3] triangulated in cam-1/world frame
    parallax: torch.Tensor    # [...] 50th-smallest parallax in degrees


def check_rt(R: torch.Tensor, t: torch.Tensor, p1: torch.Tensor,
             p2: torch.Tensor, weights: torch.Tensor, K: torch.Tensor,
             sigma2: float = 1.0, min_parallax_cos: float = 0.99998) -> CheckRTResult:
    """ORB-SLAM CheckRT (src/initialization.cpp:412-520), batched over the
    leading axes of R [..., 3, 3] / t [..., 3]: finite, parallax cos below
    min_parallax_cos, in front of both cameras, reprojection within
    4*sigma2 in both views; parallax = 50th-smallest good angle."""
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    P1 = projection_matrix(K, eye, torch.zeros(3, dtype=K.dtype, device=K.device))
    P2 = projection_matrix(K, R, t)
    X = triangulate(P1.expand_as(P2), P2, p1, p2)          # [..., N, 3]

    finite = torch.isfinite(X).all(dim=-1)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]      # [..., 3]
    n1 = X
    n2 = X - O2[..., None, :]
    d1 = torch.linalg.norm(n1, dim=-1)
    d2 = torch.linalg.norm(n2, dim=-1)
    cos_par = torch.sum(n1 * n2, dim=-1) / torch.clamp(d1 * d2, min=1e-12)
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    front = (z1 > 0) & (z2 > 0)

    def reproj(P, Xw):
        x = Xw @ P[..., :3, :3].transpose(-1, -2) + P[..., None, :3, 3]
        z = x[..., 2:3]
        z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
        return x[..., :2] / z

    e1 = torch.sum((reproj(P1, X) - p1) ** 2, dim=-1)
    e2 = torch.sum((reproj(P2, X) - p2) ** 2, dim=-1)
    reproj_ok = (e1 <= 4.0 * sigma2) & (e2 <= 4.0 * sigma2)
    parallax_ok = cos_par < min_parallax_cos
    good = finite & front & reproj_ok & parallax_ok & (weights > 0)
    n_good = good.sum(-1)

    cos_masked = torch.where(good, cos_par, torch.full_like(cos_par, -2.0))
    cos_sorted = torch.sort(cos_masked, dim=-1, descending=True).values
    idx = torch.clamp(torch.clamp(n_good, min=1), max=50) - 1
    cos_sel = torch.clamp(torch.gather(cos_sorted, -1, idx[..., None])[..., 0], -1.0, 1.0)
    parallax_deg = torch.acos(cos_sel) * (180.0 / math.pi)
    parallax_deg = torch.where(n_good > 0, parallax_deg, torch.zeros_like(parallax_deg))
    return CheckRTResult(n_good=n_good, good=good, points=X, parallax=parallax_deg)


def disambiguate_pose(hyp: PoseHypotheses, p1: torch.Tensor, p2: torch.Tensor,
                      weights: torch.Tensor, K: torch.Tensor, sigma2: float = 1.0):
    """Pick the (R, t) with most good points among the 4 hypotheses,
    requiring a clear winner like ReconstructF (initialization.cpp:286-306):
    second-best must be < 0.7 * best. One batched :func:`check_rt` over
    the hypotheses; ties go to the first index. Returns
    (best_idx, results_stacked, clear_winner: bool tensor)."""
    results = check_rt(hyp.R, hyp.t, p1, p2, weights, K, sigma2)
    n = results.n_good
    best = torch.argmax(n)
    nmax = n[best]
    n_similar = (n.to(torch.float32) > 0.7 * nmax).sum()
    return best, results, n_similar == 1
