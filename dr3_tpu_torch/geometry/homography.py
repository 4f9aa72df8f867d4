"""Homography estimation (DLT) and planar transforms (port of
dr3_tpu.geometry.homography; reference src/utils.cpp:20-89,
src/stitch.cpp:156-217).

Every solver takes fixed-capacity point arrays plus a weight vector and
batches over leading axes: ``fit_homography(src [..., N, 2], dst, w [..., N])``
fits one homography per leading index, so RANSAC fits all its hypotheses
in one call where the JAX package ``vmap``s an unbatched fit.
"""

from __future__ import annotations

import math

import torch

from dr3_tpu_torch.geometry.linalg import smallest_eigvec_gram


# ---------------------------------------------------------------------------
# affine 2x3 transforms (reference src/utils.cpp:20-42)
# ---------------------------------------------------------------------------

def affine_translate(tx: float, ty: float) -> torch.Tensor:
    return torch.tensor([[1.0, 0.0, tx], [0.0, 1.0, ty]], dtype=torch.float32)


def affine_rotate(cx: float, cy: float, angle_deg: float, scale: float = 1.0) -> torch.Tensor:
    """2x3 rotation about (cx, cy) — cv::getRotationMatrix2D semantics."""
    a = torch.deg2rad(torch.tensor(angle_deg, dtype=torch.float32))
    alpha = float(scale * torch.cos(a))
    beta = float(scale * torch.sin(a))
    return torch.tensor(
        [[alpha, beta, (1 - alpha) * cx - beta * cy],
         [-beta, alpha, beta * cx + (1 - alpha) * cy]], dtype=torch.float32)


def affine_scale(sx: float, sy: float) -> torch.Tensor:
    return torch.tensor([[sx, 0.0, 0.0], [0.0, sy, 0.0]], dtype=torch.float32)


# ---------------------------------------------------------------------------
# homogeneous transform application
# ---------------------------------------------------------------------------

def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply H [..., 3, 3] to points [..., 2] (leading axes broadcast);
    perspective divide with a |w| < 1e-12 guard. The op order is the one
    csrc/warp.cu's homography warp reproduces."""
    x, y = pts[..., 0], pts[..., 1]
    w = H[..., 2, 0] * x + H[..., 2, 1] * y + H[..., 2, 2]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    u = (H[..., 0, 0] * x + H[..., 0, 1] * y + H[..., 0, 2]) / w
    v = (H[..., 1, 0] * x + H[..., 1, 1] * y + H[..., 1, 2]) / w
    return torch.stack([u, v], dim=-1)


def normalize_points(pts: torch.Tensor, weights: torch.Tensor):
    """Weighted Hartley normalisation over the point axis (-2): similarity
    T with zero weighted mean and mean distance sqrt(2). Returns
    (pts_n [..., N, 2], T [..., 3, 3])."""
    wsum = torch.clamp(weights.sum(-1), min=1e-9)
    mean = torch.sum(pts * weights[..., None], dim=-2) / wsum[..., None]
    centered = pts - mean[..., None, :]
    meandist = torch.sum(torch.linalg.norm(centered, dim=-1) * weights, dim=-1) / wsum
    s = torch.full_like(meandist, math.sqrt(2.0)) / torch.clamp(meandist, min=1e-9)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([s, zero, -s * mean[..., 0],
                     zero, s, -s * mean[..., 1],
                     zero, zero, one], dim=-1).reshape(s.shape + (3, 3))
    return centered * s[..., None, None], T


def fit_homography(src: torch.Tensor, dst: torch.Tensor,
                   weights: torch.Tensor | None = None,
                   normalize: bool = True) -> torch.Tensor:
    """Weighted DLT homography mapping src -> dst, batched over leading axes.

    src, dst [..., N, 2]; weights [..., N] (0 masks a row out). Each match
    contributes the rows (reference src/utils.cpp:48-88)
      [-x, -y, -1, 0, 0, 0, u x, u y, u]
      [0, 0, 0, -x, -y, -1, v x, v y, v]."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    if normalize:
        src_n, Ts = normalize_points(src, weights)
        dst_n, Td = normalize_points(dst, weights)
        # Td^-1 of the similarity in closed form (a general inverse would
        # sync the card to check for errors)
        Td_inv = _similarity_inverse(Td)
    else:
        src_n, dst_n = src, dst
        Ts = Td_inv = torch.eye(3, dtype=src.dtype, device=src.device)

    x, y = src_n[..., 0], src_n[..., 1]
    u, v = dst_n[..., 0], dst_n[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([weights, weights], dim=-1)[..., None]
    h = smallest_eigvec_gram(A)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = Td_inv @ Hn @ Ts          # denormalise: H = Td^-1 Hn Ts
    h22 = H[..., 2, 2]
    h22 = torch.where(h22.abs() < 1e-12, torch.full_like(h22, 1e-12), h22)
    return H / h22[..., None, None]


def _similarity_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of [[s, 0, a], [0, s, b], [0, 0, 1]]."""
    inv_s = 1.0 / T[..., 0, 0]
    zero = torch.zeros_like(inv_s)
    one = torch.ones_like(inv_s)
    return torch.stack([inv_s, zero, -T[..., 0, 2] * inv_s,
                        zero, inv_s, -T[..., 1, 2] * inv_s,
                        zero, zero, one], dim=-1).reshape(T.shape)


def fit_translation(src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """Translation-only 'homography' = weighted mean displacement as a 3x3,
    batched over leading axes (reference Stitch::least_squares_fit
    Translate branch, src/stitch.cpp:203-217)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(weights.sum(-1), min=1e-9)
    d = torch.sum((dst - src) * weights[..., None], dim=-2) / wsum[..., None]
    zero = torch.zeros_like(d[..., 0])
    one = torch.ones_like(zero)
    return torch.stack([one, zero, d[..., 0], zero, one, d[..., 1],
                        zero, zero, one], dim=-1).reshape(d.shape[:-1] + (3, 3))


def transfer_error(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Forward transfer distance ||H src - dst|| per match
    (src/stitch.cpp:156-184)."""
    return torch.linalg.norm(apply_homography(H, src) - dst, dim=-1)


def symmetric_transfer_error(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    Hinv = torch.linalg.inv(H)
    fwd = torch.sum((apply_homography(H, src) - dst) ** 2, dim=-1)
    bwd = torch.sum((apply_homography(Hinv, dst) - src) ** 2, dim=-1)
    return fwd + bwd
