"""Sparse image alignment, SVO-style direct pose tracking (port of
dr3_tpu.ops.sparse_align).

Inverse-compositional on SE3: minimise sum_i || I_cur(pi(T X_i) + u) -
P_i(u) ||^2 over patches P_i sampled in the reference frame, with the
Jacobian chain built from reference-patch gradients (constant across
iterations). LM with system reuse: the trial evaluation doubles as the
next iteration's linearisation when the step is accepted.

On a CUDA image :func:`sparse_align` is one launch of ``dr3_sparse_align``
(csrc/sparse_align.cu): the reference patches, every evaluation of the
normal equations with kernel K2's sampler in its body, the 6x6 solves, the
pose updates and the accept tests, with poses, intrinsics and results on
the device throughout. On a CPU image it is :func:`_sparse_align_plain`,
whose patch access goes through K2's plain version at two widths: W =
2*half+3 once on the reference image (the centre patch and both
central-difference gradients from one sample), then W = 2*half+1 every
iteration on the current image. There is no cap on W or on the image size.
``sparse_align.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr3_tpu_torch.geometry.lie import SE3, hat
from dr3_tpu_torch.geometry.linalg import chol_solve_small
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.ops import _native
from dr3_tpu_torch.ops.lk import _sample_patches_plain


class AlignResult(NamedTuple):
    T: SE3                 # refined world->camera pose
    cost0: torch.Tensor    # initial photometric cost
    cost: torch.Tensor     # final photometric cost
    n_used: torch.Tensor   # features contributing


def sparse_align(img_ref: torch.Tensor, img_cur: torch.Tensor,
                 T_ref: SE3, T_init: SE3, cam: Pinhole,
                 points_w: torch.Tensor, valid: torch.Tensor,
                 level: int = 2, half_patch: int = 2,
                 iters: int = 15) -> AlignResult:
    """Refine T_init (world->cur) against img_ref patches.

    img_ref/img_cur: pyramid images at ``level``; points_w [N, 3] world
    landmarks visible in the reference frame; valid [N] bool. Intrinsics are
    scaled internally to the pyramid level. No host synchronisation: on a
    CUDA image one kernel launch, the poses, the camera's intrinsics and
    the result staying on the device.
    """
    if not img_cur.is_cuda:
        return _sparse_align_plain(img_ref, img_cur, T_ref, T_init, cam, points_w,
                                   valid, level, half_patch, iters)
    dev = img_cur.device
    n = points_w.shape[0]
    if half_patch < 0 or iters < 0 or level < 0:
        raise ValueError(f"negative half_patch {half_patch}, iters {iters} or level {level}")
    for name, img in (("img_ref", img_ref), ("img_cur", img_cur)):
        _native.check(img, name, torch.float32, device=dev)
        if img.dim() != 2 or img.numel() == 0:
            raise ValueError(f"{name}: expected a non-empty [H, W], got {tuple(img.shape)}")
    _native.check(points_w, "points_w", torch.float32, (n, 3), dev)
    _native.check(valid, "valid", torch.bool, (n,), dev)
    for name, T in (("T_ref", T_ref), ("T_init", T_init)):
        _native.check(T.wxyz, f"{name}.wxyz", torch.float32, (4,), dev)
        _native.check(T.t, f"{name}.t", torch.float32, (3,), dev)
    intrinsics = (cam.fx, cam.fy, cam.cx, cam.cy)
    for name, v in zip(("fx", "fy", "cx", "cy"), intrinsics):
        _native.check(v, f"cam.{name}", torch.float32, (), dev)
    W = 2 * half_patch + 1
    out = torch.empty((9,), dtype=torch.float32, device=dev)
    n_used = torch.empty((), dtype=torch.int64, device=dev)
    # P_ref, gx, gy where a block's share does not fit its shared memory
    scratch = torch.empty((3, n, W * W), dtype=torch.float32, device=dev)
    (hr, wr), (hc, wc) = img_ref.shape, img_cur.shape
    _native.call("dr3_sparse_align", img_ref, hr, wr, img_cur, hc, wc,
                 T_ref.wxyz, T_ref.t, T_init.wxyz, T_init.t, *intrinsics,
                 1.0 / (2.0 ** level), points_w, valid, n, half_patch, iters,
                 scratch, out, n_used)
    sparse_align.launches += 1
    return AlignResult(T=SE3(out[0:4], out[4:7]), cost0=out[7], cost=out[8], n_used=n_used)


sparse_align.launches = 0


def _sparse_align_plain(img_ref: torch.Tensor, img_cur: torch.Tensor,
                        T_ref: SE3, T_init: SE3, cam: Pinhole,
                        points_w: torch.Tensor, valid: torch.Tensor,
                        level: int, half_patch: int, iters: int) -> AlignResult:
    """:func:`sparse_align` in plain tensor ops: LM with one normal-equation
    evaluation per step, patches through K2's plain version."""
    scale = 1.0 / (2.0 ** level)
    fx, fy = cam.fx * scale, cam.fy * scale
    cx_, cy_ = cam.cx * scale, cam.cy * scale

    def project(xc):
        z = xc[..., 2:3]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        xy = xc[..., :2] / z
        return torch.stack([fx * xy[..., 0] + cx_, fy * xy[..., 1] + cy_], -1)

    xc_ref = T_ref.apply(points_w)
    uv_ref = project(xc_ref)
    P_big = _sample_patches_plain(img_ref, uv_ref, half_patch + 1)
    P_ref = P_big[:, 1:-1, 1:-1]
    gx = (P_big[:, 1:-1, 2:] - P_big[:, 1:-1, :-2]) * 0.5
    gy = (P_big[:, 2:, 1:-1] - P_big[:, :-2, 1:-1]) * 0.5

    h_ref, w_ref = img_ref.shape
    m = float(half_patch)
    ref_in = (uv_ref[:, 0] >= m) & (uv_ref[:, 0] <= w_ref - 1 - m) \
        & (uv_ref[:, 1] >= m) & (uv_ref[:, 1] <= h_ref - 1 - m)
    use = valid & (xc_ref[..., 2] > 1e-3) & ref_in
    w = use.to(torch.float32)
    eye3 = torch.eye(3, dtype=torch.float32, device=points_w.device)

    def residual_system(T: SE3):
        """(H [6,6], b [6], cost) at pose T."""
        xc = T.apply(points_w)
        uv = project(xc)
        I = _sample_patches_plain(img_cur, uv, half_patch)
        r = I - P_ref
        wi = w * (xc[..., 2] > 1e-3).to(torch.float32)
        z = xc[..., 2]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        inv_z = 1.0 / z
        x_z = xc[..., 0] * inv_z
        y_z = xc[..., 1] * inv_z
        zero = torch.zeros_like(inv_z)
        J_proj = torch.stack([
            torch.stack([fx * inv_z, zero, -fx * x_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * y_z * inv_z], -1),
        ], -2)
        J_pose = torch.cat([eye3.expand(xc.shape[:-1] + (3, 3)), -hat(xc)], dim=-1)
        J_uv = J_proj @ J_pose                                    # [N, 2, 6]
        J = gx[..., None] * J_uv[:, None, None, 0, :] + \
            gy[..., None] * J_uv[:, None, None, 1, :]             # [N, P, P, 6]
        wi_full = wi[:, None, None]
        Jw = J * wi_full[..., None]
        H = torch.einsum("npqi,npqj->ij", Jw, J)
        b = -torch.einsum("npqi,npq->i", Jw, r)
        cost = 0.5 * torch.sum(wi_full * r * r)
        return H, b, cost

    H, b, best = residual_system(T_init)
    cost0 = best
    T_best = T_init
    lam = torch.tensor(1e-3, dtype=torch.float32, device=points_w.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=points_w.device)
    for _ in range(iters):
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
        delta = chol_solve_small(Hd, b)
        T_new = (SE3.exp(delta) @ T_best).normalize()
        H_new, b_new, new_cost = residual_system(T_new)
        ok = (new_cost < best) & torch.isfinite(new_cost)
        T_best = SE3(torch.where(ok, T_new.wxyz, T_best.wxyz),
                     torch.where(ok, T_new.t, T_best.t))
        H = torch.where(ok, H_new, H)
        b = torch.where(ok, b_new, b)
        lam = torch.where(ok, torch.clamp(lam / 2.0, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e4))
        best = torch.where(ok, new_cost, best)
    return AlignResult(T=T_best, cost0=cost0, cost=best, n_used=use.sum())
