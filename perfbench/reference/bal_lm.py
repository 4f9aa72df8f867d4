"""Plain reference of a BAL solve: Levenberg-Marquardt on the Snavely
objective with a dense Schur complement, in plain torch.

The objective is the BAL file format's (Agarwal et al., ECCV 2010): camera
k has an angle-axis rotation, a translation, a focal length f and radial
terms k1, k2; a point X projects to p = R X + t, q = -(p_x, p_y) / p_z,
u = f (1 + k1 |q|^2 + k2 |q|^4) q, and the cost is half the sum of squared
pixel residuals. Camera 0 is held fixed (the gauge). Each LM step solves
the damped normal equations exactly: the reduced camera system
S = Hcc - W Hpp^-1 W^T is formed densely and solved by Cholesky, the point
steps follow by back-substitution. A step is taken when it lowers the
cost; the damping divides by 3 on a taken step and doubles on a refused
one. Nothing here comes from the program under test.
"""

from __future__ import annotations

import torch


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """[K, 3] angle-axis -> [K, 3, 3] rotation matrices."""
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    small = theta < 1e-12
    k = aa / torch.where(small, torch.ones_like(theta), theta)
    K = skew(k)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R = eye + s * K + (1 - c) * (K @ K)
    return torch.where(small[..., None], eye + skew(aa), R)


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def quat_to_matrix(wxyz: torch.Tensor) -> torch.Tensor:
    """[K, 4] unit quaternions (w, x, y, z) -> [K, 3, 3]."""
    q = wxyz / torch.linalg.vector_norm(wxyz, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


class Problem:
    """Observations of a BAL problem on a device, in ``dtype``."""

    def __init__(self, data: dict, device, dtype=torch.float64):
        def t(a, dt=dtype):
            return torch.as_tensor(a, device=device).to(dt)

        self.obs_cam = t(data["obs_cam"], torch.int64)
        self.obs_pt = t(data["obs_pt"], torch.int64)
        self.obs_uv = t(data["obs_uv"])
        self.n_cams = int(data["cam_params"].shape[0])
        self.n_points = int(data["points"].shape[0])
        self.dtype, self.device = dtype, device


def start_params(data: dict, device, dtype=torch.float64):
    """(R [K, 3, 3], t [K, 3], fkk [K, 3], X [P, 3]) of a BAL dict."""
    cam = torch.as_tensor(data["cam_params"], device=device).to(dtype)
    return (rodrigues(cam[:, :3]), cam[:, 3:6].clone(), cam[:, 6:9].clone(),
            torch.as_tensor(data["points"], device=device).to(dtype))


def residuals(prob: Problem, params) -> torch.Tensor:
    R, t, fkk, X = params
    oc, op = prob.obs_cam, prob.obs_pt
    p = (R[oc] @ X[op][..., None])[..., 0] + t[oc]
    q = -p[:, :2] / p[:, 2:3]
    r2 = (q * q).sum(-1, keepdim=True)
    f, k1, k2 = fkk[oc, 0:1], fkk[oc, 1:2], fkk[oc, 2:3]
    return f * (1 + k1 * r2 + k2 * r2 * r2) * q - prob.obs_uv


def cost(prob: Problem, params) -> torch.Tensor:
    r = residuals(prob, params)
    return 0.5 * (r * r).sum()


def jacobians(prob: Problem, params):
    """(r [O, 2], Jc [O, 2, 9], Jp [O, 2, 3]); the camera's 9 columns are a
    rotation perturbation exp(d) R (3), the translation (3), f, k1, k2."""
    R, t, fkk, X = params
    oc, op = prob.obs_cam, prob.obs_pt
    RX = (R[oc] @ X[op][..., None])[..., 0]
    p = RX + t[oc]
    iz = 1.0 / p[:, 2]
    q = -p[:, :2] * iz[:, None]
    r2 = (q * q).sum(-1)
    f, k1, k2 = fkk[oc, 0], fkk[oc, 1], fkk[oc, 2]
    d = 1 + k1 * r2 + k2 * r2 * r2
    dd = k1 + 2 * k2 * r2
    r = (f * d)[:, None] * q - prob.obs_uv
    eye2 = torch.eye(2, dtype=p.dtype, device=p.device)
    du_dq = (f * d)[:, None, None] * eye2 + (2 * f * dd)[:, None, None] * (
        q[:, :, None] * q[:, None, :])
    zero = torch.zeros_like(iz)
    dq_dp = -iz[:, None, None] * torch.stack([
        torch.stack([torch.ones_like(iz), zero, -p[:, 0] * iz], -1),
        torch.stack([zero, torch.ones_like(iz), -p[:, 1] * iz], -1)], -2)
    du_dp = du_dq @ dq_dp
    J_rot = du_dp @ (-skew(RX))
    J_t = du_dp
    J_f = (d[:, None] * q)[..., None]
    J_k1 = ((f * r2)[:, None] * q)[..., None]
    J_k2 = ((f * r2 * r2)[:, None] * q)[..., None]
    Jc = torch.cat([J_rot, J_t, J_f, J_k1, J_k2], -1)
    Jp = du_dp @ R[oc]
    return r, Jc, Jp


def apply_step(params, dc: torch.Tensor, dX: torch.Tensor):
    R, t, fkk, X = params
    return (rodrigues(dc[:, 0:3]) @ R, t + dc[:, 3:6], fkk + dc[:, 6:9], X + dX)


def lm_step(prob: Problem, params, lam: float):
    """The damped Gauss-Newton step (dc [K, 9], dX [P, 3]) at ``params``;
    camera 0 is the gauge."""
    r, Jc, Jp = jacobians(prob, params)
    fixed = torch.zeros(prob.n_cams, dtype=torch.bool, device=r.device)
    fixed[0] = True
    return schur_step(r, Jc, Jp, prob.obs_cam, prob.obs_pt, prob.n_points, fixed, lam)


def schur_step(r, Jc, Jp, oc, op, P: int, fixed, lam: float):
    """The damped Gauss-Newton step of residuals r [O, 2] with camera
    Jacobians Jc [O, 2, C] and point Jacobians Jp [O, 2, 3] (observation o
    of camera oc[o] and point op[o]): (dc [K, C], dX [P, 3]), the cameras
    in ``fixed`` held. The reduced camera system S = Hcc - W Hpp^-1 W^T is
    formed densely and solved by Cholesky; the damping adds lam times each
    diagonal."""
    K, C = fixed.shape[0], Jc.shape[-1]
    dt, dev = r.dtype, r.device
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
    # W as a dense [P, 3, CK] table; S = blockdiag(Hcc) - W^T Hpp^-1 W
    W = torch.zeros(P, 3, K * C, dtype=dt, device=dev)
    cols = oc[:, None] * C + torch.arange(C, device=dev)[None]
    W.view(P * 3, K * C).index_put_(
        ((op[:, None] * 3 + torch.arange(3, device=dev)[None])[:, :, None].expand(-1, 3, C),
         cols[:, None, :].expand(-1, 3, C)),
        Jp.transpose(1, 2) @ Jc, accumulate=True)
    Y = Hpp_inv @ W                                        # [P, 3, CK]
    S = -(W.reshape(P * 3, K * C).T @ Y.reshape(P * 3, K * C))
    blocks = torch.arange(K, device=dev)
    S.view(K, C, K, C)[blocks, :, blocks, :] += Hcc
    rhs = -(gc.reshape(K * C) - torch.einsum("pik,pi->k", Y, gp))
    keep = (~fixed).repeat_interleave(C)
    dc = torch.zeros(K * C, dtype=dt, device=dev)
    L = torch.linalg.cholesky(S[keep][:, keep].to(fdt))
    dc[keep] = torch.cholesky_solve(rhs[keep][:, None].to(fdt), L)[:, 0].to(dt)
    # dX = Hpp^-1 (-gp - W dc)
    dX = (Hpp_inv @ (-gp - (W @ dc))[..., None])[..., 0]
    return dc.view(K, C), dX


def solve(prob: Problem, params, max_iters: int, lam0: float = 1e-3):
    """LM from ``params``: (params, cost per iteration, taken steps)."""
    lam = lam0
    best = cost(prob, params)
    costs, taken = [float(best)], 0
    for _ in range(max_iters):
        try:
            dc, dX = lm_step(prob, params, lam)
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
