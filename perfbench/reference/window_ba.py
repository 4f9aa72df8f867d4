"""Plain reference of the VO's sliding-window bundle adjustment, in plain
torch: the objective that the window's last BA minimised, evaluated at the
state the program left, and its minimum, found by Levenberg-Marquardt from
that state in float64.

The window: keyframe k has a world->camera pose (R_k, t_k) and, for each
track slot, the pixel its track had when the keyframe was made and the map
point the slot belongs to. A live observation (a slot with a point, on a
valid keyframe, of a valid point) contributes the Huber loss (delta in
pixels) of its pinhole reprojection residual,
(fx x/z + cx - u, fy y/z + cy - v) with (x, y, z) = R_k X + t_k, where z >
1e-6. The two oldest valid keyframes are held fixed (the gauge). This
follows the program's state from its own last step: it judges window BA
and the map and poses it leaves, not the stages before it.
"""

from __future__ import annotations

import torch

from perfbench.reference.bal_lm import quat_to_matrix, rodrigues, schur_step, skew


class Window:
    """A window's observations, from the raw state the program left."""

    def __init__(self, kf_wxyz, kf_t, kf_frame_id, kf_valid, obs_px, obs_point, map_xyz,
                 map_valid, intrinsics, huber_delta: float, device, dtype=torch.float64):
        def t(a, dt=dtype):
            return torch.as_tensor(a, device=device).to(dt)

        valid = t(kf_valid, torch.bool)
        point = t(obs_point, torch.int64)
        K, N = point.shape
        oc = torch.arange(K, device=device)[:, None].expand(K, N).reshape(-1)
        op = point.reshape(-1)
        live = (op >= 0) & valid[oc]
        live &= t(map_valid, torch.bool)[op.clamp(min=0)]
        self.oc, self.op = oc[live], op[live]
        self.uv = t(obs_px).reshape(-1, 2)[live]
        self.intr = t(intrinsics)
        self.delta = float(huber_delta)
        fid = t(kf_frame_id, torch.int64)
        order = torch.where(valid, fid, torch.full_like(fid, 2 ** 62))
        self.fixed = ~valid
        self.fixed[torch.argsort(order, stable=True)[:2]] = True
        self.params = (quat_to_matrix(t(kf_wxyz)), t(kf_t), t(map_xyz))
        self.n_points = self.params[2].shape[0]


def _project(win: Window, params):
    R, tr, X = params
    xc = (R[win.oc] @ X[win.op][..., None])[..., 0] + tr[win.oc]
    z = xc[:, 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, torch.ones_like(z))
    fx, fy, cx, cy = win.intr
    r = torch.stack([fx * xc[:, 0] / zs + cx, fy * xc[:, 1] / zs + cy], -1) - win.uv
    return xc, zs, torch.where(ok[:, None], r, torch.zeros_like(r)), ok


def cost(win: Window, params) -> torch.Tensor:
    _, _, r, _ = _project(win, params)
    n = torch.linalg.vector_norm(r, dim=-1)
    d = win.delta
    return torch.where(n <= d, 0.5 * n * n, d * (n - 0.5 * d)).sum()


def step(win: Window, params, lam: float):
    """The damped Gauss-Newton step of the Huber objective (its residuals
    reweighted, IRLS): (dc [K, 6] = rotation, translation; dX [P, 3])."""
    R, _, _ = params
    xc, z, r, ok = _project(win, params)
    fx, fy = win.intr[0], win.intr[1]
    zero = torch.zeros_like(z)
    J_proj = torch.stack([torch.stack([fx / z, zero, -fx * xc[:, 0] / (z * z)], -1),
                          torch.stack([zero, fy / z, -fy * xc[:, 1] / (z * z)], -1)], -2)
    J_proj = torch.where(ok[:, None, None], J_proj, torch.zeros_like(J_proj))
    # x_c' = exp(w) x_c + rho: the rotation about the camera's origin first
    Jc = torch.cat([J_proj @ (-skew(xc)), J_proj], -1)
    Jp = J_proj @ R[win.oc]
    n = torch.linalg.vector_norm(r, dim=-1)
    sw = torch.sqrt(torch.where(n <= win.delta, torch.ones_like(n),
                                win.delta / n.clamp(min=1e-12)))[:, None]
    return schur_step(r * sw, Jc * sw[..., None], Jp * sw[..., None], win.oc, win.op,
                      win.n_points, win.fixed, lam)


def apply_step(params, dc, dX):
    R, t, X = params
    dR = rodrigues(dc[:, :3])
    return (dR @ R, (dR @ t[..., None])[..., 0] + dc[:, 3:], X + dX)


def minimise(win: Window, max_iters: int, lam0: float = 1e-3):
    """LM from the program's state: (the lowest cost found, the state's)."""
    params, lam = win.params, lam0
    start = best = cost(win, params)
    for _ in range(max_iters):
        try:
            dc, dX = step(win, params, lam)
        except RuntimeError:                  # a failed factorisation: damp more
            lam = min(lam * 2.0, 1e6)
            continue
        cand = apply_step(params, dc, dX)
        c = cost(win, cand)
        if bool(torch.isfinite(c)) and bool(c < best):
            params, best, lam = cand, c, max(lam / 3.0, 1e-9)
        else:
            lam = min(lam * 2.0, 1e6)
    return float(best), float(start)
