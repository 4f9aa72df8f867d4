"""Snavely-camera bundle adjustment: the exact BAL objective (port of
dr3_tpu.ba.snavely; reference offline adjuster tests/ceres/ba.cc:105-118).

Each camera has the 9 BAL parameters: angle-axis rotation (3), translation
(3), focal f, radial k1, k2, and projects

    p  = R X + t                (camera looks down -z)
    q  = -(p_x, p_y) / p_z
    u  = f * (1 + k1 |q|^2 + k2 |q|^4) * q

Cameras carry a 9-dim tangent: SE3 left retraction on the pose half,
additive on (f, k1, k2). Costs are comparable with Ceres on the same file.

The BAL-scale path (``zexplicit`` and ``pcg`` under the one-hot size limit)
linearises and assembles in one pass (:func:`_assemble_direct`) and keeps
the camera-point coupling W = Jc^T Jp factored as the weighted Jacobian
columns: every product with W goes through the 2-dim residual space.
``zexplicit`` is the exact reduced camera system by a square-root
factorisation, S = Hcc - Z^T Z, built block by block from the co-visible
observation pairs (ops/schur.py, csrc/schur.cu on the card): Z itself is
never formed; ``pcg`` is matrix-free CG with the SCHUR_JACOBI
preconditioner. Past the size limits, or with ``explicit``, the solve is
the generic observation-keyed Schur core (ba/schur_core.py) at a 9-wide
camera block.

Sums are taken in a fixed order, so an LM run gives the same bits from run
to run on the card: camera-keyed sums and broadcasts are products with the
0/1 membership matrix E (exact for a broadcast, fixed order for a sum; both
need float32 products, torch's default, TF32 off), point-keyed sums a
gather into a [points, d] table of row ids, built once per LM run (one host
read, which brings zexplicit's pair count too), and each entry of the reduced camera matrix one owner's sum of its
pairs in a fixed order. The LM loop reads nothing back to the host; ``pcg``
reads one flag per CG iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dr3_tpu_torch.ba.schur_core import (_ONEHOT_MAX_ELEMS, _camera_reducer, _solve_schur,
                                         _table_reducer, assemble_blocks, cam_onehot_matrix)
from dr3_tpu_torch.ba.schur_lm import _EXPLICIT_MAX_CAMS
from dr3_tpu_torch.geometry.lie import SE3, SO3, hat, quat_normalize, quat_rotate, \
    quat_to_matrix
from dr3_tpu_torch.geometry.linalg import _chol_factor_small, _chol_inverse_factored
from dr3_tpu_torch.ops.schur import _damp_hcc, _inv3x3_flat, pair_sizes, schur_blocks, \
    schur_factor, schur_pairs
from dr3_tpu_torch.utils.timing import span


class SnavelyProblem(NamedTuple):
    cam_wxyz: torch.Tensor   # [K, 4] world->camera rotations
    cam_t: torch.Tensor      # [K, 3]
    cam_fkk: torch.Tensor    # [K, 3] focal, k1, k2
    points: torch.Tensor     # [P, 3]
    obs_cam: torch.Tensor    # [O] int32
    obs_pt: torch.Tensor     # [O] int32
    obs_uv: torch.Tensor     # [O, 2] BAL pixel measurements
    obs_w: torch.Tensor      # [O] weight; 0 = padding
    cam_fixed: torch.Tensor  # [K] bool gauge

    @property
    def n_cams(self) -> int:
        return self.cam_wxyz.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_obs(self) -> int:
        return self.obs_cam.shape[0]


class SnavelyResult(NamedTuple):
    problem: SnavelyProblem
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    n_accepted: torch.Tensor
    lambda_final: torch.Tensor
    cg_iters: int = 0        # CG iterations run (= host reads in the CG loop)


_PARAMS = ("cam_wxyz", "cam_t", "cam_fkk", "points")


def bal_to_snavely(d, dtype=torch.float32, device=None) -> SnavelyProblem:
    """Raw BAL arrays -> SnavelyProblem on ``device`` (the card unless asked
    otherwise), parameter for parameter; camera 0 is the gauge."""
    from dr3_tpu_torch.utils.device import resolve

    dev = resolve(device, "bal_to_snavely")

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    K = d.cam_params.shape[0]
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[0] = True
    return SnavelyProblem(
        cam_wxyz=SO3.exp(t(d.cam_params[:, 0:3])).wxyz.to(dtype),
        cam_t=t(d.cam_params[:, 3:6]),
        cam_fkk=t(d.cam_params[:, 6:9]),
        points=t(d.points),
        obs_cam=t(d.obs_cam, torch.int32),
        obs_pt=t(d.obs_pt, torch.int32),
        obs_uv=t(d.obs_uv),
        obs_w=torch.ones(d.obs_cam.shape[0], dtype=dtype, device=dev),
        cam_fixed=fixed,
    )


def snavely_to_bal(p: SnavelyProblem):
    from dr3_tpu_torch.io.bal import BALData

    def n(x, dt=np.float64):
        return x.detach().cpu().numpy().astype(dt)

    aa = n(SO3(p.cam_wxyz).log())
    return BALData(cam_params=np.concatenate([aa, n(p.cam_t), n(p.cam_fkk)], axis=1),
                   points=n(p.points), obs_cam=n(p.obs_cam, np.int32),
                   obs_pt=n(p.obs_pt, np.int32), obs_uv=n(p.obs_uv))


def _z_safe(z):
    return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)


def project_snavely(fkk: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """BAL projection of camera-frame points (ba.cc:105-118): looks down -z,
    u = f * distortion * (-x/z, -y/z)."""
    f, k1, k2 = fkk[..., 0:1], fkk[..., 1:2], fkk[..., 2:3]
    q = -xc[..., :2] / _z_safe(xc[..., 2:3])
    r2 = torch.sum(q * q, dim=-1, keepdim=True)
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    return f * dist * q


class SnavelyResiduals(NamedTuple):
    r: torch.Tensor    # [O, 2]
    Jc: torch.Tensor   # [O, 2, 9] d r / d [rho, omega, f, k1, k2]
    Jp: torch.Tensor   # [O, 2, 3]
    cost: torch.Tensor
    valid: torch.Tensor


def _huber(r_norm, huber_delta):
    return torch.where(r_norm <= huber_delta, 0.5 * r_norm ** 2,
                       huber_delta * (r_norm - 0.5 * huber_delta))


def residuals_only(p: SnavelyProblem) -> torch.Tensor:
    oc, op = p.obs_cam.long(), p.obs_pt.long()
    xc = quat_rotate(p.cam_wxyz[oc], p.points[op]) + p.cam_t[oc]
    return project_snavely(p.cam_fkk[oc], xc) - p.obs_uv


def residual_cost(p: SnavelyProblem, huber_delta: float = 2.0) -> torch.Tensor:
    """Robust cost without Jacobians (the LM accept test). Validity here is
    residual finiteness only (linearize's Jacobian-finiteness mask applies
    at the next linearisation)."""
    oc, op = p.obs_cam.long(), p.obs_pt.long()
    fkk = p.cam_fkk[oc]
    xc = quat_rotate(p.cam_wxyz[oc], p.points[op]) + p.cam_t[oc]
    f, k1, k2 = fkk[..., 0], fkk[..., 1], fkk[..., 2]
    z = xc[..., 2]
    q2d = -xc[..., :2] / _z_safe(z)[..., None]
    r2 = torch.sum(q2d * q2d, dim=-1)
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    r = f[..., None] * dist[..., None] * q2d - p.obs_uv
    valid = torch.isfinite(r).all(dim=-1) & (z.abs() > 1e-9) & (p.obs_w > 0)
    r = torch.where(valid[..., None], r, torch.zeros_like(r))
    rho = _huber(torch.linalg.vector_norm(r, dim=-1), huber_delta)
    return torch.sum(p.obs_w * valid.to(r.dtype) * rho)


def linearize(p: SnavelyProblem, huber_delta: float = 2.0) -> SnavelyResiduals:
    """Residuals + analytic Jacobians per observation (9-dim camera blocks)."""
    oc, op = p.obs_cam.long(), p.obs_pt.long()
    quat = p.cam_wxyz[oc]
    fkk = p.cam_fkk[oc]
    xc = quat_rotate(quat, p.points[op]) + p.cam_t[oc]          # [O, 3]

    f, k1, k2 = fkk[..., 0], fkk[..., 1], fkk[..., 2]
    z = xc[..., 2]
    inv_z = 1.0 / _z_safe(z)
    q2d = -xc[..., :2] * inv_z[..., None]                        # [O, 2]
    r2 = torch.sum(q2d * q2d, dim=-1)
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    ddist = k1 + 2.0 * k2 * r2                                   # d dist / d r2
    r = f[..., None] * dist[..., None] * q2d - p.obs_uv

    # du/dq = f * (dist * I + 2 ddist * q q^T)   [O, 2, 2]
    eye2 = torch.eye(2, dtype=xc.dtype, device=xc.device)
    du_dq = (f * dist)[..., None, None] * eye2 + \
        (2.0 * f * ddist)[..., None, None] * (q2d[..., :, None] * q2d[..., None, :])
    # dq/dp = -(1/z) * [[1, 0, -x/z], [0, 1, -y/z]]   [O, 2, 3]
    one, zero = torch.ones_like(inv_z), torch.zeros_like(inv_z)
    dq_dp = -inv_z[..., None, None] * torch.stack([
        torch.stack([one, zero, -xc[..., 0] * inv_z], -1),
        torch.stack([zero, one, -xc[..., 1] * inv_z], -1)], -2)
    du_dp = du_dq @ dq_dp                                        # [O, 2, 3]

    # pose block (left retraction): dp/d[rho, omega] = [I | -hat(p)]
    eye3 = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[:-1] + (3, 3))
    J_pose = du_dp @ torch.cat([eye3, -hat(xc)], dim=-1)         # [O, 2, 6]
    du_df = (dist[..., None] * q2d)[..., None]                   # [O, 2, 1]
    du_dk1 = (f * r2)[..., None, None] * q2d[..., None]
    du_dk2 = (f * r2 * r2)[..., None, None] * q2d[..., None]
    Jc = torch.cat([J_pose, du_df, du_dk1, du_dk2], dim=-1)      # [O, 2, 9]
    Jp = du_dp @ quat_to_matrix(quat_normalize(quat))

    # sanitise through the mask with where, not 0-multiplication: padded or
    # non-finite observations can overflow the k2 r^4 term, and 0 * inf
    # would put NaN into the summed cost and normal equations
    valid = torch.isfinite(r).all(dim=-1) & (z.abs() > 1e-9) & (p.obs_w > 0) \
        & torch.isfinite(Jc).all(dim=(-2, -1)) & torch.isfinite(Jp).all(dim=(-2, -1))
    r = torch.where(valid[..., None], r, torch.zeros_like(r))
    Jc = torch.where(valid[..., None, None], Jc, torch.zeros_like(Jc))
    Jp = torch.where(valid[..., None, None], Jp, torch.zeros_like(Jp))
    r_norm = torch.linalg.vector_norm(r, dim=-1)
    huber_w = torch.where(r_norm <= huber_delta, torch.ones_like(r_norm),
                          huber_delta / torch.clamp(r_norm, min=1e-12))
    vf = valid.to(r.dtype)
    sw = torch.sqrt(p.obs_w * huber_w * vf)[..., None]
    cost = torch.sum(p.obs_w * vf * _huber(r_norm, huber_delta))
    return SnavelyResiduals(r=r * sw, Jc=Jc * sw[..., None], Jp=Jp * sw[..., None],
                            cost=cost, valid=valid)


class DirectBlocks(NamedTuple):
    """Normal-equation blocks of the BAL-scale path. The coupling W =
    Jc^T Jp is carried factored as the weighted Jacobian columns (u and v
    residual rows): (W x)_o = Jp_o^T (Jc_o x), with Jc_o x two scalars, so
    no [O, 9, 3] coupling array is formed."""

    Hcc: torch.Tensor       # [K, 9, 9]
    bc: torch.Tensor        # [K, 9]
    Hpp9: torch.Tensor      # [P, 9] row-major 3x3 blocks
    bp: torch.Tensor        # [P, 3]
    Jcu: torch.Tensor       # [O, 9] camera-Jacobian columns, u row
    Jcv: torch.Tensor       # [O, 9] v row
    Jpu: torch.Tensor       # [O, 3] point-Jacobian columns, u row
    Jpv: torch.Tensor       # [O, 3] v row
    obs_cam: torch.Tensor   # [O] int64, clamped to [0, K)
    obs_pt: torch.Tensor    # [O] int64, clamped to [0, P)
    active: torch.Tensor    # [O] bool


def _assemble_direct(p: SnavelyProblem, E, huber_delta: float, by_pt=None):
    """Fused linearise + normal-equation assembly; the same math as
    :func:`linearize` + ``schur_core.assemble_blocks`` to float32 rounding.
    ``E`` is the [O, K] 0/1 camera membership matrix; ``by_pt`` the point
    reducer (``schur_core._table_reducer`` over every row: an inactive
    row's terms are exact zeros; built here when None). Returns
    (DirectBlocks, robust cost)."""
    K, P = p.n_cams, p.n_points
    oc = p.obs_cam.long().clamp(0, K - 1)
    op = p.obs_pt.long().clamp(0, P - 1)
    by_cam, to_obs = _camera_reducer(oc, K, E)
    if by_pt is None:
        by_pt = _table_reducer(op, P)

    # per-observation camera parameters by one product with E (exact: its
    # rows are one-hot), points by one gather
    po = to_obs(torch.cat([p.cam_wxyz, p.cam_t, p.cam_fkk], dim=1))    # [O, 10]
    qw, qx_, qy_, qz_, tx, ty, tz, f, k1, k2 = po.unbind(1)
    X0, X1, X2 = p.points[op].unbind(1)

    qn = torch.rsqrt(torch.clamp(qw * qw + qx_ * qx_ + qy_ * qy_ + qz_ * qz_, min=1e-24))
    w, x, y, z_ = qw * qn, qx_ * qn, qy_ * qn, qz_ * qn
    R00 = 1.0 - 2.0 * (y * y + z_ * z_)
    R01 = 2.0 * (x * y - w * z_)
    R02 = 2.0 * (x * z_ + w * y)
    R10 = 2.0 * (x * y + w * z_)
    R11 = 1.0 - 2.0 * (x * x + z_ * z_)
    R12 = 2.0 * (y * z_ - w * x)
    R20 = 2.0 * (x * z_ - w * y)
    R21 = 2.0 * (y * z_ + w * x)
    R22 = 1.0 - 2.0 * (x * x + y * y)

    xc0 = R00 * X0 + R01 * X1 + R02 * X2 + tx
    xc1 = R10 * X0 + R11 * X1 + R12 * X2 + ty
    xc2 = R20 * X0 + R21 * X1 + R22 * X2 + tz

    iz = 1.0 / _z_safe(xc2)
    qx = -xc0 * iz
    qy = -xc1 * iz
    r2 = qx * qx + qy * qy
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    ddist = k1 + 2.0 * k2 * r2

    fd = f * dist
    ru = fd * qx - p.obs_uv[:, 0]
    rv = fd * qy - p.obs_uv[:, 1]

    # du/dq = f*dist*I + 2 f ddist q q^T (2x2 symmetric)
    B = 2.0 * f * ddist
    d11 = fd + B * qx * qx
    d12 = B * qx * qy
    d22 = fd + B * qy * qy
    # du/dp = du_dq @ dq_dp with dq_dp = [[-iz, 0, -iz*qx], [0, -iz, -iz*qy]]
    M00 = -iz * d11
    M01 = -iz * d12
    M02 = -iz * (d11 * qx + d12 * qy)
    M10 = -iz * d12
    M11 = -iz * d22
    M12 = -iz * (d12 * qx + d22 * qy)

    # pose block: [du_dp | -du_dp @ hat(xc)]
    def rot_cols(a, b, c):
        return (b * xc2 - c * xc1, c * xc0 - a * xc2, a * xc1 - b * xc0)

    W03, W04, W05 = rot_cols(M00, M01, M02)
    W13, W14, W15 = rot_cols(M10, M11, M12)
    r2q = f * r2
    Jcu = torch.stack([M00, M01, M02, -W03, -W04, -W05, dist * qx, r2q * qx,
                       r2q * r2 * qx], dim=1)                          # [O, 9]
    Jcv = torch.stack([M10, M11, M12, -W13, -W14, -W15, dist * qy, r2q * qy,
                       r2q * r2 * qy], dim=1)
    # Jp = du_dp @ R
    Jpu = torch.stack([M00 * R00 + M01 * R10 + M02 * R20,
                       M00 * R01 + M01 * R11 + M02 * R21,
                       M00 * R02 + M01 * R12 + M02 * R22], dim=1)      # [O, 3]
    Jpv = torch.stack([M10 * R00 + M11 * R10 + M12 * R20,
                       M10 * R01 + M11 * R11 + M12 * R21,
                       M10 * R02 + M11 * R12 + M12 * R22], dim=1)

    valid = torch.isfinite(ru) & torch.isfinite(rv) \
        & torch.isfinite(torch.cat([Jcu, Jcv, Jpu, Jpv], dim=1)).all(dim=1) \
        & (xc2.abs() > 1e-9) & (p.obs_w > 0)

    # sanitise through the mask with where, not 0-multiplication (as linearize)
    vf = valid.to(ru.dtype)
    zero = torch.zeros_like(ru)
    ru = torch.where(valid, ru, zero)
    rv = torch.where(valid, rv, zero)
    r_norm = torch.sqrt(ru * ru + rv * rv)
    huber_w = torch.where(r_norm <= huber_delta, torch.ones_like(r_norm),
                          huber_delta / torch.clamp(r_norm, min=1e-12))
    sw = torch.sqrt(p.obs_w * huber_w * vf)
    cost = torch.sum(p.obs_w * vf * _huber(r_norm, huber_delta))

    ru, rv = ru * sw, rv * sw
    keep = valid[:, None]
    sw1 = sw[:, None]
    Jcu = torch.where(keep, Jcu, torch.zeros_like(Jcu)) * sw1
    Jcv = torch.where(keep, Jcv, torch.zeros_like(Jcv)) * sw1
    Jpu = torch.where(keep, Jpu, torch.zeros_like(Jpu)) * sw1
    Jpv = torch.where(keep, Jpv, torch.zeros_like(Jpv)) * sw1

    # camera-keyed [O, 81 + 9] (AtA | Atr) through one product with E,
    # point-keyed [O, 9 + 3] (BtB | Btr) through the point table
    O = ru.shape[0]
    AtA = Jcu[:, :, None] * Jcu[:, None, :] + Jcv[:, :, None] * Jcv[:, None, :]
    Atr = Jcu * ru[:, None] + Jcv * rv[:, None]
    red = by_cam(torch.cat([AtA.reshape(O, 81), Atr], dim=1))           # [K, 90]
    BtB = Jpu[:, :, None] * Jpu[:, None, :] + Jpv[:, :, None] * Jpv[:, None, :]
    Btr = Jpu * ru[:, None] + Jpv * rv[:, None]
    pred = by_pt(torch.cat([BtB.reshape(O, 9), Btr], dim=1))            # [P, 12]
    return DirectBlocks(Hcc=red[:, :81].reshape(K, 9, 9), bc=-red[:, 81:90],
                        Hpp9=pred[:, :9], bp=-pred[:, 9:12], Jcu=Jcu, Jcv=Jcv,
                        Jpu=Jpu, Jpv=Jpv, obs_cam=oc, obs_pt=op, active=valid), cost


def _mv3(h9, x):
    """[P, 9] flat 3x3 blocks times [P, 3] vectors -> [P, 3]."""
    return torch.stack([
        h9[:, 0] * x[:, 0] + h9[:, 1] * x[:, 1] + h9[:, 2] * x[:, 2],
        h9[:, 3] * x[:, 0] + h9[:, 4] * x[:, 1] + h9[:, 5] * x[:, 2],
        h9[:, 6] * x[:, 0] + h9[:, 7] * x[:, 1] + h9[:, 8] * x[:, 2]], dim=-1)


# auto's zexplicit ceiling: the [3P, 9K] float32 Z of the square-root
# factorisation. The port forms no Z (its pair list holds two ids a pair,
# n_p (n_p + 1) / 2 pairs a point seen n_p times), but auto routes as the JAX
# package does
_Z_MAX_BYTES = 2 * 1024 ** 3


def _damp_blocks(blocks: DirectBlocks, lam):
    """(Hcc + diag(lam * diag Hcc + 1e-8), the damped point inverses [P, 9])."""
    return _damp_hcc(blocks.Hcc, lam), _inv3x3_flat(blocks.Hpp9, lam)


def _pair(blocks: DirectBlocks, per_obs3):
    """Jp_o v_o for [O, 3] v: the (u, v) residual-space pair, [O] each."""
    return (blocks.Jpu * per_obs3).sum(-1), (blocks.Jpv * per_obs3).sum(-1)


def _reduced_rhs(blocks: DirectBlocks, Hinv9, by_cam):
    """rhs_c = bc - by_cam(Jc^T Jp Hinv bp), through t = Jp (Hinv bp)."""
    tu, tv = _pair(blocks, _mv3(Hinv9, blocks.bp)[blocks.obs_pt])
    return blocks.bc - by_cam(blocks.Jcu * tu[:, None] + blocks.Jcv * tv[:, None])


def _camera_step(S, rhs_c, dinv, cam_fixed):
    """dc [K, 9] from the scaled system by Cholesky, gauge cameras' rows and
    columns replaced by identity. A failed factorisation (a camera with no
    live observation at tiny lambda) gives NaN, as jnp.linalg.cholesky
    does, and the step becomes zero; no host read."""
    K = rhs_c.shape[0]
    keep_v = (~cam_fixed).to(S.dtype).repeat_interleave(9)
    S = S * keep_v[:, None] * keep_v[None, :] + torch.diag(1.0 - keep_v)
    S = S + 1e-6 * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    rhs = rhs_c.reshape(9 * K) * dinv * keep_v
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
    xs = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    xs = torch.where(torch.isfinite(xs), xs, torch.zeros_like(xs))
    return (xs * dinv).view(K, 9)


def _back_substitute(blocks: DirectBlocks, dc, cam_fixed, Hinv9, to_obs, by_pt):
    """dp = Hinv (bp - W^T dc), with (W^T dc)_o = Jp_o^T (Jc_o dc)."""
    dco = to_obs(dc * (~cam_fixed)[:, None].to(dc.dtype))               # [O, 9]
    su = (blocks.Jcu * dco).sum(-1)
    sv = (blocks.Jcv * dco).sum(-1)
    up = by_pt(blocks.Jpu * su[:, None] + blocks.Jpv * sv[:, None])
    return _mv3(Hinv9, blocks.bp - up)


def _solve_explicit_direct(blocks: DirectBlocks, lam, cam_fixed, E, by_pt=None, pairs=None):
    """The exact dense Schur step by the square-root factorisation: the
    correction sum_p W_p Hpp^-1 W_p^T is Z^T Z, summed block by block over
    co-visible observation pairs (ops/schur.py: ``pairs``, built here from
    ``by_pt``'s point table when None), into the Jacobi-scaled reduced
    [9K, 9K] system, which solves by Cholesky. The same reduced system as
    schur_core.solve_schur(method='explicit'). Returns (dc, dp)."""
    K = blocks.Hcc.shape[0]
    by_cam, to_obs = _camera_reducer(blocks.obs_cam, K, E)
    if by_pt is None:
        by_pt = _table_reducer(blocks.obs_pt, blocks.Hpp9.shape[0])
    if pairs is None:
        pairs = schur_pairs(blocks.obs_cam, blocks.obs_pt, by_pt.table, K)
    with span("ba.z_build"):
        Hcc = blocks.Hcc.contiguous()
        Hinv9, G, dinv = schur_factor(blocks.Hpp9.contiguous(), Hcc, lam, blocks.Jcu,
                                      blocks.Jcv, blocks.Jpu, blocks.Jpv, pairs)
    with span("ba.ztz"):
        S = schur_blocks(G, dinv, Hcc, lam, pairs)
    del G                                # freed before the Cholesky
    with span("ba.camera_solve"):
        dc = _camera_step(S, _reduced_rhs(blocks, Hinv9, by_cam), dinv, cam_fixed)
    with span("ba.back_substitute"):
        return dc, _back_substitute(blocks, dc, cam_fixed, Hinv9, to_obs, by_pt)


def _solve_pcg_direct(blocks: DirectBlocks, lam, cam_fixed, E, cg_iters: int,
                      cg_tol: float, q_eta: float, by_pt=None):
    """Matrix-free Schur PCG on the factored blocks: schur_core's pcg math
    (SCHUR_JACOBI preconditioner, the relative-residual and Ceres
    Q-stagnation exits), every product with W through the residual space,
    one point sum and one gather per CG iteration, one host read per CG
    iteration (the exit test). Returns (dc, dp, CG iterations run)."""
    K = blocks.Hcc.shape[0]
    O = blocks.obs_pt.shape[0]
    op = blocks.obs_pt
    Jcu, Jcv = blocks.Jcu, blocks.Jcv
    by_cam, to_obs = _camera_reducer(blocks.obs_cam, K, E)
    if by_pt is None:
        by_pt = _table_reducer(op, blocks.Hpp9.shape[0])
    Hcc_d, Hinv9 = _damp_blocks(blocks, lam)
    rhs_c = _reduced_rhs(blocks, Hinv9, by_cam)

    # SCHUR_JACOBI: the block diagonal of S. Per observation W Hinv W^T =
    # Jc^T (Jp Hinv Jp^T) Jc, the middle a 2x2 (a b; b g) of [O] scalars
    Hio = Hinv9[op].view(O, 3, 3)
    hu = torch.einsum("oj,ojl->ol", blocks.Jpu, Hio)
    hv = torch.einsum("oj,ojl->ol", blocks.Jpv, Hio)
    a2 = (hu * blocks.Jpu).sum(-1)[:, None, None]
    b2 = (hu * blocks.Jpv).sum(-1)[:, None, None]
    g2 = (hv * blocks.Jpv).sum(-1)[:, None, None]
    uu = Jcu[:, :, None] * Jcu[:, None, :]
    uv = Jcu[:, :, None] * Jcv[:, None, :]
    vv = Jcv[:, :, None] * Jcv[:, None, :]
    mm = a2 * uu + b2 * (uv + uv.transpose(1, 2)) + g2 * vv             # [O, 9, 9]
    M = Hcc_d - by_cam(mm.reshape(O, 81)).view(K, 9, 9)
    eye9 = torch.eye(9, dtype=M.dtype, device=M.device)
    M = torch.where(cam_fixed[:, None, None], eye9, M) + 1e-7 * eye9
    M_inv = _chol_inverse_factored(_chol_factor_small(M))     # applied as one product

    keep = (~cam_fixed).to(Jcu.dtype)[:, None]                          # [K, 1]
    fixed_c = 1.0 - keep

    def s_mv(xc):
        xk = xc * keep
        xo = to_obs(xk)                                                 # [O, 9]
        su = (Jcu * xo).sum(-1)
        sv = (Jcv * xo).sum(-1)
        v = _mv3(Hinv9, by_pt(blocks.Jpu * su[:, None] + blocks.Jpv * sv[:, None]))
        tu, tv = _pair(blocks, v[op])
        y = torch.einsum("kcd,kd->kc", Hcc_d, xk) - by_cam(Jcu * tu[:, None]
                                                            + Jcv * tv[:, None])
        return y * keep + xc * fixed_c

    def dot(a, b):
        return torch.sum(a * b)

    # solve in a normalised scale: |rhs| entries reach ~1e8 on real problems
    # and dot(b, b) then overflows float32 to inf, which makes the first
    # residual test (inf > inf) false and CG exit with a silent zero step.
    # CG is linear, so solve S x' = b / s and rescale.
    b_raw = rhs_c * keep
    s_b = torch.clamp(b_raw.abs().max(), min=1e-30)
    b = b_raw / s_b
    bs = dot(b, b)
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("kcd,kd->kc", M_inv, r)
    p = z
    rz = dot(r, z)
    q_prev = q_cur = torch.zeros_like(bs)
    i = 0
    while i < cg_iters:
        go = dot(r, r) > cg_tol ** 2 * bs
        if q_eta > 0.0 and i > 1:
            go = go & ~(i * (q_prev - q_cur) <= q_eta * q_cur.abs())
        if not bool(go):                     # the loop's one host read
            break
        Ap = s_mv(p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("kcd,kd->kc", M_inv, r)
        rz_new = dot(r, z)
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz = rz_new
        q_prev, q_cur = q_cur, -0.5 * (dot(x, b) + dot(x, r))
        i += 1
    dc = x * s_b
    dc = torch.where(torch.isfinite(dc), dc, torch.zeros_like(dc))
    with span("ba.back_substitute"):
        return dc, _back_substitute(blocks, dc, cam_fixed, Hinv9, to_obs, by_pt), i


def apply_update(p: SnavelyProblem, dc: torch.Tensor, dp: torch.Tensor) -> SnavelyProblem:
    """dc [K, 9] = [rho, omega, df, dk1, dk2]; fixed cameras stay put."""
    dc = torch.where(p.cam_fixed[:, None], torch.zeros_like(dc), dc)
    new_cams = (SE3.exp(dc[:, :6]) @ SE3(p.cam_wxyz, p.cam_t)).normalize()
    return p._replace(cam_wxyz=new_cams.wxyz, cam_t=new_cams.t,
                      cam_fkk=p.cam_fkk + dc[:, 6:], points=p.points + dp)


def _pick_method(problem: SnavelyProblem, solver: str) -> tuple[str, bool]:
    """(the solve ``solver`` runs on ``problem``, whether the one-hot E
    fits). ``auto`` prefers the exact square-root dense Schur whenever dense
    Z fits, then the dense generic solve up to ``_EXPLICIT_MAX_CAMS``
    cameras, then matrix-free PCG."""
    use_direct = problem.n_obs * problem.n_cams <= _ONEHOT_MAX_ELEMS
    z_fits = 12 * problem.n_points * problem.n_cams * 9 <= _Z_MAX_BYTES
    method = solver
    if solver == "auto":
        if use_direct and z_fits:
            method = "zexplicit"
        elif problem.n_cams <= _EXPLICIT_MAX_CAMS:
            method = "explicit"
        else:
            method = "pcg"
    if method == "zexplicit" and not (use_direct and z_fits):
        method = "pcg"
    return method, use_direct


def _accept_step(p: SnavelyProblem, dc, dp, lam, best, huber_delta: float):
    """The LM accept test as selections (no host read): the candidate is
    taken when its cost is lower and finite and its parameters are finite
    (a NaN candidate masks its own observations, so its cost alone can look
    small). Returns (problem, lambda, best cost, accepted)."""
    p_new = apply_update(p, dc, dp)
    new_cost = residual_cost(p_new, huber_delta)
    finite = torch.stack([torch.isfinite(getattr(p_new, k)).all() for k in _PARAMS]).all()
    ok = (new_cost < best) & torch.isfinite(new_cost) & finite
    p = p._replace(**{k: torch.where(ok, getattr(p_new, k), getattr(p, k)) for k in _PARAMS})
    lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9), torch.clamp(lam * 2.0, max=1e6))
    return p, lam, torch.where(ok, new_cost, best), ok


def bundle_adjust_snavely(problem: SnavelyProblem, max_iters: int = 30,
                          huber_delta: float = 2.0, lambda0: float = 1e-3,
                          solver: str = "auto", d_max: int | None = None,
                          cg_iters: int = 100, cg_tol: float = 1e-2,
                          q_eta: float = 0.1) -> SnavelyResult:
    """LM on the exact BAL objective (ba.cc's ceres::Solve equivalent), a
    fixed ``max_iters`` iterations (rejected steps count).

    ``cg_tol``/``q_eta`` control the PCG inner solve (defaults: the loose
    Ceres ITERATIVE_SCHUR forcing, right for BAL-scale problems whose outer
    LM loop absorbs step inexactness). Callers that need near-exact steps,
    fixed LM budgets, tight-convergence tests, pass cg_tol=1e-5, q_eta=0.
    """
    with span("ba.solve"):
        method, use_direct = _pick_method(problem, solver)
        if d_max is None:
            d_max = min(problem.n_cams, problem.n_obs)
        K, P = problem.n_cams, problem.n_points
        dev = problem.cam_t.device
        cost0 = residual_cost(problem, huber_delta)
        # the camera one-hot and the point table are built once: obs ids are
        # constant across the loop
        E = cam_onehot_matrix(problem.obs_cam, K) if use_direct else None
        fast = use_direct and method in ("pcg", "zexplicit")
        op = problem.obs_pt.long().clamp(0, P - 1)
        by_pt = pairs = None
        if fast and method == "zexplicit":
            # the solve's one host read: the table's width and the pair count
            d, n = pair_sizes(problem.obs_cam, op, K, P)
            by_pt = _table_reducer(op, P, width=d)
            pairs = schur_pairs(problem.obs_cam, problem.obs_pt, by_pt.table, K, n)
        elif fast:
            by_pt = _table_reducer(op, P)

        p = problem
        lam = torch.tensor(lambda0, dtype=torch.float32, device=dev)
        best = cost0
        n_acc = torch.zeros((), dtype=torch.int32, device=dev)
        total_cg = 0
        for _ in range(max_iters):
            with span("ba.lm_iter"):
                if fast:
                    with span("ba.assemble"):
                        blocks, _ = _assemble_direct(p, E, huber_delta, by_pt)
                    if method == "zexplicit":
                        dc, dpt = _solve_explicit_direct(blocks, lam, p.cam_fixed, E, by_pt,
                                                         pairs)
                    else:
                        with span("ba.pcg"):
                            dc, dpt, n_cg = _solve_pcg_direct(blocks, lam, p.cam_fixed, E,
                                                              cg_iters, cg_tol, q_eta, by_pt)
                        total_cg += n_cg
                else:
                    with span("ba.assemble"):
                        res = linearize(p, huber_delta)
                        active = (p.obs_w > 0) & res.valid
                        blocks = assemble_blocks(res.r, res.Jc, res.Jp, p.obs_cam, p.obs_pt,
                                                 active, K, P, cam_onehot=E)
                    with span("ba.schur_solve"):
                        dc, dpt, _, n_cg = _solve_schur(blocks, lam, p.cam_fixed,
                                                        method=method, d_max=d_max,
                                                        jacobi=True, cg_iters=cg_iters,
                                                        cg_tol=cg_tol, q_eta=q_eta,
                                                        point_sorted=False, cam_onehot=E)
                    total_cg += n_cg
                with span("ba.accept"):
                    p, lam, best, ok = _accept_step(p, dc, dpt, lam, best, huber_delta)
                n_acc = n_acc + ok.to(torch.int32)
        return SnavelyResult(problem=p, initial_cost=cost0, final_cost=best, n_accepted=n_acc,
                             lambda_final=lam, cg_iters=total_cg)
