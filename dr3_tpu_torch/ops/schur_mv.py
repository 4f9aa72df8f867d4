"""The matrix-free reduced camera operator of the generic Schur PCG
(``ba/schur_core.py`` :meth:`PCG.s_mv`) as two kernels over the keyed
tables:

    y = keep (Hcc_d xk - W Hpp^-1 W^T xk) + (1 - keep) x,   xk = keep x,

with W never formed (one [C, 3] coupling block AtB_o per observation) and
the point and camera sums over the [P, d_pt] and [K, d_cam] tables of row
ids that ``schur_core._table_reducer`` keeps (each row in index order,
padded with O).

* the point pass, one launch of ``schur_mv_point_kernel``
  (csrc/schur_mv.cu): u_p = sum_o AtB_o^T xk[cam_o] over point p's row in
  order, v_p = Hpp^-1_p u_p;
* the camera pass, one launch of ``schur_mv_camera_kernel``: y_k = Hcc_d_k
  xk_k - sum_o AtB_o v[pt_o] over camera k's row, lane t of the camera's
  ``CAM_THREADS`` summing the slots t, t + CAM_THREADS, ... in order and the
  lanes' partials added by a halving tree; then the keep / fixed blend.

:func:`schur_mv` runs its plain PyTorch version :func:`_schur_mv_plain` (the
kernels' arithmetic and order: no fused multiply-add, every sum in the
order above) for a CPU tensor; for a CUDA tensor it launches both kernels
or raises. ``schur_mv.launches`` counts kernel launches, two a call.

Replaces no Pallas kernel: the JAX package leaves the operator to XLA. The
kernels' bound and design are in csrc/schur_mv.cu.
"""

from __future__ import annotations

import torch

from dr3_tpu_torch.ops import _native

# csrc/schur_mv.cu kCamThreads: the camera pass's lanes
CAM_THREADS = 128
_SIZES = (6, 9)          # the camera block sizes the kernels are built for


def _halve(s):
    """The kernels' tree over the last-but-one axis: [..., 2^n, C] -> [..., C],
    each level adding the upper half onto the lower."""
    while s.shape[-2] > 1:
        h = s.shape[-2] // 2
        s = s[..., :h, :] + s[..., h:, :]
    return s[..., 0, :]


def _schur_mv_plain(AtB, obs_cam, obs_pt, pt_table, cam_table, Hpp_inv, Hcc_d, keep, x):
    O, C, _ = AtB.shape
    P, K = pt_table.shape[0], cam_table.shape[0]
    A = torch.cat([AtB, AtB.new_zeros((1, C, 3))])            # the pad O reads zeros
    cam = torch.cat([obs_cam.long(), obs_cam.new_zeros(1).long()])
    pt = torch.cat([obs_pt.long(), obs_pt.new_zeros(1).long()])
    kp = keep[:, None]
    xk = x * kp
    # the point pass
    u = AtB.new_zeros((P, 3))
    for d in range(pt_table.shape[1]):
        o = pt_table[:, d]
        ok = (o >= 0) & (o < O)
        o = torch.where(ok, o, torch.full_like(o, O))
        a, xo = A[o], xk[cam[o]]                               # [P, C, 3], [P, C]
        t = a[:, 0] * xo[:, 0:1]
        for c in range(1, C):
            t = t + a[:, c] * xo[:, c:c + 1]
        u = torch.where(ok[:, None], u + t, u)
    v = (Hpp_inv[:, :, 0] * u[:, 0:1] + Hpp_inv[:, :, 1] * u[:, 1:2]) \
        + Hpp_inv[:, :, 2] * u[:, 2:3]
    vp = torch.cat([v, v.new_zeros((1, 3))])
    # the camera pass: lane t's slots t, t + CAM_THREADS, ... in order
    d_cam = cam_table.shape[1]
    n = -(-d_cam // CAM_THREADS)
    tbl = torch.cat([cam_table, cam_table.new_full((K, n * CAM_THREADS - d_cam), O)], 1)
    tbl = tbl.view(K, n, CAM_THREADS)
    s = AtB.new_zeros((K, CAM_THREADS, C))
    for i in range(n):
        o = tbl[:, i]
        ok = (o >= 0) & (o < O)
        o = torch.where(ok, o, torch.full_like(o, O))
        a, vo = A[o], vp[pt[o]]                                # [K, T, C, 3], [K, T, 3]
        w = (a[..., 0] * vo[..., 0:1] + a[..., 1] * vo[..., 1:2]) + a[..., 2] * vo[..., 2:3]
        s = torch.where(ok[..., None], s + w, s)
    hx = Hcc_d[:, :, 0] * xk[:, 0:1]
    for e in range(1, C):
        hx = hx + Hcc_d[:, :, e] * xk[:, e:e + 1]
    return (hx - _halve(s)) * kp + x * (1.0 - kp)


def schur_mv(AtB: torch.Tensor, obs_cam: torch.Tensor, obs_pt: torch.Tensor,
             pt_table: torch.Tensor, cam_table: torch.Tensor, Hpp_inv: torch.Tensor,
             Hcc_d: torch.Tensor, keep: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y [K, C] = S x of the damped reduced system with the gauge fix:
    AtB [O, C, 3] the coupling blocks, obs_cam / obs_pt [O] int64 ids,
    pt_table [P, d_pt] / cam_table [K, d_cam] int64 row ids (pad O),
    Hpp_inv [P, 3, 3], Hcc_d [K, C, C], keep [K] (1 free, 0 fixed), x [K, C]."""
    if not AtB.is_cuda:
        return _schur_mv_plain(AtB, obs_cam, obs_pt, pt_table, cam_table, Hpp_inv, Hcc_d,
                               keep, x)
    dev = AtB.device
    O, C, _ = AtB.shape
    P, d_pt = pt_table.shape
    K, d_cam = cam_table.shape
    if C not in _SIZES:
        raise ValueError(f"camera blocks of size {C}: the kernels are built for {_SIZES}")
    f32, i64 = torch.float32, torch.int64
    for name, t, shape in (("AtB", AtB, (O, C, 3)), ("Hpp_inv", Hpp_inv, (P, 3, 3)),
                           ("Hcc_d", Hcc_d, (K, C, C)), ("keep", keep, (K,)),
                           ("x", x, (K, C))):
        _native.check(t, name, f32, shape, dev)
    for name, t, shape in (("obs_cam", obs_cam, (O,)), ("obs_pt", obs_pt, (O,)),
                           ("pt_table", pt_table, (P, d_pt)),
                           ("cam_table", cam_table, (K, d_cam))):
        _native.check(t, name, i64, shape, dev)
    v = torch.empty((P, 3), dtype=f32, device=dev)
    y = torch.empty((K, C), dtype=f32, device=dev)
    _native.call("dr3_schur_mv", AtB, obs_cam, obs_pt, pt_table, d_pt, cam_table, d_cam,
                 Hpp_inv, Hcc_d, keep, x, O, P, K, C, v, y)
    schur_mv.launches += 2
    return y


schur_mv.launches = 0
