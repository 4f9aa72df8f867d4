"""BAL ("Bundle Adjustment in the Large") problem file I/O (port of
dr3_tpu.io.bal; the reference's offline adjuster reads the format,
tests/ceres/ba.cc:21-167).

Format:
    n_cams n_points n_obs
    <n_obs lines>  cam_idx pt_idx u v
    <n_cams * 9 values>  angle-axis R (3), t (3), f, k1, k2
    <n_points * 3 values> xyz

The raw arrays stay numpy (:class:`BALData`), and :func:`save_bal` writes
files byte-identical to the JAX package's, so a file written by either
package loads in the other. BAL cameras look down -z and project
p = -f * (x/z, y/z) (Snavely model). :func:`bal_to_problem` conjugates each
camera by S = diag(1, -1, -1) (R' = S R, t' = S t), which turns the frame
into the +z pinhole convention of :func:`dr3_tpu_torch.ba.problem.project`
and the measurement into (u, -v); the shared intrinsics are (median f,
median f, 0, 0) and k1/k2 are dropped. The exact 9-parameter objective is
:func:`dr3_tpu_torch.ba.snavely.bal_to_snavely`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BALData(NamedTuple):
    """Raw BAL arrays, exactly as stored in the file."""
    cam_params: np.ndarray  # [K, 9] angle-axis(3), t(3), f, k1, k2
    points: np.ndarray      # [P, 3]
    obs_cam: np.ndarray     # [O] int32
    obs_pt: np.ndarray      # [O] int32
    obs_uv: np.ndarray      # [O, 2]


def load_bal(path: str) -> BALData:
    # one vectorised parse: real BAL files have 1e5-1e6 observations
    with open(path) as f:
        tokens = f.read().split()
    n_cams, n_pts, n_obs = int(tokens[0]), int(tokens[1]), int(tokens[2])
    obs_block = np.asarray(tokens[3:3 + 4 * n_obs], np.float64).reshape(n_obs, 4)
    obs_cam = obs_block[:, 0].astype(np.int32)
    obs_pt = obs_block[:, 1].astype(np.int32)
    obs_uv = np.ascontiguousarray(obs_block[:, 2:4])
    rest = np.asarray(tokens[3 + 4 * n_obs:3 + 4 * n_obs + 9 * n_cams + 3 * n_pts],
                      np.float64)
    cam_params = rest[:9 * n_cams].reshape(n_cams, 9)
    points = rest[9 * n_cams:].reshape(n_pts, 3)
    return BALData(cam_params, points, obs_cam, obs_pt, obs_uv)


def save_bal(path: str, d: BALData) -> None:
    """Write ``d`` as the JAX package does: the observations one per line,
    then every camera and point value on its own line, floats as %.17g."""
    with open(path, "w") as f:
        f.write(f"{d.cam_params.shape[0]} {d.points.shape[0]} {d.obs_cam.shape[0]}\n")
        for c, p, (u, v) in zip(d.obs_cam, d.obs_pt, d.obs_uv):
            f.write(f"{int(c)} {int(p)} {u:.17g} {v:.17g}\n")
        for row in d.cam_params:
            f.write("\n".join(f"{x:.17g}" for x in row) + "\n")
        for row in d.points:
            f.write("\n".join(f"{x:.17g}" for x in row) + "\n")


def bal_to_problem(d: BALData, huber_ready: bool = True, device=None):
    """Raw BAL arrays -> a :class:`~dr3_tpu_torch.ba.problem.BAProblem` on
    ``device`` (the card unless asked otherwise): cameras conjugated by S
    = diag(1, -1, -1), observations as (u, -v), shared intrinsics (median
    f, median f, 0, 0)."""
    from dr3_tpu_torch.ba.problem import make_problem
    from dr3_tpu_torch.geometry.lie import SE3, SO3
    from dr3_tpu_torch.utils.device import resolve

    dev = resolve(device, "bal_to_problem")
    S = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    R = SO3.exp(torch.as_tensor(d.cam_params[:, 0:3], dtype=torch.float32)).matrix().numpy()
    Rp = np.einsum("ij,kjl->kil", S, R)
    t = d.cam_params[:, 3:6].astype(np.float32) @ S.T
    f_med = float(np.median(d.cam_params[:, 6]))
    cams = SE3(SO3.from_matrix(torch.as_tensor(Rp)).wxyz.to(dev),
               torch.as_tensor(t, device=dev))
    intr = torch.tensor([f_med, f_med, 0.0, 0.0], dtype=torch.float32, device=dev)
    uv = d.obs_uv * np.asarray([1.0, -1.0])
    return make_problem(
        cams, torch.as_tensor(d.points, dtype=torch.float32, device=dev), intr,
        torch.as_tensor(d.obs_cam, device=dev), torch.as_tensor(d.obs_pt, device=dev),
        torch.as_tensor(uv, dtype=torch.float32, device=dev))


def problem_to_bal(p, f: float | None = None) -> BALData:
    """Inverse of :func:`bal_to_problem` (for exporting SLAM maps):
    conjugate back by S = diag(1, -1, -1) and restore (u, -v)."""
    from dr3_tpu_torch.geometry.lie import SO3

    S = np.diag([1.0, -1.0, -1.0])
    Rp = SO3(p.cam_wxyz.detach().cpu().float()).matrix().numpy().astype(np.float64)
    R_bal = np.einsum("ij,kjl->kil", S, Rp)
    t_bal = p.cam_t.detach().cpu().numpy().astype(np.float64) @ S.T
    aa = SO3.from_matrix(torch.as_tensor(R_bal, dtype=torch.float32)).log().numpy() \
        .astype(np.float64)
    f_out = float(p.intrinsics[0]) if f is None else f
    K = Rp.shape[0]
    cam_params = np.concatenate([aa, t_bal, np.tile([[f_out, 0.0, 0.0]], (K, 1))], axis=1)
    return BALData(
        cam_params=cam_params,
        points=p.points.detach().cpu().numpy().astype(np.float64),
        obs_cam=p.obs_cam.cpu().numpy().astype(np.int32),
        obs_pt=p.obs_pt.cpu().numpy().astype(np.int32),
        obs_uv=p.obs_uv.detach().cpu().numpy().astype(np.float64) * np.asarray([1.0, -1.0]),
    )
