"""Plain reference for the VO cells: the renderer's true poses and scene,
against which a monocular trajectory and its map are judged, in numpy.

A monocular trajectory is known up to a similarity, so it is aligned to the
truth first (:func:`align`). Nothing here comes from the program under
test.
"""

from __future__ import annotations

import numpy as np


def centres(mats) -> np.ndarray:
    """Camera centres [N, 3] of world->camera 4x4 matrices."""
    m = np.asarray(mats, np.float64)
    return -np.einsum("nji,nj->ni", m[:, :3, :3], m[:, :3, 3])


def align(mats, true_R: np.ndarray, true_c: np.ndarray):
    """(s, R, t) carrying the estimate's world into the truth's,
    x_true = s R x_est + t. The rotation is the chordal mean of the
    orientations' differences, R_true_i^T R_est_i, projected onto SO(3);
    the scale and offset then fit the centres by least squares. (Centres
    alone, as Umeyama's alignment takes them, leave the rotation about a
    nearly straight path undetermined.)"""
    est_R = np.asarray(mats, np.float64)[:, :3, :3]
    M = np.einsum("nji,njk->ik", np.asarray(true_R, np.float64), est_R)
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    p = centres(mats) @ R.T
    c = np.asarray(true_c, np.float64)
    dp, dc = p - p.mean(0), c - c.mean(0)
    s = float((dp * dc).sum() / max((dp * dp).sum(), 1e-300))
    return s, R, c.mean(0) - s * p.mean(0)


def ate_pct(mats, true_R, true_c) -> tuple:
    """(RMSE of the aligned centres as a percentage of the true path's
    extent, the diagonal of the box its centres span; the
    alignment). The extent, and not the length, since a path that goes
    over the same ground again grows in length while its error need not."""
    a = align(mats, true_R, true_c)
    s, R, t = a
    est = s * centres(mats) @ R.T + t
    c = np.asarray(true_c, np.float64)
    rmse = float(np.sqrt(((est - c) ** 2).sum(-1).mean()))
    lo, hi = c.min(0), c.max(0)
    return 100.0 * rmse / float(np.linalg.norm(hi - lo)), a


def rpe_pct(mats, true_c, align, gap: int) -> float:
    """Relative pose error: the RMS over the window of the error of the
    aligned motion over ``gap`` frames, as a percentage of the RMS true
    motion over as many frames. It reads the local accuracy of the
    estimate, which a drift across the window leaves alone."""
    if len(mats) <= gap:
        return float("nan")
    s, R, _ = align
    est = s * centres(mats) @ R.T
    c = np.asarray(true_c, np.float64)
    d_est, d_true = est[gap:] - est[:-gap], c[gap:] - c[:-gap]
    err = np.sqrt(((d_est - d_true) ** 2).sum(-1).mean())
    return 100.0 * float(err / np.sqrt((d_true ** 2).sum(-1).mean()))


def rotation_errors_deg(mats, true_R: np.ndarray, R_align: np.ndarray) -> np.ndarray:
    """Angle (degrees) between each estimated world->camera rotation,
    expressed in the truth's world (R_est R_align^T), and the true one."""
    est = np.asarray(mats, np.float64)[:, :3, :3]
    rel = np.einsum("nij,kj,nlk->nil", est, R_align, np.asarray(true_R, np.float64))
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def scene_distance(points: np.ndarray, scene: dict) -> np.ndarray:
    """Distance of each world point [N, 3] to the rendered scene: a near
    rectangle at z_near inside an unbounded far plane at z_far."""
    p = np.asarray(points, np.float64)
    dx = np.maximum(np.abs(p[:, 0]) - scene["near_halfw"], 0.0)
    dy = np.maximum(np.abs(p[:, 1]) - scene["near_halfh"], 0.0)
    d_near = np.sqrt((p[:, 2] - scene["z_near"]) ** 2 + dx ** 2 + dy ** 2)
    return np.minimum(d_near, np.abs(p[:, 2] - scene["z_far"]))


def map_error(points: np.ndarray, align, scene: dict) -> np.ndarray:
    """Each map point's distance to the true scene after the trajectory's
    alignment, over its true depth (z)."""
    s, R, t = align
    p = s * np.asarray(points, np.float64) @ R.T + t
    return scene_distance(p, scene) / np.maximum(np.abs(p[:, 2]), 1.0)
