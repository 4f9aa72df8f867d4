"""Legacy frame-to-frame visual odometry (port of
dr3_tpu.pipelines.slam_legacy; the reference's first SLAM stack,
``dr3::SLAM``, include/slam.hpp:26-68, src/slam.cpp:6-218).

The older of the reference's two SLAM stacks, descriptor matching frame to
frame. Per frame:

reference (src/slam.cpp:86-216)        | here
---------------------------------------|--------------------------------
ORB detect + BFMatcher(Hamming) vs     | FAST grid corners (kernel K3) +
  previous frame (103-113)             |   ZNCC patch descriptors (K4's
                                       |   remap_xy), [N, M] product match
                                       |   with cross-check + ratio,
                                       |   level-0 LK polish (K1)
TwoView::estimate_F RANSAC x30 (117)   | batched 8-point RANSAC, the same
                                       |   30 hypotheses, 5 px gate
extract_camera_pose: E=K^T F K, 4      | decompose_essential
  (R,t) hypotheses (123)               |
4 x inliers x DLT triangulation +      | one batched check_rt over the 4
  cheirality (127-152)                 |   hypotheses (disambiguate_pose)
pose chain T_cur = Rt * T_prev (159)   | same (SE3, host)
world-point insertion w/ duplicate     | same: match-index chaining reuses
  suppression via prev-frame obs reuse |   the previous frame's point ids
  (161-197)                            |   (host)
per-stage timing report (49-84)        | Monitor + report() parity

A frame is two functions of tensors on the instance's device,
``_detect_describe`` and ``_geometry``, and one host read of their packed
results; the host only chains poses and appends to the (numpy, unbounded
like the reference's std::list Map) point store. Monocular scale is
unobservable frame-to-frame, so each step's t has unit norm — exactly the
reference's behavior.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dr3_tpu_torch.geometry.epipolar import (decompose_essential, disambiguate_pose,
                                             essential_from_fundamental)
from dr3_tpu_torch.geometry.lie import SE3, SO3
from dr3_tpu_torch.geometry.ransac import ransac_fundamental
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.ops import corners, lk, match, pyramid
from dr3_tpu_torch.utils.config import Config
from dr3_tpu_torch.utils.device import resolve as resolve_device
from dr3_tpu_torch.utils.timing import Monitor


@dataclasses.dataclass
class LegacyFrameResult:
    R: np.ndarray            # [3,3] cur-from-prev rotation
    t: np.ndarray            # [3] unit translation
    n_matches: int
    n_inliers: int
    n_good: int              # cheirality-positive triangulations


def _detect_describe(img: torch.Tensor, cfg: Config):
    """Pyramid, grid corners (K3 over the detection levels) and ZNCC patch
    descriptors of one frame: (pyr, xy [N, 2], valid [N], desc [N, D])."""
    pyr = pyramid.build_pyramid(img, cfg.n_pyr_levels)
    f = corners.detect_features(pyr, cfg.cell_size, cfg.min_corner_score,
                                cfg.fast_threshold)
    d = match.patch_descriptors(img, f.xy, f.valid)
    return pyr, f.xy, f.valid, d


def _geometry(generator, K: torch.Tensor, cfg: Config, pyr_prev, d_prev, xy_prev,
              v_prev, pyr_cur, d_cur, xy_cur, v_cur) -> torch.Tensor:
    """Match -> LK polish -> F RANSAC -> E -> the cheirality winner, packed
    into one float32 vector for the frame's one host read (:func:`_unpack`).
    Every float32 product here is exact float32 (the port never enables
    TF32): a TF32 match product would flip cross-check ties."""
    m = match.match_descriptors(d_prev, d_cur, v_prev, v_cur)
    p1 = xy_prev
    # idx2 names a row for every descriptor, failed ones too; the rows that
    # failed carry weight 0 below (m.ok), as in the JAX package
    p2 = xy_cur[m.idx2]
    # subpixel refinement of matched positions: integer-pixel corner pairs
    # are too coarse for F estimation under forward motion, so a short LK
    # polish (initialised at the match, level 0 only) recovers the
    # subpixel correspondence before RANSAC
    pos, ok, _ = lk.track_level(pyr_prev[0], pyr_cur[0], p1, p2, half_window=5,
                                iters=8, eps=1e-3)
    p2 = torch.where((ok & (torch.linalg.norm(pos - p2, dim=-1) < 2.0))[:, None], pos, p2)
    w = m.ok.to(torch.float32)
    # reference estimate_F: Config::ransac_iters hypotheses, 5 px inlier
    # gate; the chi-square score gates dist^2 < 3.841 sigma^2, so a raw px
    # threshold tau maps to sigma = tau / sqrt(3.841) = tau / 1.96
    res = ransac_fundamental(generator, p1, p2, w, n_samples=max(cfg.ransac_iters, 30),
                             sigma=cfg.ransac_threshold / 1.96)
    inl = res.inliers & m.ok
    E = essential_from_fundamental(res.model, K)
    hyp = decompose_essential(E)
    best, results, clear = disambiguate_pose(hyp, p1, p2, inl.to(torch.float32), K)
    X = results.points[best]              # [N, 3] in the previous camera's frame
    good = results.good[best] & inl
    f = torch.float32
    return torch.cat([m.idx2.to(f), m.ok.to(f), inl.to(f), good.to(f), X.reshape(-1),
                      hyp.R[best].reshape(-1), hyp.t[best],
                      results.n_good[best].to(f).reshape(1), clear.to(f).reshape(1)])


def _unpack(packed: np.ndarray, n: int):
    """(idx2, ok, inliers, good, X, R, t, n_good, clear) of :func:`_geometry`'s
    vector, read to the host."""
    idx2 = packed[:n].astype(np.int64)
    ok, inl, good = (packed[k * n:(k + 1) * n] > 0.5 for k in (1, 2, 3))
    o = 4 * n
    X = packed[o:o + 3 * n].reshape(n, 3)
    R = packed[o + 3 * n:o + 3 * n + 9].reshape(3, 3)
    t = packed[o + 3 * n + 9:o + 3 * n + 12]
    n_good, clear = packed[o + 3 * n + 12:]
    return idx2, ok, inl, good, X, R, t, int(n_good), bool(clear > 0.5)


class LegacySLAM:
    """dr3::SLAM equivalent: frame-to-frame VO over descriptor matches.

    ``device``: where the frame's tensors live (default: the card;
    ``device="cpu"`` runs the kernels' plain versions). ``seed`` seeds the
    ``torch.Generator`` that draws the F RANSAC's minimal sets, one fresh
    set of draws for each frame after the first."""

    def __init__(self, cam: Pinhole, cfg: Optional[Config] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device, "LegacySLAM")
        self.cam = cam.to(self.device)
        self.cfg = cfg or Config()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.monitor = Monitor()
        for name in ("frame", "match", "fmatrix", "triangulation", "global"):
            self.monitor.add_timer(name)

        self.T_f_w = SE3.identity()        # current cam-from-world (host)
        self.trajectory: List[np.ndarray] = [self.T_f_w.matrix().numpy()]
        self.points_w: List[np.ndarray] = []      # world landmarks
        self.point_obs: List[int] = []            # observation count per point
        self._prev = None                          # (pyr, desc, xy, valid, point_id)
        self.n_frames = 0

    def process(self, img: np.ndarray) -> Optional[LegacyFrameResult]:
        """SLAM::process parity (src/slam.cpp:86-216). Returns None for the
        first frame (nothing to match against)."""
        self.monitor.tic("global")
        self.monitor.tic("frame")
        img_t = torch.as_tensor(np.asarray(img), dtype=torch.float32).to(self.device)
        pyr, xy, valid, desc = _detect_describe(img_t, self.cfg)
        self.monitor.toc("frame", block=desc)
        self.n_frames += 1

        if self._prev is None:
            n = int(xy.shape[0])
            self._prev = (pyr, desc, xy, valid, np.full(n, -1, np.int64))
            self.monitor.toc("global")
            return None

        pyr_p, d_p, xy_p, v_p, pid_p = self._prev
        self.monitor.tic("match")
        packed = _geometry(self.generator, self.cam.K, self.cfg, pyr_p, d_p, xy_p, v_p,
                           pyr, desc, xy, valid)
        idx2, mok, inl, good, X, R, t, n_good, _clear = _unpack(
            packed.cpu().numpy(), int(xy_p.shape[0]))        # the frame's one read
        self.monitor.toc("match")
        # matching/F/triangulation run as one device function; report the
        # stage split the reference prints by attributing it to "match" and
        # keeping fmatrix/triangulation as aliases
        self.monitor.tic("fmatrix")
        self.monitor.toc("fmatrix")
        self.monitor.tic("triangulation")
        self.monitor.toc("triangulation")

        # pose chain: T_cur_w = [R|t] * T_prev_w (src/slam.cpp:159)
        T_rel = SE3(SO3.from_matrix(torch.as_tensor(R)).wxyz, torch.as_tensor(t))
        T_prev = self.T_f_w
        self.T_f_w = T_rel @ T_prev
        self.trajectory.append(self.T_f_w.matrix().numpy())

        # world-point insertion with duplicate suppression via prev-frame
        # observation reuse (src/slam.cpp:161-197): a match whose previous
        # feature already observes a landmark extends it instead of
        # duplicating
        T_w_prev = T_prev.inverse()
        pid_cur = np.full(int(xy.shape[0]), -1, np.int64)
        good_idx = np.flatnonzero(good & inl)
        if good_idx.size:
            Xw = T_w_prev.apply(torch.as_tensor(X[good_idx])).numpy()
            for k, i_prev in enumerate(good_idx):
                j_cur = int(idx2[i_prev])
                existing = pid_p[i_prev]
                if existing >= 0:
                    self.point_obs[existing] += 1
                    pid_cur[j_cur] = existing
                else:
                    self.points_w.append(Xw[k])
                    self.point_obs.append(2)
                    pid_cur[j_cur] = len(self.points_w) - 1

        self._prev = (pyr, desc, xy, valid, pid_cur)
        self.monitor.toc("global")
        return LegacyFrameResult(R=R, t=t, n_matches=int(mok.sum()),
                                 n_inliers=int(inl.sum()), n_good=n_good)

    # ----- reporting (SLAM::pprint parity, src/slam.cpp:49-84) -----------
    def report(self) -> str:
        m = self.monitor
        fps = self.n_frames / max(m["global"].total, 1e-9)
        n_pts = len(self.points_w)
        n_obs = sum(self.point_obs)
        lines = [
            "-" * 58,
            f"frames processed      : {self.n_frames}",
            f"FPS                   : {fps:.2f}",
            f"map points            : {n_pts}",
            f"observations          : {n_obs}",
            f"parameters (6K + 3P)  : {6 * self.n_frames + 3 * n_pts}",
        ]
        for name in ("frame", "match", "fmatrix", "triangulation"):
            lines.append(f"avg {name:<18}: {m[name].average * 1e3:8.3f} ms")
        lines.append("-" * 58)
        return "\n".join(lines)

    def trajectory_matrix(self) -> np.ndarray:
        return np.stack(self.trajectory)

    def map_points(self) -> np.ndarray:
        if not self.points_w:
            return np.zeros((0, 3), np.float32)
        return np.stack(self.points_w)
