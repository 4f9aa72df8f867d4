"""Monocular visual odometry / SLAM (port of dr3_tpu.pipelines.vo, the
per-frame ``MonoVO.process``, loop closure included).

State machine FIRST -> SECOND -> GENERAL (-> RELOCALIZE) like the
reference's HandlerMono (include/svo/handler.h:18-22):

* FIRST: FAST + Shi-Tomasi grid detection (kernel K3) seeds the track table;
* SECOND: pyramidal LK (K1) until the median disparity clears the gate,
  then the two-view init bootstraps the map;
* GENERAL (:func:`_general_step`): pyramid -> sparse image alignment (K2)
  -> pyramidal LK + template alignment (K1) -> motion-only pose GN ->
  reprojection gate -> keyframe statistics; a keyframe adds
  triangulation, detection + spawning (K3, K2), template refresh (K2), a
  snapshot, the loop-database insert and query (pipelines/loop_closure.py:
  oriented descriptors and rotated query images through K4's
  ``remap_xy``), verification and pose-graph correction on a hit, and
  sliding-window Schur BA (``Config.ba_solver``, pcg by default).

The loop database lives in the local frame: bootstrap inserts its two
keyframes, relocalization empties it. ``global_refine`` runs the offline
global BA over the database and the map.

A general frame of :meth:`MonoVO.process` is one device program, as
``Config.fused_frontend`` makes it in the JAX package: on the card one
replay of a CUDA graph captured from :func:`_general_step`
(utils/cudagraph.py), elsewhere one eager call of the same function; either
way one host read per frame, a packed [3 + 32] vector of the frame's
statistics and trajectory matrices. A keyframe adds one read (its counters
and the loop query's result together) and one per CG iteration of window
BA. ``fused_frontend=False`` runs the step eagerly with a ``Monitor`` toc
per sub-stage, each synchronising the device.

:meth:`MonoVO.process_batch` is the device-resident frame loop, the JAX
package's ``_scan_frames`` (vo.py:427-594): :class:`_Scan` holds its body —
the general step, the keyframe decision, lost / relocalise, the capacity
guards, the whole keyframe path and window BA, the loop candidate's
``fire`` — as steps over device tensors, with the counters as 0-d int32
tensors; the per-frame driver calls the same functions. On the card one
:class:`_ScanProgram` per image shape and ``frames_per_dispatch`` runs a
batch as ONE CUDA graph: the steps are captured pieces and the branches
and the CG loop are conditional nodes (csrc/graph_loop.cu), so a batch
costs one launch and one host read (its row block) however many keyframes
and CG iterations it holds; window BA runs inside with every ``ba_solver``
(pcg's CG loop a WHILE node, the dense solves' Cholesky inside their LM
step's piece). On the CPU the same steps run with Python branches on the
flags. The host touches a frame only on an early-out: relocalisation, a
map or database capacity event, a loop candidate, or — with ``mesh=``
(parallel/mesh.py) only, as in the JAX package — the deferred window BA
(``_REASON_*``). With ``mesh=`` the window BA and ``global_refine`` run the
point-sharded distributed BA (parallel/dist_ba.py).
"""

from __future__ import annotations

import enum
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from dr3_tpu_torch.ba.problem import make_problem
from dr3_tpu_torch.ba.schur_lm import LMSteps, _pick_solver, bundle_adjust, pose_only_adjust
from dr3_tpu_torch.geometry.lie import SE3
from dr3_tpu_torch.geometry.linalg import smallest_eigvec_gram
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.ops import corners, lk, pyramid
from dr3_tpu_torch.ops.sparse_align import sparse_align
from dr3_tpu_torch.parallel.dist_ba import dist_bundle_adjust
from dr3_tpu_torch.pipelines import loop_closure as lc
from dr3_tpu_torch.pipelines.twoview_init import initialize_two_view
from dr3_tpu_torch.state import (KeyframeState, MapState, TrackState,
                                 compact_map, remap_point_ids)
from dr3_tpu_torch.utils.config import Config
from dr3_tpu_torch.ops.warp import remap_xy
from dr3_tpu_torch.utils.cudagraph import (GraphProgram, Slots, StepGraph, _clone, _copy_into,
                                           capture_piece)
from dr3_tpu_torch.utils.device import resolve as resolve_device
from dr3_tpu_torch.utils.stats import nanmedian
from dr3_tpu_torch.utils.timing import Monitor

# the kernel wrappers a general step may reach: their launch counts go up on
# every replay of the captured step
_STEP_COUNTERS = (lk.track_pyramid, lk.track_level, lk.align_to_templates,
                  lk.sample_patches, sparse_align)


class Stage(enum.Enum):
    FIRST = 0     # handler.h:18-22 state machine
    SECOND = 1
    GENERAL = 2
    RELOCALIZE = 3


# ---------------------------------------------------------------------------
# frame-step functions
# ---------------------------------------------------------------------------

def _detect(pyr, cfg: Config, occupancy=None):
    return corners.detect_features(pyr[: cfg.n_pyr_levels], cfg.cell_size,
                                   cfg.min_corner_score, cfg.fast_threshold,
                                   occupancy=occupancy)


class _Untimed:
    """Stands in for a Monitor where the step must not synchronise."""

    def tic(self, name: str) -> None:
        pass

    def toc(self, name: str, block=None) -> float:
        return 0.0


def _traj_mats_pair(Tc: SE3, Ta: SE3) -> torch.Tensor:
    """[2, 4, 4]: global (T_cur @ T_anchor) and local T_cur matrices."""
    return torch.stack([(Tc @ Ta).matrix(), Tc.matrix()])


def _traj_mats(Tc: SE3, Ta: SE3) -> np.ndarray:
    """Host copy of :func:`_traj_mats_pair`."""
    return _traj_mats_pair(Tc, Ta).cpu().numpy()


def _track(pyr_prev, pyr_cur, tracks: TrackState, cfg: Config):
    res = lk.track_pyramid(pyr_prev, pyr_cur, tracks.px, tracks.valid,
                           half_window=cfg.klt_window // 2,
                           iters=cfg.klt_iters, eps=cfg.klt_eps)
    pos = res.pos
    if cfg.feature_align:
        ref = lk.align_to_templates(pyr_cur[0], tracks.ref_patch, pos,
                                    res.ok & tracks.valid,
                                    iters=cfg.feature_align_iters)
        pos = ref.pos
    return tracks._replace(px=pos, valid=tracks.valid & res.ok,
                           age=tracks.age + 1), res


def _sparse_align_step(pyr_prev, pyr_cur, tracks: TrackState, map_xyz,
                       map_valid, T_prev: SE3, cam: Pinhole, cfg: Config) -> SE3:
    lvl = min(cfg.align_level, len(pyr_prev) - 1)
    has_pt = tracks.valid & (tracks.point >= 0)
    pt_idx = torch.clamp(tracks.point, min=0).long()
    use = has_pt & map_valid[pt_idx]
    res = sparse_align(pyr_prev[lvl], pyr_cur[lvl], T_prev, T_prev, cam,
                       map_xyz[pt_idx], use, level=lvl,
                       half_patch=cfg.align_half_patch, iters=cfg.align_iters)
    # fall back to the constant-pose guess when too few features contribute
    ok = res.n_used >= 20
    return SE3(torch.where(ok, res.T.wxyz, T_prev.wxyz),
               torch.where(ok, res.T.t, T_prev.t))


def _pose_optimize(tracks: TrackState, map_xyz, map_valid, T_guess: SE3,
                   cam: Pinhole, cfg: Config):
    """Motion-only BA on the frame's 3D-2D matches + reprojection outlier
    gate. Returns (new pose, inlier track mask, n_inliers tensor)."""
    dev = map_xyz.device
    has_pt = tracks.valid & (tracks.point >= 0)
    pt_idx = torch.clamp(tracks.point, min=0)
    w = (has_pt & map_valid[pt_idx.long()]).to(torch.float32)
    prob = make_problem(
        cams=SE3(T_guess.wxyz[None], T_guess.t[None]), points=map_xyz,
        intrinsics=cam.intrinsics, obs_cam=torch.zeros_like(tracks.point),
        obs_pt=pt_idx, obs_uv=tracks.px, obs_w=w,
        cam_fixed=torch.zeros((1,), dtype=torch.bool, device=dev), dist=cam.dist)
    res = pose_only_adjust(prob, 10, cfg.ba_huber_delta)
    T_new = SE3(res.problem.cam_wxyz[0], res.problem.cam_t[0])
    xc = T_new.apply(map_xyz[pt_idx.long()])
    err = torch.linalg.norm(cam.world2cam(xc) - tracks.px, dim=-1)
    inlier = (w > 0) & (err < cfg.reproj_threshold) & (xc[..., 2] > 1e-3)
    return T_new, inlier, inlier.sum()


def _general_step(img, pyr_prev, tracks: TrackState, map_xyz, map_valid,
                  T_cur: SE3, cam: Pinhole, cfg: Config, last_kf_slot,
                  anchor: Optional[SE3] = None, mon: Optional[Monitor] = None):
    """One general frame: pyramid, sparse image alignment, pyramidal LK +
    template alignment, motion-only pose GN, reprojection gating and the
    keyframe-disparity statistic (dr3_tpu/pipelines/vo.py:158-207).

    Returns (pyr_cur, tracks', T', stats) with everything still on the
    device; the pose and track gates are applied with ``where``. stats [3]
    = (n_inliers, median disparity, n_tracked); with ``anchor`` the two
    trajectory matrices of T' (global, local) follow as 32 more values
    (vo.py:197-205). ``last_kf_slot`` is an int or a 0-d int32 tensor.
    ``mon`` times the sub-stages, each toc synchronising the device; the
    graphed step takes none, since no sync may happen under capture."""
    mon = mon or _Untimed()
    mon.tic("pyramid")
    pyr_cur = pyramid.build_pyramid(img, max(cfg.n_pyr_levels, cfg.klt_levels))
    mon.toc("pyramid", block=pyr_cur[-1])
    T_guess = T_cur
    if cfg.use_sparse_align:
        mon.tic("sparse_img_align")
        T_guess = _sparse_align_step(pyr_prev, pyr_cur, tracks, map_xyz,
                                     map_valid, T_cur, cam, cfg)
        mon.toc("sparse_img_align", block=T_guess.t)
    mon.tic("klt")
    tracks, _res = _track(pyr_prev, pyr_cur, tracks, cfg)
    mon.toc("klt", block=tracks.px)
    mon.tic("pose_optimizer")
    T_new, inlier, n_inl = _pose_optimize(tracks, map_xyz, map_valid, T_guess,
                                          cam, cfg)
    accept = n_inl >= 10
    gated = tracks.valid & ((tracks.point < 0) | inlier)
    tracks = tracks._replace(valid=torch.where(accept, gated, tracks.valid))
    T_out = SE3(torch.where(accept, T_new.wxyz, T_cur.wxyz),
                torch.where(accept, T_new.t, T_cur.t))
    # keyframe-disparity statistic over the cohort spawned at the last
    # keyframe (vo.py:189-196); an empty cohort gives NaN, ignored by the gate
    disp = torch.linalg.norm(tracks.px - tracks.ref_px, dim=-1)
    in_cohort = tracks.valid & (tracks.ref_kf == last_kf_slot)
    med = nanmedian(torch.where(in_cohort, disp, torch.full_like(disp, float("nan"))))
    stats = torch.stack([n_inl.to(torch.float32), med,
                         tracks.valid.sum().to(torch.float32)])
    if anchor is not None:
        stats = torch.cat([stats, _traj_mats_pair(T_out, anchor).reshape(32)])
    mon.toc("pose_optimizer", block=stats)
    return pyr_cur, tracks, T_out, stats


def _flat_step(cam: Pinhole, cfg: Config, n_levels: int):
    """:func:`_general_step` over a flat tuple of tensors, as
    :class:`StepGraph` captures it: (img, *pyr_prev, *tracks, map_xyz,
    map_valid, T_cur.wxyz, T_cur.t, last_kf_slot, anchor.wxyz, anchor.t) ->
    (*pyr_cur, *tracks', T'.wxyz, T'.t, packed [35]). The camera's tensors
    are read where they lie: the driver never replaces them."""
    n_fields = len(TrackState._fields)

    def step(*x):
        img, pyr_prev = x[0], list(x[1:1 + n_levels])
        k = 1 + n_levels
        tracks = TrackState(*x[k:k + n_fields])
        map_xyz, map_valid, wxyz, t, slot, a_wxyz, a_t = x[k + n_fields:]
        pyr, tr, T, packed = _general_step(img, pyr_prev, tracks, map_xyz, map_valid,
                                           SE3(wxyz, t), cam, cfg, slot, SE3(a_wxyz, a_t))
        return (*pyr, *tr, T.wxyz, T.t, packed)

    return step


def _triangulate_new(tracks: TrackState, kfs: KeyframeState, T_cur: SE3,
                     map_state: MapState, point_cursor, cam: Pinhole,
                     cfg: Config):
    """Triangulate tracks without a map point against their originating
    keyframe (DLT + cheirality + reprojection + parallax gates).

    New points go to consecutive slots from ``point_cursor`` (an int or a
    0-d int32 tensor); only the accepted rows are written: the rejected
    ones go to a scratch row past the end, so the shapes are fixed and
    nothing is read to the host. (The JAX reference scatters every row,
    sending the rejected ones to slot 0 with slot 0's old value —
    harmless there unless the cursor is 0.)"""
    K = cam.K
    finite_px = torch.isfinite(tracks.px).all(-1) & torch.isfinite(tracks.ref_px).all(-1)
    cur_px = torch.where(finite_px[:, None], tracks.px, torch.zeros_like(tracks.px))
    ref_px = torch.where(finite_px[:, None], tracks.ref_px, torch.zeros_like(tracks.ref_px))
    need = tracks.valid & (tracks.point < 0) & (tracks.ref_kf >= 0) & finite_px
    ref_slot = torch.clamp(tracks.ref_kf, 0, kfs.wxyz.shape[0] - 1).long()
    T_ref = SE3(kfs.wxyz[ref_slot], kfs.t[ref_slot])

    def proj_mat(T: SE3):
        return torch.einsum("ij,...jk->...ik", K, T.matrix34())

    P_ref = proj_mat(T_ref)                        # [N, 3, 4]
    P_cur = proj_mat(T_cur).expand_as(P_ref)       # [N, 3, 4]

    def rows(P, p):
        r1 = p[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r2 = p[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return r1, r2

    a1, a2 = rows(P_ref, ref_px)
    a3, a4 = rows(P_cur, cur_px)
    Xh = smallest_eigvec_gram(torch.stack([a1, a2, a3, a4], dim=-2))
    wh = Xh[..., 3:4]
    wh = torch.where(wh.abs() < 1e-12, torch.full_like(wh, 1e-12), wh)
    X = Xh[..., :3] / wh

    xc_ref = T_ref.apply(X)
    xc_cur = T_cur.apply(X)
    front = (xc_ref[..., 2] > 1e-3) & (xc_cur[..., 2] > 1e-3)
    e_ref = torch.linalg.norm(cam.world2cam(xc_ref) - ref_px, dim=-1)
    e_cur = torch.linalg.norm(cam.world2cam(xc_cur) - cur_px, dim=-1)
    reproj_ok = (e_ref < cfg.reproj_threshold) & (e_cur < cfg.reproj_threshold)
    r1 = X - T_ref.center()
    r2 = X - T_cur.center()
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)
    parallax_ok = cosp < float(np.cos(np.deg2rad(np.float32(1.0))))
    good = need & front & reproj_ok & parallax_ok & torch.isfinite(X).all(-1)

    rank = torch.cumsum(good.to(torch.int32), 0) - 1
    slot = point_cursor + rank
    P = map_state.xyz.shape[0]
    good = good & (slot < P)
    dest = torch.where(good, slot, torch.full_like(slot, P)).long()
    new_xyz = torch.cat([map_state.xyz, map_state.xyz[:1]]).index_copy_(0, dest, X)[:P]
    new_valid = torch.cat([map_state.valid, map_state.valid[:1]]).index_fill_(0, dest, True)[:P]
    new_point = torch.where(good, slot, tracks.point).to(torch.int32)
    n_new = good.sum()
    return (tracks._replace(point=new_point), MapState(xyz=new_xyz, valid=new_valid),
            n_new)


def _spawn_tracks(pyr_cur, tracks: TrackState, cfg: Config, kf_slot, img_hw):
    """Detect corners in cells not covered by live tracks and place them into
    free track slots (grid occupancy parity, src/features.cpp:75-95): slot
    and corner ranks pair up through stable argsorts; every table update is
    a gather + where-merge."""
    occ = corners.make_occupancy(tracks.px, tracks.valid, img_hw, cfg.cell_size)
    feats = _detect(pyr_cur, cfg, occupancy=occ)
    n = tracks.px.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=tracks.px.device)
    free = ~tracks.valid
    slot_of_rank = torch.argsort(torch.where(free, iota, n + iota), stable=True)
    rank_of_slot = torch.argsort(slot_of_rank, stable=True)
    new_rank = torch.cumsum(feats.valid.to(torch.int64), 0) - 1
    feat_of_rank = torch.argsort(torch.where(feats.valid, new_rank, n + iota),
                                 stable=True)
    n_placed = torch.minimum(free.sum(), feats.valid.sum())
    src = feat_of_rank[torch.clamp(rank_of_slot, 0, n - 1)]
    fill = free & (rank_of_slot < n_placed)

    patch_half = (tracks.ref_patch.shape[-1] - 1) // 2
    new_patches = lk.extract_patches(pyr_cur[0], feats.xy, patch_half)

    def merge(old, incoming):
        f = fill.reshape(fill.shape + (1,) * (old.dim() - 1))
        return torch.where(f, incoming[src], old)

    tr = tracks._replace(
        px=merge(tracks.px, feats.xy),
        ref_px=merge(tracks.ref_px, feats.xy),
        ref_kf=torch.where(fill, kf_slot, tracks.ref_kf),
        point=torch.where(fill, torch.full_like(tracks.point, -1), tracks.point),
        age=torch.where(fill, torch.zeros_like(tracks.age), tracks.age),
        valid=tracks.valid | fill,
        ref_patch=merge(tracks.ref_patch, new_patches),
    )
    return tr, n_placed


def _keyframe_step(pyr, tracks: TrackState, kfs: KeyframeState, T_cur: SE3,
                   map_state: MapState, point_cursor, cam: Pinhole,
                   cfg: Config, kf_slot, img_hw):
    """Keyframe work: triangulate new landmarks, detect + spawn fresh tracks,
    re-anchor triangulated tracks at this keyframe, refresh templates.
    ``point_cursor`` and ``kf_slot`` are 0-d int32 tensors on the device
    (or ints). Returns (tracks, map, stats [4] int64 = (new point cursor,
    n_triangulated, n_spawned, n_tracks_with_point)) on the device."""
    tracks, map_state, n_new = _triangulate_new(tracks, kfs, T_cur, map_state,
                                                point_cursor, cam, cfg)
    tracks, n_spawned = _spawn_tracks(pyr, tracks, cfg, kf_slot, img_hw)
    has_pt = tracks.valid & (tracks.point >= 0)
    tracks = tracks._replace(
        ref_px=torch.where(has_pt[:, None], tracks.px, tracks.ref_px),
        ref_kf=torch.where(has_pt, kf_slot, tracks.ref_kf))
    if cfg.feature_align:
        half = (tracks.ref_patch.shape[-1] - 1) // 2
        fresh = lk.extract_patches(pyr[0], tracks.px, half)
        tracks = tracks._replace(ref_patch=torch.where(
            tracks.valid[:, None, None], fresh, tracks.ref_patch))
    n_with_pt = (tracks.valid & (tracks.point >= 0)).sum()
    stats = torch.stack([point_cursor + n_new, n_new, n_spawned, n_with_pt]).long()
    return tracks, map_state, stats


def _evict_pair(kfs: KeyframeState, tracks: TrackState):
    """Roll the keyframe ring left (slot 0 evicted) and re-base the tracks'
    originating-keyframe slots."""
    def roll(a):
        return torch.roll(a, -1, 0)

    # the emptied last slot by fills: a scalar assignment would copy from the
    # host, which a CUDA graph cannot capture
    frame_id = roll(kfs.frame_id)
    frame_id[-1:].fill_(-1)
    valid = roll(kfs.valid)
    valid[-1:].fill_(False)
    obs_point = roll(kfs.obs_point)
    obs_point[-1:].fill_(-1)
    kfs2 = KeyframeState(wxyz=roll(kfs.wxyz), t=roll(kfs.t), frame_id=frame_id,
                         valid=valid, obs_px=roll(kfs.obs_px), obs_point=obs_point)
    return kfs2, tracks._replace(ref_kf=tracks.ref_kf - 1)


def _snapshot_kf_step(kfs: KeyframeState, tracks: TrackState, T_cur: SE3,
                      slot, frame_id) -> KeyframeState:
    """Write pose + track-table snapshot into keyframe slot ``slot`` (an int
    or a 0-d int32 tensor, as ``frame_id``; no host read)."""
    dev = kfs.valid.device
    idx = lc._row_index(slot, dev)
    rows = KeyframeState(
        wxyz=T_cur.wxyz, t=T_cur.t, frame_id=lc._row_index(frame_id, dev)[0].to(torch.int32),
        valid=torch.ones((), dtype=torch.bool, device=dev), obs_px=tracks.px,
        obs_point=torch.where(tracks.valid, tracks.point, torch.full_like(tracks.point, -1)))
    return KeyframeState(*[a.index_copy(0, idx, r[None]) for a, r in zip(kfs, rows)])


def _referenced_points(tracks: TrackState, kfs: KeyframeState, map_valid,
                       db_point=None, db_valid=None):
    """Bool [P]: map point ids referenced by live tracks, window keyframe
    observations, or the loop database."""
    keep = torch.zeros_like(map_valid)

    def mark(ids, cond):
        sel = cond & (ids >= 0)
        keep[ids[sel].long()] = True

    mark(tracks.point, tracks.valid)
    mark(kfs.obs_point, kfs.valid[:, None].expand_as(kfs.obs_point))
    if db_point is not None:
        mark(db_point, db_valid[:, None].expand_as(db_point))
    return keep


def _corrected_window_poses(kf_wxyz, kf_t, kf_fid, kf_valid, old_fid,
                            old_valid, new_wxyz, new_t, G_wxyz, G_t):
    """PGO-corrected database poses propagated into the window keyframes:
    the exact corrected pose where a keyframe's frame_id matches a database
    entry (first match, as argmax), the rigid-G fallback otherwise."""
    match = (kf_fid[:, None] == old_fid[None, :]) & old_valid[None, :] \
        & kf_valid[:, None]
    j = torch.argmax(match.to(torch.int32), dim=1)
    found = match.any(dim=1)
    exact = SE3(new_wxyz[j], new_t[j])
    fallback = SE3(kf_wxyz, kf_t) @ SE3(G_wxyz, G_t).inverse()
    use_exact = (found & kf_valid)[:, None]
    keep = (kf_valid & ~found)[:, None]
    wxyz = torch.where(use_exact, exact.wxyz, torch.where(keep, fallback.wxyz, kf_wxyz))
    t = torch.where(use_exact, exact.t, torch.where(keep, fallback.t, kf_t))
    return wxyz, t


def _apply_closure_step(kfs: KeyframeState, map_xyz, map_valid, db,
                        new_wxyz, new_t, my_slot, old_fid, old_valid):
    """Everything device-side of applying a verified loop closure: rigid
    world correction of the map, exact/fallback window-pose propagation,
    database pose + landmark transport, and the corrected pose matrices
    the host needs for the trajectory rewrite."""
    poses_new = SE3(new_wxyz, new_t)
    G = lc.world_correction(SE3(db.wxyz[my_slot], db.t[my_slot]), poses_new[my_slot])
    xyz2 = lc.apply_correction_points(G, map_xyz, map_valid)
    wxyz, t = _corrected_window_poses(kfs.wxyz, kfs.t, kfs.frame_id, kfs.valid,
                                      old_fid, old_valid, new_wxyz, new_t, G.wxyz, G.t)
    return (kfs._replace(wxyz=wxyz, t=t), xyz2, lc.apply_correction_db(db, poses_new),
            poses_new.matrix())


def _window_problem(kfs: KeyframeState, map_state: MapState, intr, dist=None):
    """Flatten keyframe snapshots into a BAProblem over ALL map points
    (unobserved points carry zero weight), gauge fixed on the two oldest
    valid keyframes."""
    K, N = kfs.obs_point.shape
    dev = kfs.wxyz.device
    obs_cam = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(K, N).reshape(-1)
    obs_pt_raw = kfs.obs_point.reshape(-1)
    obs_uv = kfs.obs_px.reshape(-1, 2)
    pt_idx = torch.clamp(obs_pt_raw, min=0)
    w = ((obs_pt_raw >= 0) & kfs.valid[:, None].expand(K, N).reshape(-1)
         & map_state.valid[pt_idx.long()]).to(torch.float32)
    order = torch.where(kfs.valid, kfs.frame_id,
                        torch.full_like(kfs.frame_id, torch.iinfo(torch.int32).max))
    oldest = torch.argsort(order, stable=True)[:2]
    fixed = torch.zeros((K,), dtype=torch.bool, device=dev).index_fill_(0, oldest, True)
    fixed = fixed | ~kfs.valid
    return make_problem(cams=kfs.poses(), points=map_state.xyz,
                        intrinsics=intr, obs_cam=obs_cam, obs_pt=pt_idx,
                        obs_uv=obs_uv, obs_w=w, cam_fixed=fixed, dist=dist)


def _local_ba(kfs: KeyframeState, map_state: MapState, intr, dist,
              cfg: Config, max_iters: int):
    """Single-device sliding-window BA from keyframe snapshots, driven from
    the host (one read of the CG exit flag per CG iteration). Returns (kfs,
    map, initial cost, final cost, CG iterations run)."""
    prob = _window_problem(kfs, map_state, intr, dist)
    lm = _window_lm(prob, cfg, max_iters)
    S = Slots()
    lm.start(S, prob)
    n_cg = lm.run(S)
    res = lm.result(S)
    kfs2 = kfs._replace(wxyz=res.problem.cam_wxyz, t=res.problem.cam_t)
    map2 = map_state._replace(xyz=res.problem.points)
    return kfs2, map2, res.initial_cost, res.final_cost, n_cg


def _local_ba_distributed(kfs: KeyframeState, map_state: MapState, intr,
                          dist, cfg: Config, max_iters: int, mesh):
    """Mesh-distributed window BA: points shard over the mesh, cameras
    replicate, one all-reduce of the reduced camera system per LM
    iteration (parallel/dist_ba.py). Returns (kfs, map, initial cost,
    final cost)."""
    prob = _window_problem(kfs, map_state, intr, dist)
    res = dist_bundle_adjust(prob, max_iters=max_iters, huber_delta=cfg.ba_huber_delta,
                             lambda0=cfg.ba_lambda0, mesh=mesh)
    kfs2 = kfs._replace(wxyz=res.problem.cam_wxyz, t=res.problem.cam_t)
    map2 = map_state._replace(xyz=res.problem.points)
    return kfs2, map2, res.initial_cost, res.final_cost


def _window_lm(prob, cfg: Config, max_iters: int) -> LMSteps:
    """The window BA's LM steps: ``Config.ba_solver`` and its CG settings,
    and the point sums at the static width min(K, O), the JAX package's
    d_max (dr3_tpu/ba/schur_lm.py:111-113): a window keyframe observes a
    map point through at most one track (a keyframe's observations are a
    snapshot of the track table, where no two tracks share a point), so no
    point has more than K observations and no (point, keyframe) pair more
    than one: the dense solves' pair tables have width 1. No host read
    sizes anything."""
    return LMSteps(prob, max_iters, cfg.ba_huber_delta, cfg.ba_jacobi_scaling,
                   cfg.ba_lambda0, False, _pick_solver(prob, cfg.ba_solver), None,
                   cfg.ba_cg_iters, cfg.ba_cg_tol, cfg.ba_q_eta,
                   pt_width=min(prob.n_cams, prob.n_obs), pair_width=1)


# scan-row layout (float32; counters are exact in f32 at these magnitudes):
# columns 0-47 are the JAX package's (dr3_tpu/pipelines/vo.py:395-412), the
# rest the port's counters
_ROW_CONSUMED = 0
_ROW_N_INL = 1
_ROW_MED = 2
_ROW_N_TRACKED = 3
_ROW_IS_KF = 4
_ROW_MATS = 5            # ..36: [2, 4, 4] global + local trajectory mats
_ROW_CURSOR = 37
_ROW_KF_COUNT = 38
_ROW_DB_CURSOR = 39
_ROW_LAST_KF_TRACKED = 40
_ROW_LOST = 41
_ROW_REASON = 42         # 0 ok, 1 relocalize, 2 host keyframe, 3 loop cand, 4 kf BA
_ROW_N_NEW = 43
_ROW_N_SPAWNED = 44
_ROW_CAND = 45
_ROW_SCORE = 46
_ROW_SLOT = 47
_ROW_KF_IN_LOOP = 48     # the keyframe path ran inside the loop
_ROW_BA_IN_LOOP = 49     # and so did window BA
_ROW_CG = 50             # that BA's CG iterations
_ROW_DIM = 51

# reasons the loop hands a frame back to the host
_REASON_OK = 0
_REASON_RELOC = 1        # lost_count hit 3: host re-bootstraps
_REASON_HOST_KF = 2      # map/db capacity: host keyframe (with compaction)
_REASON_LOOP_CAND = 3    # place recognition hit: host verifies + closes,
                         # then runs the deferred window BA
_REASON_KF_BA = 4        # keyframe made in the loop, window BA deferred to
                         # the host (only with a mesh: the distributed BA)

# the carry of the frame loop: what one batch hands the next
_CARRY = ("pyr", "tracks", "kfs", "map", "db", "T", "fidx", "kfc", "pc", "dbc", "lkt",
          "lost", "done")
# per-batch inputs beside the carry
_BATCH_IN = ("imgs", "n_valid", "last_loop_kf", "n_edges", "anchor")


def _i32(v, device) -> torch.Tensor:
    """A 0-d int32 tensor on ``device``, by a fill (no host->device copy)."""
    return torch.full((), int(v), dtype=torch.int32, device=device)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[i] for a 0-d integer tensor i, without reading i to the host."""
    return a.index_select(0, i.reshape(1).long())[0]


class _Scan:
    """The device-resident frame loop's body as steps over a state dict
    ``S`` (:class:`Slots`): the counterpart of ``_scan_frames``' scan body
    (dr3_tpu/pipelines/vo.py:427-594), its decisions computed on the device
    exactly as there. Per batch: :meth:`prologue`, then per frame while
    ``S["go"]``: :meth:`frame` (the general step and the decisions), if
    ``S["do_kf"]`` :meth:`keyframe` (eviction, triangulation + spawning,
    snapshot, loop insert + query), if ``S["run_ba"]`` the window BA
    (:meth:`ba_start`, the LM steps — for pcg with its CG loop, for the
    dense solves without one —, :meth:`ba_finish`), then :meth:`tail` (the
    frame's row, the carry's counters, the next ``go``). ``defer_ba`` (a
    mesh is attached) ends the batch at each keyframe instead, for the
    host's distributed BA.

    The CPU runs it with Python branches on the flags (:meth:`walk`);
    on the card :class:`_ScanProgram` captures each step as a CUDA graph
    piece and puts the branches into conditional nodes. Either way the same
    functions compute the same values as the per-frame driver."""

    def __init__(self, vo: "MonoVO", defer_ba: bool):
        self.cam, self.cfg, self.n_tracks = vo.cam, vo.cfg, vo.n_tracks
        self.img_hw = (vo.cam.height, vo.cam.width)
        self.defer_ba = defer_ba
        cfg, dev = vo.cfg, vo.device
        kfs0 = KeyframeState.empty(cfg.max_keyframes, vo.n_tracks, dev)
        self.lm = _window_lm(_window_problem(kfs0, MapState.empty(cfg.max_points, dev),
                                             vo.intr, vo.cam.dist), cfg, cfg.ba_max_iters)
        self.T: dict = {}       # the LM iteration's reduced system (read-only)

    def prologue(self, S) -> None:
        dev = S["n_valid"].device
        S.put("rows", torch.zeros_like(S["rows"]))
        S.put("i", torch.zeros((), dtype=torch.int32, device=dev))
        S.put("done", torch.zeros((), dtype=torch.int32, device=dev))
        S.put("go", (S["n_valid"] > 0).to(torch.int32))

    def frame(self, S) -> None:
        """The general step on frame ``S["i"]`` and the frame's decisions
        (vo.py:466-494)."""
        cfg = self.cfg
        img = _take(S["imgs"], S["i"])
        mp = S["map"]
        pyr, tr, T, stats = _general_step(img, list(S["pyr"]), S["tracks"], mp.xyz, mp.valid,
                                          SE3(*S["T"]), self.cam, cfg, S["kfc"] - 1)
        n_inl = stats[0].to(torch.int32)
        med = stats[1]
        lost, lkt, pc, dbc = S["lost"], S["lkt"], S["pc"], S["dbc"]
        is_lost = n_inl < 10
        lost2 = torch.where(is_lost, lost + 1, torch.zeros_like(lost))
        need_reloc = is_lost & (lost2 >= 3)
        is_kf = (n_inl < cfg.kf_min_inliers) \
            | (torch.isfinite(med) & (med > cfg.kf_disparity)) \
            | (n_inl < cfg.kf_inlier_ratio * torch.clamp(lkt, min=1).to(torch.float32))
        is_kf = is_kf & ~need_reloc
        # capacity guards: these keyframes go to the host, which compacts
        map_full = pc + self.n_tracks > cfg.max_points
        db_full = dbc >= cfg.loop_db_capacity if cfg.loop_closure else torch.zeros_like(is_kf)
        host_kf = is_kf & (map_full | db_full)
        do_kf = is_kf & ~host_kf
        S.put("pyr", pyr)
        S.put("tracks", tr)
        S.put("T", (T.wxyz, T.t))
        S.put("lost", lost2)
        S.put("g_stats", torch.stack([n_inl.to(torch.float32), med, stats[2],
                                      is_kf.to(torch.float32)]))
        S.put("need_reloc", need_reloc)
        S.put("host_kf", host_kf)
        S.put("do_kf", do_kf.to(torch.int32))
        # what the keyframe path reports, for a frame that makes none:
        # (n_new, n_spawned, cand, score, slot, fire, kf, ba, cg)
        S.put("kf_info", _kf_info_none(img.device))

    def keyframe(self, S) -> None:
        """Ring eviction, triangulation + spawning, snapshot, loop-database
        insert + query and the loop decision (vo.py:496-530)."""
        cfg = self.cfg
        tr, kf, mp, db = S["tracks"], S["kfs"], S["map"], S["db"]
        kfc, fidx, pyr = S["kfc"], S["fidx"], list(S["pyr"])
        full = kfc >= cfg.max_keyframes
        kf_r, tr_r = _evict_pair(kf, tr)
        kf_e = KeyframeState(*[torch.where(full, a, b) for a, b in zip(kf_r, kf)])
        tr_e = tr._replace(ref_kf=torch.where(full, tr_r.ref_kf, tr.ref_kf))
        slot = torch.where(full, torch.full_like(kfc, cfg.max_keyframes - 1), kfc)
        T = SE3(*S["T"])
        tr_s, mp_s, kf_stats = _keyframe_step(pyr, tr_e, kf_e, T, mp, S["pc"], self.cam, cfg,
                                              slot, self.img_hw)
        kf_s = _snapshot_kf_step(kf_e, tr_s, T, slot, fidx)
        kfc_s = slot + 1
        if cfg.loop_closure:
            db, _entry, cs = lc.insert_and_query(db, S["dbc"], pyr[-1], pyr[cfg.loop_desc_level],
                                                 tr_s, mp_s, cfg, T.wxyz, T.t, fidx)
            S.put("db", db)
            S.put("dbc", S["dbc"] + 1)
            cand, score = cs[0].to(torch.int32), cs[1]
            fire = (cand >= 0) & (kfc_s - S["last_loop_kf"] >= cfg.loop_cooldown_kfs) \
                & (S["n_edges"] < cfg.loop_max_edges)
        else:
            cand = torch.full_like(kfc, -1)
            score = torch.zeros((), dtype=torch.float32, device=kfc.device)
            fire = torch.zeros_like(full)
        S.put("tracks", tr_s)
        S.put("kfs", kf_s)
        S.put("map", mp_s)
        S.put("kfc", kfc_s)
        S.put("pc", kf_stats[0].to(torch.int32))
        S.put("lkt", kf_stats[3].to(torch.int32))
        S.put("slot", slot)
        S.put("fire", fire)
        run_ba = ~fire & (not self.defer_ba)
        S.put("run_ba", run_ba.to(torch.int32))
        f32 = torch.float32
        S.put("kf_info", torch.stack([kf_stats[1].to(f32), kf_stats[2].to(f32),
                                      cand.to(f32), score, slot.to(f32), fire.to(f32),
                                      torch.ones_like(score), torch.zeros_like(score),
                                      torch.zeros_like(score)]))

    def ba_start(self, S) -> None:
        prob = _window_problem(S["kfs"], S["map"], self.cam.intrinsics, self.cam.dist)
        self.lm.start(S, prob)

    def lm_pre(self, S) -> None:
        self.lm.pre(S, self.T)

    def cg_step(self, S) -> None:
        self.lm.cg_step(S, self.T)

    def lm_post(self, S) -> None:
        self.lm.post(S, self.T)

    def ba_finish(self, S) -> None:
        """The window's new poses and points; the frame's pose becomes its
        keyframe's (vo.py:521-524)."""
        res = self.lm.result(S)
        kfs = S["kfs"]._replace(wxyz=res.problem.cam_wxyz, t=res.problem.cam_t)
        S.put("kfs", kfs)
        S.put("map", S["map"]._replace(xyz=res.problem.points))
        S.put("T", (_take(kfs.wxyz, S["slot"]), _take(kfs.t, S["slot"])))
        info = S["kf_info"]
        S.put("kf_info", torch.cat([info[:7], torch.ones_like(info[:1]),
                                    res.cg_iters.to(info.dtype).reshape(1)]))

    def tail(self, S) -> None:
        """The frame's row; the carry's frame index and ``done``; the next
        ``go`` (vo.py:532-560)."""
        g, info = S["g_stats"], S["kf_info"]
        fire = info[5] > 0.5
        reason = torch.where(S["need_reloc"], _REASON_RELOC,
                             torch.where(S["host_kf"], _REASON_HOST_KF,
                                         torch.where(fire, _REASON_LOOP_CAND, _REASON_OK)))
        done = S["need_reloc"] | S["host_kf"] | fire
        if self.defer_ba:
            kf_ba = S["do_kf"] > 0
            reason = torch.where(kf_ba & (reason == _REASON_OK), _REASON_KF_BA, reason)
            done = done | kf_ba
        mats = _traj_mats_pair(SE3(*S["T"]), SE3(*S["anchor"])).reshape(32)
        f32 = lambda v: v.to(torch.float32).reshape(-1)  # noqa: E731
        row = torch.cat([torch.ones_like(g[:1]), g, mats, f32(S["pc"]), f32(S["kfc"]),
                         f32(S["dbc"]), f32(S["lkt"]), f32(S["lost"]), f32(reason),
                         info[0:5], info[6:9]])
        # every new value before the first put: under capture a put writes
        # the slot a later expression would read
        i = S["i"].reshape(1).long()
        nxt = S["i"] + 1
        go = ((nxt < S["n_valid"]) & ~done).to(torch.int32)
        S.put("rows", S["rows"].index_copy(0, i, row[None]))
        S.put("fidx", S["fidx"] + 1)
        S.put("done", done.to(torch.int32))
        S.put("i", nxt)
        S.put("go", go)

    def structure(self) -> list:
        """The loop as nested steps: ("step", name), ("if", flag, body),
        ("while", flag, body); a WHILE body sets its flag again at its end.
        :meth:`walk` runs it, :class:`_ScanProgram` builds its graph. An LM
        step of pcg holds its CG loop; a dense solve's has none (its camera
        step is inside ``lm_pre``, as ``LMSteps.pre`` computes it)."""
        lm_step = [("step", "lm_pre"), ("step", "lm_post")]
        if self.lm.method == "pcg":
            lm_step.insert(1, ("while", "cg_go", [("step", "cg_step")]))
        ba = [("step", "ba_start"), *lm_step * self.lm.max_iters, ("step", "ba_finish")]
        body = [("step", "frame"), ("if", "do_kf", [("step", "keyframe"), ("if", "run_ba", ba)]),
                ("step", "tail")]
        return [("step", "prologue"), ("while", "go", body)]

    def walk(self, S, nodes=None) -> None:
        """Run the loop with Python branches on the flags (the CPU's loop:
        each flag is a host read here, the CG exit flag once per CG
        iteration as in ``bundle_adjust``)."""
        for node in self.structure() if nodes is None else nodes:
            if node[0] == "step":
                getattr(self, node[1])(S)
            elif node[0] == "if":
                if bool(S[node[1]]):
                    self.walk(S, node[2])
            else:
                while bool(S[node[1]]):
                    self.walk(S, node[2])

    def steps(self, nodes=None) -> list:
        """The step names :meth:`structure` holds, each once, in the order
        they first appear: the pieces a program warms up and captures."""
        out: list = []
        for node in self.structure() if nodes is None else nodes:
            names = [node[1]] if node[0] == "step" else self.steps(node[2])
            out += [n for n in names if n not in out]
        return out


def _kf_info_none(device) -> torch.Tensor:
    """:meth:`_Scan.frame`'s no-keyframe info by fills (a graph captures
    no host->device copy)."""
    info = torch.zeros((9,), dtype=torch.float32, device=device)
    info[2:5:2].fill_(-1.0)
    return info


# the kernel wrappers the loop program may reach; a consumed row adds what
# its pieces launch (one capture's count per replay)
_LOOP_COUNTERS = _STEP_COUNTERS + (corners.corner_response_pyramid, corners.corner_response,
                                   remap_xy)


def _own_slots(scan: _Scan, carry: dict, batch: dict) -> Slots:
    """The slots of a loop program: the carry and the batch cloned, then
    one eager run of every step the loop holds (:meth:`_Scan.steps`) in
    ``own`` mode, which allocates every other slot, each with storage of
    its own, and warms the steps up."""
    S = Slots("own")
    for k, v in {**carry, **batch}.items():
        S.put(k, v)
    S.put("rows", torch.zeros((batch["imgs"].shape[0], _ROW_DIM), dtype=torch.float32,
                              device=batch["imgs"].device))
    for name in scan.steps():
        getattr(scan, name)(S)
    return S


class _ScanProgram:
    """The frame loop as ONE CUDA graph program for an image shape and a
    batch width N: the pieces of :class:`_Scan`, captured on one stream
    with ``keep_graph=True``, under conditional nodes (utils/cudagraph.py
    :class:`GraphProgram`, csrc/graph_loop.cu)::

        prologue
        WHILE go:                       (the frames of the batch)
            frame                       (copy frame i, general step, decisions)
            IF do_kf:
                keyframe                (evict, kf step, snapshot, loop insert + query)
                IF run_ba:              (no loop candidate, no mesh)
                    ba_start
                    ba_max_iters x [lm_pre, WHILE cg_go: [cg_step], lm_post]
                                        (pcg; a dense solve: [lm_pre, lm_post])
                    ba_finish
            tail                        (row, counters, next go)

    Every tensor a piece reads or writes is a slot of ``S`` allocated once
    (an eager run of every piece in ``own`` mode before the captures):
    :meth:`load` copies a carry and the batch into them before a launch,
    :meth:`launch` copies the final carry and the rows out after it.
    ``launches`` maps each piece to the kernel launches one replay makes;
    ``build_launches`` holds the warm-up's, set-up outside any batch."""

    def __init__(self, scan: _Scan, carry: dict, batch: dict):
        t0 = time.perf_counter()
        self.scan = scan
        dev = batch["imgs"].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = [c.launches for c in _LOOP_COUNTERS]
        with torch.cuda.stream(side):
            self.S = S = _own_slots(scan, carry, batch)
        torch.cuda.synchronize(dev)
        # the warm-up's launches ran on the card: kept apart, as set-up
        self.build_launches = {c.__name__: c.launches - b
                               for c, b in zip(_LOOP_COUNTERS, before) if c.launches != b}
        S.mode = "capture"
        self.graphs, self.launches = {}, {}
        for name in scan.steps():
            self.graphs[name], self.launches[name] = capture_piece(
                lambda fn=getattr(scan, name): fn(S), side, _LOOP_COUNTERS)
        self.program = GraphProgram()
        self._build(self.program.chain(), scan.structure())
        self.program.instantiate()
        self.last_carry = None
        self.build_s = time.perf_counter() - t0

    def _build(self, chain, nodes) -> None:
        for node in nodes:
            if node[0] == "step":
                chain.piece(self.graphs[node[1]])
            elif node[0] == "if":
                body, _ = chain.cond(self.S[node[1]])
                self._build(body, node[2])
            else:
                body, handle = chain.cond(self.S[node[1]], loop=True)
                self._build(body, node[2])
                body.set(handle, self.S[node[1]])

    def load(self, carry: dict, batch: dict) -> None:
        """Copy a carry (unless it is the snapshot of this program's last
        launch, which its slots still hold) and a batch into the slots."""
        if carry is not self.last_carry:
            for k in _CARRY:
                _copy_into(self.S[k], carry[k])
        for k in _BATCH_IN:
            _copy_into(self.S[k], batch[k])

    def launch(self) -> tuple:
        """Run the batch; returns (the final carry, rows [N, _ROW_DIM]), both
        copies the next launch leaves alone."""
        self.program.launch(torch.cuda.current_stream())
        carry = {k: _clone(self.S[k]) for k in _CARRY}
        self.last_carry = carry
        return carry, self.S["rows"].clone()

    def count(self, rows: np.ndarray) -> None:
        """Add the launches the consumed ``rows`` made to the kernel
        counters: the frame pieces per row, the keyframe piece per in-loop
        keyframe, the BA pieces per in-loop BA (cg_step per CG iteration,
        none in a dense solve's program)."""
        used = rows[rows[:, _ROW_CONSUMED] > 0.5]
        n = {"prologue": 1 if len(used) else 0, "frame": len(used), "tail": len(used),
             "keyframe": int(used[:, _ROW_KF_IN_LOOP].sum())}
        n_ba = int(used[:, _ROW_BA_IN_LOOP].sum())
        n.update(ba_start=n_ba, ba_finish=n_ba, lm_pre=n_ba * self.scan.lm.max_iters,
                 lm_post=n_ba * self.scan.lm.max_iters, cg_step=int(used[:, _ROW_CG].sum()))
        for piece, k in n.items():
            for c, d in self.launches.get(piece, {}).items():
                c.launches += k * d


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class FrameStats(NamedTuple):
    frame_id: int
    stage: str
    n_tracked: int
    n_inliers: int
    is_keyframe: bool
    n_map_points: int


class MonoVO:
    """Monocular VO/SLAM driver (HandlerMono + SLAM union): per frame
    (:meth:`process`) or through the device-resident frame loop
    (:meth:`process_batch`).

    ``device``: where every tensor of the state lives (default: the card;
    ``device="cpu"`` runs the kernels' plain versions). ``seed`` seeds the
    ``torch.Generator`` that draws the two-view RANSAC minimal sets."""

    def __init__(self, cam: Pinhole, cfg: Optional[Config] = None, seed: int = 0,
                 mesh=None, device=None):
        self.cfg = cfg or Config()
        if self.cfg.loop_closure and self.cfg.loop_db_capacity < 4:
            # db_compact keeps every other slot + a tail; below 4 slots the
            # compaction frees nothing and the next insert would overflow
            raise ValueError("loop_db_capacity must be >= 4 when loop_closure "
                             f"is enabled (got {self.cfg.loop_db_capacity})")
        self.mesh = mesh
        self.device = resolve_device(device, "MonoVO")
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"MonoVO on {self.device} with a mesh on {mesh.device}")
        self.cam = cam.to(self.device)
        n_cols = -(-cam.width // self.cfg.cell_size)
        n_rows = -(-cam.height // self.cfg.cell_size)
        self.n_tracks = min(n_cols * n_rows, self.cfg.max_corners)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.monitor = Monitor()
        self.graphs: dict = {}   # image shape -> StepGraph of the general step
        self.scan_programs: dict = {}   # (H, W, N) -> _ScanProgram (the card's loop)
        self._scan: Optional[_Scan] = None
        self.reset()

    def reset(self):
        self.frame_idx = -1
        self.trajectory: list[np.ndarray] = []
        self._traj_local: list[np.ndarray] = []
        self.stats: list[FrameStats] = []
        self.T_anchor = SE3.identity(device=self.device)
        self.lost_count = 0
        self.n_relocalizations = 0
        self.n_loop_closures = 0
        self.n_compactions = 0
        self.n_db_compactions = 0
        self.n_window_ba = 0
        self.n_cg_iters = 0
        self.n_discarded_batches = 0   # speculative loop batches thrown away
        self._reset_init()

    def _reset_init(self):
        """Drop tracking/map state but keep trajectory + counters
        (initialization.cpp:557-560)."""
        dev = self.device
        self.stage = Stage.FIRST
        self.tracks = TrackState.empty(self.n_tracks, self.cfg.feature_align_patch, dev)
        self.kfs = KeyframeState.empty(self.cfg.max_keyframes, self.n_tracks, dev)
        self.map = MapState.empty(self.cfg.max_points, dev)
        self.T_cur = SE3.identity(device=dev)
        self.pyr_prev = None
        self.kf_count = 0
        self.point_cursor = 0
        self.last_kf_tracked = 0
        # loop-closure state: the database lives in the *local* frame, so a
        # re-bootstrap (new local frame) invalidates it
        cfg = self.cfg
        self.loop_db = lc.LoopDatabase.empty(
            cfg.loop_db_capacity, self.n_tracks, cfg.loop_thumb_h * cfg.loop_thumb_w,
            cfg.loop_desc_patch ** 2, dev) if cfg.loop_closure else None
        self.db_cursor = 0
        self.loop_edges: list[tuple] = []  # (i_slot, j_slot, rel_wxyz, rel_t)
        self.last_loop_kf = -10 ** 9

    # -- helpers ----------------------------------------------------------
    @property
    def intr(self) -> torch.Tensor:
        return self.cam.intrinsics

    def _snapshot_kf(self, slot: int, frame_id: int):
        self.kfs = _snapshot_kf_step(self.kfs, self.tracks, self.T_cur, slot, frame_id)

    def _evict_oldest_if_full(self) -> int:
        if self.kf_count < self.cfg.max_keyframes:
            return self.kf_count
        self.kfs, self.tracks = _evict_pair(self.kfs, self.tracks)
        self.kf_count = self.cfg.max_keyframes - 1
        return self.kf_count

    def _upload(self, frames) -> torch.Tensor:
        """[n, H, W] float32 on the device from numpy frames, in one copy
        (pinned and non-blocking on the card); uint8 frames become [0, 1]
        floats as in the JAX package (vo.py:977-991)."""
        arrays = [np.asarray(f) for f in frames]
        host = torch.from_numpy(np.stack([
            a.astype(np.float32) / 255.0 if a.dtype == np.uint8 else a.astype(np.float32)
            for a in arrays]))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def _to_image(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device, torch.float32).contiguous()
        return self._upload([img])[0]

    # -- stages -----------------------------------------------------------
    def process(self, img) -> np.ndarray:
        """Add one grayscale frame [H, W] in [0,1] (or uint8, converted;
        numpy or torch); returns T_f_w 4x4 (numpy)."""
        img = self._to_image(img)
        self.frame_idx += 1
        self.monitor.tic("global")
        mats = None
        if self.stage is Stage.GENERAL and self.pyr_prev is not None:
            pyr, mats = self._process_general(img)
        else:
            cfg = self.cfg
            self.monitor.tic("pyramid")
            pyr = pyramid.build_pyramid(img, max(cfg.n_pyr_levels, cfg.klt_levels))
            self.monitor.toc("pyramid", block=pyr[-1])
            if self.stage is Stage.FIRST:
                self._process_first(pyr)
            elif self.pyr_prev is None:
                self._log_stats("reseed", int(self.tracks.n), 0, False)
            else:
                self._process_second(pyr)
        self.pyr_prev = pyr
        if mats is None:
            mats = _traj_mats(self.T_cur, self.T_anchor)
        self.monitor.toc("global")
        self.trajectory.append(mats[0])
        self._traj_local.append(mats[1])
        return mats[0]

    # -- the device-resident frame loop ----------------------------------
    def process_batch(self, imgs) -> list[np.ndarray]:
        """Process a sequence of frames, consuming up to
        ``cfg.frames_per_dispatch`` GENERAL frames per dispatch of the
        device-resident frame loop (:class:`_Scan`, the counterpart of the
        JAX package's ``_scan_frames``): the general step and the whole
        keyframe path — eviction, triangulation and spawning, snapshot,
        loop-database insert and query, window BA — run inside it. On the
        card a dispatch is one launch of a CUDA graph program
        (:class:`_ScanProgram`: conditional nodes for the branches and the
        CG loop) and the host reads one row block per batch; on the CPU the
        same functions run with Python branches. The host touches a frame
        only for bootstrap, relocalisation, capacity compaction, loop-
        closure verification and correction, and, with a mesh only, the
        window BA (``_REASON_KF_BA``). Returns the
        per-frame T_f_w 4x4 matrices, bit-equal to per-frame
        :meth:`process`.

        Falls back to per-frame processing outside the GENERAL stage, when
        ``frames_per_dispatch <= 1``, or with the fused frontend off
        (vo.py:885-951). ``scan_speculation_depth`` batches are dispatched,
        each from the previous one's final carry, before the oldest one's
        rows are read; an event discards the rest of the chain (counted in
        ``n_discarded_batches``) and resubmits its frames."""
        out: list[np.ndarray] = []
        i, n = 0, len(imgs)
        N = self.cfg.frames_per_dispatch
        depth = max(1, self.cfg.scan_speculation_depth)
        scan_ok = N > 1 and self.cfg.fused_frontend
        # dispatched-but-unread batches, oldest first: (start, n_valid, carry, ys)
        inflight: list[tuple] = []
        while i < n or inflight:
            if not inflight and (not scan_ok or self.stage is not Stage.GENERAL
                                 or self.pyr_prev is None):
                out.append(self.process(imgs[i]))
                i += 1
                continue
            while len(inflight) < depth:
                nxt = inflight[-1][0] + inflight[-1][1] if inflight else i
                if nxt >= n:
                    break
                carry_in = inflight[-1][2] if inflight else None
                inflight.append((nxt,) + self._dispatch_scan(imgs[nxt:nxt + N], carry=carry_in))
            start, nv, carry, ys = inflight.pop(0)
            # adopt THIS batch's carry so the event handlers in _consume_rows
            # see exactly the post-early-out state
            self._adopt_carry(carry)
            self.monitor.tic("scan_fetch")
            rows = ys.cpu().numpy()          # the batch's one host read
            self.monitor.toc("scan_fetch")
            self._count_launches(rows)
            consumed, mats, clean = self._consume_rows(rows)
            out.extend(mats)
            i = start + consumed
            if not (clean and consumed == nv):
                for entry in inflight:       # they ran: their launches count
                    self._count_launches(entry[3].cpu().numpy())
                self.n_discarded_batches += len(inflight)
                inflight.clear()
        return out

    def _scan_body(self) -> _Scan:
        if self._scan is None:
            # the loop runs window BA with every solver, as the JAX package's
            # scan does (dr3_tpu/pipelines/vo.py:1013); the mesh-distributed
            # BA runs on the host after a _REASON_KF_BA early-out
            self._scan = _Scan(self, defer_ba=self.mesh is not None)
        return self._scan

    def _host_carry(self) -> dict:
        """The loop's carry from the driver's state (device scalars by fills)."""
        dev = self.device
        return dict(pyr=list(self.pyr_prev), tracks=self.tracks, kfs=self.kfs, map=self.map,
                    db=self.loop_db, T=(self.T_cur.wxyz, self.T_cur.t),
                    fidx=_i32(self.frame_idx + 1, dev), kfc=_i32(self.kf_count, dev),
                    pc=_i32(self.point_cursor, dev), dbc=_i32(self.db_cursor, dev),
                    lkt=_i32(self.last_kf_tracked, dev), lost=_i32(self.lost_count, dev),
                    done=_i32(0, dev))

    def _dispatch_scan(self, batch, carry=None):
        """Dispatch (without reading) the loop over up to
        ``frames_per_dispatch`` frames. ``carry``: chain directly off a prior
        batch's final carry instead of the driver's state — the speculative
        chain. Returns (n_valid, carry, ys) with ys the [N, _ROW_DIM] row
        block, unread, on the device."""
        cfg = self.cfg
        N = cfg.frames_per_dispatch
        frames = [np.asarray(f) for f in batch]
        n_valid = len(frames)
        frames += [np.zeros_like(frames[0])] * (N - n_valid)   # the compiled width
        dev = self.device
        inputs = dict(imgs=self._upload(frames), n_valid=_i32(n_valid, dev),
                      last_loop_kf=_i32(self.last_loop_kf, dev),
                      n_edges=_i32(len(self.loop_edges), dev),
                      anchor=(self.T_anchor.wxyz, self.T_anchor.t))
        state = self._host_carry() if carry is None else carry
        scan = self._scan_body()
        self.monitor.tic("scan_dispatch")
        if dev.type == "cuda":
            key = tuple(inputs["imgs"].shape[1:]) + (N,)
            if key not in self.scan_programs:
                self.scan_programs[key] = _ScanProgram(scan, state, inputs)
            prog = self.scan_programs[key]
            self._scan_key = key
            prog.load(state, inputs)
            new_carry, ys = prog.launch()
        else:
            S = Slots()
            S.update(state)
            S.update(inputs)
            S["rows"] = torch.zeros((N, _ROW_DIM), dtype=torch.float32, device=dev)
            scan.walk(S)
            new_carry, ys = {k: S[k] for k in _CARRY}, S["rows"]
        self.monitor.toc("scan_dispatch")
        return n_valid, new_carry, ys

    def _count_launches(self, rows: np.ndarray) -> None:
        """The loop program's kernel launches for a batch's rows (the card;
        CPU tensors launch nothing)."""
        if self.device.type == "cuda":
            self.scan_programs[self._scan_key].count(rows)

    def _adopt_carry(self, carry):
        """Point driver state at a batch's final carry (device tensors, no
        read); the host counters come from the rows."""
        self.pyr_prev = list(carry["pyr"])
        self.tracks = carry["tracks"]
        self.kfs = carry["kfs"]
        self.map = carry["map"]
        if self.cfg.loop_closure:
            self.loop_db = carry["db"]
        self.T_cur = SE3(*carry["T"])

    def _consume_rows(self, rows) -> tuple[int, list[np.ndarray], bool]:
        """Apply the host-side bookkeeping for one row block: stats and
        trajectory per consumed frame, the host mirrors of the counters, and
        any trailing event (relocalise / host keyframe / loop-closure finish
        / deferred window BA). Returns (consumed, trajectory mats, clean) —
        clean means no event fired, so a speculative next batch may stand."""
        mats_out: list[np.ndarray] = []
        consumed = 0
        clean = True
        for r in rows:
            if r[_ROW_CONSUMED] < 0.5:
                break
            consumed += 1
            self.frame_idx += 1
            reason = int(r[_ROW_REASON])
            n_inl = int(r[_ROW_N_INL])
            n_tracked = int(r[_ROW_N_TRACKED])
            is_kf = bool(r[_ROW_IS_KF] > 0.5)
            self.point_cursor = int(r[_ROW_CURSOR])
            self.kf_count = int(r[_ROW_KF_COUNT])
            self.db_cursor = int(r[_ROW_DB_CURSOR])
            self.last_kf_tracked = int(r[_ROW_LAST_KF_TRACKED])
            self.lost_count = int(r[_ROW_LOST])
            if r[_ROW_BA_IN_LOOP] > 0.5:
                self.n_window_ba += 1
                self.n_cg_iters += int(r[_ROW_CG])
            if reason == _REASON_OK:
                mats = r[_ROW_MATS:_ROW_MATS + 32].reshape(2, 4, 4).astype(np.float32)
                self._log_stats("general", n_tracked, n_inl, is_kf)
            else:
                clean = False
                if reason == _REASON_RELOC:
                    self._relocalize()
                    self._log_stats("relocalize", 0, 0, False)
                else:
                    if reason == _REASON_HOST_KF:
                        # capacity: the general step ran in the loop; the host
                        # makes the keyframe (with compaction)
                        self._make_keyframe(self.pyr_prev)
                    elif reason == _REASON_KF_BA:
                        # the keyframe ran in the loop; the host runs its BA
                        self._run_local_ba(int(r[_ROW_SLOT]))
                    else:                    # _REASON_LOOP_CAND
                        self._finish_loop_candidate(int(r[_ROW_SLOT]), int(r[_ROW_CAND]))
                    self._log_stats("general", n_tracked, n_inl, True)
                mats = _traj_mats(self.T_cur, self.T_anchor)
            self.trajectory.append(mats[0])
            self._traj_local.append(mats[1])
            mats_out.append(mats[0])
        return consumed, mats_out, clean

    def _finish_loop_candidate(self, slot: int, cand: int):
        """Complete a keyframe whose in-loop place-recognition query hit:
        geometric verification and, on success, pose-graph correction, then
        the window BA the loop deferred (correction before BA, as on the
        per-frame path)."""
        db = self.loop_db
        my_slot = self.db_cursor - 1      # the loop already inserted this keyframe
        self.monitor.tic("loop_closure")
        entry = lc.LoopEntry(thumb=db.thumb[my_slot], kp_desc=db.kp_desc[my_slot],
                             kp_px=db.kp_px[my_slot], kp_xyz=db.kp_xyz[my_slot],
                             kp_point=db.kp_point[my_slot], kp_has=db.kp_has[my_slot])
        self._verify_and_close(my_slot, cand, entry)
        self.monitor.toc("loop_closure")
        self._run_local_ba(slot)

    def _process_first(self, pyr):
        cfg = self.cfg
        self.monitor.tic("detect")
        feats = _detect(pyr, cfg)
        n = int(feats.n)
        self.monitor.toc("detect")
        if n < cfg.init_min_features:   # initialization.cpp:556-561
            self._log_stats("first", 0, 0, False)
            return
        if feats.xy.shape[0] > self.n_tracks:
            # capacity cap (Config.max_corners): keep the first n_tracks cells
            feats = corners.GridCorners(*[a[: self.n_tracks] for a in feats])
        half = (cfg.feature_align_patch - 1) // 2
        dev = self.device
        self.tracks = TrackState(
            px=feats.xy, ref_px=feats.xy,
            ref_kf=torch.zeros((self.n_tracks,), dtype=torch.int32, device=dev),
            point=torch.full((self.n_tracks,), -1, dtype=torch.int32, device=dev),
            age=torch.zeros((self.n_tracks,), dtype=torch.int32, device=dev),
            valid=feats.valid,
            ref_patch=lk.extract_patches(pyr[0], feats.xy, half))
        self.T_cur = SE3.identity(device=dev)
        self._snapshot_kf(0, self.frame_idx)
        self._loop_db_insert(pyr)
        self.kf_count = 1
        self.stage = Stage.SECOND
        self._log_stats("first", n, n, True)

    def _process_second(self, pyr):
        cfg = self.cfg
        self.monitor.tic("klt")
        self.tracks, res = _track(self.pyr_prev, pyr, self.tracks, cfg)
        n_tracked = int(self.tracks.n)
        self.monitor.toc("klt")
        if n_tracked < cfg.init_min_tracked:   # initialization.cpp:655
            self._reset_init()
            self._log_stats("second", n_tracked, 0, False)
            return
        disp = torch.linalg.norm(self.tracks.px - self.tracks.ref_px, dim=-1)
        med_disp = float(nanmedian(torch.where(self.tracks.valid, disp,
                                               torch.full_like(disp, float("nan")))))
        if not np.isfinite(med_disp) or med_disp < cfg.init_min_disparity:
            self._log_stats("second", n_tracked, 0, False)
            return

        self.monitor.tic("init")
        result = initialize_two_view(self.generator, self.tracks.ref_px,
                                     self.tracks.px, self.tracks.valid,
                                     self.cam.K, cfg)
        success = bool(result.success)
        self.monitor.toc("init")
        if not success:
            self._log_stats("second", n_tracked, int(result.n_good), False)
            return

        # initial map (initialization.cpp:716-739): good tracks get
        # consecutive point ids; only their rows are written (the JAX
        # reference also scatters the rejected rows onto slot 0 with its
        # old value, which drops point 0 whenever a rejected row follows it)
        good = result.good
        rank = torch.cumsum(good.to(torch.int32), 0) - 1
        idx = rank[good].long()
        xyz = self.map.xyz.clone()
        xyz[idx] = result.points[good]
        valid = self.map.valid.clone()
        valid[idx] = True
        self.map = MapState(xyz=xyz, valid=valid)
        n_good_tracks = int(good.sum())
        self.point_cursor = n_good_tracks
        self.tracks = self.tracks._replace(
            point=torch.where(good, rank, torch.full_like(rank, -1)).to(torch.int32),
            valid=self.tracks.valid & good,
            ref_px=self.tracks.px,
            ref_kf=torch.ones_like(self.tracks.ref_kf))
        self.T_cur = result.T_cur_ref
        self._snapshot_kf(1, self.frame_idx)
        self._loop_db_insert(pyr)
        self.kf_count = 2
        self.last_kf_tracked = n_good_tracks
        self.stage = Stage.GENERAL
        self._log_stats("second", n_tracked, int(result.n_good), True)

    def _fused_step(self, img):
        """The general step with its packed [3 + 32] result read back: one
        graph replay on the card (captured on the first general frame of
        an image shape), one eager call elsewhere."""
        args = (self.pyr_prev, self.tracks, self.map.xyz, self.map.valid, self.T_cur)
        if self.device.type != "cuda":
            pyr, tracks, T, packed = _general_step(img, *args, self.cam, self.cfg,
                                                   self.kf_count - 1, self.T_anchor)
            return pyr, tracks, T, packed.numpy()
        key = tuple(img.shape)
        if key not in self.graphs:
            self.graphs[key] = StepGraph(_flat_step(self.cam, self.cfg, len(self.pyr_prev)),
                                         _STEP_COUNTERS)
        slot = torch.full((), self.kf_count - 1, dtype=torch.int32, device=self.device)
        out = self.graphs[key](img, *self.pyr_prev, *self.tracks, self.map.xyz,
                               self.map.valid, self.T_cur.wxyz, self.T_cur.t, slot,
                               self.T_anchor.wxyz, self.T_anchor.t)
        n_levels, n_fields = len(self.pyr_prev), len(TrackState._fields)
        tracks = TrackState(*out[n_levels:n_levels + n_fields])
        T = SE3(out[-3], out[-2])
        return list(out[:n_levels]), tracks, T, out[-1].cpu().numpy()

    def _process_general(self, img):
        """A general frame; returns (pyramid, trajectory matrices [2, 4, 4]
        or None). The packed matrices hold where the pose did not change
        after the step: not on a keyframe or a relocalisation (vo.py:850-856)."""
        cfg = self.cfg
        self.monitor.tic("frame_step")
        if cfg.fused_frontend:
            pyr, tracks, T_new, packed = self._fused_step(img)
        else:
            pyr, tracks, T_new, packed = _general_step(
                img, self.pyr_prev, self.tracks, self.map.xyz, self.map.valid,
                self.T_cur, self.cam, cfg, self.kf_count - 1, mon=self.monitor)
            packed = packed.cpu().numpy()      # the frame's one host read
        self.monitor.toc("frame_step")
        n_inliers = int(packed[0])
        med_disp = float(packed[1])
        n_tracked = int(packed[2])
        mats = packed[3:].reshape(2, 4, 4) if packed.size > 3 else None
        self.tracks = tracks
        if n_inliers >= 10:
            self.T_cur = T_new
            self.lost_count = 0
        else:
            self.lost_count += 1
            if self.lost_count >= 3:
                self._relocalize()
                self._log_stats("relocalize", 0, 0, False)
                return pyr, None
        is_kf = self._keyframe_needed(n_inliers, med_disp)
        if is_kf:
            self._make_keyframe(pyr)
        self._log_stats("general", n_tracked, n_inliers, is_kf)
        return pyr, None if is_kf else mats

    def _relocalize(self):
        """Tracking lost: restart the bootstrap in a fresh local frame chained
        onto the last reported pose."""
        self.T_anchor = SE3.from_matrix(torch.as_tensor(
            self.trajectory[-1], dtype=torch.float32, device=self.device)) \
            if self.trajectory else SE3.identity(device=self.device)
        self.n_relocalizations += 1
        self.lost_count = 0
        self._reset_init()

    def _keyframe_needed(self, n_inliers: int, med_disp: float) -> bool:
        cfg = self.cfg
        if n_inliers < cfg.kf_min_inliers:
            return True
        if np.isfinite(med_disp) and med_disp > cfg.kf_disparity:
            return True
        return n_inliers < cfg.kf_inlier_ratio * max(self.last_kf_tracked, 1)

    def _compact_map_if_needed(self):
        """Reclaim map capacity when the allocation cursor nears the end:
        drop points no longer referenced, renumber survivors densely."""
        if self.point_cursor + self.n_tracks <= self.cfg.max_points:
            return
        db = self.loop_db
        keep = _referenced_points(self.tracks, self.kfs, self.map.valid,
                                  None if db is None else db.kp_point,
                                  None if db is None else db.valid)
        self.map, new_id, n_live = compact_map(self.map, keep)
        self.tracks = self.tracks._replace(point=remap_point_ids(self.tracks.point, new_id))
        self.kfs = self.kfs._replace(obs_point=remap_point_ids(self.kfs.obs_point, new_id))
        if db is not None:
            self.loop_db = db._replace(kp_point=remap_point_ids(db.kp_point, new_id))
        self.point_cursor = int(n_live)
        self.n_compactions += 1

    def _make_keyframe(self, pyr):
        """The keyframe path of the per-frame driver, on the loop's
        functions with device scalars; its one host read is the counters
        and the loop query's result together."""
        cfg = self.cfg
        dev = self.device
        slot = self._evict_oldest_if_full()
        self._compact_map_if_needed()
        self.monitor.tic("kf_step")
        self.tracks, self.map, kf_stats = _keyframe_step(
            pyr, self.tracks, self.kfs, self.T_cur, self.map, _i32(self.point_cursor, dev),
            self.cam, cfg, _i32(slot, dev), (self.cam.height, self.cam.width))
        self.monitor.toc("kf_step")
        self._snapshot_kf(slot, self.frame_idx)
        self.kf_count += 1
        if self.loop_db is None:
            vals = kf_stats.cpu().numpy()     # the keyframe's one host read
        else:
            self.monitor.tic("loop_closure")
            my_slot, entry, cs = self._loop_step(pyr)
            vals = torch.cat([kf_stats.to(torch.float64), cs.to(torch.float64)]).cpu().numpy()
        self.point_cursor = int(vals[0])
        self.last_kf_tracked = int(vals[3])
        if self.loop_db is not None:
            cand = int(vals[4])
            if cand >= 0 and self.kf_count - self.last_loop_kf >= cfg.loop_cooldown_kfs \
                    and len(self.loop_edges) < cfg.loop_max_edges:
                self._verify_and_close(my_slot, cand, entry)
            self.monitor.toc("loop_closure")
        self._run_local_ba(slot)

    def _run_local_ba(self, slot: int):
        """Sliding-window BA over the keyframe snapshots; the current pose
        becomes the just-optimised keyframe pose."""
        cfg = self.cfg
        self.monitor.tic("local_BA")
        n_cg = 0
        if self.mesh is not None:
            self.kfs, self.map, _c0, _c1 = _local_ba_distributed(
                self.kfs, self.map, self.intr, self.cam.dist, cfg, cfg.ba_max_iters,
                self.mesh)
        else:
            self.kfs, self.map, _c0, _c1, n_cg = _local_ba(
                self.kfs, self.map, self.intr, self.cam.dist, cfg, cfg.ba_max_iters)
        self.monitor.toc("local_BA", block=self.map.xyz)
        self.n_window_ba += 1
        self.n_cg_iters += n_cg
        self.T_cur = SE3(self.kfs.wxyz[slot], self.kfs.t[slot])

    # -- loop closure (pipelines/loop_closure.py) --------------------------
    def _maybe_compact_db(self):
        """Capacity policy: when the append cursor hits capacity, halve
        temporal density (keep every other old keyframe + the newest few)
        and keep appending."""
        cap = self.cfg.loop_db_capacity
        if self.db_cursor < cap:
            return
        keep = np.zeros(cap, bool)
        keep[::2] = True
        # always keep the newest few, but never so many that the
        # compaction stops freeing slots
        keep[cap - max(1, min(8, cap // 4)):] = True
        self.loop_db, old2new, n_keep = lc.db_compact(
            self.loop_db, torch.as_tensor(keep, device=self.device))
        self.n_db_compactions += 1
        o2n = old2new.cpu().numpy()
        # edges touching an evicted keyframe are dropped (their correction
        # already lives in the poses)
        self.loop_edges = [(int(o2n[i]), int(o2n[j]), q, t)
                           for (i, j, q, t) in self.loop_edges
                           if o2n[i] >= 0 and o2n[j] >= 0]
        self.db_cursor = int(n_keep)

    def _loop_db_insert(self, pyr):
        """Append the just-made bootstrap keyframe to the loop database."""
        if self.loop_db is None:
            return
        self._maybe_compact_db()
        entry = lc.make_entry(pyr[-1], pyr[self.cfg.loop_desc_level], self.tracks,
                              self.map, self.cfg)
        self.loop_db = lc.db_add(self.loop_db, self.db_cursor, entry, self.T_cur.wxyz,
                                 self.T_cur.t, self.frame_idx)
        self.db_cursor += 1

    def _loop_step(self, pyr):
        """At every new keyframe: add it to the loop database and query for
        a revisit, as the loop does (device slots, nothing read). Returns
        (its slot, its entry, the query's [cand, score] on the device)."""
        cfg = self.cfg
        dev = self.device
        self._maybe_compact_db()
        my_slot = self.db_cursor
        self.loop_db, entry, cs = lc.insert_and_query(
            self.loop_db, _i32(my_slot, dev), pyr[-1], pyr[cfg.loop_desc_level], self.tracks,
            self.map, cfg, self.T_cur.wxyz, self.T_cur.t, _i32(self.frame_idx, dev))
        self.db_cursor += 1
        return my_slot, entry, cs

    def _verify_and_close(self, my_slot: int, cand: int, entry):
        """Geometric verification of a place-recognition hit and, on
        success, the correction of the whole trajectory through the
        keyframe pose graph."""
        ver = lc.verify_loop(self.loop_db, cand, entry, self.cam, self.cfg)
        if bool(ver.ok):
            self._close_loop(my_slot, cand, ver)

    def _close_loop(self, my_slot: int, cand: int, ver):
        cfg = self.cfg
        db = self.loop_db
        T_cand = SE3(db.wxyz[cand], db.t[cand])
        rel = SE3(ver.wxyz, ver.t) @ T_cand.inverse()   # measured T_ij, i=cur j=cand
        self.loop_edges.append((my_slot, cand, rel.wxyz.cpu().numpy(), rel.t.cpu().numpy()))
        E = cfg.loop_max_edges
        li = np.zeros(E, np.int64)
        lj = np.zeros(E, np.int64)
        lw = np.zeros(E, np.float32)
        lq = np.zeros((E, 4), np.float32)
        lq[:, 0] = 1.0
        lt = np.zeros((E, 3), np.float32)
        for e, (i, j, q, t) in enumerate(self.loop_edges):
            li[e], lj[e], lq[e], lt[e], lw[e] = i, j, q, t, cfg.loop_edge_weight
        dev = self.device
        old_fid = db.frame_id.cpu().numpy()
        old_valid = db.valid.cpu().numpy()
        old_mats = SE3(db.wxyz, db.t).matrix().cpu().numpy()
        poses_new, _c0, _c1 = lc.optimize_db_graph(
            db, *[torch.as_tensor(a, device=dev) for a in (li, lj, lq, lt, lw)],
            cfg.loop_pgo_iters)
        # the correction everywhere (map rigid remap, window poses, database
        # transport); the next local BA re-settles the window on top of it
        self.kfs, xyz2, self.loop_db, new_mats = _apply_closure_step(
            self.kfs, self.map.xyz, self.map.valid, db, poses_new.wxyz, poses_new.t,
            my_slot, db.frame_id, db.valid)
        self.map = self.map._replace(xyz=xyz2)
        self.T_cur = poses_new[my_slot]
        self._correct_trajectory(old_fid, old_valid, old_mats, new_mats.cpu().numpy())
        self.last_loop_kf = self.kf_count
        self.n_loop_closures += 1

    def _apply_db_poses(self, old_fid, old_valid, old_mats, poses_new, my_slot: int):
        """Propagate corrected database keyframe poses into the live window,
        the current pose, the past trajectory, and the database itself."""
        db = self.loop_db                 # still the pre-correction poses
        G = lc.world_correction(SE3(db.wxyz[my_slot], db.t[my_slot]), poses_new[my_slot])
        wxyz, t = _corrected_window_poses(
            self.kfs.wxyz, self.kfs.t, self.kfs.frame_id, self.kfs.valid,
            torch.as_tensor(old_fid, device=self.device),
            torch.as_tensor(old_valid, device=self.device),
            poses_new.wxyz, poses_new.t, G.wxyz, G.t)
        self.kfs = self.kfs._replace(wxyz=wxyz, t=t)
        self.T_cur = poses_new[my_slot]
        self._correct_trajectory(old_fid, old_valid, old_mats,
                                 poses_new.matrix().cpu().numpy())
        self.loop_db = lc.apply_correction_db(db, poses_new)

    def global_refine(self, max_iters: int = 20):
        """Offline global bundle adjustment over every keyframe in the loop
        database plus the full map (the reference's Optimizer::global_BA,
        src/optimizer.cpp:131-175), with the solver "auto" picks. Needs
        ``loop_closure=True``. Returns (initial_cost, final_cost), or None
        without a database of at least 3 keyframes."""
        if self.loop_db is None or self.db_cursor < 3:
            return None
        cfg = self.cfg
        db = self.loop_db
        prob = lc.global_ba_problem(db, self.map, self.intr, self.cam.dist)
        if self.mesh is not None:
            res = dist_bundle_adjust(prob, max_iters=max_iters, huber_delta=cfg.ba_huber_delta,
                                     lambda0=cfg.ba_lambda0, mesh=self.mesh)
        else:
            res = bundle_adjust(prob, max_iters, cfg.ba_huber_delta,
                                cfg.ba_jacobi_scaling, cfg.ba_lambda0)
        self.map = self.map._replace(xyz=res.problem.points)
        self._apply_db_poses(db.frame_id.cpu().numpy(), db.valid.cpu().numpy(),
                             SE3(db.wxyz, db.t).matrix().cpu().numpy(),
                             SE3(res.problem.cam_wxyz, res.problem.cam_t),
                             self.db_cursor - 1)
        return float(res.initial_cost), float(res.final_cost)

    def _correct_trajectory(self, fids, valid, old_mats, new_mats):
        """Rewrite past trajectory entries: every frame between keyframe k
        and k+1 inherits k's correction Ginv_k = T_old_k^-1 · T_new_k
        (applied on the right of its local pose), vectorized in numpy. The
        database resets at relocalization, so one anchor covers them all."""
        anchor = self.T_anchor.matrix().cpu().numpy()
        ks = np.nonzero(np.asarray(valid))[0]
        n_frames = len(self._traj_local)
        if ks.size == 0 or n_frames == 0:
            return
        kf_fids = np.asarray(fids)[ks].astype(np.int64)
        first = int(kf_fids[0])
        if first >= n_frames:
            return
        # frame f in [kf_fids[i], kf_fids[i+1]) inherits correction i
        owner = np.searchsorted(kf_fids, np.arange(first, n_frames), side="right") - 1
        Ginv = np.linalg.inv(old_mats[ks]) @ new_mats[ks]
        traj_l = np.asarray(self._traj_local[first:]) @ Ginv[owner]
        traj_g = traj_l @ anchor
        for i, f in enumerate(range(first, n_frames)):
            self._traj_local[f] = traj_l[i]
            self.trajectory[f] = traj_g[i]

    def _log_stats(self, stage, n_tracked, n_inliers, is_kf):
        self.stats.append(FrameStats(self.frame_idx, stage, n_tracked,
                                     n_inliers, is_kf, self.point_cursor))

    # -- reporting (SLAM::pprint parity, src/slam.cpp:49-84) --------------
    def report(self) -> str:
        return self.monitor.report(
            n_frames=self.frame_idx + 1,
            extra={"keyframes": self.kf_count, "map_points": int(self.map.n),
                   "observations": int(self.map.n_observations(self.kfs)),
                   "relocalizations": self.n_relocalizations,
                   "loop_closures": self.n_loop_closures,
                   "window_BA": self.n_window_ba,
                   "cg_iterations": self.n_cg_iters})

    def positions(self) -> np.ndarray:
        """[T, 3] camera centers in world (pos() parity, frame.hpp:82)."""
        out = []
        for T in self.trajectory:
            out.append(-T[:3, :3].T @ T[:3, 3])
        return np.asarray(out)
