"""Distributed Schur-complement bundle adjustment over a point-shard mesh
(port of dr3_tpu.parallel.dist_ba).

The growth axis of a SLAM problem is landmarks/observations, so **points
shard across the mesh** and cameras replicate (SURVEY §5/§7):

* each shard owns P/n point blocks and exactly the observations of those
  points (co-partitioned on the host: Hpp is 3x3 block-diagonal, so the
  point elimination is embarrassingly parallel);
* the partial reduced systems S_d = Hcc_d - W_d Hpp_d^-1 W_d^T and rhs_d of
  a rank's shards are summed in a fixed order (the rank's rows are one
  point-sorted table; camera sums are products with the 0/1 membership
  matrix, point sums the compensated scan of ba/schur_core.py), then
  combined across ranks with **one** ``all_reduce`` of one flat buffer —
  the JAX package's one ``psum`` (the reduce stage of the reference's
  Ceres DENSE_SCHUR, src/optimizer.cpp:155-166);
* a rank builds its W Hpp^-1 W^T as Z^T Z with one Z over its points, or
  one Z per shard where that is past the dense guard (each within it, as
  each JAX device's), or the pair table where one shard's is past it;
* the [6K, 6K] reduced camera solve is small and runs on every rank;
* the point back-substitution is local.

Per LM iteration the collectives are that ``all_reduce`` and a second,
two-number one (the candidate cost and the count of shards with
non-finite points); the accept/reject and the lambda schedule are
``torch.where`` on the device, so nothing is read on the host until the
loop ends. The refined points come back with one ``all_gather``. The port
compiles nothing, so there is no executable cache to keep (the JAX
package's ``_build_dist_ba``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from dr3_tpu_torch.ba import schur_core
from dr3_tpu_torch.ba.problem import BAProblem, apply_update, linearize
from dr3_tpu_torch.ba.schur_core import (_camera_reducer, _damp, _dense_camera_step,
                                         _explicit_s_corr, _explicit_s_corr_sqrt, _pad_obs,
                                         _sorted_reducer, assemble_blocks, cam_onehot_matrix,
                                         group_by_point)
from dr3_tpu_torch.ba.schur_lm import BAResult
from dr3_tpu_torch.geometry.linalg import inv3x3
from dr3_tpu_torch.parallel.mesh import Mesh, make_mesh


class ShardedProblem(NamedTuple):
    """Host-side partition of a BAProblem over n shards (leading axis)."""

    base: BAProblem              # original (cams, intrinsics, gauge)
    points: np.ndarray           # [n, P_loc, 3]
    obs_cam: np.ndarray          # [n, O_loc]
    obs_pt_local: np.ndarray     # [n, O_loc] indices into the shard's points
    obs_uv: np.ndarray           # [n, O_loc, 2]
    obs_w: np.ndarray            # [n, O_loc]
    point_perm: np.ndarray       # [n * P_loc] original index per padded slot (-1 pad)


def _round_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def partition_problem(p: BAProblem, n_shards: int) -> ShardedProblem:
    """Co-partition points and their observations across shards (vectorized
    host-side pass; obs of point i go to i's shard)."""
    P_tot = p.n_points
    p_loc = -(-P_tot // n_shards)

    pts_np = np.array(_host(p.points), np.float32)
    pad = n_shards * p_loc - P_tot
    points = np.concatenate([pts_np, np.zeros((pad, 3), np.float32)]
                            ).reshape(n_shards, p_loc, 3)
    perm = np.concatenate([np.arange(P_tot, dtype=np.int64),
                           np.full(pad, -1, np.int64)])

    obs_cam = np.array(_host(p.obs_cam))
    obs_pt = np.array(_host(p.obs_pt))
    obs_uv = np.array(_host(p.obs_uv), np.float32)
    obs_w = np.array(_host(p.obs_w), np.float32)
    shard_of_obs = np.clip(obs_pt, 0, P_tot - 1) // p_loc
    # inactive (weight-0) rows spread round-robin so they never skew one
    # shard's capacity
    inactive = obs_w <= 0
    if inactive.any():
        shard_of_obs = shard_of_obs.copy()
        shard_of_obs[inactive] = np.arange(int(inactive.sum())) % n_shards

    counts = np.bincount(shard_of_obs, minlength=n_shards)
    # power-of-two capacity: stable shapes across calls unless load doubles
    o_loc = min(_round_pow2(int(counts.max())), len(obs_cam))
    o_loc = max(o_loc, 1)

    order = np.argsort(shard_of_obs, kind="stable")
    s_sorted = shard_of_obs[order]
    starts = np.searchsorted(s_sorted, np.arange(n_shards))
    pos = np.arange(len(order)) - starts[s_sorted]

    oc = np.zeros((n_shards, o_loc), np.int32)
    op = np.zeros((n_shards, o_loc), np.int32)
    ouv = np.zeros((n_shards, o_loc, 2), np.float32)
    ow = np.zeros((n_shards, o_loc), np.float32)  # padding weight 0
    oc[s_sorted, pos] = obs_cam[order]
    op[s_sorted, pos] = np.clip(obs_pt[order], 0, P_tot - 1) - s_sorted * p_loc
    np.clip(op, 0, p_loc - 1, out=op)
    ouv[s_sorted, pos] = obs_uv[order]
    ow[s_sorted, pos] = obs_w[order]
    return ShardedProblem(base=p, points=points, obs_cam=oc, obs_pt_local=op,
                          obs_uv=ouv, obs_w=ow, point_perm=perm)


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the mesh's ranks (in place; the identity in one
    process)."""
    if mesh.group is not None:
        dist.all_reduce(x, group=mesh.group)
    return x


def _rank_problem(problem: BAProblem, sp: ShardedProblem, mesh: Mesh, dist_arr):
    """This rank's shards as one BAProblem: their points stacked
    [n_local * P_loc, 3], their observation rows sorted by (point,
    camera) key in one table (point ids offset by shard). Returns (local
    problem, the sorted keys, the first row of each shard and the end
    [n_local + 1])."""
    dev = problem.cam_wxyz.device
    lo, hi = mesh.rank * mesh.n_local, (mesh.rank + 1) * mesh.n_local
    S, P_loc = hi - lo, sp.points.shape[1]
    op = sp.obs_pt_local[lo:hi].astype(np.int64) + (np.arange(S) * P_loc)[:, None]
    oc = sp.obs_cam[lo:hi].astype(np.int64)
    key = (op * problem.n_cams + oc).reshape(-1)
    order = np.argsort(key, kind="stable")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    local = problem._replace(
        points=t(sp.points[lo:hi].reshape(-1, 3)),
        obs_cam=t(oc.reshape(-1)[order].astype(np.int32)),
        obs_pt=t(op.reshape(-1)[order].astype(np.int32)),
        obs_uv=t(sp.obs_uv[lo:hi].reshape(-1, 2)[order]),
        obs_w=t(sp.obs_w[lo:hi].reshape(-1)[order]), dist=dist_arr)
    bounds = np.searchsorted(key[order], np.arange(S + 1) * P_loc * problem.n_cams)
    return local, t(key[order]), bounds.tolist()


def _z_blocks(key_sorted: torch.Tensor, bounds: list, n_pts: int, K: int):
    """How this rank builds its S correction Z^T Z under the dense guard
    (Z of P x K x 6 x 3 elements): one Z over all its points where that
    fits, else one Z per shard (as each device of the JAX package builds
    its own), summed in shard order; None where one shard's Z is past the
    guard (the pair table). Each entry: (rows, point offset, points, the
    (point, camera) key reducer, built once per LM run)."""
    n_local = len(bounds) - 1
    P_loc = n_pts // n_local
    if n_pts * K * 6 * 3 <= schur_core._DENSE_W_MAX_ELEMS:
        return [(slice(None), 0, n_pts, _sorted_reducer(key_sorted, n_pts * K, is_sorted=True))]
    if P_loc * K * 6 * 3 > schur_core._DENSE_W_MAX_ELEMS:
        return None
    return [(slice(lo, hi), s * P_loc, P_loc,
             _sorted_reducer(key_sorted[lo:hi] - s * P_loc * K, P_loc * K, is_sorted=True))
            for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]


def _lm_loop(local: BAProblem, key_sorted: torch.Tensor, bounds: list, mesh: Mesh,
             max_iters: int, huber_delta: float, lambda0: float):
    """The JAX package's shard function (dist_ba.py:121-228) over this
    rank's shards: ``max_iters`` LM steps with the one reduction of the
    partial reduced systems per step; nothing read on the host."""
    K = local.n_cams
    n_pts = local.n_points
    dtype, dev = local.points.dtype, local.points.device
    oc, op = local.obs_cam.long(), local.obs_pt.long()
    E = cam_onehot_matrix(oc, K)
    by_cam, _ = _camera_reducer(oc, K, E)
    by_pt = _sorted_reducer(op, n_pts, is_sorted=True)
    zs = _z_blocks(key_sorted, bounds, n_pts, K)
    keep = (~local.cam_fixed).to(dtype).repeat_interleave(6)

    def cost_and_nonfinite(p):
        """[total cost over the ranks, ranks with a non-finite point]."""
        bad = (~torch.isfinite(p.points).all()).to(dtype)
        return _all_reduce(torch.stack([linearize(p, huber_delta).cost, bad]), mesh)

    cost0 = cost_and_nonfinite(local)[0]
    p, lam, best = local, torch.tensor(lambda0, dtype=dtype, device=dev), cost0
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        res = linearize(p, huber_delta)
        active = (p.obs_w > 0) & res.valid
        blocks = assemble_blocks(res.r, res.Jc, res.Jp, oc, op, active, K, n_pts,
                                 cam_onehot=E, point_sorted=True)
        Hpp_inv = inv3x3(_damp(blocks.Hpp, lam))
        WHinv = torch.einsum("ocj,ojl->ocl", blocks.AtB, Hpp_inv[op])
        rhs_corr = by_cam(torch.einsum("ocl,ol->oc", WHinv, blocks.bp[op]))
        if zs is None:
            tbl = group_by_point(op, active, n_pts, K)
            S_corr = _explicit_s_corr(_pad_obs(WHinv), _pad_obs(blocks.AtB), _pad_obs(oc),
                                      tbl, K)
        else:
            S_corr = None
            for rows, p0, n_z, by_key in zs:
                part = _explicit_s_corr_sqrt(Hpp_inv[p0:p0 + n_z], blocks.AtB[rows],
                                             op[rows] - p0, K, n_z, by_key)
                S_corr = part if S_corr is None else S_corr + part
        # the ONE communication step per iteration: the partial reduced
        # systems, packed into one buffer
        parts = (blocks.Hcc, blocks.bc, S_corr, rhs_corr)
        flat = _all_reduce(torch.cat([x.reshape(-1) for x in parts]), mesh)
        Hcc, bc, S_sum, rhs_sum = torch.split(flat, [x.numel() for x in parts])
        dc = _dense_camera_step(S_sum.reshape(K, 6, K, 6), _damp(Hcc.reshape(K, 6, 6), lam),
                                bc - rhs_sum, keep, True).reshape(K, 6)

        u = by_pt(torch.einsum("ocj,oc->oj", blocks.AtB, dc[oc]))       # local, no comms
        dp = torch.einsum("pij,pj->pi", Hpp_inv, blocks.bp - u)
        newp = apply_update(p, dc, dp)
        new_cost, bad = cost_and_nonfinite(newp)
        # nan/inf candidates mask their own observations (cost drops to
        # ~0): require finite parameters on every rank, not just a finite cost
        ok = ((new_cost < best) & torch.isfinite(new_cost) & (bad == 0)
              & torch.isfinite(newp.cam_wxyz).all() & torch.isfinite(newp.cam_t).all())
        p = p._replace(cam_wxyz=torch.where(ok, newp.cam_wxyz, p.cam_wxyz),
                       cam_t=torch.where(ok, newp.cam_t, p.cam_t),
                       points=torch.where(ok, newp.points, p.points))
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9), torch.clamp(lam * 2.0, max=1e6))
        best = torch.where(ok, new_cost, best)
        n_acc = n_acc + ok.to(torch.int32)
    return p, cost0, best, n_acc, lam


def dist_bundle_adjust(problem: BAProblem, n_devices: int | None = None,
                       max_iters: int = 20, huber_delta: float = 5.0,
                       lambda0: float = 1e-3, mesh=None) -> BAResult:
    """Drop-in distributed counterpart of ba.bundle_adjust. ``mesh``
    defaults to ``make_mesh(n_devices)`` on the problem's device. Every
    rank passes the same problem and gets the whole result."""
    dev = problem.cam_wxyz.device
    mesh = mesh or make_mesh(n_devices, device=dev)
    if mesh.device.type != dev.type:
        raise ValueError(f"dist_bundle_adjust: the problem is on {dev}, the mesh on "
                         f"{mesh.device}")
    sp = partition_problem(problem, mesh.size)
    # distortion rides as a plain [5] tensor; zeros reproduce the pure
    # pinhole exactly (radial term = 1, tangential = 0)
    dist_arr = (torch.zeros((5,), dtype=torch.float32, device=dev) if problem.dist is None
                else problem.dist)
    local, key_sorted, bounds = _rank_problem(problem, sp, mesh, dist_arr)
    p, cost0, cost, n_acc, lam = _lm_loop(local, key_sorted, bounds, mesh, max_iters,
                                          float(huber_delta), float(lambda0))
    # gather refined points from every rank: [n * P_loc, 3] in shard order
    pts = p.points.contiguous()
    if mesh.group is not None:
        parts = [torch.empty_like(pts) for _ in range(mesh.world)]
        dist.all_gather(parts, pts, group=mesh.group)
        pts = torch.cat(parts)
    # reassemble points into original order (host)
    flat = _host(pts).reshape(-1, 3)
    pts_out = np.array(_host(problem.points))
    mask = sp.point_perm >= 0
    pts_out[sp.point_perm[mask]] = flat[mask]
    new_prob = problem._replace(cam_wxyz=p.cam_wxyz, cam_t=p.cam_t,
                                points=torch.as_tensor(pts_out).to(dev))
    return BAResult(problem=new_prob, initial_cost=cost0, final_cost=cost,
                    n_accepted=n_acc, lambda_final=lam)
