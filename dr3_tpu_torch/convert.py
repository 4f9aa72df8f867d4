"""Carry state across from the JAX package to the port, as numpy arrays.

The JAX side (a test, a tool) turns its state into plain numpy —
``{name: np.asarray(v) for name, v in state._asdict().items()}`` for a
NamedTuple state, ``(np.asarray(T.wxyz), np.asarray(T.t))`` for an SE3 —
and these functions rebuild the port's tensors from that, so both packages
can compute the same step from the same state. This module never imports
jax or dr3_tpu.

A BAL problem crosses as its fields (:func:`snavely_problem`; back with
:func:`to_numpy`). A ``MonoVO`` snapshot is a dict with the keys
  stage (int, Stage value), frame_idx, kf_count, point_cursor,
  last_kf_tracked, lost_count, n_relocalizations (ints);
  T_cur, T_anchor ((wxyz, t) pairs);
  tracks, kfs, map (field -> array dicts, as the states' fields);
  pyr_prev (list of [H, W] arrays, or None);
  trajectory, traj_local (lists of 4x4 arrays);
and, when the driver runs loop closure,
  loop_db (field -> array dict of a LoopDatabase, or None);
  db_cursor, last_loop_kf, n_loop_closures, n_db_compactions (ints);
  loop_edges (list of (i_slot, j_slot, rel_wxyz [4], rel_t [3])).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from dr3_tpu_torch.ba.problem import BAProblem
from dr3_tpu_torch.geometry.lie import SE3
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.state import KeyframeState, MapState, TrackState

_INT_FIELDS = {"ref_kf", "point", "age", "frame_id", "obs_point", "obs_cam",
               "obs_pt", "kp_point"}
_BOOL_FIELDS = {"valid", "cam_fixed", "kp_has"}


def tensor(a, device="cpu", name: str = "") -> torch.Tensor:
    """numpy -> tensor with the port's dtype convention for field ``name``
    (int32 ids, bool masks, float32 otherwise)."""
    arr = np.asarray(a)
    if name in _BOOL_FIELDS or arr.dtype == np.bool_:
        dtype = torch.bool
    elif name in _INT_FIELDS or np.issubdtype(arr.dtype, np.integer):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.as_tensor(np.array(arr, copy=True), device=device).to(dtype)


def to_numpy(state) -> dict:
    """Port NamedTuple state -> {field: numpy array} (the inverse)."""
    return {k: (None if v is None else v.detach().cpu().numpy())
            for k, v in state._asdict().items()}


def se3(pair, device="cpu") -> SE3:
    wxyz, t = pair
    return SE3(tensor(wxyz, device), tensor(t, device))


def pinhole(fx, fy, cx, cy, dist, width: int, height: int, device="cpu") -> Pinhole:
    return Pinhole.create(width, height, float(fx), float(fy), float(cx),
                          float(cy), tuple(float(v) for v in np.asarray(dist)),
                          device=device)


def _fields(cls, d: Mapping, device):
    return cls(**{k: tensor(d[k], device, k) for k in cls._fields})


def track_state(d: Mapping, device="cpu") -> TrackState:
    return _fields(TrackState, d, device)


def keyframe_state(d: Mapping, device="cpu") -> KeyframeState:
    return _fields(KeyframeState, d, device)


def map_state(d: Mapping, device="cpu") -> MapState:
    return _fields(MapState, d, device)


def loop_database(d: Mapping, device="cpu"):
    from dr3_tpu_torch.pipelines.loop_closure import LoopDatabase

    return _fields(LoopDatabase, d, device)


def ba_problem(d: Mapping, device="cpu") -> BAProblem:
    vals = {k: (None if d.get(k) is None else tensor(d[k], device, k))
            for k in BAProblem._fields}
    return BAProblem(**vals)


def snavely_problem(d: Mapping, device="cpu"):
    """{field: numpy} of a SnavelyProblem -> the port's; the reverse is
    :func:`to_numpy`."""
    from dr3_tpu_torch.ba.snavely import SnavelyProblem

    return _fields(SnavelyProblem, d, device)


def monovo(snapshot: Mapping, cam: Pinhole, cfg, device="cpu", seed: int = 0):
    """A port ``MonoVO`` whose state is the given snapshot (module doc)."""
    from dr3_tpu_torch.pipelines.vo import MonoVO, Stage

    vo = MonoVO(cam, cfg, seed=seed, device=device)
    vo.stage = Stage(int(snapshot["stage"]))
    for k in ("frame_idx", "kf_count", "point_cursor", "last_kf_tracked",
              "lost_count", "n_relocalizations"):
        setattr(vo, k, int(snapshot[k]))
    vo.T_cur = se3(snapshot["T_cur"], device)
    vo.T_anchor = se3(snapshot["T_anchor"], device)
    vo.tracks = track_state(snapshot["tracks"], device)
    vo.kfs = keyframe_state(snapshot["kfs"], device)
    vo.map = map_state(snapshot["map"], device)
    pyr = snapshot.get("pyr_prev")
    vo.pyr_prev = None if pyr is None else [tensor(p, device) for p in pyr]
    vo.trajectory = [np.asarray(m) for m in snapshot.get("trajectory", [])]
    vo._traj_local = [np.asarray(m) for m in snapshot.get("traj_local", [])]
    if snapshot.get("loop_db") is not None:
        vo.loop_db = loop_database(snapshot["loop_db"], device)
        for k in ("db_cursor", "last_loop_kf", "n_loop_closures", "n_db_compactions"):
            setattr(vo, k, int(snapshot[k]))
        vo.loop_edges = [(int(i), int(j), np.asarray(q, np.float32), np.asarray(t, np.float32))
                         for (i, j, q, t) in snapshot["loop_edges"]]
    return vo
