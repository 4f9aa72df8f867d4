"""World state as fixed-capacity struct-of-arrays (port of dr3_tpu.state).

* ``TrackState``: one slot per detection-grid cell;
* ``KeyframeState``: ring of keyframe poses + a snapshot of the track table
  at keyframe creation (the BA observation table);
* ``MapState``: landmark positions + liveness.

NamedTuples of tensors with the JAX package's field names, shapes and
dtypes (int32 ids, bool masks, float32 values), updated functionally.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr3_tpu_torch.geometry.lie import SE3


class TrackState(NamedTuple):
    px: torch.Tensor        # [N, 2] current-frame pixel position
    ref_px: torch.Tensor    # [N, 2] pixel in the originating keyframe
    ref_kf: torch.Tensor    # [N] keyframe slot where the track started
    point: torch.Tensor     # [N] map point id, -1 = not yet triangulated
    age: torch.Tensor       # [N] frames since spawn
    valid: torch.Tensor     # [N] bool
    ref_patch: torch.Tensor # [N, A, A] template captured at the last keyframe

    @classmethod
    def empty(cls, n: int, patch: int = 9, device="cpu") -> "TrackState":
        f32, i32 = torch.float32, torch.int32
        return cls(px=torch.zeros((n, 2), dtype=f32, device=device),
                   ref_px=torch.zeros((n, 2), dtype=f32, device=device),
                   ref_kf=torch.zeros((n,), dtype=i32, device=device),
                   point=torch.full((n,), -1, dtype=i32, device=device),
                   age=torch.zeros((n,), dtype=i32, device=device),
                   valid=torch.zeros((n,), dtype=torch.bool, device=device),
                   ref_patch=torch.zeros((n, patch, patch), dtype=f32,
                                         device=device))

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum()


class KeyframeState(NamedTuple):
    wxyz: torch.Tensor      # [K, 4] T_f_w rotations (world -> frame)
    t: torch.Tensor         # [K, 3]
    frame_id: torch.Tensor  # [K] source frame index, -1 = empty slot
    valid: torch.Tensor     # [K] bool
    obs_px: torch.Tensor    # [K, N, 2] track pixels at keyframe creation
    obs_point: torch.Tensor # [K, N] map point id per track slot (-1 none)

    @classmethod
    def empty(cls, k: int, n_tracks: int, device="cpu") -> "KeyframeState":
        wxyz = torch.zeros((k, 4), dtype=torch.float32, device=device)
        wxyz[:, 0] = 1.0
        return cls(wxyz=wxyz,
                   t=torch.zeros((k, 3), dtype=torch.float32, device=device),
                   frame_id=torch.full((k,), -1, dtype=torch.int32,
                                       device=device),
                   valid=torch.zeros((k,), dtype=torch.bool, device=device),
                   obs_px=torch.zeros((k, n_tracks, 2), dtype=torch.float32,
                                      device=device),
                   obs_point=torch.full((k, n_tracks), -1, dtype=torch.int32,
                                        device=device))

    def poses(self) -> SE3:
        return SE3(self.wxyz, self.t)

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum()


class MapState(NamedTuple):
    xyz: torch.Tensor       # [P, 3] world positions
    valid: torch.Tensor     # [P] bool

    @classmethod
    def empty(cls, p: int, device="cpu") -> "MapState":
        return cls(xyz=torch.zeros((p, 3), dtype=torch.float32, device=device),
                   valid=torch.zeros((p,), dtype=torch.bool, device=device))

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum()

    def n_observations(self, kfs: KeyframeState) -> torch.Tensor:
        """Total live observations (Map::n_observations, src/map.cpp:21-26)."""
        return ((kfs.obs_point >= 0) & kfs.valid[:, None]).sum()


def compact_map(map_state: MapState, keep: torch.Tensor):
    """Compress live map points to the front of the capacity array;
    survivors are renumbered densely in id order.

    Returns (compacted MapState, new_id [P] int32 with -1 for dropped,
    n_live). Remap every id table through ``remap_point_ids(ids, new_id)``.
    The destinations of kept points are distinct, so the scatter is
    deterministic on every device.
    """
    keep = keep & map_state.valid
    new_id = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0) - 1,
                         torch.full_like(keep, -1, dtype=torch.int32))
    new_id = new_id.to(torch.int32)
    dest = new_id[keep].long()
    xyz = torch.zeros_like(map_state.xyz)
    xyz[dest] = map_state.xyz[keep]
    valid = torch.zeros_like(map_state.valid)
    valid[dest] = True
    return MapState(xyz=xyz, valid=valid), new_id, keep.sum()


def remap_point_ids(ids: torch.Tensor, new_id: torch.Tensor) -> torch.Tensor:
    """Rewrite a point-id table (-1 = none) through a compaction mapping."""
    safe = torch.clamp(ids, 0, new_id.shape[0] - 1).long()
    return torch.where(ids >= 0, new_id[safe],
                       torch.full_like(ids, -1)).to(torch.int32)
