"""Corner detection: dense FAST-10, Shi-Tomasi scoring, 3x3 NMS, grid
bucketing (port of dr3_tpu.ops.corners; reference src/features.cpp:43-98,
src/utils.cpp:282-321).

Images are float32 in [0, 1]; FAST/Shi-Tomasi scale by 255 internally so
thresholds keep the reference's 0-255 units.

:func:`corner_response_pyramid` and its one-level case
:func:`corner_response` are the wrappers of kernel K3 (csrc/detect.cu): for
CUDA images one launch of the fused FAST + NMS + Shi-Tomasi kernel over all
the levels given, for CPU images the plain twin ``where(nms3x3(
fast_score_map), shi_tomasi_map, 0)`` per level — the jnp oracle,
wrap-around rolls included. ``<wrapper>.launches`` counts kernel launches.
:func:`half_ring_pass_map` and :func:`arc_min_doubling` are the plain forms
of the kernel's early rejection and of its arc minima, held against
:func:`fast_score_map` by the CPU tests.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import torch

from dr3_tpu_torch.ops import _native

# FAST-10: 16 offsets (dx, dy) on the radius-3 Bresenham circle, in circular
# order starting at 12 o'clock.
FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
FAST_ARC = 10


def _border_mask(h: int, w: int, b: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)


def _ring_differences(img: torch.Tensor) -> torch.Tensor:
    """[16, H, W] ring pixel minus centre in 0-255 units (wrap-around rolls)."""
    x = img * 255.0
    ring = torch.stack([torch.roll(x, shifts=(-dy, -dx), dims=(-2, -1))
                        for dx, dy in FAST_OFFSETS])
    return ring - x[None]


def arc_min_rolled(sign_d: torch.Tensor) -> torch.Tensor:
    """[16, ...] minimum of each of the 16 contiguous 10-arcs of ring values
    sign_d [16, ...], one roll per arc element (the oracle's form)."""
    arc_min = sign_d
    for k in range(1, FAST_ARC):
        arc_min = torch.minimum(arc_min, torch.roll(sign_d, -k, dims=0))
    return arc_min


def arc_min_doubling(sign_d: torch.Tensor) -> torch.Tensor:
    """The same minima by doubling, as kernel K3 takes them: of 2, 4 and 8
    consecutive ring values, then 8 and the pair after them. ``min`` is
    exact and associative, so this equals :func:`arc_min_rolled` bit for
    bit."""
    m2 = torch.minimum(sign_d, torch.roll(sign_d, -1, dims=0))
    m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
    m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
    return torch.minimum(m8, torch.roll(m2, -8, dims=0))


def half_ring_pass_map(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """Kernel K3's early rejection, [H, W] bool: 5 consecutive (cyclically)
    of the ring's 8 even positions all brighter than I(p)+t or all darker
    than I(p)-t. A contiguous arc of 10 on the 16-ring holds 5 consecutive
    even positions, so every pixel with a FAST score passes; the kernel
    takes the arc minima of the 16-ring only there."""
    d = _ring_differences(img)[0::2]

    def run_of_5(ok):
        run = ok
        for k in range(1, 5):
            run = run & torch.roll(ok, -k, dims=0)
        return run.any(0)

    return run_of_5(d > threshold) | run_of_5(-d > threshold)


def fast_score_map(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """Dense FAST-10 corner score (reference fast_corner_detect_10 +
    fast_corner_score_10, src/features.cpp:55-73): max over contiguous
    10-arcs brighter (darker) than I(p)+t (I(p)-t) of the arc's min
    |I(k)-I(p)|; 0 for non-corners and the 3-px border. 0-255 units."""
    d = _ring_differences(img)

    def arc_score(sign_d):
        ok = sign_d > threshold
        all_ok = ok
        for k in range(1, FAST_ARC):
            all_ok = all_ok & torch.roll(ok, -k, dims=0)
        arc_min = arc_min_rolled(sign_d)
        return torch.amax(torch.where(all_ok, arc_min, torch.zeros_like(arc_min)),
                          dim=0)

    score = torch.maximum(arc_score(d), arc_score(-d))
    h, w = img.shape[-2:]
    return torch.where(_border_mask(h, w, 3, img.device), score,
                       torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Strict max of the 3x3 neighbourhood (fast_nonmax_3x3,
    src/features.cpp:70-73)."""
    neigh = torch.full_like(score, float("-inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = torch.maximum(neigh, torch.roll(score, (-dy, -dx), (-2, -1)))
    return (score > neigh) & (score > 0)


def gradients(img: torch.Tensor):
    """Central differences I(x+1)-I(x-1), unnormalised, in 0-255 units."""
    x = img * 255.0
    dx = torch.roll(x, -1, dims=-1) - torch.roll(x, 1, dims=-1)
    dy = torch.roll(x, -1, dims=-2) - torch.roll(x, 1, dims=-2)
    return dx, dy


def _box_sum8(x: torch.Tensor) -> torch.Tensor:
    """Sum over the 8x8 box [y-4, y+4) x [x-4, x+4) (utils.cpp:293-314)."""
    def axis_sum(v, dim):
        out = torch.zeros_like(v)
        for o in range(-4, 4):
            out = out + torch.roll(v, -o, dims=dim)
        return out

    return axis_sum(axis_sum(x, -1), -2)


def shi_tomasi_map(img: torch.Tensor) -> torch.Tensor:
    """Dense Shi-Tomasi min-eigenvalue score (utils.cpp:282-321: 8x8 box of
    central-difference gradients, normalised by 2*box_area); 0 within 5 px
    of the border."""
    dx, dy = gradients(img)
    box_area = 64.0
    dxx = _box_sum8(dx * dx) / (2.0 * box_area)
    dyy = _box_sum8(dy * dy) / (2.0 * box_area)
    dxy = _box_sum8(dx * dy) / (2.0 * box_area)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    score = 0.5 * (tr - disc)
    h, w = img.shape[-2:]
    return torch.where(_border_mask(h, w, 5, img.device), score,
                       torch.zeros_like(score))


def _corner_response_plain(img: torch.Tensor, fast_threshold: float) -> torch.Tensor:
    st = shi_tomasi_map(img)
    return torch.where(nms3x3(fast_score_map(img, fast_threshold)), st,
                       torch.zeros_like(st))


# the levels one dr3_corner_response launch takes (csrc/detect.cu kMaxLevels)
MAX_LEVELS = 8


def corner_response_pyramid(levels: Sequence[torch.Tensor],
                            fast_threshold: float) -> List[torch.Tensor]:
    """Per-level responses [H_l, W_l] of the images ``levels``: Shi-Tomasi
    score at NMS-surviving FAST corners, zero elsewhere. CUDA images: kernel
    K3 over all levels in one launch (a tile list over levels); CPU images:
    the plain version per level."""
    if not levels[0].is_cuda:
        return [_corner_response_plain(img, fast_threshold) for img in levels]
    outs = _launch_response(levels, fast_threshold)
    corner_response_pyramid.launches += 1
    return outs


corner_response_pyramid.launches = 0


def corner_response(img: torch.Tensor, fast_threshold: float) -> torch.Tensor:
    """One level's response [H, W] (kernel K3 over one level on a CUDA
    image)."""
    if not img.is_cuda:
        return _corner_response_plain(img, fast_threshold)
    out, = _launch_response([img], fast_threshold)
    corner_response.launches += 1
    return out


corner_response.launches = 0


def _launch_response(levels: Sequence[torch.Tensor], fast_threshold: float):
    """One dr3_corner_response launch over ``levels``; returns their outputs."""
    n = len(levels)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{n} levels: K3 takes 1 to {MAX_LEVELS} in one launch")
    dev = levels[0].device
    for lvl, img in enumerate(levels):
        _native.check(img, f"levels[{lvl}]", torch.float32, device=dev)
        if img.dim() != 2:
            raise ValueError(f"levels[{lvl}]: expected [H, W], got {tuple(img.shape)}")
    outs = [torch.empty_like(img) for img in levels]
    imgs_p = (ctypes.c_void_p * n)(*[img.data_ptr() for img in levels])
    outs_p = (ctypes.c_void_p * n)(*[out.data_ptr() for out in outs])
    dims = (ctypes.c_int * (2 * n))(*[d for img in levels for d in img.shape])
    _native.call("dr3_corner_response", n, ctypes.addressof(imgs_p), ctypes.addressof(dims),
                 float(fast_threshold), ctypes.addressof(outs_p))
    return outs


class GridCorners(NamedTuple):
    """One corner slot per grid cell (SoA; fixed capacity = n_cells)."""

    xy: torch.Tensor      # [n_cells, 2] level-0 pixel coords
    level: torch.Tensor   # [n_cells] pyramid level of detection
    score: torch.Tensor   # [n_cells] Shi-Tomasi score
    valid: torch.Tensor   # [n_cells] bool

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum()


def detect_features(pyramid: List[torch.Tensor], cell_size: int = 30,
                    detection_threshold: float = 20.0,
                    fast_threshold: float = 20.0,
                    occupancy: Optional[torch.Tensor] = None) -> GridCorners:
    """FastDetector::detect parity (src/features.cpp:43-98), dense: per
    level response -> nearest-upsampled to level 0 -> per-pixel max with
    the winning level -> best corner per grid cell. ``occupancy``
    [n_cells] True blocks a cell."""
    h0, w0 = pyramid[0].shape[-2:]
    dev = pyramid[0].device
    n_cols = -(-w0 // cell_size)
    n_rows = -(-h0 // cell_size)
    n_cells = n_rows * n_cols

    score0 = torch.zeros((h0, w0), dtype=torch.float32, device=dev)
    level0 = torch.zeros((h0, w0), dtype=torch.int32, device=dev)
    responses = corner_response_pyramid(pyramid, fast_threshold)
    for lvl, score in enumerate(responses):
        scale = 1 << lvl
        if lvl > 0:
            score = score.repeat_interleave(scale, 0).repeat_interleave(scale, 1)
            score = score[:h0, :w0]
            ph = h0 - score.shape[0]
            pw = w0 - score.shape[1]
            if ph or pw:
                score = torch.nn.functional.pad(score, (0, pw, 0, ph))
        better = score > score0
        level0 = torch.where(better, torch.full_like(level0, lvl), level0)
        score0 = torch.maximum(score0, score)

    H = n_rows * cell_size
    W = n_cols * cell_size
    score_p = torch.nn.functional.pad(score0, (0, W - w0, 0, H - h0))
    level_p = torch.nn.functional.pad(level0, (0, W - w0, 0, H - h0))
    cells = score_p.reshape(n_rows, cell_size, n_cols, cell_size) \
        .permute(0, 2, 1, 3).reshape(n_cells, cell_size * cell_size)
    lcells = level_p.reshape(n_rows, cell_size, n_cols, cell_size) \
        .permute(0, 2, 1, 3).reshape(n_cells, cell_size * cell_size)

    best_in_cell = torch.argmax(cells, dim=1)   # first maximum, as jnp
    best_score = torch.gather(cells, 1, best_in_cell[:, None])[:, 0]
    best_level = torch.gather(lcells, 1, best_in_cell[:, None])[:, 0]

    cell_idx = torch.arange(n_cells, dtype=torch.int32, device=dev)
    cell_row = cell_idx // n_cols
    cell_col = cell_idx % n_cols
    in_y = best_in_cell.to(torch.int32) // cell_size
    in_x = best_in_cell.to(torch.int32) % cell_size
    py = (cell_row * cell_size + in_y).to(torch.float32)
    px = (cell_col * cell_size + in_x).to(torch.float32)
    scale_f = torch.bitwise_left_shift(torch.ones_like(best_level), best_level) \
        .to(torch.float32)
    px = torch.floor(px / scale_f) * scale_f
    py = torch.floor(py / scale_f) * scale_f

    found = best_score > detection_threshold
    if occupancy is not None:
        found = found & ~occupancy
    return GridCorners(xy=torch.stack([px, py], -1), level=best_level,
                       score=torch.where(found, best_score,
                                         torch.zeros_like(best_score)),
                       valid=found)


def make_occupancy(xy: torch.Tensor, valid: torch.Tensor, img_hw, cell_size: int) -> torch.Tensor:
    """[n_cells] bool occupancy from existing feature pixels
    (Detector::flag_grid, src/features.cpp:23-27)."""
    h, w = img_hw
    n_cols = -(-w // cell_size)
    n_rows = -(-h // cell_size)
    n_cells = n_rows * n_cols

    def to_int(v):
        # jnp float->int32 truncates toward zero; NaN slots are invalid
        return torch.nan_to_num(v, nan=0.0).clamp(-2.0 ** 30, 2.0 ** 30) \
            .to(torch.int32)

    cell = (to_int(xy[:, 1]) // cell_size) * n_cols + (to_int(xy[:, 0]) // cell_size)
    cell = cell.clamp(0, n_cells - 1).long()
    occ = torch.zeros((n_cells,), dtype=torch.bool, device=xy.device)
    occ[cell[valid]] = True
    return occ
