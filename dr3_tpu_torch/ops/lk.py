"""Pyramidal Lucas-Kanade feature tracking (port of dr3_tpu.ops.lk).

Inverse-compositional GN batched over tracks, fixed iteration count with a
per-track convergence freeze; failures are masked, never pruned.

Kernels (csrc/lk.cu, K1; csrc/sample.cu, K2) sit behind four wrappers:

* :func:`track_pyramid` — the whole coarse-to-fine loop in one launch (K1,
  ``dr3_lk_pyramid``);
* :func:`track_level` — one pyramid level, the same kernel with one level;
* :func:`align_to_templates` — refinement against stored [N, W, W]
  templates (K1, ``dr3_lk_align``);
* :func:`sample_patches` — [N, 2] centres -> [N, W, W] clamp-sampled
  patches (K2), used by :func:`extract_patches`; sparse alignment runs the
  same sampler inside its own kernel (ops/sparse_align.py).

Each wrapper runs its plain PyTorch twin (``_*_plain``, the jnp semantics
of dr3_tpu/ops/lk.py) for a CPU tensor; for a CUDA tensor it launches the
kernel or raises. ``<wrapper>.launches`` counts kernel launches.

K1 keeps one track's template, gradients and staged image window,
3 W^2 + (W + 5)^2 float32, in shared memory, so it takes windows up to
:data:`MAX_HALF_WINDOW` (59 on an H100); :func:`_check_window` refuses
larger ones before any launch.

``align_to_templates`` takes its gradients as ``jnp.gradient`` does
(one-sided at the patch border, lk.py:167): the JAX CPU path. The JAX
package's TPU path instead runs the templates through an edge-replicated
atlas image with central differences at the border (lk.py:257-260), so on
a TPU its border gradients differ slightly; the port holds the CPU path.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import torch

from dr3_tpu_torch.ops import _native
from dr3_tpu_torch.ops.warp import bilinear_sample


class TrackResult(NamedTuple):
    pos: torch.Tensor  # [N, 2] tracked positions in the new image (level-0 px)
    ok: torch.Tensor   # [N] bool: converged, in-bounds, well-conditioned
    err: torch.Tensor  # [N] mean |residual| over the window (intensity 0-255)


def _patch_coords(center: torch.Tensor, half: int) -> torch.Tensor:
    """[N, W, W, 2] sample coordinates for WxW patches around centers [N,2]."""
    off = torch.arange(-half, half + 1, dtype=center.dtype, device=center.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    grid = torch.stack([ox, oy], dim=-1)
    return center[:, None, None, :] + grid[None]


def _solve_2x2_steps(sample_img, T, gx, gy, guess, iters, eps):
    """Shared GN loop of the plain versions (lk.py:84-100 / 174-190). Also
    returns the steps each track ran before its freeze ([N] int: K1 stops a
    track there, the later steps of this loop add zero)."""
    gxx = torch.sum(gx * gx, dim=(-2, -1))
    gxy = torch.sum(gx * gy, dim=(-2, -1))
    gyy = torch.sum(gy * gy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    pos = guess
    converged = torch.zeros(guess.shape[0], dtype=torch.bool, device=guess.device)
    steps = torch.zeros(guess.shape[0], dtype=torch.int64, device=guess.device)
    for _ in range(iters):
        steps += ~converged
        r = sample_img(pos) - T
        bx = torch.sum(r * gx, dim=(-2, -1))
        by = torch.sum(r * gy, dim=(-2, -1))
        dx = (gyy * bx - gxy * by) / det_safe
        dy = (gxx * by - gxy * bx) / det_safe
        delta = torch.stack([dx, dy], dim=-1)
        step = torch.where(converged[:, None], torch.zeros_like(delta), delta)
        pos = pos - step
        converged = converged | (torch.sum(delta ** 2, dim=-1) < eps * eps)
    return pos, gxx, gxy, gyy, det, steps


# Dynamic shared memory one block may hold on the H100 (227 KB), and the
# bytes one track of K1 keeps there (csrc/lk.cu warp_floats): its template
# and two gradients (W^2 float32 each) and the staged image window,
# (W + 5)^2 (the (W + 1)^2 a GN step reads, 2 pixels more on each side).
SMEM_PER_BLOCK = 232_448
# the levels one dr3_lk_pyramid launch takes (csrc/lk.cu kMaxLevels)
MAX_LEVELS = 8


def track_smem_bytes(half: int) -> int:
    """Shared memory of one K1 track with a (2 half + 1)^2 window."""
    W = 2 * half + 1
    return 4 * (3 * W * W + (W + 5) ** 2)


MAX_HALF_WINDOW = max(h for h in range(1, 200) if track_smem_bytes(h) <= SMEM_PER_BLOCK)


def _check_window(half: int) -> None:
    """Refuse a window K1 cannot launch: one track's warp needs
    track_smem_bytes(half) of shared memory in a block of at most
    SMEM_PER_BLOCK bytes (the C side launches fewer tracks per block where
    more would not fit)."""
    if not 1 <= half <= MAX_HALF_WINDOW:
        raise ValueError(
            f"half window {half} outside [1, {MAX_HALF_WINDOW}]: K1 keeps "
            f"3 W^2 + (W + 5)^2 float32 per track (W = 2 half + 1) in "
            f"shared memory, at most {SMEM_PER_BLOCK} bytes per block")


def _center_in(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return (pos[:, 0] >= 0) & (pos[:, 1] >= 0) & \
        (pos[:, 0] <= w - 1) & (pos[:, 1] <= h - 1)


# ---------------------------------------------------------------------------
# K1 (a): pyramid tracking
# ---------------------------------------------------------------------------

def _track_level_plain(img_prev, img_next, pts_prev, guess, half_window: int,
                       iters: int, eps: float, min_eig: float = 1e-4,
                       with_steps: bool = False):
    """track_level's plain version; ``with_steps`` appends the GN steps
    each track ran (_solve_2x2_steps)."""
    coords = _patch_coords(pts_prev, half_window)
    T, _ = bilinear_sample(img_prev, coords, clamp=True)
    ex = coords.new_tensor([1.0, 0.0])
    ey = coords.new_tensor([0.0, 1.0])
    gx = (bilinear_sample(img_prev, coords + ex, clamp=True)[0]
          - bilinear_sample(img_prev, coords - ex, clamp=True)[0]) * 0.5
    gy = (bilinear_sample(img_prev, coords + ey, clamp=True)[0]
          - bilinear_sample(img_prev, coords - ey, clamp=True)[0]) * 0.5
    n_px = (2 * half_window + 1) ** 2

    def sample_next(p):
        return bilinear_sample(img_next, _patch_coords(p, half_window), clamp=True)[0]

    pos, gxx, gxy, gyy, det, steps = _solve_2x2_steps(sample_next, T, gx, gy, guess,
                                                      iters, eps)
    tr = gxx + gyy
    min_eig_val = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / n_px
    conditioned = min_eig_val > (min_eig / (255.0 ** 2))
    err = torch.mean(torch.abs(sample_next(pos) - T), dim=(-2, -1)) * 255.0
    h, w = img_next.shape[-2:]
    out = (pos, conditioned & _center_in(pos, h, w), err)
    return (*out, steps) if with_steps else out


def _launch_pyramid(pyr_prev, pyr_next, pts, start, valid, half_window: int,
                    iters: int, eps: float, min_eig: float, max_err: float):
    """One dr3_lk_pyramid launch over the levels (finest first, as the
    pyramids are stored). ``start`` is init (or None: pts), ``valid`` None
    for track_level's ok (conditioned & centre in image). Returns (pos, ok,
    err)."""
    n_levels = len(pyr_prev)
    if not 1 <= n_levels <= MAX_LEVELS or len(pyr_next) != n_levels:
        raise ValueError(f"pyramids of {n_levels} and {len(pyr_next)} levels: K1 takes "
                         f"1 to {MAX_LEVELS} levels, the same number in both")
    _check_window(half_window)
    dev = pyr_next[0].device
    n = pts.shape[0]
    for name, pyr in (("pyr_prev", pyr_prev), ("pyr_next", pyr_next)):
        for lvl, img in enumerate(pyr):
            _native.check(img, f"{name}[{lvl}]", torch.float32, device=dev)
            if img.dim() != 2:
                raise ValueError(f"{name}[{lvl}]: expected [H, W], got {tuple(img.shape)}")
    _native.check(pts, "pts", torch.float32, (n, 2), dev)
    if start is not None:
        _native.check(start, "init", torch.float32, (n, 2), dev)
    if valid is not None:
        _native.check(valid, "valid", torch.bool, (n,), dev)
    levels = (ctypes.c_void_p * (2 * n_levels))(
        *[img.data_ptr() for img in (*pyr_prev, *pyr_next)])
    dims = (ctypes.c_int * (4 * n_levels))(
        *[d for a, b in zip(pyr_prev, pyr_next) for d in (*a.shape, *b.shape)])
    pos = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    err = torch.empty((n,), dtype=torch.float32, device=dev)
    _native.call("dr3_lk_pyramid", n_levels, ctypes.addressof(levels),
                 ctypes.addressof(dims), pts, start, valid, n, half_window, iters,
                 float(eps * eps), float(min_eig / (255.0 ** 2)), float(max_err),
                 pos, ok, err)
    return pos, ok, err


def track_level(img_prev: torch.Tensor, img_next: torch.Tensor,
                pts_prev: torch.Tensor, guess: torch.Tensor, half_window: int,
                iters: int, eps: float, min_eig: float = 1e-4):
    """One pyramid level of inverse-compositional LK.

    img_* [H, W] in [0,1]; pts_prev [N,2] template centers at this level's
    scale; guess [N,2] current position estimates. Returns (pos, ok, err).
    On the card: K1 over one level.
    """
    if not img_next.is_cuda:
        return _track_level_plain(img_prev, img_next, pts_prev, guess,
                                  half_window, iters, eps, min_eig)
    out = _launch_pyramid([img_prev], [img_next], pts_prev, guess, None,
                          half_window, iters, eps, min_eig, 0.0)
    track_level.launches += 1
    return out


track_level.launches = 0


def _track_pyramid_plain(pyr_prev, pyr_next, pts, valid, init, half_window: int,
                         iters: int, eps: float, max_err: float) -> TrackResult:
    n_levels = len(pyr_prev)
    guess = (pts if init is None else init) / (2.0 ** (n_levels - 1))
    ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    err = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    for lvl in range(n_levels - 1, -1, -1):
        pts_l = pts / (2.0 ** lvl)
        pos, ok, err = _track_level_plain(pyr_prev[lvl], pyr_next[lvl], pts_l, guess,
                                          half_window, iters, eps)
        ok_all = ok_all & ok
        guess = pos * 2.0 if lvl > 0 else pos
    ok_final = ok_all & valid & (err < max_err)
    return TrackResult(pos=guess, ok=ok_final, err=err)


def track_pyramid(pyr_prev: List[torch.Tensor], pyr_next: List[torch.Tensor],
                  pts: torch.Tensor, valid: torch.Tensor,
                  init: torch.Tensor | None = None, half_window: int = 15,
                  iters: int = 10, eps: float = 1e-2,
                  max_err: float = 40.0) -> TrackResult:
    """Coarse-to-fine LK over an image pyramid (calcOpticalFlowPyrLK
    parity), coarsest level first. On the card: one K1 launch for all
    levels; on the CPU: one plain :func:`track_level` per level."""
    if not pyr_next[0].is_cuda:
        return _track_pyramid_plain(pyr_prev, pyr_next, pts, valid, init,
                                    half_window, iters, eps, max_err)
    pos, ok, err = _launch_pyramid(
        pyr_prev, pyr_next, pts.contiguous(), None if init is None else init.contiguous(),
        valid.contiguous(), half_window, iters, eps, 1e-4, max_err)
    track_pyramid.launches += 1
    return TrackResult(pos=pos, ok=ok, err=err)


track_pyramid.launches = 0


# ---------------------------------------------------------------------------
# K2: patch sampling
# ---------------------------------------------------------------------------

def _sample_patches_plain(img, centers, half: int):
    return bilinear_sample(img, _patch_coords(centers, half), clamp=True)[0]


def sample_patches(img: torch.Tensor, centers: torch.Tensor,
                   half: int) -> torch.Tensor:
    """[N, 2] centers -> [N, W, W] bilinear patches (W = 2*half+1) with
    edge-clamped borders, as bilinear_sample(clamp=True)."""
    if not img.is_cuda:
        return _sample_patches_plain(img, centers, half)
    dev = img.device
    n = centers.shape[0]
    _native.check(img, "img", torch.float32, device=dev)
    _native.check(centers, "centers", torch.float32, (n, 2), dev)
    if half < 0:
        raise ValueError(f"negative half size {half}")
    W = 2 * half + 1
    out = torch.empty((n, W, W), dtype=torch.float32, device=dev)
    h, w = img.shape
    _native.call("dr3_sample_patches", img, h, w, centers, n, half, out)
    sample_patches.launches += 1
    return out


sample_patches.launches = 0


def extract_patches(img: torch.Tensor, pts: torch.Tensor, half: int) -> torch.Tensor:
    """[N, W, W] clamp-sampled patches around pts (template storage for
    drift-free alignment)."""
    return sample_patches(img, pts, half)


# ---------------------------------------------------------------------------
# K1 (b): template alignment
# ---------------------------------------------------------------------------

def _gradient(t: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.gradient along ``dim`` with unit spacing (edge_order=1)."""
    n = t.shape[dim]
    upper = t.narrow(dim, 1, 1) - t.narrow(dim, 0, 1)
    lower = t.narrow(dim, n - 1, 1) - t.narrow(dim, n - 2, 1)
    inner = (t.narrow(dim, 2, n - 2) - t.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([upper, inner, lower], dim=dim)


def _align_to_templates_plain(img, templates, pos, valid, iters, eps,
                              max_err, max_shift):
    n, W, _ = templates.shape
    half = (W - 1) // 2
    gy_t = _gradient(templates, -2)
    gx_t = _gradient(templates, -1)

    def sample(p):
        return bilinear_sample(img, _patch_coords(p, half), clamp=True)[0]

    pos_r, *_ = _solve_2x2_steps(sample, templates, gx_t, gy_t, pos, iters, eps)
    err = torch.mean(torch.abs(sample(pos_r) - templates), dim=(-2, -1)) * 255.0
    shift = torch.linalg.norm(pos_r - pos, dim=-1)
    h, w = img.shape[-2:]
    ok = valid & _center_in(pos_r, h, w) & (err < max_err) & (shift <= max_shift)
    out_pos = torch.where(ok[:, None], pos_r, pos)
    return TrackResult(pos=out_pos, ok=ok, err=err)


def _launch_align(img, templates, pos, valid, iters: int, eps: float,
                  max_err: float, max_shift: float) -> TrackResult:
    """One dr3_lk_align launch."""
    dev = img.device
    n, W, W2 = templates.shape
    if W != W2 or W % 2 == 0:
        raise ValueError(f"templates must be [N, W, W] with odd W, got "
                         f"{tuple(templates.shape)}")
    half = (W - 1) // 2
    _check_window(half)
    _native.check(img, "img", torch.float32, device=dev)
    _native.check(templates, "templates", torch.float32, device=dev)
    _native.check(pos, "pos", torch.float32, (n, 2), dev)
    _native.check(valid, "valid", torch.bool, (n,), dev)
    pos_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    err = torch.empty((n,), dtype=torch.float32, device=dev)
    h, w = img.shape
    _native.call("dr3_lk_align", img, h, w, templates, pos, valid, n, half,
                 iters, float(eps * eps), float(max_err), float(max_shift),
                 pos_out, ok, err)
    return TrackResult(pos=pos_out, ok=ok, err=err)


def align_to_templates(img: torch.Tensor, templates: torch.Tensor,
                       pos: torch.Tensor, valid: torch.Tensor,
                       iters: int = 8, eps: float = 1e-2,
                       max_err: float = 30.0, max_shift: float = 4.0) -> TrackResult:
    """Refine track positions against *stored* templates (SVO
    'feature_align'): one inverse-compositional GN per track with gradients
    from the template patch; a refinement that fails (off-image, err >=
    max_err, shift > max_shift) keeps the input position."""
    if not img.is_cuda:
        return _align_to_templates_plain(img, templates, pos, valid, iters,
                                         eps, max_err, max_shift)
    res = _launch_align(img, templates, pos, valid, iters, eps, max_err, max_shift)
    align_to_templates.launches += 1
    return res


align_to_templates.launches = 0
