"""The least time an H100 could take for the work of each hand-written
kernel call, its bound: the larger of the bytes it must move over the
memory rate and the operations it must do over the float32 rate (NVIDIA's
H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s float32 outside the tensor
cores).

A frozen copy of the port's ``dr3_tpu_torch/tools/bounds.py`` with the plain
computations its counting needs (bilinear sampling, the LK steps, the
corner maps), so that the count does not change when the program does:
``perfbench/tests/test_perfbench_frozen.py`` holds it to the original on
the same inputs.

Bytes count each input read once and each output written once. Where a
kernel reads windows of an image, the image bytes are the pixels the
windows of this call touch, each once (the union of their boxes, clamped
to the image as the clamped reads are). Operations are the float
operations the function needs at this call's data, counted per pixel (the
OPS_* constants below, a fused multiply-add as two) and, where the work
depends on the data, at what this call's data needs. K1: per GN step that
the tracks of this call run: the eps-freeze makes every later step a
no-op, so the kernel stops there and so does the count. K3: the half-ring
test on every pixel, the arc minima where it passes, the NMS where there
is a FAST score and the Shi-Tomasi box at the NMS survivors.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

OPS_CELL = 6
OPS_SHARED_SAMPLE = 9
OPS_LK_TEMPLATE = 5 * OPS_SHARED_SAMPLE + 10
OPS_LK_STEP = OPS_SHARED_SAMPLE + 5
OPS_LK_ERR = OPS_SHARED_SAMPLE + 3
OPS_ALIGN_GRAD = 10
OPS_LK_SOLVE = OPS_CELL + 13
OPS_LK_LEVEL = 2 * OPS_CELL + 12
OPS_ALIGN_PROJECT = 43
OPS_ALIGN_REF_PIXEL = 10
OPS_ALIGN_PIXEL = OPS_SHARED_SAMPLE + 7
OPS_ALIGN_POINT = OPS_ALIGN_PROJECT + OPS_CELL + 198
OPS_ALIGN_LM = 300
OPS_CORNER_TEST = 36
OPS_CORNER_ARCS = 169
OPS_CORNER_NMS = 8
OPS_CORNER_BOX = 64 * 8 + 10
OPS_REMAP_COORD = 10
OPS_REMAP_CHANNEL = 9

FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
FAST_ARC = 10


def bound(n_bytes: float, n_ops: float) -> dict:
    """{"bound_ms", "bound_by", "bytes", "ops"} of a call's work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(n_ops)}


# -- plain computations the counts need ------------------------------------

def _corner_index(x0: torch.Tensor, n: int) -> torch.Tensor:
    x0 = torch.nan_to_num(x0.clamp(-1.0, float(n)), nan=-1.0)
    return x0.to(torch.int64)


def bilinear_clamped(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img [H, W] at xy [..., 2] with border-replicated
    reads."""
    H, W = img.shape[:2]
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = _corner_index(x0, W), _corner_index(y0, H)
    x0c, x1c = x0i.clamp(0, W - 1), (x0i + 1).clamp(0, W - 1)
    y0c, y1c = y0i.clamp(0, H - 1), (y0i + 1).clamp(0, H - 1)
    flat = img.reshape(H * W)
    top = flat[y0c * W + x0c] * (1 - wx) + flat[y0c * W + x1c] * wx
    bot = flat[y1c * W + x0c] * (1 - wx) + flat[y1c * W + x1c] * wx
    return top * (1 - wy) + bot * wy


def patch_coords(center: torch.Tensor, half: int) -> torch.Tensor:
    off = torch.arange(-half, half + 1, dtype=center.dtype, device=center.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    return center[:, None, None, :] + torch.stack([ox, oy], dim=-1)[None]


def gn_steps(sample_img, T, gx, gy, guess, iters, eps):
    """(end positions, steps each track ran before its eps-freeze) of the
    2x2 Gauss-Newton loop that K1 runs."""
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
        pos = pos - torch.where(converged[:, None], torch.zeros_like(delta), delta)
        converged = converged | (torch.sum(delta ** 2, dim=-1) < eps * eps)
    return pos, steps


def track_level_steps(img_prev, img_next, pts_prev, guess, half: int, iters: int,
                      eps: float):
    """(end positions, steps) of one LK level on the plain path."""
    coords = patch_coords(pts_prev, half)
    T = bilinear_clamped(img_prev, coords)
    ex, ey = coords.new_tensor([1.0, 0.0]), coords.new_tensor([0.0, 1.0])
    gx = (bilinear_clamped(img_prev, coords + ex) - bilinear_clamped(img_prev, coords - ex)) * 0.5
    gy = (bilinear_clamped(img_prev, coords + ey) - bilinear_clamped(img_prev, coords - ey)) * 0.5
    return gn_steps(lambda p: bilinear_clamped(img_next, patch_coords(p, half)), T, gx, gy,
                    guess, iters, eps)


def template_gradient(t: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy.gradient along ``dim`` with unit spacing (edge_order=1)."""
    n = t.shape[dim]
    upper = t.narrow(dim, 1, 1) - t.narrow(dim, 0, 1)
    lower = t.narrow(dim, n - 1, 1) - t.narrow(dim, n - 2, 1)
    inner = (t.narrow(dim, 2, n - 2) - t.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([upper, inner, lower], dim=dim)


def _border_mask(h: int, w: int, b: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)


def _ring_differences(img: torch.Tensor) -> torch.Tensor:
    x = img * 255.0
    ring = torch.stack([torch.roll(x, shifts=(-dy, -dx), dims=(-2, -1))
                        for dx, dy in FAST_OFFSETS])
    return ring - x[None]


def half_ring_pass_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """5 consecutive (cyclically) of the ring's 8 even positions all
    brighter than I(p)+t or all darker than I(p)-t."""
    d = _ring_differences(img)[0::2]

    def run_of_5(ok):
        run = ok
        for k in range(1, 5):
            run = run & torch.roll(ok, -k, dims=0)
        return run.any(0)

    return run_of_5(d > threshold) | run_of_5(-d > threshold)


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-10 score, 0 for non-corners and the 3-px border."""
    d = _ring_differences(img)

    def arc_score(sign_d):
        ok = sign_d > threshold
        all_ok = ok
        arc_min = sign_d
        for k in range(1, FAST_ARC):
            all_ok = all_ok & torch.roll(ok, -k, dims=0)
            arc_min = torch.minimum(arc_min, torch.roll(sign_d, -k, dims=0))
        return torch.amax(torch.where(all_ok, arc_min, torch.zeros_like(arc_min)), dim=0)

    score = torch.maximum(arc_score(d), arc_score(-d))
    h, w = img.shape[-2:]
    return torch.where(_border_mask(h, w, 3, img.device), score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    neigh = torch.full_like(score, float("-inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                neigh = torch.maximum(neigh, torch.roll(score, (-dy, -dx), (-2, -1)))
    return (score > neigh) & (score > 0)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by the normalised quaternion q (w, x, y, z)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    u = q[..., 1:].expand(v.shape)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + torch.linalg.cross(u, uv, dim=-1))


# -- the bounds ------------------------------------------------------------

def _index(v: torch.Tensor, n: int) -> torch.Tensor:
    v = torch.nan_to_num(v.to(torch.float32), nan=-1.0, posinf=float(n), neginf=-1.0)
    return v.clamp(-1.0, float(n)).floor().clamp(0, n - 1).to(torch.int64)


def touched_pixels(h: int, w: int, x0, y0, x1, y1) -> int:
    """Pixels of an [h, w] image in the union of the boxes [x0, x1] x
    [y0, y1] (inclusive float corners, floored and clamped to the image)."""
    x0, x1 = _index(x0.reshape(-1), w), _index(x1.reshape(-1), w)
    y0, y1 = _index(y0.reshape(-1), h), _index(y1.reshape(-1), h)
    stride = w + 1
    diff = torch.zeros((h + 1) * stride, dtype=torch.int64, device=x0.device)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1 + 1, -1), (y1 + 1, x0, -1), (y1 + 1, x1 + 1, 1)):
        diff.index_add_(0, ys * stride + xs, torch.full_like(ys, sign))
    cover = diff.view(h + 1, stride).cumsum(0).cumsum(1)[:h, :w]
    return int((cover > 0).sum())


def _window_boxes(c: torch.Tensor, lo: int, hi: int):
    f = torch.floor(c)
    return f[:, 0] - lo, f[:, 1] - lo, f[:, 0] + hi, f[:, 1] + hi


def _span_boxes(a: torch.Tensor, b: torch.Tensor, lo: int, hi: int):
    fa, fb = torch.floor(a), torch.floor(b)
    mn, mx = torch.minimum(fa, fb), torch.maximum(fa, fb)
    return mn[:, 0] - lo, mn[:, 1] - lo, mx[:, 0] + hi, mx[:, 1] + hi


def k1_pyramid(pyr_prev, pyr_next, pts, init, half, iters, eps) -> dict:
    """One dr3_lk_pyramid call: each level's template region in prev, the
    region the GN path's windows cover in next, pts / init / valid in,
    pos / ok / err out; operations at the GN steps the tracks run."""
    n = pts.shape[0]
    P = (2 * half + 1) ** 2
    n_bytes = n * (8 + 1 + (0 if init is None else 8)) + n * (8 + 1 + 4)
    n_levels = len(pyr_prev)
    guess = (pts if init is None else init) / (2.0 ** (n_levels - 1))
    steps = 0
    for lvl in range(n_levels - 1, -1, -1):
        pts_l = pts / (2.0 ** lvl)
        pos, lvl_steps = track_level_steps(pyr_prev[lvl], pyr_next[lvl], pts_l, guess, half,
                                           iters, eps)
        hp, wp = pyr_prev[lvl].shape
        h, w = pyr_next[lvl].shape
        n_bytes += 4 * touched_pixels(hp, wp, *_window_boxes(pts_l, half + 1, half + 2))
        n_bytes += 4 * touched_pixels(h, w, *_span_boxes(guess, pos, half, half + 1))
        steps += int(lvl_steps.sum())
        guess = pos * 2.0 if lvl > 0 else pos
    n_ops = (n_levels * n * (P * (OPS_LK_TEMPLATE + OPS_LK_ERR) + OPS_LK_LEVEL)
             + steps * (P * OPS_LK_STEP + OPS_LK_SOLVE))
    return dict(bound(n_bytes, n_ops), steps=steps)


def k1_align(img, templates, start, iters, eps) -> dict:
    """One dr3_lk_align call: the templates, the region the GN path's
    windows cover, pos / valid in, pos / ok / err out."""
    n, W, _ = templates.shape
    half = (W - 1) // 2
    h, w = img.shape
    end, steps = gn_steps(lambda p: bilinear_clamped(img, patch_coords(p, half)), templates,
                          template_gradient(templates, -1), template_gradient(templates, -2),
                          start, iters, eps)
    steps = int(steps.sum())
    n_bytes = templates.numel() * 4 + n * (8 + 1) + n * (8 + 1 + 4)
    n_bytes += 4 * touched_pixels(h, w, *_span_boxes(start, end, half, half + 1))
    n_ops = (n * (W * W * (OPS_ALIGN_GRAD + OPS_LK_ERR) + OPS_LK_LEVEL)
             + steps * (W * W * OPS_LK_STEP + OPS_LK_SOLVE))
    return dict(bound(n_bytes, n_ops), steps=steps)


def k2_sample(img, centers, half: int) -> dict:
    """One dr3_sample_patches call."""
    n = centers.shape[0]
    P = (2 * half + 1) ** 2
    h, w = img.shape
    n_bytes = 4 * touched_pixels(h, w, *_window_boxes(centers, half, half + 1))
    n_bytes += n * 8 + n * P * 4
    return bound(n_bytes, n * (P * OPS_SHARED_SAMPLE + OPS_CELL))


def k2_sparse_align(img_ref, img_cur, pose_ref, pose_init, pose_final, intrinsics,
                    points_w, level: int, half_patch: int, iters: int) -> dict:
    """One dr3_sparse_align call; poses as (wxyz, t), intrinsics (fx, fy,
    cx, cy) at level 0. The LM runs all ``iters`` steps, so the operations
    do not depend on the data."""
    n = points_w.shape[0]
    W = 2 * half_patch + 1
    scale = 1.0 / (2.0 ** level)
    fx, fy, cx, cy = intrinsics

    def project(pose):
        xc = quat_rotate(pose[0], points_w) + pose[1]
        z = xc[:, 2]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        return torch.stack([fx * scale * xc[:, 0] / z + cx * scale,
                            fy * scale * xc[:, 1] / z + cy * scale], -1)

    hr, wr = img_ref.shape
    hc, wc = img_cur.shape
    n_bytes = 4 * touched_pixels(hr, wr, *_window_boxes(project(pose_ref), half_patch + 1,
                                                        half_patch + 2))
    n_bytes += 4 * touched_pixels(hc, wc, *_span_boxes(project(pose_init), project(pose_final),
                                                       half_patch, half_patch + 1))
    n_bytes += n * (12 + 1) + 4 * (2 * 7 + 4) + 4 * 9 + 8
    n_ops = (n * ((W + 2) ** 2 * OPS_SHARED_SAMPLE + OPS_CELL + W * W * OPS_ALIGN_REF_PIXEL
                  + OPS_ALIGN_PROJECT)
             + (iters + 1) * n * (W * W * OPS_ALIGN_PIXEL + OPS_ALIGN_POINT)
             + iters * OPS_ALIGN_LM)
    return bound(n_bytes, n_ops)


def k3_corners(levels, fast_threshold: float) -> dict:
    """One dr3_corner_response call over the images ``levels``."""
    count = dict(pixels=0, candidates=0, scored=0, survivors=0)
    for img in levels:
        h, w = img.shape
        fast = fast_score_map(img, fast_threshold)
        passed = half_ring_pass_map(img, fast_threshold)
        count["pixels"] += h * w
        count["candidates"] += int((passed & _border_mask(h, w, 3, img.device)).sum())
        count["scored"] += int((fast > 0).sum())
        count["survivors"] += int((nms3x3(fast) & _border_mask(h, w, 5, img.device)).sum())
    n_ops = (count["pixels"] * OPS_CORNER_TEST + count["candidates"] * OPS_CORNER_ARCS
             + count["scored"] * OPS_CORNER_NMS + count["survivors"] * OPS_CORNER_BOX)
    return dict(bound(2 * 4 * count["pixels"], n_ops), **count)


def _gather_bytes(img, x, y) -> int:
    h, w = img.shape[:2]
    c = 1 if img.dim() == 2 else img.shape[2]
    x0, y0 = torch.floor(x), torch.floor(y)
    return 4 * c * touched_pixels(h, w, x0, y0, x0 + 1, y0 + 1)


def k4_remap(img, x, y, field_bytes: int, with_valid: bool) -> dict:
    """One dr3_remap call sampling img at (x, y)."""
    n = x.numel()
    c = 1 if img.dim() == 2 else img.shape[2]
    n_bytes = _gather_bytes(img, x, y) + field_bytes + n * 4 * c + (n if with_valid else 0)
    return bound(n_bytes, n * (OPS_REMAP_COORD + c * OPS_REMAP_CHANNEL))
