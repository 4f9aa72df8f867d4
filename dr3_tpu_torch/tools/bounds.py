"""The least time an H100 could take for the work of each kernel call, its
bound: the larger of the bytes it must move over the memory rate and the
operations it must do over the float32 rate (NVIDIA's H100 SXM data sheet:
3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores).

Bytes count each input read once and each output written once. Where a
kernel reads windows of an image, the image bytes are the pixels the
windows of this call touch, each once (the union of their boxes, clamped
to the image as the clamped reads are). Operations are the float
operations the function needs at this call's data, counted per pixel (the
OPS_* constants below, a fused multiply-add as two) and, where the work
depends on the data, at what this call's data needs. K1: per GN step that
the tracks of this call run: the eps-freeze makes every later step a
no-op, so the kernel stops there and so does the count, taken from the
plain version's freeze flags. K3: the half-ring test on every pixel, the
arc minima where it passes, the NMS where there is a FAST score and the
Shi-Tomasi box at the NMS survivors, counted on the plain version's maps.
"""

from __future__ import annotations

import torch

from dr3_tpu_torch.ops import corners, lk

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float operations the work needs
# all pixels of a window or patch share its centre's floor and fraction, so
# a sample is its 3 lerps and the cell costs OPS_CELL once per window
OPS_CELL = 6              # 2 floors, 2 fractions, 2 complements
OPS_SHARED_SAMPLE = 9     # 3 lerps of a multiply and a multiply-add
OPS_LK_TEMPLATE = 5 * OPS_SHARED_SAMPLE + 10   # T and 4 neighbours; 2 differences,
                                               # 2 halvings; 3 products summed
OPS_LK_STEP = OPS_SHARED_SAMPLE + 5            # residual, 2 multiply-adds
OPS_LK_ERR = OPS_SHARED_SAMPLE + 3             # residual, |.|, sum
OPS_ALIGN_GRAD = 10                            # 2 differences, 2 halvings, 3 products summed
OPS_LK_SOLVE = OPS_CELL + 13                   # per window and step: the cell, the 2x2
                                               # solve (2 x 2 products, a difference, a
                                               # division), the update, |d|^2
OPS_LK_LEVEL = 2 * OPS_CELL + 12               # per window and level: the template's and
                                               # the error pass's cells, min eigenvalue
# sparse alignment (csrc/sparse_align.cu), H taken per point as J^T G J
OPS_ALIGN_PROJECT = 43    # a point into the image: quaternion rotation 30 (two
                          # cross products of 9, 3 multiply-adds, 3 doublings, 3
                          # sums), translation 3, the |z| guard 2, 2 divisions,
                          # 2 multiply-adds
OPS_ALIGN_REF_PIXEL = 10  # gx, gy (2 differences, 2 halvings) and their 3
                          # products summed into the point's 2x2 G
OPS_ALIGN_PIXEL = OPS_SHARED_SAMPLE + 7   # per pixel and evaluation: the sample,
                                          # the residual, gx r and gy r and r r summed
OPS_ALIGN_POINT = OPS_ALIGN_PROJECT + OPS_CELL + 198   # per point and evaluation:
                          # the patch's cell, the in-front weight 2, J_uv 23
                          # (1/z, x/z, y/z, 4 scaled entries of 8 in all, 6
                          # rotational entries of 12), G J
                          # 36 (12 entries of a product and a multiply-add), the
                          # 21 entries of H at 5 (a product, a multiply-add, the
                          # weight, the sum), the 6 of b at 5, the cost 2
OPS_ALIGN_LM = 300        # per LM step: damping 18, the 6x6 Cholesky factor 91,
                          # both substitutions 72, SE3.exp about 60, the pose
                          # product and its normalisation about 60
# K3 (csrc/detect.cu): a pixel pays for what it is
OPS_CORNER_TEST = 36      # every pixel: scale 1, the 8 even ring differences,
                          # 16 threshold tests, a run of 5 in each sign (4
                          # conjunctions and a test: 2 x 5), either 1
OPS_CORNER_ARCS = 169     # where the test passes: the 8 odd ring differences,
                          # the 16 10-arc minima of each sign by doubling
                          # (pairs, fours, eights and a last pair: 2 x 64),
                          # their maxima (2 x 15), 2 threshold tests, the
                          # larger sign 1
OPS_CORNER_NMS = 8        # where there is a FAST score: the 8 neighbours
OPS_CORNER_BOX = 64 * 8 + 10   # at an NMS survivor: 2 central differences, 3
                          # products and 3 sums at each of the box's 8x8
                          # pixels, min eigenvalue 10
OPS_REMAP_COORD = 10      # 2 floors, 2 fractions, 2 complements, 4 bound tests
OPS_REMAP_CHANNEL = 9     # 6 products, 3 sums
OPS_SPHERICAL = 20        # 2 differences, 2 divisions, 4 sin/cos, 2 products,
                          # 2 products, 2 divisions, 2 sums, 2 guards
OPS_CYLINDRICAL = 16      # the spherical field without sin b, cos b and their
                          # 2 products
OPS_HOMOGRAPHY = 15       # 6 products, 6 sums, 2 divisions, 1 guard


# the reduced camera matrix of BAL (csrc/schur.cu); a factor G_o is 27 floats
OPS_SCHUR_INV3 = 75       # per point, the damped inverse: damping 6, max |entry| 17,
                          # the scale's reciprocal and 9 products 10, adjugate 27,
                          # determinant 5, its reciprocal 1, 9 products
OPS_SCHUR_CHOL3 = 17      # per point, its Cholesky factor: 3 clamps, 3 square roots,
                          # 3 divisions, 4 products, 4 differences
OPS_SCHUR_FACTOR = 180    # per observation: L^T Jp^T for u and v 18, G_o 81 (27
                          # entries of 2 products and a sum), its column squares 45,
                          # their sum into the camera's 9, the scaling 27
OPS_SCHUR_DINV = 9 * 8    # per camera: damping 3, difference, floor 2, square root,
                          # reciprocal, each of 9 columns
OPS_SCHUR_PAIR = 81 * 6   # per pair and entry of its 9x9 block: 3 products, 2 sums
                          # over the factor's rows, the sum into the entry
OPS_SCHUR_DIAG = 81 * 5   # per camera: the damping 2, d_a d_b, the product, the sum


def schur_factor(n_cams: int, n_points: int, n_obs: int) -> dict:
    """dr3_schur_factor: bytes of Hpp9 [P, 9], Hcc's diagonal, the damping,
    the Jacobian columns (24 floats an observation), its point and row ids
    and the camera offsets read once, Hinv9, the factors (27 floats an
    observation) and dinv written once; operations per point, observation
    and camera."""
    K, P, O = n_cams, n_points, n_obs
    n_bytes = 4 * (9 * P + 9 * K + 1 + 24 * O + 2 * O + K + 1 + 9 * P + 27 * O + 9 * K)
    n_ops = P * (OPS_SCHUR_INV3 + OPS_SCHUR_CHOL3) + O * OPS_SCHUR_FACTOR + K * OPS_SCHUR_DINV
    return bound(n_bytes, n_ops)


def schur_blocks(pairs, n_cams: int, n_obs: int) -> dict:
    """dr3_schur_blocks at this call's pairs (ops/schur.py SchurPairs):
    bytes of the scaled factors (27 floats an observation), dinv, Hcc's
    diagonal blocks, the damping, the pairs' two rows and the block offsets
    read once, S [9K, 9K] written once; operations per pair and per camera.
    Also ``l2_bytes``: the two padded rows each pair stages, as the kernel
    loads them."""
    K, O = n_cams, n_obs
    n = int(pairs.qi.shape[0])
    n_bytes = 4 * (27 * O + 9 * K + 81 * K + 1 + 2 * n + K * K + 1 + 81 * K * K)
    n_ops = n * OPS_SCHUR_PAIR + K * OPS_SCHUR_DIAG
    return {**bound(n_bytes, n_ops), "pairs": n, "l2_bytes": 2 * 36 * 4 * n}


# the generic PCG's operator S p (csrc/schur_mv.cu) at BAL's 9 camera parameters
OPS_SCHUR_MV_OBS = 63 + 54   # per observation: the point pass's xk 9, AtB^T xk 27
                             # products and 24 sums, the sum into u 3; the camera
                             # pass's AtB v 27 products and 18 sums, the sum into y 9
OPS_SCHUR_MV_POINT = 15      # per point: Hpp^-1 u, 9 products and 6 sums
OPS_SCHUR_MV_CAM = 199       # per camera: xk 9, Hcc_d xk 81 products and 72 sums, the
                             # difference 9, the blend 27 and 1 - keep


def schur_mv(n_cams: int, n_points: int, n_obs: int, d_pt: int, d_cam: int) -> dict:
    """dr3_schur_mv, both launches: bytes of the coupling blocks (27 floats
    an observation), the observations' camera and point ids and the two
    tables (int64), Hpp^-1, Hcc_d, keep and x read once and y written once;
    operations per observation, point and camera. Also ``two_pass_bytes``
    and ``two_pass_ms``: what the two passes move, the coupling blocks read
    by each (more than L2 holds at BAL's sizes) and the points' v written
    and read once between them."""
    K, P, O = n_cams, n_points, n_obs
    n_bytes = (4 * 27 * O + 8 * 2 * O + 8 * (P * d_pt + K * d_cam) + 4 * 9 * P
               + 4 * (81 + 1 + 9 + 9) * K)
    two_pass = n_bytes + 4 * 27 * O + 4 * 2 * 3 * P
    n_ops = O * OPS_SCHUR_MV_OBS + P * OPS_SCHUR_MV_POINT + K * OPS_SCHUR_MV_CAM
    return {**bound(n_bytes, n_ops), "two_pass_bytes": int(two_pass),
            "two_pass_ms": 1e3 * two_pass / HBM_BYTES_PER_S}


def bound(n_bytes: float, n_ops: float) -> dict:
    """{"bound_ms", "bound_by", "bytes", "ops"} of a call's work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(n_ops)}


def _index(v: torch.Tensor, n: int) -> torch.Tensor:
    """Integer pixel indices clamped to [0, n-1], NaN on the border, as
    common.cuh corner_index and the clamped reads place them."""
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
    """Boxes [floor(c) - lo, floor(c) + hi] around centres c [N, 2]."""
    f = torch.floor(c)
    return f[:, 0] - lo, f[:, 1] - lo, f[:, 0] + hi, f[:, 1] + hi


def _span_boxes(a: torch.Tensor, b: torch.Tensor, lo: int, hi: int):
    """Boxes spanning the windows around a and around b (a GN path)."""
    fa, fb = torch.floor(a), torch.floor(b)
    mn, mx = torch.minimum(fa, fb), torch.maximum(fa, fb)
    return mn[:, 0] - lo, mn[:, 1] - lo, mx[:, 0] + hi, mx[:, 1] + hi


def plain_levels(pyr_prev, pyr_next, pts, init, half, iters, eps):
    """track_pyramid's plain loop, keeping each level's (level, start, end,
    steps): where that level's GN steps began and ended, and how many the
    tracks ran in all."""
    n_levels = len(pyr_prev)
    guess = (pts if init is None else init) / (2.0 ** (n_levels - 1))
    out = []
    for lvl in range(n_levels - 1, -1, -1):
        pos, _, _, steps = lk._track_level_plain(pyr_prev[lvl], pyr_next[lvl],
                                                 pts / (2.0 ** lvl), guess, half, iters,
                                                 eps, with_steps=True)
        out.append((lvl, guess, pos, int(steps.sum())))
        guess = pos * 2.0 if lvl > 0 else pos
    return out


def k1_pyramid(pyr_prev, pyr_next, pts, init, half, iters, eps) -> dict:
    """One dr3_lk_pyramid call (track_pyramid with valid and max_err):
    each level's template region (window + 1 px for the gradients + 1 for
    the bilinear corner) in prev, the region the GN path's windows cover in
    next, pts / init / valid in, pos / ok / err out; operations at the GN
    steps the tracks run (``bound["steps"]``)."""
    n = pts.shape[0]
    P = (2 * half + 1) ** 2
    n_bytes = n * (8 + 1 + (0 if init is None else 8)) + n * (8 + 1 + 4)
    steps = 0
    for lvl, start, end, lvl_steps in plain_levels(pyr_prev, pyr_next, pts, init, half,
                                                   iters, eps):
        hp, wp = pyr_prev[lvl].shape
        h, w = pyr_next[lvl].shape
        n_bytes += 4 * touched_pixels(hp, wp, *_window_boxes(pts / (2.0 ** lvl),
                                                             half + 1, half + 2))
        n_bytes += 4 * touched_pixels(h, w, *_span_boxes(start, end, half, half + 1))
        steps += lvl_steps
    n_ops = (len(pyr_prev) * n * (P * (OPS_LK_TEMPLATE + OPS_LK_ERR) + OPS_LK_LEVEL)
             + steps * (P * OPS_LK_STEP + OPS_LK_SOLVE))
    return dict(bound(n_bytes, n_ops), steps=steps)


def k1_align(img, templates, start, iters, eps) -> dict:
    """One dr3_lk_align call: the templates, the region the GN path's
    windows cover, pos / valid in, pos / ok / err out; operations at the GN
    steps the tracks run (``bound["steps"]``)."""
    n, W, _ = templates.shape
    half = (W - 1) // 2
    h, w = img.shape
    end, *_, steps = lk._solve_2x2_steps(
        lambda p: lk._sample_patches_plain(img, p, half), templates,
        lk._gradient(templates, -1), lk._gradient(templates, -2), start, iters, eps)
    steps = int(steps.sum())
    n_bytes = templates.numel() * 4 + n * (8 + 1) + n * (8 + 1 + 4)
    n_bytes += 4 * touched_pixels(h, w, *_span_boxes(start, end, half, half + 1))
    n_ops = (n * (W * W * (OPS_ALIGN_GRAD + OPS_LK_ERR) + OPS_LK_LEVEL)
             + steps * (W * W * OPS_LK_STEP + OPS_LK_SOLVE))
    return dict(bound(n_bytes, n_ops), steps=steps)


def k2_sample(img, centers, half: int) -> dict:
    """One dr3_sample_patches call: the pixels its patches touch, the
    centres in, the [N, W, W] patches out."""
    n = centers.shape[0]
    P = (2 * half + 1) ** 2
    h, w = img.shape
    n_bytes = 4 * touched_pixels(h, w, *_window_boxes(centers, half, half + 1))
    n_bytes += n * 8 + n * P * 4
    return bound(n_bytes, n * (P * OPS_SHARED_SAMPLE + OPS_CELL))


def k2_sparse_align(img_ref, img_cur, T_ref, T_init, T_final, cam, points_w,
                    level: int, half_patch: int, iters: int) -> dict:
    """One dr3_sparse_align call: the reference level's pixels under the
    (W + 2)^2 patches, the current level's pixels under the W^2 patches
    from the start pose to the final one (the LM path's windows), points,
    valid flags, both poses and the intrinsics in, pose, costs and n_used
    out; operations of the reference stage, of iters + 1 evaluations of the
    normal equations and of iters LM steps (no early exit: the count does
    not depend on the data)."""
    n = points_w.shape[0]
    W = 2 * half_patch + 1
    scale = 1.0 / (2.0 ** level)

    def project(T):
        xc = T.apply(points_w)
        z = xc[:, 2]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        return torch.stack([cam.fx * scale * xc[:, 0] / z + cam.cx * scale,
                            cam.fy * scale * xc[:, 1] / z + cam.cy * scale], -1)

    hr, wr = img_ref.shape
    hc, wc = img_cur.shape
    n_bytes = 4 * touched_pixels(hr, wr, *_window_boxes(project(T_ref), half_patch + 1,
                                                        half_patch + 2))
    n_bytes += 4 * touched_pixels(hc, wc, *_span_boxes(project(T_init), project(T_final),
                                                       half_patch, half_patch + 1))
    n_bytes += n * (12 + 1) + 4 * (2 * 7 + 4) + 4 * 9 + 8
    n_ops = (n * ((W + 2) ** 2 * OPS_SHARED_SAMPLE + OPS_CELL + W * W * OPS_ALIGN_REF_PIXEL
                  + OPS_ALIGN_PROJECT)
             + (iters + 1) * n * (W * W * OPS_ALIGN_PIXEL + OPS_ALIGN_POINT)
             + iters * OPS_ALIGN_LM)
    return bound(n_bytes, n_ops)


def k3_corners(levels, fast_threshold: float) -> dict:
    """One dr3_corner_response call over the images ``levels``: each image
    in, each score map out; operations at what these images need, from the
    plain version's maps: ``bound["pixels"]`` take the half-ring test,
    ``["candidates"]`` pass it (inside FAST's 3-px border) and take the arc
    minima, ``["scored"]`` have a FAST score and take the NMS,
    ``["survivors"]`` pass it (inside the 5-px border) and take the box."""
    count = dict(pixels=0, candidates=0, scored=0, survivors=0)
    for img in levels:
        h, w = img.shape
        fast = corners.fast_score_map(img, fast_threshold)
        passed = corners.half_ring_pass_map(img, fast_threshold)
        count["pixels"] += h * w
        count["candidates"] += int((passed & corners._border_mask(h, w, 3, img.device)).sum())
        count["scored"] += int((fast > 0).sum())
        count["survivors"] += int((corners.nms3x3(fast)
                                   & corners._border_mask(h, w, 5, img.device)).sum())
    n_ops = (count["pixels"] * OPS_CORNER_TEST + count["candidates"] * OPS_CORNER_ARCS
             + count["scored"] * OPS_CORNER_NMS + count["survivors"] * OPS_CORNER_BOX)
    return dict(bound(2 * 4 * count["pixels"], n_ops), **count)


def _gather_bytes(img, x, y, valid=None) -> int:
    """Bytes of the source pixels bilinear samples at (x, y) read: the 2x2
    corners of each sample (of the valid ones, if given), all channels."""
    if valid is not None:
        x, y = x[valid], y[valid]
    h, w = img.shape[:2]
    c = 1 if img.dim() == 2 else img.shape[2]
    x0, y0 = torch.floor(x), torch.floor(y)
    return 4 * c * touched_pixels(h, w, x0, y0, x0 + 1, y0 + 1)


def k4_remap(img, x, y, field_bytes: int, with_valid: bool) -> dict:
    """One dr3_remap call sampling img at (x, y): the pixels it reads, the
    field in, the samples (and validity) out."""
    n = x.numel()
    c = 1 if img.dim() == 2 else img.shape[2]
    n_bytes = _gather_bytes(img, x, y) + field_bytes + n * 4 * c + (n if with_valid else 0)
    return bound(n_bytes, n * (OPS_REMAP_COORD + c * OPS_REMAP_CHANNEL))


def k4_warp(img, x, y, with_valid: bool, ops_coord: int) -> dict:
    """One dr3_warp call whose output pixels sample img at (x, y): the
    pixels the in-image samples read, the warped image (and validity) out;
    ``ops_coord`` the operations of one output pixel's source coordinate."""
    h, w = img.shape[:2]
    n = x.numel()
    c = 1 if img.dim() == 2 else img.shape[2]
    inside = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    n_bytes = _gather_bytes(img, x, y, inside) + n * 4 * c + (n if with_valid else 0)
    return bound(n_bytes, n * (ops_coord + OPS_REMAP_COORD + c * OPS_REMAP_CHANNEL))
