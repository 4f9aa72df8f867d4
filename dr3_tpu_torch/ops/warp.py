"""Bilinear sampling and dense image warps (port of dr3_tpu.ops.warp):
remap, perspective / affine warp, spherical and cylindrical projection
(reference src/utils.cpp:125-272, src/stitch.cpp:73-74,
src/panorama.cpp:192).

``bilinear_sample`` is the plain PyTorch reference of every sampler in the
port: the LK and patch kernels (csrc/lk.cu, csrc/sample.cu) are held
against it, and so is kernel K4 (csrc/warp.cu), whose wrappers live here:

* :func:`remap_xy`, :func:`remap_rows`, :func:`remap_cols` — a given
  coordinate field, as (x, y) pairs, rows only or columns only
  (``dr3_remap``; the last two carry the contracts of the TPU kernels
  warp_pallas.py remap_rows / remap_cols);
* :func:`warp_perspective`, :func:`warp_spherical`,
  :func:`warp_cylindrical` — the kernel computes each output pixel's source
  coordinate itself (``dr3_warp``).

Each wrapper runs its plain version (``_*_plain``) for a CPU tensor; for a
CUDA tensor it launches the kernel or raises. ``<wrapper>.launches`` counts
kernel launches. The kernel is bit-exact against the plain version on the
card. It equals direct bilinear sampling: the JAX package's TPU two-pass
warps and their capacity checks have no counterpart (dr3_tpu/ops/warp.py's
``*_auto`` dispatchers collapse into this rule).

The plain field functions divide by the focal length as a tensor on the
image's device: PyTorch divides a CUDA tensor by a Python scalar as a
multiplication by its reciprocal, which the CPU and the kernel do not.
"""

from __future__ import annotations

import numpy as np
import torch

from dr3_tpu_torch.geometry.homography import apply_homography
from dr3_tpu_torch.ops import _native

_REMAP_XY, _REMAP_ROWS, _REMAP_COLS = 0, 1, 2
_HOMOGRAPHY, _SPHERICAL, _CYLINDRICAL = 0, 1, 2


def _corner_index(x0: torch.Tensor, n: int) -> torch.Tensor:
    """floor()'d coordinate -> int64 index, safe for any float input.

    ``jnp``'s float->int32 conversion followed by ``clip(i, 0, n-1)`` and
    ``clip(i+1, 0, n-1)``: clamping the float to [-1, n] first gives the
    same clipped corners for every finite coordinate, and keeps NaN and
    huge values from an undefined conversion (they land on the border and
    the caller's validity test rejects them)."""
    x0 = torch.nan_to_num(x0.clamp(-1.0, float(n)), nan=-1.0)
    return x0.to(torch.int64)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor, fill: float = 0.0,
                    clamp: bool = False):
    """Sample img [H, W] or [H, W, C] at xy [..., 2] (x=col, y=row).

    Returns (values [..., C?], valid [...]): samples outside [0, W-1] x
    [0, H-1] get ``fill`` unless ``clamp`` (border-replicate; valid still
    reports out-of-bounds)."""
    H, W = img.shape[:2]
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = _corner_index(x0, W)
    y0i = _corner_index(y0, H)
    valid = (x >= 0) & (y >= 0) & (x <= W - 1) & (y <= H - 1)
    x0c = x0i.clamp(0, W - 1)
    x1c = (x0i + 1).clamp(0, W - 1)
    y0c = y0i.clamp(0, H - 1)
    y1c = (y0i + 1).clamp(0, H - 1)
    flat = img.reshape((H * W,) + img.shape[2:])
    v00 = flat[y0c * W + x0c]
    v01 = flat[y0c * W + x1c]
    v10 = flat[y1c * W + x0c]
    v11 = flat[y1c * W + x1c]
    if img.dim() == 3:
        wx, wy, vmask = wx[..., None], wy[..., None], valid[..., None]
    else:
        vmask = valid
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    if not clamp:
        out = torch.where(vmask, out, torch.full_like(out, fill))
    return out, valid


def output_grid(h: int, w: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[h, w, 2] grid of (x, y) pixel coordinates."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


# ---------------------------------------------------------------------------
# K4 launch helpers
# ---------------------------------------------------------------------------

def _check_image(img: torch.Tensor) -> int:
    """Validate a kernel source image [H, W] or [H, W, C]; returns C."""
    _native.check(img, "img", torch.float32)
    if img.dim() not in (2, 3) or img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError(f"img: expected a non-empty [H, W] or [H, W, C] image, "
                         f"got {tuple(img.shape)}")
    return 1 if img.dim() == 2 else img.shape[2]


def _outputs(img: torch.Tensor, shape, with_valid: bool):
    out = torch.empty(tuple(shape) + tuple(img.shape[2:]), dtype=torch.float32,
                      device=img.device)
    valid = torch.empty(tuple(shape), dtype=torch.bool, device=img.device) \
        if with_valid else None
    return out, valid


def _launch_remap(img, mode, field, ho, wo, clamp, fill, out, valid):
    c = _check_image(img)
    h, w = img.shape[:2]
    _native.call("dr3_remap", img, h, w, c, mode, field, ho, wo, int(clamp),
                 float(fill), out, valid)


def _launch_warp(img, kind, params, ho, wo, fill, out, valid):
    c = _check_image(img)
    h, w = img.shape[:2]
    p = [float(v) for v in params] + [0.0] * (9 - len(params))
    _native.call("dr3_warp", img, h, w, c, kind, *p, ho, wo, float(fill), out, valid)


# ---------------------------------------------------------------------------
# remaps over a given field (dr3_remap)
# ---------------------------------------------------------------------------

def remap_xy(img: torch.Tensor, xy: torch.Tensor, fill: float = 0.0,
             clamp: bool = False):
    """bilinear_sample(img, xy, fill, clamp) -> (values [..., C?], valid
    [...]); for a CUDA image the K4 remap kernel over the (x, y) field."""
    if not img.is_cuda:
        return bilinear_sample(img, xy, fill=fill, clamp=clamp)
    _native.check(xy, "xy", torch.float32, device=img.device)
    if xy.dim() == 0 or xy.shape[-1] != 2:
        raise ValueError(f"xy: expected [..., 2], got {tuple(xy.shape)}")
    lead = xy.shape[:-1]
    out, valid = _outputs(img, lead, True)
    _launch_remap(img, _REMAP_XY, xy, int(np.prod(lead, dtype=np.int64)), 1,
                  clamp, fill, out, valid)
    remap_xy.launches += 1
    return out, valid


remap_xy.launches = 0


def remap(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
          fill: float = 0.0) -> torch.Tensor:
    """cv::remap parity (src/utils.cpp:189-194): out[i,j] = img(v[i,j], u[i,j])."""
    out, _ = remap_xy(img, torch.stack([u, v], dim=-1), fill=fill)
    return out


def _remap_rows_plain(src, v):
    gx = torch.arange(v.shape[1], dtype=v.dtype, device=v.device).expand_as(v)
    return bilinear_sample(src, torch.stack([gx, v], dim=-1), clamp=True)[0]


def _remap_cols_plain(src, u):
    gy = torch.arange(u.shape[0], dtype=u.dtype, device=u.device)[:, None].expand_as(u)
    return bilinear_sample(src, torch.stack([u, gy], dim=-1), clamp=True)[0]


def remap_rows(src: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[i, j] = bilinear row-sample src[v[i, j], j], border-replicated
    (the contract of warp_pallas.py remap_rows, K4a). src [H, W] or
    [H, W, C]; v [Ho, W] row coordinates."""
    if v.dim() != 2 or v.shape[1] != src.shape[1]:
        raise ValueError(f"v: expected [Ho, {src.shape[1]}], got {tuple(v.shape)}")
    if not src.is_cuda:
        return _remap_rows_plain(src, v)
    _native.check(v, "v", torch.float32, device=src.device)
    out, _ = _outputs(src, v.shape, False)
    _launch_remap(src, _REMAP_ROWS, v, v.shape[0], v.shape[1], True, 0.0, out, None)
    remap_rows.launches += 1
    return out


remap_rows.launches = 0


def remap_cols(src: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """out[i, j] = bilinear column-sample src[i, u[i, j]], border-replicated
    (the contract of warp_pallas.py remap_cols, K4b). src [H, W] or
    [H, W, C]; u [H, Wo] column coordinates."""
    if u.dim() != 2 or u.shape[0] != src.shape[0]:
        raise ValueError(f"u: expected [{src.shape[0]}, Wo], got {tuple(u.shape)}")
    if not src.is_cuda:
        return _remap_cols_plain(src, u)
    _native.check(u, "u", torch.float32, device=src.device)
    out, _ = _outputs(src, u.shape, False)
    _launch_remap(src, _REMAP_COLS, u, u.shape[0], u.shape[1], True, 0.0, out, None)
    remap_cols.launches += 1
    return out


remap_cols.launches = 0


# ---------------------------------------------------------------------------
# warps that compute their own field (dr3_warp)
# ---------------------------------------------------------------------------

def homography_inverse(H) -> np.ndarray:
    """H^-1 of a 3x3 homography (numpy or tensor) as host float32 numpy:
    the plain version and the kernel both sample through these nine
    numbers. It is geometry.linalg.inv3x3's f32 adjugate, op for op (the
    JAX warp inverts with inv3x3; an f64 inverse moves canvas samples by
    3e-5), computed in numpy so that a warp costs no small torch ops."""
    if isinstance(H, torch.Tensor):
        H = H.detach().cpu().numpy()
    m = np.asarray(H, dtype=np.float32)
    scale = max(np.float32(np.abs(m).max()), np.float32(1e-30))
    (a, b, c), (d, e, f), (g, h, i) = m / scale
    A, B, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * C
    if abs(det) < 1e-20:
        det = np.sign(det) * np.float32(1e-20) + np.float32(1e-20)
    adj = np.array([[A, -(b * i - c * h), b * f - c * e],
                    [B, a * i - c * g, -(a * f - c * d)],
                    [C, -(a * h - b * g), a * e - b * d]], np.float32)
    return adj / (det * scale)


def _warp_perspective_plain(img, Hinv, out_hw, fill):
    oh, ow = out_hw
    grid = output_grid(oh, ow, device=img.device)
    src_xy = apply_homography(torch.as_tensor(Hinv, device=img.device), grid)
    return bilinear_sample(img, src_xy, fill=fill)


def warp_perspective(img: torch.Tensor, H, out_hw: tuple[int, int],
                     fill: float = 0.0):
    """cv::warpPerspective parity: map *src* through H (3x3, numpy or
    tensor) into a canvas of out_hw; output pixel p gets img(H^-1 p).
    Returns (warped [Ho, Wo, C?], valid [Ho, Wo])."""
    Hinv = homography_inverse(H)
    if not img.is_cuda:
        return _warp_perspective_plain(img, Hinv, out_hw, fill)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out, valid = _outputs(img, (oh, ow), True)
    _launch_warp(img, _HOMOGRAPHY, Hinv.ravel().tolist(), oh, ow, fill, out, valid)
    warp_perspective.launches += 1
    return out, valid


warp_perspective.launches = 0


def warp_affine(img: torch.Tensor, M, out_hw: tuple[int, int], fill: float = 0.0):
    """cv::warpAffine parity with a 2x3 forward map M (inverted internally)."""
    M = M.detach().cpu().numpy() if isinstance(M, torch.Tensor) else np.asarray(M)
    H = np.concatenate([M.astype(np.float32), np.array([[0.0, 0.0, 1.0]], np.float32)])
    return warp_perspective(img, H, out_hw, fill=fill)


def _angles(h: int, w: int, f: float, device):
    grid = output_grid(h, w, device=device)
    fd = torch.tensor(f, dtype=torch.float32, device=device)
    return (grid[..., 0] - 0.5 * w) / fd, (grid[..., 1] - 0.5 * h) / fd


def _project(xhat, yhat, zhat, h: int, w: int, f: float):
    zhat = torch.where(zhat.abs() < 1e-9, torch.full_like(zhat, 1e-9), zhat)
    return 0.5 * w + f * xhat / zhat, 0.5 * h + f * yhat / zhat


def spherical_warp_field(h: int, w: int, f: float, device="cpu"):
    """Inverse-warp field of the spherical projection
    (compute_spherical_warping, src/utils.cpp:125-187): output pixel (j, i)
    -> angles ((j - w/2)/f, (i - h/2)/f) -> unit sphere -> perspective
    divide. Returns (u, v), each [h, w]."""
    xf, yf = _angles(h, w, f, device)
    cy = torch.cos(yf)
    return _project(torch.sin(xf) * cy, torch.sin(yf), torch.cos(xf) * cy, h, w, f)


def cylindrical_warp_field(h: int, w: int, f: float, device="cpu"):
    """compute_cylindrical_warping parity (src/utils.cpp:204-271): cylinder
    point (sin th, height, cos th) with th = (j - w/2)/f, height = (i - h/2)/f."""
    theta, height = _angles(h, w, f, device)
    return _project(torch.sin(theta), height, torch.cos(theta), h, w, f)


def _warp_field(img, kind, f):
    field = spherical_warp_field if kind == _SPHERICAL else cylindrical_warp_field
    u, v = field(img.shape[0], img.shape[1], f, device=img.device)
    return bilinear_sample(img, torch.stack([u, v], dim=-1))[0]


def _warp_projection(img, kind, f):
    out, _ = _outputs(img, img.shape[:2], False)
    _launch_warp(img, kind, [f], img.shape[0], img.shape[1], 0.0, out, None)
    return out


def warp_spherical(img: torch.Tensor, f: float) -> torch.Tensor:
    """warp_spherical parity (src/utils.cpp:196-201): img [H, W, C?] through
    the spherical field of its own size; 0 outside the source."""
    if not img.is_cuda:
        return _warp_field(img, _SPHERICAL, f)
    out = _warp_projection(img, _SPHERICAL, f)
    warp_spherical.launches += 1
    return out


warp_spherical.launches = 0


def warp_cylindrical(img: torch.Tensor, f: float) -> torch.Tensor:
    """The cylindrical counterpart of :func:`warp_spherical`."""
    if not img.is_cuda:
        return _warp_field(img, _CYLINDRICAL, f)
    out = _warp_projection(img, _CYLINDRICAL, f)
    warp_cylindrical.launches += 1
    return out


warp_cylindrical.launches = 0
