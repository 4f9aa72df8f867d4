"""Synthetic two-plane scene with exact ground truth, numpy only.

A copy of the renderer pieces of the repository's test fixtures
(tests/synth.py: ``make_textures``, ``NpSE3``, ``render_scene``, and the
forward corridor ``corridor_path`` / ``render_corridor``) that
imports neither jax nor dr3_tpu, so the port's smoke run and benchmarks can
render frames on a machine without JAX: a near textured plane inside a far
background plane, by ray-plane intersection + bilinear texture lookup (two
depths break the planar degeneracy of fundamental-matrix initialisation).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def make_textures(rng, size=1600):
    """High-contrast binary-blob textures (FAST-friendly)."""
    def tex():
        base = ndimage.gaussian_filter(rng.uniform(0, 1, (size, size)), 2.5)
        soft = ndimage.gaussian_filter(rng.uniform(0, 1, (size, size)), 1.0)
        return (0.6 * (base > np.median(base)) + 0.4 * soft).astype(np.float32)

    return tex(), tex()


def _np_skew(omega):
    return np.array([[0.0, -omega[2], omega[1]],
                     [omega[2], 0.0, -omega[0]],
                     [-omega[1], omega[0], 0.0]], np.float64)


class NpSE3:
    """World->cam rigid transform (R, t); ``exp`` of a tangent [rho, omega]
    with the left Jacobian, as the package's SE3.exp."""

    def __init__(self, R, t):
        self.R = np.asarray(R, np.float64)
        self.t = np.asarray(t, np.float64)

    @classmethod
    def exp(cls, tangent):
        tangent = np.asarray(tangent, np.float64)
        rho, omega = tangent[:3], tangent[3:]
        theta = float(np.linalg.norm(omega))
        K = _np_skew(omega)
        if theta < 1e-8:
            R = np.eye(3) + K + 0.5 * (K @ K)
            V = np.eye(3) + 0.5 * K + (K @ K) / 6.0
        else:
            A = np.sin(theta) / theta
            B = (1.0 - np.cos(theta)) / theta ** 2
            C = (theta - np.sin(theta)) / theta ** 3
            R = np.eye(3) + A * K + B * (K @ K)
            V = np.eye(3) + B * K + C * (K @ K)
        return cls(R, V @ rho)

    def center(self):
        return (-self.R.T @ self.t).astype(np.float32)


def lateral_path(n_frames, step=0.09, yaw_rate=0.0):
    """Ground-truth world->cam poses sliding along +x (the camera looks down
    +z at the two planes), optionally yawing ``yaw_rate`` rad per frame.
    Returns (poses [n], centres [n, 3])."""
    poses = [NpSE3.exp([-step * i, 0.0, 0.0, 0.0, yaw_rate * i, 0.0])
             for i in range(n_frames)]
    return poses, np.stack([p.center() for p in poses])


def render_scene(cam, T, tex_near, tex_far, z_near=6.0, z_far=14.0,
                 near_halfw=2.2, near_halfh=1.6, px_per_unit=60.0):
    """Render the scene from world->cam pose T (NpSE3) with camera ``cam``
    (anything with fx, fy, cx, cy, width, height)."""
    h, w = cam.height, cam.width
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    R_wc = T.R.astype(np.float32)
    t_wc = T.t.astype(np.float32)
    R = R_wc.T                      # cam->world rotation
    t = -R_wc.T @ t_wc              # camera center in world
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    d_w = d_cam @ R.T

    def plane_hit(z_plane):
        lam = (z_plane - t[2]) / np.where(np.abs(d_w[..., 2]) < 1e-9, 1e-9,
                                          d_w[..., 2])
        return t + lam[..., None] * d_w, lam

    pw_n, lam_n = plane_hit(z_near)
    pw_f, _ = plane_hit(z_far)
    near_mask = (np.abs(pw_n[..., 0]) < near_halfw) & \
        (np.abs(pw_n[..., 1]) < near_halfh) & (lam_n > 0)

    def lookup(tex, pw):
        txy = pw[..., :2] * px_per_unit + np.asarray(tex.shape)[::-1] / 2.0
        th, tw = tex.shape
        x = np.clip(txy[..., 0], 0.0, tw - 1.001)
        y = np.clip(txy[..., 1], 0.0, th - 1.001)
        x0 = x.astype(np.int32)
        y0 = y.astype(np.int32)
        ax = (x - x0).astype(np.float32)
        ay = (y - y0).astype(np.float32)
        v00 = tex[y0, x0]
        v01 = tex[y0, x0 + 1]
        v10 = tex[y0 + 1, x0]
        v11 = tex[y0 + 1, x0 + 1]
        return ((1 - ay) * ((1 - ax) * v00 + ax * v01)
                + ay * ((1 - ax) * v10 + ax * v11))

    img = np.where(near_mask, lookup(tex_near, pw_n), lookup(tex_far, pw_f))
    return img.astype(np.float32)


def scene_points(cam, T, xy, z_near=6.0, z_far=14.0, near_halfw=2.2, near_halfh=1.6):
    """World points [N, 3] (float32) that the pixels xy [N, 2] of the view
    :func:`render_scene` renders from pose T see: each pixel's ray meets
    the near plane inside its rectangle, else the far plane."""
    xy = np.asarray(xy, np.float64)
    fx, fy, cx, cy = (float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    d_w = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy, np.ones(len(xy))], -1) @ T.R
    centre = -T.R.T @ T.t

    def hit(z_plane):
        return centre + ((z_plane - centre[2]) / d_w[:, 2])[:, None] * d_w

    near, far = hit(z_near), hit(z_far)
    on_near = (np.abs(near[:, 0]) < near_halfw) & (np.abs(near[:, 1]) < near_halfh)
    return np.where(on_near[:, None], near, far).astype(np.float32)


# ---------------------------------------------------------------------------
# panorama views: a pinhole camera turning about its y axis inside a
# textured sphere
# ---------------------------------------------------------------------------

def sphere_texture(rng, px_per_rad: float, lon=(-np.pi, np.pi),
                   lat=(-np.pi / 2, np.pi / 2)):
    """Equirectangular RGB texture [h, w, 3] in [0, 1] over the given
    longitude / latitude ranges at ``px_per_rad`` texels per radian: a
    thresholded blob pattern shared by the channels (FAST-friendly, as
    tests/test_stitch_panorama.py scene()) plus fine noise per channel.
    Texel (tx, ty) holds longitude lon[0] + tx / px_per_rad and latitude
    lat[0] + ty / px_per_rad."""
    h = int(np.ceil((lat[1] - lat[0]) * px_per_rad)) + 2
    w = int(np.ceil((lon[1] - lon[0]) * px_per_rad)) + 2
    base = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 4.0)
    binary = (base > np.median(base)).astype(np.float32)
    chans = []
    for gain in (0.75, 0.65, 0.55):
        soft = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 1.5)
        chans.append(gain * binary + (1.0 - gain) * soft)
    return np.stack(chans, axis=-1).astype(np.float32)


def _yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def render_sphere_view(tex, px_per_rad: float, lon0: float, lat0: float,
                       fx: float, fy: float, cx: float, cy: float,
                       width: int, height: int, yaw: float) -> np.ndarray:
    """[height, width, 3] view of a camera at the sphere's centre turned by
    ``yaw`` about y (the view centre looks at longitude ``yaw``). The ray of
    pixel (x, y) goes to longitude / latitude and a bilinear lookup in
    ``tex`` (texel (0, 0) at (lon0, lat0)). Two such views differ by the
    exact homography :func:`sphere_homography`, and after the spherical
    pre-warp with focal fx by a horizontal shift of fx * (yaw difference)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    d = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1) @ _yaw_matrix(yaw).T
    lon = np.arctan2(d[..., 0], d[..., 2])
    lat = np.arctan2(d[..., 1], np.hypot(d[..., 0], d[..., 2]))
    th, tw = tex.shape[:2]
    tx = np.clip((lon - lon0) * px_per_rad, 0.0, tw - 1.001)
    ty = np.clip((lat - lat0) * px_per_rad, 0.0, th - 1.001)
    x0 = tx.astype(np.int64)
    y0 = ty.astype(np.int64)
    ax = (tx - x0)[..., None]
    ay = (ty - y0)[..., None]
    out = ((1 - ay) * ((1 - ax) * tex[y0, x0] + ax * tex[y0, x0 + 1])
           + ay * ((1 - ax) * tex[y0 + 1, x0] + ax * tex[y0 + 1, x0 + 1]))
    return out.astype(np.float32)


def sphere_homography(fx: float, fy: float, cx: float, cy: float, yaw: float) -> np.ndarray:
    """3x3 H = K R_y(yaw) K^-1 taking pixels of the view turned by ``yaw``
    into pixels of the view at yaw 0 (float64)."""
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    return K @ _yaw_matrix(yaw) @ np.linalg.inv(K)


def entry_pair(seed: int = 7):
    """Two consecutive frames for the VO tracking step of
    ``dr3_tpu_torch.entry``: frames 0 and 1 of the lateral path (0.08
    units apart) at 1240x376 with the KITTI camera, a 42 x 13 grid of 546
    tracks on frame 0 and the world points they see. Returns (the two
    frames, the step's inputs after the image as numpy arrays — track_px,
    track_valid, track_point, map_xyz, map_valid, pose_wxyz, pose_t — and
    frame 1's true pose)."""
    from types import SimpleNamespace

    cam = SimpleNamespace(width=1240, height=376, fx=718.856, fy=718.856, cx=607.1928,
                          cy=185.2157)
    tn, tf = make_textures(np.random.default_rng(seed))
    poses, _ = lateral_path(2, step=0.08)
    frames = [render_scene(cam, T, tn, tf) for T in poses]
    xs, ys = np.meshgrid(np.linspace(30, 1210, 42), np.linspace(30, 346, 13))
    px = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    n = px.shape[0]
    inputs = (px, np.ones(n, bool), np.arange(n, dtype=np.int32),
              scene_points(cam, poses[0], px), np.ones(n, bool),
              np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), np.zeros(3, np.float32))
    return frames, inputs, poses[1]


def panorama_views(rng, n: int = 8, width: int = 640, height: int = 480,
                   focal: float = 600.0, yaw: float = 0.35) -> dict:
    """The TRANSLATE panorama case of the benchmark and the smoke run:
    ``n`` RGB views [height, width, 3] of a textured sphere, ``yaw`` rad
    apart, from a camera of focal ``focal`` at the centre (bench.py's
    configuration: 8 views of 640x480, f 600). Returns dict(tex, lon0,
    lat0, views); the texture is drawn from ``rng`` first."""
    lon0, lat0 = -1.0, -0.6
    tex = sphere_texture(rng, focal, lon=(lon0, (n - 1) * yaw + 1.0), lat=(lat0, -lat0))
    views = [render_sphere_view(tex, focal, lon0, lat0, focal, focal, width / 2, height / 2,
                                width, height, yaw * k) for k in range(n)]
    return dict(tex=tex, lon0=lon0, lat0=lat0, views=views)


def _bilinear_periodic(tex, u, v):
    """Periodic (tiled) bilinear texture lookup."""
    th, tw = tex.shape
    x = np.mod(u, tw - 1.001).astype(np.float32)
    y = np.mod(v, th - 1.001).astype(np.float32)
    x0 = x.astype(np.int32)
    y0 = y.astype(np.int32)
    ax = x - x0
    ay = y - y0
    v00 = tex[y0, x0]
    v01 = tex[y0, x0 + 1]
    v10 = tex[y0 + 1, x0]
    v11 = tex[y0 + 1, x0 + 1]
    return ((1 - ay) * ((1 - ax) * v00 + ax * v01)
            + ay * ((1 - ax) * v10 + ax * v11))


def render_corridor(cam, T, tex_ground, tex_wall, ground_y=1.5, wall_x=4.0,
                    px_per_unit=50.0):
    """Render an ENDLESS corridor scene: textured ground plane (y=ground_y,
    +y is down) and two textured side walls (x=±wall_x), tiled periodically
    along the driving direction (+z); rays above the horizon hit a
    featureless sky. Unlike the two-plane lateral scene (render_scene),
    this supports unbounded FORWARD motion with turns — the KITTI-like
    regime where parallax vanishes near the focus of expansion (the
    reference's demonstrated use case, reference README.md:4-5)."""
    h, w = cam.height, cam.width
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    R_wc = T.R.astype(np.float32)
    t_wc = T.t.astype(np.float32)
    R = R_wc.T
    t = -R_wc.T @ t_wc
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    d_w = d_cam @ R.T

    INF = np.float32(1e9)

    def plane(axis, value):
        denom = d_w[..., axis]
        lam = (value - t[axis]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        return np.where(lam > 1e-3, lam, INF).astype(np.float32)

    lams = np.stack([plane(1, ground_y), plane(0, -wall_x),
                     plane(0, wall_x)])
    choice = np.argmin(lams, 0)
    lam = np.min(lams, 0)
    pw = t.astype(np.float32) + lam[..., None] * d_w.astype(np.float32)

    img_g = _bilinear_periodic(tex_ground, pw[..., 0] * px_per_unit,
                               pw[..., 2] * px_per_unit)
    # walls keyed by (z, y); the left wall samples a half-texture offset so
    # the two walls never alias in place recognition
    off = tex_wall.shape[1] / 2.0
    img_l = _bilinear_periodic(tex_wall, pw[..., 2] * px_per_unit + off,
                               pw[..., 1] * px_per_unit)
    img_r = _bilinear_periodic(tex_wall, pw[..., 2] * px_per_unit,
                               pw[..., 1] * px_per_unit)
    img = np.where(choice == 0, img_g, np.where(choice == 1, img_l, img_r))
    img = np.where(lam >= INF, np.float32(0.5), img)  # featureless sky
    return img.astype(np.float32)


def corridor_path(n_frames, step=0.10, curve_amp=0.22, period=240,
                  rot_only_at=0.45, rot_only_len=12, rot_rate=0.02):
    """Forward-dominant ground-truth path down the corridor: S-curve
    heading (yaw = curve_amp*sin(2*pi*i/period), turns up to ~±13 deg) plus
    one ROTATION-ONLY stress segment (position frozen, yaw sweeps
    +rot_rate/frame for rot_only_len frames then back — zero net heading,
    zero parallax while it lasts). Returns (NpSE3 world->cam poses [n],
    centers [n, 3])."""
    poses, centers = [], []
    pos = np.zeros(3, np.float64)
    s0 = int(rot_only_at * n_frames)
    s1 = s0 + rot_only_len
    s2 = s1 + rot_only_len
    extra = 0.0
    for i in range(n_frames):
        base_yaw = curve_amp * np.sin(2.0 * np.pi * i / period)
        if s0 <= i < s1:
            extra += rot_rate
            advance = 0.0
        elif s1 <= i < s2:
            extra -= rot_rate
            advance = 0.0
        else:
            advance = step
        yaw = base_yaw + extra
        d = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        pos = pos + advance * d
        # cam->world = Ry(yaw); world->cam pose (R_wc, t_wc = -R_wc @ c)
        c, s = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        R_wc = R_cw.T
        poses.append(NpSE3(R_wc, -R_wc @ pos))
        centers.append(pos.copy())
    return poses, np.asarray(centers, np.float32)
