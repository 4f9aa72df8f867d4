"""Helpers for the port's parity tests (tests/test_torch_*.py): the same
numpy inputs go to a ``dr3_tpu`` function (JAX on the CPU, ``highest``
matmul precision, set by conftest.py) and to its ``dr3_tpu_torch``
counterpart (PyTorch on the CPU, the kernels' plain twins); arrays cross
between the two as numpy."""

import numpy as np
import torch

# the tests run as several xdist workers; one intra-op thread per worker
# keeps torch from oversubscribing the cores the JAX tests share
torch.set_num_threads(1)


def tt(a, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (float32 unless bool/int or given)."""
    arr = np.asarray(a)
    if dtype is None:
        if arr.dtype == np.bool_:
            dtype = torch.bool
        elif np.issubdtype(arr.dtype, np.integer):
            dtype = torch.int32
        else:
            dtype = torch.float32
    return torch.as_tensor(np.array(arr, copy=True)).to(dtype)


def nn(x) -> np.ndarray:
    """tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tse3(T):
    """dr3_tpu SE3 -> port SE3."""
    from dr3_tpu_torch.geometry.lie import SE3

    return SE3(tt(T.wxyz), tt(T.t))


# ---------------------------------------------------------------------------
# sparse-alignment cases, numpy only: the CPU parity tests hand them to the
# JAX package and the port, the card tests to the kernel and its plain
# version
# ---------------------------------------------------------------------------

SPARSE_ALIGN_CASES = ("nominal", "all_invalid", "few_usable", "behind_camera",
                      "outside_image", "iters0", "far_init", "level0", "level2")


def sparse_align_case(name: str, n: int = 120) -> dict:
    """Inputs of one sparse_align call on the rendered two-plane scene
    (dr3_tpu_torch.utils.synth; a 320x240 camera, the images smoothed and
    averaged down to ``level``; seeded by the case's name, so every test of
    a case sees the same scene): numpy arrays ``img_ref``, ``img_cur``,
    ``T_ref`` / ``T_init`` as (wxyz [4], t [3]), ``points`` [n, 3],
    ``valid`` [n], the camera's ``intrinsics`` (width, height, fx, fy, cx,
    cy) and ``level``, ``half_patch``, ``iters``. The cases a one-launch
    kernel must reproduce: every point invalid; fewer than 20 usable;
    points behind the current camera and on its |z| < 1e-9 guard;
    projections off the image (edge clamp); no LM step; a start so far off
    that LM steps are rejected; levels 0 and 2."""
    import zlib

    from scipy import ndimage

    from dr3_tpu_torch.models.camera import Pinhole
    from dr3_tpu_torch.utils import synth

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    intrinsics = (320, 240, 260.0, 260.0, 160.0, 120.0)
    cam = Pinhole.create(*intrinsics)
    level = {"level0": 0, "level2": 2}.get(name, 1)
    tn, tf = synth.make_textures(rng, size=900)
    T_ref = synth.NpSE3.exp(np.zeros(6))
    T_cur = synth.NpSE3.exp([-0.05, 0.02, 0.04, 0.003, -0.004, 0.002])

    def view(T):
        img = ndimage.gaussian_filter(synth.render_scene(cam, T, tn, tf), 2.0)
        for _ in range(level):
            h, w = img.shape
            img = img.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
        return np.ascontiguousarray(img, np.float32)

    xy = np.stack([rng.uniform(30, 290, n), rng.uniform(30, 210, n)], -1)
    if name == "outside_image":
        # some reference pixels within a patch of the border (ref_in False
        # at the level's scale) and some that leave the current image
        xy[:15] = np.stack([rng.uniform(0, 3, 15), rng.uniform(0, 240, 15)], -1)
        xy[15:30] = np.stack([rng.uniform(4, 10, 15), rng.uniform(4, 10, 15)], -1)
    points = synth.scene_points(cam, T_ref, xy)
    valid = np.ones(n, bool)
    valid[:10] = name == "outside_image"
    if name == "all_invalid":
        valid[:] = False
    elif name == "few_usable":
        valid[12:] = False
        valid[:12] = True
    elif name == "behind_camera":
        # behind both cameras; in front of the reference but behind the start
        # pose (which stands 0.2 further along z); on the |z| < 1e-9 guard
        points[10:14, 2] = -3.0
        points[14:18] = [0.01, -0.01, 0.1]
        points[18] = [0.3, 0.2, 0.0]
        points[19] = [0.3, 0.2, 5e-10]
    init = np.zeros(6)
    if name == "far_init":
        init = np.array([0.45, -0.3, 0.3, 0.03, 0.05, -0.04])
    elif name == "behind_camera":
        init = np.array([0.0, 0.0, -0.2, 0.0, 0.0, 0.0])
    Ti = synth.NpSE3.exp(init)

    def quat_t(T):
        # small rotations only: w is the largest component
        R = T.R
        w = 0.5 * np.sqrt(1.0 + np.trace(R))
        q = [w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w)]
        return np.asarray(q, np.float32), T.t.astype(np.float32)

    return dict(img_ref=view(T_ref), img_cur=view(T_cur), T_ref=quat_t(T_ref),
                T_init=quat_t(Ti), points=points, valid=valid, intrinsics=intrinsics,
                level=level, half_patch=2, iters=0 if name == "iters0" else 12)


# ---------------------------------------------------------------------------
# a window-style BA problem, numpy only (the card tests have no JAX)
# ---------------------------------------------------------------------------

def ba_case(seed: int, n_cams: int = 6, n_pts: int = 120, noise_px: float = 0.5) -> dict:
    """The fields of a BAProblem as numpy arrays: cameras on an arc over a
    point cloud (tests/test_ba.py's synthetic_ba), every camera sees every
    point, two gauge-fixed cameras, every seventh observation padding,
    perturbed initial poses and points."""
    from dr3_tpu_torch.ba.problem import project
    from dr3_tpu_torch.geometry.lie import SE3

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 16, n_pts)], -1).astype(np.float32)
    taus = np.zeros((n_cams, 6), np.float32)
    taus[:, 0] = 0.4 * np.arange(n_cams)
    taus[:, 1] = 0.02 * np.arange(n_cams)
    taus[:, 4] = 0.015 * np.arange(n_cams)
    cams = SE3.exp(torch.as_tensor(taus))
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    intr = np.asarray([500.0, 500.0, 320.0, 240.0], np.float32)
    xc = cams[torch.as_tensor(obs_cam).long()].apply(torch.as_tensor(pts)[obs_pt])
    uv = project(torch.as_tensor(intr), xc).numpy()
    uv = (uv + rng.normal(0, noise_px, uv.shape)).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.02, (n_cams, 3)), rng.normal(0, 0.01, (n_cams, 3))],
                       -1).astype(np.float32)
    d[:2] = 0.0
    cams0 = SE3.exp(torch.as_tensor(d)) @ cams
    w = np.ones(obs_cam.shape[0], np.float32)
    w[::7] = 0.0
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    return dict(cam_wxyz=cams0.wxyz.numpy(), cam_t=cams0.t.numpy(),
                points=pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
                intrinsics=intr, obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv, obs_w=w,
                cam_fixed=fixed, dist=None)


# ---------------------------------------------------------------------------
# BAL problems, numpy only (a copy of tests/test_snavely.py's generator)
# ---------------------------------------------------------------------------

def snavely_np(cam9, X, uv):
    """Independent numpy evaluation of the BAL residual (ba.cc:105-118)."""
    from scipy.spatial.transform import Rotation

    aa, t, f, k1, k2 = cam9[:3], cam9[3:6], cam9[6], cam9[7], cam9[8]
    p = Rotation.from_rotvec(aa).as_matrix() @ X + t
    q = -p[:2] / p[2]
    r2 = float(q @ q)
    dist = 1.0 + k1 * r2 + k2 * r2 * r2
    return f * dist * q - uv


def rand_bal(rng, n_cams=4, n_pts=60, noise=0.0, pt_noise=0.0, k_radial=True):
    """The port's BALData of a random scene: cameras along x with small
    rotations, per-camera focals and radial terms, every camera seeing
    every point (down -z), pixel noise ``noise``, points perturbed by
    ``pt_noise``."""
    from dr3_tpu_torch.io.bal import BALData

    pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(-8, -4, n_pts)], 1)
    cam = np.zeros((n_cams, 9))
    cam[:, 0] = rng.normal(0, 0.02, n_cams)      # small angle-axis
    cam[:, 3] = np.linspace(-0.5, 0.5, n_cams)
    cam[:, 4] = rng.normal(0, 0.1, n_cams)
    cam[:, 6] = rng.uniform(400, 600, n_cams)    # per-camera focals
    if k_radial:
        cam[:, 7] = rng.uniform(-0.1, 0.1, n_cams)
        cam[:, 8] = rng.uniform(-0.01, 0.01, n_cams)
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.stack([snavely_np(cam[c], pts[p], np.zeros(2))
                   for c, p in zip(obs_cam, obs_pt)])
    uv += rng.normal(0, noise, uv.shape)
    return BALData(cam, pts + pt_noise * rng.normal(size=pts.shape), obs_cam, obs_pt, uv)
