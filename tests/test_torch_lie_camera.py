"""The port's SO3 / SE3 group operations, the camera's unprojection and
bounds check, and KeyframeState's pose view, held against the JAX package
on the CPU: the same seeded numpy inputs through both, atol 1e-6. Round
trips against the truth keep tests/test_camera.py's tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.geometry.lie import SE3 as JSE3
from dr3_tpu.geometry.lie import SO3 as JSO3
from dr3_tpu.models.camera import Pinhole as JPinhole
from dr3_tpu.state import KeyframeState as JKeyframeState
from dr3_tpu_torch.geometry.lie import SE3, SO3
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.state import KeyframeState

ATOL = 1e-6
DIST = (-0.28, 0.07, 1e-4, -2e-4, 0.0)      # tests/test_camera.py's distortion


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _both(a):
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("op", ["identity", "apply", "inverse", "compose", "normalize"])
def test_so3_matches_jax(op):
    rng = np.random.default_rng(0)
    (q1, jq1), (q2, jq2) = _both(_unit_quats(rng, 8)), _both(_unit_quats(rng, 8))
    v, jv = _both(rng.normal(size=(8, 3)).astype(np.float32))
    a, b, ja, jb = SO3(q1), SO3(q2), JSO3(jq1), JSO3(jq2)
    if op == "identity":
        got, want = SO3.identity((3, 2)), JSO3.identity((3, 2))
        _close(got.wxyz, want.wxyz)
        assert got.batch_shape == want.batch_shape == (3, 2)
        _close(got.apply(v[:6].reshape(3, 2, 3)), v[:6].reshape(3, 2, 3).numpy())
    elif op == "apply":
        _close(a.apply(v), ja.apply(jv))
    elif op == "inverse":
        _close(a.inverse().wxyz, ja.inverse().wxyz)
        _close(a.inverse().apply(a.apply(v)), v.numpy(), atol=1e-5)
    elif op == "compose":
        _close((a @ b).wxyz, (ja @ jb).wxyz)
        _close((a @ b).matrix(), a.matrix() @ b.matrix(), atol=1e-5)
    else:
        scaled, jscaled = _both(2.5 * q1.numpy())
        _close(SO3(scaled).normalize().wxyz, JSO3(jscaled).normalize().wxyz)
    assert a.batch_shape == ja.batch_shape == (8,)
    assert repr(a).startswith("SO3(wxyz=")


def _poses(rng, n):
    q = _unit_quats(rng, n)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return (SE3(torch.from_numpy(q), torch.from_numpy(t)),
            JSE3(jnp.asarray(q), jnp.asarray(t)))


@pytest.mark.parametrize("op", ["retract", "from_rotation_translation", "matrix34"])
def test_se3_matches_jax(op):
    rng = np.random.default_rng(1)
    T, JT = _poses(rng, 8)
    if op == "retract":
        delta, jdelta = _both((0.1 * rng.normal(size=(8, 6))).astype(np.float32))
        got = T.retract(delta)
        for a, b in ((got.wxyz, JT.retract(jdelta).wxyz), (got.t, JT.retract(jdelta).t)):
            _close(a, b)
        want = SE3.exp(delta) @ T
        assert torch.equal(got.wxyz, want.wxyz) and torch.equal(got.t, want.t)
    elif op == "from_rotation_translation":
        R = SO3.exp(torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))).matrix()
        t, jt = _both(rng.normal(size=(8, 3)).astype(np.float32))
        got = SE3.from_rotation_translation(R, t)
        want = JSE3.from_rotation_translation(jnp.asarray(R.numpy()), jt)
        _close(got.wxyz, want.wxyz)
        _close(got.t, want.t)
        _close(got.rotation().matrix(), R.numpy(), atol=1e-5)
    else:
        _close(T.matrix34(), JT.matrix34())
        _close(T.matrix34(), T.matrix()[..., :3, :].numpy())
    assert T.batch_shape == JT.batch_shape == (8,)
    assert repr(T[0]).startswith("SE3(wxyz=")


def _cams(distorted: bool):
    d = DIST if distorted else (0.0,) * 5
    args = (640, 480, 500.0, 500.0, 320.0, 240.0)
    return Pinhole.create(*args, d=d), JPinhole.create(*args, d=d)


@pytest.mark.parametrize("distorted", [False, True])
def test_cam2world_and_undistort_match_jax_and_round_trip(distorted):
    rng = np.random.default_rng(2)
    cam, jcam = _cams(distorted)
    assert bool(cam.has_distortion) == bool(jcam.has_distortion) == distorted
    xyz = np.stack([rng.uniform(-1.5, 1.5, 50), rng.uniform(-1.0, 1.0, 50),
                    rng.uniform(2.0, 8.0, 50)], axis=-1).astype(np.float32)
    px = cam.world2cam(torch.from_numpy(xyz))
    f = cam.cam2world(px)
    assert f.shape == (50, 3)
    _close(f, jcam.cam2world(jnp.asarray(px.numpy())))
    dirs = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    _close(f, dirs, atol=1e-3 if distorted else 1e-4)
    xy, jxy = _both(rng.uniform(-0.4, 0.4, size=(200, 2)).astype(np.float32))
    xyd, jxyd = cam.distort(xy), jcam.distort(jxy)
    _close(xyd, jxyd)
    for iters in (8, 10):
        _close(cam.undistort(xyd, iters=iters), jcam.undistort(jxyd, iters=iters))
    _close(cam.undistort(xyd, iters=10), xy.numpy(), atol=1e-4)


@pytest.mark.parametrize("level,boundary", [(0, 0.0), (2, 0.0), (0, 20.0), (2, 3.0)])
def test_is_in_frame_matches_jax(level, boundary):
    cam, jcam = Pinhole.kitti(), JPinhole.kitti()
    rng = np.random.default_rng(3)
    edges = np.array([[10.0, 10.0], [1239.0, 375.0], [-1.0, 5.0], [700.0, 200.0],
                      [310.0, 94.0], [309.9, 93.9], [20.0, 20.0], [1220.0, 356.0]], np.float32)
    px = np.concatenate([edges, rng.uniform(-50, 1300, size=(64, 2)).astype(np.float32)])
    got = cam.is_in_frame(torch.from_numpy(px), boundary, level)
    want = np.asarray(jcam.is_in_frame(jnp.asarray(px), boundary, level))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    _close(cam.error2(2.0), jcam.error2(2.0))


def test_keyframe_state_poses_and_n():
    rng = np.random.default_rng(4)
    k, n = 6, 5
    fields = dict(wxyz=_unit_quats(rng, k), t=rng.normal(size=(k, 3)).astype(np.float32),
                  frame_id=np.arange(k, dtype=np.int32),
                  valid=np.array([True, False, True, True, False, True]),
                  obs_px=np.zeros((k, n, 2), np.float32),
                  obs_point=np.full((k, n), -1, np.int32))
    kfs = KeyframeState(**{f: torch.from_numpy(v) for f, v in fields.items()})
    jkfs = JKeyframeState(**{f: jnp.asarray(v) for f, v in fields.items()})
    assert int(kfs.n) == int(jkfs.n) == 4
    P, JP = kfs.poses(), jkfs.poses()
    assert isinstance(P, SE3) and P.batch_shape == (k,)
    _close(P.wxyz, JP.wxyz)
    _close(P.center(), JP.center())
    empty = KeyframeState.empty(3, n)
    assert int(empty.n) == int(JKeyframeState.empty(3, n).n) == 0
    _close(empty.poses().wxyz, JKeyframeState.empty(3, n).poses().wxyz)
