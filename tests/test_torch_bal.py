"""Port parity for BAL file I/O (io/bal.py) and the conversions into both
problem layouts: dr3_tpu (JAX on the CPU) vs dr3_tpu_torch (the CPU)."""

import os

import numpy as np

from dr3_tpu.ba.snavely import bal_to_snavely as jbal_to_snavely
from dr3_tpu.ba.snavely import snavely_to_bal as jsnavely_to_bal
from dr3_tpu.io import bal as jbal
from dr3_tpu_torch import convert
from dr3_tpu_torch.ba.snavely import bal_to_snavely, snavely_to_bal
from dr3_tpu_torch.io import bal as tbal
from tests.test_ba import synthetic_ba
from tests.torch_parity import nn, rand_bal, tt


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_save_bal_is_byte_identical_and_loads_in_both(rng, tmp_path):
    """A file written by either package is byte for byte the other's, and
    load_bal gives the same arrays (exactly) in both."""
    d = rand_bal(rng, n_cams=3, n_pts=20, noise=0.5, pt_noise=0.1)
    pt, pj = os.path.join(tmp_path, "t.bal"), os.path.join(tmp_path, "j.bal")
    tbal.save_bal(pt, d)
    jbal.save_bal(pj, jbal.BALData(*d))
    assert _read(pt) == _read(pj)
    for got, want in zip(tbal.load_bal(pj), jbal.load_bal(pt)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tbal.load_bal(pt), d):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_bal_to_problem_matches(rng):
    """bal_to_problem: rotations and translations within 1e-6, points,
    observations and intrinsics exactly as JAX's (float32 either way)."""
    d = rand_bal(rng, n_cams=4, n_pts=30)
    pj = jbal.bal_to_problem(jbal.BALData(*d))
    pt = tbal.bal_to_problem(d, device="cpu")
    for k in ("cam_wxyz", "cam_t"):
        np.testing.assert_allclose(nn(getattr(pt, k)), np.asarray(getattr(pj, k)), atol=1e-6)
    for k in ("points", "intrinsics", "obs_cam", "obs_pt", "obs_uv", "obs_w", "cam_fixed"):
        np.testing.assert_array_equal(nn(getattr(pt, k)), np.asarray(getattr(pj, k)), k)


def test_problem_to_bal_matches(rng):
    """problem_to_bal on the same BAProblem: angle-axis within 1e-6, the rest
    exactly; with ``f`` given too."""
    prob, _, _ = synthetic_ba(rng, n_cams=4, n_pts=30, noise_px=0.3)
    pt = convert.ba_problem({k: None if v is None else np.asarray(v)
                             for k, v in prob._asdict().items()})
    for f in (None, 321.0):
        bj, bt = jbal.problem_to_bal(prob, f), tbal.problem_to_bal(pt, f)
        np.testing.assert_allclose(bt.cam_params[:, :3], bj.cam_params[:, :3], atol=1e-6)
        for got, want in zip(bt[1:], bj[1:]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(bt.cam_params[:, 3:], bj.cam_params[:, 3:])


def test_bal_round_trip_through_a_file(rng, tmp_path):
    """problem_to_bal -> save -> load -> bal_to_problem keeps the cameras
    (1e-5) and points (1e-6) of a zero-principal-point problem."""
    prob, _, _ = synthetic_ba(rng, n_cams=4, n_pts=60)
    prob = prob._replace(intrinsics=prob.intrinsics.at[2:].set(0.0))
    pt = convert.ba_problem({k: None if v is None else np.asarray(v)
                             for k, v in prob._asdict().items()})
    path = os.path.join(tmp_path, "r.bal")
    tbal.save_bal(path, tbal.problem_to_bal(pt))
    back = tbal.bal_to_problem(tbal.load_bal(path), device="cpu")
    np.testing.assert_allclose(nn(back.cam_t), nn(pt.cam_t), atol=1e-5)
    np.testing.assert_allclose(np.abs(nn(back.cam_wxyz) @ nn(pt.cam_wxyz).T).diagonal(), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(nn(back.points), nn(pt.points), atol=1e-6)


def test_bal_to_snavely_round_trip_matches(rng):
    """bal_to_snavely / snavely_to_bal against JAX's: within 1e-6."""
    d = rand_bal(rng, n_cams=5, n_pts=40, pt_noise=0.05)
    pj, pt = jbal_to_snavely(jbal.BALData(*d)), bal_to_snavely(d, device="cpu")
    np.testing.assert_allclose(nn(pt.cam_wxyz), np.asarray(pj.cam_wxyz), atol=1e-6)
    for got, want in zip(snavely_to_bal(pt), jsnavely_to_bal(pj)):
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_negative_z_bal_converts_to_valid_pinhole(rng):
    """BAL's -z cameras become +z pinhole cameras (S-conjugation): every
    observation valid and residuals ~0 in both packages."""
    from dr3_tpu.ba.problem import linearize as jlinearize
    from dr3_tpu_torch.ba.problem import linearize, residuals_only

    pts = np.stack([rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50), rng.uniform(-6, -4, 50)], 1)
    cam = np.zeros((3, 9))
    cam[:, 3] = np.linspace(-0.2, 0.2, 3)
    cam[:, 6] = 500.0
    oc = np.repeat(np.arange(3), 50).astype(np.int32)
    op = np.tile(np.arange(50), 3).astype(np.int32)
    pc = pts[op] + cam[oc, 3:6]
    d = tbal.BALData(cam, pts, oc, op, -500.0 * pc[:, :2] / pc[:, 2:3])
    pt = tbal.bal_to_problem(d, device="cpu")
    assert bool(linearize(pt).valid.all())
    assert bool(np.asarray(jlinearize(jbal.bal_to_problem(jbal.BALData(*d))).valid).all())
    np.testing.assert_allclose(nn(residuals_only(pt)), 0.0, atol=1e-2)


def test_export_bal_matches_the_reference_tool(rng, tmp_path):
    """dr3_tpu_torch/tools/make_real_bal.export_bal against the JAX
    package's tools/make_real_bal.export_bal on the same loop database and
    map (two empty slots, corners without a landmark or on a dead map
    point, points seen once): the same kept cameras, points and
    observations, every kept point seen twice or more, pixels recentred on
    the principal point; camera values within 1e-5, the rest within 1e-6."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from dr3_tpu.pipelines.loop_closure import LoopDatabase as JLoopDatabase
    from dr3_tpu.state import MapState as JMapState
    from dr3_tpu_torch.tools.make_real_bal import export_bal
    from tools.make_real_bal import export_bal as jexport_bal

    C, N, P = 6, 40, 90
    q = rng.normal(0, 0.05, (C, 4)).astype(np.float32)
    q[:, 0] = 1.0
    db = dict(thumb=np.zeros((C, 8), np.float32), kp_desc=np.zeros((C, N, 4), np.float32),
              kp_px=rng.uniform(0, 600, (C, N, 2)).astype(np.float32),
              kp_xyz=np.zeros((C, N, 3), np.float32),
              kp_point=np.where(rng.uniform(size=(C, N)) < 0.8, rng.integers(0, P, (C, N)),
                                -1).astype(np.int32),
              kp_has=np.ones((C, N), bool), wxyz=q / np.linalg.norm(q, axis=1, keepdims=True),
              t=rng.normal(0, 1, (C, 3)).astype(np.float32),
              frame_id=np.arange(C, dtype=np.int32), valid=np.array([1, 1, 0, 1, 1, 0], bool))
    mp = dict(xyz=rng.normal(0, 3, (P, 3)).astype(np.float32), valid=rng.uniform(size=P) < 0.9)
    intr = np.asarray([500.0, 510.0, 320.0, 240.0], np.float32)
    jvo = SimpleNamespace(loop_db=JLoopDatabase(**{k: jnp.asarray(v) for k, v in db.items()}),
                          map=JMapState(**{k: jnp.asarray(v) for k, v in mp.items()}),
                          intr=jnp.asarray(intr), cam=SimpleNamespace(dist=jnp.zeros(5)))
    tvo = SimpleNamespace(loop_db=convert.loop_database(db), map=convert.map_state(mp),
                          intr=tt(intr), cam=SimpleNamespace(dist=tt(np.zeros(5))))
    want = jexport_bal(jvo, os.path.join(tmp_path, "j.bal"))
    got = export_bal(tvo, os.path.join(tmp_path, "t.bal"))
    assert [a.shape for a in got] == [a.shape for a in want]
    assert got.cam_params.shape[0] == 4 and got.obs_cam.shape[0] > 0
    np.testing.assert_allclose(got.cam_params, want.cam_params, rtol=0, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert np.bincount(got.obs_pt).min() >= 2
    assert [a.shape for a in tbal.load_bal(os.path.join(tmp_path, "t.bal"))] == \
        [a.shape for a in got]
