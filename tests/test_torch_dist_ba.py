"""Port parity for the point-sharded distributed BA
(dr3_tpu_torch.parallel.dist_ba, parallel.mesh) against the JAX package's
on its 8 virtual CPU devices (tests/conftest.py). A port mesh of n shards
in one process stands for JAX's n devices: the same partition, the same LM
schedule, one reduction of the partial reduced systems per step.

Tolerances: initial cost rtol 1e-5 (the same residuals summed in another
order), final cost rtol 1e-4. These problems fix one camera, so their
scale is free: near the optimum float32 round-off (here: one intra-op
thread against several) moves every camera along it, and whether a step at the optimum lowers
the cost is float noise (5 against 7 accepted of 10 seen). After 3 steps
the runs agree step for step (the same accepted steps and lambda, cam_t
within 1e-4); after 8-10 steps final cost rtol 1e-4 and cam_t within
1e-3 (1.7e-4 measured)."""

import numpy as np
import pytest
import torch

from dr3_tpu.parallel import dist_ba as jdist
from dr3_tpu.parallel.mesh import make_mesh_2d as j_mesh_2d
from dr3_tpu_torch.parallel import dist_ba as tdist
from dr3_tpu_torch.parallel import mesh as tmesh
from tests.test_ba import DIST, synthetic_ba
from tests.test_torch_ba import _both
from tests.torch_parity import nn


def _check(res_t, res_j, converged=True):
    np.testing.assert_allclose(float(res_t.initial_cost), float(res_j.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(res_t.final_cost), float(res_j.final_cost),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(nn(res_t.problem.cam_t), nn(res_j.problem.cam_t),
                               atol=1e-3 if converged else 1e-4)
    if not converged:
        assert int(res_t.n_accepted) == int(res_j.n_accepted)
        np.testing.assert_allclose(float(res_t.lambda_final), float(res_j.lambda_final),
                                   rtol=1e-5)


@pytest.mark.parametrize("n_pts,n_shards", [(50, 4), (103, 8), (1, 3)])
def test_partition_is_bit_equal(n_pts, n_shards):
    """partition_problem copies the JAX host numpy: every array bit-equal,
    padding and round-robin inactive rows included."""
    prob, *_ = synthetic_ba(np.random.default_rng(n_pts), n_cams=4, n_pts=n_pts)
    w = np.asarray(prob.obs_w).copy()
    w[::5] = 0.0
    pj, pt = _both(prob, obs_w=w)
    sj, st = jdist.partition_problem(pj, n_shards), tdist.partition_problem(pt, n_shards)
    for name in ("points", "obs_cam", "obs_pt_local", "obs_uv", "obs_w", "point_perm"):
        a, b = getattr(st, name), getattr(sj, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_dist_matches_jax(n_dev):
    prob, *_ = synthetic_ba(np.random.default_rng(11), n_cams=5, n_pts=96, noise_px=0.3)
    pj, pt = _both(prob)
    for iters in (3, 10):
        rj = jdist.dist_bundle_adjust(pj, n_devices=n_dev, max_iters=iters)
        rt = tdist.dist_bundle_adjust(pt, n_devices=n_dev, max_iters=iters)
        _check(rt, rj, converged=iters > 3)
        np.testing.assert_allclose(nn(rt.problem.points), nn(rj.problem.points),
                                   atol=1e-3 if iters == 3 else 1e-2)


def test_dist_with_distortion_matches_jax():
    prob, cams_true, _ = synthetic_ba(np.random.default_rng(12), n_cams=5, n_pts=96, dist=DIST)
    pj, pt = _both(prob)
    rj = jdist.dist_bundle_adjust(pj, n_devices=4, max_iters=10)
    rt = tdist.dist_bundle_adjust(pt, n_devices=4, max_iters=10)
    _check(rt, rj)
    assert float(rt.final_cost) < float(rt.initial_cost) * 1e-3


def test_dist_uneven_points_matches_jax():
    # a point count not divisible by the shard count exercises the padding
    prob, *_ = synthetic_ba(np.random.default_rng(13), n_cams=4, n_pts=103)
    pj, pt = _both(prob)
    rj = jdist.dist_bundle_adjust(pj, n_devices=8, max_iters=8)
    rt = tdist.dist_bundle_adjust(pt, n_devices=8, max_iters=8)
    _check(rt, rj)
    assert int(rt.n_accepted) >= 3


def test_dist_2d_mesh_matches_jax():
    """make_mesh_2d(n_hosts=2, n_devices=8) in one process: a [2, 4] grid of
    shards held by this rank, against JAX's [2, 4] device mesh."""
    mesh = tmesh.make_mesh_2d(n_hosts=2, n_devices=8, device="cpu")
    assert mesh.shape == (2, 4) and mesh.n_local == 8 and mesh.size == 8
    assert mesh.axis_names == (tmesh.HOST_AXIS, tmesh.POINT_AXIS)
    prob, *_ = synthetic_ba(np.random.default_rng(14), n_cams=5, n_pts=96, noise_px=0.3)
    pj, pt = _both(prob)
    rj = jdist.dist_bundle_adjust(pj, max_iters=10, mesh=j_mesh_2d(n_hosts=2, n_devices=8))
    rt = tdist.dist_bundle_adjust(pt, max_iters=10, mesh=mesh)
    _check(rt, rj)


def test_pair_table_branch_matches_jax(monkeypatch):
    """Past the dense guard the S correction takes the pair table
    (_explicit_s_corr); JAX's default branch is the square root: the same
    LM run within the stated tolerances, and repeats bit-equal."""
    monkeypatch.setattr(tdist.schur_core, "_DENSE_W_MAX_ELEMS", 10)
    prob, *_ = synthetic_ba(np.random.default_rng(15), n_cams=5, n_pts=64, noise_px=0.3)
    w = np.asarray(prob.obs_w).copy()
    w[::6] = 0.0
    pj, pt = _both(prob, obs_w=w)
    calls = []
    real = tdist._explicit_s_corr
    monkeypatch.setattr(tdist, "_explicit_s_corr", lambda *a: calls.append(1) or real(*a))
    rt = tdist.dist_bundle_adjust(pt, n_devices=4, max_iters=8)
    assert len(calls) == 8
    _check(rt, jdist.dist_bundle_adjust(pj, n_devices=4, max_iters=8))
    again = tdist.dist_bundle_adjust(pt, n_devices=4, max_iters=8)
    assert torch.equal(rt.final_cost, again.final_cost)
    assert torch.equal(rt.problem.points, again.problem.points)


def test_dense_guard_bounds_each_z(monkeypatch):
    """The dense guard bounds every Z the rank builds: 4 shards of 16
    points in one process build one Z over the rank's 64 points where it
    fits, one Z per shard where only a shard's fits (as each JAX device
    builds its own), and take the pair table below that. Each way agrees
    with JAX's run within the stated tolerances."""
    prob, *_ = synthetic_ba(np.random.default_rng(15), n_cams=5, n_pts=64, noise_px=0.3)
    pj, pt = _both(prob)
    ref = jdist.dist_bundle_adjust(pj, n_devices=4, max_iters=2)
    calls = {"sqrt": 0, "pairs": 0}
    sqrt, pairs = tdist._explicit_s_corr_sqrt, tdist._explicit_s_corr

    def count(name, fn):
        return lambda *a, **k: calls.__setitem__(name, calls[name] + 1) or fn(*a, **k)

    monkeypatch.setattr(tdist, "_explicit_s_corr_sqrt", count("sqrt", sqrt))
    monkeypatch.setattr(tdist, "_explicit_s_corr", count("pairs", pairs))
    for guard, want in ((64 * 5 * 6 * 3, (2, 0)), (16 * 5 * 6 * 3, (8, 0)),
                        (16 * 5 * 6 * 3 - 1, (0, 2))):
        monkeypatch.setattr(tdist.schur_core, "_DENSE_W_MAX_ELEMS", guard)
        calls.update(sqrt=0, pairs=0)
        _check(tdist.dist_bundle_adjust(pt, n_devices=4, max_iters=2), ref, converged=False)
        assert (calls["sqrt"], calls["pairs"]) == want, guard


def test_repeats_bit_equal_and_shard_counts_agree():
    """Two runs at 4 shards give the same bits; 1 and 4 shards agree to
    float32 round-off (the sums group differently)."""
    prob, *_ = synthetic_ba(np.random.default_rng(16), n_cams=6, n_pts=120, noise_px=0.3)
    _, pt = _both(prob)
    a, b = (tdist.dist_bundle_adjust(pt, n_devices=4, max_iters=10) for _ in range(2))
    for x, y in zip((a.initial_cost, a.final_cost, a.problem.cam_wxyz, a.problem.cam_t,
                     a.problem.points),
                    (b.initial_cost, b.final_cost, b.problem.cam_wxyz, b.problem.cam_t,
                     b.problem.points)):
        assert torch.equal(x, y)
    one = tdist.dist_bundle_adjust(pt, n_devices=1, max_iters=10)
    np.testing.assert_allclose(float(one.initial_cost), float(a.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(one.final_cost), float(a.final_cost), rtol=1e-4,
                               atol=1e-6)


def test_mesh_shapes_and_device_rules(monkeypatch):
    m = tmesh.make_mesh(device="cpu")
    assert (m.group, m.n_local, m.shape, m.size, m.world, m.rank) == (None, 1, (1,), 1, 1, 0)
    assert tmesh.make_mesh(4, device="cpu").n_local == 4
    assert tmesh.make_mesh_2d(device="cpu").shape == (1, 1)
    with pytest.raises(ValueError):
        tmesh.make_mesh_2d(n_hosts=3, n_devices=8, device="cpu")
    assert tmesh.pad_to_multiple(103, 8) == 104
    # the card by default: without one, the mesh refuses instead of using the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmesh.make_mesh()
    prob, *_ = synthetic_ba(np.random.default_rng(17), n_cams=3, n_pts=20)
    _, pt = _both(prob)
    with pytest.raises(ValueError, match="mesh"):
        tdist.dist_bundle_adjust(pt, mesh=tmesh.Mesh(None, torch.device("cuda"), 1, (1,),
                                                      (tmesh.POINT_AXIS,)))


def test_distributed_init_noop_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.distributed_init() is False    # no env contract -> single process
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert tmesh.distributed_init() is False    # one process: nothing to join
