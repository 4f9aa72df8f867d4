"""Port parity: Lie groups, small linear algebra, camera, BA linearisation
and map compaction — dr3_tpu (JAX, CPU) vs dr3_tpu_torch (PyTorch, CPU)
on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.ba import problem as jprob
from dr3_tpu.geometry import lie as jlie
from dr3_tpu.geometry import linalg as jlinalg
from dr3_tpu.models.camera import Pinhole as JPinhole
from dr3_tpu import state as jstate
from dr3_tpu.ops import warp as jwarp
from dr3_tpu_torch import convert
from dr3_tpu_torch.ba import problem as tprob
from dr3_tpu_torch.geometry import lie as tlie
from dr3_tpu_torch.geometry import linalg as tlinalg
from dr3_tpu_torch.models.camera import Pinhole as TPinhole
from dr3_tpu_torch import state as tstate
from dr3_tpu_torch.ops import warp as twarp
from tests.torch_parity import nn, tt

# float32 elementwise math in both frameworks: identical formulas, so only
# libm / reduction-order round-off differs
F32 = dict(rtol=1e-5, atol=1e-6)


def _tangents(rng, n, scale):
    tau = rng.normal(0, scale, (n, 6)).astype(np.float32)
    tau[0] = 0.0                                  # identity (Taylor branch)
    tau[1, 3:] = [1e-5, -2e-5, 1e-5]              # tiny rotation
    return tau


@pytest.mark.parametrize("scale", [1e-3, 0.3, 1.5])
def test_se3_exp_matrix_apply(rng, scale):
    tau = _tangents(rng, 16, scale)
    Tj = jlie.SE3.exp(jnp.asarray(tau))
    Tt = tlie.SE3.exp(tt(tau))
    np.testing.assert_allclose(nn(Tt.wxyz), nn(Tj.wxyz), **F32)
    np.testing.assert_allclose(nn(Tt.t), nn(Tj.t), **F32)
    np.testing.assert_allclose(nn(Tt.matrix()), nn(Tj.matrix()), **F32)
    pts = rng.normal(0, 3, (16, 3)).astype(np.float32)
    np.testing.assert_allclose(nn(Tt.apply(tt(pts))), nn(Tj.apply(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn(Tt.center()), nn(Tj.center()), rtol=1e-5, atol=1e-5)
    # composition, inverse, from_matrix round trip
    Tj2, Tt2 = Tj[::-1], Tt[torch_flip(16)]
    np.testing.assert_allclose(nn((Tt @ Tt2).t), nn((Tj @ Tj2).t), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn(Tt.inverse().wxyz), nn(Tj.inverse().wxyz), **F32)
    m = nn(Tj.matrix())
    np.testing.assert_allclose(nn(tlie.SE3.from_matrix(tt(m)).wxyz),
                               nn(jlie.SE3.from_matrix(jnp.asarray(m)).wxyz),
                               rtol=1e-5, atol=1e-5)


def torch_flip(n):
    return list(range(n - 1, -1, -1))


def test_quaternion_and_hat_helpers(rng):
    q = rng.normal(size=(20, 4)).astype(np.float32)
    v = rng.normal(size=(20, 3)).astype(np.float32)
    qn = nn(tlie.quat_normalize(tt(q)))
    np.testing.assert_allclose(qn, nn(jlie.quat_normalize(jnp.asarray(q))), **F32)
    np.testing.assert_allclose(nn(tlie.quat_rotate(tt(qn), tt(v))),
                               nn(jlie.quat_rotate(jnp.asarray(qn), jnp.asarray(v))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn(tlie.quat_to_matrix(tt(qn))),
                               nn(jlie.quat_to_matrix(jnp.asarray(qn))), **F32)
    np.testing.assert_allclose(nn(tlie.hat(tt(v))), nn(jlie.hat(jnp.asarray(v))), atol=0)
    ident = tlie.SE3.identity()
    np.testing.assert_array_equal(nn(ident.wxyz), nn(jlie.SE3.identity().wxyz))


@pytest.mark.parametrize("shape", [(4, 4), (16, 9)])
def test_smallest_eigvec_gram(rng, shape):
    """Fixed-count inverse power iteration: same start, same arithmetic;
    float32 Cholesky round-off bounds the difference (atol 1e-4 on a unit
    vector)."""
    A = rng.normal(size=(8,) + shape).astype(np.float32)
    A[:, :, -1] = A[:, :, :-1] @ rng.normal(size=(shape[1] - 1,)).astype(np.float32)
    want = nn(jlinalg.smallest_eigvec_gram(jnp.asarray(A)))
    got = nn(tlinalg.smallest_eigvec_gram(tt(A)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_chol_solve_chol3_inv3x3(rng):
    M = rng.normal(size=(10, 6, 6)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(10, 6)).astype(np.float32)
    np.testing.assert_allclose(nn(tlinalg.chol_solve_small(tt(A), tt(b))),
                               nn(jlinalg.chol_solve_small(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    B = A[:, :3, :3]
    np.testing.assert_allclose(nn(tlinalg.chol3(tt(B))), nn(jlinalg.chol3(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nn(tlinalg.inv3x3(tt(B))), nn(jlinalg.inv3x3(jnp.asarray(B))),
                               rtol=1e-5, atol=1e-7)


def test_chol_inverse_applies_as_the_solve(rng):
    """The preconditioner's block inverse from the unrolled factor (PCG
    applies it as one product) against the JAX package's unrolled solve."""
    M = rng.normal(size=(10, 9, 9)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 9 * np.eye(9, dtype=np.float32)
    b = rng.normal(size=(10, 9)).astype(np.float32)
    inv = tlinalg._chol_inverse_factored(tlinalg._chol_factor_small(tt(A)))
    np.testing.assert_allclose(nn(inv), np.linalg.inv(A.astype(np.float64)), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(nn(torch.einsum("kcd,kd->kc", inv, tt(b))),
                               nn(jlinalg.chol_solve_small(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)


def test_inv3x3_large_hessian_blocks(rng):
    """BA Hpp blocks reach ~1e13: the max-|entry| normalisation keeps the
    determinant finite in float32 (ROADMAP round-5 fix)."""
    M = rng.normal(size=(6, 3, 3)).astype(np.float32)
    H = (M @ M.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)) * np.float32(1e13)
    got = nn(tlinalg.inv3x3(tt(H)))
    want = nn(jlinalg.inv3x3(jnp.asarray(H)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    np.testing.assert_allclose(np.einsum("kij,kjl->kil", got, H.astype(np.float64)),
                               np.broadcast_to(np.eye(3), H.shape), atol=1e-3)


def test_pinhole_projection_with_distortion(rng):
    args = (1240, 376, 718.856, 718.856, 607.1928, 185.2157)
    d = (-0.28, 0.07, 1e-4, -5e-5, 0.01)
    cj = JPinhole.create(*args, d=d)
    ct = TPinhole.create(*args, d=d)
    np.testing.assert_array_equal(nn(ct.K), nn(cj.K))
    xyz = np.stack([rng.uniform(-4, 4, 50), rng.uniform(-2, 2, 50),
                    rng.uniform(2, 30, 50)], -1).astype(np.float32)
    np.testing.assert_allclose(nn(ct.world2cam(tt(xyz))), nn(cj.world2cam(jnp.asarray(xyz))),
                               rtol=1e-6, atol=1e-3)
    k = TPinhole.kitti()
    assert (k.width, k.height) == (1240, 376) and float(k.fx) == float(JPinhole.kitti().fx)
    cc = convert.pinhole(cj.fx, cj.fy, cj.cx, cj.cy, cj.dist, cj.width, cj.height)
    np.testing.assert_array_equal(nn(cc.world2cam(tt(xyz))), nn(ct.world2cam(tt(xyz))))


def test_output_grid_matches():
    np.testing.assert_array_equal(nn(twarp.output_grid(5, 7)),
                                  nn(jwarp.output_grid(5, 7)))


def _ba_inputs(rng, n_cams=4, n_pts=40, dist=True):
    tau = rng.normal(0, 0.05, (n_cams, 6)).astype(np.float32)
    T = jlie.SE3.exp(jnp.asarray(tau))
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(6, 14, n_pts)], -1).astype(np.float32)
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = rng.uniform([0, 0], [640, 480], (len(obs_cam), 2)).astype(np.float32)
    w = (rng.uniform(size=len(obs_cam)) > 0.1).astype(np.float32)
    return dict(cam_wxyz=np.asarray(T.wxyz), cam_t=np.asarray(T.t), points=pts,
                intrinsics=np.asarray([500.0, 500.0, 320.0, 240.0], np.float32),
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv, obs_w=w,
                cam_fixed=np.arange(n_cams) == 0,
                dist=np.asarray([-0.2, 0.05, 1e-4, -5e-5, 0.0], np.float32) if dist else None)


@pytest.mark.parametrize("dist", [True, False])
def test_linearize_matches(rng, dist):
    d = _ba_inputs(rng, dist=dist)
    pj = jprob.BAProblem(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})
    pt = convert.ba_problem(d)          # the JAX-side numpy carried across
    assert pt.obs_cam.dtype == torch.int32 and pt.cam_fixed.dtype == torch.bool
    rj = jprob.linearize(pj, 5.0)
    rt = tprob.linearize(pt, 5.0)
    np.testing.assert_array_equal(nn(rt.valid), nn(rj.valid))
    np.testing.assert_allclose(nn(rt.r), nn(rj.r), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(nn(rt.Jc), nn(rj.Jc), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(nn(rt.Jp), nn(rj.Jp), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-5)


def test_compact_map_and_remap(rng):
    P = 64
    xyz = rng.normal(size=(P, 3)).astype(np.float32)
    valid = rng.uniform(size=P) > 0.3
    keep = rng.uniform(size=P) > 0.4
    ids = rng.integers(-1, P, size=(5, 20)).astype(np.int32)
    mj, nid_j, nj = jstate.compact_map(jstate.MapState(jnp.asarray(xyz), jnp.asarray(valid)),
                                       jnp.asarray(keep))
    mt, nid_t, nt = tstate.compact_map(tstate.MapState(tt(xyz), tt(valid)), tt(keep))
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(nn(nid_t), nn(nid_j))
    np.testing.assert_array_equal(nn(mt.xyz), nn(mj.xyz))
    np.testing.assert_array_equal(nn(mt.valid), nn(mj.valid))
    np.testing.assert_array_equal(nn(tstate.remap_point_ids(tt(ids), nid_t)),
                                  nn(jstate.remap_point_ids(jnp.asarray(ids), nid_j)))
