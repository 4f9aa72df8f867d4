"""Port parity for the exact BAL objective (ba/snavely.py): residuals,
cost and Jacobians, the fused assembly, the square-root dense Schur and
matrix-free PCG solves on the same blocks, and the LM in every solver —
dr3_tpu (JAX on the CPU) vs dr3_tpu_torch (the CPU) on the same numpy
problems; then the JAX file's behavioural cases on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from dr3_tpu.ba import snavely as js
from dr3_tpu.ba.schur_core import cam_onehot_matrix as jonehot
from dr3_tpu.io.bal import BALData as JBALData
from dr3_tpu_torch import convert
from dr3_tpu_torch.ba import snavely as ts
from dr3_tpu_torch.ba.schur_core import cam_onehot_matrix
from tests.torch_parity import nn, rand_bal, snavely_np, tt


def _both(d, **changes):
    """The same problem in both packages: JAX's bal_to_snavely, its fields
    (with ``changes``) handed to the port as numpy."""
    pj = js.bal_to_snavely(JBALData(*d))
    fields = {k: np.asarray(v) for k, v in pj._asdict().items()}
    fields.update(changes)
    pj = js.SnavelyProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    return pj, convert.snavely_problem(fields)


def _masked_case(rng):
    """test_assemble_direct_matches_generic's problem: Huber-active noise,
    every seventh weight zero, one point at 1e18 (its residuals overflow)."""
    d = rand_bal(rng, n_cams=5, n_pts=80, noise=6.0, pt_noise=0.2)
    w = np.ones(d.obs_cam.shape[0], np.float32)
    w[::7] = 0.0
    pts = np.asarray(js.bal_to_snavely(JBALData(*d)).points).copy()
    pts[3] = 1e18
    return _both(d, obs_w=w, points=pts)


def _close(got, want, rel, name=""):
    """|got - want| <= rel * max|want| (+ a floor for all-zero arrays)."""
    got, want = nn(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * (np.abs(want).max() + 1e-6),
                               err_msg=name)


def test_bal_to_snavely_and_back_match(rng):
    """bal_to_snavely: rotations within 1e-6, the rest exact float32;
    snavely_to_bal back within 1e-6 of JAX's (float64 of float32 math)."""
    d = rand_bal(rng)
    pj = js.bal_to_snavely(JBALData(*d))
    pt = ts.bal_to_snavely(d, device="cpu")
    for k in ts.SnavelyProblem._fields:
        np.testing.assert_allclose(nn(getattr(pt, k)), np.asarray(getattr(pj, k)), atol=1e-6,
                                   err_msg=k)
    assert pt.cam_fixed.tolist() == [True, False, False, False]
    bj, bt = js.snavely_to_bal(pj), ts.snavely_to_bal(pt)
    for a, b in zip(bt, bj):
        np.testing.assert_allclose(a, b, atol=1e-6)
        assert a.dtype == b.dtype


def test_residuals_cost_and_linearize_match(rng):
    """residuals_only, residual_cost and linearize (r, Jc, Jp, cost,
    valid) with zero weights and an overflowing point: the same validity
    mask, values within 1e-5 of each array's scale, costs rtol 1e-5."""
    pj, pt = _masked_case(rng)
    rj, rt = np.asarray(js.residuals_only(pj)), nn(ts.residuals_only(pt))
    fin = np.isfinite(rj).all(-1)
    assert (np.isfinite(rt).all(-1) == fin).all()
    _close(rt[fin], rj[fin], 1e-5)
    for hd in (2.0, 1e9):
        np.testing.assert_allclose(float(ts.residual_cost(pt, hd)),
                                   float(js.residual_cost(pj, hd)), rtol=1e-5)
        lj, lt = js.linearize(pj, hd), ts.linearize(pt, hd)
        assert (nn(lt.valid) == np.asarray(lj.valid)).all()
        for k in ("r", "Jc", "Jp"):
            _close(getattr(lt, k), getattr(lj, k), 1e-5, k)
        np.testing.assert_allclose(float(lt.cost), float(lj.cost), rtol=1e-5)


def _port_blocks(bj):
    """JAX DirectBlocks -> the port's (the tuples of [O] columns stacked)."""
    return ts.DirectBlocks(
        Hcc=tt(bj.Hcc), bc=tt(bj.bc), Hpp9=tt(bj.Hpp9), bp=tt(bj.bp),
        Jcu=tt(np.stack(bj.Jcu, -1)), Jcv=tt(np.stack(bj.Jcv, -1)),
        Jpu=tt(np.stack(bj.Jpu, -1)), Jpv=tt(np.stack(bj.Jpv, -1)),
        obs_cam=tt(bj.obs_cam).long(), obs_pt=tt(bj.obs_pt).long(), active=tt(bj.active))


def test_assemble_direct_matches(rng):
    """_assemble_direct: Hcc, bc, Hpp9, bp and the factored columns within
    2e-5 of each array's scale, active equal, the cost rtol 1e-5."""
    pj, pt = _masked_case(rng)
    bj, cj = js._assemble_direct(pj, jonehot(pj.obs_cam, pj.n_cams), 2.0)
    bt, ct = ts._assemble_direct(pt, cam_onehot_matrix(pt.obs_cam, pt.n_cams), 2.0)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)
    assert (nn(bt.active) == np.asarray(bj.active)).all()
    for k in ("Hcc", "bc", "Hpp9", "bp"):
        _close(getattr(bt, k), getattr(bj, k), 2e-5, k)
    for k in ("Jcu", "Jcv", "Jpu", "Jpv"):
        _close(getattr(bt, k), np.stack(getattr(bj, k), -1), 2e-5, k)


@pytest.mark.parametrize("solve", ["explicit", "pcg"])
def test_direct_solves_match_on_the_same_blocks(rng, solve):
    """_solve_explicit_direct and _solve_pcg_direct (cg_tol 1e-7, 200
    iterations) on JAX's blocks: dc and dp within 1e-3 of their scale;
    the gauge camera's step is zero."""
    d = rand_bal(rng, n_cams=6, n_pts=100, noise=3.0, pt_noise=0.1)
    pj, pt = _both(d)
    Ej = jonehot(pj.obs_cam, pj.n_cams)
    bj, _ = js._assemble_direct(pj, Ej, 2.0)
    bt = _port_blocks(bj)
    Et = cam_onehot_matrix(pt.obs_cam, pt.n_cams)
    lam = 1e-3
    if solve == "explicit":
        dcj, dpj = js._solve_explicit_direct(bj, jnp.asarray(lam), pj.cam_fixed, Ej)
        dct, dpt = ts._solve_explicit_direct(bt, torch.tensor(lam), pt.cam_fixed, Et)
    else:
        dcj, dpj = js._solve_pcg_direct(bj, jnp.asarray(lam), pj.cam_fixed, Ej, cg_iters=200,
                                        cg_tol=1e-7, q_eta=0.0)
        dct, dpt, n = ts._solve_pcg_direct(bt, torch.tensor(lam), pt.cam_fixed, Et, 200, 1e-7,
                                           0.0)
        assert 0 < n < 200
    _close(dct, dcj, 1e-3, "dc")
    _close(dpt, dpj, 1e-3, "dp")
    assert float(dct[0].abs().max()) == 0.0


def test_z_scatter_adds_padding_rows_that_collide(rng):
    """Zero-weight padding rows carry clamped (camera, point) ids that
    collide with live observations; in the co-visible block sums they pair
    with the live rows and must bring exact zeros. Duplicating every
    observation as a padding row leaves the explicit step unchanged bit for
    bit."""
    d = rand_bal(rng, n_cams=4, n_pts=40, noise=2.0, pt_noise=0.1)
    _, pt = _both(d)
    E = cam_onehot_matrix(pt.obs_cam, pt.n_cams)
    blocks, _ = ts._assemble_direct(pt, E, 2.0)
    dc, dp = ts._solve_explicit_direct(blocks, torch.tensor(1e-3), pt.cam_fixed, E)
    twice = lambda a: torch.cat([a, a])  # noqa: E731
    pad = pt._replace(obs_cam=twice(pt.obs_cam), obs_pt=twice(pt.obs_pt),
                      obs_uv=twice(pt.obs_uv),
                      obs_w=torch.cat([pt.obs_w, torch.zeros_like(pt.obs_w)]))
    E2 = cam_onehot_matrix(pad.obs_cam, pad.n_cams)
    blocks2, _ = ts._assemble_direct(pad, E2, 2.0)
    dc2, dp2 = ts._solve_explicit_direct(blocks2, torch.tensor(1e-3), pad.cam_fixed, E2)
    assert torch.equal(dc, dc2) and torch.equal(dp, dp2)


@pytest.mark.parametrize("solver", ["auto", "zexplicit", "explicit", "pcg"])
def test_bundle_adjust_snavely_matches(rng, solver):
    """10 LM iterations, Huber 2 (pcg near-exact: cg_tol 1e-5, q_eta 0):
    the same accepted steps, initial and final costs rtol 1e-4."""
    d = rand_bal(rng, n_cams=6, n_pts=100, noise=3.0, pt_noise=0.1)
    pj, pt = _both(d)
    kw = dict(huber_delta=2.0, solver=solver, cg_tol=1e-5, q_eta=0.0)
    rj = js.bundle_adjust_snavely(pj, 10, **kw)
    rt = ts.bundle_adjust_snavely(pt, 10, **kw)
    assert int(rt.n_accepted) == int(rj.n_accepted)
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-4)
    assert float(rt.final_cost) < 0.3 * float(rt.initial_cost)
    assert (rt.cg_iters > 0) == (solver == "pcg")


def test_routing_matches_the_reference():
    """auto takes zexplicit while dense Z fits; zexplicit past the Z limit
    falls back to pcg; past the one-hot limit the generic core runs."""
    def shaped(K, P, O):
        z = torch.zeros
        return ts.SnavelyProblem(z(K, 4), z(K, 3), z(K, 3), z(P, 3), z(O, dtype=torch.int32),
                                 z(O, dtype=torch.int32), z(O, 2), z(O), z(K, dtype=torch.bool))

    assert ts._pick_method(shaped(120, 60000, 10), "auto") == ("zexplicit", True)
    big = shaped(200, 200000, 10)            # Z of 4.3 GB
    assert ts._pick_method(big, "auto") == ("pcg", True)
    assert ts._pick_method(big, "zexplicit") == ("pcg", True)
    assert ts._pick_method(shaped(60, 400000, 10), "auto") == ("explicit", True)
    assert ts._pick_method(shaped(64, 10, 2 ** 22 + 1), "auto")[1] is False


# --- tests/test_snavely.py's behavioural cases, on the port ---------------

def test_snavely_residuals_match_numpy(rng):
    d = rand_bal(rng, pt_noise=0.05)
    r = nn(ts.residuals_only(ts.bal_to_snavely(d, device="cpu")))
    want = np.stack([snavely_np(d.cam_params[c], d.points[p], uv)
                     for c, p, uv in zip(d.obs_cam, d.obs_pt, d.obs_uv)])
    np.testing.assert_allclose(r, want, atol=5e-2, rtol=1e-3)


def test_snavely_jacobians_match_autodiff(rng):
    """linearize's analytic Jacobians against torch.func.jacfwd through
    apply_update + residuals_only (1e-2, as the JAX test)."""
    d = rand_bal(rng, n_cams=2, n_pts=5, pt_noise=0.02)
    prob = ts.bal_to_snavely(d, device="cpu")
    lin = ts.linearize(prob, huber_delta=1e9)
    free = prob._replace(cam_fixed=torch.zeros_like(prob.cam_fixed))

    def res_of(tangent, dpt, o):
        dc = torch.zeros((prob.n_cams, 9)).index_copy(0, prob.obs_cam[o:o + 1].long(),
                                                       tangent[None])
        dp = torch.zeros_like(prob.points).index_copy(0, prob.obs_pt[o:o + 1].long(),
                                                      dpt[None])
        return ts.residuals_only(ts.apply_update(free, dc, dp))[o]

    for o in [3, 7]:
        Jc = jacfwd(lambda tg: res_of(tg, torch.zeros(3), o))(torch.zeros(9))
        Jp = jacfwd(lambda dp: res_of(torch.zeros(9), dp, o))(torch.zeros(3))
        np.testing.assert_allclose(nn(lin.Jc[o]), nn(Jc), atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(nn(lin.Jp[o]), nn(Jp), atol=1e-2, rtol=1e-2)


def test_snavely_recovers_focal_and_radial(rng):
    d = rand_bal(rng, n_cams=8, n_pts=200)
    true_fkk = d.cam_params[:, 6:9].copy()
    cam = d.cam_params.copy()
    cam[1:, 6] *= 1.03
    cam[1:, 7] += 0.02
    res = ts.bundle_adjust_snavely(ts.bal_to_snavely(d._replace(cam_params=cam), device="cpu"),
                                   40, huber_delta=1e9)
    assert float(res.final_cost) < 1e-4 * float(res.initial_cost)
    np.testing.assert_allclose(nn(res.problem.cam_fkk)[1:, 0], true_fkk[1:, 0], rtol=2e-3)


def test_snavely_pcg_path(rng):
    d = rand_bal(rng, n_cams=6, n_pts=100, noise=0.1, pt_noise=0.05)
    prob = ts.bal_to_snavely(d, device="cpu")
    res_e = ts.bundle_adjust_snavely(prob, 15, solver="explicit")
    res_p = ts.bundle_adjust_snavely(prob, 15, solver="pcg")
    assert float(res_p.final_cost) < float(res_p.initial_cost) * 5e-2
    assert abs(float(res_e.final_cost) - float(res_p.final_cost)) < \
        0.1 * float(res_e.initial_cost)
    assert res_p.cg_iters > 0


def test_snavely_bal_roundtrip(rng):
    d = rand_bal(rng)
    d2 = ts.snavely_to_bal(ts.bal_to_snavely(d, device="cpu"))
    np.testing.assert_allclose(d2.cam_params, d.cam_params, atol=1e-5)
    np.testing.assert_allclose(d2.points, d.points, atol=1e-6)
    np.testing.assert_allclose(d2.obs_uv, d.obs_uv, atol=1e-5)


def test_snavely_result_round_trips_through_convert(rng):
    """convert.snavely_problem / to_numpy carry a problem both ways exactly."""
    _, pt = _both(rand_bal(rng))
    back = convert.snavely_problem(convert.to_numpy(pt))
    for k in ts.SnavelyProblem._fields:
        assert torch.equal(getattr(back, k), getattr(pt, k)), k
