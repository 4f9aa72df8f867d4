"""The Ladybug-1723 cell's pieces on the CPU: the pair-summed reference
step against the dense one, the route generator's counts and geometry, the
cell's driver through the harness at a tiny size (correct, and not correct
under a planted fault or its bfloat16 control), and the program's generic
pcg path, which the cell's counts select, against the pair-summed
reference."""

from __future__ import annotations

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dr3_tpu_torch.ba import schur_core, snavely
from dr3_tpu_torch.io.bal import BALData
from perfbench import run
from perfbench.calibrate import calibrate
from perfbench.gen import bal, bal_route
from perfbench.reference import bal_lm, bal_lm_pairs

CELL = "bal-ladybug-1723"
LADYBUG = (1723, 156502, 678718)
# 72 cameras, past auto's dense limit of 64: the driver's problem (a tenth
# of Ladybug's points a camera, its observations a point; 5 LM iterations a
# solve, so that the traced solve is short) and the path's (Ladybug's
# points and observations a camera)
TINY = dict(cameras=72, points=720, observations=3096)
TINY_ITERS = 5
PATH = (72, 6480, 28080)


def _step_inputs(start, fixed_ids):
    prob = bal_lm.Problem(start, "cpu")
    r, Jc, Jp = bal_lm.jacobians(prob, bal_lm.start_params(start, "cpu"))
    fixed = torch.zeros(prob.n_cams, dtype=torch.bool)
    fixed[list(fixed_ids)] = True
    return r, Jc, Jp, prob.obs_cam, prob.obs_pt, prob.n_points, fixed


def _seen_once(seed):
    """A banded problem with its observations of one point but the first
    taken out."""
    start, _ = bal.bal_case(8, 600, 1600, seed)
    op = start["obs_pt"]
    drop = (op == op[800]) & (np.arange(len(op)) != np.flatnonzero(op == op[800])[0])
    out = {k: (v[~drop] if k.startswith("obs_") else v) for k, v in start.items()}
    assert np.bincount(out["obs_pt"])[op[800]] == 1
    return out


@pytest.mark.parametrize("case,fixed_ids", [("banded", []), ("seen_once", [0]),
                                            ("camera_0_fixed", [0])])
def test_pair_step_equals_the_dense_step(case, fixed_ids):
    start = (_seen_once(5) if case == "seen_once"
             else bal.bal_case(8, 600, 1600, 4)[0] if case == "banded"
             else bal_route.route_case(10, 400, 1200, 6)[0])
    args = _step_inputs(start, fixed_ids)
    for lam in (1e-3, 10.0):
        dc, dX = bal_lm.schur_step(*args, lam)
        pc, pX = bal_lm_pairs.schur_step(*args, lam)
        assert float((pc - dc).abs().max()) <= 1e-10 * float(dc.abs().max())
        assert float((pX - dX).abs().max()) <= 1e-10 * float(dX.abs().max())
        if fixed_ids:
            assert float(pc[0].abs().max()) == 0.0


def test_obs_pairs_lists_every_pair_once():
    op = torch.tensor([2, 0, 2, 1, 2, 0])
    i, j = bal_lm_pairs.obs_pairs(op, 4)
    got = sorted(zip(i.tolist(), j.tolist()))
    want = sorted((a, b) for a in range(6) for b in range(6) if op[a] == op[b])
    assert got == want


def _parallax_deg(data: dict) -> np.ndarray:
    """[P] the angle at each point between the rays from the two farthest
    apart cameras that see it, in degrees (the route's cameras differ only
    in x)."""
    centre = -data["cam_params"][:, 3]
    oc, op, X = data["obs_cam"], data["obs_pt"], data["points"]
    lo = np.full(len(X), np.inf)
    hi = np.full(len(X), -np.inf)
    np.minimum.at(lo, op, centre[oc])
    np.maximum.at(hi, op, centre[oc])
    a = np.stack([X[:, 0] - lo, X[:, 1], X[:, 2]], 1)
    b = np.stack([X[:, 0] - hi, X[:, 1], X[:, 2]], 1)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def test_route_counts_runs_and_parallax():
    start, truth = bal_route.route_case(*LADYBUG, 2**31 + 9)
    oc, op = start["obs_cam"], start["obs_pt"]
    assert start["cam_params"].shape == (LADYBUG[0], 9)
    assert start["points"].shape == (LADYBUG[1], 3) and oc.shape == op.shape == (LADYBUG[2],)
    runs = np.bincount(oc, minlength=LADYBUG[0])
    assert runs.max() - runs.min() <= 1 and runs.sum() == LADYBUG[2]
    for k in (0, 700, LADYBUG[0] - 1):           # a contiguous run of point ids
        ids = op[oc == k]
        assert np.array_equal(ids, np.arange(ids[0], ids[0] + len(ids)))
    assert np.bincount(op, minlength=LADYBUG[1]).min() >= 1
    centre = -start["cam_params"][:, 3]
    assert np.allclose(np.diff(centre), bal_route.SPACING)
    assert np.median(_parallax_deg(truth)) >= 1.0
    again, _ = bal_route.route_case(*LADYBUG, 2**31 + 9)
    assert all(np.array_equal(again[k], start[k]) for k in start)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with the cell's problem at the TINY counts
    and a window of 1 s."""
    root = tmp_path_factory.mktemp("ladybug")
    shutil.copytree(os.path.join(run.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(open(os.path.join(run.ROOT, "BENCHMARK.json")).read())
    bench["run_seconds"] = 1          # the driver draws the problems a window this long solves
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    conf = root / "perfbench" / "configs" / f"{CELL}.json"
    c = json.loads(conf.read_text())
    c["problem"] = TINY
    c["solve"]["lm_iterations"] = TINY_ITERS
    conf.write_text(json.dumps(c))
    return str(root)


@pytest.fixture
def generic(monkeypatch):
    """The one-hot's limit lowered, so that a small problem takes Ladybug's
    path: auto's generic pcg, its camera sums through the keyed table."""
    monkeypatch.setattr(snavely, "_ONEHOT_MAX_ELEMS", 0)
    monkeypatch.setattr(schur_core, "_ONEHOT_MAX_ELEMS", 0)


def _faulty_program():
    def solve(prob, iters, huber_delta, solver):
        res = snavely.bundle_adjust_snavely(prob, iters, huber_delta=huber_delta, solver=solver)
        return res._replace(problem=res.problem._replace(points=res.problem.points + 1.0))

    return SimpleNamespace(BALData=BALData, bal_to_snavely=snavely.bal_to_snavely,
                           bundle_adjust_snavely=solve)


def test_driver_correct_on_the_cpu(tiny, generic):
    r = run.run_cell(tiny, CELL, 2**31 + 77, 0.2, True, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    # the CPU counts no host read and traces no device time: of the cell's
    # metrics only the program's CG counter reads
    assert set(r["metrics"]) == {"bal.cg_iters_per_lm_iter"}
    assert 1 <= r["metrics"]["bal.cg_iters_per_lm_iter"]["value"] <= 100


def test_planted_fault_and_control_fail(tiny, generic):
    r = run.run_cell(tiny, CELL, 2**31 + 3, 0.2, False, "cpu", program=_faulty_program())
    assert not r["correct"], r["checks"]
    limit = run.cell_spec(tiny, CELL)["limits"]["limits"]["cost_excess"]
    ctl = calibrate(CELL, 2**31 + 3, 0.2, True, device="cpu", root=tiny)["readings"]
    assert ctl["cost_excess"] > limit, ctl


def test_pick_method_at_ladybug_counts():
    K, P, O = LADYBUG
    z = torch.zeros
    shaped = snavely.SnavelyProblem(z(K, 4), z(K, 3), z(K, 3), z(P, 3),
                                    z(O, dtype=torch.int32), z(O, dtype=torch.int32),
                                    z(O, 2), z(O), z(K, dtype=torch.bool))
    assert snavely._pick_method(shaped, "auto") == ("pcg", False)


def test_generic_pcg_path_against_the_pair_reference(generic):
    """auto at 72 cameras with the one-hot limit lowered runs the generic
    pcg path; at tight CG settings its cost after 10 LM iterations is the
    pair-summed reference's to 1e-4."""
    start, _ = bal_route.route_case(*PATH, 11)
    prob = snavely.bal_to_snavely(BALData(start["cam_params"], start["points"], start["obs_cam"],
                                          start["obs_pt"], start["obs_uv"]), device="cpu")
    assert snavely._pick_method(prob, "auto") == ("pcg", False)
    res = snavely.bundle_adjust_snavely(prob, 10, huber_delta=1e9, solver="auto",
                                        cg_tol=1e-6, q_eta=0.0)
    assert res.cg_iters > 0
    ref = bal_lm.Problem(start, "cpu")
    _, costs, _ = bal_lm_pairs.solve(ref, bal_lm.start_params(start, "cpu"), 10)
    o = res.problem
    got = float(bal_lm.cost(ref, (bal_lm.quat_to_matrix(o.cam_wxyz.double()), o.cam_t.double(),
                                  o.cam_fkk.double(), o.points.double())))
    assert costs[0] > 10 * costs[-1]
    assert abs(got - costs[-1]) <= 1e-4 * costs[-1]
