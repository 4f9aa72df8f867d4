"""The port's device-resident frame loop with the dense window solves
(``Config.ba_solver`` "explicit", "zexplicit" and "auto", which takes
zexplicit at a window of 64 keyframes or fewer) on the CPU, on
tests/test_vo_scan.py's 320x240 out-and-back, held bit-equal to the port's
per-frame ``process``.

The loop runs window BA inside with every solver, as the JAX package's
``_scan_frames`` does (dr3_tpu/pipelines/vo.py:544-548, ``defer_ba`` only
with a mesh): a dense solve's LM step is ``[lm_pre, lm_post]``, its camera
step (the dense reduced system, its Cholesky and both triangular solves)
inside ``lm_pre``, with no CG loop. No row hands a keyframe's BA to the
host (``_REASON_KF_BA``). Every run draws the bootstrap's RANSAC sets from
JAX's key chain, as tests/test_torch_vo_scan.py does
(tests/test_torch_vo_scan_dense_jax.py holds the zexplicit loop against the
JAX package's).
"""

import numpy as np
import pytest
import torch

from dr3_tpu_torch.ba.schur_lm import LMSteps
from dr3_tpu_torch.geometry import ransac as transac
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.parallel.mesh import make_mesh
from dr3_tpu_torch.pipelines import vo as tvo
from dr3_tpu_torch.pipelines.vo import MonoVO, Stage
from dr3_tpu_torch.utils.config import Config
from dr3_tpu_torch.utils.cudagraph import Slots, _copy_into
from tests.test_torch_vo import _JaxMinimalSets
from tests.test_torch_vo_batch import BASE, CAM, _out_and_back
from tests.test_torch_vo_scan import _assert_same, _Runs
from tests.torch_parity import nn  # noqa: F401  (one intra-op thread per worker)

SOLVERS = ("explicit", "zexplicit", "auto")


@pytest.fixture(scope="module")
def frames():
    """tests/test_vo_scan.py's out-and-back: 32 frames that close a loop."""
    return _out_and_back(16)


@pytest.fixture(scope="module")
def runs():
    """Memoised runs; each driver keeps the rows it consumed (``rows_seen``)."""
    mp = pytest.MonkeyPatch()
    consume = MonoVO._consume_rows

    def spy(self, rows):
        seen = self.__dict__.setdefault("rows_seen", [])
        seen.extend(r.copy() for r in rows if r[tvo._ROW_CONSUMED] > 0.5)
        return consume(self, rows)

    mp.setattr(MonoVO, "_consume_rows", spy)
    try:
        yield _Runs()
    finally:
        mp.undo()


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("solver", SOLVERS)
def test_dense_scan_matches_per_frame(frames, runs, solver, width):
    """Widths 1 (the per-frame fallback) and 4 (keyframes, their window BAs
    and a loop candidate through the loop): the per-frame bits, the same
    window BAs, no CG iteration, and no keyframe handed to the host for
    its BA."""
    cfg = dict(BASE, ba_solver=solver)
    per_frame = runs.get("oab", frames, cfg, False)
    batched = runs.get("oab", frames, dict(cfg, frames_per_dispatch=width), True)
    vo = batched[0]
    assert ("scan_dispatch" in vo.monitor.timers) == (width > 1)
    assert vo.n_window_ba >= 2 and vo.n_cg_iters == per_frame[0].n_cg_iters == 0
    rows = np.asarray(vo.__dict__.get("rows_seen", []), np.float32).reshape(-1, tvo._ROW_DIM)
    assert (rows[:, tvo._ROW_REASON] != tvo._REASON_KF_BA).all()
    if width > 1:
        assert vo.n_loop_closures >= 1
        assert rows[:, tvo._ROW_BA_IN_LOOP].sum() >= 1 and rows[:, tvo._ROW_CG].sum() == 0
    _assert_same(per_frame, batched)


@pytest.mark.parametrize("solver", ("pcg",) + SOLVERS)
def test_loop_structure_per_solver(solver):
    """A dense solve's LM step is [lm_pre, lm_post], pcg's holds its CG
    loop; the program warms up and captures only the steps its structure
    holds. Window BA is deferred to the host only with a mesh."""
    cam = Pinhole.create(*CAM)
    cfg = Config(**BASE, ba_solver=solver, loop_closure=False)
    vo = MonoVO(cam, cfg, device="cpu")
    scan = vo._scan_body()
    assert scan.defer_ba is False
    dense = solver != "pcg"
    assert ("cg_step" in scan.steps()) == (not dense)
    assert scan.steps()[:4] == ["prologue", "frame", "keyframe", "ba_start"]
    assert scan.lm.method == ("pcg" if not dense else
                              "zexplicit" if solver == "auto" else solver)
    meshed = MonoVO(cam, cfg, device="cpu", mesh=make_mesh(2, device="cpu"))
    assert meshed._scan_body().defer_ba is True


@pytest.mark.parametrize("solver", ("explicit", "zexplicit"))
def test_window_pair_width_is_the_read_one(frames, runs, solver):
    """The window BA's dense pair tables at the static width 1 (no host
    read) give the bits of the width read from the problem: on the
    batched run's last window (its points moved off the optimum), one
    (point, keyframe) pair never holds two observations."""
    vo, _ = runs.get("oab", frames, dict(BASE, ba_solver=solver, frames_per_dispatch=4), True)
    prob = tvo._window_problem(vo.kfs, vo.map, vo.intr, vo.cam.dist)
    nudge = np.random.default_rng(0).normal(0.0, 0.02, tuple(prob.points.shape))
    prob = prob._replace(points=prob.points + torch.as_tensor(nudge, dtype=torch.float32))
    static = tvo._window_lm(prob, vo.cfg, 3)
    assert static.pair_width == 1 and static.method == solver
    read = LMSteps(prob, 3, vo.cfg.ba_huber_delta, vo.cfg.ba_jacobi_scaling,
                   vo.cfg.ba_lambda0, False, solver, None, vo.cfg.ba_cg_iters,
                   vo.cfg.ba_cg_tol, vo.cfg.ba_q_eta, pt_width=static.pt_width)
    out = []
    for lm in (static, read):
        S = Slots()
        lm.start(S, prob)
        assert lm.run(S) == 0
        out.append(lm.result(S))
    assert int(out[0].n_accepted) >= 1
    for a, b in zip(out[0].problem[:4], out[1].problem[:4]):
        assert torch.equal(a, b)
    assert torch.equal(out[0].final_cost, out[1].final_cost)


def test_dense_scan_slots_in_place_match_eager(frames, monkeypatch):
    """tests/test_torch_vo_scan.py's in-place check for zexplicit: every
    step the program captures writes its slots in place after one "own"
    warm-up run, over a batch with keyframes and their window BA (the camera
    step handed from lm_pre to lm_post); rows and carry equal the eager
    loop's bit for bit."""
    monkeypatch.setattr(transac, "sample_minimal_sets", _JaxMinimalSets(seed=0))
    vo = MonoVO(Pinhole.create(*CAM), Config(**BASE, loop_closure=False, ba_solver="zexplicit",
                                             frames_per_dispatch=16), device="cpu")
    i = 0
    while vo.stage is not Stage.GENERAL:
        vo.process(frames[i])
        i += 1
    batch = frames[i:i + 16]
    scan = vo._scan_body()
    assert "cg_step" not in scan.steps()
    carry = vo._host_carry()
    inputs = dict(imgs=vo._upload(batch), n_valid=tvo._i32(len(batch), vo.device),
                  last_loop_kf=tvo._i32(vo.last_loop_kf, vo.device),
                  n_edges=tvo._i32(0, vo.device), anchor=(vo.T_anchor.wxyz, vo.T_anchor.t))
    eager = Slots()
    eager.update(carry)
    eager.update(inputs)
    eager["rows"] = torch.zeros((16, tvo._ROW_DIM))
    scan.walk(eager)
    S = tvo._own_slots(scan, carry, inputs)
    S.mode = "capture"
    for k in tvo._CARRY:
        _copy_into(S[k], carry[k])
    for k in tvo._BATCH_IN:
        _copy_into(S[k], inputs[k])
    scan.walk(S)
    rows = eager["rows"].numpy()
    assert rows[:, tvo._ROW_BA_IN_LOOP].sum() >= 1 and rows[:, tvo._ROW_CG].sum() == 0
    np.testing.assert_array_equal(S["rows"].numpy(), rows)
    flat = lambda v: [t for x in v for t in flat(x)] if isinstance(v, (list, tuple)) else [v]  # noqa: E731
    for k in tvo._CARRY:
        for a, b in zip(flat(S[k]), flat(eager[k])):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), k
