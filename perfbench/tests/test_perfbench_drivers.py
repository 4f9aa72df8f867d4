"""The drivers at a tiny size on the CPU, through the harness's test entry
(``run.run_cell`` on a copy of the benchmark with tiny configurations),
never through the measured command; and the faults a cell can have, each
planted under the harness, turning ``correct`` false."""

from __future__ import annotations

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from dr3_tpu_torch.state import MapState
from dr3_tpu_torch.utils.timing import Monitor
from perfbench import run
from perfbench.gen import bal, render
from perfbench.reference import bal_lm

TINY_VO = dict(cell_size=12, fast_threshold=8.0, init_min_features=60, init_min_tracked=60,
               init_min_triangulated=30, init_min_disparity=2.0, kf_disparity=12.0,
               max_points=2048, loop_db_capacity=16, loop_min_gap_frames=60)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with tiny sizes: 320x240 frames, an 8-camera
    BAL problem; warm-up until a window BA only."""
    root = tmp_path_factory.mktemp("tiny")
    shutil.copytree(os.path.join(run.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")

    def edit(rel, fn):
        p = root / rel
        data = json.loads(p.read_text())
        fn(data)
        p.write_text(json.dumps(data))

    edit("perfbench/configs/bal-dubrovnik-88.json",
         lambda c: c.update(problem=dict(cameras=8, points=600, observations=1600)))
    edit("perfbench/configs/kitti-mono-vo.json",
         lambda c: c.update(image=dict(width=320, height=240, focal_over_width=0.875),
                            settings=TINY_VO))
    # the VO cells, added to the copy by entries alone (their files are in
    # perfbench/: the benchmark leaves them out, PERF.md says why)
    with open(os.path.join(run.ROOT, "perfbench", "tests", "vo_cells.json")) as f:
        vo = json.load(f)
    edit("BENCHMARK.json", lambda b: [b[k].extend(vo[k]) for k in vo])
    for w in ("kitti-lateral-batch", "kitti-lateral-live"):
        edit(f"perfbench/workloads/{w}.json",
             lambda t: t.update(warmup=dict(require=["window_ba"], min_frames=16,
                                            max_frames=200),
                                trace_frames=4, trace_chunk=4,
                                **({"chunk_frames": 8} if "chunk_frames" in t else {})))
    return str(root)


def _result_ok(r: dict, trace: bool):
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


@pytest.mark.parametrize("trace", [False, True])
def test_bal_driver(tiny, trace):
    r = run.run_cell(tiny, "bal-dubrovnik-88", 2**31 + 77, 1.0, trace, "cpu")
    _result_ok(r, trace)
    assert r["correct"], r["checks"]
    if not trace:
        assert set(r["metrics"]) == {"bal_lm_iters_per_s", "setup_s"}


@pytest.mark.parametrize("workload,metric", [("vo-kitti-offline", "vo_fps"),
                                             ("vo-kitti-live", "vo_frame_p95_ms")])
def test_vo_driver(tiny, workload, metric):
    r = run.run_cell(tiny, workload, 2**31 + 5, 2.0, False, "cpu")
    _result_ok(r, False)
    assert set(r["metrics"]) == {metric, "setup_s"}
    assert set(r["checks"]) == {"missing_poses", "frozen_poses", "window_ba_excess"}
    assert all(np.isfinite(c["value"]) for c in r["checks"].values())


def test_vo_driver_traced(tiny):
    r = run.run_cell(tiny, "vo-kitti-live", 7, 1.0, True, "cpu")
    _result_ok(r, True)
    # the CPU runs no kernel and counts no host read: the readers of those
    # say nothing, the harness's own latencies are there
    assert set(r["metrics"]) == {"driver.nonkf_frame_p50_ms.live"}


# -- faults planted under the harness --------------------------------------

class FakeVO:
    """Stands in for MonoVO on the rendered stream: it knows the true pose
    of frame k (the stream replays one period), holds a map on the true
    scene and a keyframe window that sees it exactly, and answers with them
    unless a fault is planted: ``unchanged`` (every pose the first),
    ``half`` (half of each batch left out), ``altered`` (the map's points
    altered where they are made)."""

    def __init__(self, truth, cam, fault=None):
        self.truth, self.fault = truth, fault
        self.trajectory, self.stats = [], []
        self.frame_idx = -1
        self.scan_programs, self.device = {}, torch.device("cpu")
        self.n_window_ba = self.n_loop_closures = self.n_cg_iters = 0
        self.n_relocalizations = self.n_db_compactions = 0
        self.monitor = Monitor()
        self.cfg = SimpleNamespace(ba_huber_delta=5.0)
        self.intr = torch.tensor([cam["fx"], cam["fy"], cam["cx"], cam["cy"]])
        rng = np.random.default_rng(0)
        pts = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                        np.full(200, 6.0)], -1)
        kf = [self._pose(k) for k in (0, 10, 20)]
        xc = np.einsum("kij,pj->kpi", np.stack([m[:3, :3] for m in kf]), pts) + \
            np.stack([m[:3, 3] for m in kf])[:, None]
        px = np.stack([cam["fx"] * xc[..., 0] / xc[..., 2] + cam["cx"],
                       cam["fy"] * xc[..., 1] / xc[..., 2] + cam["cy"]], -1)
        if fault == "altered":                # the map's points 10% too deep
            pts = pts * np.array([1.0, 1.0, 1.1])
        f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
        self.map = MapState(xyz=f32(pts), valid=torch.ones(200, dtype=torch.bool))
        self.kfs = SimpleNamespace(
            wxyz=f32([Rotation.from_matrix(m[:3, :3]).as_quat()[[3, 0, 1, 2]] for m in kf]),
            t=f32([m[:3, 3] for m in kf]), frame_id=torch.tensor([0, 10, 20]),
            valid=torch.ones(3, dtype=torch.bool), obs_px=f32(px),
            obs_point=torch.arange(200).expand(3, 200).clone())

    def _pose(self, k):
        R, c = self.truth(k)
        if self.fault == "unchanged" and self.trajectory:
            return self.trajectory[0]
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = R, -R @ c
        return m

    def process(self, img):
        self.frame_idx += 1
        self.n_window_ba += 1
        m = self._pose(self.frame_idx)
        self.trajectory.append(m)
        self.stats.append(SimpleNamespace(frame_id=self.frame_idx, is_keyframe=False))
        return m

    def process_batch(self, imgs):
        n = len(imgs) // 2 if self.fault == "half" else len(imgs)
        return [self.process(i) for i in imgs[:n]]


def _vo_program(tiny, fault):
    cfg = json.loads(open(os.path.join(tiny, "perfbench/configs/kitti-mono-vo.json")).read())
    traffic = json.loads(open(os.path.join(
        tiny, "perfbench/workloads/kitti-lateral-batch.json")).read())
    poses = render.lateral_poses(traffic["path"]["period"], **{
        k: traffic["path"][k] for k in ("period", "amplitude", "wobble_y", "yaw")})

    def truth(k):
        p = poses[k % len(poses)]
        return p.R, -p.R.T @ p.t

    img = cfg["image"]
    cam = render.camera(img["width"], img["height"], img["focal_over_width"])
    return SimpleNamespace(MonoVO=lambda c, settings, device=None: FakeVO(truth, cam, fault),
                           Config=lambda **kw: None,
                           Pinhole=SimpleNamespace(create=lambda *a: None))


@pytest.mark.parametrize("workload", ["vo-kitti-offline", "vo-kitti-live"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_vo_faults_fail(tiny, workload, fault):
    if fault == "half" and workload == "vo-kitti-live":
        pytest.skip("one frame a call: there is no batch to halve")
    r = run.run_cell(tiny, workload, 3, 0.3, False, "cpu", program=_vo_program(tiny, fault))
    assert r["correct"] == (fault is None), r["checks"]


def _bal_program(fault):
    from dr3_tpu_torch.ba import snavely
    from dr3_tpu_torch.io.bal import BALData

    def solve(prob, iters, huber_delta, solver):
        p = prob
        if fault == "unchanged":
            return SimpleNamespace(problem=p, final_cost=torch.tensor(0.0))
        if fault == "half":
            keep = torch.arange(p.n_obs) % 2 == 0
            p = p._replace(obs_cam=p.obs_cam[keep], obs_pt=p.obs_pt[keep],
                           obs_uv=p.obs_uv[keep], obs_w=p.obs_w[keep])
        res = snavely.bundle_adjust_snavely(p, iters, huber_delta=huber_delta, solver=solver)
        out = res.problem._replace(obs_cam=prob.obs_cam, obs_pt=prob.obs_pt,
                                   obs_uv=prob.obs_uv, obs_w=prob.obs_w)
        if fault == "altered":
            out = out._replace(points=out.points + 0.01)
        return SimpleNamespace(problem=out, final_cost=res.final_cost)

    return SimpleNamespace(BALData=BALData, bal_to_snavely=snavely.bal_to_snavely,
                           bundle_adjust_snavely=solve)


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_bal_faults_fail(tiny, fault):
    r = run.run_cell(tiny, "bal-dubrovnik-88", 2**31 + 3, 0.3, False, "cpu",
                     program=_bal_program(fault))
    assert r["correct"] == (fault is None), r["checks"]


def test_bal_reference_finds_the_minimum():
    """The reference's solve ends where the gradient vanishes: a further
    iteration lowers the cost by less than 1e-12 of it."""
    start, _ = bal.bal_case(8, 600, 1600, 7)
    prob = bal_lm.Problem(start, "cpu")
    params, costs, taken = bal_lm.solve(prob, bal_lm.start_params(start, "cpu"), 40)
    assert taken > 5 and costs[0] > 10 * costs[-1]
    _, more, _ = bal_lm.solve(prob, params, 1)
    assert more[0] - more[-1] <= 1e-12 * more[0]


@pytest.mark.cuda
def test_control_fails_on_the_card():
    """Each cell's control (its limits file: the BAL reference in
    bfloat16) fails the cell's limits at the cell's own size on the card;
    the program passes them on the same seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.calibrate import calibrate

    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for workload in cells:
        limits = run.cell_spec(run.ROOT, workload)["limits"]["limits"]
        good = calibrate(workload, 2**31 + 101, 10.0, False)["readings"]
        bad = calibrate(workload, 2**31 + 101, 10.0, True)["readings"]
        assert all(good[k] <= v for k, v in limits.items()), good
        assert any(bad[k] > v for k, v in limits.items()), bad
