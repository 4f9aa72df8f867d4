"""The port's distributed BA across processes: 2 gloo ranks (OS processes,
the group initialised through a file store under tmp_path, no TCP port)
of 2 point shards each, against one process at 4 shards, on
tests/test_multiprocess.py's problem — the CPU stand-in for one rank per
card over NCCL. The 4 shards' partial systems are summed on 2 ranks and
reduced across them instead of summed in one process, so the runs agree
to float32 round-off: after 4 LM steps the same accepted steps, final
cost within 1e-5 relative, cam_t within 1e-5; after 10, at the optimum
of a problem whose scale is free (one fixed camera), final cost within
1e-4 and cam_t within 1e-3, as tests/test_torch_dist_ba.py states."""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBLEM = r"""
import numpy as np
import torch
from dr3_tpu_torch.ba.problem import make_problem, project
from dr3_tpu_torch.geometry.lie import SE3

def problem():
    rng = np.random.default_rng(1234)
    n_cams, n_pts = 5, 96
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0])
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(7, 14, n_pts)], -1).astype(np.float32)
    taus = np.zeros((n_cams, 6), np.float32)
    taus[:, 0] = 0.35 * np.arange(n_cams)
    cams = SE3.exp(torch.as_tensor(taus))
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    oc = torch.as_tensor(obs_cam).long()
    uv = project(intr, cams[oc].apply(torch.as_tensor(pts)[torch.as_tensor(obs_pt).long()]))
    uv = uv.numpy() + rng.normal(0, 0.3, uv.shape).astype(np.float32)
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return make_problem(cams, torch.as_tensor(pts0), intr, torch.as_tensor(obs_cam),
                        torch.as_tensor(obs_pt), torch.as_tensor(uv))
"""

_WORKER = _PROBLEM + r"""
import json, sys
torch.set_num_threads(1)
pid, n, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from dr3_tpu_torch.parallel.dist_ba import dist_bundle_adjust
from dr3_tpu_torch.parallel.mesh import distributed_init, distributed_shutdown, make_mesh_2d
assert distributed_init("file://" + store, n, pid, device="cpu")
import torch.distributed as dist
assert dist.get_backend() == "gloo" and dist.get_world_size() == n
mesh = make_mesh_2d(n_devices=2 * n)        # [n ranks, 2 shards each]
assert mesh.shape == (n, 2) and mesh.n_local == 2 and mesh.world == n
out = {}
for iters in (4, 10):
    res = dist_bundle_adjust(problem(), max_iters=iters, mesh=mesh)
    out[iters] = {"initial": float(res.initial_cost), "final": float(res.final_cost),
                  "n_acc": int(res.n_accepted), "cam_t": res.problem.cam_t.tolist(),
                  "points": res.problem.points.tolist()}
print("RESULT " + json.dumps(out), flush=True)
del mesh, res
distributed_shutdown()
"""


def test_two_rank_dist_ba_matches_one_process(tmp_path):
    import torch

    ns = {}
    exec(_PROBLEM, ns)
    from dr3_tpu_torch.parallel.dist_ba import dist_bundle_adjust

    single = {it: dist_bundle_adjust(ns["problem"](), n_devices=4, max_iters=it)
              for it in (4, 10)}

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    store = str(tmp_path / "store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid), "2", store],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                              text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n{err[-2000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, out
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # both ranks hold the whole, identical result
    assert outs[0] == outs[1]
    for it, tight in ((4, True), (10, False)):
        o, s = outs[0][str(it)], single[it]
        np.testing.assert_allclose(o["initial"], float(s.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(o["final"], float(s.final_cost), rtol=1e-5 if tight else 1e-4)
        np.testing.assert_allclose(np.asarray(o["cam_t"]), s.problem.cam_t.numpy(),
                                   atol=1e-5 if tight else 1e-3)
        np.testing.assert_allclose(np.asarray(o["points"]), s.problem.points.numpy(),
                                   atol=1e-4 if tight else 1e-2)
        if tight:
            assert o["n_acc"] == int(s.n_accepted) == 4
        assert torch.isfinite(s.problem.points).all()
