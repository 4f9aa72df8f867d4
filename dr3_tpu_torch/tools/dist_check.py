"""The distributed BA across ranks against one process (a check, with the
times of both).

    torchrun --nproc-per-node=4 dr3_tpu_torch/tools/dist_check.py            # one rank per card
    torchrun --nproc-per-node=4 dr3_tpu_torch/tools/dist_check.py --device cpu   # gloo

Every rank joins the group through ``parallel/mesh.distributed_init``
(torchrun's environment contract) and solves, with ``dist_bundle_adjust``:

* ``toy``: tests/test_multiprocess.py's problem (5 cameras, 96 points)
  drawn from each of ``--seeds`` seeds (the first is the test's), over a
  [ranks, 2] ``make_mesh_2d``, after 2, 4 and 10 LM steps;
* ``window``: the VO path's window shape (32 keyframes x 546 track slots
  = 17,472 observations over a 16,384-point map, 2 gauge cameras,
  ``tools/ba_time.window_case``), one shard per rank, 8 LM steps (as the
  VO runs a window BA);
* ``global``: the same generator at 256 cameras (139,776 observations
  over 16,384 points: the shape of ``MonoVO.global_refine``'s problem),
  one shard per rank, 8 LM steps.

Every rank also solves each problem in its process alone over the same
number of shards on its one card (the same partition: only the order of
the sum across ranks differs), and, as the witness of how far round-off
alone moves the result, that problem with its points relabelled by a
seeded permutation (the same problem, its sums in another order). Times
are wall ms of one call after a warm-up, the host read included.

It prints one JSON line (and writes it to ``--out``) and exits non-zero
when a rank's result differs from rank 0's in any bit, or against one
process over the same shards:

* the toy after 2 LM steps, held step by step (each accepted step there
  lowers the cost by about 1e-2 relative, far above round-off): the
  accepted steps differ, the final cost by more than 2e-5 relative, or
  cam_t by more than 1.5e-5 of the largest |cam_t|;
* every run after more steps, held by cost: the initial cost by more
  than 1e-5 relative, the final by more than 3e-5. Past convergence a
  step may lower the cost by as little as 2e-6 relative (toy seed 1237's
  4th), so round-off decides its accept, and cam_t drifts along the weak
  directions (the parity tests hold such runs by cost).

The bounds are four to five times the worst reading over eight toy seeds
and two window seeds on 4 gloo ranks on the CPU, the witness's included
(2 steps: final cost 4.5e-6, cam_t 2.91e-6 of the largest; more steps:
initial cost 8.4e-8, final 7.46e-6).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from dr3_tpu_torch import convert  # noqa: E402
from dr3_tpu_torch.ba.problem import make_problem, project  # noqa: E402
from dr3_tpu_torch.geometry.lie import SE3  # noqa: E402
from dr3_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from dr3_tpu_torch.parallel.dist_ba import dist_bundle_adjust  # noqa: E402
from dr3_tpu_torch.tools.ba_time import window_case  # noqa: E402

# relative bounds (module docstring): (final cost, cam_t) of the toy after
# 2 steps; (initial, final cost) after more
STEP_RTOL = (2e-5, 1.5e-5)
COST_RTOL = (1e-5, 3e-5)


def toy_problem(device, seed=1234):
    """tests/test_multiprocess.py's problem, from the same numpy draws."""
    rng = np.random.default_rng(seed)
    n_cams, n_pts = 5, 96
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0])
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(7, 14, n_pts)], -1).astype(np.float32)
    taus = np.zeros((n_cams, 6), np.float32)
    taus[:, 0] = 0.35 * np.arange(n_cams)
    cams = SE3.exp(torch.as_tensor(taus))
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = project(intr, cams[torch.as_tensor(obs_cam).long()].apply(
        torch.as_tensor(pts)[torch.as_tensor(obs_pt).long()]))
    uv = uv.numpy() + rng.normal(0, 0.3, uv.shape).astype(np.float32)
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    p = make_problem(cams, torch.as_tensor(pts0), intr, torch.as_tensor(obs_cam),
                     torch.as_tensor(obs_pt), torch.as_tensor(uv))
    return p._replace(**{k: getattr(p, k).to(device) for k in p._fields
                         if getattr(p, k) is not None})


def timed(fn):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    float(r.final_cost)
    return r, 1e3 * (time.perf_counter() - t0)


def permuted(prob, seed):
    """``prob`` with its points relabelled by a seeded permutation."""
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(prob.n_points),
                           device=prob.points.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(prob.n_points, device=perm.device)
    return prob._replace(points=prob.points[perm],
                         obs_pt=inv[prob.obs_pt.long()].to(prob.obs_pt.dtype))


def check(prob, mesh, iters, toy, world, seed):
    """One problem at one step count: the ranks' run against one process's
    over the same shards, and that against the point-permuted problem (the
    witness); a dict of the readings and whether the gates hold."""
    run = lambda m: dist_bundle_adjust(prob, max_iters=iters, mesh=m)  # noqa: E731
    run(mesh)                                                            # warm-up
    res, ms = timed(lambda: run(mesh))
    vec = torch.cat([res.problem.cam_t.reshape(-1), res.problem.points.reshape(-1),
                     res.final_cost.reshape(1)])
    every = [torch.empty_like(vec) for _ in range(world)]
    dist.all_gather(every, vec)
    same = all(torch.equal(v, every[0]) for v in every)
    alone = pmesh.Mesh(None, mesh.device, mesh.size, (1, mesh.size), mesh.axis_names)
    run(alone)
    a, ms_alone = timed(lambda: run(alone))
    b = dist_bundle_adjust(permuted(prob, seed), max_iters=iters, mesh=alone)
    scale = float(a.problem.cam_t.abs().max())

    def rel(x, y):
        return abs(float(x) / float(y) - 1.0)

    def t_rel(x, y):
        return float((x.problem.cam_t - y.problem.cam_t).abs().max()) / scale

    out = dict(ranks_equal=same, initial=float(res.initial_cost), final=float(res.final_cost),
               final_alone=float(a.final_cost), final_witness=float(b.final_cost),
               accepted=int(res.n_accepted), accepted_alone=int(a.n_accepted),
               accepted_witness=int(b.n_accepted),
               initial_rel=rel(res.initial_cost, a.initial_cost),
               final_rel=rel(res.final_cost, a.final_cost), cam_t_rel=t_rel(res, a),
               final_rel_witness=rel(b.final_cost, a.final_cost), cam_t_rel_witness=t_rel(b, a),
               ms=ms, ms_alone=ms_alone)
    if toy and iters == 2:
        gates = (out["accepted"] == out["accepted_alone"] and out["final_rel"] < STEP_RTOL[0]
                 and out["cam_t_rel"] < STEP_RTOL[1])
    else:
        gates = out["initial_rel"] < COST_RTOL[0] and out["final_rel"] < COST_RTOL[1]
    return out, same and gates


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    ap.add_argument("--problems", default="toy,window,global",
                    help="comma-separated: toy, window, global")
    ap.add_argument("--seeds", type=int, default=8,
                    help="toy problems (seeds 1234, 1235, ...; the witness's permutation too)")
    ap.add_argument("--big-seeds", type=int, default=2,
                    help="window and global problems (window_case seeds 0, 1, ...)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not pmesh.distributed_init(device=args.device):
        raise SystemExit("dist_check: run under torchrun with more than one process")
    world, rank = dist.get_world_size(), dist.get_rank()
    runs, ok = [], True
    for name in args.problems.split(","):
        if name == "toy":
            mesh = pmesh.make_mesh_2d(n_devices=2 * world, device=args.device)
            cases = [(f"toy seed {s}", s, toy_problem(mesh.device, s), it)
                     for s in range(1234, 1234 + args.seeds) for it in (2, 4, 10)]
        elif name in ("window", "global"):
            mesh = pmesh.make_mesh_2d(n_devices=world, device=args.device)
            n_cams = 32 if name == "window" else 256
            cases = [(f"{name} seed {s}", s,
                      convert.ba_problem(window_case(seed=s, n_cams=n_cams), device=mesh.device),
                      8) for s in range(args.big_seeds)]
        else:
            raise SystemExit(f"dist_check: unknown problem {name!r}")
        for label, seed, prob, iters in cases:
            out, good = check(prob, mesh, iters, name == "toy", world, seed)
            out.update(problem=label, shape=[prob.n_cams, prob.n_points, prob.n_obs],
                       mesh=list(mesh.shape), iters=iters, ok=good)
            runs.append(out)
            ok &= good
    if rank == 0:
        dev = (torch.cuda.get_device_name(torch.cuda.current_device())
               if args.device != "cpu" else "cpu")
        line = json.dumps({"ranks": world, "backend": dist.get_backend(), "device": dev,
                           "step_rtol": STEP_RTOL, "cost_rtol": COST_RTOL, "ok": bool(ok),
                           "runs": runs})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                f.write(line + "\n")
    mesh = None            # the group goes with the shutdown, not at exit
    pmesh.distributed_shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
