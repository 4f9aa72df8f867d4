"""Levenberg-Marquardt bundle adjustment on the Schur complement (port of
dr3_tpu.ba.schur_lm; reference Ceres solve, src/optimizer.cpp:155-170).

Fixed iteration counts with accept/reject by cost comparison (lambda /3 on
accept, x2 on reject) selected with ``torch.where`` — no host read in the
LM loops themselves. ``bundle_adjust`` reuses the linearisation: the
accept-cost evaluation at the trial point is the next iteration's
linearisation when the step is accepted. Solver selection: up to
``_EXPLICIT_MAX_CAMS`` cameras "auto" takes the exact dense solve
``zexplicit``, beyond it ``pcg``.

:class:`LMSteps` is that loop as steps over a state dict: start, then per
LM iteration ``pre`` (blocks, reduced system, then the dense solves' camera
step or CG's start), ``cg_step`` while ``S["cg_go"]`` holds (pcg only),
``post`` (point step, update, accept). ``bundle_adjust`` drives it from the
host, reading the CG exit flag once per iteration; the VO's loop program
(pipelines/vo.py) captures the same steps as CUDA graph pieces, with the CG
loop a WHILE node and no read at all.

Every sum has a fixed order (ba/schur_core.py), so both entry points give
the same bits from run to run on the card; every camera-keyed sum,
``pose_only_adjust``'s too, is a product with the 0/1 membership matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr3_tpu_torch.ba.problem import BAProblem, Residuals, apply_update, linearize
from dr3_tpu_torch.ba.schur_core import (_ONEHOT_MAX_ELEMS, PCG, _assemble_blocks,
                                         _camera_reducer, back_substitute,
                                         cam_onehot_matrix, dense_camera_solve,
                                         reduce_system)
from dr3_tpu_torch.geometry.linalg import chol_solve_small
from dr3_tpu_torch.utils.cudagraph import Slots

# beyond this camera count the dense [6K, 6K] Cholesky stops being the
# right tool and the matrix-free PCG path takes over
_EXPLICIT_MAX_CAMS = 64


class BAResult(NamedTuple):
    problem: BAProblem
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    n_accepted: torch.Tensor
    lambda_final: torch.Tensor
    cg_iters: object = 0     # CG iterations run: an int from bundle_adjust
                             # (one host read each), an int32 tensor from LMSteps


def _params_finite(p: BAProblem) -> torch.Tensor:
    return (torch.isfinite(p.cam_wxyz).all() & torch.isfinite(p.cam_t).all()
            & torch.isfinite(p.points).all() & torch.isfinite(p.intrinsics).all())


def _select_problem(ok, p: BAProblem, p_new: BAProblem) -> BAProblem:
    return p._replace(**{k: torch.where(ok, getattr(p_new, k), getattr(p, k))
                         for k in ("cam_wxyz", "cam_t", "points", "intrinsics")})


def _select_residuals(ok, res: Residuals, res_new: Residuals) -> Residuals:
    return Residuals(*[None if a is None else torch.where(ok, b, a)
                       for a, b in zip(res, res_new)])


def _pick_solver(problem: BAProblem, solver: str) -> str:
    if solver == "auto":
        return "zexplicit" if problem.n_cams <= _EXPLICIT_MAX_CAMS else "pcg"
    return solver


def bundle_adjust(problem: BAProblem, max_iters: int = 20,
                  huber_delta: float = 5.0, jacobi: bool = True,
                  lambda0: float = 1e-3, optimize_intrinsics: bool = False,
                  solver: str = "auto", d_max: int | None = None,
                  cg_iters: int = 100, cg_tol: float = 1e-5,
                  q_eta: float = 0.0) -> BAResult:
    """Full LM loop (global_BA parity, src/optimizer.cpp:131-175).
    ``jacobi`` scales the dense solves' reduced system; ``d_max`` sizes
    their pair table (default min(K, O): one observation per camera);
    ``cg_tol``/``q_eta`` forward to the pcg solve."""
    lm = LMSteps(problem, max_iters, huber_delta, jacobi, lambda0, optimize_intrinsics,
                 _pick_solver(problem, solver), d_max, cg_iters, cg_tol, q_eta)
    S = Slots()
    lm.start(S, problem)
    n_cg = lm.run(S)
    return lm.result(S)._replace(cg_iters=n_cg)


class LMSteps:
    """:func:`bundle_adjust`'s LM loop as steps over a state dict ``S`` (a
    :class:`dr3_tpu_torch.utils.cudagraph.Slots`): :meth:`start`, then
    ``max_iters`` times :meth:`pre`, :meth:`cg_step` while ``S["cg_go"]``
    (int32) holds, :meth:`post`. ``T`` is a plain dict for what ``pre``
    hands to the CG steps and ``post`` of the same LM iteration (the reduced
    system, read-only; for a dense method the camera step). ``pt_width`` is
    the most observations a point can have and ``pair_width`` the most one
    (point, camera) pair can have, when the caller knows them from the
    problem's shape: the point sums and the dense solves' pair tables then
    read nothing to the host (``schur_core._table_reducer``). The CG
    iterations run are counted in ``S["cg_total"]`` (int32), 0 for a dense
    method."""

    def __init__(self, problem: BAProblem, max_iters: int, huber_delta: float,
                 jacobi: bool, lambda0: float, optimize_intrinsics: bool, method: str,
                 d_max: int | None, cg_iters: int, cg_tol: float, q_eta: float,
                 pt_width: int | None = None, pair_width: int | None = None):
        if method not in ("explicit", "zexplicit", "pcg"):
            raise ValueError(f"unknown schur method {method!r}")
        self.K, self.P, self.O = problem.n_cams, problem.n_points, problem.n_obs
        self.max_iters, self.huber_delta, self.jacobi = max_iters, huber_delta, jacobi
        self.lambda0, self.intrinsics, self.method = lambda0, optimize_intrinsics, method
        self.d_max = min(self.K, self.O) if d_max is None else d_max
        self.cg_iters, self.cg_tol, self.q_eta = cg_iters, cg_tol, q_eta
        self.pt_width, self.pair_width = pt_width, pair_width
        self.dist = problem.dist

    def problem(self, S) -> BAProblem:
        return BAProblem(*[S["p_" + k] for k in BAProblem._fields[:-1]], dist=self.dist)

    def residuals(self, S) -> Residuals:
        return Residuals(*[S["res_" + k] for k in Residuals._fields])

    def _put_state(self, S, p: BAProblem, res: Residuals) -> None:
        for k in ("cam_wxyz", "cam_t", "points", "intrinsics"):
            S.put("p_" + k, getattr(p, k))
        for k in Residuals._fields:
            S.put("res_" + k, getattr(res, k))

    def start(self, S, problem: BAProblem) -> None:
        """The problem and its linearisation into ``S``."""
        for k in BAProblem._fields[4:-1]:
            S.put("p_" + k, getattr(problem, k))
        res = linearize(problem, self.huber_delta, with_intrinsics=self.intrinsics)
        self._put_state(S, problem, res)
        dev = problem.cam_t.device
        E = cam_onehot_matrix(problem.obs_cam, self.K) \
            if self.O * self.K <= _ONEHOT_MAX_ELEMS else None
        S.put("E", E)
        S.put("lam", torch.full((), self.lambda0, dtype=torch.float32, device=dev))
        S.put("cost0", res.cost)
        S.put("best", res.cost)
        S.put("n_acc", torch.zeros((), dtype=torch.int32, device=dev))
        S.put("cg_total", torch.zeros((), dtype=torch.int32, device=dev))

    def pre(self, S, T: dict) -> None:
        """Blocks and the reduced system at the current linearisation; the
        dense solves' step, or CG's start."""
        p, res = self.problem(S), self.residuals(S)
        active = (p.obs_w > 0) & res.valid
        blocks = _assemble_blocks(res.r, res.Jc, res.Jp, p.obs_cam, p.obs_pt, active,
                                  self.K, self.P, Jg=res.Jg, cam_onehot=S["E"],
                                  pt_width=self.pt_width)
        T["red"] = red = reduce_system(blocks, S["lam"], p.cam_fixed, cam_onehot=S["E"],
                                       pt_width=self.pt_width)
        if self.method == "pcg":
            T["cg"] = PCG(red, p.cam_fixed, self.cg_iters, self.cg_tol, self.q_eta)
            T["cg"].start(S)
        else:
            T["step"] = dense_camera_solve(red, self.method, self.d_max, self.jacobi,
                                           self.pair_width)
            S.put("cg_go", torch.zeros((), dtype=torch.int32, device=p.cam_t.device))

    def cg_step(self, S, T: dict) -> None:
        T["cg"].step(S)
        S.put("cg_total", S["cg_total"] + 1)

    def post(self, S, T: dict) -> None:
        """The point step, the update, and accept / reject by cost."""
        dc, dg = T["cg"].solution(S) if self.method == "pcg" else T["step"]
        dp = back_substitute(T["red"], dc, dg)
        p, res = self.problem(S), self.residuals(S)
        p_new = apply_update(p, dc, dp, dg)
        res_new = linearize(p_new, self.huber_delta, with_intrinsics=self.intrinsics)
        # a nan/inf candidate masks its own observations inside linearize
        # (cost drops to ~0), so the parameters themselves must stay finite
        best, lam = S["best"], S["lam"]
        ok = (res_new.cost < best) & torch.isfinite(res_new.cost) & _params_finite(p_new)
        self._put_state(S, _select_problem(ok, p, p_new), _select_residuals(ok, res, res_new))
        S.put("lam", torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                                 torch.clamp(lam * 2.0, max=1e6)))
        S.put("best", torch.where(ok, res_new.cost, best))
        S.put("n_acc", S["n_acc"] + ok.to(torch.int32))

    def run(self, S) -> int:
        """Every LM iteration, driven from the host: one read of the CG exit
        flag per CG iteration (pcg), none otherwise. Returns the CG
        iterations run."""
        n = 0
        for _ in range(self.max_iters):
            T: dict = {}
            self.pre(S, T)
            while self.method == "pcg" and bool(S["cg_go"]):
                self.cg_step(S, T)
                n += 1
            self.post(S, T)
        return n

    def result(self, S) -> BAResult:
        return BAResult(problem=self.problem(S), initial_cost=S["cost0"],
                        final_cost=S["best"], n_accepted=S["n_acc"],
                        lambda_final=S["lam"], cg_iters=S["cg_total"])


def pose_only_adjust(problem: BAProblem, max_iters: int = 10,
                     huber_delta: float = 5.0) -> BAResult:
    """Motion-only BA: camera poses optimised with points frozen (the VO
    'pose_optimizer' stage, src/handler.cpp:22-26). Damped GN on [K, 6]
    blocks, the per-camera sums products with the 0/1 membership matrix
    (K = 1 on a VO frame: a sum over all observations in a fixed order)."""
    cost0 = linearize(problem, huber_delta).cost
    K = problem.n_cams
    eye6 = torch.eye(6, dtype=problem.cam_t.dtype, device=problem.cam_t.device)
    by_cam, _ = _camera_reducer(problem.obs_cam.long().clamp(0, K - 1), K)
    p = problem
    # a fill, not a host->device copy: the VO's graphed general step runs this
    lam = torch.full((), 1e-3, dtype=torch.float32, device=problem.cam_t.device)
    best = cost0
    n_acc = torch.zeros((), dtype=torch.int32, device=problem.cam_t.device)
    zero_pts = torch.zeros_like(problem.points)
    for _ in range(max_iters):
        res = linearize(p, huber_delta)
        H = by_cam(torch.einsum("oij,oik->ojk", res.Jc, res.Jc))
        b = -by_cam(torch.einsum("oij,oi->oj", res.Jc, res.r))
        H = H + eye6 * (lam * torch.diagonal(H, dim1=-2, dim2=-1) + 1e-8)[..., None, :]
        dc = chol_solve_small(H, b)
        p_new = apply_update(p, dc, zero_pts)
        new_cost = linearize(p_new, huber_delta).cost
        ok = (new_cost < best) & torch.isfinite(new_cost) & _params_finite(p_new)
        p = _select_problem(ok, p, p_new)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 2.0, max=1e6))
        best = torch.where(ok, new_cost, best)
        n_acc = n_acc + ok.to(torch.int32)
    return BAResult(problem=p, initial_cost=cost0, final_cost=best,
                    n_accepted=n_acc, lambda_final=lam)
