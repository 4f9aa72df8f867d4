"""The program's spans (dr3_tpu_torch.utils.timing.span, Monitor tic/toc) on
the CPU under torch.profiler: the BAL solve's ranges on each path, results
bit-identical with the profiler on and off, no ``record_function`` entered
with the profiler off, and the Monitor's ranges and report."""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dr3_tpu_torch.ba import snavely as sn
from dr3_tpu_torch.utils import timing
from dr3_tpu_torch.utils.timing import Monitor
from torch_parity import rand_bal

ITERS = 3
# each path's stages inside an LM iteration, and the spans nested in them
STAGES = {"zexplicit": ["dr3.ba.assemble", "dr3.ba.z_build", "dr3.ba.ztz",
                        "dr3.ba.camera_solve", "dr3.ba.back_substitute", "dr3.ba.accept"],
          "pcg": ["dr3.ba.assemble", "dr3.ba.pcg", "dr3.ba.accept"],
          "explicit": ["dr3.ba.assemble", "dr3.ba.schur_solve", "dr3.ba.accept"]}
NESTED = {"pcg": {"dr3.ba.pcg": ["dr3.ba.back_substitute"]},
          "explicit": {"dr3.ba.schur_solve": ["dr3.ba.reduce", "dr3.ba.back_substitute"]}}


@pytest.fixture(scope="module")
def prob():
    return sn.bal_to_snavely(rand_bal(np.random.default_rng(3), 6, 80, noise=0.5,
                                      pt_noise=0.05), device="cpu")


def _traced(fn):
    """fn()'s result and its program spans in the order they opened, each
    (name, index of the nearest enclosing program span or None), as
    torch.profiler's own events nest them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted((e for e in prof.events() if e.name.startswith("dr3.")),
                 key=lambda e: (e.time_range.start, -e.time_range.end))
    index = {e.id: i for i, e in enumerate(evs)}

    def parent(e):
        e = e.cpu_parent
        while e is not None and e.id not in index:
            e = e.cpu_parent
        return None if e is None else index[e.id]

    return out, [(e.name, parent(e)) for e in evs]


@pytest.mark.parametrize("solver", ["zexplicit", "pcg", "explicit"])
def test_solve_spans_on_each_path(prob, solver):
    assert sn._pick_method(prob, solver)[0] == solver
    res, found = _traced(lambda: sn.bundle_adjust_snavely(prob, ITERS, solver=solver))
    nested = NESTED.get(solver, {})
    names = Counter(n for n, _ in found)
    assert names == Counter({"dr3.ba.solve": 1, "dr3.ba.lm_iter": ITERS,
                             **{s: ITERS for s in STAGES[solver]},
                             **{s: ITERS for kids in nested.values() for s in kids}})
    # each stage once inside each iteration, in the path's order
    want = {"dr3.ba.solve": ["dr3.ba.lm_iter"] * ITERS, "dr3.ba.lm_iter": STAGES[solver],
            **nested}
    for i, (n, _) in enumerate(found):
        assert [k for k, p in found if p == i] == want.get(n, []), n

    # the same bits with the profiler off
    plain = sn.bundle_adjust_snavely(prob, ITERS, solver=solver)
    for k in sn._PARAMS + ("final_cost", "lambda_final", "n_accepted", "initial_cost"):
        a = getattr(res.problem, k) if k in sn._PARAMS else getattr(res, k)
        b = getattr(plain.problem, k) if k in sn._PARAMS else getattr(plain, k)
        assert torch.equal(a, b), k
    assert res.cg_iters == plain.cg_iters


def test_generic_pcg_spans(prob, monkeypatch):
    """The generic pcg path (past the one-hot's limit): inside each
    ``schur_solve`` one ``reduce``, one ``cg_setup``, a ``cg_read`` before
    each ``cg_step`` and one more that ends the loop, one
    ``back_substitute``; as many ``cg_step`` as the result's CG count."""
    monkeypatch.setattr(sn, "_ONEHOT_MAX_ELEMS", 0)
    assert sn._pick_method(prob, "pcg") == ("pcg", False)
    res, found = _traced(lambda: sn.bundle_adjust_snavely(prob, ITERS, solver="pcg"))
    names = Counter(n for n, _ in found)
    assert names["dr3.ba.cg_step"] == res.cg_iters > 0
    assert names["dr3.ba.reduce"] == names["dr3.ba.schur_solve"] == ITERS
    assert names["dr3.ba.cg_read"] == res.cg_iters + ITERS
    solves = [i for i, (n, _) in enumerate(found) if n == "dr3.ba.schur_solve"]
    for i in solves:
        kids = [k for k, p in found if p == i]
        steps = kids.count("dr3.ba.cg_step")
        assert kids == (["dr3.ba.reduce", "dr3.ba.cg_setup"]
                        + ["dr3.ba.cg_read", "dr3.ba.cg_step"] * steps
                        + ["dr3.ba.cg_read", "dr3.ba.back_substitute"])
    plain = sn.bundle_adjust_snavely(prob, ITERS, solver="pcg")
    assert torch.equal(plain.final_cost, res.final_cost) and plain.cg_iters == res.cg_iters


def test_no_range_without_a_profiler(prob, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(timing, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for solver in STAGES:
        sn.bundle_adjust_snavely(prob, 1, solver=solver)
    m = Monitor()
    m.tic("stage")
    m.toc("stage", block=torch.zeros(1))
    assert timing.span("x") is timing.span("y")          # the one shared no-op
    assert m["stage"].n == 1


def test_monitor_ranges_and_report(monkeypatch):
    clock = iter(range(1000))
    monkeypatch.setattr(timing, "time", SimpleNamespace(perf_counter=lambda: 0.001 * next(clock)))

    def stages():
        m = Monitor()
        for _ in range(2):
            m.tic("frame")
            m.tic("klt")
            m.toc("klt", block=torch.ones(2))
            m.toc("frame")
        m.tic("detect")                   # a tic with no toc, then again
        m.tic("detect")
        m.toc("detect")
        return m.report(n_frames=2, extra={"kf": 1})

    traced, found = _traced(stages)
    clock = iter(range(1000))
    assert stages() == traced             # the report's text, byte for byte
    assert found == [("dr3.frame", None), ("dr3.klt", 0), ("dr3.frame", None), ("dr3.klt", 2),
                     ("dr3.detect", None), ("dr3.detect", None)]
    assert "frame" in traced and "dr3." not in traced
