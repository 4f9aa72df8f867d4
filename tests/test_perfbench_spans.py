"""perfbench/spans.py on synthetic chrome-trace events: the program's
``dr3.*`` ranges nested by time, device operations charged through their
launch's ``correlation``, host launch calls counted, idle gaps charged to
the innermost span, the figures' 90% rule, and ``read_events``' keys left as
they were; and a tiny BAL cell's traced slice read by its spans on the
CPU."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from perfbench import run, spans, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = dict(pid=1, tid=1)


def _span(name, ts, end, **where):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=end - ts,
                **(where or HOST))


def _call(name, ts, corr=None, cat="cuda_runtime", dur=5):
    ev = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **HOST)
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _op(ts, end, corr, cat="kernel", name="k"):
    return dict(ph="X", cat=cat, name=name, pid=0, tid=7, ts=ts, dur=end - ts,
                args={"correlation": corr})


def events(outside=True):
    """One solve of two LM iterations (us): the spans, the host's calls
    (launches, a driver call inside a runtime call, a sync, a torch op, a
    harness range that is not the program's) and the device's operations.
    With ``outside``, a kernel launched outside every span and one whose
    launch the trace lacks."""
    ev = [_span("bundle_adjust_snavely", 0, 1200),
          _span("dr3.ba.solve", 0, 1000),
          _span("dr3.ba.lm_iter", 100, 500),
          _span("dr3.ba.assemble", 110, 200),
          _span("dr3.ba.ztz", 210, 400),
          _span("dr3.ba.lm_iter", 500, 900),
          _span("dr3.ba.assemble", 510, 600),
          _span("dr3.ba.ztz", 605, 800),
          dict(ph="X", cat="cpu_op", name="aten::mul", ts=115, dur=10, **HOST),
          _call("cudaLaunchKernel", 50, 1), _op(60, 80, 1),
          _call("cudaLaunchKernel", 120, 2), _op(130, 180, 2),
          _call("cudaMemsetAsync", 150, 3), _op(180, 190, 3, cat="gpu_memset", name="Memset"),
          _call("cudaLaunchKernel", 220, 4),
          _call("cuLaunchKernel", 221, 40, cat="cuda_driver", dur=2), _op(240, 400, 4),
          _call("cudaLaunchKernel", 450, 8), _op(450, 460, 8),
          _call("cudaLaunchKernel", 520, 5), _op(520, 600, 5),
          _call("cudaLaunchKernel", 620, 6), _op(620, 820, 6),
          _call("cudaStreamSynchronize", 850, dur=100)]
    if outside:
        ev += [_call("cudaLaunchKernel", 1100, 7), _op(1100, 1150, 7), _op(1160, 1170, 99)]
    return ev


def test_spans_nest_on_their_thread():
    th = spans._Thread([e for e in events() if e["name"].startswith("dr3.")])
    names = [s["name"] for s in th.spans]
    parents = [None if p is None else names[p] for p in th.parent]
    assert list(zip(names, parents)) == [
        ("dr3.ba.solve", None), ("dr3.ba.lm_iter", "dr3.ba.solve"),
        ("dr3.ba.assemble", "dr3.ba.lm_iter"), ("dr3.ba.ztz", "dr3.ba.lm_iter"),
        ("dr3.ba.lm_iter", "dr3.ba.solve"), ("dr3.ba.assemble", "dr3.ba.lm_iter"),
        ("dr3.ba.ztz", "dr3.ba.lm_iter")]
    assert th.parent[2] == 1 and th.parent[6] == 4
    # the innermost span open at a time, the parent's once a child has ended
    assert [th.innermost(t) for t in (-1, 105, 300, 450, 950, 1000)] == \
        [None, 1, 3, 1, 0, None]


def _read(ev):
    return spans.read(ev)


def test_device_ops_charged_through_their_launch():
    by = _read(events())["by_name"]
    own = {k: round(v["device_s"] * 1e6, 6) for k, v in by.items()}
    assert own == {"dr3.ba.solve": 20, "dr3.ba.lm_iter": 10, "dr3.ba.assemble": 140,
                   "dr3.ba.ztz": 360}
    assert round(by["dr3.ba.lm_iter"]["device_s_total"] * 1e6, 6) == 10 + 140 + 360
    assert round(by["dr3.ba.solve"]["device_s_total"] * 1e6, 6) == 530
    # the kernel launched outside every span and the one with no launch
    assert round(_read(events())["outside_s"] * 1e6, 6) == 60
    assert {k: v["n"] for k, v in by.items()} == {"dr3.ba.solve": 1, "dr3.ba.lm_iter": 2,
                                                  "dr3.ba.assemble": 2, "dr3.ba.ztz": 2}
    assert round(by["dr3.ba.lm_iter"]["host_s"] * 1e6, 6) == 800


def test_launch_calls_counted_once_each():
    by = _read(events())["by_name"]
    assert {k: v["launches"] for k, v in by.items()} == {
        "dr3.ba.solve": 1, "dr3.ba.lm_iter": 1, "dr3.ba.assemble": 3, "dr3.ba.ztz": 2}
    # a sync is no launch, and the driver call inside a runtime call is the
    # same launch
    assert by["dr3.ba.lm_iter"]["launches_total"] == 6
    assert by["dr3.ba.solve"]["launches_total"] == 7


def test_idle_gaps_charged_to_the_innermost_span():
    sp = _read(events())
    gaps = {k: round(v * 1e6, 6) for k, v in sp["idle_gaps"]}
    assert gaps == {"dr3.ba.solve": 280, "dr3.ba.lm_iter": 160, "dr3.ba.ztz": 70,
                    spans.OUTSIDE: 10}
    assert [k for k, _ in sp["idle_gaps"]] == ["dr3.ba.solve", "dr3.ba.lm_iter", "dr3.ba.ztz",
                                               spans.OUTSIDE]
    assert round(sp["by_name"]["dr3.ba.ztz"]["idle_s"] * 1e6, 6) == 70
    assert round(sp["charged_s"]["dr3.ba"] * 1e6, 6) == 530


def test_idle_gaps_charged_on_the_host_calls_thread():
    """A program span open on another thread takes no gap that the host
    spent inside the spans of its own thread."""
    other = _span("dr3.other", -10, 1000, pid=1, tid=2)
    sp = _read(events() + [other])
    assert sp["idle_gaps"] == _read(events())["idle_gaps"]
    assert sp["by_name"]["dr3.other"]["idle_s"] == 0.0


def _reading(ev):
    """What :func:`spans.profile` returns for a profiled slice of ``ev``."""
    return dict(trace.read_events(ev, 1300e-6), spans=spans.read(ev))


DEVICE_FIGURES = list(spans.BAL_STAGES)


@pytest.mark.parametrize("outside,want", [
    # 530 of 590 us busy charged to dr3.ba spans: under 90%, no device figure
    (True, {}),
    (False, {"bal.assembly_ms_per_lm_iter": 0.07, "bal.ztz_ms_per_lm_iter": 0.18,
             "bal.step_ms_per_lm_iter": 0.0})])
def test_readers_and_the_90_percent_rule(outside, want):
    got = spans.figures(_reading(events(outside)))
    assert {k: round(got[k], 9) for k in DEVICE_FIGURES if k in got} == want
    assert got["bal.host_ms_per_lm_iter"] == pytest.approx(0.4)
    assert got["bal.launches_per_lm_iter"] == 3.0


def test_readers_say_nothing_without_the_programs_spans():
    """A program without the spans gives no figure, and a trace with no
    device work (the CPU) the host's alone; the benchmark's own reader of
    the solve's device time is untouched by the spans."""
    bare = [e for e in events() if not e["name"].startswith("dr3.")]
    assert spans.figures(_reading(bare)) == {}
    cpu = [e for e in events() if e["cat"] in ("user_annotation", "cpu_op")]
    got = spans.figures(_reading(cpu))
    assert list(got) == ["bal.host_ms_per_lm_iter"]
    assert got["bal.host_ms_per_lm_iter"] == pytest.approx(0.4)
    path = os.path.join(ROOT, "perfbench", "layer_metrics", "bal.device_ms_per_lm_iter.py")
    reader = run.load_module(path, "m_bal_device_ms_per_lm_iter").read
    assert reader({"trace": trace.read_events(cpu, 1300e-6)}) is None


# read_events of the synthetic trace: the benchmark's reading, which the
# spans leave as it is
BEFORE = {
    "window_s": 1300e-6,
    "busy_s": 590e-6,
    "device_ops": [["k", 580e-6], ["Memset", 10e-6]],
    "idle_gaps": [["host: dr3.ba.solve", 280e-6], ["host: dr3.ba.lm_iter", 160e-6],
                  ["host: dr3.ba.ztz", 70e-6], ["host: bundle_adjust_snavely", 10e-6]],
    "kernel_s": {"k": [580e-6, 8]},
    "device_events": 9,
    "graph_launches": 0,
}


def test_read_events_keeps_its_keys_and_values():
    out = trace.read_events(events(), 1300e-6)
    assert set(out) == set(BEFORE)
    assert set(_reading(events())) == set(BEFORE) | {"spans"}
    for key, want in BEFORE.items():
        got = out[key]
        if key in ("device_ops", "idle_gaps"):
            assert [k for k, _ in got] == [k for k, _ in want], key
            assert [v for _, v in got] == pytest.approx([v for _, v in want], abs=1e-12), key
        elif key == "kernel_s":
            assert {k: (pytest.approx(v[0], abs=1e-12), v[1]) for k, v in got.items()} == \
                {k: (v[0], v[1]) for k, v in want.items()}
        else:
            assert got == pytest.approx(want, abs=1e-12), key


def test_cell_slice_read_by_spans_on_the_cpu(tmp_path):
    """``run_cell`` on a copy of the benchmark with an 8-camera BAL problem:
    the traced slice's reading holds the program's BAL spans, the host's
    figure and no device figure."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    conf = tmp_path / "perfbench" / "configs" / "bal-dubrovnik-88.json"
    c = json.loads(conf.read_text())
    c["problem"] = dict(cameras=8, points=600, observations=1600)
    conf.write_text(json.dumps(c))
    (tr,) = spans.run_cell(str(tmp_path), "bal-dubrovnik-88", 2**31 + 77, 0.2, 1, "cpu")
    iters = c["solve"]["lm_iterations"]
    by = tr["spans"]["by_name"]
    assert by["dr3.ba.solve"]["n"] == 1 and by["dr3.ba.lm_iter"]["n"] == iters
    assert all(by["dr3.ba." + s]["n"] == iters for s in ("assemble", "z_build", "ztz",
                                                           "camera_solve", "back_substitute",
                                                           "accept"))
    assert list(tr["figures"]) == ["bal.host_ms_per_lm_iter"]
    assert 0 < tr["figures"]["bal.host_ms_per_lm_iter"] < 1e3 * tr["window_s"]
