"""BENCHMARK.json against the benchmark's rules, and the harness's files
found by name from it. CPU only."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from perfbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _with_vo_cells(bench: dict) -> dict:
    """The benchmark with the VO cells' entries added, as a later change
    would add them (``vo_cells.json``; their files are all in perfbench/)."""
    with open(os.path.join(ROOT, "perfbench", "tests", "vo_cells.json")) as f:
        vo = json.load(f)
    return {k: v + vo[k] if k in vo else v for k, v in bench.items()}


@pytest.fixture(scope="module", params=["as committed", "with the VO cells"])
def bench(request):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    return b if request.param == "as committed" else _with_vo_cells(b)


def _text_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(_text_ok(w) for w in bench["command"]) and len(bench["command"]) <= 32
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text_ok(c["source"]) and _text_ok(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text_ok(m["layer"])
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == \
        len(bench["workloads"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_a_full_check(bench):
    """2 + 14 x 24 runs at run_seconds + 60 s, 2 x 90 s a cell to compile
    and 1200 s spare fit in 43,200 s."""
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_every_cell_resolves_its_files(bench, tmp_path):
    cells = {w["name"] for w in bench["workloads"]}
    root = tmp_path / "copy"
    root.mkdir()
    os.symlink(os.path.join(ROOT, "perfbench"), root / "perfbench", target_is_directory=True)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for w in bench["workloads"]:
        spec = run.cell_spec(str(root), w["name"])
        assert os.path.isfile(spec["driver"])
        assert all(os.path.isfile(p) for p in spec["readers"].values())
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
        assert spec["limits"]["limits"]
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in bench["workloads"])
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"] and "assumed" in data
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_layer_metric_cells_report_what_it_moves(bench):
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in bench["workloads"]]))
           for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", [])) <= e2e[m["moves"]]


def test_layers_named_alike(bench):
    """A layer has one name, as PERF.md's list of layers gives it."""
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in bench["per_layer"]}:
        assert f"| {layer} |" in perf


def test_command_names_only_the_harness(bench):
    assert bench["paths"] == ["perfbench"]
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A configuration, cells and per-layer metrics (the VO cells' entries)
    and a throwaway traffic mix with its cell, added as new files and new
    entries in a copy of the repository's benchmark, resolve with no edit
    to any file that was there."""
    root = tmp_path / "copy"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    traffic = json.loads((root / "perfbench/workloads/kitti-lateral-batch.json").read_text())
    traffic["chunk_frames"] = 32
    (root / "perfbench/workloads/kitti-lateral-batch32.json").write_text(json.dumps(traffic))
    (root / "perfbench/limits/vo-kitti-offline32.json").write_text(
        (root / "perfbench/limits/vo-kitti-offline.json").read_text())
    bench = _with_vo_cells(json.loads((root / "BENCHMARK.json").read_text()))
    bench["workloads"].append({"name": "vo-kitti-offline32", "config": "kitti-mono-vo",
                               "traffic": "kitti-lateral-batch32", "chips": 1,
                               "why": "throwaway"})
    for m in bench["end_to_end"]:
        if m["name"] == "vo_fps":
            m["workloads"].append("vo-kitti-offline32")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.cell_spec(str(root), "vo-kitti-offline32")
    assert spec["traffic"]["chunk_frames"] == 32
    assert spec["driver"].endswith("drivers/vo_batch.py")
    assert {m["name"] for m in spec["end_to_end"]} == {"vo_fps", "setup_s"}
    live = run.cell_spec(str(root), "vo-kitti-live")
    assert {m["name"] for m in live["per_layer"]} == {
        "driver.nonkf_frame_p50_ms.live", "window_ba.local_ba_ms.live",
        "hand_kernels_roofline.vo_live", "device.idle_pct.vo_live"}
    assert all(os.path.isfile(p) for p in live["readers"].values())
    changed = [p for p, b in before.items() if p.read_bytes() != b and p.name != "BENCHMARK.json"]
    assert changed == []
