"""The port's benchmark (dr3_tpu_torch/bench.py) against the repository's
root ``bench.py`` on the CPU.

* ``_window_problem``: the window BA problem (32 cameras x 16,384 points x
  546 slots) from the same generator: the observation indices, weights and
  perturbed points bit-equal, the cameras to 1e-6, ``uv`` within 1e-3 px
  (float32 projections in two packages, plus the same noise draws).
* The parent-and-child contract with ``BENCH_DEVICE=cpu`` at tiny depth
  (BA and pipeline skipped): one JSON line with the root bench.py's keys,
  the front-end and panorama metrics in ``extra`` with their details and
  sources, no errors, a ``[bench] name:`` line per metric on stderr.
* Without a card and without ``BENCH_DEVICE=cpu`` each child raises and the
  parent records the error (it never falls back to the CPU).
* The pipeline metric's detail keys, on a few 320x240 frames.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_window_problem_matches_bench():
    import jax.numpy as jnp

    import bench as jax_bench
    from dr3_tpu_torch import bench

    jp = jax_bench._window_problem(jnp, np.random.default_rng(0))
    tp = bench._window_problem(np.random.default_rng(0))
    assert tp.obs_cam.shape == (32 * 546,) and tp.points.shape == (16384, 3)
    for name in ("obs_cam", "obs_pt", "obs_w", "points", "cam_fixed"):
        a, b = np.asarray(getattr(jp, name)), nn(getattr(tp, name))
        assert np.array_equal(a, b), name
    assert 0 < nn(tp.obs_w).sum() < tp.obs_w.numel()
    for name in ("cam_wxyz", "cam_t", "intrinsics"):
        np.testing.assert_allclose(nn(getattr(tp, name)), np.asarray(getattr(jp, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(nn(tp.obs_uv), np.asarray(jp.obs_uv), rtol=0, atol=1e-3)


def _bench(timeout, **env):
    full = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    full.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2", BENCH_SKIP_BA="1",
                BENCH_SKIP_PIPELINE="1", **env)
    out = subprocess.run([sys.executable, "-m", "dr3_tpu_torch.bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout, env=full)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0]), out.stderr


def test_bench_parent_and_children_on_the_cpu():
    line, err = _bench(240, BENCH_DEVICE="cpu", BENCH_FRAMES="2", BENCH_REPS="1")
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "slam_pipeline_frames_per_sec_per_chip"
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0   # pipeline skipped
    extra = line["extra"]
    assert "errors" not in extra, extra.get("errors")
    assert extra["vo_frontend_frames_per_sec_scan"] > 0
    assert extra["panorama_images_per_sec"] > 0
    assert "ba_window_lm_iters_per_sec" not in extra and "pipeline_detail" not in extra
    fe, pan = extra["frontend_detail"], extra["panorama_detail"]
    assert fe["device"] == pan["device"] == "cpu"
    assert fe["frames_per_rep"] == 2 and fe["reps"] == 1
    assert pan["images"] == 8 and pan["canvas"][2] == 3
    # CPU tensors take the plain versions, which count no kernel launch
    assert set(fe["launches"]) >= {"track_pyramid", "corner_response_pyramid", "remap_xy",
                                   "sparse_align", "warp_spherical"}
    assert not any(fe["launches"].values()) and not any(pan["launches"].values())
    assert extra["frames_source"].startswith("rendered")
    assert extra["panorama_source"].startswith("rendered")
    assert "card" in extra
    assert "[bench] frontend: " in err and "[bench] panorama: " in err


def test_bench_without_a_card_records_each_child_failure():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the children would run on it")
    line, err = _bench(120)
    errors = line["extra"]["errors"]
    assert set(errors) == {"frontend", "panorama"}
    for msg in errors.values():
        assert msg.startswith("rc=1") and "is_available() is False" in msg, msg
    assert line["value"] == 0.0
    assert "vo_frontend_frames_per_sec_scan" not in line["extra"]


def test_pipeline_detail_keys():
    """The pipeline metric's contract on 12 frames at 320x240 (which do not
    bootstrap at the benchmark's Config: 88 grid cells, fewer than its 100
    initial features): the root bench.py's detail keys, fps_device_bound
    null with its note, every timed frame counted."""
    from dr3_tpu_torch import bench

    cam, frames, source = bench.pipeline_frames(12, 320, 240)
    assert len(frames) == 12 and frames[0].dtype == np.uint8 and frames[0].shape == (240, 320)
    fps, d = bench._bench_pipeline(torch.device("cpu"), cam, frames, source)
    assert fps > 0
    assert set(d) >= {"fps_steady_state", "fps_mapping_phase", "fps_device_bound",
                      "device_bound_event_free", "timed_frames", "warmup_frames",
                      "timed_keyframes", "loop_closures_total", "loop_closures_timed",
                      "mapping_phase_keyframes", "discarded_speculative_batches",
                      "frames_per_dispatch", "speculation_depth", "stage_breakdown",
                      "frames_source", "launches", "device_bound_note"}
    assert d["fps_device_bound"] is None and d["device_bound_event_free"] is None
    assert d["timed_frames"] == 12 - d["warmup_frames"] + 8
    assert d["frames_per_dispatch"] == 32 and d["frames_source"] == source
