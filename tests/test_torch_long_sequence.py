"""The port's long-sequence entry point (dr3_tpu_torch/tools/run_long_sequence.py)
against the JAX package's tools/run_long_sequence.py, loaded by path, on the
CPU: ``make_sequence`` renders the same poses and frames bit for bit in
both profiles, and ``main`` over a short lateral sequence (40 frames of
320x240: the bootstrap's two keyframes and one general keyframe at frame
30) takes the same decisions as the JAX tool's: the same keyframe count,
compactions, closures and relocalizations, ATE within 1% of the path and
the same JSON keys. The port's RANSAC draws are JAX's (the JAX MonoVO's key
chain, tests/test_torch_vo.py), and the port runs batched
(``process_batch``, bit-equal to ``process``) where the JAX tool runs frame
by frame (``--batch 1``)."""

import importlib.util
import json
import os

import numpy as np
import pytest

from dr3_tpu_torch.geometry import ransac as transac
from dr3_tpu_torch.tools import run_long_sequence as port_tool
from tests.test_torch_vo import _JaxMinimalSets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 40
# keys whose values are wall-clock measurements
TIMINGS = ("pipeline_frames_per_sec", "wall_clock_total_s")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_run_long_sequence", os.path.join(ROOT, "tools", "run_long_sequence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("profile", ["lateral", "forward"])
def test_make_sequence_matches_jax_bit_for_bit(profile):
    cam, poses, frames = port_tool.make_sequence(6, 96, 64, np.random.default_rng(7), profile)
    jcam, jposes, jframes = _jax_tool().make_sequence(6, 96, 64, np.random.default_rng(7),
                                                      profile)
    for k in ("fx", "fy", "cx", "cy"):
        assert float(getattr(cam, k)) == float(getattr(jcam, k))
    assert (cam.width, cam.height) == (jcam.width, jcam.height) == (96, 64)
    assert len(poses) == len(jposes) == len(frames) == len(jframes) == 6
    for T, J in zip(poses, jposes):
        np.testing.assert_array_equal(T.R, J.R)
        np.testing.assert_array_equal(T.t, J.t)
    for f, g in zip(frames, jframes):
        assert f.dtype == np.float32 and f.shape == (64, 96)
        np.testing.assert_array_equal(f, np.asarray(g))


def _json_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_matches_jax_tool(capsys, monkeypatch):
    monkeypatch.setenv("DR3_COMPILE_CACHE", "off")   # the JAX tool writes no cache
    assert _jax_tool().main(["--frames", str(N_FRAMES), "--cpu", "--batch", "1"]) == 0
    want = _json_line(capsys)

    sampler = _JaxMinimalSets(seed=0)
    monkeypatch.setattr(transac, "sample_minimal_sets", sampler)
    held = {}
    assert port_tool.main(["--frames", str(N_FRAMES), "--device", "cpu"],
                          on_step=lambda vo: held.update(vo=vo)) == 0
    got = _json_line(capsys)
    vo = held["vo"]

    assert sampler.calls >= 1
    assert set(got) == set(want)
    assert sum(s.is_keyframe and s.stage == "general" for s in vo.stats) >= 1
    for k in ("frames", "resolution", "keyframes", "map_compactions", "loop_closures",
              "relocalizations", "distributed"):
        assert got[k] == want[k], k
    assert want["keyframes"] >= 3
    assert (got["frames_per_dispatch"], want["frames_per_dispatch"]) == (8, 1)
    assert abs(got["trajectory_length"] - want["trajectory_length"]) < 1e-3
    assert abs(got["ate_rmse"] - want["ate_rmse"]) < 0.01 * want["trajectory_length"]
    assert all(got[k] > 0 for k in TIMINGS)


def test_card_is_the_default():
    """Without a card the default device refuses, as run_slam does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit, match="--device cpu"):
        port_tool.main(["--frames", "4"])
