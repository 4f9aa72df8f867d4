"""The port's SLAM CLI (python -m dr3_tpu_torch.run_slam) on the CPU over
12 rendered 1240x376 frames written as a KITTI-layout directory
(image_0/%06d.png + times.txt): the four outputs, a trajectory file equal
to the TUM lines the JAX package's formula gives for the same matrices
(dr3_tpu/run_slam.py:137-148), --resume continuing from the checkpoint,
and the refusals (--device cuda without a card, with --distributed too)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dr3_tpu.geometry.lie import matrix_to_quat as j_matrix_to_quat
from dr3_tpu_torch import run_slam
from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.utils.synth import lateral_path, make_textures, render_scene
from tests.torch_parity import nn  # noqa: F401  (one intra-op thread per worker)

N = 12


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti")
    os.makedirs(d / "image_0")
    rng = np.random.default_rng(3)
    tn, tf = make_textures(rng, size=2000)
    poses, _ = lateral_path(N, 0.08)
    for i, T in enumerate(poses):
        f = render_scene(Pinhole.kitti(), T, tn, tf)
        Image.fromarray(np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)).save(
            d / "image_0" / f"{i:06d}.png")
    np.savetxt(d / "times.txt", 0.1 * np.arange(N) + 3.0)
    return str(d)


@pytest.fixture(scope="module")
def first_run(seq_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    assert run_slam.main(["--seq", seq_dir, "--out", out, "--device", "cpu", "--batch", "4",
                          "--checkpoint-every", "8"]) == 0
    return out


def _jax_tum(trajectory, times):
    """dr3_tpu/run_slam.py:137-148's lines, as numbers."""
    rows = []
    for t, T in zip(times, trajectory):
        R = T[:3, :3]
        c = -R.T @ T[:3, 3]
        q = np.asarray(j_matrix_to_quat(jnp.asarray(R.T)))
        rows.append([t, c[0], c[1], c[2], q[1], q[2], q[3], q[0]])
    return np.asarray(rows)


def test_cli_writes_the_four_outputs(first_run):
    for name in ("trajectory.txt", "slam_map.png", "checkpoint.npz", "checkpoint.json",
                 "final.npz", "final.json"):
        assert os.path.getsize(os.path.join(first_run, name)) > 0, name
    with Image.open(os.path.join(first_run, "slam_map.png")) as im:
        assert im.size[0] > 100 and im.size[1] > 100
    with open(os.path.join(first_run, "checkpoint.json")) as f:
        assert json.load(f)["frame_idx"] == 7
    with open(os.path.join(first_run, "final.json")) as f:
        meta = json.load(f)
    assert meta["frame_idx"] == N - 1 and meta["stage"] == "GENERAL"


def test_trajectory_file_is_jax_tum(first_run, seq_dir):
    got = np.loadtxt(os.path.join(first_run, "trajectory.txt"))
    traj = np.load(os.path.join(first_run, "final.npz"))["trajectory"]
    assert got.shape == (N, 8) and traj.shape == (N, 4, 4)
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"))
    # six printed decimals; the two float32 quaternion formulas may round apart
    np.testing.assert_allclose(got, _jax_tum(traj, times), rtol=0, atol=2e-6)
    assert np.ptp(got[:, 1]) > 0.01         # the camera moved (monocular scale)


def test_resume_continues_from_the_checkpoint(first_run, seq_dir, tmp_path, capsys):
    out = str(tmp_path)
    assert run_slam.main(["--seq", seq_dir, "--out", out, "--device", "cpu", "--batch", "1",
                          "--resume", os.path.join(first_run, "checkpoint")]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[0")]
    assert [ln[:7] for ln in lines] == [f"[{i:05d}]" for i in range(8, N)]
    assert "reseed" in lines[0] and all("general" in ln for ln in lines[1:])
    ckpt = np.load(os.path.join(first_run, "checkpoint.npz"))["trajectory"]
    resumed = np.load(os.path.join(out, "final.npz"))["trajectory"]
    assert resumed.shape == (N, 4, 4)
    np.testing.assert_array_equal(resumed[:8], ckpt)
    tum = np.loadtxt(os.path.join(out, "trajectory.txt"))
    assert tum.shape == (N, 8) and np.isfinite(tum).all()


def test_refusals(seq_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--distributed"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            run_slam.main(["--seq", seq_dir, "--out", str(tmp_path)] + extra)
    assert not os.listdir(tmp_path)
