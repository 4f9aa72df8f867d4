"""The port's two-view CLI (dr3_tpu_torch.run_twoview) against the JAX
package's run_twoview pieces on two rendered 320x240 frames written as
PNGs: ``--device cpu --init --map`` runs and writes both renderings, and
with JAX's draws handed over (its CLI hands PRNGKey(seed) to both RANSACs,
run_twoview.py:63-80) the F inliers and the bootstrap's R / t agree."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.geometry import ransac as jransac
from dr3_tpu.geometry.lie import SE3 as JSE3
from dr3_tpu.io.image import load_image as j_load, to_gray as j_gray
from dr3_tpu.models.camera import Pinhole as JPinhole
from dr3_tpu.pipelines.stitch import find_correspondences as j_corr
from dr3_tpu.pipelines.twoview_init import initialize_two_view as j_init
from dr3_tpu.utils.config import Config as JConfig
from dr3_tpu_torch import run_twoview
from dr3_tpu_torch.geometry import ransac as transac
from dr3_tpu_torch.io.image import save_image
from tests.synth import make_textures, render_scene
from tests.torch_parity import nn

CAM = (320, 240, 280.0, 280.0, 160.0, 120.0)
# the camera, and tests/test_slam_legacy.py's finer grid (Config's default
# 30 px cells leave ~15 ZNCC matches at 320x240)
K_FLAGS = ["--fx", "280", "--fy", "280", "--cx", "160", "--cy", "120",
           "--cell_size=12", "--fast_threshold=8.0"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("twoview")
    rng = np.random.default_rng(3)
    cam = JPinhole.create(*CAM)
    tn, tf = make_textures(rng)
    taus = ([0.0] * 6, [-0.6, 0.0, 0.0, 0.0, 0.03, 0.0])
    paths = []
    for i, tau in enumerate(taus):
        img = np.asarray(render_scene(cam, JSE3.exp(jnp.asarray(tau, jnp.float32)), tn, tf))
        paths.append(str(d / f"f{i}.png"))
        save_image(img, paths[-1])
    return d, paths, JSE3.exp(jnp.asarray(taus[1], jnp.float32))


def _jax_pieces(paths, seed=0):
    """What dr3_tpu/run_twoview.py computes, without its renderings."""
    cfg = JConfig(cell_size=12, fast_threshold=8.0)
    lg = jnp.asarray(j_gray(j_load(paths[0])))
    rg = jnp.asarray(j_gray(j_load(paths[1])))
    p1, p2, w = jax.jit(j_corr, static_argnums=2)(lg, rg, cfg)
    key = jax.random.PRNGKey(seed)
    fr = jransac.ransac_fundamental(key, p1, p2, w, n_samples=cfg.init_ransac_iters,
                                    sigma=cfg.init_sigma)
    K = jnp.asarray([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]], jnp.float32)
    res = j_init(key, p1, p2, w > 0, K, cfg)
    return (int(np.asarray(w).sum()), np.asarray(fr.inliers),
            np.asarray(res.T_cur_ref.rotation().matrix()), np.asarray(res.T_cur_ref.t),
            bool(res.success))


def _parse(out: str):
    lines = out.splitlines()
    head = next(ln for ln in lines if ln.startswith("matches:"))
    n_match, n_inl = int(head.split()[1]), int(head.split()[3])
    boot = next(ln for ln in lines if ln.startswith("bootstrap success:"))
    i = lines.index(next(ln for ln in lines if ln.startswith("R =")))
    R = np.array([[float(v) for v in ln.strip(" []").split()] for ln in lines[i + 1:i + 4]])
    t_line = next(ln for ln in lines if ln.startswith("t ="))
    t = np.array([float(v) for v in t_line[3:].strip(" []").split()])
    return n_match, n_inl, boot.split()[2] == "True", R, t


class _SameKeyTwice:
    """Stands in for the port's sampler with JAX's sets: its CLI hands
    PRNGKey(seed) unsplit to both RANSACs."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, generator, n_points, weights, n_samples, sample_size):
        self.calls += 1
        idx = jransac.sample_minimal_sets(self.key, n_points, jnp.asarray(nn(weights)),
                                          n_samples, sample_size)
        return torch.as_tensor(np.array(idx))


def test_cli_matches_jax_pieces(pair, monkeypatch, capsys):
    """With JAX's draws: the same match count and F inliers (at most 2 rows
    flip on the chi-square gate), bootstrap success in both, R within 0.25
    degrees and t's direction within 2 degrees of JAX's. The pair's
    baseline is short (2.2 degrees of parallax): JAX's own correspondences
    jitted or run op by op move its R by 0.09 degrees."""
    d, paths, _ = pair
    sampler = _SameKeyTwice()
    monkeypatch.setattr(transac, "sample_minimal_sets", sampler)
    rc = run_twoview.main(paths + ["--device", "cpu", "--init", "--out", str(d / "e.png")]
                          + K_FLAGS)
    assert rc == 0 and sampler.calls == 2
    n_match, n_inl, ok, R, t = _parse(capsys.readouterr().out)
    jm, jinl, jR, jt, jok = _jax_pieces(paths)
    assert n_match == jm
    assert abs(n_inl - int(jinl.sum())) <= 2
    assert ok and jok
    ang = np.degrees(np.arccos(np.clip((np.trace(R.T @ jR) - 1) / 2, -1, 1)))
    tdir = np.degrees(np.arccos(np.clip(t @ jt / np.linalg.norm(t) / np.linalg.norm(jt), -1, 1)))
    assert ang < 0.25 and tdir < 2.0, (ang, tdir)


def test_cli_runs_and_writes(pair, capsys):
    """--device cpu --init --map with the port's own generator: more than
    100 F inliers, the bootstrap succeeds with the rotation within 1 degree
    of the truth, and both PNGs are written (this host has matplotlib)."""
    d, paths, T_true = pair
    out, mp = str(d / "epi.png"), str(d / "map.png")
    assert run_twoview.main(paths + ["--device", "cpu", "--init", "--out", out, "--map", mp]
                            + K_FLAGS) == 0
    text = capsys.readouterr().out
    n_match, n_inl, ok, R, _ = _parse(text)
    assert n_inl > 100 and ok, text
    R_gt = np.asarray(T_true.rotation().matrix())
    ang = np.degrees(np.arccos(np.clip((np.trace(R.T @ R_gt) - 1) / 2, -1, 1)))
    assert ang < 1.0, ang
    for p in (out, mp):
        assert os.path.getsize(p) > 5000 and f"wrote {p}" in text


def test_cli_refuses_cuda_without_card(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        run_twoview.main(pair[1])


def test_cli_says_when_matplotlib_is_absent(pair, monkeypatch, capsys):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    d, paths, _ = pair
    out, mp = str(d / "no_epi.png"), str(d / "no_map.png")
    run_twoview.main(paths + ["--device", "cpu", "--init", "--out", out, "--map", mp] + K_FLAGS)
    text = capsys.readouterr().out
    assert f"{out} not written: matplotlib is not installed" in text
    assert f"{mp} not written: matplotlib is not installed" in text
    assert not os.path.exists(out) and not os.path.exists(mp)
