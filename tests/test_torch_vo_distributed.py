"""The mesh branch of the port's MonoVO (port of
tests/test_vo_distributed.py): the distributed window BA against the JAX
package's on the same window, ``MonoVO(mesh=...)`` against the unsharded
MonoVO, and ``run_slam --distributed`` on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dr3_tpu import state as jstate
from dr3_tpu.parallel.mesh import make_mesh as j_make_mesh
from dr3_tpu.pipelines import vo as jvo
from dr3_tpu.utils.config import Config as JConfig
from dr3_tpu_torch import convert, run_slam
from dr3_tpu_torch.models.camera import Pinhole as TPinhole
from dr3_tpu_torch.parallel.mesh import make_mesh
from dr3_tpu_torch.pipelines import vo as tvo
from dr3_tpu_torch.pipelines.vo import MonoVO, Stage
from dr3_tpu_torch.utils.config import Config
from dr3_tpu_torch.utils.synth import lateral_path, make_textures, render_scene
from tests.torch_parity import nn

CAM = (320, 240, 280.0, 280.0, 160.0, 120.0)
CFG = dict(init_min_features=60, init_min_tracked=60, init_min_triangulated=30,
           init_min_disparity=2.0, max_keyframes=16, kf_disparity=10.0,
           loop_closure=False)
N_FRAMES = 14


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    cam = TPinhole.create(*CAM)
    tn, tf = make_textures(rng)
    poses, _ = lateral_path(N_FRAMES, 0.09)
    return [render_scene(cam, T, tn, tf) for T in poses]


@pytest.fixture(scope="module")
def single(frames):
    vo = MonoVO(TPinhole.create(*CAM), Config(**CFG), device="cpu")
    for f in frames:
        vo.process(f)
    return vo


def test_local_ba_distributed_matches_jax(single):
    """The unsharded run's last window (>= 3 keyframes), its map points
    moved off the optimum (seeded), carried to both packages through
    convert.py's numpy form: the same initial cost (rtol 1e-5), final cost
    rtol 1e-4, keyframe poses within 1e-4 and points within 1e-3 (two
    gauge-fixed keyframes; 8 LM steps of float32 round-off)."""
    assert single.kf_count >= 3
    kfs = convert.to_numpy(single.kfs)
    mp = convert.to_numpy(single.map)
    rng = np.random.default_rng(5)
    mp["xyz"] = (mp["xyz"] + rng.normal(0, 0.02, mp["xyz"].shape)).astype(np.float32)
    cfg = Config(**CFG)
    intr = nn(single.intr)
    tk, tm = convert.keyframe_state(kfs), convert.map_state(mp)
    jk = jstate.KeyframeState(**{k: jnp.asarray(v) for k, v in kfs.items()})
    jm = jstate.MapState(**{k: jnp.asarray(v) for k, v in mp.items()})
    kj, mj, c0j, c1j = jvo._local_ba_distributed(jk, jm, jnp.asarray(intr), None,
                                                 JConfig(**CFG), cfg.ba_max_iters,
                                                 j_make_mesh(4))
    kt, mt, c0t, c1t = tvo._local_ba_distributed(tk, tm, torch.as_tensor(intr), None, cfg,
                                                 cfg.ba_max_iters, make_mesh(4, device="cpu"))
    np.testing.assert_allclose(float(c0t), float(c0j), rtol=1e-5)
    np.testing.assert_allclose(float(c1t), float(c1j), rtol=1e-4)
    assert float(c1t) < 0.5 * float(c0t)
    np.testing.assert_allclose(nn(kt.t), nn(kj.t), atol=1e-4)
    np.testing.assert_allclose(nn(kt.wxyz), nn(kj.wxyz), atol=1e-4)
    v = mp["valid"]
    np.testing.assert_allclose(nn(mt.xyz)[v], nn(mj.xyz)[v], atol=1e-3)


def test_mesh_vo_matches_single(frames, single):
    """MonoVO(mesh=make_mesh(4)) against MonoVO(): the same stage and
    keyframe decisions, positions within 5e-3 (tests/test_vo_distributed.py's
    bound: the unsharded window BA is pcg, the sharded one the dense
    Cholesky, both to the same optimum)."""
    vo = MonoVO(TPinhole.create(*CAM), Config(**CFG), mesh=make_mesh(4, device="cpu"),
                device="cpu")
    for f in frames:
        vo.process(f)
    assert vo.stage is Stage.GENERAL and vo.n_window_ba >= 1
    assert [(s.stage, s.is_keyframe) for s in vo.stats] == \
        [(s.stage, s.is_keyframe) for s in single.stats]
    np.testing.assert_allclose(vo.positions(), single.positions(), atol=5e-3)
    assert vo.n_cg_iters == 0            # the sharded solve is dense
    with pytest.raises(ValueError, match="mesh"):
        MonoVO(TPinhole.create(*CAM), Config(**CFG),
               mesh=make_mesh(device="cpu")._replace(device=torch.device("cuda")),
               device="cpu")


def test_run_slam_distributed_on_cpu(tmp_path, capsys):
    """run_slam --distributed --device cpu over 12 rendered KITTI frames
    (kf_disparity 8 so that three general keyframes come in 12 frames): a
    one-shard mesh, window BA through it, the outputs written."""
    seq = tmp_path / "seq"
    os.makedirs(seq / "image_0")
    rng = np.random.default_rng(3)
    tn, tf = make_textures(rng, size=2000)
    poses, _ = lateral_path(12, 0.08)
    for i, T in enumerate(poses):
        f = render_scene(TPinhole.kitti(), T, tn, tf)
        Image.fromarray(np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)).save(
            seq / "image_0" / f"{i:06d}.png")
    np.savetxt(seq / "times.txt", 0.1 * np.arange(12))
    out = tmp_path / "out"
    assert run_slam.main(["--seq", str(seq), "--out", str(out), "--device", "cpu",
                          "--distributed", "--kf_disparity=8"]) == 0
    text = capsys.readouterr().out
    assert "window BA over a 1 point-shard mesh (rank 0 of 1)" in text
    n_ba = [int(ln.split()[1]) for ln in text.splitlines() if ln.startswith("window_BA")]
    assert n_ba and n_ba[0] >= 3
    # one stats line per frame
    assert sum(ln.startswith("[0") for ln in text.splitlines()) == 12
    for name in ("trajectory.txt", "final.npz", "final.json"):
        assert os.path.getsize(out / name) > 0
