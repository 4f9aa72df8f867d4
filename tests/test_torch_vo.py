"""Port parity for the whole slice: MonoVO.process with
Config(loop_closure=False) on a rendered 320x240 sequence, dr3_tpu (JAX on
the CPU) vs dr3_tpu_torch (PyTorch on the CPU, the kernels' plain twins).

(a) step parity: the JAX driver's full state after a general frame is
    carried across with dr3_tpu_torch.convert, then both packages run the
    next three frames (one of them a keyframe with window BA);
(b) whole run: both packages from the first frame, with JAX's RANSAC
    minimal sets handed to the port's sampler.

Known divergence budgeted in (b): the JAX bootstrap scatters rejected rows
onto map slot 0 with its old value, so JAX usually loses map point 0
(vo.py:1172-1176); the port keeps it. The port may thus hold one more map
point, and tracks of point 0 contribute to its pose/BA solves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.geometry import ransac as jransac
from dr3_tpu.geometry.lie import SE3 as JSE3
from dr3_tpu.models.camera import Pinhole as JPinhole
from dr3_tpu.pipelines.vo import MonoVO as JMonoVO
from dr3_tpu.utils.config import Config as JConfig
from dr3_tpu_torch import convert
from dr3_tpu_torch.geometry import ransac as transac
from dr3_tpu_torch.models.camera import Pinhole as TPinhole
from dr3_tpu_torch.pipelines.vo import MonoVO as TMonoVO
from dr3_tpu_torch.pipelines.vo import Stage
from dr3_tpu_torch.utils.config import Config
from tests.synth import make_textures, render_scene

N_FRAMES = 14
CFG = dict(init_min_features=60, init_min_tracked=60, init_min_triangulated=30,
           init_min_disparity=2.0, max_keyframes=16, kf_disparity=10.0,
           loop_closure=False)
CAM = (320, 240, 280.0, 280.0, 160.0, 120.0)


def _snapshot(vo: JMonoVO) -> dict:
    """The JAX driver's state as numpy (convert.monovo's format)."""
    np_dict = lambda s: {k: np.asarray(v) for k, v in s._asdict().items()}  # noqa: E731
    return dict(
        stage=vo.stage.value, frame_idx=vo.frame_idx, kf_count=vo.kf_count,
        point_cursor=vo.point_cursor, last_kf_tracked=vo.last_kf_tracked,
        lost_count=vo.lost_count, n_relocalizations=vo.n_relocalizations,
        T_cur=(np.asarray(vo.T_cur.wxyz), np.asarray(vo.T_cur.t)),
        T_anchor=(np.asarray(vo.T_anchor.wxyz), np.asarray(vo.T_anchor.t)),
        tracks=np_dict(vo.tracks), kfs=np_dict(vo.kfs), map=np_dict(vo.map),
        pyr_prev=None if vo.pyr_prev is None else [np.asarray(p) for p in vo.pyr_prev],
        trajectory=list(vo.trajectory), traj_local=list(vo._traj_local))


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(0)
    cam = JPinhole.create(*CAM)
    tn, tf = make_textures(rng)
    frames = [np.asarray(render_scene(
        cam, JSE3.exp(jnp.asarray([-0.09 * i, 0, 0, 0, 0, 0], jnp.float32)), tn, tf))
        for i in range(N_FRAMES)]
    vo = JMonoVO(cam, JConfig(**CFG))
    snaps = []
    for f in frames:
        vo.process(f)
        snaps.append(_snapshot(vo))
    return dict(frames=frames, vo=vo, snaps=snaps,
                decisions=[(s.stage, s.is_keyframe) for s in vo.stats])


class _JaxMinimalSets:
    """Stands in for the port's RANSAC sampler: draws each init attempt's
    minimal sets with JAX's key chain (MonoVO: PRNGKey(seed), one split per
    attempt, vo.py:1162), so both packages score identical hypotheses."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, generator, n_points, weights, n_samples, sample_size):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        idx = jransac.sample_minimal_sets(sub, n_points, jnp.asarray(weights.numpy()),
                                          n_samples, sample_size)
        return torch.as_tensor(np.array(idx))


def _port_cam():
    return TPinhole.create(*CAM)


def test_step_parity_from_carried_state(jax_run):
    decisions = jax_run["decisions"]
    # the first general-stage keyframe after at least two plain general frames
    kf = next(i for i, (st, is_kf) in enumerate(decisions)
              if st == "general" and is_kf and i >= 2
              and all(d == ("general", False) for d in decisions[i - 2:i]))
    start = kf - 2                         # snapshot after this frame
    assert start + 3 < N_FRAMES
    snap = jax_run["snaps"][start]
    vo = convert.monovo(snap, _port_cam(), Config(**CFG))
    assert vo.stage is Stage.GENERAL
    for i in range(start + 1, start + 4):
        vo.process(jax_run["frames"][i])
    got = [(s.stage, s.is_keyframe) for s in vo.stats]
    assert got == decisions[start + 1:start + 4]
    assert any(is_kf for _, is_kf in got) and vo.n_window_ba == 1
    jvo = jax_run["vo"]
    # same pose after each of the three frames (float32 GN/BA round-off)
    for k, i in enumerate(range(start + 1, start + 4)):
        np.testing.assert_allclose(vo.trajectory[len(snap["trajectory"]) + k],
                                   jvo.trajectory[i], atol=1e-3)
    after = jax_run["snaps"][start + 3]
    assert vo.point_cursor == after["point_cursor"]
    assert vo.kf_count == after["kf_count"]
    np.testing.assert_array_equal(convert.to_numpy(vo.map)["valid"], after["map"]["valid"])
    tr = convert.to_numpy(vo.tracks)
    np.testing.assert_array_equal(tr["valid"], after["tracks"]["valid"])
    v = tr["valid"]
    np.testing.assert_allclose(tr["px"][v], after["tracks"]["px"][v], atol=5e-3)


def test_whole_run_parity(jax_run, monkeypatch):
    sampler = _JaxMinimalSets(seed=0)
    monkeypatch.setattr(transac, "sample_minimal_sets", sampler)
    vo = TMonoVO(_port_cam(), Config(**CFG), device="cpu")
    for f in jax_run["frames"]:
        vo.process(f)
    jvo = jax_run["vo"]
    assert sampler.calls >= 1
    assert [(s.stage, s.is_keyframe) for s in vo.stats] == jax_run["decisions"]
    # the JAX run gates out the track bound to its lost point 0 at the
    # first general frame; the port keeps it (module docstring)
    extra = [a.n_tracked - b.n_tracked for a, b in zip(vo.stats, jvo.stats)]
    assert all(e in (0, 1) for e in extra), extra
    assert vo.stage is Stage.GENERAL and vo.kf_count == jvo.kf_count
    # map point 0 budget (module docstring)
    n_port, n_jax = int(vo.map.n), int(jvo.map.n)
    assert n_jax <= n_port <= n_jax + 1
    np.testing.assert_allclose(vo.positions(), jvo.positions(), atol=5e-3)


def _jax_from_snapshot(snap) -> JMonoVO:
    """A JAX MonoVO put into a snapshot's state (the fixture's own driver
    stays untouched for the other tests)."""
    from dr3_tpu.pipelines.vo import Stage as JStage
    from dr3_tpu.state import KeyframeState, MapState, TrackState

    vo = JMonoVO(JPinhole.create(*CAM), JConfig(**CFG))
    vo.stage = JStage(snap["stage"])
    for k in ("frame_idx", "kf_count", "point_cursor", "last_kf_tracked",
              "lost_count", "n_relocalizations"):
        setattr(vo, k, int(snap[k]))
    vo.T_cur = JSE3(*[jnp.asarray(a) for a in snap["T_cur"]])
    vo.T_anchor = JSE3(*[jnp.asarray(a) for a in snap["T_anchor"]])
    vo.tracks = TrackState(**{k: jnp.asarray(v) for k, v in snap["tracks"].items()})
    vo.kfs = KeyframeState(**{k: jnp.asarray(v) for k, v in snap["kfs"].items()})
    vo.map = MapState(**{k: jnp.asarray(v) for k, v in snap["map"].items()})
    vo.pyr_prev = [jnp.asarray(p) for p in snap["pyr_prev"]]
    vo.trajectory = list(snap["trajectory"])
    vo._traj_local = list(snap["traj_local"])
    return vo


def test_relocalization_parity(jax_run):
    """Featureless frames lose tracking: after three lost frames both
    packages re-bootstrap in a fresh local frame anchored at the last pose,
    then find no corners on the next blank frame."""
    snap = jax_run["snaps"][-1]
    jvo = _jax_from_snapshot(snap)
    tvo = convert.monovo(snap, _port_cam(), Config(**CFG))
    blank = np.full(jax_run["frames"][0].shape, 0.5, np.float32)
    for _ in range(4):
        jvo.process(blank)
        tvo.process(blank)
    got = [(s.stage, s.n_tracked, s.is_keyframe) for s in tvo.stats]
    want = [(s.stage, s.n_tracked, s.is_keyframe) for s in jvo.stats]
    assert got == want
    assert [g[0] for g in got] == ["general", "general", "relocalize", "first"]
    assert tvo.n_relocalizations == jvo.n_relocalizations == 1
    assert tvo.stage is Stage.FIRST
    assert not convert.to_numpy(tvo.tracks)["valid"].any()
    np.testing.assert_allclose(np.stack(tvo.trajectory[-4:]), np.stack(jvo.trajectory[-4:]),
                               atol=1e-4)


def test_referenced_points_and_compaction(jax_run):
    """Map compaction keeps exactly the points live tracks or window
    keyframes reference (vo.py _referenced_points + compact_map)."""
    from dr3_tpu.pipelines.vo import _referenced_points as j_ref
    from dr3_tpu.state import KeyframeState, TrackState
    from dr3_tpu_torch.pipelines.vo import _referenced_points as t_ref

    snap = jax_run["snaps"][-1]
    keep_j = np.asarray(j_ref(TrackState(**{k: jnp.asarray(v) for k, v in snap["tracks"].items()}),
                              KeyframeState(**{k: jnp.asarray(v) for k, v in snap["kfs"].items()}),
                              jnp.asarray(snap["map"]["valid"])))
    tvo = convert.monovo(snap, _port_cam(), Config(**CFG))
    keep_t = t_ref(tvo.tracks, tvo.kfs, tvo.map.valid).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)
    # force the capacity condition and compact: ids stay consistent
    tvo.point_cursor = tvo.cfg.max_points
    n_before = int(tvo.map.n)
    tvo._compact_map_if_needed()
    assert tvo.n_compactions == 1
    assert tvo.point_cursor == int(tvo.map.n) <= n_before
    pts = convert.to_numpy(tvo.tracks)
    live = pts["valid"] & (pts["point"] >= 0)
    assert convert.to_numpy(tvo.map)["valid"][pts["point"][live]].all()


def test_unported_options_raise():
    """The users' default Config(), loop closure on, constructs with an
    empty loop database; a too small database raises. mesh= (the
    distributed window BA, ported since: tests/test_torch_vo_distributed.py)
    constructs with a mesh on MonoVO's device and raises with one
    elsewhere."""
    from dr3_tpu_torch.parallel.mesh import make_mesh

    vo = TMonoVO(_port_cam(), Config(), device="cpu")
    assert vo.loop_db is not None and vo.db_cursor == 0
    assert vo.loop_db.thumb.shape == (256, 12 * 40)
    with pytest.raises(ValueError, match="loop_db_capacity"):
        TMonoVO(_port_cam(), Config(loop_db_capacity=3), device="cpu")
    mesh = make_mesh(2, device="cpu")
    assert TMonoVO(_port_cam(), Config(loop_closure=False), mesh=mesh,
                   device="cpu").mesh is mesh
    with pytest.raises(ValueError, match="mesh"):
        TMonoVO(_port_cam(), Config(loop_closure=False),
                mesh=mesh._replace(device=torch.device("cuda")), device="cpu")
