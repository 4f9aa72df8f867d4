"""The port's ``MonoVO.process_batch`` with ``ba_solver="zexplicit"``
against the JAX package's on the CPU, on tests/test_vo_scan.py's 320x240
out-and-back, the port drawing JAX's RANSAC sets (tests/test_torch_vo.py):
both loops run the window BA's dense square-root solve inside
(dr3_tpu/pipelines/vo.py:544-548); the same stage and keyframe decisions,
the same closures at the same frames, positions within 1e-3
(tests/test_vo_scan.py's ``_assert_equivalent``). Solver against solver
only: the JAX package's zexplicit against the port's. Most of its time is
the JAX scan program's compile."""

import jax
import numpy as np
import pytest

from dr3_tpu.models.camera import Pinhole as JPinhole
from dr3_tpu.pipelines.vo import MonoVO as JMonoVO
from dr3_tpu.utils.config import Config as JConfig
from tests.test_torch_vo_batch import BASE, CAM, _out_and_back
from tests.test_torch_vo_scan import _Runs
from tests.torch_parity import nn  # noqa: F401  (one intra-op thread per worker)


@pytest.fixture(scope="module")
def frames():
    return _out_and_back(16)


def test_dense_scan_matches_jax_process_batch(frames, monkeypatch):
    """Width 4, zexplicit in both loops: the same stage and keyframe
    decisions, keyframes, closures at the same frames and
    relocalisations, the port's window BAs all in its loop or after the
    loop candidate, positions within 1e-3."""
    cfg = dict(BASE, frames_per_dispatch=4, ba_solver="zexplicit")
    vo, _ = _Runs().get("oab", frames, cfg, True)
    jvo = JMonoVO(JPinhole.create(*CAM), JConfig(**cfg))
    closures = []
    close = JMonoVO._close_loop

    def spy(self, my_slot, cand, ver):
        closures.append(self.frame_idx)
        return close(self, my_slot, cand, ver)

    monkeypatch.setattr(JMonoVO, "_close_loop", spy)
    jvo.process_batch([np.asarray(f) for f in frames])
    assert jax.devices()[0].platform == "cpu"
    assert [(s.stage, s.is_keyframe) for s in vo.stats] == \
        [(s.stage, s.is_keyframe) for s in jvo.stats]
    assert (vo.kf_count, vo.n_loop_closures, vo.n_relocalizations) == \
        (jvo.kf_count, jvo.n_loop_closures, jvo.n_relocalizations)
    assert closures and vo.closed_at == closures
    assert vo.n_window_ba >= 2 and vo.n_cg_iters == 0
    np.testing.assert_allclose(vo.positions(), jvo.positions(), atol=1e-3)
