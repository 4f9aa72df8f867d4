"""The port's BAL CLI (``python -m dr3_tpu_torch.run_ba``) on the CPU: both
camera models and ``--out``, its final cost against the JAX package's
library call on the same file; ``--device cuda`` refuses without a card."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.ba.problem import project
from dr3_tpu.ba.schur_lm import bundle_adjust as jbundle_adjust
from dr3_tpu.ba.snavely import bal_to_snavely as jbal_to_snavely
from dr3_tpu.ba.snavely import bundle_adjust_snavely as jbundle_adjust_snavely
from dr3_tpu.io import bal as jbal
from dr3_tpu_torch import run_ba
from dr3_tpu_torch.io.bal import load_bal, save_bal
from tests.test_ba import synthetic_ba
from tests.torch_parity import rand_bal

COST = re.compile(r"cost: (\S+) -> (\S+) \((\d+)/(\d+) steps accepted")


@pytest.fixture()
def bal_file(rng, tmp_path):
    path = os.path.join(tmp_path, "p.bal")
    save_bal(path, rand_bal(rng, n_cams=5, n_pts=60, noise=0.5, pt_noise=0.05))
    return path


def _run(capsys, argv):
    assert run_ba.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    c0, c1, n_acc, iters = COST.search(out).groups()
    return out, float(c0), float(c1), int(n_acc)


@pytest.mark.parametrize("solver", ["auto", "pcg"])
def test_snavely_model_matches_the_library(capsys, bal_file, tmp_path, solver):
    """The exact objective, 8 iterations, plain L2: the printed costs
    (6 significant digits) within 1e-4 of JAX's bundle_adjust_snavely on
    the same file (pcg at the CLI's default forcing), the same accepted
    steps; --out reloads with the same counts, the observations (float32
    round trip) and the refined cost."""
    out_path = os.path.join(tmp_path, "refined.bal")
    out, c0, c1, n_acc = _run(capsys, [bal_file, "--iters", "8", "--solver", solver,
                                       "--out", out_path])
    assert "loaded 5 cams, 60 points, 300 observations" in out and "(snavely model)" in out
    ref = jbundle_adjust_snavely(jbal_to_snavely(jbal.load_bal(bal_file)), 8,
                                 huber_delta=1e9, solver=solver)
    np.testing.assert_allclose(c0, float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(c1, float(ref.final_cost), rtol=1e-4)
    assert n_acc == int(ref.n_accepted) and c1 < 0.1 * c0
    back, orig = load_bal(out_path), load_bal(bal_file)
    assert [a.shape for a in back] == [a.shape for a in orig]
    np.testing.assert_allclose(back.obs_uv, orig.obs_uv, rtol=1e-7, atol=1e-4)
    from dr3_tpu_torch.ba.snavely import bal_to_snavely, residual_cost

    np.testing.assert_allclose(float(residual_cost(bal_to_snavely(back, device="cpu"), 1e9)),
                               c1, rtol=1e-4)


def test_pinhole_model_with_intrinsics_matches_the_library(capsys, rng, tmp_path):
    """--model pinhole --optimize-intrinsics on a pinhole scene exported to
    BAL (its pixels re-projected with the principal point at 0, which BAL
    assumes; perturbed poses and points): costs within 1e-4 of JAX's
    bundle_adjust on bal_to_problem of the same file, the same accepted
    steps; --out writes a file of the same counts."""
    prob, cams, pts = synthetic_ba(rng, n_cams=5, n_pts=60, pose_noise=0.02)
    intr = prob.intrinsics.at[2:].set(0.0)
    uv = project(intr, cams[prob.obs_cam].apply(jnp.asarray(pts)[prob.obs_pt]))
    prob = prob._replace(intrinsics=intr, obs_uv=uv + rng.normal(0, 0.3, uv.shape))
    bal_file = os.path.join(tmp_path, "pin_in.bal")
    jbal.save_bal(bal_file, jbal.problem_to_bal(prob))
    out_path = os.path.join(tmp_path, "pin.bal")
    out, c0, c1, n_acc = _run(capsys, [bal_file, "--iters", "8", "--model", "pinhole",
                                       "--optimize-intrinsics", "--out", out_path])
    assert "(pinhole model)" in out
    ref = jbundle_adjust(jbal.bal_to_problem(jbal.load_bal(bal_file)), 8, huber_delta=1e9,
                         optimize_intrinsics=True, solver="auto")
    np.testing.assert_allclose(c0, float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(c1, float(ref.final_cost), rtol=1e-4)
    assert n_acc == int(ref.n_accepted) and c1 < 0.1 * c0
    assert [a.shape for a in load_bal(out_path)] == [a.shape for a in load_bal(bal_file)]


def test_render_says_why_without_matplotlib(capsys, bal_file, tmp_path, monkeypatch):
    """--render writes the PNG where matplotlib is installed, else says so."""
    import importlib.util

    png = os.path.join(tmp_path, "cloud.png")
    out, *_ = _run(capsys, [bal_file, "--iters", "2", "--render", png])
    if importlib.util.find_spec("matplotlib") is None:
        assert "not written: matplotlib is not installed" in out
    else:
        assert os.path.exists(png)
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    out, *_ = _run(capsys, [bal_file, "--iters", "1", "--render", png + "2"])
    assert "not written: matplotlib is not installed" in out and not os.path.exists(png + "2")


def test_device_cuda_refuses_without_a_card(bal_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs there")
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        run_ba.main([bal_file])
