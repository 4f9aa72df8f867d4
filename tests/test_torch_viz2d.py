"""The port's offline 2D renderings (dr3_tpu_torch.viz.draw2d; port of
tests/test_viz.py's draw2d cases): each writes a non-trivial PNG, from
numpy arrays and from tensors alike."""

import os

import numpy as np
import pytest
import torch

from dr3_tpu_torch.viz.draw2d import draw_epipolar, draw_matches, draw_points


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_matches(tmp_path, rng, as_tensor):
    img1 = rng.uniform(0, 1, (60, 80)).astype(np.float32)
    img2 = rng.uniform(0, 1, (60, 80)).astype(np.float32)
    p1 = rng.uniform(5, 70, (20, 2))
    p2 = p1 + 2.0
    mask = np.arange(20) % 3 != 0
    args = (img1, img2, p1, p2, mask)
    if as_tensor:
        args = tuple(torch.as_tensor(a) for a in args)
    out = draw_matches(*args, path=str(tmp_path / "m.png"))
    assert os.path.getsize(out) > 5000
    out = draw_matches(*args[:4], path=str(tmp_path / "mh.png"), vertical=False)
    assert os.path.getsize(out) > 5000


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_points(tmp_path, rng, as_tensor):
    img = rng.uniform(0, 1, (60, 80, 3)).astype(np.float32)
    pts = rng.uniform(5, 70, (15, 2))
    if as_tensor:
        img, pts = torch.as_tensor(img), torch.as_tensor(pts)
    out = draw_points(img, pts, path=str(tmp_path / "p.png"))
    assert os.path.getsize(out) > 5000


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_epipolar(tmp_path, rng, as_tensor):
    img = rng.uniform(0, 1, (60, 80)).astype(np.float32)
    F = np.asarray([[0, -1e-3, 0.02], [1e-3, 0, -0.03], [-0.02, 0.03, 1.0]])
    p = rng.uniform(10, 60, (10, 2))
    args = (img, img, F, p, p + 1.0)
    if as_tensor:
        args = tuple(torch.as_tensor(a) for a in args)
    out = draw_epipolar(*args, path=str(tmp_path / "e.png"))
    assert os.path.getsize(out) > 5000
