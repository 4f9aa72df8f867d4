"""Port parity for dr3_tpu_torch.io.image and the run_panorama CLI on the
CPU: images written and read back as dr3_tpu.io.image does, and the CLI's
PNG against the JAX Panorama's canvas on the same rendered views."""

import numpy as np
import pytest
import torch

from dr3_tpu.io import image as jimage
from dr3_tpu.pipelines.panorama import Panorama as JPanorama
from dr3_tpu.pipelines.panorama import PanType as JPanType
from dr3_tpu_torch import run_panorama
from dr3_tpu_torch.io import image as timage
from dr3_tpu_torch.utils import synth


def _views(n=3, f=300.0, yaw=0.3, w=320, h=240):
    tex = synth.sphere_texture(np.random.default_rng(11), f, lon=(-1.0, 1.6), lat=(-0.7, 0.7))
    return [synth.render_sphere_view(tex, f, -1.0, -0.7, f, f, w / 2, h / 2, w, h, yaw * k)
            for k in range(n)]


def test_image_io_and_gray_match(tmp_path, rng):
    img = rng.uniform(0, 1, (17, 23, 3)).astype(np.float32)
    timage.save_image(torch.as_tensor(img), str(tmp_path / "t.png"))
    jimage.save_image(img, str(tmp_path / "j.png"))
    a = timage.load_image(str(tmp_path / "t.png"))
    np.testing.assert_array_equal(a, jimage.load_image(str(tmp_path / "j.png")))
    np.testing.assert_array_equal(timage.load_image(str(tmp_path / "t.png"), gray=True),
                                  jimage.load_image(str(tmp_path / "j.png"), gray=True))
    assert [x.shape for x in timage.load_image_dir(str(tmp_path))] == [(17, 23, 3)] * 2
    np.testing.assert_array_equal(timage.to_gray(img), jimage.to_gray(img))
    np.testing.assert_allclose(timage.to_gray(torch.as_tensor(img)).numpy(),
                               jimage.to_gray(img), rtol=0, atol=1e-6)


def test_cli_translate_matches_jax_panorama(tmp_path):
    views = _views()
    d = tmp_path / "views"
    d.mkdir()
    for k, v in enumerate(views):
        timage.save_image(v, str(d / f"{k:02d}.png"))
    out = tmp_path / "pano.png"
    assert run_panorama.main(["--dir", str(d), "--mode", "translate", "--focal", "300",
                              "--device", "cpu", "--out", str(out)]) == 0
    got = np.round(timage.load_image(str(out)) * 255.0)
    pj = JPanorama(focal_length=300.0, pan_type=JPanType.TRANSLATE, feathering_width=40,
                   transfer_uint8=False)
    want = np.asarray(pj.process_dir(str(d)))
    assert got.shape == want.shape
    # the same canvas (tests/test_torch_stitch.py) written as 8 bits, which
    # save_image truncates: one level apart at most
    assert np.abs(got - np.floor(np.clip(want * 255.0, 0, 255))).max() <= 1.0


def test_cli_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        run_panorama.main(["--dir", str(tmp_path), "--out", str(tmp_path / "x.png")])
