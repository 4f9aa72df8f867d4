"""The port's entry points run on the card unless asked for the CPU:
MonoVO, Stitch and Panorama built without ``device`` take "cuda", and
without a card they raise, naming device="cpu", instead of falling back."""

import pytest
import torch

from dr3_tpu_torch.models.camera import Pinhole
from dr3_tpu_torch.pipelines.panorama import Panorama, PanType
from dr3_tpu_torch.pipelines.stitch import Stitch
from dr3_tpu_torch.pipelines.vo import MonoVO
from dr3_tpu_torch.utils.config import Config

CONSTRUCTORS = {
    "MonoVO": lambda **kw: MonoVO(Pinhole.kitti(), Config(loop_closure=False), **kw),
    "Stitch": lambda **kw: Stitch(Config(), **kw),
    "Panorama": lambda **kw: Panorama(focal_length=600.0, pan_type=PanType.TRANSLATE, **kw),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_default_device_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f'{name}: .*device="cpu"'):
        CONSTRUCTORS[name]()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CONSTRUCTORS[name](device="cuda")


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_default_device_is_the_card(name):
    """Decided here, not at import: without a card the default raises,
    with one it is cuda; device="cpu" is the CPU either way."""
    if torch.cuda.is_available():
        assert CONSTRUCTORS[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            CONSTRUCTORS[name]()
    assert CONSTRUCTORS[name](device="cpu").device == torch.device("cpu")


def test_stitch_moves_numpy_and_tensors_to_its_device():
    import numpy as np

    s = Stitch(Config(), device="cpu")
    for img in (np.zeros((4, 5), np.float64), torch.zeros(4, 5, dtype=torch.float64)):
        t = s.to_device(img)
        assert t.device == torch.device("cpu") and t.dtype == torch.float32
