"""Image IO (port of dr3_tpu.io.image; reference utils.hpp:31-33,
panorama.cpp:5-30 directory load).

Images are float32 in [0, 1], grayscale [H, W] or colour [H, W, 3], as
numpy arrays on the host. PIL is imported inside the functions that read
or write files, so the rest of the port runs where PIL is not installed.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

_LUMA = (0.299, 0.587, 0.114)


def load_image(path: str, gray: bool = False) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("L" if gray else "RGB")
        return np.asarray(im, dtype=np.float32) / 255.0


def save_image(img, path: str) -> None:
    """Write an image (numpy or tensor, [0, 1] floats or uint8)."""
    from PIL import Image

    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    arr = np.clip(arr * 255.0 if arr.dtype != np.uint8 else arr, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_image_dir(dir_name: str, gray: bool = False) -> List[np.ndarray]:
    """All images in a directory, sorted by filename (panorama.cpp:5-30)."""
    exts = {".png", ".jpg", ".jpeg", ".bmp"}
    files = sorted(
        os.path.join(dir_name, f) for f in os.listdir(dir_name)
        if os.path.splitext(f)[1].lower() in exts
    )
    return [load_image(f, gray=gray) for f in files]


def to_gray(img):
    """Luma of an [H, W, 3] image (numpy or tensor); [H, W] passes through."""
    if img.ndim == 2:
        return img
    if isinstance(img, torch.Tensor):
        return img @ torch.tensor(_LUMA, dtype=img.dtype, device=img.device)
    return img @ np.asarray(_LUMA, img.dtype)
