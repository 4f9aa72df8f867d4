"""Image pyramids by 2x2 box-average half-sampling (port of
dr3_tpu.ops.pyramid; reference src/utils.cpp:323-430).

Levels have static shapes (H/2^l, W/2^l); odd trailing rows/cols are
dropped like the reference. ``gaussian_blur3`` is the optional [1 2 1]/4
pre-smoothing.
"""

from __future__ import annotations

from typing import List

import torch


def half_sample(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H//2, W//2] by 2x2 box average."""
    h, w = img.shape[-2], img.shape[-1]
    h2, w2 = h // 2, w // 2
    img = img[..., : 2 * h2, : 2 * w2]
    shaped = img.reshape(img.shape[:-2] + (h2, 2, w2, 2))
    return shaped.mean(dim=(-3, -1))


def build_pyramid(img: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """List of n_levels images, level 0 = input (utils.cpp:421-430)."""
    pyr = [img]
    for _ in range(1, n_levels):
        pyr.append(half_sample(pyr[-1]))
    return pyr


def gaussian_blur3(img: torch.Tensor) -> torch.Tensor:
    """Separable [1 2 1]/4 blur over the last two axes, borders replicated:
    an edge pixel's missing neighbour is itself, so the edge value is
    0.75 x edge + 0.25 x its inner neighbour (as the JAX package writes it
    over its wrapped roll)."""
    def conv1d(x, dim):
        out = 0.25 * torch.roll(x, 1, dims=dim) + 0.5 * x + 0.25 * torch.roll(x, -1, dims=dim)
        out.select(dim, 0).copy_(0.75 * x.select(dim, 0) + 0.25 * x.select(dim, 1))
        out.select(dim, -1).copy_(0.75 * x.select(dim, -1) + 0.25 * x.select(dim, -2))
        return out

    return conv1d(conv1d(img, -1), -2)
