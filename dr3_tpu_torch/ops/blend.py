"""Feathered alpha blending for panoramas (port of dr3_tpu.ops.blend;
reference src/panorama.cpp:144-229).

Each warped image gets per-column weights ramping 0 -> 1 over a feathering
width at its left edge, 1 in the middle, 1 -> 0 at its right edge; weighted
colour and the weight accumulate into an RGBA canvas; the panorama divides
colour by the accumulated alpha.
"""

from __future__ import annotations

import torch


def column_feather(canvas_w: int, min_x: float, max_x: float,
                   feather_width: int, device="cpu") -> torch.Tensor:
    """[canvas_w] per-column weight: linear 0 -> 1 ramp over
    ``feather_width`` columns from min_x, flat 1, then 1 -> 0 ending at
    max_x; zero outside [min_x, max_x] (panorama.cpp:165-176)."""
    span = float(max_x - min_x)
    fw = torch.tensor(min(float(feather_width), max(span / 2.0 - 1.0, 1.0)),
                      dtype=torch.float32, device=device)
    x = torch.arange(canvas_w, dtype=torch.float32, device=device)
    up = (x - float(min_x)) / fw
    down = (float(max_x) - x) / fw
    w = torch.clamp(torch.minimum(up, down), 0.0, 1.0)
    return torch.where((x >= min_x) & (x <= max_x), w, torch.zeros_like(w))


def accumulate(canvas_rgba: torch.Tensor, warped_rgb: torch.Tensor,
               warped_valid: torch.Tensor, col_weight: torch.Tensor) -> torch.Tensor:
    """Accumulate one warped image into the RGBA canvas.

    canvas_rgba [H, W, C+1]; warped_rgb [H, W, C] on the canvas grid;
    warped_valid [H, W] bool from the warp (replaces the reference's
    is-black-pixel test, panorama.cpp:199-206)."""
    w = torch.where(warped_valid, col_weight[None, :], torch.zeros_like(col_weight)[None, :])
    rgb = canvas_rgba[..., :-1] + warped_rgb * w[..., None]
    a = canvas_rgba[..., -1] + w
    return torch.cat([rgb, a[..., None]], dim=-1)


def normalize(canvas_rgba: torch.Tensor) -> torch.Tensor:
    """Colour / accumulated alpha; empty pixels stay 0 (panorama.cpp:215-229)."""
    a = canvas_rgba[..., -1:]
    out = canvas_rgba[..., :-1] / torch.clamp(a, min=1e-9)
    return torch.where(a > 0, out, torch.zeros_like(out))
