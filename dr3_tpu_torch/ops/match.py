"""Patch descriptors and correspondence matching (port of
dr3_tpu.ops.match; reference src/stitch.cpp:11-27).

Descriptors are mean/variance-normalised intensity patches (ZNCC), so
brute-force matching over all pairs is one [N, D] x [D, M] matrix product
(``torch.matmul``, as the JAX package leaves it to XLA outside any kernel),
then mutual-best and ratio gating. The patch sampling goes through
:func:`dr3_tpu_torch.ops.warp.remap_xy`, kernel K4's remap over a given
field on the card. Fixed capacities and masks: invalid rows never match.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr3_tpu_torch.ops.warp import remap_xy


class Matches(NamedTuple):
    idx2: torch.Tensor   # [N] index into set 2 for each descriptor in set 1
    ok: torch.Tensor     # [N] bool valid match
    score: torch.Tensor  # [N] ZNCC in [-1, 1]


def patch_descriptors(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
                      patch: int = 16, spread: float = 1.0,
                      oriented: bool = False) -> torch.Tensor:
    """[N, patch*patch] ZNCC descriptors sampled around xy (bilinear,
    edge-clamped, ``spread`` px between samples). Zero-variance or invalid
    -> zero rows.

    ``oriented``: rotate each corner's sampling grid to its intensity-
    centroid orientation theta = atan2(m01, m10) over the circular
    footprint first (ORB's mechanism, match.py:36-44)."""
    half = patch // 2
    off = (torch.arange(patch, dtype=img.dtype, device=img.device) - half + 0.5) * spread
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    grid = torch.stack([ox, oy], dim=-1)                  # [P, P, 2]
    coords = xy[:, None, None, :] + grid[None]
    vals, _ = remap_xy(img, coords, clamp=True)           # [N, P, P]
    if oriented:
        r2 = ox * ox + oy * oy
        rmax = (half * spread) ** 2
        circ = (r2 <= rmax).to(vals.dtype)
        w = vals * circ[None]
        m10 = torch.sum(w * ox[None], dim=(1, 2))
        m01 = torch.sum(w * oy[None], dim=(1, 2))
        theta = torch.atan2(m01, m10)
        c, s = torch.cos(theta), torch.sin(theta)
        gx = c[:, None, None] * ox[None] - s[:, None, None] * oy[None]
        gy = s[:, None, None] * ox[None] + c[:, None, None] * oy[None]
        coords = xy[:, None, None, :] + torch.stack([gx, gy], dim=-1)
        vals, _ = remap_xy(img, coords, clamp=True)
    d = vals.reshape(vals.shape[0], -1)
    d = d - d.mean(dim=1, keepdim=True)
    norm = torch.linalg.norm(d, dim=1, keepdim=True)
    d = d / torch.clamp(norm, min=1e-6)
    return torch.where(valid[:, None], d, torch.zeros_like(d))


def match_descriptors(d1: torch.Tensor, d2: torch.Tensor,
                      valid1: torch.Tensor, valid2: torch.Tensor,
                      min_score: float = 0.6, ratio: float = 0.95,
                      mutual: bool = True) -> Matches:
    """Brute-force ZNCC matching: one [N, M] product + row/column argmax,
    BFMatcher crossCheck semantics plus a ratio test in correlation space
    (second best must be < ratio * best)."""
    sim = d1 @ d2.T
    neg = torch.finfo(sim.dtype).min
    sim = torch.where(valid1[:, None] & valid2[None, :], sim, torch.full_like(sim, neg))
    best2 = torch.argmax(sim, dim=1)
    best_score = torch.gather(sim, 1, best2[:, None])[:, 0]
    rows = torch.arange(sim.shape[0], device=sim.device)
    sim_wo = sim.clone()
    sim_wo[rows, best2] = neg
    second = sim_wo.amax(dim=1)
    ok = (best_score > min_score) & valid1 & (second < best_score * ratio)
    if mutual:
        best1_of_2 = torch.argmax(sim, dim=0)
        ok = ok & (best1_of_2[best2] == rows)
    return Matches(idx2=best2, ok=ok, score=best_score)
