"""Hypothesis-parallel RANSAC (port of dr3_tpu.geometry.ransac).

Pre-sample every minimal set, fit and score all hypotheses as one batch,
take the best — no data-dependent loop (reference initializer's 200
pre-sampled 8-point sets, src/initialization.cpp:48-64).

Random numbers come from a ``torch.Generator`` where JAX takes a PRNG key;
the two give different sets from the same seed, so ``ransac`` also accepts
precomputed indices and the parity tests hand both packages the same sets.
The sets are drawn on the generator's device and moved to the data's, so a
CPU generator gives the card and the CPU the same draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dr3_tpu_torch.geometry import epipolar, homography


class RansacResult(NamedTuple):
    model: torch.Tensor     # best model parameters
    inliers: torch.Tensor   # [N] bool inlier mask of the best model
    score: torch.Tensor     # [] best score
    n_inliers: torch.Tensor # [] int


def sample_minimal_sets(generator: torch.Generator | None, n_points: int,
                        weights: torch.Tensor, n_samples: int,
                        sample_size: int) -> torch.Tensor:
    """[n_samples, sample_size] indices drawn ~uniformly from valid points:
    Gumbel top-k per hypothesis over the weight mask (ransac.py:42-45) —
    distinct indices within a set, never a masked row. Drawn on the
    generator's device, returned on the weights'."""
    dev = generator.device if generator is not None else weights.device
    w = weights.to(dev)
    logits = torch.where(w > 0, torch.zeros_like(w), torch.full_like(w, -1e30))
    u = torch.rand((n_samples, n_points), generator=generator,
                   dtype=torch.float32, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny))) + logits[None, :]
    return torch.topk(g, sample_size, dim=-1).indices.to(weights.device)


def ransac(generator: torch.Generator | None,
           fit: Callable, score: Callable,
           p1: torch.Tensor, p2: torch.Tensor, weights: torch.Tensor,
           n_samples: int, sample_size: int, refit: Callable | None = None,
           refit_rounds: int = 1, sample_idx: torch.Tensor | None = None) -> RansacResult:
    """Batched RANSAC over fixed-capacity matches.

    fit(p1_s [S, k, 2], p2_s, w_s) -> [S, ...] models; score(models) ->
    (scores [S], inliers [S, N]); refit(model, inliers) -> model, iterated
    ``refit_rounds`` times (LO-RANSAC style). ``sample_idx`` [n_samples,
    sample_size] replaces the drawn minimal sets when given."""
    n = p1.shape[0]
    idx = sample_idx if sample_idx is not None else sample_minimal_sets(
        generator, n, weights, n_samples, sample_size)
    idx = idx.to(device=p1.device, dtype=torch.long)
    sw = torch.ones(idx.shape, dtype=p1.dtype, device=p1.device)
    models = fit(p1[idx], p2[idx], sw)
    scores, inls = score(models)
    best = torch.argmax(scores)
    model = models[best]
    inliers = inls[best]
    final_score = scores[best]
    if refit is not None:
        for _ in range(refit_rounds):
            model2 = refit(model, inliers)
            sc2, inl2 = score(model2)
            better = sc2 >= final_score
            model = torch.where(better, model2, model)
            inliers = torch.where(better, inl2, inliers)
            final_score = torch.where(better, sc2, final_score)
    return RansacResult(model=model, inliers=inliers, score=final_score,
                        n_inliers=inliers.sum())


def ransac_fundamental(generator: torch.Generator | None, p1: torch.Tensor,
                       p2: torch.Tensor, weights: torch.Tensor,
                       n_samples: int = 200, sigma: float = 1.0,
                       sample_idx: torch.Tensor | None = None) -> RansacResult:
    """Normalised 8-point F RANSAC with chi-square scoring — initializer
    parity (FindFundamental, src/initialization.cpp:81-133)."""
    w = weights.to(p1.dtype)

    def fit(s1, s2, sw):
        return epipolar.fit_fundamental(s1, s2, sw)

    def score(F):
        return epipolar.score_fundamental(F, p1, p2, w, sigma=sigma)

    def refit(F, inl):
        return epipolar.fit_fundamental(p1, p2, inl.to(p1.dtype))

    return ransac(generator, fit, score, p1, p2, weights, n_samples, 8, refit,
                  refit_rounds=3, sample_idx=sample_idx)


def ransac_homography(generator: torch.Generator | None, src: torch.Tensor,
                      dst: torch.Tensor, weights: torch.Tensor,
                      n_samples: int = 500, threshold: float = 5.0,
                      translate_only: bool = False,
                      sample_idx: torch.Tensor | None = None) -> RansacResult:
    """Homography RANSAC with stitch-parity semantics (src/stitch.cpp:101-153):
    minimal sets of 4 (homography) or 1 (translation), forward-transfer
    inlier test at ``threshold`` px, one least-squares refit on the
    inliers. All ``n_samples`` hypotheses are fitted as one batch."""
    sample_size = 1 if translate_only else 4
    fit_fn = homography.fit_translation if translate_only else homography.fit_homography

    def score(H):
        # H [..., 3, 3] against every match -> scores [...], inliers [..., N]
        err = homography.transfer_error(H[..., None, :, :], src, dst)
        inl = (err < threshold) & (weights > 0)
        return inl.to(torch.float32).sum(-1), inl

    def refit(H, inl):
        return fit_fn(src, dst, inl.to(src.dtype))

    return ransac(generator, fit_fn, score, src, dst, weights, n_samples, sample_size, refit,
                  sample_idx=sample_idx)
