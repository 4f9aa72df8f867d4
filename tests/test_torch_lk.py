"""Port parity for kernel K1's functions (LK tracking, template alignment)
and K2's (patch extraction): dr3_tpu.ops.lk (jnp, the oracle the Pallas
kernels are held against) vs dr3_tpu_torch.ops.lk on the CPU, where the
wrappers run their plain twins."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from dr3_tpu.ops import lk as jlk
from dr3_tpu.ops.pyramid import build_pyramid as jpyr
from dr3_tpu_torch.ops import lk as tlk
from dr3_tpu_torch.ops.pyramid import build_pyramid as tpyr
from tests.torch_parity import nn, tt

# Both sides run the same float32 GN steps; reductions sum in another
# order, and 8-10 dependent GN steps amplify that round-off. 2e-3 px is
# far below the 1e-2 px the kernel-vs-oracle tests allow.
POS_ATOL = 2e-3


def _pair(rng, h=96, w=128, shift=(1.3, -0.7)):
    img = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 2.0).astype(np.float32)
    img = (img - img.min()) / (img.max() - img.min())
    nxt = ndimage.shift(img, shift, order=1, mode="nearest").astype(np.float32)
    return img, nxt


def _tracks(rng, n=40, h=96, w=128):
    pts = np.stack([rng.uniform(12, w - 12, n), rng.uniform(12, h - 12, n)],
                   -1).astype(np.float32)
    pts[5] = [np.nan, np.nan]           # a diverged slot: ok=False, no crash
    pts[6] = [2.0, 3.0]                 # near the border (clamped samples)
    valid = np.ones(n, bool)
    valid[7] = False
    return pts, valid


def _compare_tracks(pos_t, ok_t, pos_j, ok_j, min_ok=0.8):
    ok_t, ok_j = nn(ok_t), nn(ok_j)
    assert (ok_t != ok_j).sum() <= 1
    both = ok_t & ok_j
    assert both.sum() >= min_ok * len(both)
    np.testing.assert_allclose(nn(pos_t)[both], nn(pos_j)[both], atol=POS_ATOL)


@pytest.mark.parametrize("half", [3, 7])
def test_track_level_matches(rng, half):
    img, nxt = _pair(rng)
    pts, _ = _tracks(rng)
    guess = pts + np.float32(0.4)
    pj, okj, ej = jlk.track_level(jnp.asarray(img), jnp.asarray(nxt), jnp.asarray(pts),
                                  jnp.asarray(guess), half, 10, 1e-3)
    pt, okt, et = tlk.track_level(tt(img), tt(nxt), tt(pts), tt(guess), half, 10, 1e-3)
    _compare_tracks(pt, okt, pj, okj)
    both = nn(okt) & nn(okj)
    np.testing.assert_allclose(nn(et)[both], nn(ej)[both], rtol=1e-3, atol=1e-2)
    # the NaN slot fails cleanly
    assert not nn(okt)[5] and not np.isfinite(nn(pt)[5]).all()


def test_track_pyramid_matches(rng):
    img, nxt = _pair(rng, shift=(3.2, -4.6))
    pts, valid = _tracks(rng)
    rj = jlk.track_pyramid(jpyr(jnp.asarray(img), 3), jpyr(jnp.asarray(nxt), 3),
                           jnp.asarray(pts), jnp.asarray(valid), half_window=7,
                           iters=10, eps=1e-3)
    rt = tlk.track_pyramid(tpyr(tt(img), 3), tpyr(tt(nxt), 3), tt(pts), tt(valid),
                           half_window=7, iters=10, eps=1e-3)
    _compare_tracks(rt.pos, rt.ok, rj.pos, rj.ok)
    assert not nn(rt.ok)[5] and not nn(rt.ok)[7]
    # the tracked flow (x, y) is the applied shift (ndimage takes (dy, dx))
    ok = nn(rt.ok)
    flow = (nn(rt.pos) - pts)[ok]
    np.testing.assert_allclose(np.median(flow, 0), [-4.6, 3.2], atol=0.1)


def test_align_to_templates_matches(rng):
    img, nxt = _pair(rng, shift=(0.6, 0.9))
    pts, valid = _tracks(rng)
    templates = np.asarray(jlk.extract_patches(jnp.asarray(img), jnp.asarray(pts), 4))
    start = pts + np.float32(0.5)        # LK result to refine
    rj = jlk.align_to_templates(jnp.asarray(nxt), jnp.asarray(templates),
                                jnp.asarray(start), jnp.asarray(valid), iters=8)
    rt = tlk.align_to_templates(tt(nxt), tt(templates), tt(start), tt(valid), iters=8)
    _compare_tracks(rt.pos, rt.ok, rj.pos, rj.ok)
    # rejected refinements keep the input position exactly
    rej = ~nn(rt.ok) & np.isfinite(start).all(-1)
    np.testing.assert_array_equal(nn(rt.pos)[rej], start[rej])


def test_template_gradient_is_jnp_gradient(rng):
    t = rng.normal(size=(5, 9, 9)).astype(np.float32)
    gy, gx = jnp.gradient(jnp.asarray(t), axis=(-2, -1))
    np.testing.assert_allclose(nn(tlk._gradient(tt(t), -1)), nn(gx), atol=0)
    np.testing.assert_allclose(nn(tlk._gradient(tt(t), -2)), nn(gy), atol=0)


@pytest.mark.parametrize("half", [2, 3, 4])
def test_extract_patches_matches(rng, half):
    img, _ = _pair(rng)
    pts, _ = _tracks(rng)
    pts[8] = [-3.5, 200.25]             # far outside: edge-clamped samples
    want = nn(jlk.extract_patches(jnp.asarray(img), jnp.asarray(pts), half))
    got = nn(tlk.extract_patches(tt(img), tt(pts), half))
    fin = np.isfinite(pts).all(-1)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6)
    assert got.shape == (len(pts), 2 * half + 1, 2 * half + 1)


def test_wrappers_take_plain_twin_only_on_cpu():
    """On a CPU tensor no kernel launches; the counters stay put."""
    counters = (tlk.track_pyramid, tlk.track_level, tlk.sample_patches,
                tlk.align_to_templates)
    before = [c.launches for c in counters]
    img = torch.rand(32, 32)
    pts = torch.full((3, 2), 16.0)
    valid = torch.ones(3, dtype=torch.bool)
    tlk.track_pyramid(tpyr(img, 2), tpyr(img, 2), pts, valid, half_window=3, iters=2)
    tlk.track_level(img, img, pts, pts, 3, 2, 1e-3)
    tlk.sample_patches(img, pts, 2)
    tlk.align_to_templates(img, torch.rand(3, 5, 5), pts, valid)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("half,fits", [(1, True), (7, True), (15, True), (59, True),
                                       (60, False), (0, False), (-3, False)])
def test_check_window_is_the_shared_memory_limit(half, fits):
    """K1 keeps 3 W^2 + (W + 5)^2 float32 per track in shared memory
    (template, gradients, staged window), at most 227 KB (232,448 bytes) per
    block on an H100: W = 119 (half 59) fits, W = 121 does not. Pure
    arithmetic: the same check runs before every launch."""
    W = 2 * half + 1
    assert tlk.MAX_HALF_WINDOW == 59
    assert tlk.track_smem_bytes(59) == 4 * (3 * 119 ** 2 + 124 ** 2) == 231_436
    assert tlk.track_smem_bytes(59) <= tlk.SMEM_PER_BLOCK < tlk.track_smem_bytes(60)
    assert fits == (half >= 1 and 4 * (3 * W * W + (W + 5) ** 2) <= tlk.SMEM_PER_BLOCK)
    if fits:
        tlk._check_window(half)
    else:
        with pytest.raises(ValueError, match="outside \\[1, 59\\]"):
            tlk._check_window(half)
