"""Port parity for kernel K4's functions (dr3_tpu_torch.ops.warp) on the
CPU, where the wrappers run their plain versions: dr3_tpu.ops.warp (jnp,
the oracle) and the TPU kernels' own contracts
(dr3_tpu.ops.pallas.warp_pallas remap_rows / remap_cols, interpreted).

Tolerances: atol 1e-5 on values; both sides compute the same float32 source
coordinates, apart from the last bit of transcendental and division round-
off, so a sample whose coordinate sits within that of the image border may
change its validity: at most 3 such flips, as tests/test_warp_pallas.py
budgets for the same knife-edge effect.

The spherical and cylindrical fields go through sin/cos, whose PyTorch and
XLA implementations differ in the last bit: the fields agree within 2 ulp
(3.1e-5 px at source coordinates of 128-256 px), and on a uniform-noise
image, which changes by up to 1 per px, that moves a value by up to the
same amount; those warps are held at PROJECTION_ATOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.ops import warp as jw
from dr3_tpu.ops.pallas import warp_pallas as wp
from dr3_tpu_torch.ops import warp as tw
from dr3_tpu_torch.tools import warp_tiles
from tests.torch_parity import nn, tt

VALUE_ATOL = 1e-5
FIELD_ATOL = 3.1e-5
PROJECTION_ATOL = VALUE_ATOL + FIELD_ATOL
MAX_FLIPS = 3
# warp_pallas.py's own single-axis tolerance against direct bilinear
PALLAS_ATOL = 2e-3

H1 = np.asarray([[1.02, 0.03, 4.0], [-0.02, 0.98, -2.5],
                 [1e-5, -2e-5, 1.0]], np.float32)
H2 = np.asarray([[0.98, 0.05, 60.0], [-0.04, 1.01, 8.0],
                 [2e-5, 1e-5, 1.0]], np.float32)


def _img(rng, h=93, w=201, c=None):
    shape = (h, w) if c is None else (h, w, c)
    return rng.uniform(0, 1, shape).astype(np.float32)


def _grid(h=93, w=201):
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    return gx, gy


def _close_with_flips(got, got_valid, want, want_valid, atol=VALUE_ATOL):
    got_valid, want_valid = nn(got_valid), nn(want_valid)
    assert int((got_valid != want_valid).sum()) <= MAX_FLIPS
    both = got_valid & want_valid
    np.testing.assert_allclose(nn(got)[both], nn(want)[both], rtol=0, atol=atol)
    # outside the image both sides write the fill value
    out = ~got_valid & ~want_valid
    np.testing.assert_array_equal(nn(got)[out], nn(want)[out])


@pytest.mark.parametrize("clamp", [False, True])
def test_bilinear_sample_rgb(rng, clamp):
    img = _img(rng, 40, 57, 3)
    xy = np.stack([rng.uniform(-5, 62, (30, 7)), rng.uniform(-5, 45, (30, 7))],
                  -1).astype(np.float32)
    xy[0, 0] = [np.nan, 3.0]
    xy[0, 1] = [1e9, -1e9]
    vj, okj = jw.bilinear_sample(jnp.asarray(img), jnp.asarray(xy), fill=0.25, clamp=clamp)
    vt, okt = tw.bilinear_sample(tt(img), tt(xy), fill=0.25, clamp=clamp)
    assert vt.shape == (30, 7, 3) and okt.shape == (30, 7)
    np.testing.assert_array_equal(nn(okt), nn(okj))
    good = nn(okj) | clamp
    good[0, 0] = False                      # NaN sample: NaN (clamp) or fill
    np.testing.assert_allclose(nn(vt)[good], nn(vj)[good], rtol=0, atol=VALUE_ATOL)
    if not clamp:
        np.testing.assert_array_equal(nn(vt)[~nn(okj)], 0.25)
    # each channel is the 2-D sampler on that plane
    for c in range(3):
        v2, ok2 = tw.bilinear_sample(tt(img[..., c]), tt(xy), fill=0.25, clamp=clamp)
        np.testing.assert_array_equal(nn(v2), nn(vt)[..., c])
        np.testing.assert_array_equal(nn(ok2), nn(okt))


@pytest.mark.parametrize("channels", [None, 3])
def test_remap_matches(rng, channels):
    img = _img(rng, c=channels)
    gx, gy = _grid()
    u = (gx * 1.01 + 3.0 * np.sin(gy / 17.0) - 2.0).astype(np.float32)
    v = (gy * 0.97 + 2.0 * np.cos(gx / 23.0) + 1.5).astype(np.float32)
    want = jw.remap(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), fill=0.5)
    got = tw.remap(tt(img), tt(u), tt(v), fill=0.5)
    np.testing.assert_allclose(nn(got), nn(want), rtol=0, atol=VALUE_ATOL)


@pytest.mark.parametrize("H,out_hw", [(H1, (93, 201)), (H2, (120, 260))],
                         ids=["H1", "H2"])
@pytest.mark.parametrize("channels", [None, 3])
def test_warp_perspective_matches(rng, H, out_hw, channels):
    img = _img(rng, c=channels)
    want, vwant = jw.warp_perspective(jnp.asarray(img), jnp.asarray(H), out_hw)
    got, vgot = tw.warp_perspective(tt(img), H, out_hw)
    assert tuple(got.shape) == tuple(want.shape)
    _close_with_flips(got, vgot, want, vwant)


# The regimes of csrc/warp.cu's whole-tile shortcut, at small sizes:
# a 48x64 view translated onto a 48x531 canvas that is mostly fill (the
# panorama paste's geometry: 8 views 67 px apart), a homography whose
# horizon (w = 0 of H^-1, here 1 - 0.01 j) crosses the canvas at column 100,
# and one that maps the whole canvas outside the source
REGIMES = {
    "paste": (np.asarray([[1.0, 0.0, 63.37], [0.0, 1.0, 0.29], [0.0, 0.0, 1.0]], np.float32),
              (48, 64), (48, 531)),
    "horizon": (np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.01, 0.0, 1.0]], np.float32),
                (93, 201), (93, 201)),
    "outside": (np.asarray([[0.9, 0.1, 5000.0], [-0.1, 0.9, 40.0], [1e-5, 0.0, 1.0]],
                           np.float32), (40, 57), (61, 130)),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("channels", [None, 3])
def test_warp_perspective_regimes(rng, regime, channels):
    H, (h, w), out_hw = REGIMES[regime]
    img = _img(rng, h, w, channels)
    want, vwant = jw.warp_perspective(jnp.asarray(img), jnp.asarray(H), out_hw, fill=0.4)
    got, vgot = tw.warp_perspective(tt(img), H, out_hw, fill=0.4)
    assert tuple(got.shape) == tuple(want.shape)
    _close_with_flips(got, vgot, want, vwant)
    share = nn(vgot).mean()
    assert {"paste": 0.08 < share < 0.15, "horizon": 0.0 < share < 0.5,
            "outside": share == 0.0}[regime]


def _random_homographies(seed, n=10):
    """n homographies from the source's frame onto a canvas: similarities
    with a shift of up to 400 px and perspective terms that put a horizon
    on the canvas now and then; every fifth nearly singular (rank 1 plus
    1e-4 of the identity)."""
    r = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 5 == 4:
            u, v = r.normal(size=3), r.normal(size=3)
            out.append((np.outer(u, v) + 1e-4 * np.eye(3)).astype(np.float32))
            continue
        a, s = r.uniform(-0.5, 0.5), r.uniform(0.5, 2.0)
        H = np.asarray([[s * np.cos(a), -s * np.sin(a), r.uniform(-400, 400)],
                        [s * np.sin(a), s * np.cos(a), r.uniform(-100, 100)],
                        [r.normal(0, 3e-3), r.normal(0, 3e-3), 1.0]])
        out.append(H.astype(np.float32))
    return out


def _shortcut_cases():
    cases = [(regime,) + REGIMES[regime] for regime in sorted(REGIMES)]
    for seed in range(5):
        cases += [(f"random{seed}.{k}", H, (40, 57), (61, 303))
                  for k, H in enumerate(_random_homographies(seed))]
    return cases


@pytest.mark.parametrize("batch", range(6))
def test_shortcut_tiles_hold_no_valid_pixel(batch):
    """csrc/warp.cu's whole-tile rule (mirrored by tools/warp_tiles.py
    shortcut_tiles in the kernel's float32 operations; a card test holds
    the copy against the kernel) takes only tiles whose every pixel the
    plain version finds outside the source: the paste's canvas mostly, the
    tiles the horizon crosses never, an all-outside canvas wholly."""
    cases = _shortcut_cases()
    cases = cases[:3] if batch == 0 else cases[3 + 10 * (batch - 1):3 + 10 * batch]
    for name, H, src_hw, out_hw in cases:
        Hinv = tw.homography_inverse(H)
        skip = warp_tiles.shortcut_tiles(Hinv, src_hw, out_hw)
        _, valid = tw._warp_perspective_plain(torch.zeros(src_hw), Hinv, out_hw, 0.0)
        ty, tx = warp_tiles.tile_of_pixels(out_hw)
        assert skip.shape == (ty.max() + 1, tx.max() + 1), name
        assert not nn(valid)[skip[ty, tx]].any(), name
        if name == "paste":
            assert skip.mean() > 0.5
        elif name == "outside":
            assert skip.all()
        elif name == "horizon":
            assert not skip[:, 0].any()                  # the view's own tile
            assert not skip[:, tx[0, 100]].any()         # w changes sign in it


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_homography_inverse_is_inv3x3(rng, scale):
    """The warps' host inverse is the JAX warp's inv3x3 (and the port's)
    bit for bit, on random and singular homographies at any scale."""
    from dr3_tpu.geometry.linalg import inv3x3 as jinv3x3
    from dr3_tpu_torch.geometry.linalg import inv3x3
    Hs = np.eye(3) + rng.normal(0, [[0.2, 0.2, 50], [0.2, 0.2, 50], [1e-3, 1e-3, 0.1]],
                                (64, 3, 3))
    Hs[0] = np.outer([1.0, 2.0, 3.0], [0.5, -1.0, 2.0])           # rank 1
    Hs = (Hs * scale).astype(np.float32)
    for H in Hs:
        got = tw.homography_inverse(H)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, nn(inv3x3(tt(H))))
        np.testing.assert_allclose(got, nn(jinv3x3(jnp.asarray(H))), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tw.homography_inverse(tt(Hs[1])), tw.homography_inverse(Hs[1]))


def test_warp_affine_matches(rng):
    img = _img(rng, c=3)
    M = np.asarray([[0.96, -0.12, 14.0], [0.1, 1.03, -6.5]], np.float32)
    want, vwant = jw.warp_affine(jnp.asarray(img), jnp.asarray(M), (110, 190), fill=0.1)
    got, vgot = tw.warp_affine(tt(img), M, (110, 190), fill=0.1)
    _close_with_flips(got, vgot, want, vwant)


def _inside(u, v, h=93, w=201):
    u, v = nn(u), nn(v)
    return (u >= 0) & (v >= 0) & (u <= w - 1) & (v <= h - 1)


@pytest.mark.parametrize("f", [150.0, 300.0])
def test_warp_spherical_matches(rng, f):
    img = _img(rng, c=3)
    want = jw.warp_spherical(jnp.asarray(img), f)
    got = tw.warp_spherical(tt(img), f)
    u, v = jw.spherical_warp_field(93, 201, f)
    ut, vt = tw.spherical_warp_field(93, 201, f)
    np.testing.assert_allclose(nn(ut), nn(u), rtol=0, atol=FIELD_ATOL)
    np.testing.assert_allclose(nn(vt), nn(v), rtol=0, atol=FIELD_ATOL)
    _close_with_flips(got, _inside(ut, vt), want, _inside(u, v), atol=PROJECTION_ATOL)


def test_warp_cylindrical_matches(rng):
    img = _img(rng)
    want = jw.warp_cylindrical(jnp.asarray(img), 150.0)
    got = tw.warp_cylindrical(tt(img), 150.0)
    u, v = jw.cylindrical_warp_field(93, 201, 150.0)
    ut, vt = tw.cylindrical_warp_field(93, 201, 150.0)
    np.testing.assert_allclose(nn(ut), nn(u), rtol=0, atol=FIELD_ATOL)
    np.testing.assert_allclose(nn(vt), nn(v), rtol=0, atol=FIELD_ATOL)
    _close_with_flips(got, _inside(ut, vt), want, _inside(u, v), atol=PROJECTION_ATOL)


def _row_fields():
    gx, gy = _grid()
    return {
        "shift3.25": np.clip(gy + 3.25, 0, 92),
        "shift-7.6": np.clip(gy - 7.6, 0, 92),
        "shift0.5": np.clip(gy + 0.5, 0, 92),
        "sine": np.clip(gy + 4.0 * np.sin(gx / 30.0), 0, 92),
    }


@pytest.mark.parametrize("name", ["shift3.25", "shift-7.6", "shift0.5", "sine"])
def test_remap_rows_matches(rng, name):
    img = _img(rng)
    v = _row_fields()[name].astype(np.float32)
    gx, _ = _grid()
    got = nn(tw.remap_rows(tt(img), tt(v)))
    want = wp.remap_rows(jnp.asarray(img), jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(got, nn(want), rtol=0, atol=PALLAS_ATOL)
    ref, _ = jw.bilinear_sample(jnp.asarray(img), jnp.asarray(np.stack([gx, v], -1)),
                                clamp=True)
    np.testing.assert_allclose(got, nn(ref), rtol=0, atol=VALUE_ATOL)


@pytest.mark.parametrize("shift", [3.25, -7.6, 0.5])
def test_remap_cols_matches(rng, shift):
    img = _img(rng)
    gx, gy = _grid()
    u = np.clip(gx + shift, 0, 200).astype(np.float32)
    got = nn(tw.remap_cols(tt(img), tt(u)))
    want = wp.remap_cols(jnp.asarray(img), jnp.asarray(u), interpret=True)
    np.testing.assert_allclose(got, nn(want), rtol=0, atol=PALLAS_ATOL)
    ref, _ = jw.bilinear_sample(jnp.asarray(img), jnp.asarray(np.stack([u, gy], -1)),
                                clamp=True)
    np.testing.assert_allclose(got, nn(ref), rtol=0, atol=VALUE_ATOL)


def test_remap_rows_far_out_replicates_border(rng):
    """Far-out rows read the border row (the TPU kernel's sentinel case);
    the plain version needs no capacity check."""
    img = _img(rng)
    gx, gy = _grid()
    v = np.where(gx > 150.0, 5000.0, gy + 2.5).astype(np.float32)
    got = nn(tw.remap_rows(tt(img), tt(v)))
    np.testing.assert_array_equal(got[:, 151:], np.broadcast_to(img[92, 151:], (93, 50)))
    ref, _ = jw.bilinear_sample(jnp.asarray(img), jnp.asarray(np.stack([gx, v], -1)),
                                clamp=True)
    np.testing.assert_allclose(got, nn(ref), rtol=0, atol=VALUE_ATOL)


def test_wrappers_reject_bad_shapes(rng):
    img = tt(_img(rng, 20, 30))
    with pytest.raises(ValueError):
        tw.remap_rows(img, torch.zeros(5, 31))
    with pytest.raises(ValueError):
        tw.remap_cols(img, torch.zeros(21, 8))
