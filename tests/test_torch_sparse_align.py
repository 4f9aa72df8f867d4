"""Port parity for kernel K2's users: patch sampling at the sparse-alignment
widths (W=5 every iteration, W=7 once on the reference image) and the
sparse_align pose itself — dr3_tpu (jnp) vs dr3_tpu_torch (plain twins),
on a rendered plane and on the cases the one-launch kernel must reproduce
(tests/torch_parity.py sparse_align_case; the card tests hold the kernel to
the plain version on the same cases)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from dr3_tpu.geometry.lie import SE3 as JSE3
from dr3_tpu.models.camera import Pinhole as JPinhole
from dr3_tpu.ops import sparse_align as jsa
from dr3_tpu_torch.models.camera import Pinhole as TPinhole
from dr3_tpu_torch.ops import lk as tlk
from dr3_tpu_torch.ops import sparse_align as tsa
from tests.test_sparse_align import render_plane
from dr3_tpu_torch.geometry.lie import SE3 as TSE3
from tests.torch_parity import SPARSE_ALIGN_CASES, nn, sparse_align_case, tse3, tt


@pytest.mark.parametrize("half", [2, 3])
def test_sample_patches_widths(rng, half):
    """W=5 and W=7 patches on a level-2-sized image, atol 1e-5 (the
    tolerance the Pallas sampler is held to, tests/test_lk_pallas.py:144)."""
    img = rng.uniform(0, 1, (94, 310)).astype(np.float32)
    centers = np.stack([rng.uniform(-4, 314, 200), rng.uniform(-4, 98, 200)],
                       -1).astype(np.float32)
    want = nn(jsa._sample_patches(jnp.asarray(img), jnp.asarray(centers), half))
    got = nn(tlk.sample_patches(tt(img), tt(centers), half))
    np.testing.assert_allclose(got, want, atol=1e-5)


def _scene(rng):
    cam = JPinhole.create(320, 240, 260.0, 260.0, 160.0, 120.0)
    texture = ndimage.gaussian_filter(rng.uniform(0, 1, (1200, 1200)), 2.0).astype(np.float32)
    T_cur = JSE3.exp(jnp.asarray([0.05, -0.03, 0.08, 0.004, -0.006, 0.003]))
    img_ref = render_plane(cam, JSE3.identity(), texture, level_scale=0.5)
    img_cur = render_plane(cam, T_cur, texture, level_scale=0.5)
    pts = np.stack([rng.uniform(-2.0, 2.0, 120), rng.uniform(-1.5, 1.5, 120),
                    np.full(120, 5.0)], -1).astype(np.float32)
    valid = np.ones(120, bool)
    valid[:10] = False
    return cam, img_ref, img_cur, pts, valid


@pytest.mark.parametrize("half_patch", [2, 3])
def test_sparse_align_pose_matches(rng, half_patch):
    """Same LM steps on the same patches: final pose within 1e-4 (float32
    reductions over ~3000 residuals in another order), same feature count."""
    cam, img_ref, img_cur, pts, valid = _scene(rng)
    rj = jsa.sparse_align(jnp.asarray(img_ref), jnp.asarray(img_cur), JSE3.identity(),
                          JSE3.identity(), cam, jnp.asarray(pts), jnp.asarray(valid),
                          level=1, half_patch=half_patch, iters=12)
    ct = TPinhole.create(320, 240, 260.0, 260.0, 160.0, 120.0)
    ident = tse3(JSE3.identity())
    rt = tsa.sparse_align(tt(img_ref), tt(img_cur), ident, ident, ct, tt(pts),
                          tt(valid), level=1, half_patch=half_patch, iters=12)
    assert int(rt.n_used) == int(rj.n_used)
    np.testing.assert_allclose(float(rt.cost0), float(rj.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(nn(rt.T.wxyz), nn(rj.T.wxyz), atol=1e-4)
    np.testing.assert_allclose(nn(rt.T.t), nn(rj.T.t), atol=1e-4)
    assert float(rt.cost) < 0.1 * float(rt.cost0)


def _port_align(c, iters=None):
    return tsa.sparse_align(
        tt(c["img_ref"]), tt(c["img_cur"]), TSE3(*map(tt, c["T_ref"])),
        TSE3(*map(tt, c["T_init"])), TPinhole.create(*c["intrinsics"]), tt(c["points"]),
        tt(c["valid"]), level=c["level"], half_patch=c["half_patch"],
        iters=c["iters"] if iters is None else iters)


@pytest.mark.parametrize("name", SPARSE_ALIGN_CASES)
def test_sparse_align_cases_match(name):
    """Pose atol 1e-4, cost0 rtol 1e-4, n_used exact, as the test above."""
    c = sparse_align_case(name)
    rj = jsa.sparse_align(
        jnp.asarray(c["img_ref"]), jnp.asarray(c["img_cur"]),
        JSE3(*map(jnp.asarray, c["T_ref"])), JSE3(*map(jnp.asarray, c["T_init"])),
        JPinhole.create(*c["intrinsics"]), jnp.asarray(c["points"]), jnp.asarray(c["valid"]),
        level=c["level"], half_patch=c["half_patch"], iters=c["iters"])
    rt = _port_align(c)
    assert rt.n_used.dtype == torch.int64 and int(rt.n_used) == int(rj.n_used)
    np.testing.assert_allclose(float(rt.cost0), float(rj.cost0), rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(nn(rt.T.wxyz), nn(rj.T.wxyz), atol=1e-4)
    np.testing.assert_allclose(nn(rt.T.t), nn(rj.T.t), atol=1e-4)
    if name == "all_invalid":
        # H = 1e-8 I, delta = 0, no step accepted: T_init comes back as given
        assert int(rt.n_used) == 0 and float(rt.cost0) == 0.0
        np.testing.assert_array_equal(nn(rt.T.wxyz), c["T_init"][0])
        np.testing.assert_array_equal(nn(rt.T.t), c["T_init"][1])
    elif name == "few_usable":
        assert 0 < int(rt.n_used) < 20
    elif name == "iters0":
        assert float(rt.cost) == float(rt.cost0)
        np.testing.assert_array_equal(nn(rt.T.t), c["T_init"][1])
    elif name in ("behind_camera", "outside_image"):
        assert int(rt.n_used) < int(c["valid"].sum())
        assert float(rt.cost) < 0.1 * float(rt.cost0)
    elif name in ("far_init", "level2"):
        # a step that does not lower the cost is refused and lam grows 4x: the
        # cost stands still over such a step, and at level 2 falls again later
        costs = [float(_port_align(c, k).cost) for k in range(c["iters"] + 1)]
        refused = [b == a for a, b in zip(costs, costs[1:])]
        assert any(refused) and not all(refused) and costs[-1] == float(rt.cost)
        if name == "level2":
            first = refused.index(True)
            assert not all(refused[first:])
