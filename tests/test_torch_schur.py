"""The reduced camera matrix from co-visible blocks (ops/schur.py), on the
CPU: the plain versions against float64 oracles built inside the test (Z
scattered densely from the same blocks, Z^T Z formed whole), the pair
structure against a brute-force enumeration, and the zexplicit step on
the cases that stress it. The kernels against these plain versions on the
card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from dr3_tpu_torch.ba import snavely as ts
from dr3_tpu_torch.ba.schur_core import _table_reducer, cam_onehot_matrix
from dr3_tpu_torch.ops import schur
from dr3_tpu_torch.tools.ba_time import bal_case
from tests.torch_parity import rand_bal

CASES = ("banded", "all_visible", "padded", "fixed_and_unseen_camera", "seen_once")
LAM = 1e-3


def _padded(p):
    """Every observation again as a zero-weight row: clamped ids that
    collide with the live rows."""
    twice = lambda a: torch.cat([a, a])  # noqa: E731
    return p._replace(obs_cam=twice(p.obs_cam), obs_pt=twice(p.obs_pt), obs_uv=twice(p.obs_uv),
                      obs_w=torch.cat([p.obs_w, torch.zeros_like(p.obs_w)]))


def _problem(name, rng):
    """banded: tools/ba_time's visibility at 8 cameras (points at both ends
    seen by one camera); all_visible: every camera sees every point;
    padded: banded with every row again at zero weight; fixed_and_unseen_
    camera: two gauge cameras and a camera with no observation; seen_once:
    a third of the points keep one observation."""
    if name in ("banded", "padded"):
        p = ts.bal_to_snavely(bal_case(8, 400, 120)[0], device="cpu")
        return _padded(p) if name == "padded" else p
    d = rand_bal(rng, n_cams=6, n_pts=45, noise=2.0, pt_noise=0.1)
    p = ts.bal_to_snavely(d, device="cpu")
    if name == "all_visible":
        return p
    oc, op = p.obs_cam.long(), p.obs_pt.long()
    if name == "fixed_and_unseen_camera":
        keep = oc != 3
        fixed = torch.zeros(6, dtype=torch.bool)
        fixed[:2] = True
    else:
        keep = (op >= 15) | (oc == op % 6)
        fixed = p.cam_fixed
    return p._replace(obs_cam=p.obs_cam[keep], obs_pt=p.obs_pt[keep], obs_uv=p.obs_uv[keep],
                      obs_w=p.obs_w[keep], cam_fixed=fixed)


def _blocks(p):
    E = cam_onehot_matrix(p.obs_cam, p.n_cams)
    return ts._assemble_direct(p, E, 1e9)[0], E


def _pairs(blocks, K):
    table = _table_reducer(blocks.obs_pt, blocks.Hpp9.shape[0]).table
    return schur.schur_pairs(blocks.obs_cam, blocks.obs_pt, table, K)


def _factor_and_blocks(blocks, pairs):
    lam = torch.tensor(LAM)
    Hcc = blocks.Hcc.contiguous()
    Hinv9, Gs, dinv = schur.schur_factor(blocks.Hpp9.contiguous(), Hcc, lam, blocks.Jcu,
                                         blocks.Jcv, blocks.Jpu, blocks.Jpv, pairs)
    return Hinv9, Gs, dinv, schur.schur_blocks(Gs, dinv, Hcc, lam, pairs)


def _unrows(Gs, pairs):
    """[O, 3, 9] factors by observation from the kernel's rows."""
    G = torch.empty((Gs.shape[0], 3, 9), dtype=Gs.dtype)
    G[pairs.cam_obs.long()] = Gs.view(-1, 9, 4)[:, :, :3].transpose(1, 2)
    return G


def _factor_oracle(blocks):
    """float64 (Hinv9, G [O, 3, 9]): the damped point inverses by
    torch.linalg.inv, L L^T = Hinv by torch.linalg.cholesky, G_o =
    L^T Jp_o^T Jc_o."""
    H = blocks.Hpp9.double().reshape(-1, 3, 3)
    H = H + torch.diag_embed(LAM * torch.diagonal(H, dim1=-2, dim2=-1) + 1e-8)
    Hinv = torch.linalg.inv(H)
    L = torch.linalg.cholesky(Hinv)[blocks.obs_pt]                         # [O, 3, 3]
    Jp = torch.stack([blocks.Jpu, blocks.Jpv], 1).double()                 # [O, 2, 3]
    Jc = torch.stack([blocks.Jcu, blocks.Jcv], 1).double()                 # [O, 2, 9]
    return Hinv.reshape(-1, 9), L.transpose(1, 2) @ Jp.transpose(1, 2) @ Jc


def _s_oracle(blocks, Gs, dinv, pairs):
    """float64 (S~, dinv) from the same scaled factors: Z diag(dinv) [3P,
    9K] scattered densely from them (adding where ids collide), the damped
    Hcc on the diagonal less the scaled Z^T Z as one product; dinv again
    from Z's column norms (the factors unscaled)."""
    K, P = blocks.Hcc.shape[0], blocks.Hpp9.shape[0]
    G = _unrows(Gs, pairs).double()                                        # [O, 3, 9]
    O = G.shape[0]
    rows = (3 * blocks.obs_pt[:, None] + torch.arange(3))[:, :, None].expand(O, 3, 9)
    cols = (9 * blocks.obs_cam[:, None] + torch.arange(9))[:, None, :].expand(O, 3, 9)
    Zs = torch.zeros(3 * P, 9 * K, dtype=torch.float64)
    Zs.index_put_((rows.reshape(-1), cols.reshape(-1)), G.reshape(-1), accumulate=True)
    d = dinv.double()
    Hd = schur._damp_hcc(blocks.Hcc.double(), LAM)
    S = torch.block_diag(*Hd) * (d[:, None] * d[None, :]) - Zs.T @ Zs
    hdiag = torch.diagonal(Hd, dim1=-2, dim2=-1).reshape(-1)
    colsq = ((Zs / d) ** 2).sum(0)
    sdiag = torch.maximum(hdiag - colsq, 1e-10 * torch.clamp(hdiag, min=1e-20))
    return S, 1.0 / torch.sqrt(sdiag)


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", CASES)
def test_schur_plain_matches_float64_oracle(rng, name):
    """The plain factor against float64 inverses, Cholesky factors and
    factors G (scaled by the kernel's dinv), within 1e-3 of each array's
    scale: the float32 inverse of a point seen
    by one or two cameras holds its depth by the damping alone, a block
    conditioned up to ~1e4 (measured: 1.4e-4 per point at most); the rows'
    pads zero. S~ and dinv against Z^T Z formed densely in float64 from the
    same scaled factors: S~ within
    2e-5 of its scale (float32 sums of up to ~400 pairs a block; measured
    3.8e-6 at most), dinv rtol 1e-5; S~ symmetric bit for bit. A camera
    with no observation gets an identity diagonal block and no coupling."""
    p = _problem(name, rng)
    blocks, _ = _blocks(p)
    K = p.n_cams
    pairs = _pairs(blocks, K)
    Hinv9, Gs, dinv, S = _factor_and_blocks(blocks, pairs)
    Hinv_o, G_o = _factor_oracle(blocks)
    assert _rel(Hinv9, Hinv_o) <= 1e-3
    d = dinv.double().view(K, 9)[blocks.obs_cam][:, None, :]
    assert _rel(_unrows(Gs, pairs), G_o * d) <= 1e-3
    assert float(Gs.view(-1, 9, 4)[:, :, 3].abs().max()) == 0.0
    S_o, dinv_o = _s_oracle(blocks, Gs, dinv, pairs)
    assert _rel(S, S_o) <= 2e-5
    np.testing.assert_allclose(dinv.numpy(), dinv_o.numpy(), rtol=1e-5, atol=0)
    assert torch.equal(S, S.T)
    if name == "fixed_and_unseen_camera":
        b = S[27:36]
        torch.testing.assert_close(b[:, 27:36], torch.eye(9), rtol=0, atol=1e-6)
        assert float(torch.cat([b[:, :27], b[:, 36:]], 1).abs().max()) == 0.0
    if name == "padded":
        # the same blocks without the padding rows: S~ bit for bit
        O = p.n_obs // 2
        live = blocks._replace(**{k: getattr(blocks, k)[:O] for k in
                                  ("Jcu", "Jcv", "Jpu", "Jpv", "obs_cam", "obs_pt", "active")})
        assert torch.equal(_factor_and_blocks(live, _pairs(live, K))[3], S)


def _brute_pairs(oc, op, K):
    """{block key: sorted [(point, {o1, o2})]} over every unordered pair of
    observations of one point, a pair with itself included, twice where
    one camera made both."""
    out = {}
    for pt in np.unique(op):
        obs = np.flatnonzero(op == pt)
        for a, o1 in enumerate(obs):
            for o2 in obs[a:]:
                i, j = sorted((oc[o1], oc[o2]))
                pair = (int(pt), frozenset((int(o1), int(o2))))
                # two observations by one camera: the pair in both orders
                out.setdefault(int(i * K + j), []).extend([pair] * (1 + (i == j and o1 != o2)))
    return {k: sorted(v, key=lambda t: (t[0], sorted(t[1]))) for k, v in out.items()}


@pytest.mark.parametrize("name", CASES)
def test_schur_pairs_match_brute_force(rng, name):
    """The pair structure: each block's CSR range holds exactly its pairs
    from a brute-force enumeration, sorted by point, oriented so that the
    first observation is camera i's and the second camera j's; the list
    holds those pairs and nothing else, as many as pair_sizes counts beside
    the table's width; the camera ranges hold each camera's observations
    in index order (the rows are observations in that order)."""
    p = _problem(name, rng)
    K = p.n_cams
    oc, op = p.obs_cam.numpy(), p.obs_pt.numpy()
    table = _table_reducer(p.obs_pt.long(), p.n_points).table
    pr = schur.schur_pairs(p.obs_cam, p.obs_pt, table, K)
    want = _brute_pairs(oc, op, K)
    obs = pr.cam_obs.numpy()
    ptr, oi, oj = pr.blk_ptr.numpy(), obs[pr.qi.numpy()], obs[pr.qj.numpy()]
    assert ptr[0] == 0 and (np.diff(ptr) >= 0).all()
    assert ptr[-1] == sum(len(v) for v in want.values()) == len(oi) == len(oj)
    assert schur.pair_sizes(p.obs_cam, p.obs_pt, K, p.n_points) == (table.shape[1], ptr[-1])
    for key in range(K * K):
        got = [(int(op[a]), frozenset((int(a), int(b)))) for a, b in
               zip(oi[ptr[key]:ptr[key + 1]], oj[ptr[key]:ptr[key + 1]])]
        assert [g[0] for g in got] == sorted(g[0] for g in got), key
        assert sorted(got, key=lambda t: (t[0], sorted(t[1]))) == want.get(key, []), key
        i, j = divmod(key, K)
        seg = slice(ptr[key], ptr[key + 1])
        assert (oc[oi[seg]] == i).all() and (oc[oj[seg]] == j).all() and (op[oi[seg]] == op[oj[seg]]).all()
    assert obs.tolist() == np.argsort(oc, kind="stable").tolist()
    assert pr.cam_ptr.tolist() == np.searchsorted(np.sort(oc), np.arange(K + 1)).tolist()


def test_schur_pairs_refuse_int32_overflow(rng, monkeypatch):
    """A pair list past the kernel's int32 offsets raises before it is
    built (the limit lowered to one pair short of a small problem's)."""
    p = _problem("banded", rng)
    table = _table_reducer(p.obs_pt.long(), p.n_points).table
    n = schur.pair_sizes(p.obs_cam, p.obs_pt, p.n_cams, p.n_points)[1]
    monkeypatch.setattr(schur, "_MAX_PAIRS", n - 1)
    with pytest.raises(ValueError, match="int32"):
        schur.schur_pairs(p.obs_cam, p.obs_pt, table, p.n_cams)
    monkeypatch.setattr(schur, "_MAX_PAIRS", n)
    assert schur.schur_pairs(p.obs_cam, p.obs_pt, table, p.n_cams).qi.shape[0] == n


@pytest.mark.parametrize("name", CASES)
def test_zexplicit_step_on_schur_blocks(rng, name):
    """_solve_explicit_direct through the block path: a finite step, zero
    on the gauge cameras, the same bits twice and with the pairs built by
    the caller (the padded problem against the unpadded one end to end:
    test_torch_snavely.py); three LM iterations lower the cost."""
    p = _problem(name, rng)
    blocks, E = _blocks(p)
    lam = torch.tensor(LAM)
    dc, dp = ts._solve_explicit_direct(blocks, lam, p.cam_fixed, E)
    assert torch.isfinite(dc).all() and torch.isfinite(dp).all()
    assert float(dc[p.cam_fixed].abs().max()) == 0.0 and float(dc.abs().max()) > 0
    by_pt = _table_reducer(blocks.obs_pt, p.n_points)
    again = ts._solve_explicit_direct(blocks, lam, p.cam_fixed, E, by_pt,
                                      _pairs(blocks, p.n_cams))
    assert torch.equal(again[0], dc) and torch.equal(again[1], dp)
    r = ts.bundle_adjust_snavely(p, 3, huber_delta=1e9, solver="zexplicit")
    assert float(r.final_cost) < float(r.initial_cost)
