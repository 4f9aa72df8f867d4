"""The generic PCG's operator S p over the keyed tables (ops/schur_mv.py)
on the CPU: the plain version against the products PCG.s_mv ran before it
(a copy kept here, ``_products_s_mv``) on random keyed-table problems,
PCG's choice between the two, and the camera solve through it. The kernels
against the plain version on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from dr3_tpu_torch.ba import schur_core
from dr3_tpu_torch.ba.schur_core import PCG, _solve_schur, assemble_blocks, reduce_system
from dr3_tpu_torch.ops import schur_mv as smv

CASES = ("mixed", "padded_slots", "long_track", "six_dof")


def _products_s_mv(cg, x):
    """PCG.s_mv as the products over the one-hot E, the point scan or the
    keyed tables, bordered by the global block where there is one."""
    red, b = cg.red, cg.red.blocks
    xc, xg = x
    xk = xc * cg.keep_c
    u = red.by_pt(torch.einsum("ocj,oc->oj", b.AtB, red.to_obs(xk)))
    v = torch.einsum("pij,pj->pi", red.Hpp_inv, u)
    y = torch.einsum("kcd,kd->kc", red.Hcc_d, xk) - red.by_cam(
        torch.einsum("ocj,oj->oc", b.AtB, v[b.obs_pt]))
    if red.border is not None:
        y = y + torch.einsum("kgc,g->kc", cg.S_gc, xg)
        yg = torch.einsum("kgc,kc->g", cg.S_gc, xk) + cg.S_gg @ xg
    else:
        yg = xg
    return y * cg.keep_c + xc * cg.fixed_c, yg


def _observations(rng, case):
    """(K, P, obs_cam, obs_pt, active, fixed cameras). mixed: random
    visibility with inactive rows, points seen once, two cameras that see
    nothing and a fixed camera; padded_slots: every row again as an
    inactive row (the tables' pad slots and a camera table twice as wide);
    long_track: every camera sees every point (a point's row as wide as
    the cameras); six_dof: mixed with 6-parameter cameras."""
    if case == "long_track":
        K, P = 12, 30
        oc = np.tile(np.arange(K), P)
        op = np.repeat(np.arange(P), K)
        active = rng.uniform(size=K * P) > 0.1
        active[:K] = True                             # point 0 seen by every camera
        return K, P, oc, op, active, [0]
    K, P, O = 20, 150, 700
    oc = rng.choice(np.arange(2, K), O)               # cameras 0 and 1 see nothing
    op = np.concatenate([np.arange(P), rng.integers(0, P // 2, O - P)])   # the upper half once
    active = rng.uniform(size=O) > 0.2
    active[:P] = True
    if case == "padded_slots":
        oc, op = np.concatenate([oc, oc]), np.concatenate([op, op])
        active = np.concatenate([active, np.zeros_like(active)])
    return K, P, oc, op, active, [0, 5]


def _reduced(rng, case, monkeypatch, *, global_block=False, point_sorted=False, lam=1e-3):
    """A damped reduced system of random weighted Jacobians (inactive rows
    zero), its sums through the keyed tables (the one-hot's limit lowered
    to 0) unless ``monkeypatch`` is None."""
    K, P, oc, op, active, fixed_ids = _observations(rng, case)
    if point_sorted:
        order = np.argsort(op, kind="stable")
        oc, op, active = oc[order], op[order], active[order]
    C = 6 if case == "six_dof" else 9
    O = len(oc)
    w = torch.as_tensor(active, dtype=torch.float32)
    g = torch.Generator().manual_seed(int(rng.integers(2**31)))
    r = torch.randn(O, 2, generator=g) * w[:, None]
    Jc = torch.randn(O, 2, C, generator=g) * w[:, None, None]
    Jp = torch.randn(O, 2, 3, generator=g) * w[:, None, None]
    Jg = torch.randn(O, 2, 4, generator=g) * w[:, None, None] if global_block else None
    if monkeypatch is not None:
        monkeypatch.setattr(schur_core, "_ONEHOT_MAX_ELEMS", 0)
    blocks = assemble_blocks(r, Jc, Jp, torch.as_tensor(oc), torch.as_tensor(op),
                             torch.as_tensor(active), K, P, Jg=Jg, point_sorted=point_sorted)
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[fixed_ids] = True
    red = reduce_system(blocks, torch.tensor(lam), fixed, point_sorted=point_sorted)
    return red, fixed, g


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_products(rng, case, monkeypatch):
    """The plain version against the products on keyed-table problems:
    within 1e-6 of the largest entry of S p, fixed cameras passed through
    bit for bit, and the same bits on a second call."""
    red, fixed, g = _reduced(rng, case, monkeypatch)
    assert red.by_pt.table is not None and red.by_cam.table is not None
    if case == "long_track":
        assert red.by_pt.table.shape[1] == red.Hcc_d.shape[0]
    if case == "padded_slots":
        assert bool((red.by_pt.table == red.blocks.AtB.shape[0]).any())
    cg = PCG(red, fixed, 100, 1e-5, 0.0)
    assert cg.keyed is not None
    for _ in range(3):
        x = torch.randn(red.Hcc_d.shape[:2], generator=g)
        want, _ = _products_s_mv(cg, (x, cg.b[1]))
        got = smv.schur_mv(*cg.keyed, x)
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
        assert torch.equal(got[fixed], x[fixed])
        assert torch.equal(smv.schur_mv(*cg.keyed, x), got)


def test_plain_follows_the_kernels_order():
    """The plain version's camera sums add each lane's slots in order and
    the lanes' partials by halving: one camera's 3 x CAM_THREADS terms of
    spread magnitudes sum to the tree's float32 sum, which differs from
    their sum in row order."""
    K, T = 1, smv.CAM_THREADS
    O = 3 * T
    g = torch.Generator().manual_seed(5)
    vals = torch.randn(O, generator=g) * 2.0 ** torch.randint(-8, 9, (O,), generator=g)
    AtB = torch.zeros(O, 9, 3)
    AtB[:, 0, 0] = vals
    obs_cam = torch.zeros(O, dtype=torch.long)
    obs_pt = torch.arange(O)
    pt_table = torch.arange(O)[:, None]
    cam_table = torch.arange(O)[None, :]
    Hpp_inv = torch.eye(3).expand(O, 3, 3).contiguous()
    Hcc_d = torch.zeros(K, 9, 9)
    x = torch.zeros(K, 9)
    x[0, 0] = 1.0
    y = smv.schur_mv(AtB, obs_cam, obs_pt, pt_table, cam_table, Hpp_inv, Hcc_d,
                     torch.ones(K), x)
    w = vals * vals                       # each observation's term of y_00, negated
    lanes = w.view(3, T)
    part = (lanes[0] + lanes[1]) + lanes[2]
    while part.numel() > 1:
        part = part[:part.numel() // 2] + part[part.numel() // 2:]
    assert torch.equal(y[0, 0], -part[0])
    in_order = torch.zeros(())
    for t in w:
        in_order = in_order + t
    assert not torch.equal(y[0, 0], -in_order)


@pytest.mark.parametrize("case", ["keyed", "one_hot", "point_sorted", "bordered"])
def test_pcg_takes_the_kernels_only_over_keyed_tables(rng, case, monkeypatch):
    """PCG.s_mv calls ops/schur_mv.schur_mv exactly where both sums are
    keyed tables and there is no border; the one-hot, sorted-point and
    bordered operators give the products' bits."""
    calls = []

    def spy(*args):
        calls.append(args)
        return smv.schur_mv(*args)

    red, fixed, g = _reduced(rng, "mixed", None if case == "one_hot" else monkeypatch,
                             global_block=case == "bordered",
                             point_sorted=case == "point_sorted")
    monkeypatch.setattr(schur_core, "schur_mv", spy)
    cg = PCG(red, fixed, 100, 1e-5, 0.0)
    x = (torch.randn(red.Hcc_d.shape[:2], generator=g),
         torch.randn(cg.b[1].shape, generator=g))
    got = cg.s_mv(x)
    want = _products_s_mv(cg, x)
    if case == "keyed":
        assert len(calls) == 1 and got[1] is x[1]
        assert float((got[0] - want[0]).abs().max()) <= 1e-6 * float(want[0].abs().max())
    else:
        assert not calls and cg.keyed is None
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["mixed", "long_track"])
def test_camera_solve_through_the_kernels_order(rng, case, monkeypatch):
    """_solve_schur(method="pcg") on a generic-path problem: the same
    camera step within 1e-5 of its scale and the same CG iterations as
    with the products."""
    red, fixed, _ = _reduced(rng, case, monkeypatch)
    kw = dict(method="pcg", d_max=None, jacobi=True, cg_iters=100, cg_tol=1e-5, q_eta=0.0,
              point_sorted=False)
    dc, _, _, n = _solve_schur(red.blocks, torch.tensor(1e-3), fixed, **kw)
    monkeypatch.setattr(PCG, "s_mv", _products_s_mv)
    dc0, _, _, n0 = _solve_schur(red.blocks, torch.tensor(1e-3), fixed, **kw)
    assert n == n0 > 1
    assert float((dc - dc0).abs().max()) <= 1e-5 * float(dc0.abs().max())
    assert float(dc[fixed].abs().max()) == 0.0


def test_bound_counts_the_operators_tensors(rng, monkeypatch):
    """tools/bounds.schur_mv's bytes are the operator's inputs read once and
    y written once at this call's table widths; the two passes move the
    coupling blocks once more and v [P, 3] out and back."""
    from dr3_tpu_torch.tools import bounds

    red, fixed, g = _reduced(rng, "mixed", monkeypatch)
    args = PCG(red, fixed, 100, 1e-5, 0.0).keyed
    x = torch.randn(red.Hcc_d.shape[:2], generator=g)
    y = smv.schur_mv(*args, x)
    (O, _, _), (P, d_pt), (K, d_cam) = args[0].shape, args[3].shape, args[4].shape
    b = bounds.schur_mv(K, P, O, d_pt, d_cam)
    n = sum(t.nbytes for t in (*args, x, y))
    assert b["bytes"] == n and b["bound_by"] == "bytes"
    assert b["two_pass_bytes"] == n + args[0].nbytes + 2 * 3 * 4 * P
