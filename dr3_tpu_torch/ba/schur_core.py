"""Observation-keyed Schur-complement solver core (port of
dr3_tpu.ba.schur_core).

The reduced camera system of bundle adjustment is

    S dc = rhs,   S = Hcc - W Hpp^-1 W^T,

with one [C, 3] coupling block per observation; W is never formed. Three
solves, as in the JAX package:

* ``explicit`` — the exact dense S and its Cholesky. The correction
  W Hpp^-1 W^T is one matrix product of dense per-(point, camera) tables
  when their [P, K, C, 3] fits under ``_DENSE_W_MAX_ELEMS``, else a loop
  over a ``[P, d_max]`` table of observation pairs sharing a point;
* ``zexplicit`` — the same exact S through a square-root factorization:
  with Hpp^-1 = L L^T per point the correction is Z^T Z for a [3P, CK] Z
  (falls back to the pair table past the same size guard, unlike the
  JAX package, whose zexplicit has no guard and builds its scatter index in
  int32);
* ``pcg`` — matrix-free preconditioned conjugate gradients on S with the
  block-Jacobi (SCHUR_JACOBI, reference src/optimizer.cpp:161)
  preconditioner.

An optional global block g (G = 4: the shared fx, fy, cx, cy the reference
optimizes in global BA, src/optimizer.cpp:144-153) is eliminated jointly
with the cameras in every solve: the dense system is bordered by it, and
CG runs on the same bordered operator.

Every sum is taken in a fixed order, so a solve gives the same bits from
run to run on the card; no ``index_add_`` (float atomics on CUDA) is left.
Camera-keyed sums are products with the exact 0/1 membership matrix E.
Point-keyed (and point-and-camera-keyed) sums gather the active rows into
a [keys, d] table of row ids (:func:`group_by_point`, d the largest count,
read once to the host when the table is built) and sum over d: three
launches a sum, so the CG loop's point sum costs about what a scatter-add
did. With ``point_sorted=True`` they are the JAX package's compensated
prefix scan :func:`sorted_segment_sum` instead, as there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dr3_tpu_torch.geometry.linalg import (_chol_factor_small,
                                           _chol_solve_factored, chol3, inv3x3)


class SchurBlocks(NamedTuple):
    """Normal-equation blocks, observation-keyed (no dense W anywhere)."""

    Hcc: torch.Tensor       # [K, C, C] camera diagonal blocks
    bc: torch.Tensor        # [K, C]
    Hpp: torch.Tensor       # [P, 3, 3] point diagonal blocks
    bp: torch.Tensor        # [P, 3]
    AtB: torch.Tensor       # [O, C, 3] per-observation coupling blocks
    obs_cam: torch.Tensor   # [O] int64 (clamped to [0, K))
    obs_pt: torch.Tensor    # [O] int64 (clamped to [0, P))
    active: torch.Tensor    # [O] bool — False rows are padding
    Hgg: Optional[torch.Tensor] = None   # [G, G] global block
    Hgc: Optional[torch.Tensor] = None   # [K, G, C] global-camera coupling
    bg: Optional[torch.Tensor] = None    # [G]
    GtB: Optional[torch.Tensor] = None   # [O, G, 3] global-point coupling


# above this many [O, K] one-hot entries camera sums go through the keyed
# scan instead of the membership matrix (as the JAX package's 256M limit)
_ONEHOT_MAX_ELEMS = 256 * 1024 * 1024


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (in the absence of overflow)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _comp_add(x, y):
    """Compensated (hi, lo) pair addition — the scan's combiner."""
    h1, l1 = x
    h2, l2 = y
    s, e = _two_sum(h1, h2)
    return _two_sum(s, l1 + l2 + e)


def _inclusive_scan(flat: torch.Tensor):
    """Inclusive compensated prefix sum of [O, F] along axis 0: a
    Hillis-Steele scan, log2(O) steps of elementwise ops in a fixed order
    (the JAX package uses ``associative_scan``; the pair arithmetic makes
    either order exact to ~48 bits)."""
    hi, lo = flat, torch.zeros_like(flat)
    k, n = 1, flat.shape[0]
    while k < n:
        s_hi, s_lo = _comp_add((hi[:-k], lo[:-k]), (hi[k:], lo[k:]))
        hi = torch.cat([hi[:k], s_hi])
        lo = torch.cat([lo[:k], s_lo])
        k *= 2
    return hi, lo


def segment_boundaries(seg_ids_sorted: torch.Tensor, num_segments: int):
    """(starts, ends) [S] row ranges of each segment in a SORTED id array."""
    ids = seg_ids_sorted.long().contiguous()
    q = torch.arange(num_segments, dtype=ids.dtype, device=ids.device)
    return (torch.searchsorted(ids, q, side="left"),
            torch.searchsorted(ids, q, side="right"))


def sorted_segment_sum(terms: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, *, starts=None, ends=None):
    """``segment_sum`` for terms already SORTED by segment id, as a
    compensated prefix scan and a boundary difference in pair arithmetic:
    each segment's sum is accurate to about f32 eps of its own magnitude,
    and the order of every addition is fixed (no float atomics).
    ``starts``/``ends`` (from :func:`segment_boundaries`) are index data a
    caller with an iteration loop computes once."""
    O = terms.shape[0]
    flat = terms.reshape(O, -1)
    hi, lo = _inclusive_scan(flat)
    zhi = torch.cat([torch.zeros_like(hi[:1]), hi])
    zlo = torch.cat([torch.zeros_like(lo[:1]), lo])
    if starts is None:
        starts, ends = segment_boundaries(seg_ids, num_segments)
    d_hi, d_err = _two_sum(zhi[ends], -zhi[starts])
    out = d_hi + (d_err + (zlo[ends] - zlo[starts]))
    return out.reshape((num_segments,) + terms.shape[1:])


def _sorted_reducer(keys: torch.Tensor, num_segments: int, is_sorted: bool = False):
    """by_key(terms [O, ...]) -> [num_segments, ...]: the sum of the rows
    sharing a key by the compensated scan. The sort (when ``keys`` is not
    sorted) and the segment boundaries are computed once, here."""
    keys = keys.long()
    order = None
    if not is_sorted:
        order = torch.argsort(keys, stable=True)
        keys = keys[order]
    starts, ends = segment_boundaries(keys, num_segments)

    def by_key(terms):
        if order is not None:
            terms = terms[order]
        return sorted_segment_sum(terms, keys, num_segments, starts=starts, ends=ends)
    return by_key


def _table_reducer(keys: torch.Tensor, num_segments: int, active=None):
    """by_key(terms [O, ...]) -> [num_segments, ...]: the sum of the
    ``active`` rows sharing a key (inactive rows carry zero terms), as a
    gather into the [num_segments, d] table of their row ids, rows in index
    order, and a sum over it. d, the largest count, is read to the host
    once, here."""
    keys = keys.long()
    if active is None:
        active = torch.ones_like(keys, dtype=torch.bool)
    counts = torch.bincount(torch.where(active, keys, torch.full_like(keys, num_segments)),
                            minlength=num_segments + 1)
    d = int(counts[:num_segments].max()) if num_segments else 0
    tbl = group_by_point(keys, active, num_segments, d) if d else None

    def by_key(terms):
        if tbl is None:
            return terms.new_zeros((num_segments,) + terms.shape[1:])
        flat = terms.reshape(terms.shape[0], -1)
        padded = torch.cat([flat, torch.zeros_like(flat[:1])])
        return padded[tbl].sum(dim=1).reshape((num_segments,) + terms.shape[1:])
    return by_key


def _point_reducer(obs_pt, n_points: int, active, point_sorted: bool):
    if point_sorted:
        return _sorted_reducer(obs_pt, n_points, is_sorted=True)
    return _table_reducer(obs_pt, n_points, active)


def cam_onehot_matrix(obs_cam: torch.Tensor, n_cams: int,
                      dtype=torch.float32) -> torch.Tensor:
    """[O, K] exact 0/1 camera-membership matrix."""
    oc = obs_cam.clamp(0, n_cams - 1).long()
    return (oc[:, None] == torch.arange(n_cams, device=oc.device)[None, :]).to(dtype)


def _camera_reducer(obs_cam: torch.Tensor, n_cams: int, E=None):
    """(by_cam, to_obs): per-camera sums [O, ...] -> [K, ...] and the
    broadcast [K, C] -> [O, C], as products with the 0/1 matrix E (exact,
    fixed order), or by the keyed table and a gather past the one-hot's
    size limit."""
    O = obs_cam.shape[0]
    if E is None and O * n_cams <= _ONEHOT_MAX_ELEMS:
        E = cam_onehot_matrix(obs_cam, n_cams)
    if E is None:
        return _table_reducer(obs_cam, n_cams), lambda per_cam: per_cam[obs_cam]

    def by_cam(terms):
        flat = terms.reshape(terms.shape[0], -1)
        return (E.T @ flat.to(E.dtype)).reshape((n_cams,) + terms.shape[1:])
    return by_cam, lambda per_cam: E @ per_cam


def assemble_blocks(r, Jc, Jp, obs_cam, obs_pt, active, n_cams: int,
                    n_points: int, Jg=None, cam_onehot=None,
                    point_sorted: bool = False) -> SchurBlocks:
    """One pass over the observation table -> all normal-equation blocks.

    r [O, 2], Jc [O, 2, C], Jp [O, 2, 3] (and Jg [O, 2, G]) already carry
    the robust / validity weights (zero rows for padding), as produced by
    :func:`dr3_tpu_torch.ba.problem.linearize`. ``cam_onehot`` (from
    :func:`cam_onehot_matrix`) is the camera membership matrix, built once
    by callers with an LM loop. ``point_sorted``: the table is sorted by
    point id; the point sums are then the compensated scan."""
    oc = obs_cam.clamp(0, n_cams - 1).long()
    op = obs_pt.clamp(0, n_points - 1).long()
    by_pt = _point_reducer(op, n_points, active, point_sorted)
    by_cam, _ = _camera_reducer(oc, n_cams, cam_onehot)
    AtA = torch.einsum("oij,oik->ojk", Jc, Jc)
    BtB = torch.einsum("oij,oik->ojk", Jp, Jp)
    AtB = torch.einsum("oij,oik->ojk", Jc, Jp)
    Atr = torch.einsum("oij,oi->oj", Jc, r)
    Btr = torch.einsum("oij,oi->oj", Jp, r)
    Hgg = Hgc = bg = GtB = None
    if Jg is not None:
        Hgg = torch.einsum("oij,oik->jk", Jg, Jg)
        Hgc = by_cam(torch.einsum("oij,oik->ojk", Jg, Jc))       # [K, G, C]
        bg = -torch.einsum("oij,oi->j", Jg, r)
        GtB = torch.einsum("oij,oik->ojk", Jg, Jp)                # [O, G, 3]
    return SchurBlocks(Hcc=by_cam(AtA), bc=-by_cam(Atr), Hpp=by_pt(BtB),
                       bp=-by_pt(Btr), AtB=AtB, obs_cam=oc, obs_pt=op,
                       active=active, Hgg=Hgg, Hgc=Hgc, bg=bg, GtB=GtB)


def group_by_point(obs_pt, active, n_points: int, d_max: int) -> torch.Tensor:
    """[P, d_max] table of observation indices per point (pad value = O).
    Observations are ranked within their point by a stable sort (inactive
    rows sort to a scratch bucket); those beyond ``d_max`` per point are
    left out of the pair assembly only."""
    O = obs_pt.shape[0]
    dev = obs_pt.device
    eff = torch.where(active, obs_pt.long(), torch.full_like(obs_pt.long(), n_points))
    order = torch.argsort(eff, stable=True)
    sorted_pt = eff[order].contiguous()
    first = torch.searchsorted(sorted_pt, sorted_pt, side="left")
    rank = torch.arange(O, device=dev) - first
    ok = (sorted_pt < n_points) & (rank < d_max)
    rows = torch.where(ok, sorted_pt, torch.full_like(sorted_pt, n_points))
    cols = torch.where(ok, rank, torch.zeros_like(rank))
    tbl = torch.full((n_points + 1, d_max), O, dtype=torch.int64, device=dev)
    # only the scratch row n_points takes several writes; it is cut off
    tbl[rows, cols] = order
    return tbl[:n_points]


def _damp(H, lam, floor=1e-8):
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + eye * (lam * diag + floor)[..., None, :]


def _explicit_s_corr(WHinv_pad, AtB_pad, cam_pad, pt_table, n_cams: int):
    """sum over observation pairs sharing a point of WHinv_(o1) AtB_(o2)^T
    into S[cam_o1, cam_o2] — the W Hpp^-1 W^T correction without forming
    W. ``*_pad`` have one extra zero row at index O (the table's pad)."""
    P, D = pt_table.shape
    C = AtB_pad.shape[-2]
    Wp = AtB_pad[pt_table]          # [P, D, C, 3]
    WHp = WHinv_pad[pt_table]       # [P, D, C, 3]
    cams_p = cam_pad[pt_table]      # [P, D] (pad rows -> cam 0, contrib 0)
    s_flat = torch.zeros((n_cams * n_cams, C, C), dtype=AtB_pad.dtype,
                         device=AtB_pad.device)
    for d1 in range(D):
        contrib = torch.einsum("pij,pdkj->pdik", WHp[:, d1], Wp)   # [P, D, C, C]
        keys = (cams_p[:, d1, None] * n_cams + cams_p).reshape(-1)
        s_flat = s_flat + _sorted_reducer(keys, n_cams * n_cams)(
            contrib.reshape(-1, C, C))
    return s_flat.reshape(n_cams, n_cams, C, C).permute(0, 2, 1, 3)


def _explicit_s_corr_sqrt(Hpp_inv, AtB, obs_cam, obs_pt, active, n_cams: int,
                          n_points: int, by_key=None):
    """W Hpp^-1 W^T as Z^T Z: with Hpp^-1_p = L_p L_p^T, the (point,
    camera) block of Z [3P, CK] is L_p^T sum_o AtB_o^T over the point's
    observations by that camera (duplicates add, padding rows add zeros).
    The active rows' blocks are summed per (point, camera) key in a fixed
    order, keys in int64: by the keyed table, or by ``by_key`` (a reducer
    over those keys built once by a caller with an LM loop)."""
    O, C, _ = AtB.shape
    Lo = chol3(Hpp_inv)[obs_pt]                            # [O, 3, 3] lower
    zupd = torch.einsum("ojr,ocj->orc", Lo, AtB)           # [O, 3, C]
    if by_key is None:
        key = obs_pt.long() * n_cams + obs_cam.long()
        by_key = _table_reducer(key, n_points * n_cams, active)
    Zb = by_key(zupd)                                      # [P*K, 3, C]
    Z = Zb.reshape(n_points, n_cams, 3, C).permute(0, 2, 1, 3) \
        .reshape(3 * n_points, n_cams * C)
    return (Z.T @ Z).reshape(n_cams, C, n_cams, C)


def _pad_obs(x):
    return torch.cat([x, torch.zeros_like(x[:1])], dim=0)


# the dense [P, K, C, 3] tables (explicit) and Z (zexplicit, [3P, CK], the
# same count) are built only under this many float32 elements; larger
# problems take the pair table
_DENSE_W_MAX_ELEMS = 64 * 1024 * 1024


def _explicit_s_corr_dense(WHinv, AtB, obs_cam, obs_pt, active, n_cams: int,
                           n_points: int):
    """W Hpp^-1 W^T as one product of dense per-(point, camera) tables
    U, V [P, K, C, 3], each summed per key in a fixed order."""
    C = AtB.shape[-2]
    w = active.to(WHinv.dtype)[:, None, None]
    by_key = _table_reducer(obs_pt.long() * n_cams + obs_cam.long(), n_points * n_cams,
                            active)
    U = by_key(WHinv * w).reshape(n_points, n_cams, C, 3)
    V = by_key(AtB * w).reshape(n_points, n_cams, C, 3)
    U2 = U.permute(1, 2, 0, 3).reshape(n_cams * C, n_points * 3)
    V2 = V.permute(1, 2, 0, 3).reshape(n_cams * C, n_points * 3)
    return (U2 @ V2.T).reshape(n_cams, C, n_cams, C)


def _dense_camera_step(S_corr, Hcc_d, rhs, keep_v, jacobi: bool, border=None):
    """The dense reduced camera solve: S = blockdiag(Hcc_d) - S_corr
    ([K, C, K, C]), bordered by ``border`` = (S_gc [G, K*C], S_gg [G, G])
    when given, the gauge fix (rows and columns where ``keep_v`` is 0 are
    the identity), Jacobi scaling, + 1e-6 I, Cholesky and both triangular
    solves. ``rhs`` and ``keep_v`` cover the border's rows too. Returns x
    [K*C (+G)]; a failed factorization gives NaN (as jnp.linalg.cholesky
    does), so the LM loop rejects the step; no host read."""
    K, C = Hcc_d.shape[0], Hcc_d.shape[-1]
    S = -S_corr
    kk = torch.arange(K, device=S.device)
    S[kk, :, kk, :] = S[kk, :, kk, :] + Hcc_d
    S = S.reshape(K * C, K * C)
    if border is not None:
        S_gc, S_gg = border
        S = torch.cat([torch.cat([S, S_gc.T], 1), torch.cat([S_gc, S_gg], 1)], 0)
    # gauge fixing: zero rows/cols of fixed cameras, identity diagonal
    S = S * keep_v[:, None] * keep_v[None, :] + torch.diag(1.0 - keep_v)
    rhs = rhs * keep_v
    if jacobi:
        dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
        S = S * dinv[:, None] * dinv[None, :]
        rhs = rhs * dinv
    S = S + 1e-6 * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    return x * dinv if jacobi else x


def solve_schur(blocks: SchurBlocks, lam, cam_fixed, *,
                method: str = "explicit", d_max: int | None = None,
                jacobi: bool = True, cg_iters: int = 100,
                cg_tol: float = 1e-5, q_eta: float = 0.0,
                point_sorted: bool = False):
    """One damped Schur solve -> (dc [K, C], dp [P, 3], dg [G] or None).
    ``point_sorted``: the blocks' observation rows are sorted by point id."""
    dc, dp, dg, _ = _solve_schur(blocks, lam, cam_fixed, method=method, d_max=d_max,
                                 jacobi=jacobi, cg_iters=cg_iters, cg_tol=cg_tol,
                                 q_eta=q_eta, point_sorted=point_sorted)
    return dc, dp, dg


def _solve_schur(blocks: SchurBlocks, lam, cam_fixed, *, method, d_max, jacobi,
                 cg_iters, cg_tol, q_eta, point_sorted, cam_onehot=None):
    """:func:`solve_schur`, also returning the number of CG iterations run
    (0 for the dense solves); each CG iteration costs one host read, the
    loop's exit test."""
    if method not in ("explicit", "zexplicit", "pcg"):
        raise ValueError(f"unknown schur method {method!r}")
    K, C = blocks.Hcc.shape[0], blocks.Hcc.shape[-1]
    P = blocks.Hpp.shape[0]
    oc, op = blocks.obs_cam, blocks.obs_pt
    has_g = blocks.Hgg is not None
    G = blocks.Hgg.shape[0] if has_g else 0
    by_pt = _point_reducer(op, P, blocks.active, point_sorted)
    by_cam, to_obs = _camera_reducer(oc, K, cam_onehot)

    Hpp_d = _damp(blocks.Hpp, lam)
    Hcc_d = _damp(blocks.Hcc, lam)
    Hpp_inv = inv3x3(Hpp_d)
    WHinv = torch.einsum("ocj,ojl->ocl", blocks.AtB, Hpp_inv[op])   # [O, C, 3]
    rhs_c = blocks.bc - by_cam(torch.einsum("ocl,ol->oc", WHinv, blocks.bp[op]))
    keep = (~cam_fixed).to(blocks.Hcc.dtype)

    if has_g:
        Hgg_d = _damp(blocks.Hgg, lam)
        Wg = by_pt(blocks.GtB)                                   # [P, G, 3]
        WgHinv = torch.einsum("pgj,pjl->pgl", Wg, Hpp_inv)       # [P, G, 3]
        S_gg = Hgg_d - torch.einsum("pgl,phl->gh", WgHinv, Wg)
        S_gc = blocks.Hgc - by_cam(torch.einsum("ogl,ocl->ogc", WgHinv[op],
                                                blocks.AtB))     # [K, G, C]
        rhs_g = blocks.bg - torch.einsum("pgl,pl->g", WgHinv, blocks.bp)

    n_cg = 0
    if method in ("explicit", "zexplicit"):
        dense_ok = P * K * C * 3 <= _DENSE_W_MAX_ELEMS
        if method == "zexplicit" and dense_ok:
            S_corr = _explicit_s_corr_sqrt(Hpp_inv, blocks.AtB, oc, op, blocks.active, K, P)
        elif dense_ok:
            S_corr = _explicit_s_corr_dense(WHinv, blocks.AtB, oc, op, blocks.active, K, P)
        else:
            tbl = group_by_point(op, blocks.active, P, K if d_max is None else d_max)
            S_corr = _explicit_s_corr(_pad_obs(WHinv), _pad_obs(blocks.AtB),
                                      _pad_obs(oc), tbl, K)
        rhs = rhs_c.reshape(K * C)
        keep_v = keep.repeat_interleave(C)
        border = None
        if has_g:
            border = (S_gc.permute(1, 0, 2).reshape(G, K * C), S_gg)
            rhs = torch.cat([rhs, rhs_g])
            keep_v = torch.cat([keep_v, torch.ones((G,), dtype=keep.dtype,
                                                   device=keep.device)])
        x = _dense_camera_step(S_corr, Hcc_d, rhs, keep_v, jacobi, border)
        dc = x[:K * C].reshape(K, C)
        dg = x[K * C:] if has_g else None
    else:
        dc, dg, n_cg = _pcg(blocks, Hcc_d, Hpp_inv, WHinv, rhs_c, keep, cam_fixed,
                            by_pt, by_cam, to_obs,
                            (S_gg, S_gc, rhs_g) if has_g else None,
                            cg_iters, cg_tol, q_eta)

    # back-substitute points: dp = Hpp^-1 (bp - W^T dc - Wg^T dg)
    u = by_pt(torch.einsum("ocj,oc->oj", blocks.AtB, dc[oc]))
    if has_g:
        u = u + torch.einsum("pgj,g->pj", Wg, dg)
    dp = torch.einsum("pij,pj->pi", Hpp_inv, blocks.bp - u)
    return dc, dp, dg, n_cg


def _pcg(blocks, Hcc_d, Hpp_inv, WHinv, rhs_c, keep, cam_fixed, by_pt, by_cam,
         to_obs, border, cg_iters, cg_tol, q_eta):
    """Preconditioned CG on the (bordered) reduced system; returns (dc, dg
    or None, iterations run). Termination as dr3_tpu/ba/schur_core.py:
    the residual below ``cg_tol`` (relative), or Ceres-style Q-stagnation
    when ``q_eta`` > 0 — one host read per iteration."""
    C = Hcc_d.shape[-1]
    op = blocks.obs_pt
    # SCHUR_JACOBI preconditioner: the block diagonal of S
    M = Hcc_d - by_cam(torch.einsum("ocl,odl->ocd", WHinv, blocks.AtB))
    eyeC = torch.eye(C, dtype=M.dtype, device=M.device)
    M = torch.where(cam_fixed[:, None, None], eyeC, M) + 1e-7 * eyeC
    M_chol = _chol_factor_small(M)
    keep_c = keep[:, None]
    fixed_c = 1.0 - keep_c
    if border is not None:
        S_gg, S_gc, rhs_g = border
        G = S_gg.shape[0]
        S_gg = S_gg + 1e-7 * torch.eye(G, dtype=S_gg.dtype, device=S_gg.device)
        gg_chol = _chol_factor_small(S_gg)
    else:
        rhs_g = torch.zeros((0,), dtype=rhs_c.dtype, device=rhs_c.device)

    def s_mv(x):
        xc, xg = x
        xk = xc * keep_c
        u = by_pt(torch.einsum("ocj,oc->oj", blocks.AtB, to_obs(xk)))
        v = torch.einsum("pij,pj->pi", Hpp_inv, u)
        y = torch.einsum("kcd,kd->kc", Hcc_d, xk) - by_cam(
            torch.einsum("ocj,oj->oc", blocks.AtB, v[op]))
        if border is not None:
            y = y + torch.einsum("kgc,g->kc", S_gc, xg)
            yg = torch.einsum("kgc,kc->g", S_gc, xk) + S_gg @ xg
        else:
            yg = xg
        return y * keep_c + xc * fixed_c, yg

    def m_inv(r):
        rc, rg = r
        zg = _chol_solve_factored(gg_chol, rg) if border is not None else rg
        return _chol_solve_factored(M_chol, rc), zg

    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    b = (rhs_c * keep_c, rhs_g)
    bs = dot(b, b)
    x = (torch.zeros_like(b[0]), torch.zeros_like(b[1]))
    r = b
    z = m_inv(r)
    p = z
    rz = dot(r, z)
    q_prev = torch.zeros_like(bs)
    q_cur = torch.zeros_like(bs)
    i = 0
    while i < cg_iters:
        go = dot(r, r) > cg_tol ** 2 * bs
        if q_eta > 0.0 and i > 1:
            go = go & ~(i * (q_prev - q_cur) <= q_eta * q_cur.abs())
        if not bool(go):                     # the loop's one host read
            break
        Ap = s_mv(p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * ai for ri, ai in zip(r, Ap))
        z = m_inv(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        rz = rz_new
        q_prev, q_cur = q_cur, -0.5 * (dot(x, b) + dot(x, r))
        i += 1
    return x[0], (x[1] if border is not None else None), i
