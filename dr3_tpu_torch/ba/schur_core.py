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
read once to the host when the table is built, or given by a caller who
knows it from the problem's shape: the window BA passes min(K, O), so it
reads nothing) and sum over d: three launches a sum, so the CG loop's point
sum costs about what a scatter-add did. With ``point_sorted=True`` they are
the JAX package's compensated prefix scan :func:`sorted_segment_sum`
instead, as there.

The pcg solve is :class:`PCG`, one iteration a step over a state dict and
an int32 exit flag: :func:`_pcg` drives it from the host (one read of the
flag per iteration); the VO's loop program runs the same steps under a CUDA
graph WHILE node (pipelines/vo.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dr3_tpu_torch.geometry.linalg import (_chol_factor_small, _chol_inverse_factored,
                                           _chol_solve_factored, chol3, inv3x3)
from dr3_tpu_torch.ops.schur_mv import schur_mv
from dr3_tpu_torch.utils.timing import span


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
# table instead of the membership matrix (as the JAX package's 256M limit),
# and snavely's auto leaves its fast paths for the generic core
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


def _table_reducer(keys: torch.Tensor, num_segments: int, active=None,
                   width: int | None = None):
    """by_key(terms [O, ...]) -> [num_segments, ...]: the sum of the
    ``active`` rows sharing a key (inactive rows carry zero terms), as a
    gather into the [num_segments, d] table of their row ids, rows in index
    order, and a sum over it. d is ``width`` when the caller knows from the
    problem's shape that no key holds more rows (no host read, a fixed
    shape: the window BA in a CUDA graph); else the largest count, read to
    the host once, here. The table is kept as ``by_key.table`` (None where
    d is 0)."""
    keys = keys.long()
    if active is None:
        active = torch.ones_like(keys, dtype=torch.bool)
    if width is None:
        counts = torch.bincount(torch.where(active, keys, torch.full_like(keys, num_segments)),
                                minlength=num_segments + 1)
        d = int(counts[:num_segments].max()) if num_segments else 0
    else:
        d = width if num_segments else 0
    tbl = group_by_point(keys, active, num_segments, d) if d else None

    def by_key(terms):
        if tbl is None:
            return terms.new_zeros((num_segments,) + terms.shape[1:])
        flat = terms.reshape(terms.shape[0], -1)
        padded = torch.cat([flat, torch.zeros_like(flat[:1])])
        return padded[tbl].sum(dim=1).reshape((num_segments,) + terms.shape[1:])
    by_key.table = tbl
    return by_key


def _point_reducer(obs_pt, n_points: int, active, point_sorted: bool,
                   width: int | None = None):
    if point_sorted:
        return _sorted_reducer(obs_pt, n_points, is_sorted=True)
    return _table_reducer(obs_pt, n_points, active, width)


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
    return _assemble_blocks(r, Jc, Jp, obs_cam, obs_pt, active, n_cams, n_points, Jg,
                            cam_onehot, point_sorted)


def _assemble_blocks(r, Jc, Jp, obs_cam, obs_pt, active, n_cams: int, n_points: int,
                     Jg=None, cam_onehot=None, point_sorted: bool = False,
                     pt_width: int | None = None) -> SchurBlocks:
    """:func:`assemble_blocks` with ``pt_width``, the most observations a
    point can have (:func:`_table_reducer`'s width: no host read)."""
    oc = obs_cam.clamp(0, n_cams - 1).long()
    op = obs_pt.clamp(0, n_points - 1).long()
    by_pt = _point_reducer(op, n_points, active, point_sorted, pt_width)
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


def _pair_reducer(obs_cam, obs_pt, active, n_cams: int, n_points: int,
                  width: int | None = None):
    """The per-(point, camera) sum of the active rows, keys in int64, by
    the keyed table; ``width`` is the most rows one key can hold, when the
    caller knows it (no host read: :func:`_table_reducer`)."""
    return _table_reducer(obs_pt.long() * n_cams + obs_cam.long(), n_points * n_cams,
                          active, width)


def _explicit_s_corr_sqrt(Hpp_inv, AtB, obs_pt, n_cams: int, n_points: int, by_key):
    """W Hpp^-1 W^T as Z^T Z: with Hpp^-1_p = L_p L_p^T, the (point,
    camera) block of Z [3P, CK] is L_p^T sum_o AtB_o^T over the point's
    observations by that camera (duplicates add, padding rows add zeros),
    summed per (point, camera) key in a fixed order by ``by_key`` (a
    reducer over those keys: :func:`_pair_reducer`, or the distributed
    BA's per shard)."""
    O, C, _ = AtB.shape
    Lo = chol3(Hpp_inv)[obs_pt]                            # [O, 3, 3] lower
    zupd = torch.einsum("ojr,ocj->orc", Lo, AtB)           # [O, 3, C]
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


def _explicit_s_corr_dense(WHinv, AtB, active, n_cams: int, n_points: int, by_key):
    """W Hpp^-1 W^T as one product of dense per-(point, camera) tables
    U, V [P, K, C, 3], each summed per key in a fixed order by ``by_key``
    (:func:`_pair_reducer`)."""
    C = AtB.shape[-2]
    w = active.to(WHinv.dtype)[:, None, None]
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


class Reduced(NamedTuple):
    """The damped reduced system of one Schur solve before the camera step:
    what the dense solves, CG and the point back-substitution read."""
    blocks: SchurBlocks
    by_pt: object
    by_cam: object
    to_obs: object
    Hcc_d: torch.Tensor
    Hpp_inv: torch.Tensor
    WHinv: torch.Tensor
    rhs_c: torch.Tensor
    keep: torch.Tensor
    Wg: Optional[torch.Tensor]
    border: Optional[tuple]        # (S_gg, S_gc, rhs_g) with a global block


def reduce_system(blocks: SchurBlocks, lam, cam_fixed, *, point_sorted: bool = False,
                  cam_onehot=None, pt_width: int | None = None) -> Reduced:
    """Damp both diagonals, invert the point blocks and form the reduced
    right-hand side (and the global block's border, with one)."""
    K = blocks.Hcc.shape[0]
    P = blocks.Hpp.shape[0]
    oc, op = blocks.obs_cam, blocks.obs_pt
    by_pt = _point_reducer(op, P, blocks.active, point_sorted, pt_width)
    by_cam, to_obs = _camera_reducer(oc, K, cam_onehot)
    Hpp_d = _damp(blocks.Hpp, lam)
    Hcc_d = _damp(blocks.Hcc, lam)
    Hpp_inv = inv3x3(Hpp_d)
    WHinv = torch.einsum("ocj,ojl->ocl", blocks.AtB, Hpp_inv[op])   # [O, C, 3]
    rhs_c = blocks.bc - by_cam(torch.einsum("ocl,ol->oc", WHinv, blocks.bp[op]))
    keep = (~cam_fixed).to(blocks.Hcc.dtype)
    Wg = border = None
    if blocks.Hgg is not None:
        Hgg_d = _damp(blocks.Hgg, lam)
        Wg = by_pt(blocks.GtB)                                   # [P, G, 3]
        WgHinv = torch.einsum("pgj,pjl->pgl", Wg, Hpp_inv)       # [P, G, 3]
        S_gg = Hgg_d - torch.einsum("pgl,phl->gh", WgHinv, Wg)
        S_gc = blocks.Hgc - by_cam(torch.einsum("ogl,ocl->ogc", WgHinv[op],
                                                blocks.AtB))     # [K, G, C]
        rhs_g = blocks.bg - torch.einsum("pgl,pl->g", WgHinv, blocks.bp)
        border = (S_gg, S_gc, rhs_g)
    return Reduced(blocks, by_pt, by_cam, to_obs, Hcc_d, Hpp_inv, WHinv, rhs_c, keep,
                   Wg, border)


def back_substitute(red: Reduced, dc, dg):
    """The point step dp = Hpp^-1 (bp - W^T dc - Wg^T dg)."""
    b = red.blocks
    u = red.by_pt(torch.einsum("ocj,oc->oj", b.AtB, dc[b.obs_cam]))
    if red.Wg is not None:
        u = u + torch.einsum("pgj,g->pj", red.Wg, dg)
    return torch.einsum("pij,pj->pi", red.Hpp_inv, b.bp - u)


def _solve_schur(blocks: SchurBlocks, lam, cam_fixed, *, method, d_max, jacobi,
                 cg_iters, cg_tol, q_eta, point_sorted, cam_onehot=None,
                 pt_width=None):
    """:func:`solve_schur`, also returning the number of CG iterations run
    (0 for the dense solves); here each CG iteration costs one host read,
    the loop's exit test (:class:`PCG` runs the same iterations without)."""
    if method not in ("explicit", "zexplicit", "pcg"):
        raise ValueError(f"unknown schur method {method!r}")
    with span("ba.reduce"):
        red = reduce_system(blocks, lam, cam_fixed, point_sorted=point_sorted,
                            cam_onehot=cam_onehot, pt_width=pt_width)
    if method == "pcg":
        dc, dg, n_cg = _pcg(red, cam_fixed, cg_iters, cg_tol, q_eta)
    else:
        dc, dg = dense_camera_solve(red, method, d_max, jacobi)
        n_cg = 0
    with span("ba.back_substitute"):
        return dc, back_substitute(red, dc, dg), dg, n_cg


def dense_camera_solve(red: Reduced, method: str, d_max, jacobi: bool,
                       pair_width: int | None = None):
    """The exact camera step of ``method`` (explicit / zexplicit): (dc, dg
    or None). ``pair_width``: the most observations one (point, camera)
    pair can have, when the caller knows it from the problem (the VO
    window: 1), so the dense tables read nothing to the host; by default
    it is read once, here."""
    b = red.blocks
    K, C = b.Hcc.shape[0], b.Hcc.shape[-1]
    P = b.Hpp.shape[0]
    oc, op = b.obs_cam, b.obs_pt
    dense_ok = P * K * C * 3 <= _DENSE_W_MAX_ELEMS
    by_key = _pair_reducer(oc, op, b.active, K, P, pair_width) if dense_ok else None
    if method == "zexplicit" and dense_ok:
        S_corr = _explicit_s_corr_sqrt(red.Hpp_inv, b.AtB, op, K, P, by_key)
    elif dense_ok:
        S_corr = _explicit_s_corr_dense(red.WHinv, b.AtB, b.active, K, P, by_key)
    else:
        tbl = group_by_point(op, b.active, P, K if d_max is None else d_max)
        S_corr = _explicit_s_corr(_pad_obs(red.WHinv), _pad_obs(b.AtB), _pad_obs(oc), tbl, K)
    rhs = red.rhs_c.reshape(K * C)
    keep_v = red.keep.repeat_interleave(C)
    border = None
    if red.border is not None:
        S_gg, S_gc, rhs_g = red.border
        G = S_gg.shape[0]
        border = (S_gc.permute(1, 0, 2).reshape(G, K * C), S_gg)
        rhs = torch.cat([rhs, rhs_g])
        keep_v = torch.cat([keep_v, torch.ones((G,), dtype=red.keep.dtype,
                                               device=red.keep.device)])
    x = _dense_camera_step(S_corr, red.Hcc_d, rhs, keep_v, jacobi, border)
    return x[:K * C].reshape(K, C), (x[K * C:] if border is not None else None)


class PCG:
    """Preconditioned CG on the (bordered) reduced system as steps over a
    state dict: :meth:`start` writes the initial state into ``S`` (a
    :class:`dr3_tpu_torch.utils.cudagraph.Slots`), :meth:`step` runs one
    iteration. ``S["cg_go"]`` (int32) says whether another iteration runs,
    by dr3_tpu/ba/schur_core.py's termination: fewer than ``cg_iters``
    iterations, the residual above ``cg_tol`` (relative) and, when
    ``q_eta`` > 0, no Ceres-style Q-stagnation. A host loop reads it once
    per iteration (:func:`_pcg`); on the card a CUDA graph WHILE node reads
    it (pipelines/vo.py's loop program). Block-Jacobi (SCHUR_JACOBI,
    reference src/optimizer.cpp:161) preconditioner; the operator's data
    are read-only attributes. Where both sums are keyed tables and there is
    no global border (past the one-hot's size limit: BAL's generic path),
    the operator S p is :func:`dr3_tpu_torch.ops.schur_mv.schur_mv`, two
    kernels over the tables; otherwise products with the one-hot E, the
    sorted scan or the border, as the VO window BA runs them."""

    def __init__(self, red: Reduced, cam_fixed, cg_iters: int, cg_tol: float,
                 q_eta: float):
        self.red = red
        self.cg_iters, self.cg_tol, self.q_eta = cg_iters, cg_tol, q_eta
        b = red.blocks
        C = red.Hcc_d.shape[-1]
        # the block diagonal of S
        M = red.Hcc_d - red.by_cam(torch.einsum("ocl,odl->ocd", red.WHinv, b.AtB))
        eyeC = torch.eye(C, dtype=M.dtype, device=M.device)
        M = torch.where(cam_fixed[:, None, None], eyeC, M) + 1e-7 * eyeC
        # inverted once here, so that each step applies the preconditioner as
        # one product (eager torch launches every op of an unrolled solve)
        self.M_inv = _chol_inverse_factored(_chol_factor_small(M))
        self.keep_c = red.keep[:, None]
        self.fixed_c = 1.0 - self.keep_c
        pt_tbl = getattr(red.by_pt, "table", None)
        cam_tbl = getattr(red.by_cam, "table", None)
        self.keyed = None
        if pt_tbl is not None and cam_tbl is not None and red.border is None:
            self.keyed = (b.AtB.contiguous(), b.obs_cam, b.obs_pt, pt_tbl, cam_tbl,
                          red.Hpp_inv.contiguous(), red.Hcc_d.contiguous(),
                          red.keep.contiguous())
        if red.border is not None:
            S_gg, self.S_gc, rhs_g = red.border
            G = S_gg.shape[0]
            self.S_gg = S_gg + 1e-7 * torch.eye(G, dtype=S_gg.dtype, device=S_gg.device)
            self.gg_chol = _chol_factor_small(self.S_gg)
        else:
            rhs_g = torch.zeros((0,), dtype=red.rhs_c.dtype, device=red.rhs_c.device)
        self.b = (red.rhs_c * self.keep_c, rhs_g)
        self.bs = self.dot(self.b, self.b)

    def s_mv(self, x):
        red, b = self.red, self.red.blocks
        xc, xg = x
        if self.keyed is not None:
            return schur_mv(*self.keyed, xc.contiguous()), xg
        xk = xc * self.keep_c
        u = red.by_pt(torch.einsum("ocj,oc->oj", b.AtB, red.to_obs(xk)))
        v = torch.einsum("pij,pj->pi", red.Hpp_inv, u)
        y = torch.einsum("kcd,kd->kc", red.Hcc_d, xk) - red.by_cam(
            torch.einsum("ocj,oj->oc", b.AtB, v[b.obs_pt]))
        if red.border is not None:
            y = y + torch.einsum("kgc,g->kc", self.S_gc, xg)
            yg = torch.einsum("kgc,kc->g", self.S_gc, xk) + self.S_gg @ xg
        else:
            yg = xg
        return y * self.keep_c + xc * self.fixed_c, yg

    def m_inv(self, r):
        rc, rg = r
        zg = _chol_solve_factored(self.gg_chol, rg) if self.red.border is not None else rg
        return torch.einsum("kcd,kd->kc", self.M_inv, rc), zg

    @staticmethod
    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    def _go(self, r, i, q_prev, q_cur):
        go = (self.dot(r, r) > self.cg_tol ** 2 * self.bs) & (i < self.cg_iters)
        if self.q_eta > 0.0:
            go = go & ~((i > 1) & (i * (q_prev - q_cur) <= self.q_eta * q_cur.abs()))
        return go.to(torch.int32)

    def start(self, S) -> None:
        x = (torch.zeros_like(self.b[0]), torch.zeros_like(self.b[1]))
        r = self.b
        z = self.m_inv(r)
        zero = torch.zeros_like(self.bs)
        i = torch.zeros((), dtype=torch.int32, device=zero.device)
        for k, v in (("cg_x", x), ("cg_r", r), ("cg_p", z), ("cg_rz", self.dot(r, z)),
                     ("cg_q_prev", zero), ("cg_q_cur", zero), ("cg_i", i),
                     ("cg_go", self._go(r, i, zero, zero))):
            S.put(k, v)

    def step(self, S) -> None:
        x, r, p, rz = S["cg_x"], S["cg_r"], S["cg_p"], S["cg_rz"]
        Ap = self.s_mv(p)
        alpha = rz / torch.clamp(self.dot(p, Ap), min=1e-30)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * ai for ri, ai in zip(r, Ap))
        z = self.m_inv(r)
        rz_new = self.dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        q_prev, q_cur = S["cg_q_cur"], -0.5 * (self.dot(x, self.b) + self.dot(x, r))
        i = S["cg_i"] + 1
        for k, v in (("cg_x", x), ("cg_r", r), ("cg_p", p), ("cg_rz", rz_new),
                     ("cg_q_prev", q_prev), ("cg_q_cur", q_cur), ("cg_i", i),
                     ("cg_go", self._go(r, i, q_prev, q_cur))):
            S.put(k, v)

    def solution(self, S):
        """(dc, dg or None) from the state."""
        x = S["cg_x"]
        return x[0], (x[1] if self.red.border is not None else None)


def _pcg(red: Reduced, cam_fixed, cg_iters, cg_tol, q_eta):
    """:class:`PCG` run to its end by the host, one read of the exit flag
    per iteration; returns (dc, dg or None, iterations run). The spans are
    the host loop's: :meth:`PCG.step` itself has none (the VO's loop
    program captures it)."""
    from dr3_tpu_torch.utils.cudagraph import Slots

    with span("ba.cg_setup"):
        cg = PCG(red, cam_fixed, cg_iters, cg_tol, q_eta)
        S = Slots()
        cg.start(S)
    n = 0
    while True:
        with span("ba.cg_read"):
            go = bool(S["cg_go"])            # the loop's one host read
        if not go:
            break
        with span("ba.cg_step"):
            cg.step(S)
        n += 1
    dc, dg = cg.solution(S)
    return dc, dg, n
