"""The reduced camera matrix of BAL bundle adjustment from co-visible 9x9
blocks (the ``zexplicit`` solve of ba/snavely.py).

With Hpp^-1 = L_p L_p^T per point, the Schur correction sum_p W_p Hpp^-1
W_p^T is Z^T Z, where Z [3P, 9K] holds at (point p, camera c) the 3x9
factor G_o = L_p^T Jp_o^T Jc_o of the observation o of p by c and zeros
elsewhere. Only co-visible camera blocks are non-zero: block (i, j) is the
sum over the points seen by both of G_oi^T G_oj. So S is built block by
block from observation pairs, and Z is never formed. Observations are
taken in camera order: row q is observation ``cam_obs[q]``, each camera's
in index order.

* :func:`schur_pairs` — once per solve (observation ids are constant over
  the LM loop): every unordered pair of observations of one point,
  diagonal included, from the point table of ``schur_core._table_reducer``,
  as rows, oriented so that camera(qi) <= camera(qj), sorted stably by
  (camera block, point), with a CSR range per camera block; and the rows of
  each camera. Two observations of one point by one camera make a pair of
  the diagonal block twice, once in each order. Exactly the pairs, so its
  memory follows their count and not the widest track; the count comes
  from :func:`pair_sizes`, which the LM solve reads to the host with the
  table's width, in the solve's one read.
* :func:`schur_factor` — per LM iteration, one launch of
  ``dr3_schur_factor`` (csrc/schur.cu): the damped point inverses Hinv9,
  each camera's column sums of squares of its G_o (Z's column norms) in
  index order and from them dinv = D^-1/2, D = diag S (Hcc_d's diagonal
  less the column norms, floored at 1e-10 of it), and the scaled factors
  Gs [O, 36]: row q is G_o diag dinv_c, as 9 columns of (g0, g1, g2, 0).
* :func:`schur_blocks` — per LM iteration, one launch of
  ``dr3_schur_blocks``: S~ = D^-1/2 (Hcc_d - Z^T Z) D^-1/2 [9K, 9K], each
  block the sum of its pairs in CSR order of Gs_qi^T Gs_qj (the columns
  scaled before the product, so S~ accumulates with O(eps) absolute error:
  scaling after it commits ~|S| eps errors first, which on real-structure
  problems, diag S spread over ~1e14, lost PSD-ness), negated, plus Hcc_d d_i d_i^T on the diagonal, written with its
  mirror.

Each wrapper runs its plain PyTorch version (``_*_plain``, the kernel's
arithmetic and order: no fused multiply-add, each entry summed by one
owner in a fixed order) for a CPU tensor; for a CUDA tensor it launches
the kernel or raises. ``<wrapper>.launches`` counts kernel launches.

Replaces no Pallas kernel: the JAX package's zexplicit leaves a dense Z^T Z
to XLA. The kernels' bound and design are in csrc/schur.cu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr3_tpu_torch.ops import _native


_MAX_PAIRS = 2**31 - 1   # dr3_schur_blocks' int32 pair offsets


class SchurPairs(NamedTuple):
    obs_cam: torch.Tensor   # [O] int32 camera of each observation, in [0, K)
    obs_pt: torch.Tensor    # [O] int32 point, in [0, P)
    cam_ptr: torch.Tensor   # [K + 1] int32: camera c's rows are cam_ptr[c] .. cam_ptr[c + 1]
    cam_obs: torch.Tensor   # [O] int32 observation of each row
    qi: torch.Tensor        # [n] int32 pairs of rows, camera(qi) <= camera(qj),
    qj: torch.Tensor        # [n] int32 by (block, point); block (i, j) is key i K + j
    blk_ptr: torch.Tensor   # [K * K + 1] int32: block key's pairs are qi[blk_ptr[key]:...]


def _ids(obs_cam, obs_pt, n_cams: int, n_points: int):
    """The observations' camera and point ids as int64, clamped into range."""
    return obs_cam.long().clamp(0, n_cams - 1), obs_pt.long().clamp(0, max(n_points - 1, 0))


def _same_camera_rank(oc, op, n_cams: int):
    """([O], order): how many earlier observations (in index order) of its
    point its camera made; the observations sorted stably by (point,
    camera), so those are the ones just before it."""
    O = oc.shape[0]
    key = op * n_cams + oc
    order = torch.argsort(key, stable=True)
    key = key[order]
    pos = torch.arange(O, device=oc.device)
    first = torch.ones(O, dtype=torch.bool, device=oc.device)
    first[1:] = key[1:] != key[:-1]
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    same = torch.empty_like(pos)
    same[order] = pos - start
    return same, order


def pair_sizes(obs_cam: torch.Tensor, obs_pt: torch.Tensor, n_cams: int,
               n_points: int) -> tuple[int, int]:
    """(d, n), read to the host at once: the most observations of one point
    (the width of its ``group_by_point`` table) and the number of pairs
    :func:`schur_pairs` lists, n_p (n_p + 1) / 2 a point seen n_p times and
    once more for each two observations of it by one camera."""
    if obs_cam.shape[0] == 0 or n_points == 0:
        return 0, 0
    oc, op = _ids(obs_cam, obs_pt, n_cams, n_points)
    counts = torch.bincount(op, minlength=n_points)
    n = (counts * (counts + 1) // 2).sum() + _same_camera_rank(oc, op, n_cams)[0].sum()
    d, n = torch.stack([counts.max(), n]).tolist()
    return d, n


def schur_pairs(obs_cam: torch.Tensor, obs_pt: torch.Tensor, table, n_cams: int,
                n_pairs: int | None = None) -> SchurPairs:
    """The pair structure of a problem. ``table`` is the [P, d] point table
    of every observation row (``schur_core.group_by_point``: row ids in index
    order, pad O), or None where no point has an observation; ``n_pairs``
    :func:`pair_sizes`' count, read here when None."""
    K, O = n_cams, obs_cam.shape[0]
    dev = obs_cam.device
    P, d = (0, 0) if table is None else table.shape
    oc, op = _ids(obs_cam, obs_pt, K, P)
    cam_obs = torch.argsort(oc, stable=True)
    cam_ptr = torch.searchsorted(oc[cam_obs], torch.arange(K + 1, device=dev))
    row = torch.empty_like(cam_obs)
    row[cam_obs] = torch.arange(O, device=dev)
    if d == 0:
        none = torch.zeros(0, dtype=torch.int32, device=dev)
        return SchurPairs(oc.int(), op.int(), cam_ptr.int(), cam_obs.int(), none, none,
                          torch.zeros(K * K + 1, dtype=torch.int32, device=dev))
    n = pair_sizes(obs_cam, obs_pt, K, P)[1] if n_pairs is None else n_pairs
    if n > _MAX_PAIRS:
        raise ValueError(f"{n} observation pairs: dr3_schur_blocks' int32 offsets take at "
                         f"most {_MAX_PAIRS}")
    # each observation's rank in its point's row (every row id appears once;
    # the pad O lands in a scratch slot, cut off)
    rank = torch.full((O + 1,), -1, dtype=torch.long, device=dev)
    rank[table.reshape(-1)] = torch.arange(d, device=dev).repeat(P)
    rank = rank[:O]
    same, by_pc = _same_camera_rank(oc, op, K)
    # observation o pairs with its row's entries of rank 0 .. rank(o), itself
    # last, then again, in the other order, with each earlier observation of
    # its point by its camera
    per = rank + 1 + same
    obs = torch.arange(O, device=dev)
    o = torch.repeat_interleave(obs, per, output_size=n)
    t = torch.arange(n, device=dev) - (torch.cumsum(per, 0) - per)[o]
    del per
    at = torch.empty_like(obs)
    at[by_pc] = obs                                   # o's position in by_pc
    again = t > rank[o]
    e = torch.where(again, by_pc[(at[o] - same[o] + t - rank[o] - 1).clamp(0, O - 1)],
                    table[op[o], t.clamp(max=d - 1)])
    del t, at
    co, ce = oc[o], oc[e]
    swap = again | (co > ce)                          # camera(qi) <= camera(qj)
    key = (torch.minimum(co, ce) * K + torch.maximum(co, ce)) * P + op[o]
    del co, ce
    key, order = torch.sort(key, stable=True)
    qi = row[torch.where(swap, e, o)[order]].int()
    qj = row[torch.where(swap, o, e)[order]].int()
    blk_ptr = torch.searchsorted(key // P, torch.arange(K * K + 1, device=dev))
    return SchurPairs(oc.int(), op.int(), cam_ptr.int(), cam_obs.int(), qi, qj, blk_ptr.int())


# ---------------------------------------------------------------------------
# the point inverses, the factors and the Jacobi scaling
# ---------------------------------------------------------------------------

def _inv3x3_flat(h9, lam):
    """Damped inverse of symmetric 3x3 blocks stored as [P, 9] columns
    (adjugate / determinant). Each block is first divided by its max
    |entry|: real-structure Hpp blocks reach ~1e13, whose raw determinant
    overflows float32 to inf - inf = NaN. inv(H) = inv(H/s)/s."""
    a = h9[:, 0] * (1.0 + lam) + 1e-8
    e = h9[:, 4] * (1.0 + lam) + 1e-8
    i = h9[:, 8] * (1.0 + lam) + 1e-8
    b, c, f = h9[:, 1], h9[:, 2], h9[:, 5]
    d, g, h = h9[:, 3], h9[:, 6], h9[:, 7]
    m = torch.stack([a, b, c, d, e, f, g, h, i], dim=-1)
    inv_s = 1.0 / torch.clamp(m.abs().amax(dim=-1), min=1e-30)
    a, b, c, d, e, f, g, h, i = (m * inv_s[:, None]).unbind(-1)
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = inv_s / torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    return torch.stack([A00, A01, A02, A10, A11, A12, A20, A21, A22], dim=-1) \
        * inv_det[:, None]                                               # [P, 9]


def _chol3_flat(h9):
    """Lower Cholesky factor of SPD 3x3 blocks stored flat [P, 9] -> [P, 6]
    columns (l00, l10, l11, l20, l21, l22)."""
    a, b, c = h9[:, 0], h9[:, 1], h9[:, 2]
    e, f, i = h9[:, 4], h9[:, 5], h9[:, 8]
    l00 = torch.sqrt(torch.clamp(a, min=1e-30))
    l10 = b / l00
    l20 = c / l00
    l11 = torch.sqrt(torch.clamp(e - l10 * l10, min=1e-30))
    l21 = (f - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(i - l20 * l20 - l21 * l21, min=1e-30))
    return torch.stack([l00, l10, l11, l20, l21, l22], dim=-1)


def _damp_hcc(Hcc, lam):
    """Hcc + diag(lam * diag Hcc + 1e-8) [K, 9, 9]."""
    eye9 = torch.eye(9, dtype=Hcc.dtype, device=Hcc.device)
    return Hcc + eye9 * (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8)[..., None, :]


def _schur_factor_plain(Hpp9, Hcc, lam, Jcu, Jcv, Jpu, Jpv, pairs: SchurPairs):
    K, O = Hcc.shape[0], Jcu.shape[0]
    Hinv9 = _inv3x3_flat(Hpp9, lam)
    l0, l1, l2, l3, l4, l5 = _chol3_flat(Hinv9)[pairs.obs_pt.long()].unbind(1)

    # a_r = sum_j L[j, r] Jp_j; L's columns (l00, l10, l20), (0, l11, l21),
    # (0, 0, l22)
    def lcols(J):
        return torch.stack([l0 * J[:, 0] + l1 * J[:, 1] + l3 * J[:, 2],
                            l2 * J[:, 1] + l4 * J[:, 2], l5 * J[:, 2]], dim=1)

    au, av = lcols(Jpu), lcols(Jpv)                                         # [O, 3]
    G = Jcu[:, None, :] * au[:, :, None] + Jcv[:, None, :] * av[:, :, None]  # [O, 3, 9]
    sq = G[:, 0] * G[:, 0] + G[:, 1] * G[:, 1] + G[:, 2] * G[:, 2]          # [O, 9]
    oc = pairs.obs_cam.long()
    # index_add_ on the CPU adds in index order: each camera's observations
    colsq = sq.new_zeros((K, 9)).index_add_(0, oc, sq)
    hd = torch.diagonal(_damp_hcc(Hcc, lam), dim1=-2, dim2=-1)
    sdiag = torch.maximum(hd - colsq, 1e-10 * torch.clamp(hd, min=1e-20))
    dinv = 1.0 / torch.sqrt(sdiag)
    rows = G.new_zeros((O, 9, 4))
    rows[:, :, :3] = (G * dinv[oc][:, None, :])[pairs.cam_obs.long()].transpose(1, 2)
    return Hinv9, rows.reshape(O, 36), dinv.reshape(9 * K)


def schur_factor(Hpp9: torch.Tensor, Hcc: torch.Tensor, lam: torch.Tensor,
                 Jcu: torch.Tensor, Jcv: torch.Tensor, Jpu: torch.Tensor,
                 Jpv: torch.Tensor, pairs: SchurPairs):
    """(Hinv9 [P, 9], Gs [O, 36], dinv [9K]) from the undamped blocks Hpp9
    [P, 9] and Hcc [K, 9, 9], the damping ``lam`` (a float32 scalar tensor)
    and the weighted Jacobian columns Jcu, Jcv [O, 9], Jpu, Jpv [O, 3]."""
    if not Jcu.is_cuda:
        return _schur_factor_plain(Hpp9, Hcc, lam, Jcu, Jcv, Jpu, Jpv, pairs)
    dev = Jcu.device
    P, K, O = Hpp9.shape[0], Hcc.shape[0], Jcu.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, t, shape in (("Hpp9", Hpp9, (P, 9)), ("Hcc", Hcc, (K, 9, 9)), ("lam", lam, ()),
                           ("Jcu", Jcu, (O, 9)), ("Jcv", Jcv, (O, 9)), ("Jpu", Jpu, (O, 3)),
                           ("Jpv", Jpv, (O, 3))):
        _native.check(t, name, f32, shape, dev)
    for name, t, shape in (("obs_pt", pairs.obs_pt, (O,)), ("cam_ptr", pairs.cam_ptr, (K + 1,)),
                           ("cam_obs", pairs.cam_obs, (O,))):
        _native.check(t, name, i32, shape, dev)
    Hinv9 = torch.empty((P, 9), dtype=f32, device=dev)
    Gs = torch.empty((O, 36), dtype=f32, device=dev)
    dinv = torch.empty((9 * K,), dtype=f32, device=dev)
    _native.call("dr3_schur_factor", Hpp9, Hcc, lam, Jcu, Jcv, Jpu, Jpv, pairs.obs_pt,
                 pairs.cam_ptr, pairs.cam_obs, K, P, Hinv9, Gs, dinv)
    schur_factor.launches += 1
    return Hinv9, Gs, dinv


schur_factor.launches = 0


# ---------------------------------------------------------------------------
# the blocks of S~
# ---------------------------------------------------------------------------

def _pair_products(g1, g2):
    """[n, 9, 9] sum_r g1[:, r, a] g2[:, r, b] of [n, 3, 9] factors, r in order."""
    return g1[:, 0, :, None] * g2[:, 0, None, :] + g1[:, 1, :, None] * g2[:, 1, None, :] \
        + g1[:, 2, :, None] * g2[:, 2, None, :]


def _schur_blocks_plain(Gs, dinv, Hcc, lam, pairs: SchurPairs):
    K, O = Hcc.shape[0], Gs.shape[0]
    chunk = 1 << 16                        # pairs a pass: [chunk, 9, 9] products at a time
    n = pairs.qi.shape[0]
    cam = pairs.obs_cam.long()[pairs.cam_obs.long()]                   # of each row
    G3 = Gs.view(O, 9, 4)[:, :, :3].transpose(1, 2)                    # [O, 3, 9]
    acc = Gs.new_zeros((K * K, 81))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        qi, qj = pairs.qi[s:e].long(), pairs.qj[s:e].long()
        # index_add_ on the CPU adds in index order: each block's pairs in CSR order
        acc.index_add_(0, cam[qi] * K + cam[qj], _pair_products(G3[qi], G3[qj]).reshape(-1, 81))
    S4 = -acc.view(K, K, 9, 9)
    upper = torch.ones((K, K), dtype=torch.bool, device=Gs.device).triu()[:, :, None, None]
    S4 = torch.where(upper, S4, S4.transpose(0, 1).transpose(2, 3))
    kk = torch.arange(K, device=Gs.device)
    d9 = dinv.view(K, 9)
    S4[kk, kk] = S4[kk, kk] + _damp_hcc(Hcc, lam) * (d9[:, :, None] * d9[:, None, :])
    return S4.permute(0, 2, 1, 3).reshape(9 * K, 9 * K)


def schur_blocks(Gs: torch.Tensor, dinv: torch.Tensor, Hcc: torch.Tensor, lam: torch.Tensor,
                 pairs: SchurPairs) -> torch.Tensor:
    """S~ [9K, 9K] from :func:`schur_factor`'s Gs and dinv, the undamped Hcc
    [K, 9, 9] and the damping ``lam``."""
    if not Gs.is_cuda:
        return _schur_blocks_plain(Gs, dinv, Hcc, lam, pairs)
    dev = Gs.device
    K, O = Hcc.shape[0], Gs.shape[0]
    if K > 65535:
        raise ValueError(f"{K} cameras: dr3_schur_blocks' grid takes at most 65535")
    f32, i32 = torch.float32, torch.int32
    for name, t, shape in (("Gs", Gs, (O, 36)), ("dinv", dinv, (9 * K,)),
                           ("Hcc", Hcc, (K, 9, 9)), ("lam", lam, ())):
        _native.check(t, name, f32, shape, dev)
    n = pairs.qi.shape[0]
    for name, t, shape in (("qi", pairs.qi, (n,)), ("qj", pairs.qj, (n,)),
                           ("blk_ptr", pairs.blk_ptr, (K * K + 1,))):
        _native.check(t, name, i32, shape, dev)
    S = torch.empty((9 * K, 9 * K), dtype=f32, device=dev)
    _native.call("dr3_schur_blocks", Gs, dinv, Hcc, lam, pairs.qi, pairs.qj, pairs.blk_ptr, K, S)
    schur_blocks.launches += 1
    return S


schur_blocks.launches = 0
