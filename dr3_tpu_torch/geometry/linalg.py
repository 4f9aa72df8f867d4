"""Small-matrix linear algebra (port of dr3_tpu.geometry.linalg).

The same closed forms and unrolled factorizations as the JAX package, so
the port computes the same numbers: ``smallest_eigvec_gram`` is the
fixed-count inverse power iteration (not ``eigh``), ``chol_solve_small``
the unrolled Cholesky, ``inv3x3`` the adjugate with max-|entry|
normalisation (the round-5 fix for f32 overflow at Hpp ~1e13).
"""

from __future__ import annotations

import torch


def _chol_factor_small(A: torch.Tensor):
    """Unrolled lower Cholesky factor of [..., n, n] as a nested list of
    [...] tensors (the factorization half of ``chol_solve_small``)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_factored(L, b: torch.Tensor) -> torch.Tensor:
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _chol_inverse_factored(L) -> torch.Tensor:
    """[..., n, n] inverse of the matrix whose unrolled lower factor is L
    (:func:`_chol_factor_small`): the n unit columns solved at once, so a
    caller that applies it often pays one product a time, not the ~n^2
    elementwise launches of :func:`_chol_solve_factored`."""
    n = len(L)
    Lb = [[None if x is None else x[..., None] for x in row] for row in L]
    eye = torch.eye(n, dtype=L[0][0].dtype, device=L[0][0].device)
    # row j of the solve is A^-1 e_j, column j of the inverse
    return _chol_solve_factored(Lb, eye.expand(L[0][0].shape + (n, n))).transpose(-1, -2)


def chol_solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky solve for tiny SPD systems A [..., n, n], b [..., n],
    fully unrolled (n small, <= ~9)."""
    return _chol_solve_factored(_chol_factor_small(A), b)


def smallest_eigvec_gram(A: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Right-singular vector of A [..., m, n] for its smallest singular value,
    by ``iters`` steps of inverse power iteration on the damped Gram matrix
    A^T A from a fixed all-ones start. The JAX version refactors the Gram
    matrix inside each step and XLA deduplicates it; here it is factored
    once — the same arithmetic."""
    G = torch.einsum("...ji,...jk->...ik", A, A)
    n = G.shape[-1]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    Gd = G + (1e-7 * tr + 1e-20) * eye
    L = _chol_factor_small(Gd)
    v = torch.ones(G.shape[:-1], dtype=G.dtype, device=G.device)
    for _ in range(iters):
        v = _chol_solve_factored(L, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    return v


def solve_psd(A: torch.Tensor, b: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Solve (A + damping I) x = b for symmetric PSD A via Cholesky; b is
    [..., n] or [..., n, m]. A failed factorisation gives NaN, as
    ``jnp.linalg.cholesky`` does, instead of raising (no host read)."""
    n = A.shape[-1]
    if damping:
        A = A + damping * torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    vec = b.ndim == A.ndim - 1
    y = torch.linalg.solve_triangular(L, b[..., None] if vec else b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


def chol3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form lower-Cholesky factor of SPD [..., 3, 3] blocks
    (sqrt arguments floored so a degenerate block stays finite)."""
    eps = 1e-30
    a = torch.sqrt(torch.clamp(m[..., 0, 0], min=eps))
    b = m[..., 1, 0] / a
    c = m[..., 2, 0] / a
    d = torch.sqrt(torch.clamp(m[..., 1, 1] - b * b, min=eps))
    e = (m[..., 2, 1] - b * c) / d
    f = torch.sqrt(torch.clamp(m[..., 2, 2] - c * c - e * e, min=eps))
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, b, d, z, c, e, f], dim=-1).reshape(m.shape)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det). Blocks are first
    divided by their max |entry|: the raw determinant of a BA Hpp block at
    ~1e13 overflows f32. inv(M) = inv(M/s)/s."""
    scale = torch.clamp(m.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    m = m / scale
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-20, torch.sign(det) * 1e-20 + 1e-20, det)
    adj = torch.stack([
        A, -(b * i - c * h), b * f - c * e,
        B, a * i - c * g, -(a * f - c * d),
        C, -(a * h - b * g), a * e - b * d,
    ], dim=-1).reshape(m.shape)
    return adj / (det[..., None, None] * scale)
