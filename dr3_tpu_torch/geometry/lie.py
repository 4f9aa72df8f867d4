"""SO3 / SE3 Lie groups on torch tensors (port of dr3_tpu.geometry.lie).

Rotations are unit quaternions (wxyz); every op broadcasts over leading
batch dimensions (``SE3(wxyz=[K,4], t=[K,3])``). ``T_f_w`` maps world ->
frame and ``center() = -R^T t`` (reference include/frame.hpp:82). Tangent
vectors are ``[rho(3), omega(3)]``, translation first. ``exp`` keeps the
JAX package's Taylor guards, branch-free with ``torch.where``; the
branch not taken is fed a safe value (``safe_sq``), so ``exp`` and ``log``
differentiate to finite values at zero, as the pose graph's
``torch.func.jacrev`` needs.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


# ---------------------------------------------------------------------------
# quaternion primitives (wxyz)
# ---------------------------------------------------------------------------

def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qvec = q[..., 1:]
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (wxyz), branch-free
    four-candidate construction (largest diagonal term wins)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    s = 2.0 * torch.sqrt(torch.clamp(qw, min=_EPS))
    s0, s1, s2, s3 = s.unbind(-1)
    cand0 = torch.stack([s0 / 4, (m21 - m12) / s0, (m02 - m20) / s0,
                         (m10 - m01) / s0], dim=-1)
    cand1 = torch.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1,
                         (m02 + m20) / s1], dim=-1)
    cand2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4,
                         (m12 + m21) / s2], dim=-1)
    cand3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3,
                         (m12 + m21) / s3, s3 / 4], dim=-1)
    idx = torch.argmax(qw, dim=-1)
    cands = torch.stack([cand0, cand1, cand2, cand3], dim=-2)  # [..., 4, 4]
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def hat(v: torch.Tensor) -> torch.Tensor:
    """so3 hat: [..., 3] -> skew-symmetric [..., 3, 3]."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------

class SO3:
    """Unit-quaternion rotation group, batched over leading axes."""

    def __init__(self, wxyz: torch.Tensor):
        self.wxyz = wxyz

    @classmethod
    def identity(cls, batch: tuple = (), dtype=torch.float32, device=None) -> "SO3":
        q = torch.zeros(batch + (4,), dtype=dtype, device=device)
        q[..., 0].fill_(1.0)
        return cls(q)

    @classmethod
    def from_matrix(cls, m: torch.Tensor) -> "SO3":
        return cls(matrix_to_quat(m))

    @classmethod
    def exp(cls, omega: torch.Tensor) -> "SO3":
        """Rotation-vector exponential with the theta->0 Taylor guard."""
        theta_sq = torch.sum(omega ** 2, dim=-1, keepdim=True)
        use_taylor = theta_sq < _EPS
        safe_sq = torch.where(use_taylor, torch.ones_like(theta_sq), theta_sq)
        theta = torch.sqrt(safe_sq)
        half = 0.5 * theta
        k = torch.where(use_taylor, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
        w = torch.where(use_taylor, 1.0 - theta_sq / 8.0, torch.cos(half))
        return cls(torch.cat([w, k * omega], dim=-1))

    def log(self) -> torch.Tensor:
        """Rotation vector [..., 3], theta in [0, pi]."""
        q = quat_normalize(self.wxyz)
        q = torch.where(q[..., :1] < 0, -q, q)
        w = q[..., :1]
        vec = q[..., 1:]
        norm_sq = torch.sum(vec ** 2, dim=-1, keepdim=True)
        use_taylor = norm_sq < _EPS
        safe_sq = torch.where(use_taylor, torch.ones_like(norm_sq), norm_sq)
        norm = torch.sqrt(safe_sq)
        w_safe = torch.clamp(w, min=_EPS)
        # atan2(|v|, w) * 2 / |v|; Taylor: 2/w - 2|v|^2/(3 w^3)
        k = torch.where(use_taylor,
                        2.0 / w_safe - 2.0 * norm_sq / (3.0 * w_safe ** 3),
                        2.0 * torch.atan2(norm, w) / norm)
        return k * vec

    def matrix(self) -> torch.Tensor:
        return quat_to_matrix(quat_normalize(self.wxyz))

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return quat_rotate(quat_normalize(self.wxyz), v)

    def inverse(self) -> "SO3":
        return SO3(quat_conjugate(self.wxyz))

    def __matmul__(self, other: "SO3") -> "SO3":
        return SO3(quat_multiply(self.wxyz, other.wxyz))

    def normalize(self) -> "SO3":
        return SO3(quat_normalize(self.wxyz))

    @property
    def batch_shape(self) -> torch.Size:
        return self.wxyz.shape[:-1]

    def __getitem__(self, idx) -> "SO3":
        return SO3(self.wxyz[idx])

    def __repr__(self):
        return f"SO3(wxyz={self.wxyz})"


# ---------------------------------------------------------------------------
# SE3
# ---------------------------------------------------------------------------

class SE3:
    """Rigid transform T = (R, t): x -> R x + t, batched over leading axes."""

    def __init__(self, wxyz: torch.Tensor, t: torch.Tensor):
        self.wxyz = wxyz
        self.t = t

    @classmethod
    def identity(cls, batch: tuple = (), dtype=torch.float32,
                 device=None) -> "SE3":
        q = torch.zeros(batch + (4,), dtype=dtype, device=device)
        q[..., 0].fill_(1.0)
        return cls(q, torch.zeros(batch + (3,), dtype=dtype, device=device))

    @classmethod
    def from_rotation_translation(cls, R: torch.Tensor, t: torch.Tensor) -> "SE3":
        return cls(matrix_to_quat(R), t)

    @classmethod
    def from_matrix(cls, m: torch.Tensor) -> "SE3":
        return cls(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])

    @classmethod
    def exp(cls, tangent: torch.Tensor) -> "SE3":
        """tangent [..., 6] = [rho, omega] -> SE3, with left-Jacobian V."""
        rho, omega = tangent[..., :3], tangent[..., 3:]
        rot = SO3.exp(omega)
        theta_sq = torch.sum(omega ** 2, dim=-1)[..., None, None]
        use_taylor = theta_sq < _EPS
        safe_sq = torch.where(use_taylor, torch.ones_like(theta_sq), theta_sq)
        theta = torch.sqrt(safe_sq)
        W = hat(omega)
        WW = W @ W
        A = torch.where(use_taylor, 0.5 - theta_sq / 24.0,
                        (1.0 - torch.cos(theta)) / safe_sq)
        B = torch.where(use_taylor, 1.0 / 6.0 - theta_sq / 120.0,
                        (theta - torch.sin(theta)) / (safe_sq * theta))
        V = _eye3(tangent) + A * W + B * WW
        t = torch.einsum("...ij,...j->...i", V, rho)
        return cls(rot.wxyz, t)

    def log(self) -> torch.Tensor:
        """Tangent [..., 6] = [rho, omega] (the inverse of ``exp``)."""
        omega = SO3(self.wxyz).log()
        theta_sq = torch.sum(omega ** 2, dim=-1)[..., None, None]
        use_taylor = theta_sq < _EPS
        safe_sq = torch.where(use_taylor, torch.ones_like(theta_sq), theta_sq)
        theta = torch.sqrt(safe_sq)
        W = hat(omega)
        WW = W @ W
        half_theta = 0.5 * theta
        # V^-1 = I - W/2 + k W^2, k = (1 - theta cos(t/2) / (2 sin(t/2))) / theta^2
        k = torch.where(use_taylor, 1.0 / 12.0 + theta_sq / 720.0,
                        (1.0 - half_theta * torch.cos(half_theta)
                         / torch.clamp(torch.sin(half_theta), min=_EPS)) / safe_sq)
        Vinv = _eye3(self.t) - 0.5 * W + k * WW
        rho = torch.einsum("...ij,...j->...i", Vinv, self.t)
        return torch.cat([rho, omega], dim=-1)

    def rotation(self) -> SO3:
        return SO3(self.wxyz)

    def matrix(self) -> torch.Tensor:
        """[..., 4, 4] homogeneous matrix."""
        R = quat_to_matrix(quat_normalize(self.wxyz))
        batch = R.shape[:-2]
        m = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
        m[..., :3, :3] = R
        m[..., :3, 3] = self.t
        m[..., 3, 3].fill_(1.0)        # a fill: no host->device copy
        return m

    def matrix34(self) -> torch.Tensor:
        """[..., 3, 4] (R | t)."""
        R = quat_to_matrix(quat_normalize(self.wxyz))
        return torch.cat([R, self.t[..., :, None]], dim=-1)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return quat_rotate(quat_normalize(self.wxyz), v) + self.t

    def inverse(self) -> "SE3":
        qinv = quat_conjugate(quat_normalize(self.wxyz))
        return SE3(qinv, -quat_rotate(qinv, self.t))

    def __matmul__(self, other: "SE3") -> "SE3":
        return SE3(quat_multiply(self.wxyz, other.wxyz),
                   quat_rotate(quat_normalize(self.wxyz), other.t) + self.t)

    def center(self) -> torch.Tensor:
        """Camera center in world for a world->frame pose (frame.hpp:82)."""
        return self.inverse().t

    def normalize(self) -> "SE3":
        return SE3(quat_normalize(self.wxyz), self.t)

    def retract(self, delta: torch.Tensor) -> "SE3":
        """Left-multiplicative retraction: exp(delta) @ self (BA update)."""
        return SE3.exp(delta) @ self

    @property
    def batch_shape(self) -> torch.Size:
        return self.wxyz.shape[:-1]

    def params(self) -> torch.Tensor:
        """Flat [..., 7] (wxyz, t), the pose-table and checkpoint layout."""
        return torch.cat([self.wxyz, self.t], dim=-1)

    @classmethod
    def from_params(cls, p: torch.Tensor) -> "SE3":
        return cls(p[..., :4], p[..., 4:7])

    def __getitem__(self, idx) -> "SE3":
        return SE3(self.wxyz[idx], self.t[idx])

    def __repr__(self):
        return f"SE3(wxyz={self.wxyz}, t={self.t})"
