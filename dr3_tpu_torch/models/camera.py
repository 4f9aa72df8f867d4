"""Pinhole camera (port of dr3_tpu.models.camera).

Batched projection with radial (k1, k2, k3) + tangential (p1, p2)
distortion, matching the reference's src/camera.cpp:51-73; ``cam2world``
inverts it by fixed-point undistortion (OpenCV ``undistortPoints``, used
at src/camera.cpp:31-38) into unit bearings; ``is_in_frame`` is the
per-level bounds check of camera.hpp:45-51. Intrinsics are 0-d float32
tensors on the camera's device; ``width``/``height`` are ints.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Pinhole:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor   # [5] (k1, k2, p1, p2, k3), src/camera.cpp:57-70
    width: int = 0
    height: int = 0

    @classmethod
    def create(cls, width, height, fx, fy, cx, cy,
               d=(0.0, 0.0, 0.0, 0.0, 0.0), device="cpu") -> "Pinhole":
        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)

        return cls(fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
                   dist=torch.tensor(d, dtype=torch.float32, device=device),
                   width=int(width), height=int(height))

    @classmethod
    def kitti(cls, device="cpu") -> "Pinhole":
        """KITTI grayscale cam used by every reference SLAM run
        (tests/test_pipeline.cpp:62-64, tests/slam/test_slam.cc:56-67)."""
        return cls.create(1240, 376, 718.856, 718.856, 607.1928, 185.2157,
                          device=device)

    @property
    def device(self) -> torch.device:
        return self.fx.device

    def to(self, device) -> "Pinhole":
        return dataclasses.replace(
            self, fx=self.fx.to(device), fy=self.fy.to(device),
            cx=self.cx.to(device), cy=self.cy.to(device),
            dist=self.dist.to(device))

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], -1),
            torch.stack([z, self.fy, self.cy], -1),
            torch.stack([z, z, o], -1),
        ], -2)

    @property
    def intrinsics(self) -> torch.Tensor:
        """[4] (fx, fy, cx, cy), the BA problem's shared block."""
        return torch.stack([self.fx, self.fy, self.cx, self.cy])

    @property
    def has_distortion(self) -> torch.Tensor:
        return torch.any(self.dist.abs() > 1e-12)

    def distort(self, xy: torch.Tensor) -> torch.Tensor:
        """Apply distortion to normalized coords [..., 2] (camera.cpp:57-70)."""
        k1, k2, p1, p2, k3 = self.dist.unbind(0)
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy2 = 2.0 * x * y
        xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p2 * xy2 + p1 * (r2 + 2.0 * y * y)
        return torch.stack([xd, yd], dim=-1)

    def undistort(self, xy: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Invert ``distort`` by OpenCV-style fixed-point iteration."""
        k1, k2, p1, p2, k3 = self.dist.unbind(0)
        cur = xy
        for _ in range(iters):
            x, y = cur[..., 0], cur[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            xy2 = 2.0 * x * y
            dx = p1 * xy2 + p2 * (r2 + 2.0 * x * x)
            dy = p2 * xy2 + p1 * (r2 + 2.0 * y * y)
            cur = torch.stack([(xy[..., 0] - dx) / radial, (xy[..., 1] - dy) / radial], dim=-1)
        return cur

    def world2cam(self, xyz: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3D points [..., 3] -> pixels [..., 2]."""
        z = xyz[..., 2:3]
        z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
        return self.project_normalized(xyz[..., :2] / z)

    def project_normalized(self, xy: torch.Tensor) -> torch.Tensor:
        """Normalized image coords [..., 2] -> pixels (applies distortion)."""
        xyd = self.distort(xy)
        u = self.fx * xyd[..., 0] + self.cx
        v = self.fy * xyd[..., 1] + self.cy
        return torch.stack([u, v], dim=-1)

    def cam2world(self, px: torch.Tensor) -> torch.Tensor:
        """Pixels [..., 2] -> unit bearing vectors [..., 3] (camera.cpp:25-41)."""
        xy = torch.stack([(px[..., 0] - self.cx) / self.fx,
                          (px[..., 1] - self.cy) / self.fy], dim=-1)
        xy = self.undistort(xy)
        f = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
        return f / torch.linalg.norm(f, dim=-1, keepdim=True)

    def is_in_frame(self, px: torch.Tensor, boundary: float = 0.0,
                    level: int = 0) -> torch.Tensor:
        """Bounds check with per-level shrink (reference camera.hpp:45-51),
        half-open: [boundary, size / 2^level - boundary)."""
        scale = 2.0 ** level
        w = self.width / scale
        h = self.height / scale
        u, v = px[..., 0], px[..., 1]
        return (u >= boundary) & (v >= boundary) & (u < w - boundary) & (v < h - boundary)

    def error2(self, sigma: float = 1.0) -> torch.Tensor:
        """Squared px error of one sigma at the focal plane (camera.hpp:55)."""
        return torch.as_tensor(sigma, dtype=torch.float32, device=self.device) ** 2
