"""Offline 2D debug rendering (port of dr3_tpu.viz.draw2d; Viewer2D parity).

The reference's Viewer2D draws interactive HighGUI windows — two-image
match montages with circles and connecting lines, points and epipolar lines
(reference src/viewer.cpp:7-154, blocking waitKey). Here the same artifacts
render headlessly to PNG with matplotlib (Agg), which is imported inside the
functions. Every array argument may be numpy or a tensor on any device; a
tensor is read through ``.cpu()``.
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    """numpy view of an array-like; a tensor is copied off its device."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ax_image(ax, img):
    if img.ndim == 2:
        ax.imshow(img, cmap="gray", vmin=0, vmax=1)
    else:
        ax.imshow(np.clip(img, 0, 1))
    ax.axis("off")


def draw_matches(img1, img2, p1, p2, mask=None, path: str = "matches.png",
                 vertical: bool = True) -> str:
    """Two-image montage with lines between correspondences
    (Viewer2D::update vertical montage, src/viewer.cpp:7-124)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img1, img2, p1, p2 = _np(img1), _np(img2), _np(p1), _np(p2)
    mask = np.ones(len(p1), bool) if mask is None else _np(mask)
    h1, w1 = img1.shape[0], img1.shape[1]
    fig, ax = plt.subplots(figsize=(12, 8))
    if vertical:
        canvas = np.concatenate([img1, img2], axis=0)
        off = np.asarray([0.0, h1])
    else:
        canvas = np.concatenate([img1, img2], axis=1)
        off = np.asarray([w1, 0.0])
    _ax_image(ax, canvas)
    for a, b, m in zip(p1, p2 + off, mask):
        if not m:
            continue
        ax.plot([a[0], b[0]], [a[1], b[1]], "-", color="lime", lw=0.6)
        ax.plot(a[0], a[1], "o", color="red", ms=2)
        ax.plot(b[0], b[1], "o", color="red", ms=2)
    ax.set_title(f"{int(np.sum(mask))} matches")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def draw_points(img, pts, mask=None, path: str = "points.png",
                color: str = "lime") -> str:
    """Detected-corner overlay (Viewer2D::draw_points, src/viewer.cpp:126-138)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img, pts = _np(img), _np(pts)
    mask = np.ones(len(pts), bool) if mask is None else _np(mask)
    fig, ax = plt.subplots(figsize=(12, 5))
    _ax_image(ax, img)
    pts = pts[mask]
    ax.plot(pts[:, 0], pts[:, 1], "o", color=color, ms=3, mfc="none")
    ax.set_title(f"{len(pts)} points")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def draw_epipolar(img1, img2, F, p1, p2, path: str = "epipolar.png",
                  n_lines: int = 20) -> str:
    """Epipolar lines in both images (draw_poles_and_lines parity,
    src/two.cpp:196-236): l2 = F x1 drawn in image 2, l1 = F^T x2 in 1."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img1, img2, F = _np(img1), _np(img2), _np(F)
    p1 = _np(p1)[:n_lines]
    p2 = _np(p2)[:n_lines]
    fig, axes = plt.subplots(1, 2, figsize=(16, 4))

    def plot_lines(ax, img, lines, pts):
        _ax_image(ax, img)
        w = img.shape[1]
        xs = np.asarray([0.0, w])
        for (a, b, c), pt in zip(lines, pts):
            if abs(b) < 1e-9:
                continue
            ys = -(a * xs + c) / b
            ax.plot(xs, ys, "-", lw=0.7)
            ax.plot(pt[0], pt[1], "o", ms=3)
        ax.set_xlim(0, w)
        ax.set_ylim(img.shape[0], 0)

    x1 = np.hstack([p1, np.ones((len(p1), 1))])
    x2 = np.hstack([p2, np.ones((len(p2), 1))])
    plot_lines(axes[0], img1, x2 @ F, p1)       # l1 = F^T x2
    plot_lines(axes[1], img2, x1 @ F.T, p2)     # l2 = F x1
    axes[0].set_title("image 1 + F^T x2")
    axes[1].set_title("image 2 + F x1")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path
