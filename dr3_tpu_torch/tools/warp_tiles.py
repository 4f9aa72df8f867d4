"""The whole-tile shortcut of csrc/warp.cu's homography warp: the tiles it
writes as fill and false without sampling.

* :func:`kernel_shortcut_tiles` asks the kernel library: the same test over
  the same tiles (``dr3_warp_shortcut_tiles``), run on the card;
* :func:`shortcut_tiles` repeats the test on the host in numpy float32, one
  rounding per operation as the kernel does, so the CPU tests can hold it
  against the plain warp; a card test holds it against the kernel's own
  decisions, tile for tile.

chip_smoke.py and tools/kernel_time.py report the share of tiles taken;
nothing on the port's path calls this module.
"""

from __future__ import annotations

import numpy as np
import torch

from dr3_tpu_torch.ops import _native

# csrc/warp.cu's homography tiles (kTileRowsOf<kHomography>, kTileWidth,
# kGroup): 4 rows by 128 columns, each row of a tile starting (i * Wo) mod 4
# columns early, on a multiple of 4 of the flattened output
TILE_ROWS, TILE_WIDTH, GROUP = 4, 128, 4
_U = np.float32(2.0 ** -24)


def tile_of_pixels(out_hw: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """(tile row, tile column) [Ho, Wo] of each output pixel in csrc/warp.cu's
    homography grid: row i, column j is written by tile (i // 4, (j + (i Wo)
    mod 4) // 128)."""
    oh, ow = out_hw
    i, j = np.mgrid[0:oh, 0:ow]
    return i // TILE_ROWS, (j + (i * ow) % GROUP) // TILE_WIDTH


def shortcut_tiles(Hinv, src_hw: tuple[int, int], out_hw: tuple[int, int]) -> np.ndarray:
    """[tiles down, tiles across] bool: the tiles of a homography warp that
    csrc/warp.cu writes as fill without sampling (its ``tile_outside``),
    decided on the host with the kernel's float32 operations, one rounding
    each, so the two agree tile for tile. A tile is taken when its four
    corner pixels map beyond one edge of the source by a margin of 1 px plus
    4x the bound on the rounding of any of its pixels' coordinates, with one
    sign of w at all four corners and |w| clear of the guard (csrc/warp.cu
    derives the bound)."""
    f32 = np.float32
    h = np.asarray(Hinv, np.float32).reshape(9)
    H, W = src_hw
    oh, ow = out_hw
    gx = -(-((ow + 2 * (GROUP - 1)) // GROUP) // 32)
    gy = -(-oh // TILE_ROWS)
    c0 = np.arange(gx) * TILE_WIDTH - (GROUP - 1)
    j0 = np.maximum(c0, 0).astype(np.float32)[None, :]
    j1 = np.minimum(c0 + TILE_WIDTH + GROUP - 2, ow - 1).astype(np.float32)[None, :]
    r0 = np.arange(gy) * TILE_ROWS
    i0 = r0.astype(np.float32)[:, None]
    i1 = np.minimum(r0 + TILE_ROWS - 1, oh - 1).astype(np.float32)[:, None]
    with np.errstate(all="ignore"):
        ws, xs, ys = [], [], []
        for j, i in ((j0, i0), (j1, i0), (j0, i1), (j1, i1)):
            w = (h[6] * j + h[7] * i) + h[8]
            xs.append(((h[0] * j + h[1] * i) + h[2]) / w)
            ys.append(((h[3] * j + h[4] * i) + h[5]) / w)
            ws.append(w)
        w, x, y = (np.stack(np.broadcast_arrays(*v)) for v in (ws, xs, ys))
        nan = (np.isnan(x) | np.isnan(y) | np.isnan(w)).any(0)
        one_sign = (w > 0).all(0) | (w < 0).all(0)
        a = np.abs(h)
        a_x, a_y, a_w = ((a[k] * j1 + a[k + 1] * i1) + a[k + 2] for k in (0, 3, 6))
        e_w = f32(4) * _U * a_w
        wl = np.abs(w).min(0) - f32(2) * e_w
        margin = []
        for a_c in (a_x, a_y):
            q = a_c / wl
            e = (f32(4) * _U * a_c + q * e_w) / wl + f32(2) * _U * q
            margin.append(f32(1) + f32(4) * e)
        m_x, m_y = margin
        beyond = ((x.max(0) < -m_x) | (x.min(0) > f32(W - 1) + m_x)
                  | (y.max(0) < -m_y) | (y.min(0) > f32(H - 1) + m_y))
    return ~nan & one_sign & (wl > f32(1e-12)) & beyond


def kernel_shortcut_tiles(Hinv, src_hw: tuple[int, int], out_hw: tuple[int, int],
                          device="cuda") -> np.ndarray:
    """[tiles down, tiles across] bool: the kernel's own decisions for a
    homography warp through H^-1 of an [H, W] source onto out_hw, taken on
    the card by the test and over the tiles the warp kernel uses."""
    h = [float(v) for v in np.asarray(Hinv, np.float32).reshape(9)]
    grid = torch.zeros(2, dtype=torch.int32)
    args = (*h, int(src_hw[0]), int(src_hw[1]), int(out_hw[0]), int(out_hw[1]))
    _native.call("dr3_warp_shortcut_tiles", *args, None, grid)
    tiles = torch.empty((int(grid[0]), int(grid[1])), dtype=torch.bool, device=device)
    _native.call("dr3_warp_shortcut_tiles", *args, tiles, grid)
    return tiles.cpu().numpy()
