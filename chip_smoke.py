#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dr3_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device  — a CUDA device must exist (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build   — compiles csrc/*.cu with nvcc for sm_90a into build/;
3. kernels — each kernel against its plain PyTorch twin on the same card,
   at its main path's shapes, with the tolerances below; both timed with
   CUDA events, the median of 20 runs of 10 back-to-back calls after
   warm-up. K1-K3 at the VO path's (KITTI 1240x376, 546 tracks); K4
   (csrc/warp.cu) at the panorama's: the spherical pre-warp of a
   640x480x3 view, a 1240x376x3 view onto its canvas, the row / column
   remaps at 376x1240 and the descriptor patches, atol 1e-5, <= 3 flips of
   the validity mask; K3 and K1 again at the panorama alignment's shapes
   (two pre-warped 640x480 views, their detection levels, LK from the
   ZNCC matches), with the VO shapes' gates;
4. slice   — MonoVO(Pinhole.kitti(), Config(loop_closure=False)) over 40
   rendered frames with known ground truth: reaches GENERAL, >= 3
   keyframes with window BA, > 100 map points, Sim(3) ATE under 5% of the
   path, every kernel launched by the run (counters zeroed just before);
   then the same 320x240 sequence on the card and on the CPU (plain
   twins) must take the same stage/keyframe decisions;
5. panorama — Panorama.process on rendered views of a textured sphere
   (exact ground truth): (a) TRANSLATE, 8 RGB views of 640x480, f 600,
   feather 40, 0.35 rad apart: every pair's shift within 1 px of f * yaw,
   the canvas width within 12 px, the canvas correlating > 0.95 with the
   texture; (b) HOMOGRAPHY, 4 RGB views of 1240x376 with KITTI intrinsics,
   0.15 rad apart: each chained homography takes the truth's image of the
   view's corners back within 3 px of the corners; K1, K3 and both K4
   kernels launched (counters zeroed just before); then a 3-view 320x240
   panorama on the card and on the CPU with the same RANSAC draws: same
   canvas shape, homography corners within 0.1 px, mean |d canvas| < 2e-3.

The last two lines of stdout are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or dr3_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from dr3_tpu_torch.io.image import to_gray  # noqa: E402
from dr3_tpu_torch.models.camera import Pinhole  # noqa: E402
from dr3_tpu_torch.ops import _native, corners, lk, pyramid, warp  # noqa: E402
from dr3_tpu_torch.pipelines.panorama import Panorama, PanType  # noqa: E402
from dr3_tpu_torch.pipelines.stitch import find_correspondences  # noqa: E402
from dr3_tpu_torch.pipelines.vo import MonoVO, Stage  # noqa: E402
from dr3_tpu_torch.utils import synth  # noqa: E402
from dr3_tpu_torch.utils.config import Config  # noqa: E402
from dr3_tpu_torch.utils.synth import lateral_path, make_textures, render_scene  # noqa: E402
from dr3_tpu_torch.viz.ate import ate_rmse  # noqa: E402

SEED = 0
N_FRAMES = 40
STEP = 0.08          # scene units per frame (near plane at depth 6)
# panorama (a): bench.py's configuration (8 views, f 600, feather 40)
PAN_N, PAN_W, PAN_H, PAN_F, PAN_YAW, PAN_FEATHER = 8, 640, 480, 600.0, 0.35, 40
# panorama (b): KITTI intrinsics. At 0.3 rad apart the ZNCC matches of a
# pair fail (in the JAX package too) and the last view's edge turns past
# 90 degrees from view 0; at 0.15 the chained homographies hold their
# corners within 2.69 px over 4 texture seeds (PERF.md), gated at 3 px
HOMO_N, HOMO_YAW = 4, 0.15
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=20, n=10, warm=3) -> float:
    """Device time per call of fn() in ms: the median over ``reps`` runs,
    after warm-up, of CUDA events around n calls launched back to back,
    divided by n. For a kernel whose device time is below its wrapper's
    host time this measures the host launch rate, which is what the main
    path pays too."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def plain_pyramid_track(pyr_prev, pyr_next, pts, valid, half, iters, eps, init=None):
    """track_pyramid's coarse-to-fine loop over the plain level function."""
    n_levels = len(pyr_prev)
    guess = (pts if init is None else init) / (2.0 ** (n_levels - 1))
    ok_all = torch.ones_like(valid)
    for lvl in range(n_levels - 1, -1, -1):
        pos, ok, err = lk._track_level_plain(pyr_prev[lvl], pyr_next[lvl],
                                             pts / (2.0 ** lvl), guess, half,
                                             iters, eps)
        ok_all = ok_all & ok
        guess = pos * 2.0 if lvl > 0 else pos
    return guess, ok_all & valid & (err < 40.0)


def k3_check(tag, img, threshold) -> float:
    """K3 against its plain version on one image: the exact corner set,
    scores within rtol 2e-3, atol 0.05; returns max |d score|."""
    got = corners.corner_response(img, threshold)
    want = corners._corner_response_plain(img, threshold)
    torch.cuda.synchronize()
    if not torch.equal(got > 0, want > 0):
        raise AssertionError(f"K3 {tag}: corner sets differ "
                             f"({int((got > 0).sum())} vs {int((want > 0).sum())})")
    torch.testing.assert_close(got, want, rtol=2e-3, atol=0.05)
    err = float((got - want).abs().max())
    log(f"[K3] {tag} {tuple(img.shape)}: {int((got > 0).sum())} corners, "
        f"max |d score| {err:.3g}")
    return err


def k1_track_check(tag, pyr0, pyr1, pts, valid, init, cfg, min_ok=0.8):
    """K1's track_pyramid (from ``init``, or from pts) against the plain
    loop: at least ``min_ok`` of the valid tracks ok in both, |d pos| <
    1e-2 px where both are ok; returns (max |d pos|, the kernel's
    TrackResult)."""
    half = cfg.klt_window // 2
    res = lk.track_pyramid(pyr0, pyr1, pts, valid, init=init, half_window=half,
                           iters=cfg.klt_iters, eps=cfg.klt_eps)
    pos_p, ok_p = plain_pyramid_track(pyr0, pyr1, pts, valid, half,
                                      cfg.klt_iters, cfg.klt_eps, init=init)
    both = res.ok & ok_p
    nv = int(valid.sum())
    if not (int(res.ok.sum()) >= min_ok * nv and int(ok_p.sum()) >= min_ok * nv):
        raise AssertionError(f"K1 {tag}: ok {int(res.ok.sum())} / plain "
                             f"{int(ok_p.sum())} of {nv}")
    err = float((res.pos - pos_p)[both].abs().max())
    if not err < 1e-2:
        raise AssertionError(f"K1 {tag}: max |d pos| {err}")
    log(f"[K1] {tag}: ok {int(res.ok.sum())} (plain {int(ok_p.sum())}, "
        f"{int((res.ok != ok_p).sum())} differ) of {nv}; max |d pos| {err:.3g}")
    return err, res


def render(cam, n, step, seed, tex_size):
    rng = np.random.default_rng(seed)
    tn, tf = make_textures(rng, size=tex_size)
    poses, gt = lateral_path(n, step)
    return [render_scene(cam, T, tn, tf) for T in poses], gt


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this run needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; cards: {torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.perf_counter()
    _native.lib()
    info = _native.build_info
    log(f"[build] {info['path']} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s, cached={info['cached']})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("[build]   " + line.strip())


def phase_kernels(card, frames):
    dev = torch.device("cuda")
    cfg = Config(loop_closure=False)
    f0 = torch.as_tensor(frames[0], device=dev)
    f1 = torch.as_tensor(frames[1], device=dev)
    pyr0 = pyramid.build_pyramid(f0, 4)
    pyr1 = pyramid.build_pyramid(f1, 4)
    out = {}

    # K3 on each detection level: exact corner set, scores rtol 2e-3 atol 0.05
    errs = [k3_check(f"level {lvl}", pyr0[lvl], cfg.fast_threshold)
            for lvl in range(cfg.n_pyr_levels)]
    out["corner_response"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: corners.corner_response(pyr0[0], cfg.fast_threshold)),
        plain_ms=cuda_ms(lambda: corners._corner_response_plain(pyr0[0], cfg.fast_threshold)))

    # tracks: the detected grid corners of frame 0 (546 slots at KITTI size)
    feats = corners.detect_features(pyr0[:cfg.n_pyr_levels], cfg.cell_size,
                                    cfg.min_corner_score, cfg.fast_threshold)
    pts, valid = feats.xy.contiguous(), feats.valid
    n = pts.shape[0]
    half = cfg.klt_window // 2
    log(f"[K1] {n} track slots, {int(valid.sum())} corners, W={2 * half + 1}")

    # K1 (a) over the 4-level pyramid: >= 80% ok in both, |d pos| < 1e-2
    err_a, res = k1_track_check("track_pyramid", pyr0, pyr1, pts, valid, None, cfg)
    guess = pts.clone()
    out["lk_track_level"] = dict(
        max_abs_err=err_a,
        ms=cuda_ms(lambda: lk.track_level(pyr0[0], pyr1[0], pts, guess, half,
                                          cfg.klt_iters, cfg.klt_eps)),
        plain_ms=cuda_ms(lambda: lk._track_level_plain(pyr0[0], pyr1[0], pts, guess,
                                                       half, cfg.klt_iters, cfg.klt_eps)))

    # K1 (b) template alignment: W=9, 8 iterations, same tolerance
    thalf = (cfg.feature_align_patch - 1) // 2
    templates = lk._sample_patches_plain(pyr0[0], pts, thalf).contiguous()
    start = res.pos.contiguous()
    ok_in = res.ok & valid
    ra = lk.align_to_templates(pyr1[0], templates, start, ok_in,
                               iters=cfg.feature_align_iters)
    rp = lk._align_to_templates_plain(pyr1[0], templates, start, ok_in,
                                      cfg.feature_align_iters, 1e-2, 30.0, 4.0)
    both = ra.ok & rp.ok
    nv = int(ok_in.sum())
    if not (int(ra.ok.sum()) >= 0.8 * nv and int(rp.ok.sum()) >= 0.8 * nv):
        raise AssertionError(f"K1 align: ok {int(ra.ok.sum())} / plain "
                             f"{int(rp.ok.sum())} of {nv}")
    err_b = float((ra.pos - rp.pos)[both].abs().max())
    if not err_b < 1e-2:
        raise AssertionError(f"K1 align: max |d pos| {err_b}")
    log(f"[K1] align_to_templates: ok {int(ra.ok.sum())} (plain {int(rp.ok.sum())}) "
        f"of {nv}; max |d pos| {err_b:.3g}")
    out["lk_align_templates"] = dict(
        max_abs_err=err_b,
        ms=cuda_ms(lambda: lk.align_to_templates(pyr1[0], templates, start, ok_in,
                                                 iters=cfg.feature_align_iters)),
        plain_ms=cuda_ms(lambda: lk._align_to_templates_plain(
            pyr1[0], templates, start, ok_in, cfg.feature_align_iters, 1e-2, 30.0, 4.0)))

    # K2 on the level-2 image: W=5 and W=7 (sparse alignment), atol 1e-5
    img2 = pyr1[cfg.align_level]
    centers = (pts / 4.0 + 0.37).contiguous()
    errs = []
    for h in (cfg.align_half_patch, cfg.align_half_patch + 1):
        got = lk.sample_patches(img2, centers, h)
        want = lk._sample_patches_plain(img2, centers, h)
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
        errs.append(float((got - want).abs().max()))
        log(f"[K2] W={2 * h + 1} on {tuple(img2.shape)}: max |d| {errs[-1]:.3g}")
    h5 = cfg.align_half_patch
    out["sample_patches"] = dict(
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: lk.sample_patches(img2, centers, h5)),
        plain_ms=cuda_ms(lambda: lk._sample_patches_plain(img2, centers, h5)))
    for name, r in out.items():
        log(f"[time] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            f"({card})")
    return out


def phase_slice(card, frames, gt):
    cfg = Config(loop_closure=False)
    vo = MonoVO(Pinhole.kitti(), cfg, device="cuda")
    counters = (lk.track_level, lk.align_to_templates, lk.sample_patches,
                corners.corner_response)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    frame_s = []
    for f in frames:
        t0 = time.perf_counter()
        vo.process(f)
        frame_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()

    stages = [s.stage for s in vo.stats]
    n_general = stages.count("general")
    gen_s = [t for t, s in zip(frame_s, vo.stats) if s.stage == "general"]
    gen_kf = [t for t, s in zip(frame_s, vo.stats)
              if s.stage == "general" and s.is_keyframe]
    gen_plain = [t for t, s in zip(frame_s, vo.stats)
                 if s.stage == "general" and not s.is_keyframe]
    log(vo.report())
    log(f"[slice] stages: {stages}")
    log(f"[slice] keyframes {vo.kf_count}, window BA {vo.n_window_ba}, CG "
        f"iterations (host syncs) {vo.n_cg_iters}, map points {int(vo.map.n)}")
    log(f"[slice] launches {launches}")
    log(f"[slice] general frames: {n_general}, {n_general / sum(gen_s):.2f} frames/s; "
        f"non-keyframe median {1e3 * statistics.median(gen_plain):.2f} ms, "
        f"keyframe median {1e3 * statistics.median(gen_kf) if gen_kf else float('nan'):.2f} ms; "
        f"peak memory {peak / 2**20:.1f} MiB ({card})")

    if vo.stage is not Stage.GENERAL:
        raise AssertionError(f"slice ended in {vo.stage}")
    if vo.kf_count < 3 or vo.n_window_ba < 1:
        raise AssertionError(f"keyframes {vo.kf_count}, window BA {vo.n_window_ba}")
    if not int(vo.map.n) > 100:
        raise AssertionError(f"map points {int(vo.map.n)}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    k1 = launches["track_level"] + launches["align_to_templates"]
    if k1 < 5 * n_general:
        raise AssertionError(f"K1 launched {k1} times for {n_general} general frames")
    est = vo.positions()
    if not np.isfinite(est).all():
        raise AssertionError("non-finite trajectory")
    moving = np.nonzero(np.linalg.norm(est, axis=1) > 1e-9)[0]
    i0 = max(int(moving[0]) - 1, 0)
    a = ate_rmse(est[i0:], gt[i0:], with_scale=True)
    length = float(np.linalg.norm(np.diff(gt[i0:], axis=0), axis=1).sum())
    log(f"[slice] ATE {a.rmse:.5f} over a {length:.3f}-unit path "
        f"({100 * a.rmse / length:.2f}%)")
    if not a.rmse < 0.05 * length:
        raise AssertionError(f"ATE {a.rmse} >= 5% of {length}")
    return launches


def phase_cpu_reference():
    """Same small sequence through the port on the card and on the CPU (the
    plain twins): identical stage/keyframe decisions, positions within 1%
    of the path length (float atomics and FMA reorder sums on the card)."""
    cam = Pinhole.create(320, 240, 280.0, 280.0, 160.0, 120.0)
    frames, gt = render(cam, 16, 0.09, SEED + 1, 1600)
    cfg = Config(init_min_features=60, init_min_tracked=60,
                 init_min_triangulated=30, init_min_disparity=2.0,
                 max_keyframes=16, kf_disparity=10.0, loop_closure=False)
    runs = {}
    for device in ("cuda", "cpu"):
        vo = MonoVO(cam, cfg, device=device)
        for f in frames:
            vo.process(f)
        runs[device] = vo
    dec = {d: [(s.stage, s.is_keyframe) for s in v.stats] for d, v in runs.items()}
    if dec["cuda"] != dec["cpu"]:
        raise AssertionError(f"card vs CPU decisions differ:\n{dec['cuda']}\n{dec['cpu']}")
    diff = float(np.abs(runs["cuda"].positions() - runs["cpu"].positions()).max())
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    log(f"[reference] 320x240 x {len(frames)} frames: same decisions on card and "
        f"CPU; max |d position| {diff:.3g} (path {length:.3f})")
    if not diff < 0.01 * length:
        raise AssertionError(f"card vs CPU positions differ by {diff}")


def render_panorama_cases(seed=SEED):
    """Views of a textured sphere for the panorama phase (numpy, host)."""
    rng = np.random.default_rng(seed + 2)
    lon0, lat0 = -1.0, -0.6
    tex = synth.sphere_texture(rng, PAN_F, lon=(lon0, (PAN_N - 1) * PAN_YAW + 1.0),
                               lat=(lat0, -lat0))
    translate = dict(tex=tex, lon0=lon0, lat0=lat0, views=[
        synth.render_sphere_view(tex, PAN_F, lon0, lat0, PAN_F, PAN_F, PAN_W / 2,
                                 PAN_H / 2, PAN_W, PAN_H, PAN_YAW * k)
        for k in range(PAN_N)])
    cam = Pinhole.kitti()
    K = tuple(float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    hlon0, hlat0 = -1.0, -0.5
    htex = synth.sphere_texture(rng, K[0], lon=(hlon0, (HOMO_N - 1) * HOMO_YAW + 1.0),
                                lat=(hlat0, -hlat0))
    homography = dict(K=K, wh=(cam.width, cam.height), views=[
        synth.render_sphere_view(htex, K[0], hlon0, hlat0, *K, cam.width, cam.height,
                                 HOMO_YAW * k) for k in range(HOMO_N)])
    return dict(translate=translate, homography=homography)


def k4_check(name, got, want, got_valid=None, want_valid=None) -> float:
    """Kernel vs plain on the card: atol 1e-5, <= 3 validity flips."""
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"K4 {name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    flips = 0
    if got_valid is not None:
        flips = int((got_valid != want_valid).sum())
        if flips > 3:
            raise AssertionError(f"K4 {name}: {flips} validity flips")
        both = got_valid & want_valid
        got, want = got[both], want[both]
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not err <= 1e-5:
        raise AssertionError(f"K4 {name}: max |d| {err}")
    log(f"[K4] {name}: max |d| {err:.3g}, validity flips {flips}")
    return err


def phase_k4_kernels(card, cases):
    """K4 (csrc/warp.cu) against its plain versions at the panorama's shapes."""
    dev = torch.device(DEV)
    view = torch.as_tensor(cases["translate"]["views"][0], device=dev)      # 480x640x3
    hc = cases["homography"]
    kview = torch.as_tensor(hc["views"][1], device=dev)                    # 376x1240x3
    gray = kview @ torch.tensor([0.299, 0.587, 0.114], device=dev)
    h, w = gray.shape
    errs = {"remap": [], "warp": []}

    # spherical pre-warp of a view (and its cylindrical sibling), f 600
    errs["warp"].append(k4_check(
        f"warp_spherical {tuple(view.shape)} f {PAN_F:g}", warp.warp_spherical(view, PAN_F),
        warp._warp_field(view, warp._SPHERICAL, PAN_F)))
    errs["warp"].append(k4_check(
        f"warp_cylindrical {tuple(view.shape)} f {PAN_F:g}",
        warp.warp_cylindrical(view, PAN_F), warp._warp_field(view, warp._CYLINDRICAL, PAN_F)))

    # view 1 onto the canvas of views 0-1 through the true homography
    H1 = synth.sphere_homography(*hc["K"], HOMO_YAW)
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64).T
    t = H1 @ c
    xs = np.concatenate([t[0] / t[2], [0, w]])
    ys = np.concatenate([t[1] / t[2], [0, h]])
    T = np.eye(3)
    T[0, 2], T[1, 2] = -np.floor(xs.min()), -np.floor(ys.min())
    M = (T @ H1).astype(np.float32)
    out_hw = (int(np.ceil(ys.max()) - np.floor(ys.min())),
              int(np.ceil(xs.max()) - np.floor(xs.min())))
    Minv = warp.homography_inverse(M)
    got, gv = warp.warp_perspective(kview, M, out_hw)
    want, wv = warp._warp_perspective_plain(kview, Minv, out_hw, 0.0)
    errs["warp"].append(k4_check(f"warp_perspective {tuple(kview.shape)} -> {out_hw}",
                                 got, want, gv, wv))

    # K4a / K4b contracts at 376x1240: smooth row and column fields
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    v = (gy + 6.0 * torch.sin(gx / 40.0) + 2.5).contiguous()
    u = (gx + 5.0 * torch.cos(gy / 25.0) - 3.25).contiguous()
    errs["remap"].append(k4_check(f"remap_rows {tuple(gray.shape)}",
                                  warp.remap_rows(gray, v), warp._remap_rows_plain(gray, v)))
    errs["remap"].append(k4_check(f"remap_cols {tuple(gray.shape)}",
                                  warp.remap_cols(gray, u), warp._remap_cols_plain(gray, u)))

    # the descriptor patches of the pre-warped view's corners (the path's remap_xy)
    pgray = warp._warp_field(view, warp._SPHERICAL, PAN_F) @ torch.tensor(
        [0.299, 0.587, 0.114], device=dev)
    cfg = Config()
    feats = corners.detect_features(pyramid.build_pyramid(pgray, 3), cfg.cell_size,
                                    cfg.min_corner_score, cfg.fast_threshold)
    off = torch.arange(16, dtype=torch.float32, device=dev) - 8 + 0.5
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    coords = (feats.xy[:, None, None, :] + torch.stack([ox, oy], -1)[None]).contiguous()
    got, gv = warp.remap_xy(pgray, coords, clamp=True)
    want, wv = warp.bilinear_sample(pgray, coords, clamp=True)
    errs["remap"].append(k4_check(f"remap_xy {tuple(coords.shape[:-1])} on "
                                  f"{tuple(pgray.shape)}", got, want, gv, wv))

    times = {
        "remap_rows": (lambda: warp.remap_rows(gray, v),
                       lambda: warp._remap_rows_plain(gray, v)),
        "remap_cols": (lambda: warp.remap_cols(gray, u),
                       lambda: warp._remap_cols_plain(gray, u)),
        "remap_xy": (lambda: warp.remap_xy(pgray, coords, clamp=True),
                     lambda: warp.bilinear_sample(pgray, coords, clamp=True)),
        "warp_spherical": (lambda: warp.warp_spherical(view, PAN_F),
                           lambda: warp._warp_field(view, warp._SPHERICAL, PAN_F)),
        "warp_perspective": (lambda: warp.warp_perspective(kview, M, out_hw),
                             lambda: warp._warp_perspective_plain(kview, Minv, out_hw, 0.0)),
    }
    ms = {}
    for name, (kern, plain) in times.items():
        ms[name] = (cuda_ms(kern), cuda_ms(plain))
        log(f"[time] {name}: kernel {ms[name][0]:.4f} ms, plain {ms[name][1]:.4f} ms ({card})")
    return {
        "remap": dict(max_abs_err=max(errs["remap"]), ms=ms["remap_xy"][0],
                      plain_ms=ms["remap_xy"][1]),
        "warp": dict(max_abs_err=max(errs["warp"]), ms=ms["warp_perspective"][0],
                     plain_ms=ms["warp_perspective"][1]),
    }


def phase_align_kernels(card, cases):
    """K3 and K1 at the panorama alignment's shapes: views 0 and 1 of the
    TRANSLATE case after the spherical pre-warp (480x640), K3 on each
    detection level of both, K1 from the ZNCC matches (init=p2), as
    find_correspondences runs them."""
    dev = torch.device(DEV)
    cfg = Config()
    half = cfg.klt_window // 2
    grays = [to_gray(warp.warp_spherical(torch.as_tensor(v, device=dev), PAN_F)).contiguous()
             for v in cases["translate"]["views"][:2]]
    n_levels = min(cfg.n_pyr_levels, 3)
    pyr_l, pyr_r = (pyramid.build_pyramid(g, max(n_levels, cfg.klt_levels)) for g in grays)
    k3 = [k3_check(f"panorama view {k} level {lvl}", pyr[lvl], cfg.fast_threshold)
          for k, pyr in enumerate((pyr_l, pyr_r)) for lvl in range(n_levels)]
    # about a quarter of the matches leave LK's 40-unit error gate (53 of
    # 70 ok in both on the CPU), so the share gate here is 60%
    p1, p2, w = find_correspondences(grays[0], grays[1], cfg, refine_lk=False)
    k1, _ = k1_track_check(f"track_pyramid from the matches, {len(pyr_l)} levels",
                           pyr_l, pyr_r, p1, w > 0, p2, cfg, min_ok=0.6)
    ms = {"corner_response": (
              cuda_ms(lambda: corners.corner_response(pyr_l[0], cfg.fast_threshold)),
              cuda_ms(lambda: corners._corner_response_plain(pyr_l[0], cfg.fast_threshold))),
          "track_level": (
              cuda_ms(lambda: lk.track_level(pyr_l[0], pyr_r[0], p1, p2, half,
                                             cfg.klt_iters, cfg.klt_eps)),
              cuda_ms(lambda: lk._track_level_plain(pyr_l[0], pyr_r[0], p1, p2, half,
                                                    cfg.klt_iters, cfg.klt_eps)))}
    for name, (kern, plain) in ms.items():
        log(f"[time] {name} at {tuple(pyr_l[0].shape)} ({p1.shape[0]} track slots): "
            f"kernel {kern:.4f} ms, plain {plain:.4f} ms ({card})")
    return {"corner_response": max(k3), "lk_track_level": k1}


K4_COUNTERS = {"remap": (warp.remap_xy, warp.remap_rows, warp.remap_cols),
               "warp": (warp.warp_perspective, warp.warp_spherical, warp.warp_cylindrical)}


def _pair_shifts(Hs):
    """[(tx, ty)] of each pair's left -> right homography, from the chain."""
    out = []
    for a, b in zip(Hs[:-1], Hs[1:]):
        P = np.linalg.inv(b.astype(np.float64)) @ a
        out.append((P[0, 2] / P[2, 2], P[1, 2] / P[2, 2]))
    return out


def check_translate(pan, out, case):
    shifts = _pair_shifts(pan.homographies_)
    for k, (tx, ty) in enumerate(shifts):
        if not (abs(tx + PAN_F * PAN_YAW) < 1.0 and abs(ty) < 1.0):
            raise AssertionError(f"pair {k}: shift ({tx}, {ty}), expected "
                                 f"({-PAN_F * PAN_YAW}, 0)")
    want_w = PAN_W + (PAN_N - 1) * PAN_F * PAN_YAW
    if not abs(out.shape[1] - want_w) < 12:
        raise AssertionError(f"canvas width {out.shape[1]}, expected {want_w}")
    # the canvas against the texture, registered through origin_: canvas
    # pixel (X, Y) is longitude (X + ox - W/2) / f, latitude (Y + oy - H/2) / f
    ox, oy = pan.origin_
    hc, wc = out.shape[:2]
    Y, X = np.mgrid[0:hc, 0:wc].astype(np.float64)
    lon = (X + ox - PAN_W / 2) / PAN_F
    lat = (Y + oy - PAN_H / 2) / PAN_F
    txy = np.stack([(lon - case["lon0"]) * PAN_F, (lat - case["lat0"]) * PAN_F], -1)
    ref, _ = warp.bilinear_sample(torch.as_tensor(case["tex"]),
                                  torch.as_tensor(txy, dtype=torch.float32))
    inner = (np.abs(lat) < 0.3) & (X > 40) & (X < wc - 40)
    got = out.cpu().numpy()[inner]
    cc = float(np.corrcoef(got.ravel(), ref.numpy()[inner].ravel())[0, 1])
    log(f"[panorama] translate: canvas {tuple(out.shape)}, origin {pan.origin_}; "
        f"max |tx + f yaw| {max(abs(tx + PAN_F * PAN_YAW) for tx, _ in shifts):.4f} px, "
        f"max |ty| {max(abs(ty) for _, ty in shifts):.4f} px; correlation with the "
        f"texture {cc:.4f}")
    if not cc > 0.95:
        raise AssertionError(f"canvas vs texture correlation {cc}")


def check_homography(pan, case):
    (w, h), K = case["wh"], case["K"]
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64).T
    worst_view, worst_canvas = 0.0, 0.0
    for k, Hk in enumerate(pan.homographies_):
        truth = synth.sphere_homography(*K, HOMO_YAW * k) @ c
        est = Hk.astype(np.float64) @ c
        canvas_err = np.linalg.norm(est[:2] / est[2] - truth[:2] / truth[2], axis=0)
        back = np.linalg.inv(Hk.astype(np.float64)) @ truth
        view_err = np.linalg.norm(back[:2] / back[2] - c[:2], axis=0)
        log(f"[panorama] homography view {k}: corner error {view_err.max():.3f} px in "
            f"the view, {canvas_err.max():.3f} px on the canvas")
        worst_view = max(worst_view, float(view_err.max()))
        worst_canvas = max(worst_canvas, float(canvas_err.max()))
    if not worst_view < 3.0:
        raise AssertionError(f"chained homography corner error {worst_view} px")
    return worst_view, worst_canvas


def phase_panorama(card, cases):
    counters = (lk.track_level, corners.corner_response) + K4_COUNTERS["remap"] + \
        K4_COUNTERS["warp"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    tc = cases["translate"]
    Panorama(focal_length=PAN_F, pan_type=PanType.TRANSLATE, feathering_width=PAN_FEATHER,
             device=DEV).process(tc["views"])                # warm-up
    pan = Panorama(focal_length=PAN_F, pan_type=PanType.TRANSLATE,
                   feathering_width=PAN_FEATHER, device=DEV)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = pan.process(tc["views"])
        float(out.mean())                                      # a host read
    wall = time.perf_counter() - t0
    log(pan.monitor.report())
    log(f"[panorama] translate: {PAN_N} views {PAN_W}x{PAN_H}x3, {reps * PAN_N / wall:.2f} "
        f"images/s ({1e3 * wall / reps:.1f} ms per panorama) ({card})")
    check_translate(pan, out, tc)

    hc = cases["homography"]
    pan_h = Panorama(feathering_width=PAN_FEATHER, device=DEV)
    t0 = time.perf_counter()
    out_h = pan_h.process(hc["views"])
    float(out_h.mean())
    wall_h = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    log(pan_h.monitor.report())
    log(f"[panorama] homography: {HOMO_N} views {hc['wh'][0]}x{hc['wh'][1]}x3 -> canvas "
        f"{tuple(out_h.shape)} in {1e3 * wall_h:.1f} ms (first run of its shapes) ({card})")
    check_homography(pan_h, hc)
    log(f"[panorama] launches {launches}; peak memory {peak / 2**20:.1f} MiB ({card})")
    groups = {"K1": launches["track_level"], "K3": launches["corner_response"],
              "K4 remap": sum(launches[c.__name__] for c in K4_COUNTERS["remap"]),
              "K4 warp": sum(launches[c.__name__] for c in K4_COUNTERS["warp"])}
    if min(groups.values()) <= 0:
        raise AssertionError(f"a kernel of the panorama path never launched: {groups}")
    if not torch.isfinite(out).all() or not torch.isfinite(out_h).all():
        raise AssertionError("non-finite canvas")
    return groups


def phase_cpu_panorama():
    """A small HOMOGRAPHY panorama on the card and on the CPU (plain
    versions), with the same RANSAC draws (Stitch draws on a CPU generator):
    same canvas shape, homography corners within 0.1 px, mean |d canvas|
    below 2e-3 (the runs differ by FMA order and LK's float sums)."""
    f, yaw, w, h = 400.0, 0.15, 320, 240
    tex = synth.sphere_texture(np.random.default_rng(SEED + 3), f, lon=(-1.2, 2 * yaw + 1.2),
                               lat=(-0.8, 0.8))
    views = [synth.render_sphere_view(tex, f, -1.2, -0.8, f, f, w / 2, h / 2, w, h, yaw * k)
             for k in range(3)]
    runs = {}
    for device in (DEV, "cpu"):
        pan = Panorama(feathering_width=20, device=device)
        runs[device] = (pan, pan.process(views).cpu())
    (pg, og), (pc, oc) = runs[DEV], runs["cpu"]
    if og.shape != oc.shape or pg.origin_ != pc.origin_:
        raise AssertionError(f"card vs CPU canvas {tuple(og.shape)} {pg.origin_} vs "
                             f"{tuple(oc.shape)} {pc.origin_}")
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64).T
    gap = 0.0
    for a, b in zip(pg.homographies_, pc.homographies_):
        ta, tb = a.astype(np.float64) @ c, b.astype(np.float64) @ c
        gap = max(gap, float(np.abs(ta[:2] / ta[2] - tb[:2] / tb[2]).max()))
    diff = float((og - oc).abs().mean())
    log(f"[reference] panorama {w}x{h} x 3 views: canvas {tuple(og.shape)} on card and "
        f"CPU; homography corners within {gap:.3g} px; mean |d canvas| {diff:.3g}")
    if not (gap < 0.1 and diff < 2e-3):
        raise AssertionError(f"card vs CPU panorama: corners {gap} px, canvas {diff}")


def main():
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    cam = Pinhole.kitti()
    t0 = time.perf_counter()
    frames, gt = render(cam, N_FRAMES, STEP, SEED, 2000)
    log(f"[setup] rendered {len(frames)} frames {frames[0].shape} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pano_cases = render_panorama_cases()
    log(f"[setup] rendered the panorama views in {time.perf_counter() - t0:.1f} s")
    results = phase_kernels(card, frames)
    results.update(phase_k4_kernels(card, pano_cases))
    for name, err in phase_align_kernels(card, pano_cases).items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    launches = phase_slice(card, frames, gt)
    phase_cpu_reference()
    pano_launches = phase_panorama(card, pano_cases)
    phase_cpu_panorama()

    # dr3_remap and dr3_warp each replace both TPU warp kernels: the
    # Catmull-Smith passes K4a and K4b compose into one direct sampler
    k4 = "dr3_tpu/ops/pallas/warp_pallas.py:83,158"
    meta = {
        "corner_response": ("dr3_tpu_torch/csrc/detect.cu",
                            "dr3_tpu/ops/pallas/detect_pallas.py:54", "corner_response"),
        "lk_track_level": ("dr3_tpu_torch/csrc/lk.cu",
                           "dr3_tpu/ops/pallas/lk_pallas.py:117", "track_level"),
        "lk_align_templates": ("dr3_tpu_torch/csrc/lk.cu",
                               "dr3_tpu/ops/pallas/lk_pallas.py:117", "align_to_templates"),
        "sample_patches": ("dr3_tpu_torch/csrc/sample.cu",
                           "dr3_tpu/ops/pallas/lk_pallas.py:338", "sample_patches"),
        "remap": ("dr3_tpu_torch/csrc/warp.cu", k4, "K4 remap"),
        "warp": ("dr3_tpu_torch/csrc/warp.cu", k4, "K4 warp"),
    }
    launches.update(pano_launches)
    kernels = []
    for name, (src, replaces, counter) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[counter],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
