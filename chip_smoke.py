#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dr3_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device  — a CUDA device must exist (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build   — compiles csrc/*.cu with nvcc for sm_90a into build/;
3. kernels — each kernel against its plain PyTorch twin on the same card,
   at its main path's shapes, with the tolerances below. Each is timed
   three ways: device time per call from torch.profiler over 100
   back-to-back calls (the plain version over 10), host-inclusive time
   with CUDA events (median of 20 runs of 10 calls after warm-up), and,
   where one PyTorch call computes the same function (K2 and K4's
   border-clamped remaps: grid_sample, bilinear, border padding, its grid
   normalised inside the timed call), that call's device time; beside
   them the bound of the call's work (dr3_tpu_torch/tools/bounds.py).
   K1-K3 at the VO path's shapes (KITTI 1240x376, 546 tracks, the whole
   4-level pyramid in one K1 launch, K3 on one level and on the three
   detection levels in one launch; K4's remap_xy as the loop database
   calls it: 546 oriented 8x8 descriptor grids on level 2 and a rotated
   query image of level 3, bit-exact); sparse alignment in one launch
   (csrc/sparse_align.cu, K2's sampler in its LM loop) against the plain
   loop at 546 slots on level 2 of frames 0 and 1-3, 12 steps: pose within
   1e-4, cost0 rtol 1e-5, n_used equal, two launches bit-equal, and the
   accept decisions of both (read off the cost after 0..12 steps); K4 (csrc/warp.cu) at the
   panorama's: the spherical and cylindrical pre-warps of a 640x480x3
   view, a 1240x376x3 view onto its pair canvas, the TRANSLATE paste (a
   pre-warped view onto the whole 8-view canvas through T @ H, as
   Panorama builds it), the row / column remaps at 376x1240 and the
   descriptor patches, bit-exact (max |d| 0, no validity flip), and the
   tiles of the two perspective warps that the kernel's whole-tile test
   writes as fill, its decisions equal to tools/warp_tiles.py's host copy;
   K3 and
   K1 again at the panorama alignment's shapes (two pre-warped 640x480
   views, their detection levels, LK from the ZNCC matches), with the VO
   shapes' gates;
4. slice   — MonoVO(Pinhole.kitti(), Config()), the users' default (loop
   closure on: every keyframe inserts into the 256-slot loop database and
   queries it), over 40 rendered frames with known ground truth: reaches
   GENERAL, >= 3 keyframes with window BA, > 100 map points, Sim(3) ATE
   under 5% of the path, every kernel launched by the run (counters zeroed
   just before), K1 once per tracked frame for the whole pyramid and once
   for the template alignment, sparse alignment once per general frame and
   K2 alone only for the template captures, K4's remap_xy exactly twice
   per keyframe (the oriented descriptors) and four times per query (the
   rotated query images); a general step is one replay of the CUDA graph
   captured on the first general frame (1 capture, one replay per later
   general step), and the launch counts above count the replays; then 6
   more frames under torch.profiler (device time per launch in a steady
   window, all kernels and device time per frame);
4b. loop  — a loop at full width: the slice's first 24 frames out and the
   same frames back (48 frames, the ground truth likewise), Config() with
   only the gates a 48-frame sequence needs set: loop_min_gap_frames 12
   (default 100, longer than the sequence), loop_cooldown_kfs 3 (5),
   loop_min_score 0.6 (0.8) and loop_min_inliers 20 (25); widths and
   capacities at their defaults. Gates: at least one closure; Sim(3) ATE
   under 5% of the path and no worse than max(1.25 x the same sequence's
   loop_closure=False run, 1% of the path); global_refine(10) gives finite
   costs with c1 <= c0 and ATE still under 5%; on the run's last window
   problem, zexplicit and pcg window BAs end within 1e-3 relative of
   explicit's final cost; two calls each of bundle_adjust (pcg, zexplicit)
   and of the frame's pose_only_adjust are bit-equal;
   then the 320x240 sequences on the card and on the CPU (plain twins): the
   lateral one with loop_closure=False and the out-and-back of
   tests/test_loop_closure.py with loop closure take the same stage and
   keyframe decisions, the same closures at the same frames, positions
   within 1% of the path;
5. panorama — Panorama.process on rendered views of a textured sphere
   (exact ground truth): (a) TRANSLATE, 8 RGB views of 640x480, f 600,
   feather 40, 0.35 rad apart: every pair's shift within 1 px of f * yaw,
   the canvas width within 12 px, the canvas correlating > 0.95 with the
   texture; (b) HOMOGRAPHY, 4 RGB views of 1240x376 with KITTI intrinsics,
   0.15 rad apart: each chained homography takes the truth's image of the
   view's corners back within 3 px of the corners; K1 (once per pair), K3
   and both K4 kernels launched (counters zeroed just before); one more
   TRANSLATE panorama under torch.profiler; then a 3-view 320x240
   panorama on the card and on the CPU with the same RANSAC draws: same
   canvas shape, homography corners within 0.1 px, mean |d canvas| < 2e-3;
6. cli — the slice's 40 frames as a KITTI-layout directory (image_0/
   %06d.png, written by a PNG writer here, and times.txt) through
   ``run_slam.main(["--seq", d, "--out", o, "--batch", "16",
   "--checkpoint-every", "20"])`` on the card: phase 4's gates on its final
   state (GENERAL, >= 3 keyframes, window BA, > 100 map points, ATE < 5%),
   trajectory.txt of 40 lines whose centres match the final state's
   positions to 1e-5, the outputs written (slam_map.png where matplotlib is
   installed; the line says where it is not); a 20-frame run's checkpoint
   (frame 19) resumed over frames 20-39 on the card and on the CPU: the
   same decisions, positions within 1% of the path; fused_frontend=False
   (eager) over the slice's frames against phase 4's graph run: the same
   decisions, positions within 1e-5 (bit-equality printed), frames/s and
   medians of both; host synchronisations per frame of a per-frame graph
   run counted by torch.cuda.set_sync_debug_mode: one on every replayed
   non-keyframe general frame (the CLI's ``--batch 16`` runs the frame
   loop: its report must time scan_dispatch and scan_fetch; phase 11
   counts the loop's synchronisations). Where neither the port's native decoder nor PIL reads
   PNGs, each run drives run_slam.run with the frames in memory and says so;
7. bal — BAL bundle adjustment (ba/snavely.py, io/bal.py, ba/lm.py,
   run_ba.py): (a) bench.py's problem (_bench_bal_ba: 120 cameras x 60,000
   points x 480,000 observations from np.random.default_rng(0) in its draw
   order, plain L2, 5 LM iterations): auto routes to zexplicit, the cost at
   the true parameters and the initial cost within 1e-4 of the JAX
   package's, zexplicit accepts 5 of 5 and ends within 1e-3 of JAX's
   97,681.25 and at or below the true parameters' cost, pcg (cg_tol 1e-5,
   q_eta 0) within 1e-4 of zexplicit, two zexplicit runs bit-equal, each
   launching the co-visible block kernels (csrc/schur.cu) once per LM
   iteration; bench.py's
   ba_bal_lm_iters_per_sec for zexplicit and pcg (its default forcing, with
   the CG iterations), the peak device memory, and a zexplicit and a pcg LM
   iteration's device time by stage from the program's own ``dr3.ba.*``
   spans in one profiled solve each (``bal_split``, torch's own events);
   (b) the card against the CPU (same accepted steps, costs within 1e-4,
   cameras and the points seen twice within 1e-3 of their scale): pcg at 16
   x 8,000 x 800 per camera, zexplicit at 16 x 8,000 x 1,600 (at 800 per
   camera it is printed: 40% of the points have one observation, see
   PERF.md); (c) phase 4's MonoVO exported to a BAL file
   (tools/make_real_bal.export_bal) and run through ``run_ba.main`` for
   zexplicit, pcg and the pinhole model with intrinsics: the cost falls,
   ``--out`` reloads with the same counts, zexplicit within 1e-3 of pcg
   through the library (cg_tol 1e-5, q_eta 0); (d) ``least_squares`` on
   Powell's function (cost below 1e-8) and the plain and robust curve fits
   of tests/test_lm_bal.py, within 1e-4 of the port's CPU results. After
   it, the BAL kernels' rows: csrc/schur.cu at bal-dubrovnik-88's shapes
   (``phase_schur_kernel``), then csrc/schur_mv.cu, the generic PCG's
   operator S p, at bal-ladybug-1723's counts (``phase_schur_mv``: within
   1e-6 of its plain version on the card, bit-equal repeats, two launches
   a CG iteration of a 2-iteration auto solve).

8. legacy, two-view, distributed — (a) LegacySLAM(Pinhole.kitti(),
   Config(fast_threshold=8.0, cell_size=12)) over the slice's first 10
   frames (tests/test_slam_legacy.py's settings at KITTI width: 3,328
   candidates a frame): per frame after the first more than 40 matches, 25
   F inliers and 15 good triangulations, rotation within 1 degree of the
   truth's relative motion, translation direction within 30 degrees; more
   than 50 map points, one seen 3 times; K3's pyramid form once per frame,
   K1's track_level once per frame after the first and K4's remap_xy (the
   descriptors) once per frame (counters zeroed just before); 4 frames on
   the card and on the CPU with the same draws (one CPU generator): counts
   within 2%, rotations within 0.1 degree; K1 (3,328 tracks on level 0,
   W=11 x 8) against its plain version over every track ok in both (at
   most 1% end more than 1e-2 px apart, and each of those has its basin
   decided by round-off: the plain version in float64, or from a start
   1e-3 px away, moves it more than 1e-2 px or changes its ok), within
   1e-2 px where the path takes the polish, and K3 (the three detection
   levels at threshold 8) against its plain version; both timed, two
   more frames under torch.profiler;
   (b) run_twoview.main --init --map on frames 0 and 8 written as PNGs:
   more than 100 F inliers, the bootstrap succeeds, rotation within 1
   degree of the truth, both renderings written or the line saying
   matplotlib is absent; (c) dist_bundle_adjust over a world-size-1 NCCL
   group (a FileStore in a temporary directory) on phase 4's last window
   and phase 4b's global problem, moved off the optimum, 8 LM iterations:
   make_mesh(4) against make_mesh(1) (initial cost 1e-5, final 1e-4
   relative), make_mesh(1) against bundle_adjust(solver="explicit") (1e-5,
   1e-3), two make_mesh(4) runs bit-equal, each call's wall time; (d)
   ``run_slam.main([..., "--distributed"])`` over the slice's 40 frames on
   the card (one process: a one-shard mesh): phase 4's gates, the
   decisions of the same CLI without --distributed on the same 8-bit
   PNGs, positions within 5e-3 of that run's and of phase 4's.

9. long sequence — ``run_long_sequence.main`` (dr3_tpu_torch/tools/, the
   JAX tool's Config) on the card: (a) ``--kitti-res --profile lateral``,
   400 frames batched by 8, the map capacity cut to ``--max_points=1536``
   (the tool's 8192 fills too slowly: see LONG_MAX_POINTS): at least one
   map compaction, one ring compaction of the 64-slot loop database (more
   keyframes made than slots) and one closure; ends in GENERAL with ATE
   under 5% of the path; one frame-loop program (phase 11; no per-frame
   step graph captured) and a peak device memory that does not grow after
   the first compaction; K1 (pyramid and
   alignment), K2 (sparse alignment once per general frame, the template
   captures), K3's pyramid form and K4's remap_xy launched (counters zeroed
   just before); every loop edge on live database slots and every point id
   of the tracks, the database and the keyframes on a live map point; then
   three blank frames through the loop: one relocalization (database and
   loop edges emptied), and the sweep's first 40 frames bootstrap again and
   end in GENERAL, launching the same loop program (no new one), every
   pose finite; (b)
   ``--kitti-res --profile forward``, 240 frames, through the rotation-only
   segment: every pose finite, at least 10 keyframes, ATE and
   relocalizations printed; (c) the lateral sweeps' first 140 frames at
   320x240, frame by frame on the card and on the CPU (plain versions):
   the same decisions, the same closures at the same frames (at least
   one), positions within 1% of the path. Each part prints its frames/s,
   ATE and counters.

10. entry points — the root ``__graft_entry__.py`` and ``bench.py`` as the
   port runs them (dr3_tpu_torch/entry.py, dr3_tpu_torch/bench.py),
   counters zeroed just before: (a) ``entry()``'s step on the card
   against the same step on the CPU with the same numpy args
   (tests/test_torch_entry.py's tolerances: pyramid 1e-6, valid masks
   equal, positions of valid tracks 1e-3 px, pose 1e-4, cost 1e-4
   relative), K1 once per call; the same on two rendered 1240x376 frames
   of the lateral path (pose 1e-5, over 90% of 546 tracks valid, the pose
   within 1e-2 of the rendered motion); then 120 frames chained as the
   bench's frontend metric chains them in one StepGraph: one capture, 119
   replays, K1 120 launches, the first 8 frames against the eager step
   within 1e-4 px; (b) ``dryrun_multichip(1)`` and ``(4)`` in this process
   on this card (4 point shards, the 2-level mesh, MonoVO with the mesh
   against one device); (c) ``python -m dr3_tpu_torch.bench`` as a
   subprocess at full width, depth cut to BENCH_DEPTH: exit code 0, one
   JSON line in bench.py's contract, all five metrics non-null, no errors,
   each child's kernels launched in its timed window (BENCH_PATHS), the
   frontend's one capture and its replay count; the pipeline's
   ``fps_device_bound`` non-null with ``device_bound_event_free`` true and
   its stage breakdown holding scan_dispatch / scan_fetch; the line is
   printed.

11. scan — the device-resident frame loop (``MonoVO.process_batch``: one
   CUDA graph program per image shape and batch width, its branches and
   window BA's CG loop conditional nodes; pipelines/vo.py ``_ScanProgram``,
   csrc/graph_loop.cu) against per-frame ``process`` on the card, counters
   zeroed before each run, over (a) phase 4's 40 frames under Config(),
   (b) phase 4b's 48-frame out-and-back (a loop candidate early-outs to
   the host) and (c) 13 of phase 4's frames, four black frames and 15
   more (a relocalisation mid-batch): the same decisions, keyframes,
   closures at the same frames and relocalisations, positions within
   1e-5 of the path (bit-equality printed), the same window BAs and CG
   iterations, equal launch counts for every kernel (the program's warm-up
   launches, its set-up, taken out), one program instantiated per run, no
   keyframe handed to the host for its window BA (no mesh); (d)
   host synchronisations per ``process_batch`` call of 16 frames after the
   first, counted by torch.cuda.set_sync_debug_mode: exactly one per
   event-free batch (no read per keyframe or per CG iteration); (e) the
   dense window solves, ``Config(ba_solver=...)`` "zexplicit" and
   "explicit", over (a)'s frames: (a)'s gates with bit-equal positions,
   window BAs inside the loop (the dense camera step and its Cholesky in
   the program's LM pieces) and no CG iteration, then (d) over the same
   frames out and back, with at least one event-free batch holding a
   window BA that synchronised once. A program that fails to build,
   capture or launch raises. The whole smoke's wall time is its ``[done]``
   line.

The kernel table (launches per general frame or per panorama, the VO rows
also per general frame of phase 9(a), device us, bound, share of bound,
library us; the legacy path's two rows per legacy frame; the co-visible
kernels ``dr3_schur_factor`` and ``dr3_schur_blocks`` at bal-dubrovnik-88's
shapes, each output within 1e-5 of its plain version's, the block kernel's
library call the replaced dense ``Z.T @ Z``, after phase 7; ``dr3_schur_mv``
at bal-ladybug-1723's, its library call the two replaced einsums) and the legacy
path's launches are printed before the last three lines of stdout: a JSON
object of per-kernel results (launches: phases 4, 5, 9(a) and 10 together;
K4's ``remap`` timed at the descriptor patches, ``warp`` at the pair
canvas; the paste is a row of the table only; the BAL kernels' from phase
7(a)'s solve, counted from zero), the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
dr3_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from dr3_tpu_torch import bench  # noqa: E402
from dr3_tpu_torch import entry as entry_mod  # noqa: E402
from dr3_tpu_torch.geometry.lie import SE3  # noqa: E402
from dr3_tpu_torch.io.image import to_gray  # noqa: E402
from dr3_tpu_torch.models.camera import Pinhole  # noqa: E402
from dr3_tpu_torch.ops import _native, corners, lk, match, pyramid, warp  # noqa: E402
from dr3_tpu_torch.ops import sparse_align as sa  # noqa: E402
from dr3_tpu_torch.pipelines.panorama import Panorama, PanType  # noqa: E402
from dr3_tpu_torch.pipelines.stitch import find_correspondences  # noqa: E402
from dr3_tpu_torch.ba.schur_lm import bundle_adjust  # noqa: E402
from dr3_tpu_torch.pipelines import loop_closure as lc  # noqa: E402
from dr3_tpu_torch.pipelines import vo as vo_mod  # noqa: E402
from dr3_tpu_torch.pipelines.vo import MonoVO, Stage  # noqa: E402
from dr3_tpu_torch.tools import bounds, warp_tiles  # noqa: E402
from dr3_tpu_torch.tools import run_long_sequence as long_seq  # noqa: E402
from dr3_tpu_torch.tools.cudatime import cuda_ms, device_ms, per_launch, profile  # noqa: E402
from dr3_tpu_torch.utils import synth  # noqa: E402
from dr3_tpu_torch.utils.config import Config  # noqa: E402
from dr3_tpu_torch.utils.cudagraph import StepGraph  # noqa: E402
from dr3_tpu_torch.utils.synth import lateral_path, make_textures, render_scene  # noqa: E402
from dr3_tpu_torch.viz.ate import ate_rmse  # noqa: E402

SEED = 0
N_FRAMES = 40
N_OUT = 24           # phase 4b: frames out, then the same frames back
# phase 4b's gates for a 48-frame out-and-back (the rest of Config() default)
LOOP_GATES = dict(loop_min_gap_frames=12, loop_cooldown_kfs=3, loop_min_score=0.6,
                  loop_min_inliers=20)
N_PROFILED = 6       # frames after the slice's 40, run under torch.profiler
STEP = 0.08          # scene units per frame (near plane at depth 6)
# panorama (a): bench.py's configuration (8 views, f 600, feather 40)
PAN_N, PAN_W, PAN_H, PAN_F, PAN_YAW, PAN_FEATHER = 8, 640, 480, 600.0, 0.35, 40
# panorama (b): KITTI intrinsics. At 0.3 rad apart the ZNCC matches of a
# pair fail (in the JAX package too) and the last view's edge turns past
# 90 degrees from view 0; at 0.15 the chained homographies hold their
# corners within 2.69 px over 4 texture seeds (PERF.md), gated at 3 px
HOMO_N, HOMO_YAW = 4, 0.15
# phase 7: bench.py's BAL problem (_bench_bal_ba: cameras, points, observations
# per camera) and the card-vs-CPU shapes; the anchors are the JAX package's on
# the CPU (highest matmul precision, bench.py's draws): at bench.py's shape
# the cost at the true parameters, the initial cost, zexplicit's after 5 LM
# iterations
BAL_FULL, BAL_SMALL, BAL_OVERLAP = (120, 60000, 4000), (16, 8000, 800), (16, 8000, 1600)
BAL_TRUE_COST, BAL_INITIAL_COST, BAL_JAX_FINAL = 120035.73, 2978184.0, 97681.25
BAL_SMALL_JAX_ZEXPLICIT = 601.6403          # zexplicit's 5 iterations at BAL_SMALL
# phase 8(a): the legacy SLAM over the slice's first frames, and the card
# against the CPU over fewer
LEGACY_N, LEGACY_CPU_N = 10, 4
# phase 9: the long-sequence entry point's frames: (a) the lateral sweeps at
# 1240x376, (b) the forward corridor at 1240x376, (c) the lateral sweeps at
# 320x240 on the card and on the CPU (past the first closure, at frame 130)
LONG_LATERAL, LONG_FORWARD, LONG_CPU = 400, 240, 140
# (a)'s map capacity: at the tool's 8192 no map compaction comes within 480
# frames (1,082 points for 170 keyframes: the sweeps revisit one scene, so a
# keyframe spawns ~6 points); at 1536 the cursor passes 1536 - 546 track
# slots near frame 345 and the compaction frees the points the third ring
# compaction let go (PERF.md, section 6)
LONG_MAX_POINTS = 1536
# the kernel wrappers the long run reaches (the graph adds its replays' share)
LONG_COUNTERS = (lk.track_pyramid, lk.track_level, lk.align_to_templates, lk.sample_patches,
                 sa.sparse_align, corners.corner_response_pyramid, corners.corner_response,
                 warp.remap_xy)
# phase 10: entry()'s step chained as bench.py's frontend metric chains it,
# and the port bench at full width with its depth cut to fit this run
ENTRY_CHAIN = 120
ENTRY_EAGER = 8      # the chain's first frames, run eagerly against the graph
BENCH_DEPTH = dict(BENCH_FRAMES="30", BENCH_REPS="3", BENCH_PIPELINE_FRAMES="160")
# the kernels each bench metric's timed window must launch (wrapper names;
# the BA metrics run none)
BENCH_PATHS = {"frontend": ("track_pyramid",),
               "pipeline": ("track_pyramid", "align_to_templates", "sparse_align",
                            "sample_patches", "corner_response_pyramid", "remap_xy"),
               "panorama": ("track_pyramid", "corner_response_pyramid", "remap_xy",
                            "warp_spherical", "warp_perspective")}
DEV = "cuda"
# the kernels' names in a profile: kernel or K4 form -> its __global__
KERNEL_NAMES = {"lk_pyramid": "lk_pyramid_kernel", "lk_align": "lk_align_kernel",
                "sample_patches": "sample_patches_kernel",
                "sparse_align": "sparse_align_kernel",
                "corner_response": "corner_response_kernel",
                "remap_xy": "remap_xy_kernel", "remap_rows": "remap_rows_kernel",
                "remap_cols": "remap_cols_kernel",
                "warp_perspective": "warp_homography_kernel",
                "warp_spherical": "warp_spherical_kernel",
                "warp_cylindrical": "warp_cylindrical_kernel"}


def log(*a):
    print(*a, flush=True)


def measure(kernel, plain, library=None, bound=None, n_plain=10, **extra) -> dict:
    """A kernel row: device ms per call of the kernel's wrapper, of its
    plain version and of the one PyTorch call that computes the same
    function (torch.profiler, all device work of the call; ``library``
    None where there is none), the kernel's and the plain version's
    host-inclusive ms (CUDA events, median of 20 runs of 10 calls), and
    the bound of the call's work (tools/bounds.py)."""
    ms, how = device_ms(kernel, n=100)
    plain_ms, _ = device_ms(plain, n=n_plain)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=None, host_ms=cuda_ms(kernel),
               plain_host_ms=cuda_ms(plain, reps=5 if n_plain < 100 else 20),
               timed_by=how, **(bound or {}), **extra)
    if library is not None:
        row["library_ms"] = device_ms(library, n=100)[0]
    row["share"] = row["bound_ms"] / ms if bound else None
    return row


def log_row(name, r, card):
    lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f} us"
    steps = f", {r['steps']} GN steps" if "steps" in r else ""
    if "survivors" in r:
        steps = (f", {r['candidates']} candidates, {r['scored']} scored, {r['survivors']} "
                 f"survivors of {r['pixels']} pixels")
    log(f"[time] {name}: device {1e3 * r['ms']:.2f} us ({r['timed_by']}), bound "
        f"{1e3 * r['bound_ms']:.3f} us by {r['bound_by']} ({r['bytes']} B, {r['ops']} ops"
        f"{steps}), "
        f"share {100 * r['share']:.1f}%, library {lib}; plain device {1e3 * r['plain_ms']:.2f} "
        f"us; host-inclusive kernel {r['host_ms']:.4f} ms, plain {r['plain_host_ms']:.4f} ms "
        f"({card})")


def grid_sample_patches(img, centers, half):
    """The library yardstick of K2: the [N, W, W] border-clamped bilinear
    patches by one grid_sample call, its grid normalised inside."""
    h, w = img.shape
    scale = img.new_tensor([2.0 / (w - 1), 2.0 / (h - 1)])
    base = lk._patch_coords(img.new_zeros(1, 2), half)[0] * scale - 1.0    # [W, W, 2]
    W = 2 * half + 1
    n = centers.shape[0]

    def call():
        grid = torch.addcmul(base, centers[:, None, None, :], scale)
        out = torch.nn.functional.grid_sample(img[None, None], grid.view(1, n, W * W, 2),
                                              mode="bilinear", padding_mode="border",
                                              align_corners=True)
        return out.view(n, W, W)
    return call


def grid_sample_xy(img, make_grid):
    """The library yardstick of a border-clamped remap: one grid_sample
    call over the grid make_grid() normalises, [Ho, Wo] out."""
    def call():
        grid = make_grid()
        out = torch.nn.functional.grid_sample(img[None, None], grid[None], mode="bilinear",
                                              padding_mode="border", align_corners=True)
        return out[0, 0]
    return call


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


def k3_pyramid_check(tag, levels, threshold) -> float:
    """K3's one launch over ``levels``: each level bit-equal to its own
    launch, hence within k3_check's gates of the plain version."""
    got = corners.corner_response_pyramid(levels, threshold)
    torch.cuda.synchronize()
    err = 0.0
    for lvl, (img, g) in enumerate(zip(levels, got)):
        if not torch.equal(g, corners.corner_response(img, threshold)):
            raise AssertionError(f"K3 {tag}: level {lvl} differs from its own launch")
        want = corners._corner_response_plain(img, threshold)
        if not torch.equal(g > 0, want > 0):
            raise AssertionError(f"K3 {tag}: level {lvl} corner sets differ")
        torch.testing.assert_close(g, want, rtol=2e-3, atol=0.05)
        err = max(err, float((g - want).abs().max()))
    log(f"[K3] {tag}: {len(levels)} levels in one launch, each equal to its own launch; "
        f"max |d score| {err:.3g}")
    return err


def align_decisions(fn, iters) -> str:
    """The accept decisions of an LM run, read off its public result: step k
    was accepted ("A") iff the cost after k steps is below the cost after
    k - 1, else refused ("r")."""
    costs = [float(fn(k).cost) for k in range(iters + 1)]
    return "".join("A" if b < a else "r" for a, b in zip(costs, costs[1:]))


def sparse_align_check(tag, args, iters) -> float:
    """dr3_sparse_align against the plain loop on the same inputs: n_used
    equal, cost0 rtol 1e-5, pose within 1e-4, two launches bit-equal;
    returns max |d pose|. Prints both runs' accept decisions."""
    got = sa.sparse_align(*args, iters=iters)
    again = sa.sparse_align(*args, iters=iters)
    want = sa._sparse_align_plain(*args, iters)
    torch.cuda.synchronize()
    for a, b in zip((got.T.wxyz, got.T.t, got.cost0, got.cost, got.n_used),
                    (again.T.wxyz, again.T.t, again.cost0, again.cost, again.n_used)):
        if not torch.equal(a, b):
            raise AssertionError(f"sparse_align {tag}: two launches differ")
    if int(got.n_used) != int(want.n_used):
        raise AssertionError(f"sparse_align {tag}: n_used {int(got.n_used)} vs "
                             f"{int(want.n_used)}")
    torch.testing.assert_close(got.cost0, want.cost0, rtol=1e-5, atol=0.0)
    err = max(float((got.T.wxyz - want.T.wxyz).abs().max()),
              float((got.T.t - want.T.t).abs().max()))
    if not err < 1e-4:
        raise AssertionError(f"sparse_align {tag}: max |d pose| {err}")
    dk = align_decisions(lambda k: sa.sparse_align(*args, iters=k), iters)
    dp = align_decisions(lambda k: sa._sparse_align_plain(*args, k), iters)
    differ = sum(a != b for a, b in zip(dk, dp))
    log(f"[K2] sparse_align {tag}: n_used {int(got.n_used)}, cost0 {float(got.cost0):.6f} "
        f"(plain {float(want.cost0):.6f}), cost {float(got.cost):.6f} (plain "
        f"{float(want.cost):.6f}), max |d pose| {err:.3g}; decisions kernel {dk} plain {dp}: "
        f"{differ} of {iters} differ; t {[round(v, 5) for v in got.T.t.tolist()]}")
    return err


def k1_track_check(tag, pyr0, pyr1, pts, valid, init, cfg, min_ok=0.8):
    """K1's track_pyramid (from ``init``, or from pts) against the plain
    loop: at least ``min_ok`` of the valid tracks ok in both, |d pos| <
    1e-2 px where both are ok; returns (max |d pos|, the kernel's
    TrackResult)."""
    half = cfg.klt_window // 2
    res = lk.track_pyramid(pyr0, pyr1, pts, valid, init=init, half_window=half,
                           iters=cfg.klt_iters, eps=cfg.klt_eps)
    pos_p, ok_p, _ = lk._track_pyramid_plain(pyr0, pyr1, pts, valid, init, half,
                                             cfg.klt_iters, cfg.klt_eps, 40.0)
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
    det = pyr0[:cfg.n_pyr_levels]
    errs.append(k3_pyramid_check("detection levels", det, cfg.fast_threshold))
    for lvl, img in enumerate(det):
        b = bounds.k3_corners([img], cfg.fast_threshold)
        log(f"[K3] level {lvl}: of {b['pixels']} pixels {b['candidates']} pass the half-ring "
            f"test ({100 * b['candidates'] / b['pixels']:.2f}%), {b['scored']} have a FAST "
            f"score ({100 * b['scored'] / b['pixels']:.2f}%), {b['survivors']} survive the NMS "
            f"({100 * b['survivors'] / b['pixels']:.2f}%); {b['ops'] / b['pixels']:.1f} "
            f"operations a pixel")
    out["corner_response"] = measure(
        lambda: corners.corner_response(pyr0[0], cfg.fast_threshold),
        lambda: corners._corner_response_plain(pyr0[0], cfg.fast_threshold),
        bound=bounds.k3_corners(pyr0[:1], cfg.fast_threshold), max_abs_err=max(errs),
        shape=f"{tuple(pyr0[0].shape)}")
    out["corner_response_pyramid"] = measure(
        lambda: corners.corner_response_pyramid(det, cfg.fast_threshold),
        lambda: [corners._corner_response_plain(img, cfg.fast_threshold) for img in det],
        bound=bounds.k3_corners(det, cfg.fast_threshold), max_abs_err=max(errs),
        shape=f"{len(det)} levels of {tuple(pyr0[0].shape)}")

    # tracks: the detected grid corners of frame 0 (546 slots at KITTI size)
    feats = corners.detect_features(pyr0[:cfg.n_pyr_levels], cfg.cell_size,
                                    cfg.min_corner_score, cfg.fast_threshold)
    pts, valid = feats.xy.contiguous(), feats.valid
    n = pts.shape[0]
    half = cfg.klt_window // 2
    log(f"[K1] {n} track slots, {int(valid.sum())} corners, W={2 * half + 1}")

    # K1 over the 4-level pyramid in one launch: >= 80% ok in both, |d pos| < 1e-2
    err_a, res = k1_track_check("track_pyramid", pyr0, pyr1, pts, valid, None, cfg)
    bound = bounds.k1_pyramid(pyr0, pyr1, pts, None, half, cfg.klt_iters, cfg.klt_eps)
    log(f"[K1] GN steps run (the plain version's freeze flags): {bound['steps']} over {n} "
        f"tracks x {len(pyr0)} levels ({bound['steps'] / n / len(pyr0):.2f} per track and "
        f"level of {cfg.klt_iters})")
    out["lk_pyramid"] = measure(
        lambda: lk.track_pyramid(pyr0, pyr1, pts, valid, half_window=half,
                                 iters=cfg.klt_iters, eps=cfg.klt_eps),
        lambda: lk._track_pyramid_plain(pyr0, pyr1, pts, valid, None, half, cfg.klt_iters,
                                        cfg.klt_eps, 40.0),
        bound=bound,
        max_abs_err=err_a, shape=f"{n} tracks, {len(pyr0)} levels of {tuple(pyr0[0].shape)}")
    guess = pts.clone()
    lvl0, _ = device_ms(lambda: lk.track_level(pyr0[0], pyr1[0], pts, guess, half,
                                               cfg.klt_iters, cfg.klt_eps))
    log(f"[time] track_level (level 0 alone, the same kernel): device {1e3 * lvl0:.2f} us "
        f"({card})")

    # K1 template alignment: W=9, 8 iterations, same tolerance
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
    out["lk_align"] = measure(
        lambda: lk.align_to_templates(pyr1[0], templates, start, ok_in,
                                      iters=cfg.feature_align_iters),
        lambda: lk._align_to_templates_plain(pyr1[0], templates, start, ok_in,
                                             cfg.feature_align_iters, 1e-2, 30.0, 4.0),
        bound=bounds.k1_align(pyr1[0], templates, start, cfg.feature_align_iters, 1e-2),
        max_abs_err=err_b, shape=f"{n} templates of {2 * thalf + 1}x{2 * thalf + 1}")

    # K2 on the level-2 image: W=5 and W=7 (sparse alignment), atol 1e-5;
    # the library yardstick agrees to grid_sample's normalisation round-off
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
    library = grid_sample_patches(img2, centers, h5)
    log(f"[K2] grid_sample yardstick: max |d| "
        f"{float((library() - lk.sample_patches(img2, centers, h5)).abs().max()):.3g}")
    out["sample_patches"] = measure(
        lambda: lk.sample_patches(img2, centers, h5),
        lambda: lk._sample_patches_plain(img2, centers, h5), library=library,
        bound=bounds.k2_sample(img2, centers, h5), n_plain=100, max_abs_err=max(errs),
        shape=f"{n} patches of {2 * h5 + 1}x{2 * h5 + 1} on {tuple(img2.shape)}")
    # sparse alignment in one launch: frame 0's corners on the scene's planes
    # (frame 0 stands at the world origin), aligned into frames 1-3 from the
    # reference pose, as the VO step starts it; level 2, W=5, 12 steps
    kitti = Pinhole.kitti(device=dev)
    world = torch.as_tensor(synth.scene_points(kitti, synth.NpSE3.exp(np.zeros(6)),
                                               pts.cpu().numpy()), device=dev)
    ident = SE3.identity(device=dev)
    lvl = cfg.align_level

    def align_args(k):
        cur = pyramid.build_pyramid(torch.as_tensor(frames[k], device=dev), lvl + 1)[lvl]
        return (pyr0[lvl], cur, ident, ident, kitti, world, valid, lvl, h5)

    errs = [sparse_align_check(f"frames 0 -> {k}, {n} slots on {tuple(pyr0[lvl].shape)}",
                               align_args(k), cfg.align_iters) for k in (1, 2, 3)]
    a1 = align_args(1)
    final = sa.sparse_align(*a1, iters=cfg.align_iters).T
    out["sparse_align"] = measure(
        lambda: sa.sparse_align(*a1, iters=cfg.align_iters),
        lambda: sa._sparse_align_plain(*a1, cfg.align_iters),
        bound=bounds.k2_sparse_align(a1[0], a1[1], ident, ident, final, kitti, world, lvl, h5,
                                     cfg.align_iters),
        n_plain=3, max_abs_err=max(errs),
        shape=f"{n} points of {2 * h5 + 1}x{2 * h5 + 1} on {tuple(a1[1].shape)}, "
              f"{cfg.align_iters} LM steps")
    for name, r in out.items():
        log_row(name, r, card)
    return out


def loop_descriptor_coords(img, xy, cfg):
    """The first (unrotated) sampling grid of make_entry's descriptors: the
    track pixels on level ``cfg.loop_desc_level``, cfg.loop_desc_patch
    samples a side, loop_desc_spread full-res px apart (ops/match.py)."""
    scale = 1.0 / 2 ** cfg.loop_desc_level
    p = cfg.loop_desc_patch
    off = (torch.arange(p, dtype=torch.float32, device=img.device) - p // 2 + 0.5) \
        * (cfg.loop_desc_spread * scale)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    return ((xy * scale)[:, None, None, :] + torch.stack([ox, oy], -1)[None]).contiguous()


def loop_rotation_field(img, deg):
    """query_thumbnails' field: the coarse image rotated by ``deg`` degrees
    about its centre."""
    h, w = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    c, s = float(np.cos(np.deg2rad(deg))), float(np.sin(np.deg2rad(deg)))
    x0, y0 = xs - cx, ys - cy
    return torch.stack([c * x0 - s * y0 + cx, s * x0 + c * y0 + cy], -1).contiguous()


def phase_loop_kernels(card, frames):
    """K4's remap_xy at the VO path's loop-database shapes: the descriptor
    grids of frame 1's 546 track slots on pyramid level 2 (94x310) and a
    6-degree query rotation of level 3 (47x155), both edge-clamped,
    bit-exact against the plain version; timed beside grid_sample."""
    dev = torch.device(DEV)
    cfg = Config()
    pyr = pyramid.build_pyramid(torch.as_tensor(frames[1], device=dev), cfg.klt_levels)
    feats = corners.detect_features(pyr[:cfg.n_pyr_levels], cfg.cell_size,
                                    cfg.min_corner_score, cfg.fast_threshold)
    img2, img3 = pyr[cfg.loop_desc_level], pyr[-1]
    cases = {"remap_xy (loop descriptors)": (img2, loop_descriptor_coords(img2, feats.xy, cfg)),
             "remap_xy (loop query rotation)": (img3, loop_rotation_field(
                 img3, cfg.loop_query_rot_step_deg))}
    rows, err = {}, 0.0
    for name, (img, xy) in cases.items():
        got, gv = warp.remap_xy(img, xy, clamp=True)
        want, wv = warp.bilinear_sample(img, xy, clamp=True)
        err = max(err, k4_check(f"{name} {tuple(xy.shape[:-1])} on {tuple(img.shape)}",
                                got, want, gv, wv))
        h, w = img.shape
        scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=dev)
        neg_one = torch.full((2,), -1.0, device=dev)
        flat = xy.view(1, -1, 2) if xy.dim() == 4 else xy
        library = grid_sample_xy(img, lambda flat=flat: torch.addcmul(neg_one, flat, scale))
        log(f"[K4] {name} grid_sample yardstick: max |d| "
            f"{float((library().reshape(want.shape) - want).abs().max()):.3g}")
        rows[name] = measure(lambda img=img, xy=xy: warp.remap_xy(img, xy, clamp=True),
                             lambda img=img, xy=xy: warp.bilinear_sample(img, xy, clamp=True),
                             library=library,
                             bound=bounds.k4_remap(img, xy[..., 0], xy[..., 1],
                                                   4 * xy.numel(), True),
                             shape=f"{tuple(xy.shape[:-1])} on {tuple(img.shape)}")
    for name, r in rows.items():
        log_row(name, r, card)
    return rows, err


def phase_slice(card, frames, gt, profiled):
    """The VO slice over ``frames`` (counted, timed, gated), then the
    ``profiled`` frames that follow under torch.profiler: device time per
    launch of each kernel in that steady window."""
    cfg = Config()
    vo = MonoVO(Pinhole.kitti(), cfg, device="cuda")
    counters = (lk.track_pyramid, lk.track_level, lk.align_to_templates,
                lk.sample_patches, sa.sparse_align, corners.corner_response_pyramid,
                corners.corner_response, warp.remap_xy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    frame_s, parts = [], []

    def timer_total(name):
        t = vo.monitor.timers.get(name)
        return t.total if t else 0.0

    for f in frames:
        g0, s0 = timer_total("global"), timer_total("frame_step")
        t0 = time.perf_counter()
        vo.process(f)
        frame_s.append(time.perf_counter() - t0)
        # (upload and conversion before "global", the general step with its
        # read, the rest of the driver)
        g, st = timer_total("global") - g0, timer_total("frame_step") - s0
        parts.append((frame_s[-1] - g, st, g - st))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    positions = vo.positions()

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
        f"iterations (host syncs) {vo.n_cg_iters}, map points {int(vo.map.n)}, loop "
        f"database {vo.db_cursor} of {cfg.loop_db_capacity} slots, closures "
        f"{vo.n_loop_closures}")
    log(f"[slice] loop_closure stage (insert + query per keyframe): "
        f"{vo.monitor['loop_closure'].n} calls, {1e3 * vo.monitor['loop_closure'].average:.3f} "
        f"ms avg; local_BA {vo.monitor['local_BA'].n} calls, "
        f"{1e3 * vo.monitor['local_BA'].average:.3f} ms avg ({card})")
    log(f"[slice] launches {launches}")
    log(f"[slice] general frames: {n_general}, {n_general / sum(gen_s):.2f} frames/s; "
        f"non-keyframe median {1e3 * statistics.median(gen_plain):.2f} ms, "
        f"keyframe median {1e3 * statistics.median(gen_kf) if gen_kf else float('nan'):.2f} ms; "
        f"peak memory {peak / 2**20:.1f} MiB ({card})")
    # a general step is one CUDA graph: captured on the first, replayed after
    n_steps = stages.count("general") + stages.count("relocalize")
    graphs = list(vo.graphs.values())
    if len(graphs) != 1 or (graphs[0].captures, graphs[0].replays) != (1, n_steps - 1):
        raise AssertionError(f"graphs {[(g.captures, g.replays) for g in graphs]} for "
                             f"{n_steps} general steps")
    log(f"[slice] the general step: 1 capture, {graphs[0].replays} replays of its CUDA graph "
        f"for {n_steps} general steps")

    if vo.stage is not Stage.GENERAL:
        raise AssertionError(f"slice ended in {vo.stage}")
    if vo.kf_count < 3 or vo.n_window_ba < 1:
        raise AssertionError(f"keyframes {vo.kf_count}, window BA {vo.n_window_ba}")
    if not int(vo.map.n) > 100:
        raise AssertionError(f"map points {int(vo.map.n)}")
    # K1 once per tracked frame (every stage but "first") for the whole
    # pyramid, and once more for the template alignment
    n_tracked = sum(st != "first" for st in stages)
    one_level = ("track_level", "corner_response")      # the path runs their pyramid forms
    if min(v for k, v in launches.items() if k not in one_level) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    # one sparse-alignment launch per general step, with K2's sampler inside:
    # sample_patches alone is left with the template captures of the keyframes
    n_aligned = stages.count("general") + stages.count("relocalize")
    if launches["sparse_align"] != n_aligned:
        raise AssertionError(f"sparse alignment launched {launches['sparse_align']} times "
                             f"for {n_aligned} general steps")
    if not launches["sample_patches"] <= 2 * vo.kf_count + 1:
        raise AssertionError(f"K2 alone launched {launches['sample_patches']} times for "
                             f"{vo.kf_count} keyframes")
    if launches["corner_response"] != 0:
        raise AssertionError(f"K3 launched per level: {launches}")
    if (launches["track_pyramid"], launches["track_level"]) != (n_tracked, 0):
        raise AssertionError(f"K1's pyramid launched {launches['track_pyramid']} times "
                             f"(and track_level {launches['track_level']}) for "
                             f"{n_tracked} tracked frames")
    if launches["align_to_templates"] != n_tracked:
        raise AssertionError(f"K1's alignment launched {launches['align_to_templates']} "
                             f"times for {n_tracked} tracked frames")
    # K4 in the loop database: the oriented descriptors sample twice per
    # keyframe entry (bootstrap's two included), each general keyframe's
    # query resamples the coarse image once per extra rotation
    n_entries = sum(s.is_keyframe for s in vo.stats)
    n_queries = sum(s.is_keyframe and s.stage == "general" for s in vo.stats)
    want_remap = 2 * n_entries + (cfg.loop_query_rotations - 1) * n_queries
    if launches["remap_xy"] != want_remap or vo.db_cursor != n_entries:
        raise AssertionError(f"remap_xy launched {launches['remap_xy']} times for "
                             f"{n_entries} entries and {n_queries} queries (want {want_remap}); "
                             f"database cursor {vo.db_cursor}")
    log(f"[slice] K4 remap_xy: {launches['remap_xy']} launches = 2 x {n_entries} database "
        f"entries + {cfg.loop_query_rotations - 1} x {n_queries} queries")
    log(f"[slice] K1: one pyramid and one alignment launch per tracked frame "
        f"({n_tracked}); launches per general frame: "
        + ", ".join(f"{k} {v / n_general:.3f}" for k, v in launches.items()))
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

    n0 = len(vo.stats)
    t0 = time.perf_counter()
    events = profile(lambda: [vo.process(f) for f in profiled])
    wall = time.perf_counter() - t0
    window = per_launch(events, KERNEL_NAMES)
    n_kernels = sum(c for c, _ in events.values())
    busy = 1e-3 * sum(us for _, us in events.values())
    log(f"[slice] device time per launch over {len(profiled)} more frames under "
        f"torch.profiler: " + ", ".join(f"{k} {us:.2f} us x {c}" for k, (c, us) in window.items())
        + f"; all kernels {n_kernels} ({n_kernels / len(profiled):.0f} a frame), device time "
        f"{busy:.2f} ms ({busy / len(profiled):.2f} ms a frame; {1e3 * wall:.2f} ms of wall "
        f"under the profiler); keyframes in the window "
        f"{sum(s.is_keyframe for s in vo.stats[n0:])} ({card})")
    # one replay of the general step's graph alone (a measurement launch: the
    # driver's state and the counts are not touched)
    replay = graphs[0].graph.replay
    events = profile(replay)
    n_rep, rep_ms = sum(c for c, _ in events.values()), 1e-3 * sum(us for _, us in events.values())
    ev_ms = cuda_ms(replay, 5, 4)
    launch_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay()                      # the host's part: the launch, no sync
        launch_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    plain_med = 1e3 * statistics.median(gen_plain)
    replayed = [p for p, st in zip(parts, vo.stats) if st.stage == "general"
                and not st.is_keyframe][1:]
    up, step, rest = (1e3 * statistics.median(x) for x in zip(*replayed))
    log(f"[slice] one replay of the general step's graph: {n_rep} kernels, device time "
        f"{rep_ms:.2f} ms (torch.profiler), {ev_ms:.2f} ms by CUDA events, the host's "
        f"replay() call {1e3 * statistics.median(launch_s):.2f} ms; the device is "
        f"busy {100 * rep_ms / plain_med:.1f}% of a non-keyframe general frame's "
        f"{plain_med:.2f} ms median; medians over its replayed frames: upload and "
        f"conversion {up:.2f} ms, frame_step (copies in, replay, clones, the read) "
        f"{step:.2f} ms, the rest of the driver {rest:.2f} ms ({card})")
    run = dict(frame_s=frame_s, stats=list(vo.stats[:len(frames)]), positions=positions,
               vo=vo)
    return launches, n_general, window, n_entries, run


def ate_share(est, gt):
    """(Sim(3) ATE, path length) from the first moving frame's predecessor."""
    if not np.isfinite(est).all():
        raise AssertionError("non-finite trajectory")
    moving = np.nonzero(np.linalg.norm(est, axis=1) > 1e-9)[0]
    i0 = max(int(moving[0]) - 1, 0)
    a = ate_rmse(est[i0:], gt[i0:], with_scale=True)
    return a.rmse, float(np.linalg.norm(np.diff(gt[i0:], axis=0), axis=1).sum())


def run_vo(cam, cfg, frames, device=DEV):
    vo = MonoVO(cam, cfg, device=device)
    closed = []
    for f in frames:
        vo.process(f)
        closed.append(vo.n_loop_closures)
    return vo, closed


def phase_loop(card, frames, gt):
    """Phase 4b: a loop at full width (module docstring)."""
    cam = Pinhole.kitti()
    frames = list(frames[:N_OUT]) + list(frames[N_OUT - 1::-1])
    gt = np.concatenate([gt[:N_OUT], gt[N_OUT - 1::-1]])
    cfg = Config(**LOOP_GATES)
    t0 = time.perf_counter()
    vo, closed = run_vo(cam, cfg, frames)
    wall = time.perf_counter() - t0
    odo, _ = run_vo(cam, Config(loop_closure=False), frames)
    log(vo.report())
    a_loop, length = ate_share(vo.positions(), gt)
    a_odo, _ = ate_share(odo.positions(), gt)
    at = [k for k in range(len(closed)) if closed[k] != (closed[k - 1] if k else 0)]
    log(f"[loop] {len(frames)} frames 1240x376 out and back in {wall:.2f} s: "
        f"{vo.n_loop_closures} closures (at frames {at}), {vo.kf_count} keyframes, database "
        f"{vo.db_cursor} slots; ATE {100 * a_loop / length:.3f}% of a {length:.3f}-unit path, "
        f"loop_closure=False {100 * a_odo / length:.3f}%; loop_closure stage "
        f"{vo.monitor['loop_closure'].n} calls {1e3 * vo.monitor['loop_closure'].average:.3f} "
        f"ms avg, local_BA {1e3 * vo.monitor['local_BA'].average:.3f} ms avg ({card})")
    if vo.stage is not Stage.GENERAL or vo.n_loop_closures < 1:
        raise AssertionError(f"no loop closed ({vo.stage}, {vo.n_loop_closures} closures)")
    if not a_loop < 0.05 * length:
        raise AssertionError(f"ATE {a_loop} >= 5% of {length}")
    if not a_loop <= max(1.25 * a_odo, 0.01 * length):
        raise AssertionError(f"ATE with loop closure {a_loop}, without {a_odo}")

    # the window BA of the run's last state, its free poses and points moved
    # off the optimum (seeded), in each solve, and repeats
    prob = vo_mod._window_problem(vo.kfs, vo.map, vo.intr, vo.cam.dist)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    nudge = (0.01 * torch.randn((prob.n_cams, 6), generator=gen)).to(DEV)
    nudge = torch.where(prob.cam_fixed[:, None], torch.zeros_like(nudge), nudge)
    cams = (SE3.exp(nudge) @ prob.cams()).normalize()
    prob = prob._replace(cam_wxyz=cams.wxyz, cam_t=cams.t, points=prob.points + (
        0.02 * torch.randn(prob.points.shape, generator=gen)).to(DEV))
    finals, times = {}, {}
    for solver in ("explicit", "zexplicit", "pcg"):
        kw = dict(solver=solver, cg_iters=cfg.ba_cg_iters, cg_tol=cfg.ba_cg_tol,
                  q_eta=cfg.ba_q_eta)
        runs = []
        for _ in range(2 if solver != "explicit" else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(bundle_adjust(prob, cfg.ba_max_iters, cfg.ba_huber_delta,
                                      cfg.ba_jacobi_scaling, cfg.ba_lambda0, **kw))
            torch.cuda.synchronize()
            times[solver] = time.perf_counter() - t0
        finals[solver] = float(runs[0].final_cost)
        if len(runs) == 2:
            a, b = runs
            same = all(torch.equal(x, y) for x, y in zip(a.problem, b.problem) if x is not None)
            if not (same and torch.equal(a.final_cost, b.final_cost)):
                raise AssertionError(f"two {solver} window BAs differ")
    rel = {k: abs(v / finals["explicit"] - 1.0) for k, v in finals.items()}
    log(f"[loop] window BA on the last window (K {prob.n_cams}, P {prob.n_points}, O "
        f"{prob.n_obs}): initial cost {float(runs[0].initial_cost):.6f}, final "
        + ", ".join(f"{k} {v:.6f} ({1e3 * times[k]:.2f} ms)" for k, v in finals.items())
        + f"; pcg and zexplicit repeats bit-equal ({card})")
    if not (rel["zexplicit"] < 1e-3 and rel["pcg"] < 1e-3):
        raise AssertionError(f"window BA solves disagree: {finals}")
    T = [vo_mod._pose_optimize(vo.tracks, vo.map.xyz, vo.map.valid, vo.T_cur, vo.cam, cfg)
         for _ in range(2)]
    if not (torch.equal(T[0][0].wxyz, T[1][0].wxyz) and torch.equal(T[0][0].t, T[1][0].t)):
        raise AssertionError("two pose_only_adjust calls differ")
    log("[loop] two pose_only_adjust calls on the frame's matches: bit-equal")

    # the closure's pose graph alone, on the final database and loop edges
    E = cfg.loop_max_edges
    edges = [torch.zeros(E, dtype=torch.int64), torch.zeros(E, dtype=torch.int64),
             torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(E, 1), torch.zeros(E, 3),
             torch.zeros(E)]
    for e, (i, j, q, t) in enumerate(vo.loop_edges):
        edges[0][e], edges[1][e], edges[2][e] = i, j, torch.as_tensor(q)
        edges[3][e], edges[4][e] = torch.as_tensor(t), cfg.loop_edge_weight
    edges = [a.to(DEV) for a in edges]
    pgo = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, c0, c1 = lc.optimize_db_graph(vo.loop_db, *edges, cfg.loop_pgo_iters)
        torch.cuda.synchronize()
        pgo.append(time.perf_counter() - t0)
    log(f"[loop] the closure's pose graph ({cfg.loop_db_capacity} nodes, {cfg.loop_pgo_iters} "
        f"GN steps): {1e3 * statistics.median(pgo):.2f} ms (median of 3), cost "
        f"{float(c0):.3g} -> {float(c1):.3g} ({card})")

    t0 = time.perf_counter()
    costs = vo.global_refine(10)
    torch.cuda.synchronize()
    a_ref, _ = ate_share(vo.positions(), gt)
    log(f"[loop] global_refine(10): cost {costs[0]:.6f} -> {costs[1]:.6f} in "
        f"{time.perf_counter() - t0:.2f} s; ATE {100 * a_ref / length:.3f}% ({card})")
    if not (np.isfinite(costs).all() and costs[1] <= costs[0]):
        raise AssertionError(f"global_refine costs {costs}")
    if not a_ref < 0.05 * length:
        raise AssertionError(f"ATE after global_refine {a_ref} >= 5% of {length}")
    return vo


def phase_cpu_reference():
    """The small sequences through the port on the card and on the CPU (the
    plain twins): a lateral one with loop_closure=False and the
    out-and-back of tests/test_loop_closure.py with loop closure (its
    configuration, tests/test_loop_closure.py:251-257): identical
    stage/keyframe decisions and closures at the same frames, positions
    within 1% of the path length (FMA and library sums order differently)."""
    cam = Pinhole.create(320, 240, 280.0, 280.0, 160.0, 120.0)
    base = dict(init_min_features=60, init_min_tracked=60, init_min_triangulated=30,
                init_min_disparity=2.0, max_keyframes=16, kf_disparity=10.0)
    frames, gt = render(cam, 16, 0.09, SEED + 1, 1600)
    loop_frames = frames + frames[::-1]
    cases = {"lateral": (frames, gt, Config(**base, loop_closure=False)),
             "out and back": (loop_frames, np.concatenate([gt, gt[::-1]]),
                              Config(**base, loop_db_capacity=32, loop_min_gap_frames=12,
                                     loop_min_score=0.6, loop_min_inliers=20,
                                     loop_cooldown_kfs=3, loop_max_edges=4))}
    for name, (seq, truth, cfg) in cases.items():
        runs = {d: run_vo(cam, cfg, seq, device=d) for d in ("cuda", "cpu")}
        dec = {d: ([(s.stage, s.is_keyframe) for s in v.stats], c) for d, (v, c) in runs.items()}
        if dec["cuda"] != dec["cpu"]:
            raise AssertionError(f"card vs CPU ({name}) decisions or closures differ:\n"
                                 f"{dec['cuda']}\n{dec['cpu']}")
        diff = float(np.abs(runs["cuda"][0].positions() - runs["cpu"][0].positions()).max())
        length = float(np.linalg.norm(np.diff(truth, axis=0), axis=1).sum())
        log(f"[reference] {name} 320x240 x {len(seq)} frames: same decisions on card and "
            f"CPU, {runs['cuda'][0].n_loop_closures} closures in both; max |d position| "
            f"{diff:.3g} (path {length:.3f})")
        if not diff < 0.01 * length:
            raise AssertionError(f"card vs CPU ({name}) positions differ by {diff}")
        if cfg.loop_closure and runs["cuda"][0].n_loop_closures < 1:
            raise AssertionError(f"card vs CPU ({name}): no loop closed")


def render_panorama_cases(seed=SEED):
    """Views of a textured sphere for the panorama phase (numpy, host)."""
    rng = np.random.default_rng(seed + 2)
    translate = synth.panorama_views(rng, PAN_N, PAN_W, PAN_H, PAN_F, PAN_YAW)
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
    """Kernel vs plain on the card, bit-exact: max |d| 0 (NaN where both are
    NaN), 0 validity flips."""
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"K4 {name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    flips = 0 if got_valid is None else int((got_valid != want_valid).sum())
    both_nan = torch.isnan(got) & torch.isnan(want)
    d = torch.where(both_nan, torch.zeros_like(got), got - want).abs()
    err = float(d.max()) if d.numel() else 0.0
    if flips or not err == 0.0:
        raise AssertionError(f"K4 {name}: max |d| {err}, {flips} validity flips")
    log(f"[K4] {name}: max |d| {err:.3g}, validity flips {flips}")
    return err


def paste_case(views):
    """View 3 of the TRANSLATE case after the spherical pre-warp, and the
    homography and canvas its paste warps it through, as Panorama.process
    builds them (T @ H_3 onto the whole canvas), from one run of it."""
    pan = Panorama(focal_length=PAN_F, pan_type=PanType.TRANSLATE, feathering_width=PAN_FEATHER,
                   device=DEV)
    canvas = pan.process(views)
    T = np.eye(3, dtype=np.float32)
    T[0, 2], T[1, 2] = -pan.origin_[0], -pan.origin_[1]
    view = warp.warp_spherical(torch.as_tensor(views[3], device=DEV), PAN_F)
    return view, (T @ pan.homographies_[3]).astype(np.float32), tuple(canvas.shape[:2])


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
    # the TRANSLATE paste: a pre-warped view onto the whole 8-view canvas
    pview, P, paste_hw = paste_case(cases["translate"]["views"])
    Pinv = warp.homography_inverse(P)
    got, gv = warp.warp_perspective(pview, P, paste_hw)
    want, wv = warp._warp_perspective_plain(pview, Pinv, paste_hw, 0.0)
    errs["warp"].append(k4_check(f"warp_perspective (paste) {tuple(pview.shape)} -> "
                                 f"{paste_hw}", got, want, gv, wv))
    for tag, Mi, src, hw in (("pair canvas", Minv, kview, out_hw),
                             ("paste", Pinv, pview, paste_hw)):
        tiles = warp_tiles.kernel_shortcut_tiles(Mi, tuple(src.shape[:2]), hw)
        if not np.array_equal(tiles, warp_tiles.shortcut_tiles(Mi, tuple(src.shape[:2]), hw)):
            raise AssertionError(f"K4 warp_perspective ({tag}): the host copy of the "
                                 f"whole-tile test disagrees with the kernel's")
        log(f"[K4] warp_perspective ({tag}): the kernel's test takes {int(tiles.sum())} of "
            f"{tiles.size} tiles ({100 * tiles.mean():.1f}%), wholly outside the source, "
            f"written as fill without sampling (host copy agrees)")

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

    # the library yardstick of each border-clamped form: one grid_sample
    # over the field normalised to [-1, 1] inside the timed call
    sx, sy = 2.0 / (w - 1), 2.0 / (h - 1)
    gxn, gyn = gx * sx - 1.0, gy * sy - 1.0
    ph, pw = pgray.shape
    pscale = torch.tensor([2.0 / (pw - 1), 2.0 / (ph - 1)], device=dev)
    neg_one = torch.full((2,), -1.0, device=dev)
    pflat = coords.view(-1, 16, 2)
    library = {
        "remap_rows": grid_sample_xy(gray, lambda: torch.stack((gxn, v * sy - 1.0), -1)),
        "remap_cols": grid_sample_xy(gray, lambda: torch.stack((u * sx - 1.0, gyn), -1)),
        "remap_xy": grid_sample_xy(pgray, lambda: torch.addcmul(neg_one, pflat, pscale)),
    }
    for name, want in (("remap_rows", warp._remap_rows_plain(gray, v)),
                       ("remap_cols", warp._remap_cols_plain(gray, u)),
                       ("remap_xy", warp.bilinear_sample(pgray, coords, clamp=True)[0])):
        log(f"[K4] {name} grid_sample yardstick: max |d| "
            f"{float((library[name]().reshape(want.shape) - want).abs().max()):.3g}")
    sph_u, sph_v = warp.spherical_warp_field(view.shape[0], view.shape[1], PAN_F, device=dev)
    cyl_u, cyl_v = warp.cylindrical_warp_field(view.shape[0], view.shape[1], PAN_F, device=dev)
    per_xy = warp.apply_homography(torch.as_tensor(Minv, device=dev),
                                   warp.output_grid(*out_hw, device=dev))
    paste_xy = warp.apply_homography(torch.as_tensor(Pinv, device=dev),
                                     warp.output_grid(*paste_hw, device=dev))
    rows = {
        "remap_rows": measure(lambda: warp.remap_rows(gray, v),
                              lambda: warp._remap_rows_plain(gray, v),
                              library=library["remap_rows"],
                              bound=bounds.k4_remap(gray, gx, v, 4 * v.numel(), False),
                              shape=f"{tuple(gray.shape)}"),
        "remap_cols": measure(lambda: warp.remap_cols(gray, u),
                              lambda: warp._remap_cols_plain(gray, u),
                              library=library["remap_cols"],
                              bound=bounds.k4_remap(gray, u, gy, 4 * u.numel(), False),
                              shape=f"{tuple(gray.shape)}"),
        "remap_xy": measure(lambda: warp.remap_xy(pgray, coords, clamp=True),
                            lambda: warp.bilinear_sample(pgray, coords, clamp=True),
                            library=library["remap_xy"],
                            bound=bounds.k4_remap(pgray, coords[..., 0], coords[..., 1],
                                                  4 * coords.numel(), True),
                            shape=f"{tuple(coords.shape[:-1])} on {tuple(pgray.shape)}"),
        "warp_spherical": measure(lambda: warp.warp_spherical(view, PAN_F),
                                  lambda: warp._warp_field(view, warp._SPHERICAL, PAN_F),
                                  bound=bounds.k4_warp(view, sph_u, sph_v, False,
                                                       bounds.OPS_SPHERICAL),
                                  shape=f"{tuple(view.shape)}"),
        "warp_cylindrical": measure(lambda: warp.warp_cylindrical(view, PAN_F),
                                    lambda: warp._warp_field(view, warp._CYLINDRICAL, PAN_F),
                                    bound=bounds.k4_warp(view, cyl_u, cyl_v, False,
                                                         bounds.OPS_CYLINDRICAL),
                                    shape=f"{tuple(view.shape)}"),
        "warp_perspective (paste)": measure(
            lambda: warp.warp_perspective(pview, P, paste_hw),
            lambda: warp._warp_perspective_plain(pview, Pinv, paste_hw, 0.0),
            bound=bounds.k4_warp(pview, paste_xy[..., 0], paste_xy[..., 1], True,
                                 bounds.OPS_HOMOGRAPHY),
            shape=f"{tuple(pview.shape)} -> {paste_hw}"),
        "warp_perspective": measure(lambda: warp.warp_perspective(kview, M, out_hw),
                                    lambda: warp._warp_perspective_plain(kview, Minv, out_hw,
                                                                         0.0),
                                    bound=bounds.k4_warp(kview, per_xy[..., 0], per_xy[..., 1],
                                                         True, bounds.OPS_HOMOGRAPHY),
                                    shape=f"{tuple(kview.shape)} -> {out_hw}"),
    }
    for name, r in rows.items():
        log_row(name, r, card)
    return {"remap": dict(rows["remap_xy"], max_abs_err=max(errs["remap"])),
            "warp": dict(rows["warp_perspective"], max_abs_err=max(errs["warp"]))}, rows


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
    k3 += [k3_pyramid_check(f"panorama view {k}", pyr[:n_levels], cfg.fast_threshold)
           for k, pyr in enumerate((pyr_l, pyr_r))]
    det = pyr_l[:n_levels]
    # about a quarter of the matches leave LK's 40-unit error gate (53 of
    # 70 ok in both on the CPU), so the share gate here is 60%
    p1, p2, w = find_correspondences(grays[0], grays[1], cfg, refine_lk=False)
    k1, _ = k1_track_check(f"track_pyramid from the matches, {len(pyr_l)} levels",
                           pyr_l, pyr_r, p1, w > 0, p2, cfg, min_ok=0.6)
    valid = w > 0
    rows = {
        "corner_response (panorama)": measure(
            lambda: corners.corner_response(pyr_l[0], cfg.fast_threshold),
            lambda: corners._corner_response_plain(pyr_l[0], cfg.fast_threshold),
            bound=bounds.k3_corners(pyr_l[:1], cfg.fast_threshold),
            shape=f"{tuple(pyr_l[0].shape)}"),
        "corner_response_pyramid (panorama)": measure(
            lambda: corners.corner_response_pyramid(det, cfg.fast_threshold),
            lambda: [corners._corner_response_plain(img, cfg.fast_threshold) for img in det],
            bound=bounds.k3_corners(det, cfg.fast_threshold),
            shape=f"{n_levels} levels of {tuple(pyr_l[0].shape)}"),
        "lk_pyramid (panorama)": measure(
            lambda: lk.track_pyramid(pyr_l, pyr_r, p1, valid, init=p2, half_window=half,
                                     iters=cfg.klt_iters, eps=cfg.klt_eps),
            lambda: lk._track_pyramid_plain(pyr_l, pyr_r, p1, valid, p2, half, cfg.klt_iters,
                                            cfg.klt_eps, 40.0),
            bound=bounds.k1_pyramid(pyr_l, pyr_r, p1, p2, half, cfg.klt_iters, cfg.klt_eps),
            shape=f"{p1.shape[0]} tracks, {len(pyr_l)} levels of {tuple(pyr_l[0].shape)}"),
    }
    for name, r in rows.items():
        log_row(name, r, card)
    return {"corner_response": max(k3), "lk_pyramid": k1}, rows


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
    counters = (lk.track_pyramid, lk.track_level, corners.corner_response_pyramid,
                corners.corner_response) + K4_COUNTERS["remap"] + K4_COUNTERS["warp"]
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
    torch.cuda.synchronize()
    pastes = warp.warp_perspective.launches                  # the TRANSLATE runs' pastes

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
    groups = {"K1": launches["track_pyramid"] + launches["track_level"],
              "K3": launches["corner_response_pyramid"] + launches["corner_response"],
              "K4 remap": sum(launches[c.__name__] for c in K4_COUNTERS["remap"]),
              "K4 warp": sum(launches[c.__name__] for c in K4_COUNTERS["warp"])}
    if min(groups.values()) <= 0:
        raise AssertionError(f"a kernel of the panorama path never launched: {groups}")
    # K1 once per aligned pair for the whole pyramid: 4 TRANSLATE runs, 1 HOMOGRAPHY
    pairs = (1 + reps) * (PAN_N - 1) + (HOMO_N - 1)
    if (launches["track_pyramid"], launches["track_level"]) != (pairs, 0):
        raise AssertionError(f"K1 launched {launches['track_pyramid']} times (track_level "
                             f"{launches['track_level']}) for {pairs} pairs")
    if not torch.isfinite(out).all() or not torch.isfinite(out_h).all():
        raise AssertionError("non-finite canvas")
    window = per_launch(profile(lambda: pan.process(tc["views"])), KERNEL_NAMES)
    log(f"[panorama] device time per launch over one more TRANSLATE panorama under "
        f"torch.profiler: " + ", ".join(f"{k} {us:.2f} us x {c}" for k, (c, us) in window.items())
        + f" ({card})")
    return groups, launches, 2 + reps, window, pastes / (1 + reps)


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


def frame_summary(frame_s, stats):
    """(general frames/s, non-keyframe median ms, keyframe median ms)."""
    gen = [(t, st.is_keyframe) for t, st in zip(frame_s, stats) if st.stage == "general"]
    kf = [t for t, k in gen if k]
    return (len(gen) / sum(t for t, _ in gen), 1e3 * statistics.median([t for t, k in gen if not k]),
            1e3 * statistics.median(kf) if kf else float("nan"))


def write_png(path, img):
    """8-bit grayscale PNG of a uint8 [H, W] array (zlib, no imaging library)."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def captured(fn):
    """Run fn() with its standard output kept (its file and decoder lines
    echoed): (per-frame (frame, stage, keyframe) decisions, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    out = buf.getvalue().splitlines()
    for line in out:
        if line.startswith(("run_slam:", "wrote", "decoder:", "slam_map", "global BA")):
            log("[cli]   " + line)
    if rc not in (0, None) and not isinstance(rc, MonoVO):
        raise AssertionError(f"run_slam returned {rc}")
    dec = [(int(ln[1:6]), ln[8:18].strip(), ln.split("kf=")[1][0] == "1")
           for ln in out if ln.startswith("[0")]
    return dec, out


def phase_cli(card, frames, gt, slice_run):
    """Phase 6: the SLAM CLI (python -m dr3_tpu_torch.run_slam) over the
    slice's frames written as a KITTI-layout directory, resume from its
    checkpoint on the card and on the CPU, the graph path against the eager
    one, and the host reads per general frame (module docstring)."""
    import importlib.util

    from dr3_tpu_torch.io.checkpoint import load_vo
    from dr3_tpu_torch.native import dataloader

    tmp = tempfile.mkdtemp(prefix="dr3_cli_")
    try:
        seq = os.path.join(tmp, "seq")
        os.makedirs(os.path.join(seq, "image_0"))
        u8 = [np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8) for f in frames]
        for i, a in enumerate(u8):
            write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), a)
        np.savetxt(os.path.join(seq, "times.txt"), 0.1 * np.arange(len(u8)))
        native = dataloader.available()
        pil = importlib.util.find_spec("PIL") is not None
        log(f"[cli] {len(u8)} frames written as {seq}/image_0/%06d.png; native decoder "
            f"{'builds' if native else 'unavailable: ' + str(dataloader.build_error)}; PIL "
            f"{'installed' if pil else 'not installed'}; matplotlib "
            f"{'installed' if importlib.util.find_spec('matplotlib') else 'not installed: slam_map.png cannot be rendered here'}")
        out = {k: os.path.join(tmp, k) for k in ("full", "first", "card", "cpu")}
        base = ["--seq", seq, "--batch", "16", "--checkpoint-every", "20"]
        from dr3_tpu_torch import run_slam

        if not (native or pil):
            log("[cli] run_slam.main not run: neither the native decoder nor PIL can read "
                "the PNGs on this host; each run below drives run_slam.run with the frames "
                "in memory instead")

        def cli(argv):
            """run_slam.main(argv), or where no decoder reads the PNGs, what it
            does with the frames in memory."""
            if native or pil:
                return captured(lambda: run_slam.main(argv))
            args, unknown = run_slam._parser().parse_known_args(argv)
            vo = MonoVO(Pinhole.kitti(), Config.from_cli(unknown).replace(
                frames_per_dispatch=args.batch), device=args.device)
            if args.resume:
                load_vo(args.resume, vo)
            start, stop = vo.frame_idx + 1, args.max_frames or len(u8)
            return captured(lambda: run_slam.run(
                vo, [a.astype(np.float32) / 255.0 for a in u8[start:stop]], args, args.out))

        t0 = time.perf_counter()
        dec, lines = cli(base + ["--out", out["full"]])
        wall = time.perf_counter() - t0
        for name in ("trajectory.txt", "checkpoint.npz", "checkpoint.json", "final.npz",
                     "final.json"):
            if not os.path.getsize(os.path.join(out["full"], name)) > 0:
                raise AssertionError(f"run_slam wrote no {name}")
        png = os.path.exists(os.path.join(out["full"], "slam_map.png"))
        vo = MonoVO(Pinhole.kitti(), Config(), device="cuda")
        load_vo(os.path.join(out["full"], "final"), vo)
        n_ba = [int(ln.split()[1]) for ln in lines if ln.startswith("window_BA")]
        if vo.stage is not Stage.GENERAL or vo.kf_count < 3 or not n_ba or n_ba[0] < 1:
            raise AssertionError(f"CLI run: {vo.stage}, {vo.kf_count} keyframes, window BA {n_ba}")
        # --batch 16 runs the device-resident loop: its report times the
        # loop's dispatches and row reads
        n_disp = [int(ln.split()[1]) for ln in lines if ln.startswith("scan_dispatch")]
        if not n_disp or not any(ln.startswith("scan_fetch") for ln in lines):
            raise AssertionError("CLI run: --batch 16 never dispatched the frame loop")
        if not int(vo.map.n) > 100:
            raise AssertionError(f"CLI run: map points {int(vo.map.n)}")
        est = vo.positions()
        a, length = ate_share(est, gt)
        if not a < 0.05 * length:
            raise AssertionError(f"CLI run: ATE {a} >= 5% of {length}")
        tum = np.loadtxt(os.path.join(out["full"], "trajectory.txt"))
        d_tum = float(np.abs(tum[:, 1:4] - est).max()) if tum.shape == (len(u8), 8) else None
        if d_tum is None or not d_tum < 1e-5:
            raise AssertionError(f"trajectory.txt {tum.shape}, centres off by {d_tum}")
        log(f"[cli] run_slam.main {' '.join(base)} in {wall:.2f} s on the card: "
            f"{len(dec)} frames, {n_disp[0]} dispatches of the frame loop, "
            f"{vo.kf_count} keyframes, window BA {n_ba[0]}, map points "
            f"{int(vo.map.n)}, ATE {100 * a / length:.3f}% of the path; trajectory.txt "
            f"{tum.shape[0]} lines, centres within {d_tum:.3g} of the final state's; "
            f"slam_map.png {'written' if png else 'not written (no matplotlib here)'} ({card})")

        # resume: the checkpoint at frame 19, then frames 20-39 on the card and on the CPU
        cli(base + ["--out", out["first"], "--max-frames", "20"])
        ckpt = os.path.join(out["first"], "checkpoint")
        with open(ckpt + ".json") as f:
            if json.load(f)["frame_idx"] != 19:
                raise AssertionError("the checkpoint is not at frame 19")
        resumed = {}
        for dev in ("card", "cpu"):
            argv = base + ["--out", out[dev], "--resume", ckpt]
            t0 = time.perf_counter()
            dec_r, _ = cli(argv + (["--device", "cpu"] if dev == "cpu" else []))
            v = MonoVO(Pinhole.kitti(), Config(), device="cpu")
            load_vo(os.path.join(out[dev], "final"), v)
            resumed[dev] = (dec_r, v.positions(), time.perf_counter() - t0)
        (dc, pc, tc), (dp, pp, tp) = resumed["card"], resumed["cpu"]
        diff = float(np.abs(pc - pp).max())
        if dc != dp or [d[0] for d in dc] != list(range(20, len(u8))) or dc[0][1] != "reseed":
            raise AssertionError(f"resumed runs differ or do not continue at 20:\n{dc}\n{dp}")
        if not diff < 0.01 * length:
            raise AssertionError(f"resumed card vs CPU positions differ by {diff}")
        log(f"[cli] --resume from frame 19: frames 20-{len(u8) - 1} on the card ({tc:.2f} s) "
            f"and on the CPU ({tp:.2f} s) take the same decisions ({sum(d[2] for d in dc)} "
            f"keyframes); max |d position| {diff:.3g} (path {length:.3f})")

        # the graph path against the eager path over the slice's frames
        cfg = Config(fused_frontend=False)
        eager = MonoVO(Pinhole.kitti(), cfg, device="cuda")
        eager_s = []
        for f in frames:
            t0 = time.perf_counter()
            eager.process(f)
            eager_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        g_dec = [(s.stage, s.is_keyframe) for s in slice_run["stats"]]
        e_dec = [(s.stage, s.is_keyframe) for s in eager.stats]
        d_ge = float(np.abs(slice_run["positions"] - eager.positions()).max())
        bit = np.array_equal(slice_run["positions"], eager.positions())
        if g_dec != e_dec or not d_ge < 1e-5:
            raise AssertionError(f"graph vs eager: decisions equal {g_dec == e_dec}, max "
                                 f"|d position| {d_ge}")
        g, e = frame_summary(slice_run["frame_s"], slice_run["stats"]), frame_summary(eager_s, eager.stats)
        log(f"[cli] graph vs eager over the slice's {len(frames)} frames: the same decisions, "
            f"max |d position| {d_ge:.3g}, bit-equal {bit}; general frames/s {g[0]:.2f} "
            f"(graph) / {e[0]:.2f} (eager), non-keyframe median {g[1]:.2f} / {e[1]:.2f} ms, "
            f"keyframe median {g[2]:.2f} / {e[2]:.2f} ms ({card})")

        # host reads: every synchronising call per frame of a graph run
        vo = MonoVO(Pinhole.kitti(), Config(), device="cuda")
        syncs = []
        for f in frames[:20]:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    vo.process(f)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        replayed = [n for n, s in zip(syncs, vo.stats) if s.stage == "general"][1:]
        plain = [n for n, s in zip(syncs, vo.stats)
                 if s.stage == "general" and not s.is_keyframe][1:]
        log(f"[cli] host synchronisations per frame (torch.cuda.set_sync_debug_mode) over "
            f"{len(syncs)} frames: {syncs}; replayed non-keyframe general frames: {plain}")
        if not plain or set(plain) != {1}:
            raise AssertionError(f"replayed general frames synchronise {plain} times, not once")
        return dict(decoder=[ln for ln in lines if ln.startswith("decoder:")], syncs=replayed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bal_split(fn, windows: int = 3):
    """({span: [device ms, device operations]}, cover) of the program's
    ``dr3.ba.*`` spans over fn() in one torch.profiler window, from torch's
    own events: the profiler projects each span onto the device's timeline,
    from the first to the last operation launched directly inside it, and
    each kernel, copy or fill is charged to the shortest projection that
    holds it, so a span's figures are its own and not those of the spans
    inside it. ``cover`` is the share of the window's device time charged
    to some span. The profiler now and then drops events, so a window under
    90% is taken again, ``windows`` in all, and the best is kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    best = ({}, -1.0)
    for _ in range(windows):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ranges = [(e.name, e.time_range) for e in on_device if e.name.startswith("dr3.")]
        work = [e.time_range for e in on_device if not e.name.startswith("dr3.")]
        split = {}
        for w in work:
            holders = [(r.end - r.start, name) for name, r in ranges
                       if r.start <= w.start and w.end <= r.end]
            if holders:
                s = split.setdefault(min(holders)[1], [0.0, 0])
                s[0] += 1e-3 * w.elapsed_us()
                s[1] += 1
        total = 1e-3 * sum(w.elapsed_us() for w in work)
        cover = sum(ms for ms, _ in split.values()) / total if total > 0 else 0.0
        if cover > best[1]:
            best = (split, cover)
        if cover >= 0.9:
            break
    return best


def phase_schur_kernel(card):
    """The kernels of csrc/schur.cu at bal-dubrovnik-88's shapes
    (perfbench/gen/bal.py's problem, its first LM iteration's blocks at
    lambda 1e-3): ``dr3_schur_factor``'s Hinv9, scaled factors and dinv
    each within 1e-5 of its scale from the plain version's run on the card,
    and ``dr3_schur_blocks``' 9x9 blocks each within 1e-5 of its own on the
    plain version's factors; a table row each, the block kernel's with the
    replaced dense ``Z.T @ Z`` of the scaled [3P, 9K] Z as the library call
    (the factor kernel's has none: it replaces a chain of elementwise ops
    and a scatter). Returns the two rows."""
    from dr3_tpu_torch.ba import snavely as sn
    from dr3_tpu_torch.ba.schur_core import _table_reducer, cam_onehot_matrix
    from dr3_tpu_torch.io.bal import BALData
    from dr3_tpu_torch.ops import schur
    from perfbench.gen.bal import bal_case as cell_case

    start, _ = cell_case(88, 64298, 383937, SEED)
    prob = sn.bal_to_snavely(BALData(*(start[k] for k in ("cam_params", "points", "obs_cam",
                                                           "obs_pt", "obs_uv"))), device=DEV)
    K, P, O = prob.n_cams, prob.n_points, prob.n_obs
    blocks, _ = sn._assemble_direct(prob, cam_onehot_matrix(prob.obs_cam, K), 1e9)
    pairs = schur.schur_pairs(prob.obs_cam, prob.obs_pt,
                              _table_reducer(blocks.obs_pt, P).table, K)
    lam = torch.tensor(1e-3, device=DEV)
    Hcc = blocks.Hcc.contiguous()
    fargs = (blocks.Hpp9.contiguous(), Hcc, lam, blocks.Jcu, blocks.Jcv, blocks.Jpu,
             blocks.Jpv, pairs)
    got = schur.schur_factor(*fargs)
    f_err = {}
    for name, a, b in zip(("Hinv9", "Gs", "dinv"), got, schur._schur_factor_plain(*fargs)):
        f_err[name] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    if not max(f_err.values()) <= 1e-5:
        raise AssertionError(f"dr3_schur_factor against its plain version: {f_err}")
    _, G, dinv = got
    S = schur.schur_blocks(G, dinv, Hcc, lam, pairs)
    want = schur._schur_blocks_plain(G, dinv, Hcc, lam, pairs).view(K, 9, K, 9)
    err = float(((S.view(K, 9, K, 9) - want).abs().amax(dim=(1, 3))
                 / want.abs().amax(dim=(1, 3)).clamp(min=1e-30)).max())
    del want
    if not err <= 1e-5:
        raise AssertionError(f"dr3_schur_blocks: a block {err:.3e} of its scale from the plain")
    # the replaced product: the scaled dense Z the parent scattered, from the rows
    obs = pairs.cam_obs.long()
    rows = (3 * pairs.obs_pt.long()[obs][:, None] + torch.arange(3, device=DEV))[:, :, None]
    cols = (9 * pairs.obs_cam.long()[obs][:, None] + torch.arange(9, device=DEV))[:, None, :]
    Z = torch.zeros(3 * P * 9 * K, dtype=torch.float32, device=DEV)
    Z.index_add_(0, (rows * (9 * K) + cols).reshape(-1),
                 G.view(O, 9, 4)[:, :, :3].transpose(1, 2).reshape(-1))
    Z = Z.view(3 * P, 9 * K)
    row = measure(lambda: schur.schur_blocks(G, dinv, Hcc, lam, pairs),
                  lambda: schur._schur_blocks_plain(G, dinv, Hcc, lam, pairs),
                  library=lambda: Z.T @ Z, bound=bounds.schur_blocks(pairs, K, O),
                  shape=f"{K} x {P} x {O}", max_abs_err=err)
    del Z
    f_row = measure(lambda: schur.schur_factor(*fargs),
                    lambda: schur._schur_factor_plain(*fargs),
                    bound=bounds.schur_factor(K, P, O), shape=f"{K} x {P} x {O}",
                    max_abs_err=max(f_err.values()))
    log(f"[schur] dr3_schur_factor at {K} cameras x {P} points x {O} observations: Hinv9, Gs "
        f"and dinv within {f_err['Hinv9']:.2e}, {f_err['Gs']:.2e} and {f_err['dinv']:.2e} of "
        f"their scale from the plain version ({card})")
    log_row("dr3_schur_factor", f_row, card)
    log(f"[schur] dr3_schur_blocks at {K} cameras x {P} points x {O} observations: "
        f"{row['pairs']} pairs, {row['l2_bytes'] / 1e6:.1f} MB of factor rows staged through L2; "
        f"each block within {err:.2e} of its scale from the plain version ({card})")
    log_row("dr3_schur_blocks", row, card)
    return f_row, row


LADYBUG = (1723, 156502, 678718)    # bal-ladybug-1723's cameras, points, observations


def phase_schur_mv(card):
    """The kernels of csrc/schur_mv.cu at bal-ladybug-1723's counts
    (perfbench/gen/bal_route.py's route, its first LM iteration's reduced
    system at lambda 1e-3, a random p): S p within 1e-6 of its largest
    entry from the plain version's run on the card, bit-equal on a repeat,
    and against the products the operator ran before (two [O, 9, 3]
    einsums, cuBLAS batched GEMVs, with their gathers and table sums); a
    table row whose library call is the two einsums; a 2-iteration auto
    solve, which picks the generic pcg path, launching the kernels twice a
    CG iteration. Returns (the row, the solve's launches, its CG
    iterations)."""
    from dr3_tpu_torch.ba import snavely as sn
    from dr3_tpu_torch.ba.schur_core import PCG, assemble_blocks, reduce_system
    from dr3_tpu_torch.io.bal import BALData
    from dr3_tpu_torch.ops import schur_mv as smv
    from dr3_tpu_torch.tools.cudatime import whole_window
    from perfbench.gen.bal_route import route_case

    start, _ = route_case(*LADYBUG, SEED)
    prob = sn.bal_to_snavely(BALData(*(start[k] for k in ("cam_params", "points", "obs_cam",
                                                           "obs_pt", "obs_uv"))), device=DEV)
    K, P, O = prob.n_cams, prob.n_points, prob.n_obs
    if sn._pick_method(prob, "auto") != ("pcg", False):
        raise AssertionError(f"auto routes {K} x {P} x {O} to {sn._pick_method(prob, 'auto')}")
    res = sn.linearize(prob, 1e9)
    blocks = assemble_blocks(res.r, res.Jc, res.Jp, prob.obs_cam, prob.obs_pt,
                             (prob.obs_w > 0) & res.valid, K, P)
    red = reduce_system(blocks, torch.tensor(1e-3, device=DEV), prob.cam_fixed)
    cg = PCG(red, prob.cam_fixed, 100, 1e-2, 0.1)
    if cg.keyed is None:
        raise AssertionError("the generic path's PCG did not take the keyed kernels")
    args = cg.keyed
    d_pt, d_cam = args[3].shape[1], args[4].shape[1]
    x = torch.as_tensor(np.random.default_rng(SEED).standard_normal((K, 9)),
                        dtype=torch.float32, device=DEV)
    got = smv.schur_mv(*args, x)
    want = smv._schur_mv_plain(*args, x)
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    same = torch.equal(got, want)
    if not err <= 1e-6:
        raise AssertionError(f"dr3_schur_mv: {err:.3e} of its scale from the plain version")
    if not torch.equal(smv.schur_mv(*args, x), got):
        raise AssertionError("dr3_schur_mv: a repeat differs")
    b = red.blocks

    def products():
        xk = x * cg.keep_c
        u = red.by_pt(torch.einsum("ocj,oc->oj", b.AtB, red.to_obs(xk)))
        v = torch.einsum("pij,pj->pi", red.Hpp_inv, u)
        y = torch.einsum("kcd,kd->kc", red.Hcc_d, xk) - red.by_cam(
            torch.einsum("ocj,oj->oc", b.AtB, v[b.obs_pt]))
        return y * cg.keep_c + x * cg.fixed_c

    p_err = float((got - products()).abs().max()) / scale
    xo = red.to_obs(x * cg.keep_c)
    vo = torch.randn((O, 3), device=DEV)
    row = measure(lambda: smv.schur_mv(*args, x), lambda: smv._schur_mv_plain(*args, x),
                  library=lambda: (torch.einsum("ocj,oc->oj", b.AtB, xo),
                                   torch.einsum("ocj,oj->oc", b.AtB, vo)),
                  bound=bounds.schur_mv(K, P, O, d_pt, d_cam), shape=f"{K} x {P} x {O}",
                  max_abs_err=err)
    products_ms, _ = device_ms(products, n=20)
    passes, _ = whole_window(lambda: smv.schur_mv(*args, x), 100)
    split = ", ".join(f"{'point' if 'point' in name else 'camera'} pass {us / n:.2f} us x{n}"
                      for name, (n, us) in passes.items() if "schur_mv" in name and n)
    log(f"[schur_mv] dr3_schur_mv at {K} cameras x {P} points x {O} observations (tables "
        f"{P} x {d_pt}, {K} x {d_cam}): S p within {err:.2e} of its scale from the plain "
        f"version on the card (bit-equal: {same}), {p_err:.2e} from the parent's products; "
        f"per launch {split}; the parent's whole operator {1e3 * products_ms:.2f} us; two-pass "
        f"bytes {row['two_pass_bytes']} ({1e3 * row['two_pass_ms']:.3f} us at 3.35 TB/s, share "
        f"{100 * row['two_pass_ms'] / row['ms']:.1f}%) ({card})")
    log_row("dr3_schur_mv", row, card)
    n0 = smv.schur_mv.launches
    r = sn.bundle_adjust_snavely(prob, 2, huber_delta=1e9)
    launched = smv.schur_mv.launches - n0
    log(f"[schur_mv] a 2-iteration auto solve: {r.cg_iters} CG iterations, {launched} launches "
        f"of the two kernels, cost {float(r.initial_cost):.2f} -> {float(r.final_cost):.2f} "
        f"({card})")
    if launched != 2 * r.cg_iters or r.cg_iters == 0:
        raise AssertionError(f"{launched} launches in {r.cg_iters} CG iterations")
    return row, launched, r.cg_iters


def phase_bal(card, vo):
    """Phase 7: BAL bundle adjustment (module docstring). Returns the
    launches of dr3_schur_factor and dr3_schur_blocks in 7(a)'s 5-iteration
    auto solve."""
    from dr3_tpu_torch import run_ba
    from dr3_tpu_torch.ba import snavely as sn
    from dr3_tpu_torch.ba.lm import least_squares
    from dr3_tpu_torch.io.bal import load_bal
    from dr3_tpu_torch.ops import schur
    from dr3_tpu_torch.tools.ba_time import bal_case, bal_lm_rate
    from dr3_tpu_torch.tools.make_real_bal import export_bal

    t_phase = time.perf_counter()
    L2 = 1e9                       # bench.py's huber_delta: plain least squares

    def rel(a, b):
        return abs(a - b) / abs(b)

    # (a) bench.py's problem at full width
    d, d_true = bal_case(*BAL_FULL)
    prob = sn.bal_to_snavely(d, device=DEV)
    K, P, O = prob.n_cams, prob.n_points, prob.n_obs
    method, _ = sn._pick_method(prob, "auto")
    if method != "zexplicit":
        raise AssertionError(f"auto routes {K} x {P} x {O} to {method}")
    c_true = float(sn.residual_cost(sn.bal_to_snavely(d_true, device=DEV), L2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    schur.schur_factor.launches = schur.schur_blocks.launches = 0
    t0 = time.perf_counter()
    r_auto = sn.bundle_adjust_snavely(prob, 5, huber_delta=L2)
    c0, c_auto, n_acc = float(r_auto.initial_cost), float(r_auto.final_cost), int(r_auto.n_accepted)
    launched = (schur.schur_factor.launches, schur.schur_blocks.launches)
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[bal] (a) {K} cameras x {P} points x {O} observations, auto -> {method}: cost at "
        f"the true parameters {c_true:.2f} (JAX on the CPU {BAL_TRUE_COST}), initial "
        f"{c0:.2f} ({BAL_INITIAL_COST}), final {c_auto:.2f} ({BAL_JAX_FINAL}), {n_acc}/5 "
        f"accepted; first run {first_s:.3f} s; peak device memory {peak / 2**30:.3f} GiB "
        f"({(peak - mem0) / 2**30:.3f} GiB above the problem's) ({card})")
    if not rel(c_true, BAL_TRUE_COST) <= 1e-4:
        raise AssertionError(f"cost at the true parameters {c_true} vs {BAL_TRUE_COST}")
    if not rel(c0, BAL_INITIAL_COST) <= 1e-4:
        raise AssertionError(f"initial cost {c0} vs {BAL_INITIAL_COST}")
    if n_acc != 5 or not rel(c_auto, BAL_JAX_FINAL) <= 1e-3 or not c_auto <= c_true:
        raise AssertionError(f"zexplicit: {n_acc}/5 accepted, final {c_auto} (JAX "
                             f"{BAL_JAX_FINAL}, true parameters {c_true})")
    log(f"[bal] (a) zexplicit's kernels per LM iteration: dr3_schur_factor "
        f"{launched[0] / 5:.1f}, dr3_schur_blocks {launched[1] / 5:.1f}")
    if launched != (5, 5):
        raise AssertionError(f"zexplicit launched {launched} schur kernels in 5 iterations")
    r_z = sn.bundle_adjust_snavely(prob, 5, huber_delta=L2, solver="zexplicit")
    same = [k for k in sn._PARAMS if torch.equal(getattr(r_z.problem, k),
                                                  getattr(r_auto.problem, k))]
    if float(r_z.final_cost) != c_auto or len(same) != len(sn._PARAMS):
        raise AssertionError(f"zexplicit repeats differ: {float(r_z.final_cost)} vs {c_auto}, "
                             f"bit-equal fields {same}")
    r_p = sn.bundle_adjust_snavely(prob, 5, huber_delta=L2, solver="pcg", cg_tol=1e-5, q_eta=0.0)
    c_p = float(r_p.final_cost)
    log(f"[bal] (a) zexplicit twice: final cost and every parameter bit-equal; pcg (cg_tol "
        f"1e-5, q_eta 0) final {c_p:.2f} ({int(r_p.n_accepted)}/5 accepted, {r_p.cg_iters} CG "
        f"iterations), {rel(c_p, c_auto):.3e} from zexplicit")
    if not rel(c_p, c_auto) <= 1e-4:
        raise AssertionError(f"pcg {c_p} vs zexplicit {c_auto}")

    z_rate, _ = bal_lm_rate(prob)
    p_rate, p_cg = bal_lm_rate(prob, solver="pcg")
    log(f"[bal] (a) ba_bal_lm_iters_per_sec: zexplicit {z_rate:.3f}, pcg (cg_tol 1e-2, q_eta "
        f"0.1) {p_rate:.3f} with {p_cg:.1f} CG iterations a run of 5 ({card})")
    n_it = 5
    for solver, stages in (("zexplicit", ("assemble", "z_build", "ztz", "camera_solve",
                                          "back_substitute", "accept")),
                           ("pcg", ("assemble", "pcg", "back_substitute", "accept"))):
        split, cover = bal_split(lambda: sn.bundle_adjust_snavely(prob, n_it, huber_delta=L2,
                                                                  solver=solver))
        for name in stages:
            ms, n = split.get("dr3.ba." + name, (0.0, 0))
            log(f"[bal] a {solver} LM iteration by its spans: dr3.ba.{name}: {ms / n_it:.3f} ms "
                f"device, {n / n_it:.1f} device operations ({card})")
        log(f"[bal] {solver}: the dr3.ba spans hold {100 * cover:.2f}% of the window's device "
            f"time" + ("" if cover >= 0.9 else ": the profiler dropped events, the split "
                       "under-reads"))
        if solver == "zexplicit":
            # an iteration: every span but the solve's own (cost0, E, the table)
            whole = sum(ms for name, (ms, _) in split.items() if name != "dr3.ba.solve") / n_it
    log(f"[bal] one zexplicit LM iteration: {whole:.3f} ms of device time against "
        f"{1e3 / z_rate:.3f} ms of wall in the rate above: the device is busy "
        f"{100 * whole * z_rate / 1e3:.1f}% of it")
    del prob, r_auto, r_z, r_p

    # (b) the card against the CPU at smaller shapes. At BAL_SMALL 3,200 of
    # the 8,000 points have one observation (no depth): there zexplicit's
    # float32 reduced system is ill-conditioned, and the JAX package's own
    # CPU result and the port's differ by 8.9e-4 (PERF.md), so its costs are
    # printed there and gated at BAL_OVERLAP, where each camera's run of
    # points overlaps its neighbours'. Parameters are compared over the
    # cameras and the points seen at least twice.
    for shape, solver, gated in ((BAL_SMALL, "pcg", True), (BAL_SMALL, "zexplicit", False),
                                 (BAL_OVERLAP, "zexplicit", True)):
        d, _ = bal_case(*shape)
        kw = dict(cg_tol=1e-5, q_eta=0.0) if solver == "pcg" else {}
        rc = sn.bundle_adjust_snavely(sn.bal_to_snavely(d, device=DEV), 5, huber_delta=L2,
                                      solver=solver, **kw)
        rh = sn.bundle_adjust_snavely(sn.bal_to_snavely(d, device="cpu"), 5, huber_delta=L2,
                                      solver=solver, **kw)
        seen = torch.as_tensor(np.bincount(d.obs_pt, minlength=shape[1]) >= 2)

        def gap(k):
            a, b = getattr(rc.problem, k).cpu(), getattr(rh.problem, k)
            if k == "points":
                a, b = a[seen], b[seen]
            return float((a - b).abs().max() / b.abs().max())

        err = {k: gap(k) for k in sn._PARAMS}
        cc, ch = float(rc.final_cost), float(rh.final_cost)
        log(f"[bal] (b) {shape[0]} x {shape[1]} x {shape[0] * shape[2]} ({int(seen.sum())} "
            f"points seen twice or more), {solver}: card {cc:.4f} ({int(rc.n_accepted)}/5), "
            f"CPU {ch:.4f} ({int(rh.n_accepted)}/5), {rel(cc, ch):.3e} apart; parameters "
            + ", ".join(f"{k} {v:.2e}" for k, v in err.items()) + " of their scale"
            + ("" if gated else f"; not gated (JAX on the CPU: {BAL_SMALL_JAX_ZEXPLICIT})"))
        if int(rc.n_accepted) != int(rh.n_accepted):
            raise AssertionError(f"card and CPU accept different steps in {solver}")
        if gated and (not rel(cc, ch) <= 1e-4 or max(err.values()) > 1e-3):
            raise AssertionError(f"card and CPU differ in {solver} at {shape}")

    # (c) real structure: phase 4's MonoVO exported, through the CLI
    tmp = tempfile.mkdtemp(prefix="dr3_bal_")
    try:
        path = os.path.join(tmp, "real.bal")
        exported = export_bal(vo, path)
        counts = [a.shape for a in exported]
        log(f"[bal] (c) phase 4's map exported: {counts[0][0]} cameras, {counts[1][0]} "
            f"points, {counts[2][0]} observations")
        costs = {}
        for label, extra in (("zexplicit", ["--solver", "zexplicit"]),
                             ("pcg", ["--solver", "pcg"]),
                             ("pinhole", ["--model", "pinhole", "--optimize-intrinsics"])):
            out_path = os.path.join(tmp, f"{label}.bal")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = run_ba.main([path, "--iters", "10", *extra, "--out", out_path,
                                  "--device", DEV])
            for line in buf.getvalue().splitlines():
                log(f"[bal] (c) {label}: {line}")
            line = next(ln for ln in buf.getvalue().splitlines() if ln.startswith("cost:"))
            c_in, c_out = float(line.split()[1]), float(line.split()[3])
            costs[label] = c_out
            if rc != 0 or not c_out < c_in:
                raise AssertionError(f"run_ba {label}: rc {rc}, cost {c_in} -> {c_out}")
            if [a.shape for a in load_bal(out_path)] != counts:
                raise AssertionError(f"run_ba {label}: --out does not reload with the counts")
        r_lib = sn.bundle_adjust_snavely(sn.bal_to_snavely(load_bal(path), device=DEV), 10,
                                         huber_delta=L2, solver="pcg", cg_tol=1e-5, q_eta=0.0)
        c_lib = float(r_lib.final_cost)
        log(f"[bal] (c) pcg through the library (cg_tol 1e-5, q_eta 0) {c_lib:.6g}: "
            f"{rel(costs['zexplicit'], c_lib):.3e} from the CLI's zexplicit")
        if not rel(costs["zexplicit"], c_lib) <= 1e-3:
            raise AssertionError(f"zexplicit {costs['zexplicit']} vs pcg {c_lib}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the generic LM on the reference's Ceres exercises, card vs CPU
    def powell(x):
        return torch.stack([x[0] + 10.0 * x[1], 5.0 ** 0.5 * (x[2] - x[3]),
                            (x[1] - 2.0 * x[2]) ** 2, 10.0 ** 0.5 * (x[0] - x[3]) ** 2])

    x0 = [3.0, -1.0, 0.0, 1.0]
    pw = least_squares(powell, torch.tensor(x0, device=DEV), max_iters=60)
    pw_cpu = least_squares(powell, torch.tensor(x0), max_iters=60)
    log(f"[bal] (d) Powell: cost {float(pw.final_cost):.3e} on the card, "
        f"{float(pw_cpu.final_cost):.3e} on the CPU, {int(pw.n_accepted)} accepted")
    if not float(pw.final_cost) < 1e-8:
        raise AssertionError(f"Powell's cost {float(pw.final_cost)}")
    rng = np.random.default_rng(SEED)
    xs = np.linspace(0.0, 5.0, 67).astype(np.float32)
    for delta, frac in ((None, 0.0), (0.05, 0.15)):
        ys = np.exp(0.3 * xs + 0.1) + rng.normal(0, 0.01, xs.size).astype(np.float32)
        k = int(frac * xs.size)
        if k:
            ys[rng.choice(xs.size, k, replace=False)] += rng.uniform(1.5, 3.0, k).astype(np.float32)
        fit = {}
        for dev in (DEV, "cpu"):
            xt, yt = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
            fit[dev] = least_squares(lambda p: torch.exp(p[0] * xt + p[1]) - yt,
                                     torch.zeros(2, device=dev), max_iters=40,
                                     huber_delta=delta).x.cpu()
        gap = float((fit[DEV] - fit["cpu"]).abs().max())
        log(f"[bal] (d) curve fit (Huber {delta}, {frac:.0%} outliers): (m, c) "
            f"{fit[DEV].tolist()} on the card, {gap:.2e} from the CPU")
        if not gap <= 1e-4:
            raise AssertionError(f"curve fit {delta}: card and CPU {gap} apart")
    log(f"[bal] phase 7: {time.perf_counter() - t_phase:.1f} s")
    return launched


def rot_deg(Ra, Rb) -> float:
    """The angle of Ra^T Rb in degrees."""
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def legacy_run(cfg, frames, device, cpu_draws=False):
    """LegacySLAM over ``frames`` on ``device``: (slam, results, wall s).
    ``cpu_draws``: every F RANSAC's minimal sets come from one CPU
    generator seeded with SEED (the same sets on the card and on the CPU)."""
    from dr3_tpu_torch.geometry import ransac as ransac_mod
    from dr3_tpu_torch.pipelines.slam_legacy import LegacySLAM

    real = ransac_mod.sample_minimal_sets
    if cpu_draws:
        gen = torch.Generator().manual_seed(SEED)
        ransac_mod.sample_minimal_sets = lambda g, n, w, ns, ss: real(gen, n, w.cpu(), ns, ss)
    try:
        slam = LegacySLAM(Pinhole.kitti(), cfg, device=device)
        t0 = time.perf_counter()
        results = [slam.process(f) for f in frames]
        wall = time.perf_counter() - t0
    finally:
        ransac_mod.sample_minimal_sets = real
    return slam, results, wall


def phase_legacy(card, frames):
    """Phase 8(a): the legacy frame-to-frame SLAM (module docstring).
    Returns (launch counts, table rows, in-path device us)."""
    from dr3_tpu_torch.pipelines import slam_legacy as sl

    cfg = Config(fast_threshold=8.0, cell_size=12)
    counters = (lk.track_pyramid, lk.track_level, lk.align_to_templates, lk.sample_patches,
                sa.sparse_align, corners.corner_response_pyramid, corners.corner_response,
                warp.remap_xy)
    run = frames[:LEGACY_N]
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    slam, results, wall = legacy_run(cfg, run, DEV)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    log(slam.report())
    poses, _ = lateral_path(LEGACY_N, STEP)
    mats = [np.block([[T.R, T.t[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]]) for T in poses]
    worst = [0, 0, 0, 0.0, 0.0]
    for i, r in enumerate(results[1:], start=1):
        rel = mats[i] @ np.linalg.inv(mats[i - 1])
        ang = rot_deg(r.R, rel[:3, :3])
        gdir = rel[:3, 3] / np.linalg.norm(rel[:3, 3])
        tdir = np.degrees(np.arccos(np.clip(abs(r.t @ gdir) / np.linalg.norm(r.t), 0, 1)))
        log(f"[legacy] frame {i}: matches {r.n_matches}, inliers {r.n_inliers}, good "
            f"{r.n_good}, rotation error {ang:.4f} deg, translation direction {tdir:.3f} deg")
        if not (r.n_matches > 40 and r.n_inliers > 25 and r.n_good > 15 and ang < 1.0
                and tdir < 30.0):
            raise AssertionError(f"legacy frame {i}: {r.n_matches} matches, {r.n_inliers} "
                                 f"inliers, {r.n_good} good, {ang} deg, {tdir} deg")
        worst = [max(worst[0], r.n_matches), max(worst[1], r.n_inliers),
                 max(worst[2], r.n_good), max(worst[3], ang), max(worst[4], tdir)]
    n_pts, max_obs = slam.map_points().shape[0], max(slam.point_obs, default=0)
    if results[0] is not None or not (n_pts > 50 and max_obs >= 3):
        raise AssertionError(f"legacy map: {n_pts} points, max observations {max_obs}")
    # K3 once per frame (the three detection levels), K1 once per frame after
    # the first (level 0), K4's remap_xy once per frame (the descriptors)
    want = {"corner_response_pyramid": LEGACY_N, "track_level": LEGACY_N - 1,
            "remap_xy": LEGACY_N}
    if launches != {c.__name__: want.get(c.__name__, 0) for c in counters}:
        raise AssertionError(f"legacy launches {launches}, want {want}")
    m = slam.monitor
    log(f"[legacy] {LEGACY_N} frames 1240x376 in {wall:.3f} s, {LEGACY_N / wall:.2f} frames/s; "
        f"avg frame (detect + describe) {1e3 * m['frame'].average:.3f} ms, match (match, LK "
        f"polish, F RANSAC, E, cheirality, the read) {1e3 * m['match'].average:.3f} ms, global "
        f"{1e3 * m['global'].average:.3f} ms; {n_pts} map points, max observations "
        f"{max_obs} ({card})")

    # the card against the CPU over 4 frames with the same draws
    runs = {d: legacy_run(cfg, frames[:LEGACY_CPU_N], d, cpu_draws=True)
            for d in (DEV, "cpu")}
    gap, d_rot = 0.0, 0.0
    for i, (a, b) in enumerate(zip(runs[DEV][1][1:], runs["cpu"][1][1:]), start=1):
        for x, y in ((a.n_matches, b.n_matches), (a.n_inliers, b.n_inliers),
                     (a.n_good, b.n_good)):
            gap = max(gap, abs(x - y) / max(y, 1))
        d_rot = max(d_rot, rot_deg(a.R, b.R))
        log(f"[legacy] card vs CPU frame {i}: matches {a.n_matches}/{b.n_matches}, inliers "
            f"{a.n_inliers}/{b.n_inliers}, good {a.n_good}/{b.n_good}, rotations "
            f"{rot_deg(a.R, b.R):.4f} deg apart")
    if not (gap <= 0.02 and d_rot < 0.1):
        raise AssertionError(f"legacy card vs CPU: counts {gap} apart, rotations {d_rot} deg")
    log(f"[legacy] card vs CPU over {LEGACY_CPU_N} frames, the same draws: counts within "
        f"{100 * gap:.2f}%, rotations within {d_rot:.4f} deg; CPU {runs['cpu'][2]:.2f} s")

    # K1 and K3 at the legacy shapes, against their plain versions, timed
    dev = torch.device(DEV)
    pyr0, xy0, v0, d0 = sl._detect_describe(torch.as_tensor(frames[0], device=dev), cfg)
    pyr1, xy1, v1, d1 = sl._detect_describe(torch.as_tensor(frames[1], device=dev), cfg)
    m01 = match.match_descriptors(d0, d1, v0, v1)
    p1, p2 = xy0.contiguous(), xy1[m01.idx2].contiguous()
    n = p1.shape[0]
    pos, ok, _ = lk.track_level(pyr0[0], pyr1[0], p1, p2, 5, 8, 1e-3)
    pos_p, ok_p, _ = lk._track_level_plain(pyr0[0], pyr1[0], p1, p2, 5, 8, 1e-3)
    d = (pos - pos_p).abs().amax(-1)
    both = ok & ok_p
    out = both & (d > 1e-2)
    # the witness: the plain version in float64, and in float32 from starts
    # 1e-3 px away (x, y, both signs). A track whose end moves more than
    # 1e-2 px under one of them has its basin decided by round-off; every
    # track ok in both that the kernel ends elsewhere must be one of those
    spread = torch.zeros_like(d)
    flip = torch.zeros_like(ok)
    wit = [lk._track_level_plain(pyr0[0].double(), pyr1[0].double(), p1.double(),
                                 p2.double(), 5, 8, 1e-3)]
    for e in ((1e-3, 0.0), (-1e-3, 0.0), (0.0, 1e-3), (0.0, -1e-3)):
        wit.append(lk._track_level_plain(pyr0[0], pyr1[0], p1, p2 + p2.new_tensor(e), 5, 8,
                                         1e-3))
    for q, k, _ in wit:
        spread = torch.maximum(spread, (q.float() - pos_p).abs().amax(-1))
        flip |= k != ok_p
    sensitive = (spread > 1e-2) | flip
    unexplained = int((out & ~sensitive).sum())
    n_out, n_both = int(out.sum()), int(both.sum())
    # the path takes the polish only on an accepted match (m.ok) where it is
    # ok and stays within 2 px of the match
    near = lambda q, k: k & (torch.linalg.norm(q - p2, dim=-1) < 2.0)  # noqa: E731
    acc, acc_p = near(pos, ok) & m01.ok, near(pos_p, ok_p) & m01.ok
    used = acc & acc_p
    err_k1 = float(d[used].max())
    flips, taken = int((acc != acc_p).sum()), int(used.sum())
    w_out = spread[out]
    log(f"[K1] legacy track_level: {n} tracks on level 0 {tuple(pyr0[0].shape)}, W=11 x 8: ok "
        f"{int(ok.sum())} (plain {int(ok_p.sum())}, {int((ok != ok_p).sum())} differ); of "
        f"{n_both} ok in both {n_out} end more than 1e-2 px apart (max "
        f"{float(d[both].max()):.3g} px), {n_out - unexplained} of them decided by round-off "
        f"(the plain version in float64 or from a start 1e-3 px away moves them "
        f"{float(w_out.min()) if n_out else 0.0:.3g}-{float(w_out.max()) if n_out else 0.0:.3g}"
        f" px, {int(flip[out].sum())} change ok), {unexplained} not; of all {n_both}, "
        f"{int(sensitive[both].sum())} are so decided; the polish taken on {taken} matches in "
        f"both ({flips} in one only), there max |d pos| {err_k1:.3g}")
    if not (unexplained == 0 and n_out <= 0.01 * n_both and err_k1 < 1e-2
            and flips <= 0.01 * taken and taken > 0.3 * n):
        raise AssertionError(f"K1 legacy: {n_out} of {n_both} tracks ok in both end apart, "
                             f"{unexplained} not decided by round-off; max |d pos| {err_k1} "
                             f"where the polish is taken, {flips} of {taken} in one only")
    err_k3 = k3_pyramid_check("legacy detection levels (threshold 8)", pyr0[:cfg.n_pyr_levels],
                              cfg.fast_threshold)
    det = pyr0[:cfg.n_pyr_levels]
    rows = {
        "lk track_level (legacy)": measure(
            lambda: lk.track_level(pyr0[0], pyr1[0], p1, p2, 5, 8, 1e-3),
            lambda: lk._track_level_plain(pyr0[0], pyr1[0], p1, p2, 5, 8, 1e-3),
            bound=bounds.k1_pyramid([pyr0[0]], [pyr1[0]], p1, p2, 5, 8, 1e-3),
            max_abs_err=err_k1, shape=f"{n} tracks, level 0 of {tuple(pyr0[0].shape)}, W=11 x 8"),
        "corner_response_pyramid (legacy)": measure(
            lambda: corners.corner_response_pyramid(det, cfg.fast_threshold),
            lambda: [corners._corner_response_plain(img, cfg.fast_threshold) for img in det],
            bound=bounds.k3_corners(det, cfg.fast_threshold), max_abs_err=err_k3,
            shape=f"{len(det)} levels of {tuple(pyr0[0].shape)}, threshold 8"),
    }
    for name, r in rows.items():
        log_row(name, r, card)
    # the path's own launches: two more frames under torch.profiler
    events = profile(lambda: [slam.process(f) for f in frames[LEGACY_N:LEGACY_N + 2]])
    window = per_launch(events, KERNEL_NAMES)
    busy = 1e-3 * sum(us for _, us in events.values())
    log(f"[legacy] device time per launch over 2 more frames under torch.profiler: "
        + ", ".join(f"{k} {us:.2f} us x {c}" for k, (c, us) in window.items())
        + f"; device time {busy / 2:.2f} ms a frame in {sum(c for c, _ in events.values()) // 2} "
        f"kernels ({card})")
    # where a legacy frame's host time goes: the operators by self CPU time
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for f in frames[LEGACY_N + 2:LEGACY_N + 4]:
            slam.process(f)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    log("[legacy] host time over 2 frames by operator (self CPU ms, calls): " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ({e.count})" for e in top) + f" ({card})")
    in_path = {"lk track_level (legacy)": window.get("lk_pyramid"),
               "corner_response_pyramid (legacy)": window.get("corner_response")}
    return launches, rows, in_path


def phase_twoview(card, frames):
    """Phase 8(b): run_twoview.main --init --map on the card over frames 0
    and 8 of the slice written as PNGs (module docstring)."""
    from dr3_tpu_torch import run_twoview

    tmp = tempfile.mkdtemp(prefix="dr3_twoview_")
    try:
        paths = [os.path.join(tmp, f"{i:06d}.png") for i in (0, 8)]
        for p, i in zip(paths, (0, 8)):
            write_png(p, np.clip(frames[i] * 255.0 + 0.5, 0, 255).astype(np.uint8))
        out, mp = os.path.join(tmp, "epipolar.png"), os.path.join(tmp, "map.png")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_twoview.main(paths + ["--init", "--out", out, "--map", mp,
                                           "--device", DEV])
        wall = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        head = next(ln for ln in lines if ln.startswith("matches:"))
        n_inl = int(head.split()[3])
        boot = next(ln for ln in lines if ln.startswith("bootstrap success:"))
        i = lines.index("R =")
        R = np.array([[float(v) for v in ln.strip(" []").split()] for ln in lines[i + 1:i + 4]])
        ang = rot_deg(R, np.eye(3))               # lateral motion: no rotation
        written = [ln for ln in lines if ln.startswith("wrote") or "not written" in ln]
        for ln in [head, boot] + written:
            log("[twoview]   " + ln)
        for p in (out, mp):
            if not (os.path.exists(p) and os.path.getsize(p) > 0
                    or f"{p} not written: matplotlib is not installed" in lines):
                raise AssertionError(f"run_twoview wrote no {p} and did not say why")
        if rc != 0 or not (n_inl > 100 and boot.split()[2] == "True" and ang < 1.0):
            raise AssertionError(f"run_twoview: rc {rc}, {n_inl} F-inliers, {boot}, "
                                 f"rotation error {ang} deg")
        log(f"[twoview] run_twoview.main --init --map on frames 0 and 8 (1240x376): {n_inl} "
            f"F-inliers, bootstrap success, rotation error {ang:.4f} deg, {wall:.2f} s "
            f"on the card ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def nudged(prob, seed):
    """``prob`` with its free poses and its points moved off the optimum
    (seeded, as phase 4b moves its window)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nudge = (0.01 * torch.randn((prob.n_cams, 6), generator=gen)).to(DEV)
    nudge = torch.where(prob.cam_fixed[:, None], torch.zeros_like(nudge), nudge)
    cams = (SE3.exp(nudge) @ prob.cams()).normalize()
    return prob._replace(cam_wxyz=cams.wxyz, cam_t=cams.t, points=prob.points + (
        0.02 * torch.randn(prob.points.shape, generator=gen)).to(DEV))


def compact(prob):
    """``prob`` without its zero-weight rows, its unobserved points and its
    cameras with no observation left: the same cost and the same steps for
    what remains (a dropped point or camera has no residual)."""
    w = prob.obs_w > 0
    oc, op = prob.obs_cam[w].long(), prob.obs_pt[w].long()
    cams, pts = torch.unique(oc), torch.unique(op)
    return prob._replace(cam_wxyz=prob.cam_wxyz[cams], cam_t=prob.cam_t[cams],
                         points=prob.points[pts], cam_fixed=prob.cam_fixed[cams],
                         obs_cam=torch.searchsorted(cams, oc).to(torch.int32),
                         obs_pt=torch.searchsorted(pts, op).to(torch.int32),
                         obs_uv=prob.obs_uv[w], obs_w=prob.obs_w[w])


def phase_dist_ba(card, window_prob, global_prob):
    """Phase 8(c): dist_bundle_adjust on the card over a world-size-1 NCCL
    group (module docstring). The global problem (256 database slots x
    16,384 map slots) is compared in its compact form: past the dense
    guard bundle_adjust's explicit solve takes the pair table, a loop over
    256 slots of [16,384, 256, 6, 6] products; make_mesh(4) also runs on
    the whole problem, as global_refine calls it (one Z per shard: the
    rank's whole Z is past the guard)."""
    import torch.distributed as dist

    from dr3_tpu_torch.parallel.dist_ba import dist_bundle_adjust
    from dr3_tpu_torch.parallel.mesh import make_mesh

    cfg = Config()
    tmp = tempfile.mkdtemp(prefix="dr3_dist_")
    backend = "nccl" if DEV == "cuda" else "gloo"       # the device decides
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        float(r.final_cost)
        return r, 1e3 * (time.perf_counter() - t0)

    def dist_ba(prob, n):
        return timed(lambda: dist_bundle_adjust(prob, max_iters=8,
                                                huber_delta=cfg.ba_huber_delta,
                                                lambda0=cfg.ba_lambda0, mesh=make_mesh(n)))

    rel = lambda x, y: abs(float(x) / float(y) - 1.0)  # noqa: E731
    try:
        if make_mesh(4).group is None or dist.get_backend() != backend:
            raise AssertionError(f"backend {dist.get_backend()}, not {backend}")
        full = nudged(global_prob, SEED + 8)
        for name, prob in (("window", nudged(window_prob, SEED + 8)),
                           ("global (compact)", compact(full))):
            res, walls = {}, {}
            for tag, n in (("mesh4", 4), ("mesh4 again", 4), ("mesh1", 1)):
                res[tag], walls[tag] = dist_ba(prob, n)
            res["explicit"], walls["explicit"] = timed(lambda: bundle_adjust(
                prob, 8, cfg.ba_huber_delta, cfg.ba_jacobi_scaling, cfg.ba_lambda0,
                solver="explicit"))
            a, b = res["mesh4"], res["mesh4 again"]
            same = all(torch.equal(x, y) for x, y in zip(
                (a.initial_cost, a.final_cost, a.problem.cam_wxyz, a.problem.cam_t,
                 a.problem.points),
                (b.initial_cost, b.final_cost, b.problem.cam_wxyz, b.problem.cam_t,
                 b.problem.points)))
            log(f"[dist] {name} problem (K {prob.n_cams}, P {prob.n_points}, O {prob.n_obs}), 8 "
                f"LM iterations: " + ", ".join(
                    f"{k} {float(r.initial_cost):.6f} -> {float(r.final_cost):.6f} "
                    f"({walls[k]:.2f} ms, {int(r.n_accepted)} accepted)" for k, r in res.items())
                + f"; mesh4 repeats bit-equal {same} ({card})")
            if not same:
                raise AssertionError(f"{name}: two make_mesh(4) runs differ")
            m4, m1, ex = res["mesh4"], res["mesh1"], res["explicit"]
            if not (rel(m4.initial_cost, m1.initial_cost) < 1e-5
                    and rel(m4.final_cost, m1.final_cost) < 1e-4):
                raise AssertionError(f"{name}: make_mesh(4) vs make_mesh(1) costs differ")
            if not (rel(m1.initial_cost, ex.initial_cost) < 1e-5
                    and rel(m1.final_cost, ex.final_cost) < 1e-3):
                raise AssertionError(f"{name}: make_mesh(1) vs bundle_adjust explicit differ")
        whole, wall = dist_ba(full, 4)
        log(f"[dist] the whole global problem (K {full.n_cams}, P {full.n_points}, O "
            f"{full.n_obs}), make_mesh(4), as global_refine runs it: {float(whole.initial_cost):.6f}"
            f" -> {float(whole.final_cost):.6f} in {wall:.2f} ms ({card})")
        if not (rel(whole.initial_cost, m4.initial_cost) < 1e-5
                and rel(whole.final_cost, m4.final_cost) < 1e-4):
            raise AssertionError("the whole and the compact global problem differ")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_dist_cli(card, frames, gt, slice_run):
    """Phase 8(d): run_slam.main --distributed over the slice's frames on the
    card (module docstring). The frames go through 8-bit PNGs, so its
    decisions are held to the same CLI without --distributed on the same
    files (phase 4 ran the float frames: a keyframe gate may flip), its
    positions to phase 4's."""
    from dr3_tpu_torch import run_slam
    from dr3_tpu_torch.io.checkpoint import load_vo

    tmp = tempfile.mkdtemp(prefix="dr3_dcli_")
    try:
        seq = os.path.join(tmp, "seq")
        os.makedirs(os.path.join(seq, "image_0"))
        for i, f in enumerate(frames):
            write_png(os.path.join(seq, "image_0", f"{i:06d}.png"),
                      np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8))
        np.savetxt(os.path.join(seq, "times.txt"), 0.1 * np.arange(len(frames)))
        runs = {}
        for name, extra in (("distributed", ["--distributed"]), ("plain", ["--batch", "1"])):
            out = os.path.join(tmp, name)
            t0 = time.perf_counter()
            dec, lines = captured(lambda: run_slam.main(["--seq", seq, "--out", out,
                                                          "--device", DEV] + extra))
            wall = time.perf_counter() - t0
            vo = MonoVO(Pinhole.kitti(), Config(), device=DEV)
            load_vo(os.path.join(out, "final"), vo)
            runs[name] = (dec, lines, vo, wall)
        dec, lines, vo, wall = runs["distributed"]
        n_ba = [int(ln.split()[1]) for ln in lines if ln.startswith("window_BA")]
        head = [ln for ln in lines if ln.startswith("run_slam:")]
        if not head or "1 point-shard mesh" not in head[0]:
            raise AssertionError(f"run_slam --distributed: {head}")
        if vo.stage is not Stage.GENERAL or vo.kf_count < 3 or not n_ba or n_ba[0] < 1:
            raise AssertionError(f"--distributed run: {vo.stage}, {vo.kf_count} keyframes, "
                                 f"window BA {n_ba}")
        if not int(vo.map.n) > 100:
            raise AssertionError(f"--distributed run: map points {int(vo.map.n)}")
        a, length = ate_share(vo.positions(), gt)
        if not a < 0.05 * length:
            raise AssertionError(f"--distributed run: ATE {a} >= 5% of {length}")
        ref = [(s.stage, s.is_keyframe) for s in slice_run["stats"]]
        got = [(st, kf) for _, st, kf in dec]
        plain = [(st, kf) for _, st, kf in runs["plain"][0]]
        d_pos = float(np.abs(vo.positions() - slice_run["positions"]).max())
        d_plain = float(np.abs(vo.positions() - runs["plain"][2].positions()).max())
        flips = [i for i, (x, y) in enumerate(zip(got, ref)) if x != y]
        log(f"[dist] run_slam.main --distributed over {len(frames)} frames in {wall:.2f} s on "
            f"the card (without it, --batch 1: {runs['plain'][3]:.2f} s): {vo.kf_count} "
            f"keyframes, window BA {n_ba[0]}, map points {int(vo.map.n)}, ATE "
            f"{100 * a / length:.3f}% of the path; decisions equal to the same CLI's without "
            f"--distributed {got == plain} (max |d position| {d_plain:.3g}), to phase 4's "
            f"float frames' {got == ref} (frames {flips} differ; max |d position| "
            f"{d_pos:.3g}) ({card})")
        if got != plain or not (d_plain < 5e-3 and d_pos < 5e-3):
            raise AssertionError(f"--distributed: decisions equal {got == plain}, max "
                                 f"|d position| {d_plain} / {d_pos} (phase 4)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_8(card, frames, gt, slice_run, loop_vo):
    """Phase 8: legacy, two-view, distributed (module docstring)."""
    t0 = time.perf_counter()
    legacy = phase_legacy(card, frames)
    phase_twoview(card, frames)
    window = vo_mod._window_problem(slice_run["vo"].kfs, slice_run["vo"].map,
                                    slice_run["vo"].intr, slice_run["vo"].cam.dist)
    glob = lc.global_ba_problem(loop_vo.loop_db, loop_vo.map, loop_vo.intr, loop_vo.cam.dist)
    phase_dist_ba(card, window, glob)
    phase_dist_cli(card, frames[:N_FRAMES], gt[:N_FRAMES], slice_run)
    log(f"[phase 8] {time.perf_counter() - t0:.1f} s")
    return legacy


def long_run(argv):
    """``run_long_sequence.main(argv)`` with its standard output kept and a
    probe after every step (every frame with --batch 1, every 8 frames
    batched): (the MonoVO, the JSON line, the probe's rows, the lines
    before the JSON line, wall s)."""
    rows, held = [], {}

    def probe(vo):
        held["vo"] = vo
        card = vo.device.type == "cuda"
        rows.append(dict(frame=vo.frame_idx, comp=vo.n_compactions, db=vo.n_db_compactions,
                         closures=vo.n_loop_closures, reloc=vo.n_relocalizations,
                         captures=sum(g.captures for g in vo.graphs.values()),
                         programs=len(vo.scan_programs),
                         resident=torch.cuda.memory_allocated() if card else 0,
                         peak=torch.cuda.max_memory_allocated() if card else 0))

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = long_seq.main(argv, on_step=probe)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"run_long_sequence {argv} returned {rc}")
    return held["vo"], json.loads(lines[-1]), rows, lines[:-1], wall


def first_frame(rows, key):
    """The frame after which ``key`` first counted (None if never)."""
    return next((r["frame"] for r in rows if r[key] > 0), None)


def long_summary(tag, out, lines, wall, card):
    for line in lines:
        if line.startswith(("rendering", "long sequence:")):
            log(f"[long] {tag}   {line}")
    log(f"[long] {tag}: {out['frames']} frames {out['resolution']} in {wall:.1f} s (rendering "
        f"included): {out['pipeline_frames_per_sec']:.3f} frames/s after the warm-up, ATE "
        f"{out['ate_rmse']:.5f} = {out['ate_pct_of_trajectory']:.3f}% of a "
        f"{out['trajectory_length']:.3f}-unit path; window keyframes {out['keyframes']}, map "
        f"compactions {out['map_compactions']}, closures {out['loop_closures']}, "
        f"relocalizations {out['relocalizations']}, frames per dispatch "
        f"{out['frames_per_dispatch']} ({card})")


def long_lateral(card):
    """Phase 9(a): the lateral sweeps at full width, every long-horizon
    mechanism; returns (launches, general frames)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in LONG_COUNTERS:
        c.launches = 0
    vo, out, rows, lines, wall = long_run(["--kitti-res", "--profile", "lateral",
                                           "--frames", str(LONG_LATERAL),
                                           f"--max_points={LONG_MAX_POINTS}"])
    launches = {c.__name__: c.launches for c in LONG_COUNTERS}
    # the loop program's warm-up launches are its set-up, not a frame's
    setup = {k: v for p in vo.scan_programs.values() for k, v in p.build_launches.items()}
    for k, v in setup.items():
        launches[k] -= v
    cfg = vo.cfg
    for line in vo.report().splitlines():
        log("[long]   " + line)
    long_summary("(a) lateral", out, lines, wall, card)
    stages = [s.stage for s in vo.stats]
    n_general = stages.count("general")
    n_made = sum(s.is_keyframe for s in vo.stats)
    events = {k: first_frame(rows, k) for k in ("comp", "db", "closures", "reloc")}
    log(f"[long] (a) first map compaction after frame {events['comp']}, first ring compaction "
        f"{events['db']}, first closure {events['closures']}, first relocalization "
        f"{events['reloc']}; ring compactions {vo.n_db_compactions}, keyframes made {n_made} "
        f"(loop database of {cfg.loop_db_capacity}), map cursor {vo.point_cursor} of "
        f"{cfg.max_points}, loop edges {len(vo.loop_edges)}")
    since = [r for r in rows if r["comp"] + r["db"] > 0]
    if not since:
        raise AssertionError(f"no compaction in {LONG_LATERAL} frames: {rows[-1]}")
    at, end = since[0], rows[-1]
    log(f"[long] (a) frame-loop programs {end['programs']} (after the first compaction, frame "
        f"{at['frame']}: {at['programs']}), per-frame step graphs captured {end['captures']}; "
        f"peak device "
        f"memory {at['peak'] / 2**20:.1f} MiB at the first compaction, {end['peak'] / 2**20:.1f} "
        f"MiB at the end; resident {at['resident'] / 2**20:.1f} -> "
        f"{end['resident'] / 2**20:.1f} MiB (max after the first compaction "
        f"{max(r['resident'] for r in since) / 2**20:.1f}) ({card})")
    log(f"[long] (a) launches {launches} (the loop program's set-up {setup} taken out); per "
        f"general frame ({n_general}): "
        + ", ".join(f"{k} {v / n_general:.3f}" for k, v in launches.items()))
    if vo.stage is not Stage.GENERAL:
        raise AssertionError(f"(a) ended in {vo.stage}")
    if min(vo.n_compactions, vo.n_db_compactions, vo.n_loop_closures) < 1 \
            or not n_made > cfg.loop_db_capacity:
        raise AssertionError(f"(a) a long-horizon mechanism never fired: map compactions "
                             f"{vo.n_compactions}, ring compactions {vo.n_db_compactions}, "
                             f"closures {vo.n_loop_closures}, keyframes made {n_made}")
    if not out["ate_pct_of_trajectory"] < 5.0:
        raise AssertionError(f"(a) ATE {out['ate_pct_of_trajectory']}% of the path")
    # one loop program per image shape and width, nothing after the first
    # compaction adds one, and no general frame ran the per-frame step
    if (end["programs"], at["programs"], end["captures"]) != (1, 1, 0):
        raise AssertionError(f"(a) loop programs {at['programs']} -> {end['programs']}, step "
                             f"graphs {end['captures']}")
    if end["peak"] > at["peak"]:
        raise AssertionError(f"(a) peak memory grew after the first compaction: {at['peak']} "
                             f"-> {end['peak']} B")
    one_level = ("track_level", "corner_response")      # the path runs their pyramid forms
    if min(v for k, v in launches.items() if k not in one_level) <= 0:
        raise AssertionError(f"(a) a kernel of the path never launched: {launches}")
    if launches["sparse_align"] != n_general + stages.count("relocalize"):
        raise AssertionError(f"(a) sparse alignment launched {launches['sparse_align']} times "
                             f"for {n_general} general frames")
    # the state's ids after every compaction: each loop edge joins two live
    # database slots, each id a track or the database holds names a live point
    valid_db = vo.loop_db.valid.cpu().numpy()
    if any(not (valid_db[i] and valid_db[j]) for i, j, _, _ in vo.loop_edges):
        raise AssertionError(f"(a) a loop edge names an empty database slot: "
                             f"{[(i, j) for i, j, _, _ in vo.loop_edges]}")
    live = vo.map.valid.cpu().numpy()
    ids = np.concatenate([vo.tracks.point[vo.tracks.valid].cpu().numpy(),
                          vo.loop_db.kp_point[vo.loop_db.valid].cpu().numpy().ravel(),
                          vo.kfs.obs_point[vo.kfs.valid].cpu().numpy().ravel()])
    ids = ids[ids >= 0]
    if not (ids < cfg.max_points).all() or not live[ids].all():
        raise AssertionError("(a) a point id of the tracks, the database or the keyframes "
                             "names a dropped map point")
    log(f"[long] (a) {len(vo.loop_edges)} loop edges on live database slots; {ids.size} point "
        f"ids of tracks, database and keyframes all name live map points")

    # a relocalization on the card: three blank frames lose the track inside
    # the loop, the sweep's first frames bootstrap again, and the general
    # frames launch the loop program built before (every input is copied in
    # per launch)
    prog = next(iter(vo.scan_programs.values())).program
    launches0, reloc0 = prog.launches, vo.n_relocalizations
    _, _, again = long_seq.make_sequence(40, 1240, 376, np.random.default_rng(0))
    blank = np.full_like(again[0], 0.5)
    vo.process_batch([blank] * 3)
    lost = (vo.n_relocalizations - reloc0, vo.stage, vo.db_cursor, len(vo.loop_edges))
    vo.process_batch(again)
    torch.cuda.synchronize()
    traj = np.stack(vo.trajectory)
    log(f"[long] (a) after three blank frames: {lost[0]} relocalization, stage {lost[1].name}, "
        f"database cursor {lost[2]}, loop edges {lost[3]}; 40 frames later {vo.stage.name}, "
        f"loop programs {len(vo.scan_programs)}, launches {launches0} -> {prog.launches}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, resident "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB ({card})")
    if lost != (1, Stage.FIRST, 0, 0) or vo.stage is not Stage.GENERAL:
        raise AssertionError(f"(a) relocalization: {lost}, then {vo.stage}")
    if len(vo.scan_programs) != 1 or vo.graphs or not prog.launches > launches0:
        raise AssertionError(f"(a) after the relocalization: programs {len(vo.scan_programs)}, "
                             f"launches {launches0} -> {prog.launches}")
    if not np.isfinite(traj).all():
        raise AssertionError("(a) a non-finite pose after the relocalization")
    return launches, n_general


def long_forward(card):
    """Phase 9(b): the forward corridor with its rotation-only segment."""
    vo_f, out_f, _, lines_f, wall_f = long_run(["--kitti-res", "--profile", "forward",
                                                "--frames", str(LONG_FORWARD)])
    long_summary("(b) forward", out_f, lines_f, wall_f, card)
    traj = np.stack(vo_f.trajectory)
    made_f = sum(s.is_keyframe for s in vo_f.stats)
    rot = [s.stage for s in vo_f.stats]
    log(f"[long] (b) keyframes made {made_f}, relocalizations {vo_f.n_relocalizations} (not "
        f"gated: the JAX package's run at these settings is not made on the CPU), stages "
        f"{ {st: rot.count(st) for st in sorted(set(rot))} }, final stage {vo_f.stage.name}")
    if traj.shape[0] != LONG_FORWARD or not np.isfinite(traj).all():
        raise AssertionError(f"(b) {traj.shape[0]} poses, finite {np.isfinite(traj).all()}")
    if made_f < 10:
        raise AssertionError(f"(b) {made_f} keyframes")


def long_card_cpu():
    """Phase 9(c): the lateral sweeps at 320x240 on the card and on the CPU
    (plain versions): the same decisions and closures, positions within 1%
    of the path."""
    runs = {}
    for dev in ("cuda", "cpu"):
        v, o, r, ls, w = long_run(["--frames", str(LONG_CPU), "--batch", "1", "--device", dev])
        runs[dev] = (v, o, [x["closures"] for x in r], w)
    dec = {d: [(s.stage, s.is_keyframe) for s in v.stats] for d, (v, _, _, _) in runs.items()}
    at_c = {d: [k for k in range(len(c)) if c[k] != (c[k - 1] if k else 0)]
            for d, (_, _, c, _) in runs.items()}
    diff = float(np.abs(runs["cuda"][0].positions() - runs["cpu"][0].positions()).max())
    length = runs["cuda"][1]["trajectory_length"]
    log(f"[long] (c) {LONG_CPU} frames 320x240 on the card ({runs['cuda'][3]:.1f} s) and the "
        f"CPU ({runs['cpu'][3]:.1f} s): decisions equal {dec['cuda'] == dec['cpu']}, closures at "
        f"frames {at_c['cuda']} / {at_c['cpu']}, keyframes made "
        f"{sum(k for _, k in dec['cuda'])}; max |d position| {diff:.3g} (path {length:.3f})")
    if dec["cuda"] != dec["cpu"] or at_c["cuda"] != at_c["cpu"] or not at_c["cuda"]:
        raise AssertionError(f"(c) card vs CPU decisions or closures differ:\n{dec['cuda']}\n"
                             f"{dec['cpu']}\n{at_c}")
    if not diff < 0.01 * length:
        raise AssertionError(f"(c) card vs CPU positions differ by {diff}")


def phase_long(card):
    """Phase 9: the long-sequence entry point (module docstring)."""
    t0 = time.perf_counter()
    launches, n_general = long_lateral(card)
    long_forward(card)
    long_card_cpu()
    log(f"[phase 9] {time.perf_counter() - t0:.1f} s")
    return launches, n_general


def entry_step_check(tag, got, want, pos_tol, pose_tol):
    """The card's step outputs against the CPU's (tests/test_torch_entry.py's
    tolerances): pyramid 1e-6, valid masks equal, positions of valid tracks,
    pose, cost 1e-4 relative. Returns the valid count."""
    pyr = max(float((a.cpu() - b).abs().max()) for a, b in zip(got[0], want[0]))
    v, vw = got[2].cpu(), want[2]
    if pyr > 1e-6 or not torch.equal(v, vw):
        raise AssertionError(f"entry {tag}: pyramid |d| {pyr}, valid {int(v.sum())} "
                             f"against {int(vw.sum())} ({int((v != vw).sum())} differ)")
    dpos = float((got[1].cpu() - want[1])[v].abs().max()) if v.any() else 0.0
    dpose = max(float((got[k].cpu() - want[k]).abs().max()) for k in (3, 4))
    c, cw = float(got[5]), float(want[5])
    if dpos > pos_tol or dpose > pose_tol or abs(c - cw) > 1e-4 * max(abs(cw), 1.0):
        raise AssertionError(f"entry {tag}: |d pos| {dpos}, |d pose| {dpose}, cost {c} "
                             f"against {cw}")
    log(f"[entry] {tag}: card vs CPU: {int(v.sum())} of {v.numel()} valid in both, max |d "
        f"pos| {dpos:.3g}, max |d pose| {dpose:.3g}, cost {c:.4f} (CPU {cw:.4f})")
    return int(v.sum())


def phase_entry(card):
    """Phase 10 (module docstring): (a) entry()'s step, card against CPU,
    and chained in one CUDA graph; (b) dryrun_multichip(1) and (4); (c) the
    port bench as a subprocess. Returns the launches of every kernel wrapper
    over the phase: (a)-(b) in this process (counters zeroed just before)
    plus each bench child's timed window."""
    t_phase = time.perf_counter()
    wrappers = bench.kernel_wrappers()
    torch.cuda.synchronize()
    for c in wrappers.values():
        c.launches = 0
    # (a) the step on its example inputs and on a rendered pair
    step, args = entry_mod.entry(device=DEV)
    cpu_step, cpu_args = entry_mod.entry(device="cpu")
    for i, (a, b) in enumerate(zip(args[1:], cpu_args[1:])):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"entry: card arg {i + 1} differs from the CPU's")
    got = step(*args)
    torch.cuda.synchronize()
    if lk.track_pyramid.launches != 1:
        raise AssertionError(f"entry: K1 launched {lk.track_pyramid.launches} times in a step")
    entry_step_check("example inputs", got, cpu_step(*cpu_args), 1e-3, 1e-4)
    frames, host, T1 = synth.entry_pair()
    levels = len(args[0])
    dev_in = (tuple(pyramid.build_pyramid(torch.from_numpy(frames[0]).to(DEV), levels)),
              torch.from_numpy(frames[1]).to(DEV), *[torch.from_numpy(a).to(DEV) for a in host])
    cpu_in = (tuple(pyramid.build_pyramid(torch.from_numpy(frames[0]), levels)),
              torch.from_numpy(frames[1]), *[torch.from_numpy(a) for a in host])
    got = step(*dev_in)
    n_valid = entry_step_check("rendered pair", got, cpu_step(*cpu_in), 1e-3, 1e-5)
    dt = float(np.abs(got[4].cpu().numpy() - T1.t).max())
    if n_valid < 0.9 * host[0].shape[0] or dt > 1e-2:
        raise AssertionError(f"entry rendered pair: {n_valid} valid, |d t| to truth {dt}")
    if lk.track_pyramid.launches != 2:
        raise AssertionError(f"entry: K1 launched {lk.track_pyramid.launches} times in 2 steps")
    # chained as bench.py's frontend metric chains it, one graph
    L = levels
    graph = StepGraph(entry_mod.graph_step(step, L), (lk.track_pyramid,))
    h, w = args[1].shape
    lo = torch.tensor([25.0, 25.0], device=DEV)
    hi = torch.tensor([w - 25.0, h - 25.0], device=DEV)
    chain_frames = [args[0][0], args[1]]

    def chain(run, n):
        """(positions after frame ENTRY_EAGER, outputs of the last frame)."""
        pyr, px, wxyz, t = args[0], args[2], args[7], args[8]
        for i in range(n):
            o = run(*pyr, chain_frames[i % 2], px, *args[3:7], wxyz, t)
            pyr, px = o[:L], torch.clamp(o[L], lo, hi)
            wxyz, t = o[L + 2], o[L + 3]
            if i == ENTRY_EAGER - 1:
                early = px
        return early, o

    k0 = lk.track_pyramid.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    px_g, out_g = chain(graph, ENTRY_CHAIN)
    cost = float(out_g[-1])
    wall = time.perf_counter() - t0
    k1 = lk.track_pyramid.launches - k0
    if graph.captures != 1 or graph.replays != ENTRY_CHAIN - 1 or k1 != ENTRY_CHAIN:
        raise AssertionError(f"entry chain: {graph.captures} captures, {graph.replays} "
                             f"replays, K1 {k1} launches over {ENTRY_CHAIN} frames")
    px_e, _ = chain(entry_mod.graph_step(step, L), ENTRY_EAGER)
    dpx = float((px_g - px_e).abs().max())
    if dpx > 1e-4 or not torch.isfinite(out_g[L]).all():
        raise AssertionError(f"entry chain: graph against eager |d px| {dpx} after "
                             f"{ENTRY_EAGER} frames")
    log(f"[entry] {ENTRY_CHAIN} chained frames in one graph: 1 capture, {graph.replays} "
        f"replays, K1 {k1} launches, {1e3 * wall / ENTRY_CHAIN:.3f} ms a frame (host wall "
        f"with the capture); graph vs eager after {ENTRY_EAGER} frames |d px| {dpx:.3g} "
        f"(bit-equal: {dpx == 0.0}), "
        f"last cost {cost:.4f}")
    # (b) the distributed dry runs, one process on one card
    for n in (1, 4):
        t0 = time.perf_counter()
        entry_mod.dryrun_multichip(n, device=DEV)
        log(f"[entry] dryrun_multichip({n}) {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in wrappers.items()}
    log(f"[entry] launches in (a)-(b): {json.dumps(launches)}")
    # (c) the port bench at full width, its depth cut
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_DEPTH)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dr3_tpu_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("[bench]"):
            log(line)
    if proc.returncode != 0:
        raise AssertionError(f"bench rc={proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    log(f"[bench] {' '.join(f'{k}={v}' for k, v in BENCH_DEPTH.items())} "
        f"python -m dr3_tpu_torch.bench ({wall:.1f} s): {lines[-1]}")
    out = json.loads(lines[-1])
    if len(lines) != 1 or set(out) != {"metric", "value", "unit", "vs_baseline", "extra"}:
        raise AssertionError(f"bench: not one JSON line in bench.py's contract: {lines}")
    extra = out["extra"]
    if extra.get("errors"):
        raise AssertionError(f"bench errors: {extra['errors']}")
    values = [out["value"]] + [extra.get(k) for k in (
        "vo_frontend_frames_per_sec_scan", "ba_window_lm_iters_per_sec",
        "ba_bal_lm_iters_per_sec", "panorama_images_per_sec")]
    if not all(v is not None and v > 0 for v in values):
        raise AssertionError(f"bench: a metric is null or zero: {values}")
    for name, need in BENCH_PATHS.items():
        got = extra[f"{name}_detail"]["launches"]
        if not all(got[k] > 0 for k in need):
            raise AssertionError(f"bench {name}: launches {got}, need {need}")
    pl = extra["pipeline_detail"]
    log(f"[bench] pipeline: fps_device_bound {pl['fps_device_bound']} (event-free "
        f"{pl['device_bound_event_free']}, {pl['device_bound_keyframes']} keyframes in the "
        f"chain); stage_breakdown {json.dumps(pl['stage_breakdown'])}")
    if not (pl["fps_device_bound"] and pl["fps_device_bound"] > 0
            and pl["device_bound_event_free"] is True):
        raise AssertionError(f"bench pipeline: fps_device_bound {pl['fps_device_bound']}, "
                             f"event-free {pl['device_bound_event_free']}")
    if not {"scan_dispatch", "scan_fetch"} <= set(pl["stage_breakdown"]):
        raise AssertionError("bench pipeline: the window never ran the loop program")
    fe = extra["frontend_detail"]
    n_fe = int(BENCH_DEPTH["BENCH_FRAMES"])
    if fe["captures"] != 1 or fe["replays"] != n_fe * (int(BENCH_DEPTH["BENCH_REPS"]) + 1) - 1:
        raise AssertionError(f"bench frontend: {fe['captures']} captures, {fe['replays']} "
                             f"replays")
    for name in ("frontend", "window_ba", "bal_ba", "panorama", "pipeline"):
        for k, v in extra[f"{name}_detail"]["launches"].items():
            launches[k] += v
    log(f"[phase 10] {time.perf_counter() - t_phase:.1f} s")
    return launches


def scan_pair(tag, cfg, frames, gt, card, bit_equal=False):
    """One sequence through per-frame ``process`` and through
    ``process_batch`` (the loop program) on the card, counters zeroed
    before each: the same decisions, keyframes, closures at the same
    frames and relocalisations, positions within 1e-5 of the path (equal
    bits with ``bit_equal``), equal launch counts for every kernel (the
    program's warm-up launches, its set-up, taken out), one program
    instantiated, no keyframe handed to the host for its window BA
    (``_REASON_KF_BA``: no mesh). Returns (the batched driver, its
    launches, the two walls, the window BAs that ran inside the loop)."""
    cam = Pinhole.kitti()
    runs, launches, walls = {}, {}, {}
    rows = []
    for mode in ("per-frame", "batched"):
        for c in LONG_COUNTERS:
            c.launches = 0
        vo = MonoVO(cam, cfg, device="cuda")
        closed = []
        close = vo._close_loop

        def spy(my_slot, cand, ver, vo=vo, close=close, closed=closed):
            closed.append(vo.frame_idx)
            return close(my_slot, cand, ver)

        vo._close_loop = spy
        if mode == "batched":
            consume = vo._consume_rows

            def seen(block, consume=consume):
                rows.extend(r for r in block if r[vo_mod._ROW_CONSUMED] > 0.5)
                return consume(block)

            vo._consume_rows = seen
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "batched":
            vo.process_batch(frames)
        else:
            for f in frames:
                vo.process(f)
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
        launches[mode] = {c.__name__: c.launches for c in LONG_COUNTERS}
        runs[mode] = (vo, closed)
    (pf, pf_closed), (bt, bt_closed) = runs["per-frame"], runs["batched"]
    if len(bt.scan_programs) != 1:
        raise AssertionError(f"[scan] {tag}: {len(bt.scan_programs)} loop programs, not 1")
    prog = next(iter(bt.scan_programs.values()))
    for k, v in prog.build_launches.items():
        launches["batched"][k] -= v
    dec = [(s.stage, s.is_keyframe) for s in pf.stats]
    same = dec == [(s.stage, s.is_keyframe) for s in bt.stats] and pf_closed == bt_closed \
        and (pf.kf_count, pf.n_relocalizations, pf.n_window_ba) \
        == (bt.kf_count, bt.n_relocalizations, bt.n_window_ba)
    a_pf, length = ate_share(pf.positions(), gt)
    d = float(np.abs(pf.positions() - bt.positions()).max())
    bit = np.array_equal(pf.positions(), bt.positions())
    n_rows = sum(1 for s in bt.stats if s.stage == "general")
    in_loop = int(sum(r[vo_mod._ROW_BA_IN_LOOP] for r in rows))
    deferred = sum(int(r[vo_mod._ROW_REASON]) == vo_mod._REASON_KF_BA for r in rows)
    log(f"[scan] {tag}: {len(frames)} frames 1240x376, ba_solver {cfg.ba_solver}, per-frame "
        f"{walls['per-frame']:.2f} s, "
        f"process_batch {walls['batched']:.2f} s ({prog.program.launches} program launches, "
        f"{bt.monitor['scan_fetch'].n} reads of rows, build {prog.build_s:.2f} s); "
        f"{bt.kf_count} keyframes, {bt.n_window_ba} window BAs ({in_loop} in the loop, "
        f"{deferred} deferred to the host; {bt.n_cg_iters} CG "
        f"iterations, {pf.n_cg_iters} per-frame), closures at {bt_closed}, "
        f"{bt.n_relocalizations} relocalizations; max |d position| {d:.3g} of a "
        f"{length:.3f}-unit path, bit-equal {bit}; ATE {100 * a_pf / length:.3f}% ({card})")
    log(f"[scan] {tag} launches per-frame {json.dumps(launches['per-frame'])}; batched "
        f"{json.dumps(launches['batched'])}; program set-up {json.dumps(prog.build_launches)}")
    if not same:
        raise AssertionError(f"[scan] {tag}: process_batch decides otherwise than process: "
                             f"closures {pf_closed} / {bt_closed}")
    if not d <= 1e-5 * length or (bit_equal and not bit):
        raise AssertionError(f"[scan] {tag}: positions differ by {d} (path {length})")
    if launches["batched"] != launches["per-frame"]:
        raise AssertionError(f"[scan] {tag}: launch counts differ")
    if bt.n_cg_iters != pf.n_cg_iters or n_rows == 0:
        raise AssertionError(f"[scan] {tag}: CG iterations {bt.n_cg_iters} vs {pf.n_cg_iters}")
    if deferred:
        raise AssertionError(f"[scan] {tag}: {deferred} keyframes handed to the host for their "
                             f"window BA without a mesh")
    return bt, launches["batched"], walls, in_loop


def scan_syncs(tag, cfg, seq):
    """Host synchronisations per ``process_batch`` call of
    ``cfg.frames_per_dispatch`` frames, counted by
    torch.cuda.set_sync_debug_mode, the program built by the first batch
    and counted from the second. Returns (the driver, syncs per batch,
    whether each was event-free, the window BAs each ran)."""
    vo = MonoVO(Pinhole.kitti(), cfg, device="cuda")
    i = 0
    while vo.stage is not Stage.GENERAL or vo.pyr_prev is None:
        vo.process(seq[i])
        i += 1
    vo.process_batch(seq[i:i + cfg.frames_per_dispatch])
    i += cfg.frames_per_dispatch
    syncs, clean, bas = [], [], []
    while i + cfg.frames_per_dispatch <= len(seq):
        n_host = (vo.n_relocalizations, vo.n_loop_closures, vo.n_compactions,
                  vo.n_db_compactions)
        n_ba = vo.n_window_ba
        stacks = []

        def show(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" in str(message):
                stacks.append(traceback.format_stack()[:-1])

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                vo.process_batch(seq[i:i + cfg.frames_per_dispatch])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(len(stacks))
        clean.append(n_host == (vo.n_relocalizations, vo.n_loop_closures, vo.n_compactions,
                                vo.n_db_compactions))
        bas.append(vo.n_window_ba - n_ba)
        if len(stacks) != 1:
            for st in stacks:
                log(f"[scan] {tag}: batch at frame {i}: a synchronising call from\n"
                    + "".join(ln for ln in st if "site-packages" not in ln or "torch" in ln))
        i += cfg.frames_per_dispatch
    log(f"[scan] {tag}: host synchronisations per process_batch call of "
        f"{cfg.frames_per_dispatch} frames after the first: {syncs} (event-free: {clean}; "
        f"window BAs in each: {bas}); keyframes in the run {vo.kf_count}, window BAs "
        f"{vo.n_window_ba}, CG iterations {vo.n_cg_iters}")
    if not syncs or [n for n, c in zip(syncs, clean) if c] != [1] * sum(clean) or not any(clean):
        raise AssertionError(f"[scan] {tag}: event-free batches synchronise {syncs}, not once "
                             f"each")
    return vo, syncs, clean, bas


def phase_scan(card, frames, gt):
    """Phase 11: the device-resident frame loop (module docstring)."""
    t_phase = time.perf_counter()
    cfg = Config()
    # (a) phase 4's frames under Config(): every batch event-free
    bt, launches, _, _ = scan_pair("slice", cfg, frames, gt, card)
    if bt.n_window_ba < 3 or "scan_dispatch" not in bt.monitor.timers:
        raise AssertionError(f"[scan] slice: {bt.n_window_ba} window BAs through the loop")
    # (b) phase 4b's out-and-back: a loop candidate early-outs to the host
    loop_frames = list(frames[:N_OUT]) + list(frames[N_OUT - 1::-1])
    loop_gt = np.concatenate([gt[:N_OUT], gt[N_OUT - 1::-1]])
    lp, loop_launches, _, _ = scan_pair("loop", Config(**LOOP_GATES), loop_frames, loop_gt,
                                        card)
    if lp.n_loop_closures < 1:
        raise AssertionError("[scan] loop: no closure through process_batch")
    # (c) a relocalisation mid-batch: four black frames after frame 12
    black = [np.zeros_like(frames[0])] * 4
    rl, reloc_launches, _, _ = scan_pair("relocalize", Config(loop_closure=False),
                                         list(frames[:13]) + black + list(frames[13:28]),
                                         np.concatenate([gt[:13], np.repeat(gt[12:13], 4, 0),
                                                         gt[13:28]]), card)
    if rl.n_relocalizations < 1:
        raise AssertionError("[scan] relocalize: no relocalization")
    # (d) host synchronisations: one per event-free batch of 16 frames over
    # the slice's frames out and back (no closure: Config()'s 100-frame gap)
    seq = list(frames) + list(frames[::-1])
    scan_syncs("pcg", cfg, seq)
    out = [launches, loop_launches, reloc_launches]
    # (e) the dense window solves inside the loop (no _REASON_KF_BA early-out):
    # window BA's LM steps with the dense camera step (Z^T Z or the dense
    # tables, the Cholesky and both triangular solves) captured in the
    # program's pieces, no CG loop; the per-frame bits, and one sync per
    # event-free batch with a keyframe and its window BA inside
    for solver in ("zexplicit", "explicit"):
        dcfg = Config(ba_solver=solver)
        dn, dense_launches, _, in_loop = scan_pair(solver, dcfg, frames, gt, card,
                                                   bit_equal=True)
        if in_loop < 1 or dn.n_cg_iters != 0:
            raise AssertionError(f"[scan] {solver}: {in_loop} window BAs in the loop, "
                                 f"{dn.n_cg_iters} CG iterations")
        idle = [k for k in ("track_pyramid", "align_to_templates", "sample_patches",
                            "sparse_align", "corner_response_pyramid", "remap_xy")
                if dense_launches[k] < 1]
        if idle:
            raise AssertionError(f"[scan] {solver}: the loop launched no {idle}")
        _, syncs, clean, bas = scan_syncs(solver, dcfg, seq)
        if not any(c and n == 1 and b > 0 for n, c, b in zip(syncs, clean, bas)):
            raise AssertionError(f"[scan] {solver}: no event-free batch with a window BA "
                                 f"inside synchronised once ({syncs}, {clean}, {bas})")
        out.append(dense_launches)
    log(f"[scan] phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(d[k] for d in out) for k in launches}


def print_table(rows, per, in_path, card):
    """The kernel table: launches on its path's run per general frame (VO)
    or per panorama (K4); device us per launch at the row's shape (100
    launches alone), its bound and share, the library call's; device us
    per launch in the path's profiled window (all its shapes)."""
    log(f"[table] kernel | launches per frame or panorama | device us | bound us (by) | "
        f"share | library us | plain device us | device us in the path ({card})")
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        seen = in_path.get(name)
        seen = "not in the path" if seen is None else f"{seen[1]:.2f} (x{seen[0]})"
        log(f"[table] {name} ({r['shape']}) | {per.get(name, 'not on a counted path')} | "
            f"{1e3 * r['ms']:.2f} | {1e3 * r['bound_ms']:.3f} ({r['bound_by']}) | "
            f"{100 * r['share']:.1f}% | {lib} | {1e3 * r['plain_ms']:.2f} | {seen}")


def main():
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    cam = Pinhole.kitti()
    t0 = time.perf_counter()
    frames, gt = render(cam, N_FRAMES + N_PROFILED, STEP, SEED, 2000)
    log(f"[setup] rendered {len(frames)} frames {frames[0].shape} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pano_cases = render_panorama_cases()
    log(f"[setup] rendered the panorama views in {time.perf_counter() - t0:.1f} s")
    results = phase_kernels(card, frames)
    k4_results, k4_rows = phase_k4_kernels(card, pano_cases)
    results.update(k4_results)
    loop_rows, loop_err = phase_loop_kernels(card, frames)
    results["remap"]["max_abs_err"] = max(results["remap"]["max_abs_err"], loop_err)
    align_errs, pano_rows = phase_align_kernels(card, pano_cases)
    for name, err in align_errs.items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    launches, n_general, slice_window, n_kf, slice_run = phase_slice(
        card, frames[:N_FRAMES], gt[:N_FRAMES], frames[N_FRAMES:])
    loop_vo = phase_loop(card, frames[:N_FRAMES], gt[:N_FRAMES])
    phase_cpu_reference()
    pano_launches, pano_wrappers, n_panoramas, pano_window, pastes = phase_panorama(card,
                                                                                     pano_cases)
    phase_cpu_panorama()
    phase_cli(card, frames[:N_FRAMES], gt[:N_FRAMES], slice_run)
    bal_launches = phase_bal(card, slice_run["vo"])
    schur_rows = dict(zip(("dr3_schur_factor", "dr3_schur_blocks"), phase_schur_kernel(card)))
    mv_row, mv_launches, mv_cg = phase_schur_mv(card)
    legacy_launches, legacy_rows, legacy_in_path = phase_8(card, frames, gt, slice_run, loop_vo)
    long_launches, long_general = phase_long(card)
    entry_launches = phase_entry(card)
    scan_launches = phase_scan(card, frames[:N_FRAMES], gt[:N_FRAMES])

    # dr3_remap and dr3_warp each replace both TPU warp kernels: the
    # Catmull-Smith passes K4a and K4b compose into one direct sampler
    k4 = "dr3_tpu/ops/pallas/warp_pallas.py:83,158"
    counts = {"corner_response": launches["corner_response_pyramid"]
              + launches["corner_response"],
              "corner_response_pyramid": launches["corner_response_pyramid"],
              "lk_pyramid": launches["track_pyramid"] + launches["track_level"],
              "lk_align": launches["align_to_templates"],
              "sample_patches": launches["sample_patches"],
              "sparse_align": launches["sparse_align"],
              "remap": pano_launches["K4 remap"] + launches["remap_xy"],
              "warp": pano_launches["K4 warp"]}
    vo_rows = ("lk_pyramid", "lk_align", "sample_patches", "sparse_align", "corner_response",
               "corner_response_pyramid")
    per = {name: f"{counts[name] / n_general:.3f} per general frame" for name in vo_rows}
    per["corner_response"] = (f"{launches['corner_response'] / n_general:.3f} per general "
                              f"frame (the path runs the pyramid form)")
    for name, counter in (("lk_pyramid (panorama)", "track_pyramid"),
                          ("corner_response (panorama)", "corner_response"),
                          ("corner_response_pyramid (panorama)", "corner_response_pyramid"),
                          *[(c.__name__, c.__name__) for c in K4_COUNTERS["remap"]],
                          *[(c.__name__, c.__name__) for c in K4_COUNTERS["warp"]]):
        per[name] = f"{pano_wrappers[counter] / n_panoramas:.2f} per panorama"
    per["warp_perspective (paste)"] = f"{pastes:.2f} per TRANSLATE panorama"
    cfg = Config()
    per["remap_xy (loop descriptors)"] = (f"2 per keyframe, 0 per non-keyframe; "
                                          f"{launches['remap_xy'] / n_general:.3f} per general "
                                          f"frame, all remap_xy ({n_kf} keyframes)")
    per["remap_xy (loop query rotation)"] = (f"{cfg.loop_query_rotations - 1} per general "
                                             f"keyframe, 0 per non-keyframe")
    # the profiled windows' kernels (names as in KERNEL_NAMES); the profiled
    # panorama is a TRANSLATE one, whose perspective warps are all pastes
    in_path = {name: slice_window.get(name) for name in vo_rows}
    in_path.update({"corner_response": None,
                    "corner_response_pyramid": slice_window.get("corner_response"),
                    "lk_pyramid (panorama)": pano_window.get("lk_pyramid"),
                    "corner_response_pyramid (panorama)": pano_window.get("corner_response"),
                    "remap_xy": pano_window.get("remap_xy"),
                    "warp_spherical": pano_window.get("warp_spherical"),
                    "warp_perspective": None,
                    "warp_perspective (paste)": pano_window.get("warp_perspective"),
                    "remap_xy (loop descriptors)": slice_window.get("remap_xy"),
                    "remap_xy (loop query rotation)": slice_window.get("remap_xy")})
    per["lk track_level (legacy)"] = (f"{legacy_launches['track_level'] / LEGACY_N:.3f} per "
                                      f"legacy frame (1 per frame after the first)")
    per["corner_response_pyramid (legacy)"] = (
        f"{legacy_launches['corner_response_pyramid'] / LEGACY_N:.3f} per legacy frame")
    in_path.update(legacy_in_path)
    # phase 9(a)'s launches, per general frame of the long run, beside phase 4's
    long_counts = {"corner_response": long_launches["corner_response_pyramid"]
                   + long_launches["corner_response"],
                   "corner_response_pyramid": long_launches["corner_response_pyramid"],
                   "lk_pyramid": long_launches["track_pyramid"] + long_launches["track_level"],
                   "lk_align": long_launches["align_to_templates"],
                   "sample_patches": long_launches["sample_patches"],
                   "sparse_align": long_launches["sparse_align"],
                   "remap": long_launches["remap_xy"], "warp": 0}
    for name in vo_rows:
        per[name] += (f"; {long_counts[name] / long_general:.3f} over the long run's "
                      f"{long_general}")
    per["remap_xy (loop descriptors)"] += (f"; {long_counts['remap'] / long_general:.3f} per "
                                           f"general frame over the long run's {long_general}")
    # phase 10's launches: its in-process steps and the bench children's
    # timed windows, by wrapper name
    e = entry_launches
    entry_counts = {"corner_response": e["corner_response_pyramid"] + e["corner_response"],
                    "corner_response_pyramid": e["corner_response_pyramid"],
                    "lk_pyramid": e["track_pyramid"] + e["track_level"],
                    "lk_align": e["align_to_templates"],
                    "sample_patches": e["sample_patches"], "sparse_align": e["sparse_align"],
                    "remap": sum(e[c.__name__] for c in K4_COUNTERS["remap"]),
                    "warp": sum(e[c.__name__] for c in K4_COUNTERS["warp"])}
    # phase 11's launches: the batched runs of its three sequences
    s = scan_launches
    scan_counts = {"corner_response": s["corner_response_pyramid"] + s["corner_response"],
                   "corner_response_pyramid": s["corner_response_pyramid"],
                   "lk_pyramid": s["track_pyramid"] + s["track_level"],
                   "lk_align": s["align_to_templates"], "sample_patches": s["sample_patches"],
                   "sparse_align": s["sparse_align"], "remap": s["remap_xy"], "warp": 0}
    for name, n in zip(schur_rows, bal_launches):
        per[name] = f"{n / 5:.1f} per zexplicit LM iteration (phase 7(a), {n} in 5)"
    per["dr3_schur_mv"] = (f"{mv_launches / mv_cg:.1f} per generic CG iteration (a Ladybug "
                           f"solve of 2 LM iterations, {mv_launches} in {mv_cg})")
    print_table({**{k: results[k] for k in vo_rows}, **pano_rows, **k4_rows, **loop_rows,
                 **legacy_rows, **schur_rows, "dr3_schur_mv": mv_row}, per, in_path, card)
    log(f"[legacy] launches over its {LEGACY_N} frames (the VO path's are the JSON line's): "
        f"{json.dumps(legacy_launches)}")
    meta = {
        "corner_response": ("dr3_tpu_torch/csrc/detect.cu",
                            "dr3_tpu/ops/pallas/detect_pallas.py:54"),
        "corner_response_pyramid": ("dr3_tpu_torch/csrc/detect.cu",
                                    "dr3_tpu/ops/pallas/detect_pallas.py:54"),
        "lk_pyramid": ("dr3_tpu_torch/csrc/lk.cu", "dr3_tpu/ops/pallas/lk_pallas.py:117"),
        "lk_align": ("dr3_tpu_torch/csrc/lk.cu", "dr3_tpu/ops/pallas/lk_pallas.py:117"),
        "sample_patches": ("dr3_tpu_torch/csrc/sample.cu",
                           "dr3_tpu/ops/pallas/lk_pallas.py:338"),
        "sparse_align": ("dr3_tpu_torch/csrc/sparse_align.cu",
                         "dr3_tpu/ops/pallas/lk_pallas.py:338"),
        "remap": ("dr3_tpu_torch/csrc/warp.cu", k4),
        "warp": ("dr3_tpu_torch/csrc/warp.cu", k4),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name] + long_counts[name] + entry_counts[name]
                        + scan_counts[name],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "host_ms": r["host_ms"], "plain_host_ms": r["plain_host_ms"]})
    # launches: phase 7(a)'s auto solve of 5 LM iterations, counted from zero
    for (name, r), n in zip(schur_rows.items(), bal_launches):
        kernels.append({"name": name.removeprefix("dr3_"), "route": "cuda",
                        "source": "dr3_tpu_torch/csrc/schur.cu", "replaces": None,
                        "launches": n, "launches_per_lm_iter": n / 5,
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "host_ms",
                                             "plain_host_ms")}})
    # launches: phase_schur_mv's 2-iteration Ladybug solve
    kernels.append({"name": "schur_mv", "route": "cuda", "source": "dr3_tpu_torch/csrc/schur_mv.cu",
                    "replaces": None, "launches": mv_launches,
                    "launches_per_cg_iter": mv_launches / mv_cg,
                    **{k: mv_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "host_ms",
                                              "plain_host_ms")}})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
