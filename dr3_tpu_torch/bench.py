"""Benchmark of the port: monocular VO throughput, BA solver speed and the
panorama on one CUDA card (counterpart of the repository's root
``bench.py``: the same metrics, shapes, Config and JSON line).

    python -m dr3_tpu_torch.bench

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.

HEADLINE metric: wall-clock frames/s of the whole ``MonoVO`` driver with
every flagship stage on (sparse image alignment, LK tracking, pose GN,
keyframing, triangulation, window BA, loop closure) at KITTI's 1240x376,
over ``BENCH_PIPELINE_FRAMES`` frames, ``process_batch`` uploading
``BENCH_BATCH`` frames at a time. A general frame is one CUDA-graph replay
and one host read. The headline is a composite of two phases: steady-state
tracking of already-mapped content (after a warm-up that runs until
keyframes, a closure and a loop-database compaction have fired, capped at
60% of the frames) and a keyframe-heavy mapping pass of a fresh driver.

``extra`` carries the supporting metrics:

* ``vo_frontend_frames_per_sec_scan`` — the tracking step alone
  (:func:`dr3_tpu_torch.entry.entry`: pyramid + K1 LK + pose GN) as one
  CUDA graph replayed back to back over ``BENCH_FRAMES`` chained frames,
  ``BENCH_REPS`` reps, one host read at the end;
* ``ba_window_lm_iters_per_sec`` — ``bundle_adjust`` (the default solver)
  at the window's shape: 32 keyframes x 16,384 points x 546 slots;
* ``ba_bal_lm_iters_per_sec`` — ``bundle_adjust_snavely`` at BAL scale,
  120 cameras x 60,000 points x 480,000 observations;
* ``panorama_images_per_sec`` — ``Panorama`` TRANSLATE, f 600, feather 40,
  8 views.

vs_baseline: the reference publishes no numbers, so the anchor is the KITTI
capture rate, 10 frames/s: vs_baseline = x means x times real time.

Fixtures. The KITTI frames ``imgs/kitti0-9.png`` and the ``imgs/field``
panorama set of the reference repository are read from ``imgs/`` at the
root of this repository when they are there. Without them the frames are
rendered from a seed (``extra.frames_source``, ``extra.panorama_source``
say which): the pipeline runs on
``tools/run_long_sequence.make_sequence``'s lateral sweeps at 1240x376
(out and back with a period of 100 frames, so later periods revisit the
first; the camera they were rendered with), the front end on ``entry()``'s
two images, the panorama on 8 views of a textured sphere, 640x480, 0.35
rad apart (``utils/synth.panorama_views``). The sweeps are not cycled as a
palindrome of their first 10 frames, as the fixtures are: those frames
move the camera 0.11 units, too little parallax for the two-view
initialisation, so a palindrome of them never leaves bootstrap.

Crash isolation: each metric runs in its own subprocess (``--metric X``
re-invokes this module), one after another (the first builds the CUDA
kernels into build/, the later ones load them). A failed metric costs only
itself: the parent reports it under ``extra.errors``. The parent imports
no CUDA state. Each child's ``detail`` holds the kernel wrappers'
launches over its timed window.

Environment: ``BENCH_FRAMES`` (120), ``BENCH_REPS`` (10),
``BENCH_PIPELINE_FRAMES`` (420), ``BENCH_BATCH`` (32), ``BENCH_SKIP_BA``,
``BENCH_SKIP_PIPELINE`` as in the root bench.py, and ``BENCH_DEVICE``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions, for
debugging the harness: its numbers are no device metric).

Deliberate differences from the root bench.py: the port compiles no
programs, so there is no compile cache to enable; it has no scan program,
so the pipeline's ``fps_device_bound`` (a chain of scan dispatches with one
fetch) is null with a note — the front-end metric already times the
graph's replays back to back.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# (name, per-subprocess timeout seconds), cheapest first, as the root bench.py
METRICS = (
    ("frontend", 2700),
    ("window_ba", 1800),
    ("bal_ba", 1800),
    ("panorama", 1800),
    ("pipeline", 2700),
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference repository's fixture layout, looked for inside this one
FIXTURES = os.path.join(ROOT, "imgs")
RENDERED_FRAMES = "rendered: run_long_sequence.make_sequence lateral sweeps, period 100"
RENDERED_PANORAMA = "rendered: synth.panorama_views, 8 sphere views 640x480, 0.35 rad"


def _device():
    """The child's device: ``BENCH_DEVICE`` (default the card; raises
    without one)."""
    import torch

    from dr3_tpu_torch.utils.device import resolve

    dev = resolve(os.environ.get("BENCH_DEVICE") or "cuda", "bench")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_wrappers():
    """name -> kernel wrapper, for every kernel of the port (K1-K4)."""
    from dr3_tpu_torch.ops import corners, lk, sparse_align, warp

    fns = (lk.track_pyramid, lk.track_level, lk.align_to_templates, lk.sample_patches,
           sparse_align.sparse_align, corners.corner_response,
           corners.corner_response_pyramid, warp.remap_xy, warp.remap_rows,
           warp.remap_cols, warp.warp_perspective, warp.warp_spherical,
           warp.warp_cylindrical)
    return {f.__name__: f for f in fns}


def _launches() -> dict:
    return {name: f.launches for name, f in kernel_wrappers().items()}


def _added(before: dict, after: dict) -> dict:
    """Launches between two snapshots (:func:`_launches`)."""
    return {k: after[k] - before[k] for k in after}


def fixture_frames():
    """The reference's KITTI frames (float32 [376, 1240] in [0, 1]) from
    ``imgs/`` when all ten are there, else None."""
    from dr3_tpu_torch.io.kitti import open_fixture_sequence

    if not os.path.isdir(FIXTURES):
        return None
    seq = open_fixture_sequence(FIXTURES)
    if len(seq) < 10:
        return None
    return [np.asarray(seq.frame(i), np.float32) for i in range(len(seq))]


def _bench_frontend(dev):
    """(frames/s, detail): entry()'s step as one CUDA graph, chained over
    BENCH_FRAMES frames per rep (positions clipped to the frame less 25 px
    and fed back, the track mask fixed), BENCH_REPS reps after a warm-up
    rep that captures the graph; one host read ends the timed window. On
    the CPU the same step runs eagerly."""
    import torch

    from dr3_tpu_torch.entry import entry, graph_step
    from dr3_tpu_torch.ops import lk
    from dr3_tpu_torch.utils.cudagraph import StepGraph

    step, args = entry(device=dev)
    (pyr_prev, img_cur, track_px, track_valid, track_point,
     map_xyz, map_valid, pose_wxyz, pose_t) = args
    fixtures = fixture_frames()
    if fixtures is not None:
        frames = [torch.from_numpy(f).to(dev) for f in fixtures]
    else:
        frames = [pyr_prev[0], img_cur]
    h, w = img_cur.shape
    lo = torch.tensor([25.0, 25.0], device=dev)
    hi = torch.tensor([w - 25.0, h - 25.0], device=dev)
    n_levels = len(pyr_prev)
    flat = graph_step(step, n_levels)
    run_step = StepGraph(flat, (lk.track_pyramid,)) if dev.type == "cuda" else flat
    n_frames = int(os.environ.get("BENCH_FRAMES", "120"))

    def run():
        pyr, px, wxyz, t = tuple(pyr_prev), track_px, pose_wxyz, pose_t
        cost = None
        for i in range(n_frames):
            out = run_step(*pyr, frames[i % len(frames)], px, track_valid, track_point,
                           map_xyz, map_valid, wxyz, t)
            pyr = out[:n_levels]
            # keep the track table full and in-frame so every frame does
            # identical work
            px = torch.clamp(out[n_levels], lo, hi)
            wxyz, t, cost = out[n_levels + 2], out[n_levels + 3], out[n_levels + 4]
        return px, cost

    px, cost = run()                       # warm-up: the capture and its replays
    float(cost)
    reps = int(os.environ.get("BENCH_REPS", "10"))
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        px, cost = run()
    final_cost = float(cost)               # the one host read
    dt = time.perf_counter() - t0
    detail = {"frames_source": "fixtures" if fixtures is not None
              else "rendered: entry() args' two random images",
              "frames_per_rep": n_frames, "reps": reps, "final_cost": final_cost,
              "launches": _added(before, _launches())}
    if dev.type == "cuda":
        detail.update(captures=run_step.captures, replays=run_step.replays)
    return reps * n_frames / dt, detail


def _window_problem(rng, n_cams=32, n_pts=16384, n_tracks=546, device="cpu"):
    """Synthetic BA problem at the VO window's production shapes: the root
    bench.py's, drawn from ``rng`` in its order (the projection runs on the
    CPU in float32), then moved to ``device``."""
    import torch

    from dr3_tpu_torch.ba.problem import make_problem, project
    from dr3_tpu_torch.geometry.lie import SE3

    intr = torch.tensor([718.856, 718.856, 607.19, 185.22])
    pts = np.stack([rng.uniform(-20, 20, n_pts), rng.uniform(-5, 5, n_pts),
                    rng.uniform(5, 60, n_pts)], -1).astype(np.float32)
    taus = np.zeros((n_cams, 6), np.float32)
    taus[:, 2] = -0.8 * np.arange(n_cams)
    cams = SE3.exp(torch.as_tensor(taus))
    # window layout: one obs slot per (keyframe, track)
    obs_cam = np.repeat(np.arange(n_cams), n_tracks).astype(np.int32)
    obs_pt = np.concatenate([
        (rng.permutation(n_pts)[:n_tracks]).astype(np.int32)
        for _ in range(n_cams)])
    uv = project(intr, cams[torch.as_tensor(obs_cam).long()].apply(
        torch.as_tensor(pts)[obs_pt])).numpy()
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    w = (np.abs(uv[:, 0] - 607) < 650) & (np.abs(uv[:, 1] - 185) < 230)

    def put(a):
        return torch.as_tensor(a).to(device)

    return make_problem(SE3(cams.wxyz.to(device), cams.t.to(device)), put(pts0),
                        intr.to(device), put(obs_cam), put(obs_pt), put(uv),
                        obs_w=put(w.astype(np.float32)))


def _bench_window_ba(dev, rng):
    """(LM iterations/s, detail): bundle_adjust(prob, 10) with its defaults,
    one warm-up, 5 timed reps, each ending in a host read of the cost."""
    from dr3_tpu_torch.ba.schur_lm import bundle_adjust

    prob = _window_problem(rng, device=dev)
    iters = 10
    res = bundle_adjust(prob, iters)       # warm-up
    float(res.final_cost)
    reps = 5
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = bundle_adjust(prob, iters)
        float(res.final_cost)              # a host read ends each rep
    dt = time.perf_counter() - t0
    return reps * iters / dt, {"final_cost": float(res.final_cost),
                               "initial_cost": float(res.initial_cost),
                               "launches": _added(before, _launches())}


def _bench_bal_ba(dev):
    """(LM iterations/s, detail): bundle_adjust_snavely(prob, 5,
    huber_delta=1e9) at BAL scale (the root bench.py's problem and draws,
    tools/ba_time.bal_case), the default solver; one warm-up, 3 timed
    reps, each ending in a host read of the cost."""
    from dr3_tpu_torch.ba.snavely import bal_to_snavely, bundle_adjust_snavely
    from dr3_tpu_torch.tools.ba_time import bal_case

    prob = bal_to_snavely(bal_case(seed=0)[0], device=dev)
    iters = 5
    res = bundle_adjust_snavely(prob, iters, huber_delta=1e9)   # warm-up
    float(res.final_cost)
    reps = 3
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = bundle_adjust_snavely(prob, iters, huber_delta=1e9)
        float(res.final_cost)
    dt = time.perf_counter() - t0
    return reps * iters / dt, {"final_cost": float(res.final_cost),
                               "launches": _added(before, _launches())}


def _bench_panorama(dev):
    """(images/s, detail): Panorama TRANSLATE (f 600, feather 40) over the
    ``field`` set or the rendered sphere views: one warm run, 3 timed runs,
    each ending in a host read of the canvas."""
    from dr3_tpu_torch.io.image import load_image_dir
    from dr3_tpu_torch.pipelines.panorama import Panorama, PanType
    from dr3_tpu_torch.utils import synth

    field = os.path.join(FIXTURES, "field")
    if os.path.isdir(field):
        images, source = load_image_dir(field), "fixtures"
    else:
        images = synth.panorama_views(np.random.default_rng(2))["views"]
        source = RENDERED_PANORAMA
    pan = Panorama(focal_length=600.0, pan_type=PanType.TRANSLATE, feathering_width=40,
                   device=dev)
    out = pan.process(images)              # warm-up
    if out.shape[0] == 0:
        raise RuntimeError("panorama: empty canvas")
    reps = 3
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = pan.process(images)
        float(out.mean())                  # a host read ends each run
    dt = time.perf_counter() - t0
    return reps * len(images) / dt, {"panorama_source": source, "images": len(images),
                                     "canvas": list(out.shape),
                                     "launches": _added(before, _launches())}


def pipeline_frames(n_total: int, width: int = 1240, height: int = 376):
    """(camera, ``n_total`` uint8 frames, source): the fixture palindrome
    (0..9, 8..1, 0..9, ...) when the KITTI frames are there, else the
    rendered lateral sweeps (module docstring), quantised to uint8 once."""
    from dr3_tpu_torch.models.camera import Pinhole
    from dr3_tpu_torch.tools.run_long_sequence import make_sequence

    base = fixture_frames() if (width, height) == (1240, 376) else None
    if base is not None:
        cam, source = Pinhole.kitti(), "fixtures"
        base = base + base[-2:0:-1]
    else:
        cam, _poses, base = make_sequence(n_total, width, height, np.random.default_rng(0),
                                          "lateral")
        source = RENDERED_FRAMES
    frames = [np.clip(f * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8) for f in base]
    return cam, [frames[i % len(frames)] for i in range(n_total)], source


def _bench_pipeline(dev, cam=None, frames=None, source=None):
    """(frames/s, detail): the whole MonoVO over the palindrome (module
    docstring): warm-up, the steady window on a fresh Monitor, then a fresh
    driver's mapping pass (bootstrap on 4 frames outside the window, up to
    96 timed). ``cam``, ``frames`` and ``source`` default to
    :func:`pipeline_frames` at 1240x376."""
    from dr3_tpu_torch.pipelines.vo import MonoVO
    from dr3_tpu_torch.utils.config import Config

    n_total = int(os.environ.get("BENCH_PIPELINE_FRAMES", "420"))
    if frames is None:
        cam, frames, source = pipeline_frames(n_total)
    n_total = len(frames)
    # the root bench.py's Config: loop_min_gap_frames=20 because the
    # palindrome's content period is 18 frames, loop_db_capacity=24 so the
    # database's ring compaction runs within the run; batch 32 (uploads per
    # group here; scan_transfer_uint8 has no effect in the port)
    cfg = Config(loop_min_gap_frames=20, loop_db_capacity=24,
                 frames_per_dispatch=int(os.environ.get("BENCH_BATCH", "32")),
                 scan_transfer_uint8=True)
    vo = MonoVO(cam, cfg, device=dev)
    # warm until keyframes, a loop closure and a database compaction have
    # all fired (the CUDA graph and every kernel's first use land outside
    # the window), capped at 60% of the frames
    warm = 0
    cap = int(0.6 * n_total)
    while warm < cap:
        vo.process_batch(frames[warm:warm + cfg.frames_per_dispatch])
        warm = vo.frame_idx + 1
        if (vo.kf_count >= 5 and vo.n_loop_closures >= 1
                and vo.n_db_compactions >= 1 and warm >= 12):
            break
    warm_kf, warm_lc, warm_dbc = vo.kf_count, vo.n_loop_closures, vo.n_db_compactions
    n_stats0, lc0 = len(vo.stats), vo.n_loop_closures
    disc0 = vo.n_discarded_batches
    vo.monitor = type(vo.monitor)()        # timed-window-only stage breakdown
    _sync(dev)
    before = _launches()
    t0 = time.perf_counter()
    vo.process_batch(frames[warm:])
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = _added(before, _launches())
    n_timed = n_total - warm
    stages = {name: {"n": tm.n, "avg_ms": round(1e3 * tm.average, 2)}
              for name, tm in vo.monitor.timers.items()}

    # mapping phase: a fresh driver re-maps the content from scratch, so
    # this window is keyframe-heavy (the steady window can hold few or none
    # once the looped content is mapped)
    vo2 = MonoVO(cam, cfg, device=dev)
    vo2.process_batch(frames[:4])          # bootstrap outside the window
    n_map = min(96, n_total - 4)
    s0 = len(vo2.stats)
    _sync(dev)
    before = _launches()
    t0 = time.perf_counter()
    vo2.process_batch(frames[4:4 + n_map])
    _sync(dev)
    dt2 = time.perf_counter() - t0
    mapped = _added(before, _launches())
    launches = {k: launches[k] + mapped[k] for k in launches}
    map_kf = sum(1 for s in vo2.stats[s0:] if s.is_keyframe)

    return (n_timed + n_map) / (dt + dt2), {
        "fps_steady_state": round(n_timed / dt, 3),
        "fps_mapping_phase": round(n_map / dt2, 3),
        "fps_device_bound": None,
        "device_bound_event_free": None,
        "device_bound_note": "no scan program in the port: a frame is one graph replay "
                             "and one host read, so there is no chain of dispatches to "
                             "time; the frontend metric times the replays back to back",
        "timed_frames": n_timed + n_map,
        "warmup_frames": warm,
        "warmup_reached": {"kf_count": warm_kf, "loop_closures": warm_lc,
                           "db_compactions": warm_dbc},
        "timed_keyframes": sum(1 for s in vo.stats[n_stats0:] if s.is_keyframe) + map_kf,
        "loop_closures_total": vo.n_loop_closures,
        "loop_closures_timed": vo.n_loop_closures - lc0 + vo2.n_loop_closures,
        "mapping_phase_keyframes": map_kf,
        "discarded_speculative_batches": (vo.n_discarded_batches - disc0
                                          + vo2.n_discarded_batches),
        "frames_per_dispatch": cfg.frames_per_dispatch,
        "speculation_depth": cfg.scan_speculation_depth,
        "stage_breakdown": stages,
        "frames_source": source,
        "launches": launches,
    }


def run_one(name: str) -> None:
    """Child-process entry: run one metric, print one JSON line."""
    dev = _device()
    rng = np.random.default_rng(0)
    if name == "frontend":
        val, detail = _bench_frontend(dev)
    elif name == "window_ba":
        val, detail = _bench_window_ba(dev, rng)
    elif name == "bal_ba":
        val, detail = _bench_bal_ba(dev)
    elif name == "panorama":
        val, detail = _bench_panorama(dev)
    elif name == "pipeline":
        val, detail = _bench_pipeline(dev)
    else:
        raise SystemExit(f"unknown metric {name}")
    detail["device"] = str(dev)
    print(json.dumps({"bench_metric": name,
                      "value": None if val is None else round(float(val), 3),
                      "detail": detail}))


def main():
    from dr3_tpu_torch.tools.run_long_sequence import card_name

    results: dict[str, float] = {}
    details: dict[str, dict] = {}
    errors: dict[str, str] = {}
    skip = {
        "window_ba": os.environ.get("BENCH_SKIP_BA", "0") == "1",
        "bal_ba": os.environ.get("BENCH_SKIP_BA", "0") == "1",
        "pipeline": os.environ.get("BENCH_SKIP_PIPELINE", "0") == "1",
    }
    for name, tmo in METRICS:
        if skip.get(name):
            continue
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "dr3_tpu_torch.bench", "--metric", name],
                cwd=ROOT, capture_output=True, text=True, timeout=tmo)
        except subprocess.TimeoutExpired:
            errors[name] = f"timeout after {tmo}s"
            print(f"[bench] {name}: TIMEOUT {tmo}s", file=sys.stderr, flush=True)
            continue
        line = None
        for ln in reversed(proc.stdout.strip().splitlines()):
            if ln.startswith("{"):
                line = ln
                break
        if proc.returncode == 0 and line:
            try:
                parsed = json.loads(line)
                if parsed.get("value") is not None:
                    results[name] = parsed["value"]
                    if parsed.get("detail"):
                        details[name] = parsed["detail"]
                else:
                    errors[name] = "metric returned null"
            except json.JSONDecodeError:
                errors[name] = f"unparseable output: {line[:200]}"
        else:
            tail = (proc.stderr or proc.stdout or "").strip().splitlines()
            errors[name] = f"rc={proc.returncode}: " + " | ".join(tail[-3:])[-400:]
        # incremental evidence on stderr: survives a later hard kill
        print(f"[bench] {name}: {results.get(name, errors.get(name))}",
              file=sys.stderr, flush=True)

    fps = results.get("pipeline")
    extra = {}
    if "frontend" in results:
        extra["vo_frontend_frames_per_sec_scan"] = results["frontend"]
    if "window_ba" in results:
        extra["ba_window_lm_iters_per_sec"] = results["window_ba"]
    if "bal_ba" in results:
        extra["ba_bal_lm_iters_per_sec"] = results["bal_ba"]
    if "panorama" in results:
        extra["panorama_images_per_sec"] = results["panorama"]
    for name, detail in details.items():
        extra[f"{name}_detail"] = detail
    for key in ("frames_source", "panorama_source"):
        for name in ("pipeline", "frontend", "panorama"):
            if key in details.get(name, {}):
                extra.setdefault(key, details[name][key])
    extra["card"] = card_name()
    if errors:
        extra["errors"] = errors

    print(json.dumps({
        "metric": "slam_pipeline_frames_per_sec_per_chip",
        "value": round(fps, 3) if fps is not None else 0.0,
        "unit": "frames/s end-to-end (full MonoVO: pyramid+sparse-align+LK+pose-GN+"
                "keyframing+triangulation+window-BA+loop-closure, KITTI 1240x376, host "
                "reads included; baseline anchor = 10 Hz KITTI capture rate, "
                "self-chosen — the reference publishes no numbers)",
        "vs_baseline": round(fps / 10.0, 3) if fps is not None else 0.0,
        "extra": extra,
    }))


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--metric":
        run_one(sys.argv[2])
    else:
        main()
