"""Host reads of the VO driver on the card: ``run_long_sequence``'s lateral
run at 1240x376 through the device-resident frame loop (``--batch 8``, one
CUDA graph program per batch) and frame by frame (``--batch 1``), every
synchronising call counted with ``torch.cuda.set_sync_debug_mode("warn")``
and split into those inside the host's window BA (``MonoVO._run_local_ba``:
the per-frame path's, and the batch path's after a loop candidate) and the
rest. Counted after the tool's warm-up (its first 40 frames), as its
frames/s is. After the loop's run, window BA's pieces of its program
(``lm_pre``, ``cg_step``, ``lm_post``) are each replayed alone on the
program's slots (the state its last batch left) and timed on the device
(``tools/cudatime.device_ms``): an LM iteration inside the program costs
``lm_pre + lm_post`` and, for pcg, the run's CG iterations per LM
iteration times ``cg_step``.

    python dr3_tpu_torch/tools/scan_reads.py [--frames 400] [--out f.json]
        [--key=value ...]

``--key=value`` are ``run_long_sequence``'s Config overrides (e.g.
``--ba_solver=zexplicit``). Prints one JSON line per mode, then the card's
name and power limit. The counting hooks cost a Python call per
synchronisation, inside the timed window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def lm_piece_ms(vo, cg_per_lm: float) -> dict:
    """Device ms of window BA's pieces of ``vo``'s loop program, each
    replayed alone 20 times on the program's slots, and of one LM
    iteration built from them. The slots keep what the replays wrote: the
    program's next launch loads its carry afresh."""
    from dr3_tpu_torch.tools.cudatime import device_ms

    (prog,) = vo.scan_programs.values()
    out = {}
    for name in ("lm_pre", "cg_step", "lm_post"):
        graph = prog.graphs.get(name)
        if graph is not None:
            graph.instantiate()
            out[name + "_ms"], out[name + "_timed_by"] = device_ms(graph.replay, n=20)
    prog.last_carry = None
    out["lm_iteration_ms"] = (out["lm_pre_ms"] + out["lm_post_ms"]
                              + cg_per_lm * out.get("cg_step_ms", 0.0))
    return out


def measure(frames: int, batch: int, overrides=()) -> dict:
    import torch

    from dr3_tpu_torch.pipelines.vo import MonoVO
    from dr3_tpu_torch.tools import run_long_sequence as long_seq

    args = long_seq._parser().parse_args(["--kitti-res", "--profile", "lateral",
                                          "--frames", str(frames), "--batch", str(batch)])
    warm = min(40, frames // 4)
    counts = {"ba": 0, "other": 0}
    in_ba = [False]
    start: dict = {}
    run_ba = MonoVO._run_local_ba

    def counted_ba(self, slot):
        in_ba[0] = True
        try:
            return run_ba(self, slot)
        finally:
            in_ba[0] = False

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            counts["ba" if in_ba[0] else "other"] += 1

    def on_step(vo):
        if not start and vo.frame_idx + 1 >= warm:
            start.update(counts, frame=vo.frame_idx, window_ba=vo.n_window_ba,
                         cg=vo.n_cg_iters, kf=sum(s.is_keyframe for s in vo.stats))

    MonoVO._run_local_ba = counted_ba
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                vo, out = long_seq.run(args, overrides, on_step)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        MonoVO._run_local_ba = run_ba
    n = vo.frame_idx - start["frame"]
    n_ba = vo.n_window_ba - start["window_ba"]
    host_ba = counts["ba"] - start["ba"]
    other = counts["other"] - start["other"]
    pieces = {}
    if vo.scan_programs:
        pieces = lm_piece_ms(vo, vo.n_cg_iters / max(vo.n_window_ba * vo.cfg.ba_max_iters, 1))
    return {"batch": batch, "ba_solver": vo.cfg.ba_solver, "frames_counted": n,
            "frames_per_sec": out["pipeline_frames_per_sec"],
            "keyframes": sum(s.is_keyframe for s in vo.stats) - start["kf"],
            "window_ba": n_ba, "cg_iterations": vo.n_cg_iters - start["cg"],
            "host_reads": host_ba + other, "host_reads_in_window_ba": host_ba,
            "host_reads_per_frame_outside_ba": other / max(n, 1),
            "host_reads_per_window_ba": host_ba / max(n_ba, 1),
            "host_reads_per_frame": (host_ba + other) / max(n, 1),
            "loop_programs": len(vo.scan_programs), "loop_closures": out["loop_closures"],
            "ate_pct_of_trajectory": out["ate_pct_of_trajectory"], **pieces}


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--out", default=None, help="also write the lines as a JSON list here")
    args, overrides = ap.parse_known_args(argv)
    if any(not a.startswith("--") or "=" not in a for a in overrides):
        ap.error(f"unrecognized arguments: {' '.join(overrides)}")
    from dr3_tpu_torch.tools.run_long_sequence import card_name

    rows = [measure(args.frames, batch, overrides) for batch in (8, 1)]
    for r in rows:
        print(json.dumps(r), flush=True)
    card = card_name()
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
