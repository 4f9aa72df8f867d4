"""Window BA's solvers in turns on the long run, in one process: the
lateral run of ``chip_smoke.py`` phase 9(a) (``run_long_sequence
--kitti-res --profile lateral --batch 8 --max_points=1536``) through the
device-resident frame loop once per turn, each turn with one
``ba_solver``, after an untimed 120-frame warm-up run with each solver,
so that the first use of a kernel or a library handle falls on no turn.

    python dr3_tpu_torch/tools/solver_turns.py [--frames 400]
        [--solvers pcg,zexplicit,zexplicit,pcg] [--out f.json]

Prints one JSON line per turn (the run's frames/s after its 40-frame
warm-up, as ``run_long_sequence`` counts it, its window BAs, CG
iterations, keyframes, closures and ATE), then the card's name and power
limit. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def turn(frames: int, solver: str) -> dict:
    from dr3_tpu_torch.tools import run_long_sequence as long_seq

    args = long_seq._parser().parse_args(["--kitti-res", "--profile", "lateral",
                                          "--frames", str(frames), "--batch", "8"])
    vo, out = long_seq.run(args, ["--max_points=1536", f"--ba_solver={solver}"])
    return {"ba_solver": solver, "frames_per_sec": out["pipeline_frames_per_sec"],
            "window_ba": vo.n_window_ba, "cg_iterations": vo.n_cg_iters,
            "keyframes_made": sum(s.is_keyframe for s in vo.stats),
            "loop_closures": out["loop_closures"], "map_compactions": out["map_compactions"],
            "loop_programs": len(vo.scan_programs),
            "ate_pct_of_trajectory": out["ate_pct_of_trajectory"]}


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--solvers", default="pcg,zexplicit,zexplicit,pcg",
                    help="comma-separated ba_solver per turn")
    ap.add_argument("--out", default=None, help="also write the lines as a JSON list here")
    args = ap.parse_args(argv)
    from dr3_tpu_torch.tools.run_long_sequence import card_name

    solvers = args.solvers.split(",")
    for solver in dict.fromkeys(solvers):                   # warm-up, not reported
        turn(min(args.frames, 120), solver)
    rows = []
    for solver in solvers:
        rows.append(turn(args.frames, solver))
        print(json.dumps(rows[-1]), flush=True)
    card = card_name()
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "turns": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
