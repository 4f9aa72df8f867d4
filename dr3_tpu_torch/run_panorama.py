"""Panorama runner of the port (reference tests/test_panorama.cpp +
test_stitch.cpp; the JAX package's dr3_tpu/run_panorama.py).

    python -m dr3_tpu_torch.run_panorama --dir imgs/yosemite
    python -m dr3_tpu_torch.run_panorama --dir ... --mode translate --focal 315.5
    python -m dr3_tpu_torch.run_panorama --pair left.jpg right.jpg   # one stitch
    python -m dr3_tpu_torch.run_panorama --dir ... --device cpu      # plain versions

``--device`` defaults to cuda and is never replaced silently: without a
card the run stops. Further ``--key=value`` flags override Config fields.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=None, help="directory of overlapping images")
    ap.add_argument("--pair", nargs=2, default=None, help="stitch two images")
    ap.add_argument("--mode", choices=["homography", "translate"], default="homography")
    ap.add_argument("--focal", type=float, default=0.0,
                    help="focal length for translate/spherical mode")
    ap.add_argument("--feather", type=int, default=40)
    ap.add_argument("--out", default="panorama.png")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args, unknown = ap.parse_known_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_panorama: --device cuda but torch.cuda.is_available() "
                         "is False; pass --device cpu to run the plain versions")

    from dr3_tpu_torch.io.image import load_image, save_image
    from dr3_tpu_torch.utils.config import Config

    cfg = Config.from_cli(unknown)
    if args.pair:
        from dr3_tpu_torch.pipelines.stitch import Stitch

        s = Stitch(cfg, translate_only=args.mode == "translate",
                   focal_length=args.focal, device=device)
        out, H = s.process(load_image(args.pair[0]), load_image(args.pair[1]))
        save_image(out, args.out)
        print("H (right->left):\n", H)
    else:
        if not args.dir:
            ap.error("--dir or --pair required")
        from dr3_tpu_torch.pipelines.panorama import Panorama, PanType

        pan = Panorama(
            focal_length=args.focal,
            pan_type=PanType.TRANSLATE if args.mode == "translate" else PanType.HOMOGRAPHY,
            feathering_width=args.feather, cfg=cfg, device=device)
        out = pan.process_dir(args.dir)
        save_image(out, args.out)
        print(pan.monitor.report())
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
