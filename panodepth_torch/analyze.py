"""Analysis CLI: score a depth panorama against its ground truth, from files.

``python -m panodepth_torch.analyze gt.png prediction.png [--align 0|1|2]
[--no-cap] [--mono360] [--laplacian] [--shifted-out PNG] [--json]
[--device cuda|cpu]``

Counterpart of ``panodepth/analyze.py``, the reference's commented-out
analysis entry point (``cmd == "1"`` -> ``AnalaysisResult``, reference
``Main.cpp:896-897``): the value metrics with all three alignment modes
(ErrorEmap), the mono360 disparity chain (ErrorCompare) and the
gradient-space metrics (ErrorLaplacian), computed on ``--device`` (the
card unless ``cpu`` is asked for; ``--device`` takes the place of JAX's
``--platform``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="panodepth_torch.analyze")
    p.add_argument("gt")
    p.add_argument("prediction")
    p.add_argument("--align", type=int, default=1, choices=[0, 1, 2],
                   help="0 none, 1 median, 2 least-squares (Depth.h:312)")
    p.add_argument("--no-cap", action="store_true",
                   help="disable the 10 m Matterport depth cap")
    p.add_argument("--mono360", action="store_true",
                   help="prediction is a mono360 disparity map: run the "
                        "ErrorCompare disp->depth chain (Depth.cpp:2477-2603)")
    p.add_argument("--laplacian", action="store_true",
                   help="also report gradient-space metrics (ErrorLaplacian)")
    p.add_argument("--shifted-out", default=None,
                   help="save the aligned prediction as 8-bit PNG")
    p.add_argument("--json", action="store_true", help="print one JSON line")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def analyze(args) -> dict:
    """The metrics of ``args`` (parsed by :func:`build_parser`), as floats."""
    import torch

    from . import io as pio
    from . import metrics as pmetrics
    from .pipeline import resolve_device

    dev = resolve_device(args.device)
    gt = pio.load_image01(args.gt)
    pred = pio.load_image01(args.prediction)
    if args.mono360:
        res = pmetrics.error_compare(
            args.gt, args.prediction, disp_depth_compare=True,
            align_way=args.align, cap_depth=not args.no_cap,
            shifted_filename=args.shifted_out, device=dev)
    else:
        res = pmetrics.error_metrics(
            torch.as_tensor(gt, device=dev), torch.as_tensor(pred, device=dev),
            align_way=args.align, cap_depth=not args.no_cap)
        if args.shifted_out:
            # reference ErrorCompare writes the prediction values as loaded
            # (Depth.cpp:2611-2630)
            p2 = pred if pred.ndim == 2 else pred[..., 0]
            pio.save_png8(args.shifted_out, np.maximum(p2, 0.0))

    out = {k: float(v) for k, v in res.items() if k != "least_square"}
    out["rmse"] = math.sqrt(out["mse"])
    out["rmselog"] = math.sqrt(out["mselog"])
    if args.align == 2:
        out["least_square_s"] = float(res["least_square"][0])
        out["least_square_o"] = float(res["least_square"][1])
    if args.laplacian:
        lap = pmetrics.error_laplacian(torch.as_tensor(gt, device=dev),
                                       torch.as_tensor(pred, device=dev))
        out.update({k: float(v) for k, v in lap.items()})
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = analyze(args)
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
