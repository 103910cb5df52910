"""Command-line entry point with the reference's positional CLI.

Reference usage (README.md:50, Main.cpp:692-900)::

    WACV2022 0 rgb/ gt/ baseline/ result/

Here::

    python -m panodepth_torch 0 rgb/ gt/ baseline/ result/ --no-extract [options]

Command ``0`` runs the CreateDepthPanoramas batch's merge (stage C): per
panorama, registration, fusion and scoring of the perspective depth maps
found in ``--views-folder``.  Counterpart of ``panodepth/cli.py``'s file
mode; what is not ported yet is refused, never ignored.
"""

from __future__ import annotations

import argparse
import sys

from .kernels.jacobi import JACOBI_KINDS

# flags of the JAX CLI that this package does not run yet: parsed, so that
# passing one gets a clear refusal instead of being taken for something else
_MODEL_MODE_FLAGS = ("persp_ckpt", "baseline_ckpt", "view_width", "latency",
                     "latency_halo", "extract_dtype", "infer_norm",
                     "base_width", "persp_int8", "p99")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="panodepth_torch",
        description="High-resolution panorama depth merge on PyTorch/CUDA",
    )
    p.add_argument("cmd", choices=["0"], help="0 = CreateDepthPanoramas")
    p.add_argument("rgb_folder")
    p.add_argument("gt_folder")
    p.add_argument("baseline_folder")
    p.add_argument("result_folder")
    p.add_argument("--layout", default="5fold_leres",
                   choices=["5fold_leres", "5fold_midas", "4fold", "3fold"])
    p.add_argument("--out-width", type=int, default=2048)
    p.add_argument("--views-folder", default="test_images")
    p.add_argument("--dataset", default="matterport",
                   choices=["matterport", "stanford2d3d", "suncg", "replica"])
    p.add_argument("--pmap-ext", default=".jpg")
    p.add_argument("--no-extract", action="store_true",
                   help="skip stage-A RGB view extraction (required: stage A "
                        "is not ported yet)")
    p.add_argument("--jacobi", default="auto", choices=JACOBI_KINDS,
                   help="auto = the CUDA kernel on cuda, the plain PyTorch "
                        "version on cpu; kernel = always the CUDA kernel; "
                        "torch = always the plain version")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--limit", type=int, default=None,
                   help="process at most N panoramas (Main.cpp:372-386)")
    p.add_argument("--include", action="append", default=None,
                   help="only panoramas whose filename contains this "
                        "substring (repeatable; Main.cpp:357-370)")
    p.add_argument("--exclude", action="append", default=None,
                   help="skip panoramas whose filename contains this "
                        "substring (repeatable; Main.cpp:388-407)")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process the round-robin slice items[I::N] of the "
                        "(filtered) list; resume still applies per item")
    late = p.add_argument_group("not ported yet (refused)")
    late.add_argument("--batch-size", type=int, default=1)
    late.add_argument("--stream", default=None, choices=["auto", "on", "off"])
    late.add_argument("--profile", action="store_true")
    for name in _MODEL_MODE_FLAGS:  # with or without a value, as in JAX
        late.add_argument("--" + name.replace("_", "-"), nargs="?",
                          const=True, default=None)
    return p


def _refusal(args) -> str | None:
    if not args.no_extract:
        return ("stage-A view extraction is not ported yet: pass "
                "--no-extract and provide the depth views in --views-folder")
    for name in _MODEL_MODE_FLAGS:
        if getattr(args, name) is not None:
            return (f"--{name.replace('_', '-')} belongs to the on-device "
                    f"model mode, which is not ported yet")
    if args.batch_size != 1:
        return "--batch-size > 1 (the batched merge) is not ported yet"
    if args.stream is not None:
        return "--stream (the streamed batched merge) is not ported yet"
    if args.profile:
        return "--profile (the registration/fusion split) is not ported yet"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refusal = _refusal(args)
    if refusal:
        raise SystemExit(f"panodepth_torch: {refusal}")
    from .config import MergeConfig
    from .pipeline import run_batch

    cfg = MergeConfig(layout_name=args.layout, out_width=args.out_width)
    run_batch(
        args.rgb_folder, args.gt_folder, args.baseline_folder,
        args.result_folder, cfg,
        views_folder=args.views_folder, dataset=args.dataset,
        pmap_ext=args.pmap_ext, limit=args.limit, include=args.include,
        exclude=args.exclude, shard=args.shard, jacobi=args.jacobi,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
