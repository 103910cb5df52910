"""Command-line entry point with the reference's positional CLI.

Reference usage (README.md:50, Main.cpp:692-900)::

    WACV2022 0 rgb/ gt/ baseline/ result/

Here::

    python -m panodepth_torch 0 rgb/ gt/ baseline/ result/ [options]
    python -m panodepth_torch 0 rgb/ gt/ baseline/ result/ \\
        --persp-ckpt zoo/perspective_final.params.npz \\
        [--baseline-ckpt zoo/fastpano_final.params.npz]

Command ``0`` runs the CreateDepthPanoramas batch.  Without
``--persp-ckpt`` (file mode) it extracts the perspective RGB views of every
panorama into ``--views-folder`` (stage A; skipped where the views exist,
and with ``--no-extract``), then merges the perspective depth maps found
there under the same names per panorama (stage C).  With it (model mode)
it runs the on-device e2e graph on the RGB panoramas: the perspective CNN
on the extracted views and, with ``--baseline-ckpt``, the baseline CNN
(else the baseline files of the ``baseline`` folder), then registration
and fusion.  Every zoo checkpoint runs: ``--persp-ckpt`` takes the NF
(``zoo/perspective_*``) or the GN (``zoo/gn/perspective_*``) perspective
net (``--persp-int8``: the GN net as the int8 graph), ``--baseline-ckpt``
FastPanoNet (``zoo/fastpano_*``), the UniFuse-class net
(``zoo/panoramic_*``), HoHoNet (``zoo/hohonet_*``), BiFuse
(``zoo/bifuse_*``) or SliceNet (``zoo/slicenet_*``); ``--extract-dtype``
picks the views' gather table, ``--p99`` the percentile's selection, and
``PANODEPTH_BASE_FEED=box`` the baseline CNN's box feed, as in JAX;
``--latency`` runs each panorama through the view-parallel graph over the
ranks of an initialized process group (one rank from a plain ``python -m
panodepth_torch``).  Counterpart of ``panodepth/cli.py``; a model-mode flag
in file mode is refused, never ignored.
"""

from __future__ import annotations

import argparse
import sys

from .kernels.jacobi import JACOBI_KINDS

# flags that only the model mode takes
_MODEL_MODE = ("persp_int8", "baseline_ckpt", "view_width", "base_width",
               "infer_norm", "extract_dtype", "p99", "latency",
               "latency_halo")
LATENCY_HALO = 10  # --latency-halo's default, as in JAX


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="panodepth_torch",
        description="High-resolution panorama depth on PyTorch/CUDA",
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
                   help="file mode: skip stage-A RGB view extraction")
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
    p.add_argument("--batch-size", type=int, default=1,
                   help="panoramas per device call: the streamed batched "
                        "merge in file mode (stage A batches at least 4), "
                        "the e2e graph's batch in model mode")
    p.add_argument("--profile", action="store_true",
                   help="time registration apart from fusion (file mode) "
                        "or the models apart from registration+fusion "
                        "(model mode): two graphs with a host sync between")
    p.add_argument("--stream", default="auto", choices=["auto", "on", "off"],
                   help="send integer-source inputs to the device at their "
                        "own width (u16 maps, u8 RGB) and normalize there; "
                        "auto = off")
    p.add_argument("--persp-ckpt", default=None,
                   help="model mode: the perspective CNN's checkpoint "
                        "(*.params.npz beside its <model>.config.json)")
    p.add_argument("--baseline-ckpt", default=None,
                   help="model mode: make the baseline with this CNN "
                        "(any zoo family: fastpano, panoramic, hohonet, "
                        "bifuse, slicenet) instead of reading baseline "
                        "files")
    p.add_argument("--persp-int8", action="store_true", default=None,
                   help="model mode: run the perspective CNN as the int8 "
                        "post-training-quantized graph (per-channel int8 "
                        "weights, per-image activation codes, int8 convs "
                        "with int32 sums: the qconv kernel on the card); "
                        "GN perspective checkpoints only")
    p.add_argument("--view-width", type=int, default=None,
                   help="model mode: perspective view width (default: the "
                        "checkpoint's training view_size)")
    p.add_argument("--base-width", type=int, default=None,
                   help="model mode: run the baseline CNN at this width "
                        "instead of its training pano_width (refused for "
                        "hohonet and slicenet, whose decoders fix it)")
    p.add_argument("--infer-norm", default=None,
                   choices=["auto", "f32", "bf16"],
                   help="model mode: GroupNorm output type; auto = f32")
    p.add_argument("--extract-dtype", default=None,
                   choices=["auto", "packed", "packed16", "pair16",
                            "pair16d", "bf16", "f32"],
                   help="model mode: view-extraction gather table; auto = "
                        "f32; bf16 samples a bf16 copy, packed one int32 "
                        "word a pixel (exact for 8-bit sources), packed16 "
                        "RGB565, pair16 the 565 codes of a pixel pair (the "
                        "views of packed16), pair16d the same dithered; "
                        "every table but f32 feeds the baseline CNN's "
                        "resize in bf16")
    p.add_argument("--latency", action="store_true", default=None,
                   help="with --persp-ckpt: view-parallel single-request "
                        "mode — each panorama's view fan-out is sharded "
                        "over ALL ranks (lowest per-request latency; "
                        "use --batch-size for fleet throughput instead)")
    p.add_argument("--latency-halo", type=int, default=None, metavar="K",
                   help="with --latency: K-wide temporal-blocked halo "
                        "exchanges in the width-sharded Jacobi (K-fold "
                        "fewer collectives, bit-exact; default "
                        f"{LATENCY_HALO})")
    p.add_argument("--png-level", type=int, default=None, metavar="0-9",
                   help="deflate level for the 16-bit result PNGs (always "
                        "lossless); sets PANODEPTH_PNG_LEVEL. Default 1: "
                        "fastest writes; 6+ for smallest archival files")
    p.add_argument("--p99", default=None, choices=["sort", "topk", "approx"],
                   help="model mode: the perspective net's 99th percentile "
                        "(sets PANODEPTH_P99): sort (default), topk (the "
                        "top 1%% only), approx (the top-k JAX approximates "
                        "on the TPU; exact here, as JAX is off the TPU)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the batch into DIR "
                        "(a Chrome trace: chrome://tracing, Perfetto)")
    p.add_argument("--debug-nans", action="store_true",
                   help="abort with FloatingPointError on the first NaN in "
                        "a stage's result (registration, fusion, the nets), "
                        "naming the stage and the panorama; the stages run "
                        "eagerly (the reference's oops! prints, "
                        "Depth.cpp:1600-1601)")
    return p


def _refusal(args) -> str | None:
    if args.batch_size < 1:
        return f"--batch-size must be >= 1, got {args.batch_size}"
    if not args.persp_ckpt:
        for name in _MODEL_MODE:
            if getattr(args, name) is not None:
                return (f"--{name.replace('_', '-')} applies to the "
                        f"on-device model mode only; pass --persp-ckpt")
        return None
    if args.base_width and not args.baseline_ckpt:
        return ("--base-width resizes a --baseline-ckpt model's input; "
                "baseline files (the baseline folder) are consumed at their "
                "stored size")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refusal = _refusal(args)
    if refusal:
        raise SystemExit(f"panodepth_torch: {refusal}")
    import os

    if args.png_level is not None:
        os.environ["PANODEPTH_PNG_LEVEL"] = str(args.png_level)
    if args.p99:
        # read when the perspective net's stage runs (and is captured), as
        # JAX reads it when it traces
        os.environ["PANODEPTH_P99"] = args.p99
    from . import debug
    from .config import MergeConfig

    cfg = MergeConfig(layout_name=args.layout, out_width=args.out_width)
    if args.debug_nans:
        print("[debug-nans] each stage's result is checked for NaN; the "
              "stages run eagerly, not from CUDA graphs")
    with debug.nan_checks(args.debug_nans), \
            debug.traced(args.trace, "merge", cuda=args.device == "cuda"):
        _run(args, cfg)
    return 0


def _run(args, cfg) -> None:
    if args.persp_ckpt:
        from .e2e import run_batch_e2e

        run_batch_e2e(
            args.rgb_folder, args.gt_folder, args.result_folder,
            args.persp_ckpt, cfg, baseline_ckpt=args.baseline_ckpt,
            baseline_folder=args.baseline_folder, dataset=args.dataset,
            view_width=args.view_width, limit=args.limit,
            include=args.include, exclude=args.exclude, shard=args.shard,
            profile=args.profile, batch_size=args.batch_size,
            stream=args.stream, jacobi=args.jacobi,
            extract_dtype=args.extract_dtype or "auto",
            persp_int8=bool(args.persp_int8),
            infer_norm=args.infer_norm or "auto",
            base_width=args.base_width, device=args.device,
            latency=bool(args.latency),
            latency_halo=(LATENCY_HALO if args.latency_halo is None
                          else args.latency_halo),
        )
        return
    from .pipeline import run_batch

    run_batch(
        args.rgb_folder, args.gt_folder, args.baseline_folder,
        args.result_folder, cfg,
        views_folder=args.views_folder, dataset=args.dataset,
        extract_rgb_views=not args.no_extract,
        pmap_ext=args.pmap_ext, limit=args.limit, include=args.include,
        exclude=args.exclude, shard=args.shard, profile=args.profile,
        batch_size=args.batch_size, stream=args.stream, jacobi=args.jacobi,
        device=args.device,
    )


if __name__ == "__main__":
    sys.exit(main())
