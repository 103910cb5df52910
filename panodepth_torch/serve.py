"""Serving artifacts: the merge and the e2e graph exported to one file.

Counterpart of ``panodepth/serve.py``.  The reference re-runs its batch
binary, with all its start-up, per dataset (Main.cpp:489-685).  Here a
serving process loads an artifact once and calls it: the batched merge
(``pipeline._merge_fn``) or the batched e2e graph (``e2e.build_batched_e2e``'s
``full``, the nets' weights baked in), traced by ``torch.export`` into an
``ExportedProgram`` and written by ``torch.export.save`` (a ``.pt2``).  The
hand-written kernels are nodes of that program, the operators
``panodepth_torch::jacobi``, ``panodepth_torch::group_norm`` and, in the
int8 perspective graph (``--persp-int8``), ``panodepth_torch::qconv`` and
``panodepth_torch::quantize_nhwc`` (``kernels/``); every device table and net weight the graph reads is a
constant inside it, so the file is self-contained, but it runs only where
this package is importable (it registers the operators), on the device
and the PyTorch version it was exported with.  A ``.meta.json`` sidecar
records the kind, shapes, dtypes, configuration, device, PyTorch version
and the operators in the graph.

:func:`load` returns an :class:`Artifact` whose call replays the program
from a CUDA graph per input shape (``graphs.Graphed``, the counterpart of
the deserialized XLA executable) with TF32 off (``pipeline.true_f32``: an
exported graph does not record the flags its functions set while traced).

CLI (``--device cpu`` runs on the CPU, the plain versions in the graph)::

    python -m panodepth_torch.serve export-merge OUT.pt2 --batch 8 \\
        --emap-shape 512x1024 --pmap-shape 988x1024 [--out-width 2048]
    python -m panodepth_torch.serve export-e2e OUT.pt2 --batch 8 \\
        --rgb-shape 1024x2048 --persp-ckpt ... --baseline-ckpt ... \\
        [--persp-int8]
    python -m panodepth_torch.serve run OUT.pt2        # random inputs
    python -m panodepth_torch.serve describe OUT.pt2   # no execution
    python -m panodepth_torch.serve daemon OUT.pt2 --port 8765

Python::

    art = serve.load("merge.pt2")
    out_u16, abcd = art(emaps_u16, pmaps_u16)
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from . import graphs
from .config import MergeConfig
from .kernels import groupnorm as kgroupnorm
from .kernels import jacobi as kjacobi
from .kernels import qconv as kqconv
from .pipeline import resolve_device, true_f32

# the operators of the hand-written kernels, as graph nodes name them
KERNEL_OPS = (f"{kjacobi.OPS}::jacobi", f"{kgroupnorm.OPS}::group_norm",
              f"{kqconv.OPS}::qconv", f"{kqconv.OPS}::quantize_nhwc")


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.uint16`` -> ``"uint16"`` (numpy's name)."""
    return str(dtype).replace("torch.", "")


def kernel_nodes(program) -> dict:
    """{operator: number of nodes} of the hand-written kernels in the
    program's graph."""
    counts = {}
    for node in program.graph.nodes:
        if isinstance(node.target, torch._ops.OpOverload):
            name = node.target.name().split(".")[0]
            if name in KERNEL_OPS:
                counts[name] = counts.get(name, 0) + 1
    return counts


class Artifact:
    """A loaded exported program, its sidecar and its device; called like
    the function it was exported from, on numpy arrays or tensors, and
    returns tensors on the device."""

    def __init__(self, program, meta: dict, device):
        self.program = program
        self.meta = meta
        self.device = torch.device(device)
        module = program.module()
        self.graphed = graphs.Graphed(
            module, self.device, (module,),
            name=f"serve.{meta.get('kind', 'artifact')}")

    def __call__(self, *args):
        with true_f32():
            return self.graphed(*args)

    def describe(self) -> str:
        return describe(self.meta)


def describe(meta: dict) -> str:
    """One line on an artifact: kind, device, PyTorch version, inputs,
    output width, kernel operators."""
    ins = ", ".join(f"{s}:{d}" for s, d in zip(meta["in_shapes"],
                                               meta["in_dtypes"]))
    return (f"{meta['kind']} graph for {meta.get('device')} (torch "
            f"{meta.get('torch')}; artifacts run only on the device type and "
            f"PyTorch version they were exported with) — inputs [{ins}], cfg "
            f"out_width={meta.get('out_width')}, kernels "
            f"{meta.get('kernels')}")


def _input_meta(program) -> dict:
    """Shapes, dtypes and device of the program's user inputs, from the
    graph's placeholders."""
    users = set(program.graph_signature.user_inputs)
    vals = [n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in users]
    return dict(in_shapes=[list(v.shape) for v in vals],
                in_dtypes=[_dtype_name(v.dtype) for v in vals],
                device=str(vals[0].device) if vals else "cpu")


def read_meta(path: str):
    """(meta, program or None): the ``.meta.json`` sidecar, or without one
    the program itself, loaded, and the shapes, dtypes and device of its
    input placeholders (the configuration fields are then unknown)."""
    side = path + ".meta.json"
    if os.path.exists(side):
        with open(side) as fp:
            return json.load(fp), None
    program = torch.export.load(path)
    return dict(kind="unknown (meta sidecar missing)", **_input_meta(program),
                torch=None, kernels=kernel_nodes(program)), program


def load(path: str, device=None) -> Artifact:
    """Load an artifact written by one of the exporters below.

    This module imports the port's kernels, which registers their
    operators (each built at its first launch).  A missing ``.meta.json``
    sidecar is tolerated (:func:`read_meta`), so ``describe`` and ``run``
    still work.  ``device`` defaults to the artifact's own; an artifact runs
    on the device type it was exported for, nowhere else.
    """
    meta, program = read_meta(path)
    dev = resolve_device(device or meta["device"])
    if dev.type != torch.device(meta["device"]).type:
        raise ValueError(f"{path} was exported for {meta['device']}, not "
                         f"{dev}: export on the device you serve on")
    return Artifact(program or torch.export.load(path), meta, dev)


class _Traced(torch.nn.Module):
    """``fn`` as the module ``torch.export`` traces.  The nets ``fn`` runs
    are not its submodules: every tensor the graph reads (the casts the
    convs use, the norms' scales, the merge's tables) is lifted into the
    program as a constant, and nothing it does not read is stored."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, example_args, kind: str, extra_meta: dict, path: str):
    """Trace ``fn`` on ``example_args``, write the program and its sidecar;
    returns the program."""
    program = torch.export.export(_Traced(fn), tuple(example_args),
                                  strict=False)
    torch.export.save(program, path)
    meta = dict(kind=kind,
                in_shapes=[list(a.shape) for a in example_args],
                in_dtypes=[_dtype_name(a.dtype) for a in example_args],
                **extra_meta, device=str(example_args[0].device),
                torch=torch.__version__, kernels=kernel_nodes(program),
                tf32=False)
    with open(path + ".meta.json", "w") as fp:
        json.dump(meta, fp, indent=1)
    return program


def export_merge(path: str, cfg: MergeConfig, batch: int,
                 emap_shape=(512, 1024), pmap_shape=(988, 1024),
                 dtype: str = "uint16", jacobi: str = "auto",
                 device="cuda"):
    """Export the batched file-mode merge, (emaps (B, He, We), pmaps (B, V,
    Hp, Wp)) -> (out_u16 (B, H, W), abcd (B, V, 4)).

    ``dtype`` "uint16" takes the maps as the files hold them (the streamed
    transfer path), "float32" as 0~1 floats.  ``jacobi`` is the route
    (``auto``: the kernel on the card, the plain version on the CPU).
    """
    from .pipeline import _merge_fn

    if dtype not in ("uint16", "float32"):
        raise ValueError(f"dtype must be uint16 or float32, got {dtype!r}")
    dev = resolve_device(device)
    dt = getattr(torch, dtype)
    v = cfg.layout.num_views
    # example inputs: the tracer reads their shapes, dtypes and device only
    emaps = torch.empty((batch,) + tuple(emap_shape), dtype=dt, device=dev)
    pmaps = torch.empty((batch, v) + tuple(pmap_shape), dtype=dt,
                        device=dev)
    return _export(_merge_fn(cfg, jacobi), (emaps, pmaps), "merge",
                   dict(out_width=cfg.out_width, batch=batch,
                        layout=cfg.layout_name, dtype=dtype, jacobi=jacobi),
                   path)


def export_e2e(path: str, cfg: MergeConfig, batch: int, persp_ckpt: str,
               baseline_ckpt: str, rgb_shape=(1024, 2048),
               view_width: Optional[int] = None, persp_int8: bool = False,
               groupnorm: str = "auto", jacobi: str = "auto", device="cuda"):
    """Export the batched e2e graph, u8 RGB (B, H, W, 3) -> (out_u16 (B, oh,
    ow), baselines (B, h, w)), with both zoo checkpoints' weights baked in
    (nets in bf16, norms out in f32, as the CLI runs them).  Every family
    that ``e2e.load_model_checkpoint`` builds is taken; the view width
    defaults to the perspective net's training size, the baseline width
    to the baseline net's.  ``persp_int8`` bakes the GN perspective net's
    int8 graph in (its int8 codes, a quarter of the float weights' bytes).
    ``PANODEPTH_BASE_FEED`` and ``PANODEPTH_P99`` are read while the
    graph is traced, so the artifact bakes in their values at export
    time, as a JAX export does; the sidecar records them.
    """
    from .e2e import base_feed, build_batched_e2e, load_model_checkpoint
    from .models.perspective import p99_mode

    dev = resolve_device(device)
    persp, persp_arch = load_model_checkpoint(persp_ckpt, device=dev,
                                              quantize=persp_int8)
    base, base_arch = load_model_checkpoint(baseline_ckpt, device=dev)
    vw = view_width or persp_arch.get("view_size", 512)
    full, _, _ = build_batched_e2e(
        persp, cfg, view_width=vw, base_model=base,
        base_w=base_arch.get("pano_width", 512), jacobi=jacobi,
        groupnorm=groupnorm, device=dev)
    rgbs = torch.empty((batch,) + tuple(rgb_shape) + (3,), dtype=torch.uint8,
                       device=dev)
    return _export(full.eager, (rgbs,), "e2e",
                   dict(out_width=cfg.out_width, batch=batch,
                        layout=cfg.layout_name, view_width=vw,
                        persp=persp_arch.get("model"),
                        baseline=base_arch.get("model"),
                        persp_int8=persp_int8, jacobi=jacobi,
                        groupnorm=groupnorm, base_feed=base_feed(),
                        p99=p99_mode()), path)


def _random_inputs(meta: dict, seed: int = 0):
    """Random numpy inputs of the artifact's shapes and dtypes."""
    rng = np.random.RandomState(seed)
    ins = []
    for shape, dt in zip(meta["in_shapes"], meta["in_dtypes"]):
        if dt == "uint8":
            ins.append(rng.randint(0, 256, shape).astype(np.uint8))
        elif dt == "uint16":
            ins.append(rng.randint(0, 65536, shape).astype(np.uint16))
        else:
            ins.append(rng.uniform(0.05, 0.95, shape).astype(np.float32))
    return ins


def _parse_hw(s: str):
    h, w = s.lower().split("x")
    return int(h), int(w)


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        "panodepth_torch.serve",
        description="export the merge / e2e graph, run or serve it")
    sub = p.add_subparsers(dest="cmd", required=True)

    pm = sub.add_parser("export-merge")
    pm.add_argument("out")
    pm.add_argument("--batch", type=int, default=8)
    pm.add_argument("--emap-shape", default="512x1024")
    pm.add_argument("--pmap-shape", default="988x1024")
    pm.add_argument("--out-width", type=int, default=2048)
    pm.add_argument("--layout", default="5fold_leres")
    pm.add_argument("--dtype", default="uint16",
                    choices=["uint16", "float32"])
    pm.add_argument("--jacobi", default="auto",
                    choices=kjacobi.JACOBI_KINDS)

    pe = sub.add_parser("export-e2e")
    pe.add_argument("out")
    pe.add_argument("--batch", type=int, default=8)
    pe.add_argument("--rgb-shape", default="1024x2048")
    pe.add_argument("--out-width", type=int, default=2048)
    pe.add_argument("--layout", default="5fold_leres")
    pe.add_argument("--persp-ckpt", required=True)
    pe.add_argument("--baseline-ckpt", required=True)
    pe.add_argument("--view-width", type=int, default=None)
    pe.add_argument("--persp-int8", action="store_true",
                    help="bake the GN perspective net's int8 graph "
                         "(models/quantize.py) into the artifact")

    pr = sub.add_parser("run", help="call the artifact once on random "
                        "inputs and print the cold time")
    pr.add_argument("artifact")

    pd = sub.add_parser("describe", help="print an artifact's kind, shapes, "
                        "device and kernels (from its sidecar, else from "
                        "the program) without running it")
    pd.add_argument("artifact")

    pn = sub.add_parser(
        "daemon", help="persistent HTTP serving process: load the artifact "
        "once, coalesce requests into device batches (daemon.py)")
    pn.add_argument("artifact")
    pn.add_argument("--host", default="127.0.0.1")
    pn.add_argument("--port", type=int, default=8765)
    pn.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="micro-batching window after the first request "
                         "of a batch arrives")
    pn.add_argument("--no-warmup", action="store_true",
                    help="skip the start-up call (the first request then "
                         "pays the capture)")

    for q in (pm, pe, pr, pn):
        q.add_argument("--device", default=None, choices=["cuda", "cpu"],
                       help="export: where the graph runs (default cuda); "
                            "load: the artifact's own")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in ("export-merge", "export-e2e"):
        cfg = MergeConfig(out_width=args.out_width, layout_name=args.layout)
        t0 = time.monotonic()
        if args.cmd == "export-merge":
            program = export_merge(
                args.out, cfg, args.batch,
                emap_shape=_parse_hw(args.emap_shape),
                pmap_shape=_parse_hw(args.pmap_shape), dtype=args.dtype,
                jacobi=args.jacobi, device=args.device or "cuda")
        else:
            program = export_e2e(
                args.out, cfg, args.batch, args.persp_ckpt,
                args.baseline_ckpt, rgb_shape=_parse_hw(args.rgb_shape),
                view_width=args.view_width, persp_int8=args.persp_int8,
                device=args.device or "cuda")
        print(f"[serve] wrote {args.out} (+.meta.json): "
              f"{os.path.getsize(args.out)} bytes, "
              f"{len(program.graph.nodes)} nodes, kernels "
              f"{kernel_nodes(program)}, in {time.monotonic() - t0:.2f} s")
    elif args.cmd == "describe":
        print(f"[serve] {describe(read_meta(args.artifact)[0])}")
    elif args.cmd == "daemon":
        from .daemon import run_daemon

        return run_daemon(args.artifact, args.host, args.port,
                          args.max_delay_ms, warmup=not args.no_warmup,
                          device=args.device)
    else:
        art = load(args.artifact, args.device)
        print(f"[serve] {art.describe()}")
        ins = _random_inputs(art.meta)
        t0 = time.monotonic()
        out = art(*ins)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        shapes = [tuple(o.cpu().shape) for o in outs]  # the copies wait
        ms = (time.monotonic() - t0) * 1000
        print(f"[serve] ran ok in {ms:.0f} ms (cold), outputs {shapes}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
