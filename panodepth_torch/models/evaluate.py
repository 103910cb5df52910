"""Held-out evaluation of a trained checkpoint on procedural scenes.

``python -m panodepth_torch.models.evaluate <ckpt> [--count N] [--seed S]
[--corrupt] [--int8]``

Counterpart of ``panodepth/models/evaluate.py``: renders held-out scenes
(seed 77 000 by default, disjoint from training's), runs the checkpoint
(``e2e.load_model_checkpoint``; its GroupNorms take the CUDA kernel on the
card) and scores each prediction against the analytic depth with the
pipeline's metrics (``metrics.error_metrics`` over the whole sphere,
``align_way`` 1 = median alignment, the reference's scoring mode,
Depth.cpp:933-947).  ``--corrupt`` first degrades the rendered RGB with
the fixed mid-severity camera-pipeline corruption
(``ops/corrupt.eval_corruption``), the depth staying exact, so the clean
against corrupted delta measures robustness.  ``--int8`` evaluates the int8
graph of a GN perspective checkpoint (``models/quantize.py``; its convs
take the qconv kernel on the card).  Prints one JSON line: the
mean metrics and the RMSE of the constant predictor (each scene's mean
depth) as a floor.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def evaluate(ckpt_path: str, count: int = 16, seed: int = 77_000,
             align_way: int = 1, batch: int = 4, scene_version="v1",
             corrupt: bool = False, int8: bool = False, device="cuda",
             groupnorm: str = "auto"):
    """The mean metrics of ``count`` held-out scenes, as a dict; with
    ``corrupt`` on the RGB degraded by ``eval_corruption`` (its noise drawn
    on the device from seed 0 for each batch, as JAX draws it from
    ``PRNGKey(0)``); with ``int8`` of the checkpoint's int8 graph.
    ``groupnorm`` is the GroupNorms' route."""
    from .. import metrics as pmetrics
    from .. import synth
    from ..e2e import load_model_checkpoint
    from ..ops import corrupt as pcorrupt
    from ..pipeline import resolve_device, true_f32
    from . import norm as pnorm

    dev = resolve_device(device)
    model, arch = load_model_checkpoint(ckpt_path, device=dev, quantize=int8)
    pnorm.set_route(model, groupnorm)
    kind = arch["model"]
    rng = np.random.RandomState(seed)
    use_v2 = str(scene_version) not in ("1", "v1")
    size = arch.get("view_size", 256)
    pw = arch.get("pano_width", 512)

    recs = []
    done = 0
    with torch.no_grad(), true_f32():
        while done < count:
            n = min(batch, count - done)
            scenes = synth.stack_scenes(
                [synth.sample_scene(rng, scene_version) for _ in range(n)])
            scenes = synth.scene_tensors(scenes, dev)
            if kind == "perspective":
                fovs = torch.from_numpy(np.stack(
                    [synth.sample_view_fov(rng) for _ in range(n)])).to(dev)
                rgb, dep = synth.render_view(scenes, fovs, size, size, use_v2)
            else:
                rgb, dep = synth.render_pano(scenes, pw, pw // 2, use_v2)
            if corrupt:
                rgb = pcorrupt.eval_corruption(rgb)
            pred = model(rgb)
            for i in range(n):
                m = pmetrics.error_metrics(dep[i], pred[i],
                                           align_way=align_way,
                                           zenith_range=(0.0, np.pi))
                t = dep[i].cpu().numpy()
                recs.append(dict(
                    rmse=float(np.sqrt(float(m["mse"]))),
                    mae=float(m["mae"]), mre=float(m["mre"]),
                    delta1=float(m["delta1"]),
                    rmse_const=float(np.sqrt(np.mean((t - t.mean()) ** 2))),
                ))
            done += n

    agg = {k: float(np.mean([r[k] for r in recs])) for k in recs[0]}
    agg.update(model=kind, ckpt=ckpt_path, count=count, align_way=align_way,
               scenes=str(scene_version), corrupt=corrupt, int8=int8)
    return agg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="panodepth_torch.models.evaluate")
    p.add_argument("ckpt")
    p.add_argument("--count", type=int, default=16)
    p.add_argument("--seed", type=int, default=77_000)
    p.add_argument("--align-way", type=int, default=1, choices=[0, 1, 2])
    p.add_argument("--scenes", default="v1", choices=["v1", "v2", "mix"],
                   help="held-out scene distribution (see "
                        "panodepth_torch.synth)")
    p.add_argument("--corrupt", action="store_true",
                   help="degrade the rendered RGB with the fixed "
                        "mid-severity camera-pipeline corruption (exposure, "
                        "noise, JPEG q40) before prediction; the depth stays "
                        "exact")
    p.add_argument("--int8", action="store_true",
                   help="evaluate the int8 post-training-quantized graph "
                        "(models/quantize.py; GN perspective checkpoints "
                        "only)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    print(json.dumps(evaluate(args.ckpt, args.count, args.seed,
                              args.align_way, scene_version=args.scenes,
                              corrupt=args.corrupt, int8=args.int8,
                              device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
