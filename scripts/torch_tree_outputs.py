#!/usr/bin/env python3
"""Hashes of the merge's and the e2e graph's u16 outputs of one checkout.

    python3 scripts/torch_tree_outputs.py [--tree DIR]

Runs the ``panodepth_torch`` of ``DIR`` (default: this repository) on one
CUDA card: ``merge_arrays`` on ``chip_smoke.py``'s first scene
(5fold_leres, out 2048, seed 20231) and ``build_batched_e2e`` with the zoo
nets on ``chip_smoke.py``'s two 2048x1024 panoramas at batch 2 (views
256, baseline CNN 512), with PyTorch's TF32 flags at their defaults.
Prints one JSON line: the sha256 of each u16 output and the TF32 flags
before and after the calls.  Two checkouts compute the same outputs when
their hashes agree.  An earlier checkout needs only its
``panodepth_torch/`` unpacked into ``DIR`` (``git archive <commit>
panodepth_torch | tar -x -C DIR``); its kernels build into ``DIR``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="directory that holds the panodepth_torch to run")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # the scene makers; imports no panodepth_torch

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_tree_outputs: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.tree))
    for name in [m for m in sys.modules if m.split(".")[0] == "panodepth_torch"]:
        del sys.modules[name]
    import panodepth_torch
    from panodepth_torch import MergeConfig, merge_arrays
    from panodepth_torch.e2e import build_batched_e2e, load_model_checkpoint

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32)
    before = flags()
    dev = torch.device("cuda")
    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    scene = cs.make_scene(cfg, cs.SEED)
    emap = torch.tensor(cs._as01(scene["base"]), device=dev)
    pmaps = torch.tensor(cs.np.stack([cs._as01(v) for v in scene["views"]]),
                         device=dev)
    merged, _ = merge_arrays(emap, pmaps, cfg)
    persp, _ = load_model_checkpoint(cs.PERSP_CKPT)
    base, _ = load_model_checkpoint(cs.BASE_CKPT)
    rgbs = torch.stack([cs._pano_feed(cs.make_rgb(cs.SEED + i, 2048), dev)
                        for i in range(2)])
    full, _, _ = build_batched_e2e(persp, cfg, view_width=256,
                                   base_model=base, base_w=512)
    out, _ = full(rgbs)

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    print(json.dumps({
        "tree": os.path.dirname(os.path.abspath(panodepth_torch.__file__)),
        "merge_sha256": sha(merged), "e2e_sha256": sha(out),
        "tf32_before": before, "tf32_after": flags(),
        "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
