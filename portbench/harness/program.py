"""The system under test, built from a configuration file: the e2e graph
of ``panodepth_torch.e2e.build_batched_e2e`` with the zoo's nets, or its
exported artifact loaded by ``panodepth_torch.serve``.  This is the only
module of the harness that imports the program."""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import torch

# the program's files that an exported artifact depends on
_SOURCES = (".py", ".cu", ".cuh", ".cpp", ".h")


def set_env(config: dict):
    """The pipeline options the configuration states, as the environment
    variables the program reads when it captures or exports a stage."""
    pipe = config["pipeline"]
    os.environ["PANODEPTH_BASE_FEED"] = pipe.get("base_feed", "bilinear")
    os.environ["PANODEPTH_P99"] = pipe.get("p99", "sort")


def merge_config(config: dict):
    """The program's ``MergeConfig`` of the configuration's pipeline,
    checked against what the configuration states of it: the layout's
    windows and ranges (``layout_spec``, which the reference builds its
    own from) and the Jacobi iterations of each level."""
    import numpy as np
    from panodepth_torch.config import MergeConfig

    from ..reference import layout as L

    pipe = config["pipeline"]
    mc = MergeConfig(layout_name=pipe["layout"], out_width=pipe["out_width"])
    fovs, ranges = L.layout_tables(pipe["layout_spec"])
    if not (np.allclose(mc.layout.fovs, fovs)
            and np.allclose(mc.layout.ranges, ranges)):
        raise ValueError(f"layout {pipe['layout']!r} of the program differs "
                         f"from the configuration's layout_spec")
    if list(mc.schedule) != list(pipe["jacobi"]):
        raise ValueError(f"the configuration states Jacobi {pipe['jacobi']}; "
                         f"the program runs {list(mc.schedule)}")
    return mc


def load_nets(config: dict, root: Path, device):
    """(perspective net, baseline net) as the CLI loads them: nets in
    bfloat16, norms out in float32, the int8 graph where stated."""
    from panodepth_torch import e2e

    persp, _ = e2e.load_model_checkpoint(
        str(root / config["perspective"]["checkpoint"]), device=device,
        quantize=config["perspective"]["int8"])
    base, _ = e2e.load_model_checkpoint(
        str(root / config["baseline"]["checkpoint"]), device=device)
    return persp, base


def build_e2e(config: dict, root: Path, device):
    """``(full, models_stage, fuse_stage)`` of the batched e2e graph."""
    from panodepth_torch import e2e

    set_env(config)
    persp, base = load_nets(config, root, device)
    return e2e.build_batched_e2e(
        persp, merge_config(config),
        view_width=config["perspective"]["view_width"], base_model=base,
        base_w=config["baseline"]["width"],
        extract_dtype=config["pipeline"].get("extract_dtype", "auto"),
        device=device)


def program_digest(root: Path) -> str:
    """A digest of every source file of the program."""
    h = hashlib.sha256()
    pkg = root / "panodepth_torch"
    for path in sorted(pkg.rglob("*")):
        rel = path.relative_to(pkg)
        if (path.is_file() and path.suffix in _SOURCES
                and not {"_build", "__pycache__"} & set(rel.parts)):
            h.update(str(rel).encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def artifact(config: dict, batch: int, root: Path, cache: Path, device,
             log=print):
    """The ``serve export-e2e`` artifact of the configuration at ``batch``,
    exported on a miss of ``cache`` (keyed by the program's sources, the
    configuration, the batch, the device and PyTorch), then loaded."""
    from panodepth_torch import serve

    set_env(config)
    merge = merge_config(config)
    key = hashlib.sha256(json.dumps(
        [program_digest(root), config, batch, torch.__version__,
         torch.cuda.get_device_name(device) if torch.device(
             device).type == "cuda" else "cpu"],
        sort_keys=True).encode()).hexdigest()[:24]
    path = cache / f"e2e-{key}.pt2"
    if not (path.is_file() and Path(str(path) + ".meta.json").is_file()):
        cache.mkdir(parents=True, exist_ok=True)
        for old in cache.glob("e2e-*.pt2*"):
            old.unlink()
        tmp = cache / f"tmp-{key}.pt2"
        log(f"[portbench] exporting the e2e artifact (batch {batch}) to "
            f"{path.name}")
        serve.export_e2e(
            str(tmp), merge, batch,
            str(root / config["perspective"]["checkpoint"]),
            str(root / config["baseline"]["checkpoint"]),
            rgb_shape=tuple(config["rgb_shape"]),
            view_width=config["perspective"]["view_width"],
            persp_int8=config["perspective"]["int8"], device=device)
        os.replace(str(tmp) + ".meta.json", str(path) + ".meta.json")
        os.replace(tmp, path)
    return serve.load(str(path), device)


def batcher(art, max_delay_ms: float):
    """The daemon's micro-batcher over ``art``, started, with the daemon's
    warm-up call (its first call captures the graph)."""
    import numpy as np

    from panodepth_torch.daemon import Batcher

    b = Batcher(art, max_delay_ms=max_delay_ms).start()
    b.submit([np.zeros(s, d) for s, d in zip(b.item_shapes, b.item_dtypes)])
    return b
