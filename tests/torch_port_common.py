"""Shared inputs for the panodepth_torch parity tests.

Every scene is made with numpy from a fixed seed and handed to both
packages, the JAX reference and the PyTorch port, as numpy arrays.
"""

import numpy as np
import torch

from panodepth import geometry as jgeometry
from panodepth.config import LAYOUTS as JAX_LAYOUTS
from panodepth.config import MergeConfig as JaxMergeConfig

import panodepth_torch.config as tconfig

from conftest import make_equirect, smooth_depth

# xdist runs several workers on a few cores: one thread each
torch.set_num_threads(1)

LAYOUT_NAMES = ("5fold_leres", "5fold_midas", "4fold", "3fold", "test2")


def port_layout(name):
    """Make the port know layout ``name``, handing over the JAX package's
    arrays for layouts that exist only there (``test2`` of conftest)."""
    if name not in tconfig.LAYOUTS:
        jl = JAX_LAYOUTS[name]()
        tconfig.layout_from_arrays(name, jl.fovs, jl.ranges)
    return tconfig.LAYOUTS[name]()


def configs(layout_name, out_width):
    """(JAX MergeConfig, port MergeConfig) for the same layout and width."""
    port_layout(layout_name)
    return (JaxMergeConfig(layout_name=layout_name, out_width=out_width),
            tconfig.MergeConfig(layout_name=layout_name, out_width=out_width))


def leres_scene():
    """The 15-view 5fold_leres scene of tests/test_parity_default.py at 128
    wide: a smooth field, each view an affine distortion of it."""
    jcfg, tcfg = configs("5fold_leres", 128)
    layout = jcfg.layout
    emap = np.clip(make_equirect(128, 64) * 0.9 + 0.04, 0, 1)
    pmaps = []
    for v in range(layout.num_views):
        win = jgeometry.make_window(*layout.fovs[v], xp=np)
        w, h = 128, 124
        xg, yg = np.meshgrid(np.arange(w) / (w - 1), np.arange(h) / (h - 1))
        azi, zen = jgeometry.xy_to_spherical(win, xg, yg, xp=np)
        pm = np.clip(smooth_depth(azi, zen) * (0.78 + 0.02 * (v % 5))
                     + 0.03 + 0.01 * (v // 5), 0, 1)
        pmaps.append(pm.astype(np.float32))
    return dict(jcfg=jcfg, tcfg=tcfg, emap=emap, pmaps=np.stack(pmaps))


def tiny_scene():
    """conftest's two-view ``test2`` scene at 64 wide."""
    jcfg, tcfg = configs("test2", 64)
    layout = jcfg.layout
    emap = np.clip(make_equirect(64, 32) * 0.92 + 0.02, 0, 1)
    pmaps = []
    for v in range(layout.num_views):
        win = jgeometry.make_window(*layout.fovs[v], xp=np)
        xg, yg = np.meshgrid(np.arange(64) / 63, np.arange(48) / 47)
        azi, zen = jgeometry.xy_to_spherical(win, xg, yg, xp=np)
        pm = smooth_depth(azi, zen) * (0.75 + 0.1 * v) + 0.08 - 0.03 * v
        pmaps.append(np.clip(pm, 0, 1).astype(np.float32))
    return dict(jcfg=jcfg, tcfg=tcfg, emap=emap, pmaps=np.stack(pmaps))


def flax_flat(params):
    """{flax path string: f32 numpy leaf} of a flax params tree, the form
    ``panodepth_torch.models.weights.load_params`` takes (the keys of a
    ``save_params_npz`` export)."""
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}



def zoo_pair(root, pano_width):
    """The zoo's NF perspective net and FastPanoNet as checkpoints under
    ``root`` (links to ``zoo/``) whose sidecars run the baseline net
    ``pano_width`` wide; returns the (persp, baseline) paths."""
    import json
    import os

    zoo = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "zoo")
    paths = []
    for name in ("perspective", "fastpano"):
        src = os.path.join(zoo, f"{name}_final.params.npz")
        dst = os.path.join(root, os.path.basename(src))
        os.symlink(src, dst)
        with open(os.path.join(zoo, f"{name}.config.json")) as fp:
            arch = json.load(fp)
        with open(os.path.join(root, f"{name}.config.json"), "w") as fp:
            json.dump(dict(arch, pano_width=pano_width), fp)
        paths.append(dst)
    return tuple(paths)
