"""Shared inputs for the panodepth_torch parity tests.

Every scene is made with numpy from a fixed seed and handed to both
packages, the JAX reference and the PyTorch port, as numpy arrays.
"""

import os
import subprocess
import sys

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


# --- multi-process runs (tests/test_torch_parallel.py, test_torch_multihost.py,
# test_torch_spatial.py, test_torch_latency.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR_TIMEOUT = 120  # seconds a spawned pair may take


def free_port() -> int:
    """A port the system has just handed out (a bind to port 0)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv, out=subprocess.PIPE):
    """``python argv`` from the repository root, on one thread; the JAX
    variables of the test process are not passed on (the ranks import no
    JAX)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                            stdout=out, stderr=subprocess.STDOUT, text=True)


def _port_taken(text: str) -> bool:
    return "address already in use" in text.lower()


def run_pair(argv_of, timeout=PAIR_TIMEOUT, nproc=2):
    """Ranks 0 .. ``nproc - 1`` of ``argv_of(port, rank)`` together, each
    killed if still running at the end; a port taken in between is picked
    again once.  Returns every rank's output; asserts each exited 0."""
    for attempt in range(2):
        port = free_port()
        procs = [spawn(argv_of(port, r)) for r in range(nproc)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if attempt == 0 and any(p.returncode for p in procs) and any(
                _port_taken(o) for o in outs):
            continue
        break
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exit {p.returncode}:\n" \
                                  f"{out[-3000:]}"
    return outs
