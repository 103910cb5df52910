"""The e2e graph of the port with every zoo family against the JAX
package's ``build_batched_e2e``: each new baseline checkpoint
(``zoo/{panoramic,hohonet,bifuse,slicenet}_final.params.npz``) beside the
zoo NF perspective net, and the GN perspective net
(``zoo/gn/perspective_final.params.npz``) beside FastPanoNet.

Small layout (two views, out width 64, views 64 wide) on the scene of
``tests/test_torch_e2e.py``; the baseline CNN at 128 wide, or at 512 for
HoHoNet and SliceNet, whose column decoders fix the width.  Bars on the
u16 output are those of ``tests/test_torch_e2e.py`` (f32 max 4, mean 0.5;
bf16 max 2048, mean 64), for the reasons given there, but for f32 with
the NF perspective net beside the four new baselines (``F32_STEEP_BAR``):
these baselines span a narrow depth range (0.06-0.20 for the UniFuse-class
net), the per-view cubics are steep (coefficients ~5e3 that cancel), and
one f32 ulp of a coefficient moves the depth by ~5e-4.  The first op that
differs is the registration's normal equations, summed in another order:
on the JAX package's own models-stage outputs, the port's fuse stage
differs from JAX's by up to max 54, mean 2.51 u16 (BiFuse), and JAX
against itself moves 18 u16 under 1e-6 of noise on one baseline.  The
whole graph measured max 65, mean 2.48 (BiFuse), 26 / 1.45 (UniFuse-
class), 15-22 / 1.7 (HoHoNet), 24 / 1.29 (SliceNet); the nets' own outputs
inside the graph are held at 1e-5 in the same test.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import e2e as je
from panodepth.config import MergeConfig as JaxMergeConfig
from panodepth.config import ViewLayout, register_layout

import panodepth_torch.config as tconfig
from panodepth_torch import e2e as te
from panodepth_torch.kernels import groupnorm as kg
from panodepth_torch.kernels import jacobi as kj

from test_torch_e2e import BF16_BAR, F32_BAR, _scene, _u16_diff

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "zoo")
NF_PERSP = os.path.join(ZOO, "perspective_final.params.npz")
GN_PERSP = os.path.join(ZOO, "gn", "perspective_final.params.npz")
F32_STEEP_BAR = (128, 4.0)
# (perspective checkpoint, baseline checkpoint, baseline CNN width)
PAIRS = {
    "panoramic": (NF_PERSP, os.path.join(ZOO, "panoramic_final.params.npz"),
                  128),
    "hohonet": (NF_PERSP, os.path.join(ZOO, "hohonet_final.params.npz"),
                512),
    "bifuse": (NF_PERSP, os.path.join(ZOO, "bifuse_final.params.npz"), 128),
    "slicenet": (NF_PERSP, os.path.join(ZOO, "slicenet_final.params.npz"),
                 512),
    "gn_perspective": (GN_PERSP, os.path.join(
        ZOO, "fastpano_final.params.npz"), 128),
}

D2R = math.pi / 180.0
FOVS = np.array([(25 * D2R, 175 * D2R, 30 * D2R, 150 * D2R),
                 (185 * D2R, 355 * D2R, 30 * D2R, 150 * D2R)])
RANGES = np.array([(170 * D2R, 30 * D2R, 40 * D2R, 140 * D2R),
                   (350 * D2R, 190 * D2R, 40 * D2R, 140 * D2R)])
register_layout(ViewLayout("torch_families", fovs=FOVS, ranges=RANGES))
tconfig.layout_from_arrays("torch_families", FOVS, RANGES)
JCFG = JaxMergeConfig(layout_name="torch_families", out_width=64)
TCFG = tconfig.MergeConfig(layout_name="torch_families", out_width=64)


@pytest.mark.parametrize("family", list(PAIRS))
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_batched_e2e_with_each_family_matches_jax(family, mode):
    """The models stage (baselines and the views' depths) within the nets'
    own bars, then the u16 output (see the module docstring for the
    bars)."""
    persp, base, base_w = PAIRS[family]
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[mode]
    bar = BF16_BAR if mode == "bf16" else (
        F32_BAR if persp == GN_PERSP else F32_STEEP_BAR)
    rng = np.random.RandomState(3)
    rgbs = np.stack([_scene(0, rng), _scene(1, rng)])
    jp, jpp, _ = je.load_model_checkpoint(persp)
    jb, jbp, _ = je.load_model_checkpoint(base)
    tp, _ = te.load_model_checkpoint(persp, device="cpu", dtype=td)
    tb, _ = te.load_model_checkpoint(base, device="cpu", dtype=td)
    _, j_models, j_fuse = je.build_batched_e2e(
        jp.clone(dtype=jd), jpp, JCFG, view_width=64,
        base_model=jb.clone(dtype=jd), base_params=jbp, base_w=base_w)
    t_full, t_models, _ = te.build_batched_e2e(
        tp, TCFG, view_width=64, base_model=tb, base_w=base_w,
        device="cpu")
    kj.LAUNCHES = kg.LAUNCHES = 0
    t_out, t_base = t_full(torch.tensor(rgbs))
    assert kj.LAUNCHES == kg.LAUNCHES == 0  # the CPU runs no kernel
    j_base, j_pmaps = j_models(jnp.asarray(rgbs))
    j_out, _ = j_fuse(j_base, j_pmaps)
    assert t_out.shape == j_out.shape == (2, 32, 64)
    assert t_out.dtype == torch.uint16
    # the models stage: the family's nets inside the graph
    tol = 1e-5 if mode == "f32" else 1e-2
    assert t_base.shape == (2, base_w // 2, base_w)
    np.testing.assert_allclose(t_base.numpy(), np.asarray(j_base), rtol=0,
                               atol=tol)
    _, t_pmaps = t_models(torch.tensor(rgbs))
    for got, want in zip(t_pmaps, j_pmaps):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)
    dmax, dmean = _u16_diff(t_out.numpy(), j_out)
    assert dmax <= bar[0] and dmean < bar[1], (dmax, dmean)
    # each panorama at batch 1 gives its batch-2 output: every net runs one
    # panorama per call
    single, _ = t_full(torch.tensor(rgbs[1:]))
    assert _u16_diff(single[0], t_out[1])[0] <= 1
