"""The zoo's other model families in the port against the JAX package, on
the zoo's own checkpoints: the GN ``PerspectiveDepthNet``
(``zoo/gn/perspective_final.params.npz``), the UniFuse-class
``PanoBaselineNet`` (``zoo/panoramic_*``), ``HorizonDepthNet``
(``zoo/hohonet_*``), ``BiFuseNet`` (``zoo/bifuse_*``) and ``SliceNet``
(``zoo/slicenet_*``); both packages load the same checkpoint, the port
through ``models.weights``.  Also the ``proj="fast"`` graph of both
two-branch nets, the bf16-norm mode, the normalizer-free UniFuse-class
net (no zoo checkpoint: random weights carried across), and the loader's
branches (width scaling, the fall-through of unknown kinds, the
projection knobs).

HoHoNet and SliceNet run at their fixed 256x512, the others at 64x128
panoramas and 64x64 views.  Tolerances are ``tests/test_torch_models.py``'s:
f32 1e-5, bf16 1e-2 (outputs in 0~1; measured 5e-4 to 4.5e-3).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.e2e import load_model_checkpoint as jload
from panodepth.models import panoramic as jpano
from panodepth.models import perspective as jpersp

from panodepth_torch.models import norm as tnorm
from panodepth_torch.models import panoramic as tpano
from panodepth_torch.models import perspective as tpersp
from panodepth_torch.models import weights

from torch_port_common import flax_flat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _inference():
    """The port's nets are trainable; these tests hold their inference
    forward (as e2e and serve run it) against JAX, so autograd is off."""
    with torch.no_grad():
        yield

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "zoo")
F32_TOL = 1e-5
BF16_TOL = 1e-2
MODES = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}
# checkpoint, input shape, GroupNorms per forward, the port's class
ZOO_NETS = {
    "gn_perspective": ("gn/perspective_final.params.npz", (2, 64, 64, 3), 29,
                       "PerspectiveDepthNet"),
    "panoramic": ("panoramic_final.params.npz", (1, 64, 128, 3), 31,
                  "PanoBaselineNet"),
    "hohonet": ("hohonet_final.params.npz", (1, 256, 512, 3), 18,
                "HorizonDepthNet"),
    "bifuse": ("bifuse_final.params.npz", (1, 64, 128, 3), 38, "BiFuseNet"),
    "slicenet": ("slicenet_final.params.npz", (1, 256, 512, 3), 16,
                 "SliceNet"),
}


@functools.lru_cache(maxsize=None)
def _jax_zoo(name):
    """(JAX model, params, arch) of a zoo checkpoint."""
    return jload(os.path.join(ZOO, ZOO_NETS[name][0]))


def _port(name, dtype=torch.float32, norm_dtype=torch.float32):
    path = os.path.join(ZOO, ZOO_NETS[name][0])
    tm = weights.build_model(weights.read_arch(path), dtype=dtype,
                             norm_dtype=norm_dtype)
    return weights.load_params(tm, weights.read_params_npz(path))


def _input(name):
    shape = ZOO_NETS[name][1]
    return np.random.RandomState(len(name)).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("name", list(ZOO_NETS))
@pytest.mark.parametrize("mode,tol", [("f32", F32_TOL), ("bf16", BF16_TOL)])
def test_zoo_net_matches_jax(name, mode, tol):
    jd, td = MODES[mode]
    jm, jp, _ = _jax_zoo(name)
    tm = _port(name, dtype=td)
    assert type(tm).__name__ == ZOO_NETS[name][3]
    assert sum(isinstance(m, tnorm.GroupNorm)
               for m in tm.modules()) == ZOO_NETS[name][2]
    x = _input(name)
    want = np.asarray(jax.jit(jm.clone(dtype=jd).apply)(jp, jnp.asarray(x)))
    got = tm(torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == x.shape[
        :3]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if name == "gn_perspective":
        # the 99th-percentile map to 0~1 the e2e graph applies
        want01 = np.asarray(jax.jit(functools.partial(
            jpersp.predict_depth01, model=jm.clone(dtype=jd)))(
            jp, rgb=jnp.asarray(x)))
        got01 = tpersp.predict_depth01(tm, torch.tensor(x)).numpy()
        np.testing.assert_allclose(got01, want01, rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(ZOO_NETS))
def test_zoo_weights_carried_bit_for_bit(name):
    """Every npz key consumed, every parameter filled, and each tensor, put
    back in flax's layout, equal to the JAX loader's leaf (the attention's
    3-D kernels included)."""
    _, jp, _ = _jax_zoo(name)
    tm = _port(name)
    leaves = flax_flat(jp)
    params = dict(tm.named_parameters())
    path = os.path.join(ZOO, ZOO_NETS[name][0])
    assert len(leaves) == len(params) == len(np.load(path).files)
    for key, leaf in leaves.items():
        port_key = weights.port_name(key)
        p = params[port_key].detach().numpy()
        if p.ndim == 4:
            p = p.transpose(2, 3, 1, 0)
        elif p.ndim == 3:
            p = p.transpose((1, 2, 0) if port_key.endswith(".out.kernel")
                            else (2, 0, 1))
        elif p.ndim == 2 and port_key.endswith("kernel"):
            p = p.T
        np.testing.assert_array_equal(p, leaf)


@pytest.mark.parametrize("name,knob", [("panoramic", "PANODEPTH_PANO_PROJ"),
                                       ("bifuse", "PANODEPTH_BIFUSE_PROJ")])
def test_fast_projection_graph_matches_jax(name, knob, monkeypatch):
    """The same checkpoint with one-tap feature projections, picked by the
    JAX loader's environment knob in both packages."""
    monkeypatch.setenv(knob, "fast")
    path = os.path.join(ZOO, ZOO_NETS[name][0])
    jm, jp, _ = jload(path)
    assert jm.proj == "fast"
    jm = jm.clone(dtype=jnp.float32)
    tm = _port(name)
    x = _input(name)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    # and it is another graph than the bilinear one
    monkeypatch.setenv(knob, "bilinear")
    assert float(np.abs(_port(name)(torch.tensor(x)).numpy() - got).max()
                 ) > 1e-4


def test_zoo_bifuse_with_bf16_norms_matches_jax():
    """``--infer-norm bf16``: the norms return bf16, so the residual stream
    is bf16; the statistics stay f32 in both packages."""
    path = os.path.join(ZOO, ZOO_NETS["bifuse"][0])
    jm, jp, _ = jload(path, norm_dtype=jnp.bfloat16)
    tm = _port("bifuse", dtype=torch.bfloat16, norm_dtype=torch.bfloat16)
    x = _input("bifuse")
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_nf_pano_baseline_net_matches_jax(mode):
    """The normalizer-free UniFuse-class net (no zoo checkpoint) on random
    weights at narrow widths: no GroupNorm in it."""
    jd, td = MODES[mode]
    x = np.random.RandomState(13).rand(1, 32, 64, 3).astype(np.float32)
    jm = jpano.NFPanoBaselineNet(widths=(8, 8, 16, 16), dtype=jd)
    tm = tpano.NFPanoBaselineNet(widths=(8, 8, 16, 16), dtype=td)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    weights.load_params(tm, flax_flat(params))
    assert not any(isinstance(m, tnorm.GroupNorm) for m in tm.modules())
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_TOL if mode == "f32" else BF16_TOL)


@pytest.mark.parametrize("arch,cls,widths", [
    ({"model": "perspective", "width_scale": 0.5}, "PerspectiveDepthNet",
     (32, 64, 128, 256)),
    ({"model": "perspective", "variant": "nf"}, "NFPerspectiveNet",
     (64, 128, 256, 512)),
    ({"model": "hohonet", "width_scale": 0.25}, "HorizonDepthNet",
     (8, 16, 32, 64)),
    ({"model": "bifuse"}, "BiFuseNet", (32, 64, 128, 256)),
    ({"model": "slicenet", "width_scale": 0.125}, "SliceNet",
     (8, 8, 16, 32)),
    ({"model": "panoramic", "variant": "nf"}, "NFPanoBaselineNet",
     (32, 64, 128, 256)),
    ({"model": "unifuse"}, "PanoBaselineNet", (32, 64, 128, 256)),
])
def test_build_model_follows_the_jax_loader(arch, cls, widths):
    """Every branch of ``panodepth/e2e.py::load_model_checkpoint``: the
    class, the scaled widths (``max(8, int(w * s))``) and the parameter
    shapes JAX's init gives at the sidecar's ``pano_width``, an unknown
    kind falling through to the UniFuse-class net."""
    arch = dict(arch, pano_width=128, view_size=64)
    tm = weights.build_model(arch)
    assert type(tm).__name__ == cls
    if hasattr(tm, "widths"):
        assert tm.widths == widths
    jm = {"PerspectiveDepthNet": jpersp.PerspectiveDepthNet,
          "NFPerspectiveNet": jpersp.NFPerspectiveNet}.get(cls)
    if jm is None:
        from panodepth.models import bifuse, hohonet, slicenet

        jm = {"HorizonDepthNet": hohonet.HorizonDepthNet,
              "BiFuseNet": bifuse.BiFuseNet, "SliceNet": slicenet.SliceNet,
              "NFPanoBaselineNet": jpano.NFPanoBaselineNet,
              "PanoBaselineNet": jpano.PanoBaselineNet}[cls]
    s = arch.get("width_scale", 1.0)
    kw = {}
    if cls in ("HorizonDepthNet",):
        kw["horizon_dim"] = max(32, int(256 * s))
    if cls in ("SliceNet",):
        kw["slice_dim"] = max(32, int(256 * s))
    if cls in ("PerspectiveDepthNet", "NFPerspectiveNet"):
        kw["decoder_width"] = max(16, int(128 * s))
        sample = jnp.zeros((1, 64, 64, 3))
    else:
        sample = jnp.zeros((1, 64, 128, 3))
    shapes = jax.eval_shape(functools.partial(
        jm(widths=widths, **kw).init, jax.random.PRNGKey(0)), sample)
    flat = {weights.port_name(jax.tree_util.keystr(k)): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    ported = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert set(flat) == set(ported)
    for n, shape in flat.items():
        assert weights.to_port_layout(n, np.zeros(shape)).shape == ported[n]


def test_proj_knobs_refuse_unknown_forms(monkeypatch):
    monkeypatch.setenv("PANODEPTH_BIFUSE_PROJ", "bicubic")
    with pytest.raises(ValueError, match="proj must be one of"):
        weights.build_model({"model": "bifuse"})
