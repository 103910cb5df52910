"""The e2e nets of the port (``panodepth_torch.models``) against the JAX
package's, and the loader that carries the zoo's weights across.

Layers first, with random parameters from flax's own initialisers carried
across by ``models.weights`` (WSConv at stride 1 and 2, the 7x7 stride-2
stem, CircConv at the seam, GlobalContext, the circular upsample, both
residual blocks); then both zoo nets (``zoo/perspective_final.params.npz``,
``zoo/fastpano_final.params.npz``) in both packages on 64x64 views and a
128x64 panorama.

Tolerances: in f32 mode the two frameworks differ by the summation order
of their convolutions: 1e-5 for layers and nets (measured ~2.4e-7 on the
zoo nets).  In bf16 mode (the shipping mode) each conv's output is rounded
to bf16 after sums taken in different orders, and a flipped rounding
propagates: the zoo nets' outputs are held within 1e-2 (measured 2.6e-3,
outputs ~0.1-0.5).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from panodepth.e2e import load_model_checkpoint as jload
from panodepth.models import fastpano as jfast
from panodepth.models import perspective as jpersp
from panodepth.models import train as jtrain

from panodepth_torch.models import fastpano as tfast
from panodepth_torch.models import norm as tnorm
from panodepth_torch.models import perspective as tpersp
from panodepth_torch.models import weights
from panodepth_torch.models.layers import same_pads

from torch_port_common import flax_flat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _inference():
    """The port's nets are trainable; these tests hold their inference
    forward (as e2e and serve run it) against JAX, so autograd is off."""
    with torch.no_grad():
        yield

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERSP = os.path.join(ROOT, "zoo", "perspective_final.params.npz")
BASE = os.path.join(ROOT, "zoo", "fastpano_final.params.npz")
F32_TOL = 1e-5
BF16_TOL = 1e-2


def _nchw(x):
    return torch.tensor(np.asarray(x, np.float32)).permute(0, 3, 1, 2)


def _pair(jmod, tmod, x, *extra):
    """Init ``jmod`` on ``x`` (NHWC), carry its params into ``tmod``; return
    (JAX output NHWC, port output NHWC) as numpy."""
    params = jmod.init(jax.random.PRNGKey(x.size % 97),
                       jnp.asarray(x), *[jnp.asarray(e) for e in extra])
    weights.load_params(tmod, flax_flat(params))
    want = np.asarray(jmod.apply(params, jnp.asarray(x),
                                 *[jnp.asarray(e) for e in extra]),
                      np.float32)
    got = tmod(_nchw(x), *[_nchw(e) for e in extra])
    return want, got.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("size,k,s", [(16, 3, 2), (17, 3, 2), (16, 7, 2),
                                      (16, 3, 1), (16, 1, 2), (15, 7, 2)])
def test_same_pads_match_lax(size, k, s):
    """lax's SAME is asymmetric at stride 2: 3x3 pads (0, 1), 7x7 (2, 3)."""
    want = lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert same_pads(size, k, s) == tuple(want)


@pytest.mark.parametrize("kernel,stride,gain_act", [
    ((3, 3), 1, jpersp._RELU_GAIN), ((3, 3), 2, jpersp._RELU_GAIN),
    ((7, 7), 2, 1.0), ((1, 1), 2, jpersp._RELU_GAIN)])
def test_wsconv_matches_jax(kernel, stride, gain_act):
    x = np.random.RandomState(0).normal(0, 1, (2, 16, 12, 5))
    jm = jpersp.WSConv(8, kernel, (stride, stride), dtype=jnp.float32,
                       gain_act=gain_act)
    tm = tpersp.WSConv(5, 8, kernel, (stride, stride), dtype=torch.float32,
                       gain_act=gain_act)
    want, got = _pair(jm, tm, x.astype(np.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("kernel,stride", [((3, 3), 1), ((3, 3), 2),
                                           ((5, 5), 2), ((1, 1), 1)])
def test_circconv_matches_jax_at_the_seam(kernel, stride):
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (2, 8, 16, 5)).astype(np.float32)
    jm = jfast.CircConv(6, kernel, (stride, stride), dtype=jnp.float32)
    tm = tfast.CircConv(5, 6, kernel, (stride, stride), dtype=torch.float32)
    want, got = _pair(jm, tm, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    # the seam columns are where a wrap differs from zero padding
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]],
                               rtol=0, atol=F32_TOL)


def test_global_context_and_circ_upsample_match_jax():
    x = np.random.RandomState(2).normal(0, 1, (2, 4, 8, 32)).astype(
        np.float32)
    want, got = _pair(jfast.GlobalContext(32, dtype=jnp.float32),
                      tfast.GlobalContext(32, dtype=torch.float32), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    want = np.asarray(jfast._circ_upsample2_bilinear(jnp.asarray(x)))
    got = tfast._circ_upsample2_bilinear(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


def test_latitude_features_match_jax():
    want = np.asarray(jfast._latitude_features(8, 16, jnp.float32))
    got = tfast._latitude_features(8, 16).transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride,cin", [(1, 16), (2, 8)])
def test_residual_blocks_match_jax(stride, cin):
    x = np.random.RandomState(3).normal(0, 1, (2, 8, 16, cin)).astype(
        np.float32)
    want, got = _pair(jpersp.NFResBlock(16, stride, beta=1.2,
                                        dtype=jnp.float32),
                      tpersp.NFResBlock(cin, 16, stride, beta=1.2,
                                        dtype=torch.float32), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    want, got = _pair(jfast.CircResBlock(16, stride, dtype=jnp.float32),
                      tfast.CircResBlock(cin, 16, stride,
                                         dtype=torch.float32), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_fusion_blocks_match_jax():
    rng = np.random.RandomState(4)
    x = rng.normal(0, 1, (1, 4, 8, 16)).astype(np.float32)
    skip = rng.normal(0, 1, (1, 8, 16, 8)).astype(np.float32)
    want, got = _pair(jpersp.NFFusionBlock(16, dtype=jnp.float32),
                      tpersp.NFFusionBlock(16, 16, 8, dtype=torch.float32),
                      x, skip)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    want, got = _pair(jfast.CircFusionBlock(16, dtype=jnp.float32),
                      tfast.CircFusionBlock(16, 16, 8, dtype=torch.float32),
                      x, skip)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_bf16_scalars_are_rounded_first():
    """NFResBlock multiplies by alpha rounded to bf16 (0.2 -> 0.2001953)."""
    c = tpersp._const(0.2, torch.bfloat16, torch.device("cpu"))
    assert float(c) == float(jnp.asarray(0.2, jnp.bfloat16)) == 0.2001953125


@functools.lru_cache(maxsize=None)
def _zoo(path, mode):
    """(JAX model, params, port model) of a zoo checkpoint in ``mode``."""
    jm, jp, arch = jload(path)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[mode]
    tm = weights.build_model(arch, dtype=tdt)
    weights.load_params(tm, weights.read_params_npz(path))
    return jm.clone(dtype=jdt), jp, tm


@pytest.mark.parametrize("mode,tol", [("f32", F32_TOL), ("bf16", BF16_TOL)])
def test_zoo_perspective_net_matches_jax(mode, tol):
    jm, jp, tm = _zoo(PERSP, mode)
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = tm(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the 99th-percentile map to 0~1, the exact sort form
    want01 = np.asarray(jax.jit(functools.partial(
        jpersp.predict_depth01, model=jm))(jp, rgb=jnp.asarray(x)))
    got01 = tpersp.predict_depth01(tm, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got01, want01, rtol=0, atol=tol)


@pytest.mark.parametrize("mode,tol", [("f32", F32_TOL), ("bf16", BF16_TOL)])
def test_zoo_fastpano_net_matches_jax(mode, tol):
    jm, jp, tm = _zoo(BASE, mode)
    assert sum(isinstance(m, tnorm.GroupNorm) for m in tm.modules()) == 29
    x = np.random.RandomState(6).rand(1, 64, 128, 3).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = tm(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (1, 64, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_percentile99_matches_jnp_percentile():
    """The same ranks and the same linear interpolation.  XLA on the CPU
    forms q / 100 as q * (1/100), one f32 ulp off the division the port
    makes, which moves the interpolation weight by up to (N - 1) * 1e-8:
    held within 1e-5 relative, and exactly at the sorted ranks."""
    rng = np.random.RandomState(7)
    for n in (65536, 1000, 7):
        flat = rng.gamma(2.0, 1.0, (3, n)).astype(np.float32)
        want = np.asarray(jnp.percentile(jnp.asarray(flat), 99.0, axis=1))
        got = tpersp._percentile99(torch.tensor(flat)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        s = np.sort(flat, 1)
        lo = int(np.floor(np.float32(0.99) * np.float32(n - 1)))
        assert np.all(s[:, lo] <= got) and np.all(
            got <= s[:, min(lo + 1, n - 1)])


@pytest.mark.parametrize("path", [PERSP, BASE])
def test_zoo_weights_carried_bit_for_bit(path):
    """Every npz key is consumed, every parameter filled, and each tensor,
    put back in flax's layout, equals the JAX loader's leaf bit for bit."""
    jm, jp, tm = _zoo(path, "f32")
    leaves = flax_flat(jp)
    params = dict(tm.named_parameters())
    assert len(leaves) == len(params) == len(np.load(path).files)
    for key, leaf in leaves.items():
        p = params[weights.port_name(key)].detach().numpy()
        if p.ndim == 4:
            p = p.transpose(2, 3, 1, 0)
        elif p.ndim == 2:
            p = p.T
        np.testing.assert_array_equal(p, leaf)
    # the JAX loader reads the same bits (bf16 patterns widened)
    np.testing.assert_array_equal(
        np.asarray(jtrain.load_params_npz(path, jp)["params"]["Conv_0"]
                   ["kernel"]).reshape(-1),
        params["Conv_0.kernel"].detach().numpy().reshape(-1))


def test_loader_refuses_leftovers_and_holes():
    flat = weights.read_params_npz(BASE)
    tm = weights.build_model(weights.read_arch(BASE))
    extra = dict(flat)
    extra["['params']['Bogus_0']['kernel']"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="unused checkpoint keys"):
        weights.load_params(tm, extra)
    short = dict(flat)
    del short["['params']['GroupNorm_0']['scale']"]
    with pytest.raises(ValueError, match="unfilled parameters"):
        weights.load_params(tm, short)
    bad = dict(flat)
    bad["['params']['GroupNorm_0']['scale']"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="checkpoint shape"):
        weights.load_params(tm, bad)
    with pytest.raises(ValueError, match="not a flax parameter path"):
        weights.port_name("GroupNorm_0/scale")


def test_fastpano_refuses_widths_not_divisible_by_64():
    tm = tfast.FastPanoNet(widths=(8, 8, 16, 16), decoder_width=16,
                           dtype=torch.float32)
    with pytest.raises(ValueError, match="W % 64 == 0"):
        tm(torch.zeros(1, 48, 96, 3))
    with pytest.raises(ValueError, match="W % 64 == 0"):
        tm(torch.zeros(1, 32, 128, 3))  # not W/2 high


def test_zoo_fastpano_with_bf16_norms_matches_jax():
    """``--infer-norm bf16``: the norms return bf16, so the residual stream
    is bf16 too; the statistics stay f32 in both packages."""
    jm, jp, arch = jload(BASE, norm_dtype=jnp.bfloat16)
    tm = weights.build_model(arch, norm_dtype=torch.bfloat16)
    weights.load_params(tm, weights.read_params_npz(BASE))
    x = np.random.RandomState(8).rand(1, 64, 128, 3).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)
