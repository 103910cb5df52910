"""The port's GroupNorm (``panodepth_torch.kernels.groupnorm`` and the
``models.norm.GroupNorm`` module) against the JAX package's.

The plain twin ``group_norm_plain`` is what the CPU runs and what the CUDA
kernel is held to on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).  Here it is held to flax ``nn.GroupNorm``, to
``panodepth.models.norm.GroupNorm`` on its fallback path and to the Pallas
kernel ``panodepth.kernels.groupnorm.group_norm`` in interpret mode (as
``tests/test_groupnorm.py`` runs it), on the same numpy inputs.  The JAX
functions take NHWC, the port NCHW.

Tolerances: the two packages sum in different orders, so an f32 output is
held within 16 f32 ulps of its largest magnitude (at least 1), and a bf16
output within 1 bf16 ulp, element by element.
"""

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.kernels import groupnorm as jgroupnorm
from panodepth.models import norm as jnorm

from panodepth_torch.kernels import groupnorm as kg
from panodepth_torch.models import norm as tnorm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _inference():
    """The port's nets are trainable; these tests hold their inference
    forward (as e2e and serve run it) against JAX, so autograd is off."""
    with torch.no_grad():
        yield

F32_ULPS = 16


def _inputs(shape, groups, seed, in_dtype):
    """(x NHWC as JAX gets it, x NCHW as the port gets it, scale, bias)."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0.3, 1.7, shape).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 2.0, c).astype(np.float32)
    bias = rng.uniform(-1, 1, c).astype(np.float32)
    jx = jnp.asarray(x).astype(in_dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16 if in_dtype == jnp.bfloat16 else torch.float32)
    perm = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))
    return jx, tx.permute(*perm).contiguous(), scale, bias


def _assert_close(got_nchw, want_nhwc):
    """Port output (NCHW tensor) against a JAX output (NHWC array)."""
    want = np.asarray(jnp.asarray(want_nhwc).astype(jnp.float32))
    got = got_nchw.float()
    got = got.permute(0, *range(2, got.dim()), 1).numpy()
    assert got.shape == want.shape
    if want_nhwc.dtype == jnp.bfloat16:
        g = got_nchw.permute(0, *range(2, got_nchw.dim()), 1).contiguous()
        w = torch.tensor(want).to(torch.bfloat16)
        gi = g.view(torch.int16).to(torch.int64)
        wi = w.view(torch.int16).to(torch.int64)
        gi = torch.where(gi < 0, -(gi & 0x7FFF), gi)
        wi = torch.where(wi < 0, -(wi & 0x7FFF), wi)
        assert int((gi - wi).abs().max()) <= 1
    else:
        tol = F32_ULPS * 2.0 ** -23 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# FastPanoNet's (C, groups) pairs (_groups = gcd(C, 32)) at small sizes
PATH_SHAPES = [((2, 16, 32, 24), 8), ((1, 8, 16, 48), 16),
               ((2, 8, 8, 96), 32), ((1, 4, 8, 192), 32),
               ((1, 2, 4, 384), 32)]


@pytest.mark.parametrize("shape,groups", PATH_SHAPES)
@pytest.mark.parametrize("in_dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("out_dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_flax_group_norm(shape, groups, in_dtype, out_dtype):
    jx, tx, scale, bias = _inputs(shape, groups, len(shape) + groups,
                                  in_dtype)
    gn = nn.GroupNorm(num_groups=groups, epsilon=1e-6, dtype=out_dtype)
    want = gn.apply({"params": {"scale": scale, "bias": bias}}, jx)
    got = kg.group_norm_plain(
        tx, torch.tensor(scale), torch.tensor(bias), groups, eps=1e-6,
        out_dtype=torch.bfloat16 if out_dtype == jnp.bfloat16
        else torch.float32)
    _assert_close(got, want)


@pytest.mark.parametrize("shape,groups", PATH_SHAPES[:3])
@pytest.mark.parametrize("relu", [False, True])
def test_module_matches_jax_module_fallback(shape, groups, relu):
    """models.norm.GroupNorm of both packages, bf16 in, f32 out (the e2e
    graph's norm off the TPU), the ReLU fused or not."""
    jx, tx, scale, bias = _inputs(shape, groups, 7, jnp.bfloat16)
    jm = jnorm.GroupNorm(num_groups=groups, dtype=jnp.float32,
                         fuse_relu=relu)
    assert not jm._fusable(jx)  # the flax fallback path
    want = jm.apply({"params": {"scale": scale, "bias": bias}}, jx)
    tm = tnorm.GroupNorm(shape[-1], groups, fuse_relu=relu)
    with torch.no_grad():
        tm.scale.copy_(torch.tensor(scale))
        tm.bias.copy_(torch.tensor(bias))
    before = kg.LAUNCHES
    got = tm(tx)
    assert kg.LAUNCHES == before  # a CPU tensor takes the twin
    assert got.dtype == torch.float32
    if relu:
        assert float(got.min()) >= 0.0
    _assert_close(got, want)


@pytest.mark.parametrize("shape,groups", [((2, 16, 16, 64), 32),
                                          ((2, 16, 16, 32), 32),
                                          ((1, 16, 32, 128), 32)])
@pytest.mark.parametrize("in_dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_pallas_kernel_interpret(shape, groups, in_dtype,
                                               relu):
    """The TPU kernel the CUDA kernel replaces, run in interpret mode (it
    takes only channel counts that fold into 128 lanes)."""
    jx, tx, scale, bias = _inputs(shape, groups, 11, in_dtype)
    assert jgroupnorm.supported(shape, groups, in_dtype, jnp.float32)
    want = jgroupnorm.group_norm(jx, jnp.asarray(scale), jnp.asarray(bias),
                                 groups, eps=1e-6, relu=relu,
                                 out_dtype=jnp.float32, interpret=True)
    got = kg.group_norm_plain(tx, torch.tensor(scale), torch.tensor(bias),
                              groups, eps=1e-6, relu=relu)
    _assert_close(got, want)


def test_near_constant_group_stays_finite():
    """E[x^2] - E[x]^2 can round below 0 for a constant group; the clamp
    keeps rsqrt finite, in both packages alike.  There rsqrt(var + eps) is
    ~1000 and amplifies the sums' rounding, so the bound is 2^-10 absolute
    (the bound chip_smoke.py states for this case)."""
    x = np.full((1, 4, 8, 32), 0.1, np.float32)
    x[..., 16:] = np.random.RandomState(0).normal(0, 1, (1, 4, 8, 16))
    scale = np.ones(32, np.float32)
    bias = np.linspace(-1, 1, 32).astype(np.float32)
    want = nn.GroupNorm(num_groups=32, epsilon=1e-6, dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    got = kg.group_norm_plain(torch.tensor(x).permute(0, 3, 1, 2),
                              torch.tensor(scale), torch.tensor(bias), 32)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=2.0 ** -10)


def test_routes_and_set_route():
    x = torch.randn(2, 8, 4, 4)
    s, b = torch.ones(8), torch.zeros(8)
    assert kg.resolve("torch") is kg.group_norm_plain
    assert kg.resolve("kernel") is kg.cuda_group_norm
    before = kg.LAUNCHES
    torch.testing.assert_close(kg.resolve("auto")(x, s, b, 4),
                               kg.group_norm_plain(x, s, b, 4), rtol=0,
                               atol=0)
    assert kg.LAUNCHES == before
    with pytest.raises(ValueError, match="groupnorm route must be one of"):
        kg.resolve("pallas")
    m = torch.nn.Sequential(tnorm.GroupNorm(8, 4), tnorm.GroupNorm(8, 2))
    tnorm.set_route(m, "kernel")
    assert [g.route for g in m] == ["kernel", "kernel"]
    with pytest.raises(TypeError, match="CUDA tensor"):
        m(x)  # the kernel route never falls back to the twin
    with pytest.raises(ValueError):
        tnorm.set_route(m, "nope")
