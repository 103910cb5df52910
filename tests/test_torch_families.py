"""The building blocks of the port's model families against flax, on random
weights from flax's own initialisers carried across by
``models.weights.load_params``: the GN ``ResBlock`` and ``FusionBlock``,
UniFuse's ``SEGate``, ``UniFuseBlock`` and ``NFUniFuseBlock``, BiFuse's
``BiProjFusion`` and ``_Decoder``, flax's ``LayerNorm``,
``MultiHeadDotProductAttention``, ``gelu`` and ``GRUCell`` (as
``nn.RNN`` runs it, both ways), HoHoNet's ``HorizonAttention`` and
SliceNet's ``CircularBiGRU``.  Inputs are made with numpy from a seed.

Tolerances, of the output's largest magnitude (at least 1): f32 1e-5 (the
frameworks' sums run in other orders, and flax's fast variance cancels
where a row's mean is large); bf16 ``BF16_REL``:
each op rounds to bf16 (one step is 2^-8 relative), and XLA on the CPU
keeps some elementwise chains in f32 where PyTorch rounds each op, so a
flipped rounding of one or two steps passes through a block.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.models import bifuse as jbifuse
from panodepth.models import hohonet as jhoho
from panodepth.models import panoramic as jpano
from panodepth.models import perspective as jpersp
from panodepth.models import slicenet as jslice

from panodepth_torch.models import bifuse as tbifuse
from panodepth_torch.models import hohonet as thoho
from panodepth_torch.models import layers as tlayers
from panodepth_torch.models import panoramic as tpano
from panodepth_torch.models import perspective as tpersp
from panodepth_torch.models import slicenet as tslice
from panodepth_torch.models import weights

from torch_port_common import flax_flat

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _inference():
    """The port's nets are trainable; these tests hold their inference
    forward (as e2e and serve run it) against JAX, so autograd is off."""
    with torch.no_grad():
        yield

F32_TOL = 1e-5
BF16_REL = 2.0 ** -6
MODES = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def _nchw(x):
    return torch.tensor(np.asarray(x, np.float32)).permute(0, 3, 1, 2)


def _close(got, want, mode):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = (F32_TOL if mode == "f32" else BF16_REL) * max(
        1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _carry(jmod, tmod, *inputs):
    """Init ``jmod`` on the numpy ``inputs``, carry its params into
    ``tmod``; returns the params."""
    params = jmod.init(jax.random.PRNGKey(sum(a.size for a in inputs) % 89),
                       *[jnp.asarray(a) for a in inputs])
    weights.load_params(tmod, flax_flat(params))
    return params


def _image_pair(jmod, tmod, mode, *inputs):
    """NHWC inputs through both; the port's NCHW output compared in NHWC."""
    params = _carry(jmod, tmod, *inputs)
    want = jax.jit(jmod.apply)(params, *[jnp.asarray(a) for a in inputs])
    got = tmod(*[_nchw(a) for a in inputs])
    _close(got.float().permute(0, 2, 3, 1).numpy(), want, mode)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cin,stride", [(16, 1), (8, 2), (3, 2)])
def test_resblock_matches_jax(mode, cin, stride):
    jd, td = MODES[mode]
    x = np.random.RandomState(cin).normal(0, 1, (2, 8, 16, cin)).astype(
        np.float32)
    _image_pair(jpersp.ResBlock(16, stride, dtype=jd),
                tpersp.ResBlock(cin, 16, stride, dtype=td), mode, x)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("with_skip", [True, False])
def test_fusion_block_matches_jax(mode, with_skip):
    jd, td = MODES[mode]
    rng = np.random.RandomState(4)
    x = rng.normal(0, 1, (1, 4, 8, 16)).astype(np.float32)
    skip = rng.normal(0, 1, (1, 8, 16, 8)).astype(np.float32)
    inputs = (x, skip) if with_skip else (x,)
    _image_pair(jpersp.FusionBlock(16, dtype=jd),
                tpersp.FusionBlock(16, 16, 8 if with_skip else None,
                                   dtype=td), mode, *inputs)


@pytest.mark.parametrize("mode", list(MODES))
def test_unifuse_blocks_and_segate_match_jax(mode):
    jd, td = MODES[mode]
    rng = np.random.RandomState(5)
    e = rng.normal(0, 1, (2, 4, 8, 32)).astype(np.float32)
    c = rng.normal(0, 1, (2, 4, 8, 32)).astype(np.float32)
    _image_pair(jpano.SEGate(32, dtype=jd), tpano.SEGate(32, dtype=td), mode,
                e)
    _image_pair(jpano.UniFuseBlock(32, dtype=jd),
                tpano.UniFuseBlock(32, dtype=td), mode, e, c)
    _image_pair(jpano.NFUniFuseBlock(32, dtype=jd),
                tpano.NFUniFuseBlock(32, dtype=td), mode, e, c)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("taps", ["bilinear", "nearest"])
def test_biproj_fusion_matches_jax(mode, taps):
    """Both directions at one level of a batch of two panoramas (the cube
    branch as 12 faces)."""
    jd, td = MODES[mode]
    rng = np.random.RandomState(6)
    e = rng.normal(0, 1, (2, 8, 16, 16)).astype(np.float32)
    c = rng.normal(0, 1, (12, 4, 4, 16)).astype(np.float32)
    jm = jbifuse.BiProjFusion(16, dtype=jd, taps=taps)
    tm = tbifuse.BiProjFusion(16, dtype=td, taps=taps)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(e), jnp.asarray(c),
                     2)
    weights.load_params(tm, flax_flat(params))
    we, wc = jax.jit(jm.apply, static_argnums=3)(params, jnp.asarray(e),
                                                 jnp.asarray(c), 2)
    ge, gc = tm(_nchw(e), _nchw(c))
    _close(ge.float().permute(0, 2, 3, 1).numpy(), we, mode)
    _close(gc.float().permute(0, 2, 3, 1).numpy(), wc, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_bifuse_decoder_matches_jax(mode):
    jd, td = MODES[mode]
    rng = np.random.RandomState(7)
    skips = [rng.normal(0, 1, (1, 16 >> i, 32 >> i, w)).astype(np.float32)
             for i, w in enumerate((8, 16, 32))]
    jm = jbifuse._Decoder(dtype=jd)
    tm = tbifuse._Decoder((8, 16, 32), dtype=td)
    params = jm.init(jax.random.PRNGKey(2), [jnp.asarray(s) for s in skips])
    weights.load_params(tm, flax_flat(params))
    want = jax.jit(jm.apply)(params, [jnp.asarray(s) for s in skips])
    got = tm([_nchw(s) for s in skips])
    _close(got.float().permute(0, 2, 3, 1).numpy(), want, mode)


def _seq_pair(jmod, tmod, mode, x):
    """(B, L, C) sequences through both."""
    params = _carry(jmod, tmod, x)
    want = jax.jit(jmod.apply)(params, jnp.asarray(x))
    _close(tmod(torch.tensor(x)).float().numpy(), want, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_layer_norm_matches_flax(mode):
    """flax's epsilon (1e-6), fast variance and affine, one cast; an input
    whose rows sit far from 0 and one near-constant row."""
    jd, td = MODES[mode]
    x = np.random.RandomState(8).normal(3.0, 0.5, (2, 5, 24)).astype(
        np.float32)
    x[0, 0] = 0.25
    _seq_pair(fnn.LayerNorm(dtype=jd), tlayers.LayerNorm(24, dtype=td), mode,
              x)


@pytest.mark.parametrize("mode", list(MODES))
def test_gelu_is_flax_tanh_form(mode):
    jd, td = MODES[mode]
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x, jd)), np.float32)
    got = tlayers.gelu(torch.tensor(x).to(td)).float().numpy()
    _close(got, want, mode)
    exact = torch.nn.functional.gelu(torch.tensor(x)).numpy()
    assert float(np.abs(exact - tlayers.gelu(torch.tensor(x)).numpy()
                        ).max()) > 1e-4  # not the erf form


@pytest.mark.parametrize("mode", list(MODES))
def test_attention_matches_flax(mode):
    """Self-attention over 12 tokens of 20 features (4 heads of 8): the
    query scaled before the product, the softmax in the compute type,
    the output projected back to 20 features."""
    jd, td = MODES[mode]
    x = np.random.RandomState(9).normal(0, 1, (2, 12, 20)).astype(np.float32)

    class Self(fnn.Module):
        @fnn.compact
        def __call__(self, y):
            return fnn.MultiHeadDotProductAttention(
                num_heads=4, qkv_features=32, dtype=jd)(y, y)

    class TSelf(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.MultiHeadDotProductAttention_0 = \
                tlayers.MultiHeadDotProductAttention(20, 4, 32, dtype=td)

        def forward(self, y):
            return self.MultiHeadDotProductAttention_0(y)

    tm = TSelf()
    params = _carry(Self(), tm, x)
    assert tm.MultiHeadDotProductAttention_0.query.kernel.shape == (4, 8, 20)
    assert tm.MultiHeadDotProductAttention_0.out.kernel.shape == (20, 4, 8)
    want = jax.jit(Self().apply)(params, jnp.asarray(x))
    _close(tm(torch.tensor(x)).float().numpy(), want, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_horizon_attention_matches_jax(mode):
    jd, td = MODES[mode]
    x = np.random.RandomState(10).normal(0, 1, (1, 16, 32)).astype(
        np.float32)
    _seq_pair(jhoho.HorizonAttention(32, dtype=jd),
              thoho.HorizonAttention(32, dtype=td), mode, x)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_cell_scan_matches_flax_rnn(mode, reverse):
    """``nn.RNN(GRUCell, reverse, keep_order=True)`` from the zero f32
    carry: the output stays f32, as the carry's type decides."""
    jd, td = MODES[mode]
    x = np.random.RandomState(11).normal(0, 1, (2, 9, 12)).astype(np.float32)

    class Rnn(fnn.Module):
        @fnn.compact
        def __call__(self, y):
            return fnn.RNN(fnn.GRUCell(16, dtype=jd), reverse=reverse,
                           keep_order=True)(y)

    class TRnn(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.GRUCell_0 = tlayers.GRUCell(12, 16, dtype=td)

        def forward(self, y):
            return self.GRUCell_0.scan(y, reverse=reverse)

    tm = TRnn()
    params = _carry(Rnn(), tm, x)
    assert tm.GRUCell_0.hr.bias is None and tm.GRUCell_0.hn.bias is not None
    want = jax.jit(Rnn().apply)(params, jnp.asarray(x))
    got = tm(torch.tensor(x))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    _close(got.numpy(), want, mode)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("length", [32, 5])
def test_circular_bigru_matches_jax(mode, length):
    """The wrap of 8 columns each side, or the whole sequence when it is
    shorter."""
    jd, td = MODES[mode]
    x = np.random.RandomState(12).normal(0, 1, (1, length, 16)).astype(
        np.float32)
    _seq_pair(jslice.CircularBiGRU(16, dtype=jd),
              tslice.CircularBiGRU(16, dtype=td), mode, x)


@pytest.mark.parametrize("net", ["panoramic", "bifuse", "hohonet",
                                 "slicenet", "perspective"])
def test_nets_refuse_inputs_they_cannot_run(net):
    if net == "perspective":
        # the int8 graph (ported since) is made from a float GN net only
        from panodepth_torch.models import quantize as tquant

        twin = tpersp.PerspectiveDepthNet(quantized=True)
        for other in (tpersp.NFPerspectiveNet(), twin):
            with pytest.raises(ValueError, match="float GN"):
                tquant.quantize_perspective(other)
        return
    tm = weights.build_model({"model": net, "pano_width": 64})
    with pytest.raises(ValueError, match="W % 32 == 0"):
        tm(torch.zeros(1, 16, 48, 3))
    if net in ("hohonet", "slicenet"):
        # the column decoder was built for the checkpoint's height
        with pytest.raises(ValueError, match="built for H = 32"):
            tm(torch.zeros(1, 64, 128, 3))
