"""The int8 perspective graph of the port (``models/quantize.py``,
``layers.QConv``, ``kernels/qconv.py``'s plain twin on the CPU) against the
JAX package's (``panodepth/models/quantize.py``, ``QConv``,
``load_model_checkpoint(quantize=True)``).

The first five tests mirror ``tests/test_quantize.py`` on the port; the
rest hold the port against JAX on the same inputs:

* the weight codes and scales: bit-equal (the same numpy f32 ops);
* JAX's quantized tree carried across (``weights.load_params``) and the
  port's own quantization of the same float net: the same port net, bit
  for bit;
* one QConv: the activation codes ``round(x / sx)`` (a true division in
  both packages) and the int32 sums are bit-equal, and so is the bf16
  output; the share of codes that differ is measured (0 on these inputs)
  and held under 1e-4;
* the small int8 net: within ``NET_BAR`` of the output's largest value
  (measured 4.05e-2): the bf16 GroupNorms take their statistics from f64
  sums in the port and f32 sums in flax, the bf16 roundings differ, and a
  code that lands on the other side of a rounding tie moves a whole
  quantization step, which the next layers carry;
* the int8 e2e graph at a small layout: ``INT8_E2E_BAR`` on the u16
  output, set from the measured max 104, mean 19.0 with margin, under the
  bf16 e2e bar of ROADMAP Queue 3 (2048 / 64); the bf16 graph of the same
  checkpoint is 338 / 31.4 from JAX's int8 graph, and the test asserts
  that it falls outside the bar, so the bar tells int8 from float.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import e2e as je
from panodepth.config import MergeConfig as JaxMergeConfig
from panodepth.config import ViewLayout, register_layout
from panodepth.models import perspective as jpersp
from panodepth.models import quantize as jquant

import panodepth_torch.config as tconfig
from panodepth_torch import e2e as te
from panodepth_torch.kernels import qconv as kq
from panodepth_torch.models import layers as tlayers
from panodepth_torch.models import perspective as tpersp
from panodepth_torch.models import quantize as tquant
from panodepth_torch.models import weights

from test_torch_e2e import _scene, _u16_diff
from torch_port_common import flax_flat

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "zoo")
GN_PERSP = os.path.join(ZOO, "gn", "perspective_final.params.npz")
# the int8 e2e graph against JAX's: u16 max, mean (measured 104 / 19.0;
# the bf16 graph 338 / 31.4)
INT8_E2E_BAR = (256, 24.0)
FASTPANO = os.path.join(ZOO, "fastpano_final.params.npz")
SMALL = dict(stage_sizes=(1, 1), widths=(16, 32), decoder_width=16)
# the small int8 net against JAX's, relative to the output's largest value
NET_BAR = 0.08


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def small_net():
    """The JAX small net and its params, and the port's float twin."""
    jm = jpersp.PerspectiveDepthNet(**SMALL)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tm = tpersp.PerspectiveDepthNet(**SMALL)
    weights.load_params(tm, flax_flat(params))
    return jm, params, tm


def _jax_tree(params):
    """{flax path string: numpy leaf} of a (quantized) JAX tree."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def test_converted_tree_matches_quantized_init(small_net):
    """The port's twin has the parameters of JAX's quantized init, by
    name, shape and type (int8 codes), and the float net's quantization
    fills every one."""
    jm, _, tm = small_net
    ref = _jax_tree(jm.clone(quantized=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    tq = tquant.quantize_perspective(tm)
    got = {weights.flax_key(n): p for n, p in tq.named_parameters()}
    assert got.keys() == ref.keys()
    for key, a in ref.items():
        layout = weights.to_port_layout(weights.port_name(key), a)
        assert tuple(got[key].shape) == layout.shape, key
        assert (got[key].dtype == torch.int8) == (a.dtype == np.int8), key
    # the stem, two stages of one transition block (3), the decoder's
    # input conv, a FusionBlock with a skip (4) and one without (3), and
    # the two decoder convs
    assert len(tquant.qconvs(tq)) == 1 + 2 * 3 + 1 + 4 + 3 + 2
    assert not any(p.requires_grad for p in tq.parameters())
    assert tq.head is tq.Conv_0 and tq.head.kernel.dtype == torch.float32


def test_kernel_roundtrip_error_bound_and_codes_equal_jax():
    rng = np.random.RandomState(0)
    k = rng.randn(3, 3, 8, 16).astype(np.float32)
    q, s = tquant.quantize_conv_kernel(k)
    assert q.dtype == np.int8 and s.shape == (16,)
    back = q.astype(np.float32) * s
    assert np.max(np.abs(back - k)) <= np.max(s) / 2 + 1e-7
    assert np.all(np.max(np.abs(q), axis=(0, 1, 2)) == 127)
    jq, js = jquant.quantize_conv_kernel(k)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.uint32), js.view(np.uint32))


def test_int8_forward_close_to_f32(small_net):
    _, _, tm = small_net
    tq = tquant.quantize_perspective(tm)
    x = torch.tensor(np.random.RandomState(1).rand(2, 64, 64, 3).astype(
        np.float32))
    y, yq = tm(x).float(), tq(x).float()
    assert y.shape == yq.shape
    rel = float(torch.sqrt(torch.mean((y - yq) ** 2))
                / (torch.sqrt(torch.mean(y ** 2)) + 1e-9))
    assert rel < 0.12, rel


def test_qconv_zero_input_exact():
    """Symmetric codes have no zero point: conv(0) is exactly the bias."""
    conv = tlayers.QConv(2, 4, (3, 3), use_bias=True)
    with torch.no_grad():
        conv.kernel_q.fill_(1)
        conv.scale.fill_(2.0)
        conv.bias.fill_(1.0)
    y = conv(torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 4, 8, 8)
    np.testing.assert_array_equal(y.float().numpy(), 1.0)


def test_load_checkpoint_quantize_plumbing(tmp_path):
    """load_model_checkpoint(quantize=True) builds the twin at the
    sidecar's widths; an NF perspective or a panoramic checkpoint is
    refused with JAX's message."""
    from panodepth.models import train as jtrain

    model = jpersp.PerspectiveDepthNet(widths=(8, 16, 32, 64),
                                       decoder_width=16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    ck = tmp_path / "perspective_final.params.npz"
    jtrain.save_params_npz(str(ck), params)
    side = tmp_path / "perspective.config.json"
    side.write_text(json.dumps({"model": "perspective", "view_size": 64,
                                "width_scale": 0.125}))
    tq, arch = te.load_model_checkpoint(str(ck), device="cpu", quantize=True)
    assert tq.quantized and arch["view_size"] == 64
    assert tq(torch.zeros(1, 64, 64, 3)).shape == (1, 64, 64)
    # the same tree quantized by JAX loads onto the port's twin bit for bit
    jq, jqp, _ = je.load_model_checkpoint(str(ck), quantize=True)
    twin = tpersp.PerspectiveDepthNet(widths=(8, 16, 32, 64),
                                      decoder_width=16, quantized=True)
    weights.load_params(twin, _jax_tree(jqp))
    for (n, a), (_, b) in zip(tq.named_parameters(), twin.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    for variant, kind in (("nf", "perspective"), ("gn", "panoramic")):
        side.write_text(json.dumps({"model": kind, "view_size": 64,
                                    "variant": variant}))
        with pytest.raises(ValueError, match="GN perspective") as got:
            te.load_model_checkpoint(str(ck), device="cpu", quantize=True)
        with pytest.raises(ValueError, match="GN perspective") as want:
            je.load_model_checkpoint(str(ck), quantize=True)
        assert str(got.value) == str(want.value)


def test_jax_quantized_tree_gives_the_ports_own_twin(small_net):
    jm, params, tm = small_net
    mine = tquant.quantize_perspective(tm)
    carried = tpersp.PerspectiveDepthNet(**SMALL, quantized=True)
    weights.load_params(carried,
                        _jax_tree(jquant.quantize_perspective_params(params)))
    a, b = dict(mine.named_parameters()), dict(carried.named_parameters())
    assert a.keys() == b.keys()
    for n in a:
        assert a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]), n
    assert tquant.int8_param_bytes(mine) == sum(
        x.nbytes for x in jax.tree_util.tree_leaves(
            jquant.quantize_perspective_params(params)))


def _jax_codes(x_nhwc):
    """JAX's QConv activation codes and scales (perspective.py:62-67)."""
    xf = x_nhwc.astype(jnp.float32)
    sx = jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True)
    sx = jnp.maximum(sx, 1e-8) / 127.0
    return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx


@pytest.mark.parametrize("cin,cout,kernel,stride,bias", [
    (3, 16, 7, 2, False), (16, 32, 3, 2, False), (16, 32, 1, 2, False),
    (32, 16, 3, 1, True)])
def test_qconv_matches_jax(cin, cout, kernel, stride, bias):
    """One QConv on the same bf16 input and codes: the activation codes,
    the int32 sums and the bf16 output against JAX's."""
    rng = np.random.RandomState(cin * 7 + kernel)
    x = (rng.normal(0, 1, (2, 16, 16, cin)) * rng.uniform(0.5, 4, cin)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jconv = jpersp.QConv(cout, (kernel, kernel), (stride, stride),
                         use_bias=bias)
    p = jconv.init(jax.random.PRNGKey(1), xj)
    w = rng.normal(0, 0.2, (kernel, kernel, cin, cout)).astype(np.float32)
    q, s = jquant.quantize_conv_kernel(w)
    p = {"params": dict(p["params"], kernel_q=jnp.asarray(q),
                        scale=jnp.asarray(s))}
    if bias:
        p["params"]["bias"] = jnp.asarray(rng.normal(0, 0.5, cout).astype(
            np.float32))
    want = np.asarray(jconv.apply(p, xj).astype(jnp.float32))
    conv = tlayers.QConv(cin, cout, (kernel, kernel), (stride, stride),
                         use_bias=bias)
    weights.load_params(conv, _jax_tree(p))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(torch.bfloat16)
    got = conv(xt).float().permute(0, 2, 3, 1).numpy()
    # the codes, then the sums on them
    jx, jsx = _jax_codes(xj)
    tx, tsx = kq.quantize_activation(xt)
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx).ravel())
    flips = float(np.mean(np.asarray(jx) != tx.permute(0, 2, 3, 1).numpy()))
    assert flips < 1e-4, flips
    pads = [tlayers.same_pads(16, kernel, stride)] * 2
    jsum = jax.lax.conv_general_dilated(
        jx, jnp.asarray(q), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    tsum = kq.qconv_sums_plain(kq.to_nhwc(tx), conv.weight(),
                               (kernel, kernel), (stride, stride), pads)
    np.testing.assert_array_equal(tsum.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jsum))
    if flips == 0:
        np.testing.assert_array_equal(got, want)


def test_small_int8_net_matches_jax(small_net):
    jm, params, tm = small_net
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jm.clone(quantized=True).apply(
        jquant.quantize_perspective_params(params), jnp.asarray(x)),
        np.float32)
    got = tquant.quantize_perspective(tm)(torch.tensor(x)).float().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"small int8 net vs JAX: max abs / max {err}")
    assert got.shape == want.shape and err < NET_BAR, err


D2R = math.pi / 180.0
FOVS = np.array([(25 * D2R, 175 * D2R, 30 * D2R, 150 * D2R),
                 (185 * D2R, 355 * D2R, 30 * D2R, 150 * D2R)])
RANGES = np.array([(170 * D2R, 30 * D2R, 40 * D2R, 140 * D2R),
                   (350 * D2R, 190 * D2R, 40 * D2R, 140 * D2R)])
register_layout(ViewLayout("torch_int8", fovs=FOVS, ranges=RANGES))
tconfig.layout_from_arrays("torch_int8", FOVS, RANGES)


def test_int8_e2e_graph_matches_jax():
    """The zoo GN perspective net's int8 graph beside FastPanoNet, two
    views 64 wide, out width 64: the u16 output within ``INT8_E2E_BAR`` of
    JAX's int8 graph, and the bf16 graph of the same checkpoint outside
    it; each panorama at batch 1 as at batch 2."""
    jcfg = JaxMergeConfig(layout_name="torch_int8", out_width=64)
    tcfg = tconfig.MergeConfig(layout_name="torch_int8", out_width=64)
    rng = np.random.RandomState(3)
    rgbs = np.stack([_scene(0, rng), _scene(1, rng)])
    jp, jpp, _ = je.load_model_checkpoint(GN_PERSP, quantize=True)
    jb, jbp, _ = je.load_model_checkpoint(FASTPANO)
    tp, _ = te.load_model_checkpoint(GN_PERSP, device="cpu", quantize=True)
    tb, _ = te.load_model_checkpoint(FASTPANO, device="cpu")
    assert len(tquant.qconvs(tp)) == 39
    _, j_models, j_fuse = je.build_batched_e2e(
        jp, jpp, jcfg, view_width=64, base_model=jb, base_params=jbp,
        base_w=128)
    t_full, _, _ = te.build_batched_e2e(tp, tcfg, view_width=64,
                                        base_model=tb, base_w=128,
                                        device="cpu")
    kq.LAUNCHES = 0
    t_out, _ = t_full(torch.tensor(rgbs))
    assert kq.LAUNCHES == 0  # the CPU runs no kernel
    j_out, _ = j_fuse(*j_models(jnp.asarray(rgbs)))
    dmax, dmean = _u16_diff(t_out.numpy(), j_out)
    print(f"int8 e2e vs JAX: u16 max {dmax}, mean {dmean}")
    assert dmax <= INT8_E2E_BAR[0] and dmean < INT8_E2E_BAR[1], (dmax, dmean)
    single, _ = t_full(torch.tensor(rgbs[1:]))
    assert _u16_diff(single[0], t_out[1])[0] <= 1
    tf, _ = te.load_model_checkpoint(GN_PERSP, device="cpu")
    f_full, _, _ = te.build_batched_e2e(tf, tcfg, view_width=64,
                                        base_model=tb, base_w=128,
                                        device="cpu")
    fmax, fmean = _u16_diff(f_full(torch.tensor(rgbs))[0].numpy(), j_out)
    print(f"bf16 e2e vs JAX's int8: u16 max {fmax}, mean {fmean}")
    assert fmax > INT8_E2E_BAR[0] or fmean >= INT8_E2E_BAR[1], (fmax, fmean)
