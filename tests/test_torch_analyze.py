"""The port's analysis surface against the JAX package's, on the same
files and arrays: the ``analyze`` CLI (``tests/test_cli_tools.py``'s three
cases), ``metrics.median_scaling``, ``error_compare`` and
``error_laplacian`` (``tests/test_metrics.py``'s cases, with the
``reference_impl`` oracle where those use it) and ``ops/maps.py``
(``tests/test_ops.py``'s cases).

Bars: 1e-5 relative where both packages sum in f32 (another order), and
the f64 gradient metrics 1e-9.  The least-squares fit (``--align 2`` and
the mono360 chain's disparity fit) cancels in its determinant: the port
takes its sums in f64, as the reference does, and JAX in f32, so there the
port is held to a float64 numpy solve (1e-6) and to JAX within JAX's own
error, measured at up to 2.6e-4 (the offset, ``--align 2``) and 2.4e-3 (the
mono360 chain's MSE, the fit's error carried through the reciprocal):
bars 1e-3 and 5e-3 relative.  Where the chain inverts an exact reciprocal
the errors left are f32 roundings (an RMSE of ~5e-6 of depths 0.15-0.9),
which no relative bar holds: there the bar is also 1e-6 absolute.
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import analyze as janalyze
from panodepth import io as jio
from panodepth import metrics as jmetrics
from panodepth.ops import maps as jmaps

from panodepth_torch import analyze as tanalyze
from panodepth_torch import metrics as tmetrics
from panodepth_torch.ops import maps as tmaps

from reference_impl import ref_error_laplacian

torch.set_num_threads(1)


@pytest.fixture
def depth_pair(tmp_path):
    """tests/test_cli_tools.py's gt and a scaled, noisy prediction."""
    rng = np.random.RandomState(7)
    y, x = np.mgrid[0:64, 0:128]
    gt = (0.2 + 0.1 * np.sin(x / 17.0) * np.cos(y / 9.0)).astype(np.float32)
    pred = np.clip(gt * 1.07 + 0.01 * rng.rand(64, 128), 0, 1).astype(
        np.float32)
    gt_f, pred_f = str(tmp_path / "gt.png"), str(tmp_path / "pred.png")
    jio.save_png16(gt_f, (gt * 65535 + 0.5).astype(np.uint16))
    jio.save_png16(pred_f, (pred * 65535 + 0.5).astype(np.uint16))
    return gt_f, pred_f


def _record(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _both(argv):
    return (_record(tanalyze, argv + ["--device", "cpu"]),
            _record(janalyze, argv + ["--platform", "cpu"]))


def _close(got, want, rtol, loose=(), loose_rtol=None, atol=1e-12):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], err_msg=k, atol=atol,
            rtol=loose_rtol if k in loose else rtol)


@pytest.mark.parametrize("align", ["0", "1", "2"])
def test_analyze_cli_json(depth_pair, align):
    gt_f, pred_f = depth_pair
    got, want = _both([gt_f, pred_f, "--json", "--laplacian", "--align",
                       align])
    _close(got, want, 1e-5, loose=("least_square_o", "least_square_s"),
           loose_rtol=1e-3)
    for key in ("rmse", "mae", "mre", "rmselog", "delta1"):
        assert key in got
    if align == "1":
        # median alignment absorbs the 1.07 scale; the noise term remains
        assert 0 < got["rmse"] < 0.02 and got["delta1"] > 0.9
    assert any(k.startswith("laplacian") for k in got)


def test_analyze_cli_self_comparison_is_exact(depth_pair):
    gt_f, _ = depth_pair
    got, want = _both([gt_f, gt_f, "--json", "--align", "0"])
    assert got == want
    assert got["rmse"] == 0.0 and got["delta1"] == 1.0


def test_analyze_cli_mono360(tmp_path):
    """--mono360: the disparity through ErrorCompare (disp -> depth, the
    least-squares fit, the 10 m cap, the shifted 8-bit dump)."""
    y, x = np.mgrid[0:64, 0:128]
    gt = (0.15 + 0.05 * np.sin(x / 11.0) + 0.001 * y).astype(np.float32)
    disp = 1.0 / np.maximum(gt, 1e-3)
    disp = disp / disp.max()
    gt_f, disp_f = str(tmp_path / "gt.png"), str(tmp_path / "disp.png")
    jio.save_png16(gt_f, (gt * 65535 + 0.5).astype(np.uint16))
    jio.save_png16(disp_f, (disp * 65535 + 0.5).astype(np.uint16))
    shifted = {k: str(tmp_path / f"shifted_{k}.png") for k in ("t", "j")}
    got = _record(tanalyze, [gt_f, disp_f, "--mono360", "--json",
                             "--shifted-out", shifted["t"], "--device",
                             "cpu"])
    want = _record(janalyze, [gt_f, disp_f, "--mono360", "--json",
                              "--shifted-out", shifted["j"], "--platform",
                              "cpu"])
    _close(got, want, 5e-3, atol=1e-6)
    assert got["rmse"] < 0.05 and got["delta1"] > 0.8, got
    a = jio.load_image01(shifted["t"])
    b = jio.load_image01(shifted["j"])
    assert a.shape == b.shape and np.abs(a - b).max() <= 2 / 255


def _lsq64(gt, given):
    """The closed-form fit of align_way=2 in float64 numpy, on the pixels
    error_metrics uses (the whole map here: no cap, full zenith band)."""
    g = np.asarray(gt, np.float64).ravel()
    v = np.asarray(given, np.float64).ravel()
    m = g >= 1e-4
    g, v = g[m], v[m]
    a00, a01, a11 = (v * v).sum(), v.sum(), float(m.sum())
    b0, b1 = (g * v).sum(), g.sum()
    det = a00 * a11 - a01 * a01
    return (a11 * b0 - a01 * b1) / det, (-a01 * b0 + a00 * b1) / det


def test_least_squares_fit_is_float64():
    rng = np.random.RandomState(5)
    gt = rng.uniform(0.05, 0.6, (32, 64)).astype(np.float32)
    given = (gt * 0.93 + 0.01 + rng.normal(0, 0.01, gt.shape)).astype(
        np.float32)
    res = tmetrics.error_metrics(torch.tensor(gt), torch.tensor(given),
                                 align_way=2, cap_depth=False,
                                 zenith_range=(0.0, np.pi))
    np.testing.assert_allclose(res["least_square"].numpy(),
                               _lsq64(gt, given), rtol=1e-6)


def test_median_scaling_matches_jax_and_reference_semantics():
    rng = np.random.RandomState(9)
    e0 = rng.uniform(0.1, 0.8, (16, 16)).astype(np.float32)
    e1 = (e0 * 2.0).clip(0, 0.95).astype(np.float32)
    scaled, m0, m1 = tmetrics.median_scaling(torch.tensor(e0),
                                             torch.tensor(e1))
    js, jm0, jm1 = jmetrics.median_scaling(jnp.asarray(e0), jnp.asarray(e1))
    v0 = sorted(v for v in e0.flatten() if 1e-4 <= v < 1 - 1e-4)
    v1 = sorted(v for v in e1.flatten() if 1e-4 <= v < 1 - 1e-4)
    assert float(m0) == v0[len(v0) // 2] == float(jm0)
    assert float(m1) == v1[len(v1) // 2] == float(jm1)
    np.testing.assert_array_equal(scaled.numpy(), np.asarray(js))
    # a 3-channel map: channel 0 scaled, the others kept
    e3 = np.stack([e0, e0 * 0.5, e0 * 0.25], -1)
    s3, _, _ = tmetrics.median_scaling(torch.tensor(e3), torch.tensor(e1))
    j3, _, _ = jmetrics.median_scaling(jnp.asarray(e3), jnp.asarray(e1))
    np.testing.assert_array_equal(s3.numpy(), np.asarray(j3))


@pytest.mark.parametrize("seed,gt_shape,base_shape,holes", [
    (11, (32, 64), (32, 64), True), (12, (64, 128), (32, 64), False)])
def test_error_laplacian_matches_jax_and_oracle(seed, gt_shape, base_shape,
                                                holes):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0.05, 0.9, gt_shape).astype(np.float32)
    if holes:
        gt[rng.rand(*gt_shape) < 0.08] = 0.0
        base = np.clip(gt * 0.9 + rng.normal(0, 0.02, gt.shape), 0, 1)
    else:
        base = rng.uniform(0.05, 0.9, base_shape)
    base = base.astype(np.float32)
    got = tmetrics.error_laplacian(torch.tensor(gt), torch.tensor(base))
    want = jmetrics.error_laplacian(gt, base)
    slow = ref_error_laplacian(gt, base)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-9,
                                   err_msg=k)
        np.testing.assert_allclose(float(got[k]), slow[k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("disp", [True, False])
def test_error_compare_matches_jax(tmp_path, disp):
    """tests/test_metrics.py's mono360 PFM case, and the plain ErrorEmap
    form."""
    rng = np.random.RandomState(13)
    depth = rng.uniform(0.2, 0.9, (32, 64)).astype(np.float32)
    disparity = 1.0 / depth
    gt_f, base_f = str(tmp_path / "gt.png"), str(tmp_path / "base.pfm")
    jio.save_png16(gt_f, jio.to_uint16(depth))
    jio.save_pfm(base_f, disparity[::-1])
    out = {k: str(tmp_path / f"shifted_{k}.png") for k in ("t", "j")}
    got = tmetrics.error_compare(gt_f, base_f, disp_depth_compare=disp,
                                 shifted_filename=out["t"], device="cpu")
    want = jmetrics.error_compare(gt_f, base_f, disp_depth_compare=disp,
                                  shifted_filename=out["j"])
    for k in ("mse", "mae", "mre", "mselog", "delta1", "delta2", "delta3"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=5e-3 if disp else 1e-5,
                                   atol=1e-6 if disp else 0, err_msg=k)
    if disp:
        assert float(got["mse"]) < 1e-3 and float(got["delta1"]) > 0.95
    assert os.path.exists(out["t"])
    a, b = (jio.load_image01(out[k]) for k in ("t", "j"))
    assert np.abs(a - b).max() <= 2 / 255


def test_maps_match_jax():
    v = np.array([[0.0, 0.5, 2.0, 1e-6]], np.float32)
    out = tmaps.disp_depth_conversion(torch.tensor(v))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jmaps.disp_depth_conversion(jnp.asarray(v))))
    np.testing.assert_allclose(out.numpy(), [[0.0, 2.0, 0.5, 1e-6]],
                               rtol=1e-6)
    np.testing.assert_allclose(tmaps.disp_depth_conversion(out).numpy(), v,
                               rtol=1e-5)

    img = np.full((4, 8), 0.5, np.float32)
    ref = np.full((2, 4), 0.3, np.float32)
    ref[0, 0], ref[1, 1] = 0.0, 1.0
    got = tmaps.copy_invalid_pixels(torch.tensor(img), torch.tensor(ref))
    want = jmaps.copy_invalid_pixels(jnp.asarray(img), jnp.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0] == 0.0 and got[3, 3] == 1.0 and got[0, 4] == 0.5

    v = np.array([[0.0, 0.2, 0.4]], np.float32)
    np.testing.assert_allclose(float(tmaps.avg_valid(torch.tensor(v))),
                               float(jmaps.avg_valid(jnp.asarray(v))),
                               rtol=1e-6)
    assert float(tmaps.avg_valid(torch.zeros(2, 2))) == 0.0

    v = np.array([[0.0, 0.2, 0.6, 1.0]], np.float32)
    got = tmaps.minmax_normalize_valid(torch.tensor(v)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmaps.minmax_normalize_valid(jnp.asarray(v))))
    np.testing.assert_allclose(got, [[0.0, 0.0, 0.5, 1.0]], atol=1e-6)

    d = np.array([0.001, 0.005, 0.5, 1.0], np.float32)
    np.testing.assert_array_equal(
        tmaps.disparity_to_depth(torch.tensor(d)).numpy(),
        np.asarray(jmaps.disparity_to_depth(jnp.asarray(d))))

    # (H, W, C) maps: channel 0 written, the others kept
    m3 = np.random.RandomState(2).uniform(0.1, 2.0, (4, 8, 3)).astype(
        np.float32)
    for tf, jf in ((tmaps.disp_depth_conversion, jmaps.disp_depth_conversion),
                   (tmaps.minmax_normalize_valid,
                    jmaps.minmax_normalize_valid)):
        np.testing.assert_allclose(tf(torch.tensor(m3)).numpy(),
                                   np.asarray(jf(jnp.asarray(m3))), rtol=1e-6)
