"""The port's metrics against the JAX package and the ErrorEmap oracle,
and its Metrics file and console formats byte for byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import metrics as jmetrics

from panodepth_torch import metrics as tmetrics

from reference_impl import ref_error_emap

torch.set_num_threads(1)  # xdist runs several workers on a few cores

KEYS = ("mse", "mae", "mre", "mselog", "delta1", "delta2", "delta3")


def _scene():
    """tests/test_metrics.py's scene: noisy scaled gt with invalid pixels."""
    rng = np.random.RandomState(7)
    gt = rng.uniform(0.05, 0.9, (32, 64)).astype(np.float32)
    gt[rng.rand(32, 64) < 0.05] = 0.0
    given = np.clip(gt * 0.8 + 0.05 + rng.normal(0, 0.02, gt.shape), 0, 1)
    return gt, given.astype(np.float32)


@pytest.mark.parametrize("align_way", [0, 1, 2])
@pytest.mark.parametrize("cap_depth", [True, False])
def test_error_metrics_match_jax_and_oracle(align_way, cap_depth):
    gt, given = _scene()
    t = tmetrics.error_metrics(torch.tensor(gt), torch.tensor(given),
                               align_way=align_way, cap_depth=cap_depth)
    j = jmetrics.error_metrics(jnp.asarray(gt), jnp.asarray(given),
                               align_way=align_way, cap_depth=cap_depth)
    ref = ref_error_emap(gt, given, align_way=align_way, cap_depth=cap_depth)
    # f32 sums in another order than XLA's: 1e-5 relative to JAX, except
    # after the closed-form fit of align_way=2, whose determinant cancels
    # (a00*a11 - a01^2) and amplifies JAX's f32 rounding (the port sums in
    # f64, as the oracle does); there, and for the oracle, the bar of
    # tests/test_metrics.py: 2e-4
    rtol = 2e-4 if align_way == 2 else 1e-5
    for k in KEYS:
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=rtol,
                                   err_msg=k)
        np.testing.assert_allclose(float(t[k]), ref[k], rtol=2e-4, err_msg=k)
    if align_way == 1:
        np.testing.assert_allclose(float(t["median_shift_factor"]),
                                   float(j["median_shift_factor"]), rtol=1e-6)
    if align_way == 2:
        np.testing.assert_allclose(t["least_square"].numpy(),
                                   np.asarray(j["least_square"]), rtol=rtol)


def test_error_metrics_gt_at_another_resolution():
    gt, given = _scene()
    gt_big = np.kron(gt, np.ones((2, 2), np.float32))
    t = tmetrics.error_metrics(torch.tensor(gt_big), torch.tensor(given))
    j = jmetrics.error_metrics(jnp.asarray(gt_big), jnp.asarray(given))
    for k in KEYS:
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-5)


def test_paired_metrics_save_and_print_formats(tmp_path, capsys):
    gt, given = _scene()
    result = np.clip(gt * 0.95 + 0.01, 0, 1)
    t = tmetrics.paired_metrics(torch.tensor(gt), torch.tensor(given),
                                torch.tensor(result))
    j = jmetrics.paired_metrics(jnp.asarray(gt), jnp.asarray(given),
                                jnp.asarray(result))
    for name in tmetrics.Metrics._PAIRS:
        for side in ("given", "result"):
            np.testing.assert_allclose(getattr(t, f"{name}_{side}"),
                                       getattr(j, f"{name}_{side}"),
                                       rtol=1e-5)
    # the same numbers give the same bytes in both formats
    same = tmetrics.Metrics(**{f.name: getattr(j, f.name)
                               for f in jmetrics.dataclasses.fields(j)})
    same.save(str(tmp_path / "t.txt"))
    j.save(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert same.print() == j.print()
    zero = tmetrics.Metrics()  # the delta3 diff line gates on delta1_given
    zero.save(str(tmp_path / "z.txt"))
    jmetrics.Metrics().save(str(tmp_path / "zj.txt"))
    assert (tmp_path / "z.txt").read_bytes() == (tmp_path / "zj.txt").read_bytes()
