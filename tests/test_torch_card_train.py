"""Training on files and the corruption on the card (``cuda``-marked; they
skip without a card).  The file imports no JAX, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_card_train.py -m cuda

* ``ops/corrupt.apply`` and ``eval_corruption`` on the card against the
  CPU on the same draws, within the bar of tests/test_torch_corrupt.py
  (0.5 % of the pixels, mean 1e-3: the card's ``pow`` may differ from the
  CPU's in an ulp, which JPEG rounding turns into a level at a tie);
* a host file batch's RGB lands on the card, corrupted there, and the
  train CLI runs on files there.
"""

import os

import numpy as np
import pytest
import torch

from panodepth_torch import train_cli
from panodepth_torch.ops import corrupt as T

pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    not torch.cuda.is_available(), reason="needs a CUDA card")]

SHARE, MEAN = 5e-3, 1e-3


def _within_bar(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (d > 0).mean() <= SHARE, (d > 0).mean()
    assert d.mean() <= MEAN, d.mean()


def _batch(n=4, h=64, w=96, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    g = 0.5 + 0.3 * np.sin(xx / 6.0)[None] * np.cos(yy / 9.0)[None]
    g = g + 0.1 * rng.rand(n, h, w)
    return torch.from_numpy(np.clip(np.stack([g, 0.8 * g, 1 - 0.7 * g], -1),
                                    0, 1).astype(np.float32))


def test_corruption_on_the_card_against_the_cpu():
    x = _batch()
    draws = T.draw(x.shape, torch.Generator().manual_seed(11))
    _within_bar(T.apply(x.cuda(), draws).cpu().numpy(),
                T.apply(x, draws).numpy())
    noise = T.eval_noise(x.shape, 0)
    _within_bar(T.eval_corruption(x.cuda(), noise=noise).cpu().numpy(),
                T.eval_corruption(x, noise=noise).numpy())
    # the card's own draws: on the card, deterministic in the generator
    a = T.corrupt(x.cuda(), T.batch_generator(3, 0, "cuda"))
    b = T.corrupt(x.cuda(), T.batch_generator(3, 0, "cuda"))
    assert a.device.type == "cuda" and torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        T.corrupt(x.cuda(), torch.Generator())


def test_host_batches_land_on_the_card():
    host = [(_batch(2).numpy(), np.full((2, 64, 96), 0.5, np.float32),
             np.ones((2, 64, 96), bool))]
    rgb, depth, valid = next(T.corrupt_batches(iter(host), 0, device="cuda"))
    assert rgb.device.type == "cuda" and isinstance(depth, np.ndarray)
    dev = torch.device("cuda")
    moved = train_cli.to_device((rgb, depth, valid), dev)
    assert all(t.device.type == "cuda" for t in moved)
    assert torch.equal(moved[1].cpu(), torch.from_numpy(depth))


def test_train_cli_on_files_on_the_card(tmp_path):
    from panodepth_torch import synth

    synth.write_dataset(str(tmp_path / "ds"), 4, width=64, version="mix",
                        device="cuda", log=lambda *a: None)
    assert train_cli.main([
        "fastpano", str(tmp_path / "ds" / "rgb"), str(tmp_path / "ds" / "gt"),
        str(tmp_path / "ck"), "--width-scale", "0.125", "--batch-size", "2",
        "--pano-width", "64", "--steps", "2", "--augment", "--corrupt",
        "--log-every", "1"]) == 0
    assert os.path.exists(tmp_path / "ck" / "fastpano_final.params.npz")
