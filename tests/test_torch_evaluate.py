"""``panodepth_torch.models.evaluate`` against ``panodepth.models.evaluate``
on a small checkpoint written by the JAX package's ``save_params_npz``:
two held-out scenes (seed 77 000), the same metrics within rel 3e-3, and
the refused options.  The bar is looser than 1e-3 because both run the
bf16 net of ``load_model_checkpoint``, whose outputs differ by up to 2^-6
of their scale (tests/test_torch_train_cli.py): measured 1.1e-3 on the v2
scenes' RMSE (the renders agree within 2e-5, tests/test_torch_synth.py).
"""

import json

import numpy as np
import pytest
import torch

from panodepth.models import evaluate as jeval
from panodepth.models import train as jtrain

from panodepth_torch.models import evaluate as teval
from panodepth_torch.models import layers, weights

from torch_train_common import nest

torch.set_num_threads(1)

METRICS = ("rmse", "mae", "mre", "delta1", "rmse_const")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    arch = dict(model="fastpano", width_scale=0.125, view_size=256,
                pano_width=64, eval_holdout=False, variant="gn")
    net = weights.build_model(arch)
    layers.init_params(net, torch.Generator().manual_seed(8))
    with torch.no_grad():  # a head that predicts a depth-like field
        net.Conv_0.bias.fill_(-1.5)
    flat = {weights.flax_key(k): weights.to_flax_layout(
        k, v.detach().numpy().copy()) for k, v in net.named_parameters()}
    path = str(root / "fastpano_final.params.npz")
    jtrain.save_params_npz(path, nest(flat))
    with open(root / "fastpano.config.json", "w") as fp:
        json.dump(arch, fp)
    return path


@pytest.mark.parametrize("scenes", ["v1", "v2"])
def test_evaluate_matches_jax(ckpt, scenes):
    want = jeval.evaluate(ckpt, count=2, scene_version=scenes)
    got = teval.evaluate(ckpt, count=2, scene_version=scenes, device="cpu")
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=3e-3)
    for k in ("model", "count", "align_way", "scenes", "corrupt", "int8"):
        assert got[k] == want[k]


def test_cli_prints_one_json_line(ckpt, capsys):
    assert teval.main([ckpt, "--count", "1", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["count"] == 1 and set(METRICS) <= set(rec)


@pytest.mark.parametrize("flag,item", [("--corrupt", "item 2"),
                                       ("--int8", "item 7")])
def test_refusals(ckpt, flag, item):
    with pytest.raises(SystemExit) as e:
        teval.main([ckpt, flag, "--device", "cpu"])
    assert "not ported yet" in str(e.value) and item in str(e.value)
