"""The model-mode CLI of the port with every zoo family against the JAX
CLI, and the two repairs of ``e2e.py`` that this slice's nets need:
``--base-width`` refused for the fixed-width families as in
``panodepth/e2e.py:519-523``, and the GroupNorm route set on both nets.

Pairs, widths and the bf16 bar are those of
``tests/test_torch_families_e2e.py``; the CLIs run their shipping bf16
nets on two 8-bit RGB PNGs at ``3fold``, out width 128, views 64 wide.
"""

import numpy as np
import pytest
import torch

from panodepth import cli as jcli
from panodepth import e2e as je

from panodepth_torch import cli as tcli
from panodepth_torch import e2e as te
from panodepth_torch import io as tio
from panodepth_torch.kernels import groupnorm as kg
from panodepth_torch.models import norm as tnorm

from conftest import make_equirect
from test_torch_e2e import BF16_BAR, _scene, _u16_diff, _write_rgb8_png
from test_torch_families_e2e import JCFG, PAIRS, TCFG

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    """Two 8-bit RGB panoramas, one with a gt: (root, argv head)."""
    root = tmp_path_factory.mktemp("families_cli")
    rng = np.random.RandomState(13)
    for d in ("rgb", "gt", "bl"):
        (root / d).mkdir()
    for k in range(2):
        _write_rgb8_png(str(root / "rgb" / f"p{k}.png"),
                        _scene(k + 2, rng, w=256))
    gt = np.clip(make_equirect(128, 64) * 0.9 + 0.05, 0, 1)
    tio.save_png16(str(root / "gt" / "p0.png"), (gt * 65535).astype(np.uint16))
    return root, ["0", str(root / "rgb"), str(root / "gt"), str(root / "bl")]


@pytest.mark.parametrize("family", list(PAIRS))
def test_model_mode_cli_with_each_family_matches_jax_cli(cli_scene, family,
                                                         capsys):
    """Both CLIs in model mode with ``--baseline-ckpt`` (bf16 nets): the
    port's files agree with the JAX CLI's within the bf16 bar, the gt's
    metrics are written, and a second run skips both panoramas."""
    root, head = cli_scene
    persp, base, base_w = PAIRS[family]
    common = ["--persp-ckpt", persp, "--baseline-ckpt", base, "--layout",
              "3fold", "--out-width", "128", "--view-width", "64"]
    if base_w != 512:
        common += ["--base-width", str(base_w)]
    res_j, res_t = root / f"jax_{family}", root / f"torch_{family}"
    assert jcli.main(head + [str(res_j)] + common) == 0
    assert tcli.main(head + [str(res_t)] + common + ["--device", "cpu"]) == 0
    for name in ("p0", "p1"):
        want = tio.read_png(str(res_j / f"{name}.png"))
        got = tio.read_png(str(res_t / f"{name}.png"))
        assert got.shape == want.shape == (64, 128)
        dmax, dmean = _u16_diff(got, want)
        assert dmax <= BF16_BAR[0] and dmean < BF16_BAR[1], (name, dmax,
                                                             dmean)
    assert (res_t / "p0.aligned.txt").is_file()
    capsys.readouterr()
    tcli.main(head + [str(res_t)] + common + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "0/2 skip!" in out and "1/2 skip!" in out


@pytest.mark.parametrize("family", ["hohonet", "slicenet"])
def test_base_width_refused_for_fixed_width_families(tmp_path, family):
    """As ``panodepth/e2e.py:519-523``: both packages stop with the same
    message."""
    persp, base, _ = PAIRS[family]
    (tmp_path / "rgb").mkdir()
    with pytest.raises(SystemExit) as jerr:
        je.run_batch_e2e(str(tmp_path / "rgb"), str(tmp_path), str(
            tmp_path / "res_j"), persp, JCFG, baseline_ckpt=base,
            base_width=256, log=lambda *a: None)
    with pytest.raises(SystemExit) as terr:
        te.run_batch_e2e(str(tmp_path / "rgb"), str(tmp_path), str(
            tmp_path / "res_t"), persp, TCFG, baseline_ckpt=base,
            base_width=256, log=lambda *a: None, device="cpu")
    assert str(terr.value.code) == str(jerr.value.code)
    assert f"--base-width: {family} has a fixed-width decoder" in str(
        terr.value.code)
    # the fully-convolutional families take it
    argv = ["0"] + [str(tmp_path / "rgb")] * 3 + [str(tmp_path / "res_c"),
                                                  "--persp-ckpt", persp,
                                                  "--device", "cpu"]
    assert tcli.main(argv + ["--baseline-ckpt", PAIRS["bifuse"][1],
                             "--base-width", "256"]) == 0


def test_groupnorm_route_is_set_on_both_nets():
    """``groupnorm="torch"`` reaches every GroupNorm of the perspective net
    as well as the baseline net's: with both nets' norms set to the
    kernel route first, a norm the route missed would call the CUDA kernel
    on a CPU tensor and raise."""
    persp, base, _ = PAIRS["gn_perspective"]
    tp, _ = te.load_model_checkpoint(persp, device="cpu")
    tb, _ = te.load_model_checkpoint(base, device="cpu")
    norms = [m for net in (tp, tb) for m in net.modules()
             if isinstance(m, tnorm.GroupNorm)]
    assert len(norms) == 29 + 29
    for net in (tp, tb):
        tnorm.set_route(net, "kernel")
    full, _, _ = te.build_batched_e2e(tp, TCFG, view_width=64,
                                      base_model=tb, base_w=128,
                                      groupnorm="torch", device="cpu")
    rgbs = np.stack([_scene(0, np.random.RandomState(2))])
    kg.LAUNCHES = 0
    out, _ = full(torch.tensor(rgbs))
    assert out.shape == (1, 32, 64) and kg.LAUNCHES == 0
    assert {m.route for m in norms} == {"torch"}
