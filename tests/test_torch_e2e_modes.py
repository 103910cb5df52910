"""The options of the port's e2e graph against the JAX package's
``build_batched_e2e`` and CLI: every ``extract_dtype`` table (``bf16``,
``packed``, ``packed16``, ``pair16``, ``pair16d``), the box feed
(``PANODEPTH_BASE_FEED=box``) and the 99th percentile's ``topk`` /
``approx`` (``PANODEPTH_P99``), on the scenes of ``tests/test_torch_e2e.py``
(two views, out width 64, views 64 wide, baseline 64 wide; the CLI at
``3fold``, out 128).  Mirrors ``tests/test_e2e.py:197-230, 294-343,
422-453``.

Bars:

* The models stage with f32 nets (baselines and the views' depths): 1e-5,
  the nets' own bar; measured 1.5e-7 to 4e-7 in every table, so the
  tables, the bf16 feed and the extraction agree with JAX's.
* The u16 output with f32 nets: ``MODES_F32_BAR``, max 32, mean 1.0.  The
  registration amplifies f32 noise on some depths (see
  ``tests/test_torch_families_e2e.py``): on JAX's own models-stage outputs
  of the ``packed16`` table the port's fuse stage differs from JAX's by
  14 / 0.55, and the whole graph measured 14 / 0.51 (``packed16``,
  ``pair16``), 4 / 0.17 (``pair16d``), 3 / 0.11 (``bf16``, ``packed``).
* The box feed's bf16 input bit-equal to the jitted JAX graph's (the form
  it runs); ``pair16`` bit-equal to ``packed16``; ``packed`` and
  ``packed16`` from a u8 panorama bit-equal to the same tables from its f32
  k/255 (the tables are exact for 8-bit sources, as JAX pins them).
* The CLI files with the bf16 nets against the JAX CLI's with the same
  option: the bf16 bar of ``tests/test_torch_e2e.py`` (2048 / 64; measured
  at most 435 / 30.3); ``topk`` and ``approx`` within 1 u16 of ``sort``
  and equal to each other.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from panodepth import cli as jcli
from panodepth import e2e as je

from panodepth_torch import cli as tcli
from panodepth_torch import e2e as te
from panodepth_torch import io as tio

from test_torch_e2e import (BASE, BF16_BAR, JCFG, PERSP, TCFG,
                            _scene, _u16_diff, _write_rgb8_png)

torch.set_num_threads(1)

MODES_F32_BAR = (32, 1.0)
TABLES = ("bf16", "packed", "packed16", "pair16", "pair16d")


@pytest.fixture(scope="module")
def nets():
    """The zoo pair in f32 in both packages, and a u8 scene of two
    panoramas with its f32 k/255."""
    jp, jpp, _ = je.load_model_checkpoint(PERSP)
    jb, jbp, _ = je.load_model_checkpoint(BASE)
    tp, _ = te.load_model_checkpoint(PERSP, device="cpu",
                                     dtype=torch.float32)
    tb, _ = te.load_model_checkpoint(BASE, device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(3)
    u8 = np.round(np.stack([_scene(0, rng), _scene(1, rng)]) * 255).astype(
        np.uint8)
    return dict(j=(jp.clone(dtype=jnp.float32), jpp,
                   jb.clone(dtype=jnp.float32), jbp), t=(tp, tb), u8=u8,
                f=u8.astype(np.float32) / np.float32(255.0), outs={})


def _port(nets, mode):
    tp, tb = nets["t"]
    return te.build_batched_e2e(tp, TCFG, view_width=64, base_model=tb,
                                base_w=64, device="cpu", extract_dtype=mode)


@pytest.mark.parametrize("mode", TABLES)
def test_batched_e2e_table_matches_jax(nets, mode):
    jp, jpp, jb, jbp = nets["j"]
    _, j_models, j_fuse = je.build_batched_e2e(
        jp, jpp, JCFG, view_width=64, base_model=jb, base_params=jbp,
        base_w=64, extract_dtype=mode)
    t_full, t_models, _ = _port(nets, mode)
    j_base, j_pmaps = j_models(jnp.asarray(nets["f"]))
    j_out, _ = j_fuse(j_base, j_pmaps)
    t_base, t_pmaps = t_models(torch.tensor(nets["f"]))
    np.testing.assert_allclose(t_base.numpy(), np.asarray(j_base), rtol=0,
                               atol=1e-5)
    for got, want in zip(t_pmaps, j_pmaps):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    out, _ = t_full(torch.tensor(nets["f"]))
    assert out.shape == (2, 32, 64) and out.dtype == torch.uint16
    dmax, dmean = _u16_diff(out, j_out)
    assert dmax <= MODES_F32_BAR[0] and dmean < MODES_F32_BAR[1], (dmax,
                                                                   dmean)
    nets["outs"][mode] = out.numpy()
    if mode in ("packed", "packed16"):
        # u8 input packs straight from the u8 pixels: the same table
        u8_out, _ = t_full(torch.tensor(nets["u8"]))
        np.testing.assert_array_equal(u8_out.numpy(), out.numpy())


def test_pair16_equals_packed16_through_the_graph(nets):
    """The pair table feeds the nets the 565 table's views bit for bit, so
    the whole graph agrees exactly; the dithered pair table only differs
    through its dither (tests/test_e2e.py:325-341)."""
    outs = {m: nets["outs"].get(m) for m in ("packed16", "pair16",
                                             "pair16d")}
    for m in outs:
        if outs[m] is None:
            outs[m] = _port(nets, m)[0](torch.tensor(nets["f"]))[0].numpy()
    np.testing.assert_array_equal(outs["pair16"], outs["packed16"])
    assert not np.array_equal(outs["pair16d"], outs["pair16"])
    assert _u16_diff(outs["pair16d"], outs["packed16"])[1] < 2000.0


class _SpyBase(nn.Module):
    """A baseline 'net' whose output is its input feed's red channel, so
    the models stage shows the feed (tests/test_e2e.py:422-453)."""

    def forward(self, rb):
        return rb[..., 0].to(torch.float32)


class _JaxSpyBase:
    def apply(self, params, rb):
        return rb[..., 0].astype(jnp.float32)


@pytest.mark.parametrize("shape,gated", [((1, 64, 128, 3), True),
                                         ((2, 96, 192, 3), True),
                                         ((1, 72, 128, 3), False)])
def test_box_base_feed_exact_and_gated(monkeypatch, nets, shape, gated):
    """PANODEPTH_BASE_FEED=box: the baseline net's input is the integer-
    factor box mean of the u8 panorama in bf16, bit-equal to the jitted
    JAX graph's (a 2x2 and a 3x3 box); f32 input, or a height the feed
    does not divide, keeps the bilinear feed, as in JAX, equal to the
    default's.  Without the variable the feed is the bilinear one."""
    from panodepth.models.perspective import PerspectiveDepthNet

    # JAX's own test's tiny perspective net (it compiles in a second); the
    # feed does not depend on it
    jp = PerspectiveDepthNet(stage_sizes=(1, 1, 1, 1),
                             widths=(8, 16, 16, 32), decoder_width=16)
    jpp = jp.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tp, _ = nets["t"]
    u8 = np.random.RandomState(5).randint(0, 256, shape).astype(np.uint8)
    f32 = u8.astype(np.float32) / np.float32(255.0)

    def feeds():
        _, jm, _ = je.build_batched_e2e(jp, jpp, JCFG, view_width=64,
                                        base_model=_JaxSpyBase(),
                                        base_params={}, base_w=64)
        _, tm, _ = te.build_batched_e2e(tp, TCFG, view_width=64,
                                        base_model=_SpyBase(), base_w=64,
                                        device="cpu")
        return {k: (tm(torch.tensor(x))[0].numpy(),
                    np.asarray(jm(jnp.asarray(x))[0]))
                for k, x in (("u8", u8), ("f32", f32))}

    monkeypatch.delenv("PANODEPTH_BASE_FEED", raising=False)
    plain = feeds()
    monkeypatch.setenv("PANODEPTH_BASE_FEED", "box")
    box = feeds()
    got, want = box["u8"]
    assert got.shape == (shape[0], 32, 64)
    if gated:
        np.testing.assert_array_equal(got, want)
        fh, fw = shape[1] // 32, shape[2] // 64
        mean = u8[..., 0].reshape(shape[0], 32, fh, 64, fw).astype(
            np.float64).mean((2, 4)) / 255.0
        np.testing.assert_allclose(got, mean, atol=1.0 / 255.0)
        assert not np.array_equal(got, plain["u8"][0])
    else:
        np.testing.assert_array_equal(got, plain["u8"][0])
    # f32 input: the bilinear feed, the default's and within the f32
    # resize's bar of JAX's
    np.testing.assert_array_equal(box["f32"][0], plain["f32"][0])
    np.testing.assert_allclose(box["f32"][0], box["f32"][1], rtol=0,
                               atol=3e-7)
    monkeypatch.setenv("PANODEPTH_BASE_FEED", "boxes")
    with pytest.raises(ValueError, match="PANODEPTH_BASE_FEED"):
        feeds()


def test_stage_graphs_key_on_the_variables(nets):
    """A graph captured under one feed or p99 is never replayed for the
    other: both variables join the key of the models stage's and the
    whole graph's CUDA graphs (the fuse stage reads neither)."""
    full, models, fuse = _port(nets, "f32")
    assert full.env == models.env == te.STAGE_ENV == (
        "PANODEPTH_BASE_FEED", "PANODEPTH_P99")
    assert fuse.env == ()


@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    """One 8-bit RGB panorama with a gt, the CLI's flags, and the port's
    runs without an option and with ``--p99 sort``."""
    root = tmp_path_factory.mktemp("modes_cli")
    for d in ("rgb", "gt", "bl"):
        (root / d).mkdir()
    _write_rgb8_png(str(root / "rgb" / "p0.png"),
                    _scene(4, np.random.RandomState(11), w=256))
    from conftest import make_equirect

    gt = np.clip(make_equirect(128, 64) * 0.9 + 0.05, 0, 1)
    tio.save_png16(str(root / "gt" / "p0.png"), (gt * 65535).astype(np.uint16))
    head = ["0", str(root / "rgb"), str(root / "gt"), str(root / "bl")]
    common = ["--persp-ckpt", PERSP, "--baseline-ckpt", BASE, "--layout",
              "3fold", "--out-width", "128", "--view-width", "64",
              "--base-width", "128"]
    assert tcli.main(head + [str(root / "t_plain")] + common
                     + ["--device", "cpu"]) == 0
    return head, common, root


def _read(folder):
    return tio.read_png(os.path.join(folder, "p0.png"))


@pytest.mark.parametrize("extra", [("--extract-dtype", m) for m in
                                   ("bf16", "packed", "packed16",
                                    "pair16d")] + [("--p99", "topk")])
def test_model_mode_cli_option_matches_jax_cli(cli_scene, monkeypatch,
                                               extra):
    """The port's CLI with each remaining option against the JAX CLI with
    the same one; ``packed16`` again as ``pair16`` (equal files), ``topk``
    again as ``approx`` (equal files) and within 1 u16 of ``sort``."""
    head, common, root = cli_scene
    monkeypatch.delenv("PANODEPTH_P99", raising=False)  # unset at teardown
    tag = "_".join(extra).strip("-")
    out = {}
    for who, argv in (("t", common + ["--device", "cpu"]),
                      ("j", common + ["--platform", "cpu"])):
        main = tcli.main if who == "t" else jcli.main
        assert main(head + [str(root / f"{who}_{tag}")] + argv
                    + list(extra)) == 0
        out[who] = _read(str(root / f"{who}_{tag}"))
        os.environ.pop("PANODEPTH_P99", None)
    dmax, dmean = _u16_diff(out["t"], out["j"])
    assert out["t"].shape == (64, 128)
    assert dmax <= BF16_BAR[0] and dmean < BF16_BAR[1], (dmax, dmean)
    assert (root / f"t_{tag}" / "p0.aligned.txt").is_file()
    twin = {"--extract-dtype packed16": ("--extract-dtype", "pair16"),
            "--p99 topk": ("--p99", "approx")}.get(" ".join(extra))
    if twin is not None:
        assert tcli.main(head + [str(root / f"t_twin_{tag}")] + common
                         + ["--device", "cpu"] + list(twin)) == 0
        os.environ.pop("PANODEPTH_P99", None)
        np.testing.assert_array_equal(_read(str(root / f"t_twin_{tag}")),
                                      out["t"])
    plain = _read(str(root / "t_plain"))
    if extra[0] == "--p99":
        assert _u16_diff(out["t"], plain)[0] <= 1
    else:
        assert _u16_diff(out["t"], plain)[0] > 2
