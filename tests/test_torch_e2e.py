"""The on-device e2e graph of the port (``panodepth_torch.e2e``) against the
JAX package's (``panodepth.e2e``): ``build_batched_e2e``, ``full_pipeline``
and the model-mode CLI, with the zoo's trained nets
(``zoo/perspective_final.params.npz``, ``zoo/fastpano_final.params.npz``),
on synthetic RGB panoramas made with numpy, at a small layout (two views,
out width 64, view width 64, baseline width 64).

Bars on the u16 output:

* f32 nets (``dtype`` f32 in both packages): max 4, mean < 0.5 -- the
  oracle's bar of the file-mode merge (``tests/test_parity_default.py``).
* bf16 nets (the shipping mode, and the CLI's): each conv rounds its
  output to bf16 after sums taken in another order than XLA's, and the
  registration's cubic fit amplifies the flips (the zoo perspective net
  maps these synthetic scenes into a narrow depth range, so the cubics
  are steep).  Measured max 111, mean 17.4 at the two-view layout, and up
  to max 1057, mean 36.3 at the four built-in layouts 128-256 wide; held
  to max 2048, mean 64.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import cli as jcli
from panodepth import e2e as je
from panodepth.config import MergeConfig as JaxMergeConfig
from panodepth.config import ViewLayout, register_layout

import panodepth_torch.config as tconfig
from panodepth_torch import cli as tcli
from panodepth_torch import e2e as te
from panodepth_torch import io as tio
from panodepth_torch.kernels import groupnorm as kg
from panodepth_torch.kernels import jacobi as kj

from conftest import make_equirect

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERSP = os.path.join(ROOT, "zoo", "perspective_final.params.npz")
BASE = os.path.join(ROOT, "zoo", "fastpano_final.params.npz")
D2R = math.pi / 180.0
F32_BAR = (4, 0.5)
BF16_BAR = (2048, 64.0)
# the model-mode CLI's int8 files against JAX's int8 CLI: u16 max, mean
# (measured 431 / 43.4 and 287 / 22.2; the bf16 graph of the same
# checkpoint 1137 / 68.2 and 1663 / 120.9)
INT8_CLI_BAR = (640, 56.0)
GN_PERSP = os.path.join(ROOT, "zoo", "gn", "perspective_final.params.npz")

# two views under 180 degrees (stage A's gnomonic limit), as test_e2e.py's
FOVS = np.array([(25 * D2R, 175 * D2R, 30 * D2R, 150 * D2R),
                 (185 * D2R, 355 * D2R, 30 * D2R, 150 * D2R)])
RANGES = np.array([(170 * D2R, 30 * D2R, 40 * D2R, 140 * D2R),
                   (350 * D2R, 190 * D2R, 40 * D2R, 140 * D2R)])
register_layout(ViewLayout("torch_e2e", fovs=FOVS, ranges=RANGES))
tconfig.layout_from_arrays("torch_e2e", FOVS, RANGES)
JCFG = JaxMergeConfig(layout_name="torch_e2e", out_width=64)
TCFG = tconfig.MergeConfig(layout_name="torch_e2e", out_width=64)


def _scene(k, rng, w=128):
    """(w/2, w, 3) f32 RGB in 0~1: smooth colour fields and a little noise."""
    h = w // 2
    az = np.linspace(0, 2 * np.pi, w, endpoint=False)[None, :]
    ze = np.linspace(0, np.pi, h)[:, None]
    r = 0.5 + 0.3 * np.sin(3 * az + k) * np.sin(ze)
    g = np.broadcast_to(0.5 + 0.3 * np.cos(2 * ze + az), (h, w))
    b = make_equirect(w, h)
    img = np.stack([r, g, b], -1) + 0.05 * rng.rand(h, w, 3)
    return np.clip(img, 0, 1).astype(np.float32)


def _u16_diff(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return int(d.max()), float(d.mean())


@pytest.fixture(scope="module")
def runs():
    """Both packages' batched e2e outputs in f32 and bf16 on two scenes."""
    rng = np.random.RandomState(3)
    rgbs = np.stack([_scene(0, rng), _scene(1, rng)])
    out = {"rgbs": rgbs}
    for mode, jd, td in (("f32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        jp, jpp, _ = je.load_model_checkpoint(PERSP)
        jb, jbp, _ = je.load_model_checkpoint(BASE)
        jp, jb = jp.clone(dtype=jd), jb.clone(dtype=jd)
        tp, _ = te.load_model_checkpoint(PERSP, device="cpu", dtype=td)
        tb, _ = te.load_model_checkpoint(BASE, device="cpu", dtype=td)
        jfull, _, _ = je.build_batched_e2e(jp, jpp, JCFG, view_width=64,
                                           base_model=jb, base_params=jbp,
                                           base_w=64)
        tfull, _, _ = te.build_batched_e2e(tp, TCFG, view_width=64,
                                           base_model=tb, base_w=64,
                                           device="cpu")
        kj.LAUNCHES = kg.LAUNCHES = 0
        t_out, t_base = tfull(torch.tensor(rgbs))
        assert kj.LAUNCHES == kg.LAUNCHES == 0  # the CPU runs no kernel
        j_out, j_base = jfull(jnp.asarray(rgbs))
        out[mode] = dict(j=np.asarray(j_out), t=t_out.numpy(),
                         jb=np.asarray(j_base), tb=t_base.numpy(),
                         models=(jp, jpp, jb, jbp, tp, tb), tfull=tfull)
    return out


@pytest.mark.parametrize("mode,bar", [("f32", F32_BAR), ("bf16", BF16_BAR)])
def test_batched_e2e_matches_jax(runs, mode, bar):
    r = runs[mode]
    assert r["t"].shape == r["j"].shape == (2, 32, 64)
    assert r["t"].dtype == np.uint16
    dmax, dmean = _u16_diff(r["t"], r["j"])
    assert dmax <= bar[0] and dmean < bar[1], (dmax, dmean)
    # the baseline CNN's output, within the nets' own bars
    tol = 1e-5 if mode == "f32" else 1e-2
    np.testing.assert_allclose(r["tb"], r["jb"], rtol=0, atol=tol)


def test_full_pipeline_matches_jax_and_batched_equals_single(runs):
    jp, jpp, jb, jbp, tp, tb = runs["f32"]["models"]
    rgb = runs["rgbs"][1]
    # the params are arguments, not constants folded into the graph
    want = jax.jit(lambda pp, bp, r: je.full_pipeline(
        r, jp, pp, jb, bp, cfg=JCFG, view_width=64, base_w=64))(
        jpp, jbp, jnp.asarray(rgb))
    got = te.full_pipeline(torch.tensor(rgb), tp, tb, cfg=TCFG,
                           view_width=64, base_w=64, device="cpu")
    assert got[0].shape == want[0].shape == (32, 64)
    dmax, dmean = _u16_diff(got[0], want[0])
    assert dmax <= F32_BAR[0] and dmean < F32_BAR[1], (dmax, dmean)
    assert len(got[3]) == TCFG.layout.num_views
    # the batched graph at batch 1 and 2 gives the single-panorama result
    single, _ = runs["f32"]["tfull"](torch.tensor(rgb[None]))
    assert _u16_diff(single[0], got[0])[0] <= 1
    assert _u16_diff(runs["f32"]["t"][1], got[0])[0] <= 1
    # the baseline given as an array instead of a net, u16 as from a file
    base_u16 = (np.clip(runs["f32"]["tb"][1], 0, 1) * 65535).astype(np.uint16)
    want = jax.jit(lambda pp, r, b: je.full_pipeline(
        r, jp, pp, baseline=b, cfg=JCFG, view_width=64))(
        jpp, jnp.asarray(rgb),
        jnp.asarray(base_u16.astype(np.float32) / 65535.0))
    got = te.full_pipeline(torch.tensor(rgb), tp, baseline=torch.tensor(
        base_u16), cfg=TCFG, view_width=64, device="cpu")
    dmax, dmean = _u16_diff(got[0], want[0])
    assert dmax <= F32_BAR[0] and dmean < F32_BAR[1], (dmax, dmean)


def _write_rgb8_png(path, rgb01):
    import struct
    import zlib

    u8 = (rgb01 * 255 + 0.5).astype(np.uint8)
    h, w, _ = u8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, -1)], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                 + chunk(b"IEND", b""))


def test_model_mode_cli_matches_jax_cli_with_resume(tmp_path, capsys):
    """Both CLIs in model mode on a folder of two 8-bit RGB PNGs (one with
    a gt), the baseline from the baseline CNN, nets in bf16: the port's
    files equal its in-memory graph on the decoded panoramas and agree
    with the JAX CLI's within the bf16 bar; then the port's CLI again,
    which skips both."""
    rng = np.random.RandomState(5)
    for d in ("rgb", "gt", "bl"):
        (tmp_path / d).mkdir()
    names = ["p0", "p1"]
    for k, name in enumerate(names):
        _write_rgb8_png(str(tmp_path / "rgb" / f"{name}.png"),
                        _scene(k + 2, rng, w=256))
    gt = np.clip(make_equirect(128, 64) * 0.9 + 0.05, 0, 1)
    tio.save_png16(str(tmp_path / "gt" / "p0.png"),
                   (gt * 65535).astype(np.uint16))
    args = ["0", str(tmp_path / "rgb"), str(tmp_path / "gt"),
            str(tmp_path / "bl")]
    common = ["--persp-ckpt", PERSP, "--baseline-ckpt", BASE, "--layout",
              "3fold", "--out-width", "128", "--view-width", "64",
              "--base-width", "128"]
    assert jcli.main(args + [str(tmp_path / "res_jax")] + common) == 0
    assert tcli.main(args + [str(tmp_path / "res_torch")] + common
                     + ["--device", "cpu"]) == 0
    for name in names:
        want = tio.read_png(str(tmp_path / "res_jax" / f"{name}.png"))
        got = tio.read_png(str(tmp_path / "res_torch" / f"{name}.png"))
        assert got.shape == want.shape == (64, 128)
        dmax, dmean = _u16_diff(got, want)
        assert dmax <= BF16_BAR[0] and dmean < BF16_BAR[1], (name, dmax,
                                                             dmean)
    # the CLI's plumbing (decode, batch, names) adds nothing to the graph
    tp, _ = te.load_model_checkpoint(PERSP, device="cpu")
    tb, _ = te.load_model_checkpoint(BASE, device="cpu")
    full, _, _ = te.build_batched_e2e(
        tp, tconfig.MergeConfig(layout_name="3fold", out_width=128),
        view_width=64, base_model=tb, base_w=128, device="cpu")
    for name in names:
        rgb = tio.load_image01(str(tmp_path / "rgb" / f"{name}.png"))
        mem, _ = full(torch.tensor(rgb[None]))
        np.testing.assert_array_equal(
            tio.read_png(str(tmp_path / "res_torch" / f"{name}.png")),
            mem[0].numpy())
    assert (tmp_path / "res_torch" / "p0.aligned.txt").is_file()
    assert not (tmp_path / "res_torch" / "p1.aligned.txt").exists()
    capsys.readouterr()
    kj.LAUNCHES = kg.LAUNCHES = 0
    before = (tmp_path / "res_torch" / "p0.png").read_bytes()
    tcli.main(args + [str(tmp_path / "res_torch")] + common
              + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "0/2 skip!" in out and "1/2 skip!" in out
    assert (tmp_path / "res_torch" / "p0.png").read_bytes() == before


@pytest.fixture(scope="module")
def model_mode_scene(tmp_path_factory):
    """Two 8-bit RGB panoramas (one with a gt) and the port CLI's model-mode
    run on them with no flag: (argv head, common flags, result folder)."""
    root = tmp_path_factory.mktemp("model_mode")
    rng = np.random.RandomState(11)
    for d in ("rgb", "gt", "bl"):
        (root / d).mkdir()
    for k in range(2):
        _write_rgb8_png(str(root / "rgb" / f"p{k}.png"),
                        _scene(k + 4, rng, w=256))
    gt = np.clip(make_equirect(128, 64) * 0.9 + 0.05, 0, 1)
    tio.save_png16(str(root / "gt" / "p0.png"), (gt * 65535).astype(np.uint16))
    head = ["0", str(root / "rgb"), str(root / "gt"), str(root / "bl")]
    common = ["--persp-ckpt", PERSP, "--baseline-ckpt", BASE, "--layout",
              "3fold", "--out-width", "128", "--view-width", "64",
              "--base-width", "128", "--device", "cpu"]
    assert tcli.main(head + [str(root / "res_plain")] + common) == 0
    return head, common, root


# flags the model mode now runs: each case runs the CLI with it and holds
# the files to the run without it
_RUNS = {"--stream": ("--stream", "on"), "--profile": ("--profile",),
         "--latency": ("--latency", "--latency-halo", "10")}
# flags the model mode now runs whose files are held to the JAX CLI's with
# the same flags (the bf16 bar); the box feed engages on u8 input only,
# so its case streams the panoramas (the variable set for both CLIs)
_JAX_RUNS = {"--extract-dtype pair16": ("--extract-dtype", "pair16"),
             "--p99 approx": ("--p99", "approx"),
             "PANODEPTH_BASE_FEED=box": ("--stream", "on")}


def run_both_clis(head, common, root, extra, monkeypatch, env=None):
    """The port's and the JAX CLI's model mode with ``extra`` flags (and the
    environment ``env``) into ``root/res_{torch,jax}``; returns the two
    folders.  Each CLI sets PANODEPTH_P99 for ``--p99``; the variables are
    as before after the test."""
    monkeypatch.delenv("PANODEPTH_P99", raising=False)  # unset at teardown
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    res = {k: str(root / f"res_{k}") for k in ("torch", "jax")}
    assert tcli.main(head + [res["torch"]] + common + list(extra)) == 0
    jargs = [a for a in common if a not in ("--device", "cpu")]
    assert jcli.main(head + [res["jax"]] + jargs + list(extra)
                     + ["--platform", "cpu"]) == 0
    os.environ.pop("PANODEPTH_P99", None)
    return res


@pytest.mark.parametrize("extra,needle", [
    (("--extract-dtype", "pair16"), "--extract-dtype pair16"),
    (("--p99", "approx"), "--p99 approx"),
    (("--persp-int8",), "--persp-int8"),
    (("--latency", "--latency-halo", "10"), "--latency"),
    (("--stream", "on"), "--stream"),
    (("--profile",), "--profile"),
    (("--stream", "on"), "PANODEPTH_BASE_FEED=box"),
])
def test_model_mode_refuses_what_is_not_ported(tmp_path, request, capsys,
                                               monkeypatch, extra, needle):
    """What is not ported is refused by name; ``--stream on``,
    ``--profile`` and ``--latency --latency-halo 10`` (one rank: the
    view-parallel graph over this process alone), ported since, run and
    give the files of the run without them within 2 u16 (the CLI bar), the
    same metrics, with ``--profile`` the models / fuse split in the end
    line and with ``--latency`` the view-parallel one.
    ``--persp-int8``, ported since, runs the GN perspective checkpoint's
    int8 graph: the files within ``INT8_CLI_BAR`` of the JAX CLI's with
    the flag, and the bf16 graph of the same checkpoint outside it, the
    metrics file written and the int8 graph's own output equal to the
    file.  ``--extract-dtype pair16``, ``--p99 approx`` and
    ``PANODEPTH_BASE_FEED=box`` (with ``--stream on``), ported since, run
    both CLIs: the files within the bf16 bar of the JAX CLI's with the
    same options (measured at most 329 / 23.9, 260 / 21.2 and 271 / 28.4),
    and ``--p99 approx`` within 1 u16 of the run without it (measured max
    1, mean 0.008: the top-k interpolation ``lo + f (hi - lo)`` and the
    sort's ``lo (1 - f) + hi f`` differ by an f32 ulp; JAX's CLI moves 22 /
    0.83 between the two), and the box run's file equal to the in-memory
    graph on the u8 panorama under the variable."""
    if needle in _JAX_RUNS:
        head, common, root = request.getfixturevalue("model_mode_scene")
        env = ({"PANODEPTH_BASE_FEED": "box"} if "BASE_FEED" in needle
               else None)
        res = run_both_clis(head, common, tmp_path, extra, monkeypatch, env)
        for name in ("p0", "p1"):
            got = tio.read_png(os.path.join(res["torch"], f"{name}.png"))
            want = tio.read_png(os.path.join(res["jax"], f"{name}.png"))
            dmax, dmean = _u16_diff(got, want)
            assert got.shape == (64, 128) and dmax <= BF16_BAR[0] \
                and dmean < BF16_BAR[1], (name, dmax, dmean)
            plain = tio.read_png(str(root / "res_plain" / f"{name}.png"))
            if needle == "--p99 approx":
                assert _u16_diff(got, plain)[0] <= 1, name
            else:  # another feed or table: another output
                assert _u16_diff(got, plain)[0] > 2, name
        assert os.path.isfile(os.path.join(res["torch"], "p0.aligned.txt"))
        if "BASE_FEED" in needle:
            # the graph under the variable: the box mean of the u8 pixels
            tp, _ = te.load_model_checkpoint(PERSP, device="cpu")
            tb, _ = te.load_model_checkpoint(BASE, device="cpu")
            full = te.build_batched_e2e(
                tp, tconfig.MergeConfig(layout_name="3fold", out_width=128),
                view_width=64, base_model=tb, base_w=128, device="cpu")[0]
            rgb8 = tio.load_image_int(str(root / "rgb" / "p0.png"))[0]
            got = tio.read_png(os.path.join(res["torch"], "p0.png"))
            np.testing.assert_array_equal(
                got, full(torch.tensor(rgb8[None]))[0][0].numpy())
        return
    if needle == "--persp-int8":
        head, common, root = request.getfixturevalue("model_mode_scene")
        int8 = [GN_PERSP if a == PERSP else a for a in common] + list(extra)
        res = {k: str(tmp_path / f"res_{k}") for k in ("torch", "jax")}
        assert tcli.main(head + [res["torch"]] + int8) == 0
        jargs = [a for a in int8 if a not in ("--device", "cpu")]
        assert jcli.main(head + [res["jax"]] + jargs
                         + ["--platform", "cpu"]) == 0
        tp, _ = te.load_model_checkpoint(GN_PERSP, device="cpu",
                                         quantize=True)
        tb, _ = te.load_model_checkpoint(BASE, device="cpu")
        tf, _ = te.load_model_checkpoint(GN_PERSP, device="cpu")
        full, floats = (te.build_batched_e2e(
            net, tconfig.MergeConfig(layout_name="3fold", out_width=128),
            view_width=64, base_model=tb, base_w=128, device="cpu")[0]
            for net in (tp, tf))
        for name in ("p0", "p1"):
            got = tio.read_png(os.path.join(res["torch"], f"{name}.png"))
            want = tio.read_png(os.path.join(res["jax"], f"{name}.png"))
            dmax, dmean = _u16_diff(got, want)
            assert got.shape == (64, 128) and dmax <= INT8_CLI_BAR[0] \
                and dmean < INT8_CLI_BAR[1], (name, dmax, dmean)
            rgb = torch.tensor(tio.load_image01(
                str(root / "rgb" / f"{name}.png"))[None])
            np.testing.assert_array_equal(got, full(rgb)[0][0].numpy())
            fmax, fmean = _u16_diff(floats(rgb)[0][0].numpy(), want)
            assert fmax > INT8_CLI_BAR[0] or fmean >= INT8_CLI_BAR[1], (
                name, fmax, fmean)
        assert os.path.isfile(os.path.join(res["torch"], "p0.aligned.txt"))
        return
    if _RUNS.get(needle) == extra:
        head, common, root = request.getfixturevalue("model_mode_scene")
        res = root / f"res{needle.replace('-', '_')}"
        capsys.readouterr()
        assert tcli.main(head + [str(res)] + common + list(extra)) == 0
        out = capsys.readouterr().out
        for name in ("p0", "p1"):
            got = tio.read_png(str(res / f"{name}.png"))
            want = tio.read_png(str(root / "res_plain" / f"{name}.png"))
            assert got.shape == (64, 128) and _u16_diff(got, want)[0] <= 2
        assert ((res / "p0.aligned.txt").read_text()
                == (root / "res_plain" / "p0.aligned.txt").read_text())
        if needle == "--profile":
            assert "time_Models_avg:n/a" not in out
            assert "time_Models_avg:" in out and "reg+fusion" in out
        if needle == "--latency":
            assert "view-parallel latency mode over 1 ranks" in out
            assert "time_e2e_avg:" in out and "(view-parallel)" in out
        return
    argv = ["0"] + [str(tmp_path)] * 4 + ["--persp-ckpt", PERSP,
                                           "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        tcli.main(argv + list(extra))
    assert needle in str(e.value.code) and "not ported" in str(e.value.code)


@pytest.mark.parametrize("extra,needle", [
    (("--base-width", "256"), "--base-width"),
    (("--baseline-ckpt", BASE, "--batch-size", "0"), "--batch-size"),
])
def test_model_mode_refusals_of_the_jax_cli(tmp_path, extra, needle):
    argv = ["0"] + [str(tmp_path)] * 4 + ["--persp-ckpt", PERSP,
                                           "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        tcli.main(argv + list(extra))
    assert needle in str(e.value.code)


def test_extract_dtype_policy():
    """``auto`` is ``f32`` (JAX's choice off the TPU); every other mode of
    JAX's ``--extract-dtype`` is its own table; anything else is refused."""
    assert te._resolve_extract_dtype("auto") == "f32"
    assert te._resolve_extract_dtype("f32") == "f32"
    for mode in ("packed", "packed16", "pair16", "pair16d", "bf16"):
        assert te._resolve_extract_dtype(mode) == mode
        assert je._resolve_extract_dtype(mode, jnp.uint8, False) == mode
    assert je._resolve_extract_dtype("auto", jnp.uint8, False) == "f32"
    with pytest.raises(ValueError, match="extract dtype"):
        te._resolve_extract_dtype("u8")
    assert te._round32(247) == 256 and te._round32(256) == 256
    assert te._round32(5) == 32
    u8 = torch.tensor([[0, 255]], dtype=torch.uint8)
    assert te._as01(u8).tolist() == [[0.0, 1.0]]
    u16 = torch.tensor([[0, 65535]], dtype=torch.uint16)
    assert te._as01(u16).tolist() == [[0.0, 1.0]]


def test_run_batch_e2e_batched_matches_single(tmp_path):
    """``--batch-size`` in model mode, as tests/test_e2e.py checks the JAX
    driver: three panoramas at batch 1 and batch 2 (the odd count pads the
    last chunk), baselines from files; the same files and metrics."""
    rng = np.random.RandomState(7)
    for d in ("rgb", "gt", "bl"):
        (tmp_path / d).mkdir()
    for i in range(3):
        _write_rgb8_png(str(tmp_path / "rgb" / f"p{i}.png"),
                        _scene(i, rng, w=256))
        tio.save_png16(str(tmp_path / "gt" / f"p{i}.png"),
                       (rng.rand(64, 128) * 60000).astype(np.uint16))
        # a result folder named *hohonet* reads <raw>.depth.png baselines
        tio.save_png16(str(tmp_path / "bl" / f"p{i}.depth.png"),
                       (rng.rand(32, 64) * 60000 + 2000).astype(np.uint16))
    cfg = tconfig.MergeConfig(layout_name="3fold", out_width=128)
    outs, mets = {}, {}
    for bs in (1, 2):
        res = tmp_path / f"res_hohonet_b{bs}"
        mets[bs] = te.run_batch_e2e(
            str(tmp_path / "rgb"), str(tmp_path / "gt"), str(res), PERSP,
            cfg, baseline_folder=str(tmp_path / "bl"), view_width=64,
            batch_size=bs, log=lambda *a: None, device="cpu")
        outs[bs] = [tio.read_png(str(res / f"p{i}.png")) for i in range(3)]
    assert len(mets[1]) == len(mets[2]) == 3
    for a, b in zip(outs[1], outs[2]):
        assert a.shape == (64, 128) and _u16_diff(a, b)[0] <= 1
    for m1, m2 in zip(mets[1], mets[2]):
        np.testing.assert_allclose(m1.mse_result, m2.mse_result, rtol=1e-4,
                                   atol=1e-7)
