"""The port's merge and CLI against the JAX package's.

* ``merge_arrays`` against JAX ``merge_arrays`` and against the oracle
  ``ref_solve_depth_all`` given the same coefficients, at the bar of
  tests/test_parity_default.py (max <= 4 u16, mean < 0.5).
* The verify-skill scene (``--layout 3fold --out-width 256``) through both
  CLIs: the same files, outputs within 2 u16, metrics within 1e-4.
* Resume, quarantine, and the CLI's refusals of what is not ported.
  (Stage A on: ``tests/test_torch_stage_a.py``.)
* ``--trace`` (a Chrome trace, the same outputs) and ``--debug-nans``
  (bit-equal on a clean scene, alone and batched; FloatingPointError
  naming the stage and the panorama on a NaN view, where JAX's CLI aborts
  too in a fresh process).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import cli as jcli
from panodepth import geometry as jgeometry
from panodepth import io as jio
from panodepth.config import three_fold
from panodepth.pipeline import merge_arrays as jax_merge_arrays

from panodepth_torch import cli as tcli
from panodepth_torch import io as tio
from panodepth_torch import pipeline as tpipeline

from conftest import make_equirect, smooth_depth
from reference_impl import (RefPerspectiveMap, ref_depth2depth_transform,
                            ref_solve_depth_all)
from torch_port_common import leres_scene


def test_merge_arrays_matches_jax_and_oracle():
    sc = leres_scene()
    jcfg = sc["jcfg"]
    j_out, _ = jax.jit(lambda e, p: jax_merge_arrays(e, p, jcfg))(
        jnp.asarray(sc["emap"]), jnp.asarray(sc["pmaps"]))
    t_out, t_abcd = tpipeline.merge_arrays(sc["emap"], sc["pmaps"], sc["tcfg"],
                                           device="cpu")
    t_out = t_out.numpy().astype(np.int64)
    assert t_out.shape == (64, 128)
    # the two frameworks' f32 solves and sums round differently
    d = np.abs(t_out - np.asarray(j_out).astype(np.int64))
    assert d.max() <= 4, d.max()
    assert d.mean() < 0.5, d.mean()

    # the oracle with the port's own coefficients isolates transform+fusion
    ranges = jcfg.clamped_ranges()
    abcd = t_abcd.numpy().astype(np.float64)
    ref_pmaps = []
    for v in range(15):
        pm = RefPerspectiveMap(sc["pmaps"][v], jcfg.layout.fovs[v], ranges[v])
        pm.data = ref_depth2depth_transform(pm.data, abcd[v])
        ref_pmaps.append(pm)
    out_ref = ref_solve_depth_all(sc["emap"], ref_pmaps, jcfg.out_width,
                                  jcfg.out_height, jcfg.zenith_range,
                                  schedule=jcfg.schedule)
    d = np.abs(t_out - out_ref.astype(np.int64))
    assert d.max() <= 4, d.max()
    assert d.mean() < 0.5, d.mean()


def test_merge_arrays_uint16_input_and_jacobi_kinds():
    sc = leres_scene()
    e16 = (sc["emap"] * 65535).astype(np.uint16)
    p16 = (sc["pmaps"] * 65535).astype(np.uint16)
    a, _ = tpipeline.merge_arrays(e16, p16, sc["tcfg"], device="cpu")
    b, _ = tpipeline.merge_arrays(e16.astype(np.float32) / np.float32(65535),
                                  p16.astype(np.float32) / np.float32(65535),
                                  sc["tcfg"], jacobi="torch", device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(TypeError, match="CUDA tensor"):
        tpipeline.merge_arrays(e16, p16, sc["tcfg"], jacobi="kernel",
                               device="cpu")


def _write_verify_scene(root, names):
    """The verification scene of the repo's verify notes, written with the JAX
    package's writers: 16-bit gt and views, an 8-bit JPEG baseline with a
    mid-frequency artifact, under the default (bifuse) naming.  The last
    name gets no baseline, to be quarantined."""
    lt = three_fold()
    for d in ("rgb", "gt", "baseline", "views"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    def detail(azi, zen):
        return np.clip(smooth_depth(azi, zen)
                       + 0.03 * np.sin(5 * azi) * np.sin(4 * zen), 0, 1)

    def artifact(azi, zen):
        return np.clip(smooth_depth(azi, zen) * 0.9 + 0.03
                       + 0.08 * np.sin(6 * azi) * np.sin(5 * zen), 0, 1)

    for k, name in enumerate(names):
        jio.save_png16(os.path.join(root, "gt", name + ".png"),
                       jio.to_uint16(make_equirect(512, 256, detail)))
        if k < len(names) - 1:
            jio.save_jpg(os.path.join(root, "baseline", name + ".jpg"),
                         make_equirect(256, 128, artifact))
        jio.save_jpg(os.path.join(root, "rgb", name + ".jpg"),
                     np.stack([make_equirect(64, 32)] * 3, -1))
        for v in range(lt.num_views):
            win = jgeometry.make_window(*lt.fovs[v], xp=np)
            xg, yg = np.meshgrid(np.arange(128) / 127, np.arange(112) / 111)
            azi, zen = jgeometry.xy_to_spherical(win, xg, yg, xp=np)
            pm = np.clip(detail(azi, zen) * (0.8 + 0.03 * v) + 0.05 - 0.01 * k,
                         0, 1)
            jio.save_png16(os.path.join(
                root, "views", f"{name}.{lt.view_tag(v)}.png"), jio.to_uint16(pm))


def _argv(root, result, *extra):
    return ["0", os.path.join(root, "rgb"), os.path.join(root, "gt"),
            os.path.join(root, "baseline"), os.path.join(root, result),
            "--layout", "3fold", "--out-width", "256", "--views-folder",
            os.path.join(root, "views"), "--no-extract", "--pmap-ext", ".png",
            *extra]


def _aligned(path):
    with open(path) as fp:
        rows = [line.split(": ") for line in fp.read().splitlines()]
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("verify_scene"))
    names = ["pano_0001", "pano_0002"]
    _write_verify_scene(root, names)
    assert jcli.main(_argv(root, "result_jax", "--platform", "cpu")) == 0
    assert tcli.main(_argv(root, "result_torch", "--device", "cpu")) == 0
    return root, names


def test_cli_outputs_match_jax(cli_runs):
    root, names = cli_runs
    rj, rt = os.path.join(root, "result_jax"), os.path.join(root, "result_torch")
    name = names[0]
    for suffix in (".png", ".png.res.png", ".png.giv.png"):
        a = jio.load_image01(os.path.join(rj, name + suffix))
        b = tio.load_image01(os.path.join(rt, name + suffix))
        assert a.shape == b.shape == (128, 256)
        d = np.abs(np.round(a * 65535).astype(np.int64)
                   - np.round(b * 65535).astype(np.int64))
        # f32 rounding of the two frameworks moves a u16 truncation by <= 2
        assert d.max() <= 2, (suffix, d.max())
    keys_j, vals_j = _aligned(os.path.join(rj, name + ".aligned.txt"))
    keys_t, vals_t = _aligned(os.path.join(rt, name + ".aligned.txt"))
    assert keys_t == keys_j
    # 1e-4 relative; the file prints six decimals, so also 2e-6 absolute
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-4, atol=2e-6)
    # the fused result beats the artifacted baseline (the verify skill's bar)
    m = dict(zip(keys_t, vals_t))
    assert m["mse_result"] < m["mse_given"]
    with open(os.path.join(rj, "manifest.json")) as fp:
        mj = json.load(fp)
    with open(os.path.join(rt, "manifest.json")) as fp:
        mt = json.load(fp)
    assert sorted(mt) == sorted(mj)
    for key in ("completed", "skipped", "config"):
        assert mt[key] == mj[key]
    assert [q["name"] for q in mt["quarantined"]] == \
        [q["name"] for q in mj["quarantined"]] == [names[1]]


def test_cli_resume_skips(cli_runs, capsys):
    root, names = cli_runs
    capsys.readouterr()
    assert tcli.main(_argv(root, "result_torch", "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "0/2 skip!" in out
    assert "1/2 FAILED" in out and "quarantined, continuing" in out
    with open(os.path.join(root, "result_torch", "manifest.json")) as fp:
        m = json.load(fp)
    assert m["skipped"] == [names[0]] and m["completed"] == []


# file mode with stage A on (no --no-extract) at --batch-size 2: stage A
# finds the scene's views and skips, the batched merge runs
_STAGE_A_ON = ("--batch-size", "2")
# flags the file mode now runs: each case runs the CLI with it on the
# verify scene and holds the files to the single run and the JAX CLI's
_RUNS = {"extra0-stage-A": _STAGE_A_ON, "--batch-size": ("--batch-size", "4"),
         "--stream": ("--stream", "on"), "--profile": ("--profile",)}


@pytest.mark.parametrize("extra,needle", [
    pytest.param(_STAGE_A_ON, "--batch-size", id="extra0-stage-A"),
    # the model mode runs (tests/test_torch_e2e.py), its int8 perspective
    # graph too; the file mode refuses the flag with JAX's message
    pytest.param(("--persp-int8",), "--persp-int8",
                 id="extra1---persp-ckpt"),
    # a model-mode flag without --persp-ckpt
    (("--baseline-ckpt", "b.npz"), "--baseline-ckpt"),
    (("--latency",), "--latency"),
    (("--batch-size", "4"), "--batch-size"),
    (("--stream", "on"), "--stream"),
    (("--profile",), "--profile"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, request, extra, needle):
    """What is not ported is refused by name.  The batched merge (with
    stage A on and off), ``--stream on`` and ``--profile``, ported since,
    run on the verify scene: each output equals the single run's (the CPU
    divides k / 65535 alike on both paths) and is within 2 u16 of the JAX
    CLI's, the baseline-less panorama is quarantined, and ``--profile``
    records a registration time."""
    case = request.node.callspec.id
    if _RUNS.get(case if case in _RUNS else needle) == extra:
        root, names = request.getfixturevalue("cli_runs")
        result = os.path.join(root, "result_" + case.replace("-", "_"))
        argv = _argv(root, result, "--device", "cpu", *extra)
        if extra == _STAGE_A_ON:
            argv.remove("--no-extract")
        assert tcli.main(argv) == 0
        for suffix in (".png", ".png.res.png", ".png.giv.png"):
            got = tio.read_png(os.path.join(result, names[0] + suffix))
            single = tio.read_png(os.path.join(root, "result_torch",
                                               names[0] + suffix))
            want = jio.load_image01(os.path.join(root, "result_jax",
                                                 names[0] + suffix))
            np.testing.assert_array_equal(got, single)
            d = np.abs(got.astype(np.int64)
                       - np.round(want * 65535).astype(np.int64))
            assert d.max() <= 2, (suffix, d.max())
        with open(os.path.join(result, "manifest.json")) as fp:
            m = json.load(fp)
        assert m["completed"] == [names[0]]
        assert [q["name"] for q in m["quarantined"]] == [names[1]]
        assert len(m["time_reg_ms"]) == (needle == "--profile")
        return
    argv = ["0", str(tmp_path), str(tmp_path), str(tmp_path), str(tmp_path),
            "--device", "cpu"]
    if extra != _STAGE_A_ON:
        argv.append("--no-extract")
    with pytest.raises(SystemExit) as e:
        tcli.main(argv + list(extra))
    msg = str(e.value.code)
    assert needle in msg and ("not ported" in msg or "model mode only" in msg)
    if needle in ("--persp-int8", "--latency"):
        # JAX's model-mode message (panodepth/cli.py:178-180); the file
        # mode has no view-parallel graph
        assert msg.endswith(f"{needle} applies to the on-device model "
                            "mode only; pass --persp-ckpt")


def test_cli_cuda_without_card_raises(cli_runs, monkeypatch):
    root, _ = cli_runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(_argv(root, "result_cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipeline.merge_arrays(np.zeros((4, 8)), np.zeros((1, 4, 4)), None)


def test_cli_kernel_on_cpu_raises(cli_runs):
    root, _ = cli_runs
    with pytest.raises(TypeError, match="CUDA tensor"):
        tcli.main(_argv(root, "result_kernel_cpu", "--device", "cpu",
                        "--jacobi", "kernel"))


def _same_outputs(root, result, names, ref="result_torch"):
    for suffix in (".png", ".png.res.png", ".png.giv.png"):
        np.testing.assert_array_equal(
            tio.read_png(os.path.join(root, result, names[0] + suffix)),
            tio.read_png(os.path.join(root, ref, names[0] + suffix)))


def test_cli_trace_writes_a_trace_and_same_outputs(cli_runs, capsys):
    root, names = cli_runs
    trace = os.path.join(root, "trace")
    assert tcli.main(_argv(root, "result_trace", "--device", "cpu",
                           "--trace", trace)) == 0
    assert "profiler trace written to" in capsys.readouterr().out
    files = os.listdir(trace)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(trace, files[0])) as fp:
        events = json.load(fp)["traceEvents"]
    assert any("register" in str(e.get("name", "")) or
               "aten::" in str(e.get("name", "")) for e in events)
    _same_outputs(root, "result_trace", names)


def test_cli_debug_nans_clean_run_bit_equal(cli_runs, capsys):
    root, names = cli_runs
    for extra, result in ((("--debug-nans",), "result_nans"),
                          (("--debug-nans", "--batch-size", "2"),
                           "result_nans_b2")):
        assert tcli.main(_argv(root, result, "--device", "cpu",
                               *extra)) == 0
        assert "run eagerly" in capsys.readouterr().out
        _same_outputs(root, result, names)
    from panodepth_torch import debug

    assert not debug.nans_on()  # the switch ends with the run


def _nan_view_scene(root, names):
    """The verify scene with the views of the first panorama as PFM files
    (depth in metres, ``load_pfm01`` divides by 10), one holding a NaN
    patch where registration samples it."""
    _write_verify_scene(root, names)
    lt = three_fold()
    for v in range(lt.num_views):
        png = os.path.join(root, "views", f"{names[0]}.{lt.view_tag(v)}.png")
        depth = jio.load_image01(png) * 10.0
        if v == 1:
            depth[40:70, 40:90] = np.nan
        tio.save_pfm(png[:-4] + ".pfm", depth)


def test_cli_debug_nans_names_the_stage(tmp_path):
    """A NaN view: the port's CLI exits non-zero with FloatingPointError
    naming the stage and the panorama; without the flag it runs to its end.
    JAX's CLI with its flag aborts on the same input too (jax_debug_nans),
    in a fresh process: JAX reads the flag when it compiles, so in a
    process that compiled the same merge before, it runs unchecked (ROADMAP,
    "Pinned by tests"), where the port checks every call."""
    root = str(tmp_path)
    names = ["pano_0001", "pano_0002"]
    _nan_view_scene(root, names)
    argv = lambda result, *x: _argv(root, result, "--pmap-ext", ".pfm",
                                    "--limit", "1", *x)
    with pytest.raises(FloatingPointError,
                       match="registration result of panorama pano_0001"):
        tcli.main(argv("result_t", "--device", "cpu", "--debug-nans"))
    assert not os.path.exists(os.path.join(root, "result_t",
                                           names[0] + ".png"))
    assert tcli.main(argv("result_t2", "--device", "cpu")) == 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    err = {}
    for pkg, extra in (("panodepth_torch", ("--device", "cpu")),
                       ("panodepth", ("--platform", "cpu"))):
        proc = subprocess.run(
            [sys.executable, "-m", pkg,
             *argv("result_" + pkg, *extra, "--debug-nans")],
            cwd=repo, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu"))
        assert proc.returncode != 0, (pkg, proc.stdout[-2000:])
        assert "FloatingPointError" in proc.stderr, (pkg, proc.stderr[-2000:])
        err[pkg] = proc.stderr
    assert "NaN in the registration result of panorama pano_0001" in \
        err["panodepth_torch"]
