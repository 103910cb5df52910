"""``python -m panodepth_torch.train_cli`` on the CPU at --width-scale 0.125:
a run per input kind (the perspective and the panoramic nets), on
procedural scenes and on files with --augment --corrupt, writes the
sidecar and the params-only export, which the JAX package loads
(``load_params_npz``, ``e2e.load_model_checkpoint``) and runs to the
port's output; the file runs' holdout (JAX's lines and counts on the same
folder, sticky on --resume), --trace, --debug-nans, --resume, --init-from a
JAX-written export, --ema, SIGTERM, and the refusals.

Bars: JAX's forward on the port's export against the port's forward on
the same export, of the output's largest magnitude (at least 1): the
loaded bf16 nets 2^-6 (tests/test_torch_families.py's bf16 bar; each op
rounds to bf16, and XLA keeps some chains in f32 where PyTorch rounds each
op; measured 1.3e-2 on FastPanoNet after three steps), the same weights
computing in f32 1e-5.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.e2e import load_model_checkpoint as jload
from panodepth.models import train as jtrain

from panodepth_torch import train_cli
from panodepth_torch.e2e import load_model_checkpoint as tload
from panodepth_torch.models import train as ttrain
from panodepth_torch.models import weights

from torch_train_common import nest

torch.set_num_threads(1)

BF16_REL = 2.0 ** -6
F32_REL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width-scale", "0.125", "--batch-size", "2", "--pano-width", "64",
         "--view-size", "64", "--device", "cpu", "--log-every", "1"]


def _run(model, ckpt, *extra):
    return train_cli.main([model, "x", "x", str(ckpt), "--synth", *SMALL,
                           *extra])


def _check_exports(ckpt, model, variant, bf16=True):
    """The run's sidecar and exports: JAX's ``load_model_checkpoint`` reads
    the export and runs it to the port's output (the loaded bf16 nets unless
    ``bf16`` is False, then the same weights computing in f32), and JAX's
    ``load_params_npz`` takes the same leaves."""
    with open(os.path.join(ckpt, f"{model}.config.json")) as fp:
        arch = json.load(fp)
    assert arch["model"] == model and arch["width_scale"] == 0.125
    assert arch["variant"] == variant
    npz = os.path.join(ckpt, f"{model}_final.params.npz")
    assert os.path.isdir(os.path.join(ckpt, f"{model}_final"))
    jmodel, jparams, jarch = jload(npz)
    assert jarch == arch
    tmodel, _ = tload(npz, device="cpu")
    shape = (2, 64, 64) if model == "perspective" else (2, 32, 64)
    rgb = np.random.RandomState(1).rand(*shape, 3).astype(np.float32)
    runs = [(jmodel, tmodel, BF16_REL)] if bf16 else []
    runs.append((jmodel.clone(dtype=jnp.float32),
                 weights.build_model(arch, dtype=torch.float32), F32_REL))
    for jm, tm, rel in runs:
        if rel == F32_REL:
            ttrain.load_params_npz(npz, tm)
        want = np.asarray(jax.jit(jm.apply)(jparams, jnp.asarray(rgb)))
        with torch.no_grad():
            got = tm(torch.from_numpy(rgb)).float().numpy()
        tol = rel * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    template = jax.tree.map(jnp.zeros_like, jparams)
    again = jtrain.load_params_npz(npz, template)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return arch


@pytest.mark.parametrize("model,variant", [("perspective", "nf"),
                                           ("fastpano", "gn")])
def test_run_writes_exports_jax_loads(tmp_path, model, variant, capsys):
    assert _run(model, tmp_path, "--steps", "3", "--variant", variant,
                "--synth-version", "mix") == 0
    out = capsys.readouterr().out
    assert "step 2 loss" in out
    _check_exports(str(tmp_path), model, variant)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """16 procedural scenes (mix) at 64x32 as rgb/synth_NNNN.jpg (quality
    95) and gt/synth_NNNN.png, written by the port's writer."""
    from panodepth_torch import synth

    root = str(tmp_path_factory.mktemp("files"))
    synth.write_dataset(root, 16, width=64, version="mix", device="cpu",
                        log=lambda *a: None)
    return os.path.join(root, "rgb"), os.path.join(root, "gt")


def _run_files(model, files, ckpt, *extra):
    return train_cli.main([model, *files, str(ckpt), *SMALL, *extra])


@pytest.mark.parametrize("model,variant", [("perspective", "nf"),
                                           ("fastpano", "gn")])
def test_file_run_augment_corrupt_exports_jax_loads(files, tmp_path, model,
                                                    variant, capsys):
    assert _run_files(model, files, tmp_path, "--steps", "3", "--variant",
                      variant, "--augment", "--corrupt", "--corrupt-prob",
                      "0.5") == 0
    out = capsys.readouterr().out
    assert "[train] 16 pairs/host" in out and "step 2 loss" in out
    # the weights held in f32 (1e-5); the bf16 nets' gap depends on the
    # weights' roundings and is held on the procedural runs above (on these
    # weights FastPanoNet's reached 2.2e-2, over 2^-6 on 5 of 4096 outputs)
    arch = _check_exports(str(tmp_path), model, variant, bf16=False)
    assert arch["eval_holdout"] is False


def _refused_after_the_split(main, argv, capsys):
    """Run ``main`` with a --corrupt input size that is no multiple of 16:
    both CLIs refuse it right after the pair discovery and the split, so
    their lines up to there are read without a train step.  Returns (the
    refusal, the [train] lines)."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    out = capsys.readouterr().out
    return str(e.value), [line for line in out.splitlines()
                          if line.startswith("[train]")]


def test_holdout_and_corrupt_refusal_equal_jax(files, tmp_path, capsys):
    """Every 10th pair held out, on the same folder as JAX's CLI: the same
    lines and counts ("holding out 2 pairs", "14 pairs/host"); --corrupt at
    a width that is no multiple of 16 refused with JAX's message."""
    from panodepth import train_cli as jcli

    # batch 8: JAX's CLI shards a batch over the test process's 8 CPU
    # devices
    argv = ["fastpano", *files, str(tmp_path), "--eval-every", "2",
            "--batch-size", "8", "--corrupt", "--pano-width", "72"]
    jmsg, jlines = _refused_after_the_split(
        jcli.main, argv + ["--platform", "cpu"], capsys)
    tmsg, tlines = _refused_after_the_split(
        train_cli.main, argv + ["--device", "cpu"], capsys)
    assert tmsg == jmsg and "multiple of 16" in tmsg and "got 72" in tmsg
    assert jlines[0] == tlines[0] == \
        "[train] holding out 2 pairs for --eval-every validation"
    # the device part of the second line differs: JAX counts devices
    assert jlines[1].startswith("[train] 14 pairs/host, 1 process(es), ")
    assert tlines[1] == "[train] 14 pairs/host, 1 process(es), device cpu"
    assert not os.listdir(tmp_path)


def test_holdout_validates_and_stays_on_resume(files, tmp_path, capsys):
    """A run with --eval-every scores the held-out pairs and records the
    split; --resume without --eval-every keeps it (the port's sidecar, read
    by the port and by JAX's CLI alike)."""
    from panodepth import train_cli as jcli

    assert _run_files("fastpano", files, tmp_path, "--steps", "2",
                      "--eval-every", "2", "--augment", "--corrupt") == 0
    out = capsys.readouterr().out
    assert "holding out 2 pairs" in out and "14 pairs/host" in out
    val = [line for line in out.splitlines() if "step 1 val" in line]
    assert len(val) == 1 and np.isfinite(float(val[0].split()[-1]))
    with open(tmp_path / "fastpano.config.json") as fp:
        assert json.load(fp)["eval_holdout"] is True
    assert _run_files("fastpano", files, tmp_path, "--steps", "3",
                      "--resume") == 0
    out = capsys.readouterr().out
    assert "maintaining the validation holdout" in out
    assert "14 pairs/host" in out and "at step 2" in out
    with open(tmp_path / "fastpano.config.json") as fp:
        assert json.load(fp)["eval_holdout"] is True
    # JAX's CLI reads the same sidecar the same way
    argv = ["fastpano", *files, str(tmp_path), "--batch-size", "8",
            "--corrupt", "--pano-width", "72", "--platform", "cpu"]
    _, jlines = _refused_after_the_split(jcli.main, argv, capsys)
    assert jlines[0].startswith("[train] maintaining the validation holdout")
    assert jlines[1] == "[train] holding out 2 pairs for --eval-every " \
                        "validation"


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    trace = tmp_path / "trace"
    assert _run("fastpano", tmp_path / "a", "--steps", "5", "--trace",
                str(trace)) == 0
    out = capsys.readouterr().out
    assert "profiler trace written to" in out
    files = os.listdir(trace)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(trace / files[0]) as fp:
        names = {e.get("name", "") for e in json.load(fp)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert _run("fastpano", tmp_path / "b", "--steps", "2", "--trace",
                str(tmp_path / "none")) == 0
    out = capsys.readouterr().out
    assert "--trace wrote nothing: tracing starts at step 2" in out
    assert not os.path.exists(tmp_path / "none")


def test_debug_nans(files, tmp_path, capsys):
    """A NaN weight in an --init-from export raises FloatingPointError at
    step 0 naming the weight; a clean run with the flag ends with the
    parameters of a run without it, bit for bit."""
    assert _run_files("fastpano", files, tmp_path / "clean", "--steps",
                      "2", "--augment", "--corrupt") == 0
    assert _run_files("fastpano", files, tmp_path / "nans", "--steps", "2",
                      "--augment", "--corrupt", "--debug-nans") == 0
    assert "[debug-nans]" in capsys.readouterr().out
    a = weights.read_params_npz(
        str(tmp_path / "clean" / "fastpano_final.params.npz"))
    b = weights.read_params_npz(
        str(tmp_path / "nans" / "fastpano_final.params.npz"))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # one NaN weight
    src = str(tmp_path / "clean" / "fastpano_final.params.npz")
    with np.load(src) as z:
        arrays = dict(z)
    key = sorted(arrays)[3]
    flat = arrays[key].reshape(-1).copy()
    flat[0] = np.float32(np.nan).view(np.uint32) >> 16  # a bf16 NaN
    arrays[key] = flat.reshape(arrays[key].shape).astype(arrays[key].dtype)
    bad = str(tmp_path / "bad.params.npz")
    np.savez(bad, **arrays)
    name = next(n for n, _ in weights.build_model(dict(
        model="fastpano", width_scale=0.125)).named_parameters()
        if weights.flax_key(n) == key)
    with pytest.raises(FloatingPointError) as e:
        _run_files("fastpano", files, tmp_path / "bad", "--steps", "2",
                   "--init-from", bad, "--debug-nans")
    msg = str(e.value)
    assert "parameters entering the step" in msg and name in msg
    assert "train step 0" in msg
    from panodepth_torch import debug

    assert not debug.nans_on() and not torch.is_anomaly_enabled()
    # without the flag the NaN goes on unchecked
    assert _run_files("fastpano", files, tmp_path / "bad2", "--steps", "1",
                      "--init-from", bad) == 0


def test_resume_continues_at_the_saved_step(tmp_path, capsys):
    assert _run("fastpano", tmp_path, "--steps", "2") == 0
    capsys.readouterr()
    assert _run("fastpano", tmp_path, "--steps", "4", "--resume") == 0
    out = capsys.readouterr().out
    assert "at step 2" in out and "step 2 loss" in out
    assert "step 0 loss" not in out and "step 1 loss" not in out
    state = ttrain.init_state(weights.build_model(weights.read_arch(
        str(tmp_path / "fastpano_final.params.npz"))),
        ttrain.make_optimizer())
    state = ttrain.restore_checkpoint(str(tmp_path / "fastpano_final"), state)
    assert state.step == 4 and state.opt_state.count == 4


def test_init_from_a_jax_export_and_ema(tmp_path):
    """--init-from takes a .params.npz that JAX's save_params_npz wrote; at
    --lr 0 the run's export is that file's weights; --ema writes the EMA
    export too."""
    from panodepth.models.fastpano import FastPanoNet as JFast

    arch = dict(model="fastpano", width_scale=0.125, pano_width=64)
    tnet = weights.build_model(arch)
    from panodepth_torch.models import layers

    layers.init_params(tnet, torch.Generator().manual_seed(4))
    flat = {weights.flax_key(k): weights.to_flax_layout(
        k, v.detach().numpy().copy()) for k, v in tnet.named_parameters()}
    src = str(tmp_path / "jax_fastpano.params.npz")
    jm = JFast(widths=(8, 12, 24, 48), decoder_width=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 64, 3)))
    tree = nest(flat)
    assert jax.tree.structure(shapes) == jax.tree.structure(tree)
    jtrain.save_params_npz(src, tree)
    out = tmp_path / "run"
    assert _run("fastpano", out, "--steps", "2", "--lr", "0",
                "--init-from", src, "--ema", "0.5") == 0
    want = weights.read_params_npz(src)
    for name in ("fastpano_final.params.npz",
                 "fastpano_final.ema.params.npz"):
        got = weights.read_params_npz(str(out / name))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_sigterm_checkpoints_and_exits_0(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "panodepth_torch.train_cli", "fastpano", "x",
         "x", str(tmp_path), "--synth", *SMALL, "--steps", "100000"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        for line in proc.stdout:
            if "step 1 loss" in line:
                proc.send_signal(signal.SIGTERM)
                break
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, rest
    assert "SIGTERM: checkpointed" in rest
    tags = [p.name for p in tmp_path.iterdir() if p.name.startswith(
        "fastpano_") and p.is_dir()]
    assert len(tags) == 1 and tags[0][len("fastpano_"):].isdigit()
    assert not (tmp_path / "fastpano_final.params.npz").exists()


@pytest.mark.parametrize("flags,what", [
    ([], "no (rgb, gt) pairs found"),
    (["--synth", "--coordinator", "h:1"],
     "--coordinator given without --num-processes, --process-id"),
    (["--synth", "--num-processes", "2"],
     "--num-processes given without --coordinator, --process-id"),
    (["--synth", "--process-id", "0"],
     "--process-id given without --coordinator, --num-processes"),
    (["--synth", "--coordinator", "h:1", "--num-processes", "2",
      "--process-id", "2"], "--process-id 2 outside [0, 2)"),
    (["--synth", "--coordinator", "h:1", "--num-processes", "3",
      "--process-id", "0", "--batch-size", "8"],
     "must be divisible by the process count (3)"),
    (["--synth", "--variant", "nf"], "--variant nf"),
    (["--synth", "--resume", "--init-from", "x.npz"], "exclusive"),
])
def test_refusals(tmp_path, flags, what):
    """What is refused, before anything is written; without --synth, empty
    folders hold no pairs, as JAX's CLI says; the multi-process flags
    only as a set."""
    model = "fastpano"
    empty = tmp_path / "empty"
    empty.mkdir()
    ckpt = tmp_path / "ckpt"
    with pytest.raises(SystemExit) as e:
        train_cli.main([model, str(empty), str(empty), str(ckpt), "--device",
                        "cpu", *flags])
    assert what in str(e.value)
    assert not ckpt.exists()
    assert not ckpt.exists()
