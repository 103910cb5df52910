"""``python -m panodepth_torch.train_cli`` on the CPU at --width-scale 0.125:
a run per input kind (the perspective and the panoramic nets) writes the
sidecar and the params-only export, which the JAX package loads
(``load_params_npz``, ``e2e.load_model_checkpoint``) and runs to the
port's output; --resume, --init-from a JAX-written export, --ema, SIGTERM,
and the refusals.

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


@pytest.mark.parametrize("model,variant", [("perspective", "nf"),
                                           ("fastpano", "gn")])
def test_run_writes_exports_jax_loads(tmp_path, model, variant, capsys):
    assert _run(model, tmp_path, "--steps", "3", "--variant", variant,
                "--synth-version", "mix") == 0
    out = capsys.readouterr().out
    assert "step 2 loss" in out
    with open(tmp_path / f"{model}.config.json") as fp:
        arch = json.load(fp)
    assert arch["model"] == model and arch["width_scale"] == 0.125
    assert arch["variant"] == variant
    npz = str(tmp_path / f"{model}_final.params.npz")
    assert os.path.isdir(tmp_path / f"{model}_final")
    jmodel, jparams, jarch = jload(npz)
    assert jarch == arch
    tmodel, _ = tload(npz, device="cpu")
    shape = (2, 64, 64) if model == "perspective" else (2, 32, 64)
    rgb = np.random.RandomState(1).rand(*shape, 3).astype(np.float32)
    # the loaded (bf16) nets, then the same weights computing in f32
    for jm, tm, rel in ((jmodel, tmodel, BF16_REL),
                        (jmodel.clone(dtype=jnp.float32),
                         weights.build_model(arch, dtype=torch.float32),
                         F32_REL)):
        if rel == F32_REL:
            ttrain.load_params_npz(npz, tm)
        want = np.asarray(jax.jit(jm.apply)(jparams, jnp.asarray(rgb)))
        with torch.no_grad():
            got = tm(torch.from_numpy(rgb)).float().numpy()
        tol = rel * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # JAX's load_params_npz into its own template takes the same leaves
    template = jax.tree.map(jnp.zeros_like, jparams)
    again = jtrain.load_params_npz(npz, template)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


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
    ([], "training on files"),
    (["--synth", "--augment"], "--augment"),
    (["--synth", "--corrupt"], "--corrupt"),
    (["--synth", "--corrupt-prob", "0.5"], "--corrupt-prob"),
    (["--synth", "--trace", "t"], "--trace"),
    (["--synth", "--debug-nans"], "--debug-nans"),
    (["--synth", "--coordinator", "h:1"], "--coordinator"),
    (["--synth", "--num-processes", "2"], "--num-processes"),
    (["--synth", "--process-id", "0"], "--process-id"),
    (["--synth", "--variant", "nf"], "--variant nf"),
    (["--synth", "--resume", "--init-from", "x.npz"], "exclusive"),
])
def test_refusals(tmp_path, flags, what):
    model = "fastpano"
    with pytest.raises(SystemExit) as e:
        train_cli.main([model, "x", "x", str(tmp_path), *flags])
    assert what in str(e.value)
    if "ROADMAP" in str(e.value) or not flags:
        assert "ROADMAP Queue 1 item" in str(e.value)
    assert not os.listdir(tmp_path)
