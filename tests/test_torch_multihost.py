"""Multi-process data parallel training (``panodepth_torch/parallel/
multihost.py``, ``models/train.shard_train_step``, ``train_cli
--coordinator/--num-processes/--process-id``) in two real processes on the
CPU (gloo), against the JAX package's bars (tests/test_multihost.py):

* two data-parallel steps of the tiny perspective net: losses and
  parameters bit-equal across the ranks; against JAX's
  ``shard_train_step`` on a two-device mesh with the same weights and
  global batches (whose halves carry different masks), losses within
  1e-5 and parameters within rtol 1e-2, atol 1e-4 (JAX's own bar: AdamW
  amplifies the reduction order's noise on near-zero gradients);
* the store: first writer wins, an absent key reads None, and every key
  and barrier is a no-op without ``initialize``;
* the CLI across two processes: only rank 0 logs ``[train] done``, and
  its export loads through ``e2e.load_model_checkpoint`` and runs;
* the preemption drain: SIGTERM to one rank, both drain to the agreed
  step, checkpoint together and exit 0;
* a rank whose partner never comes fails at the timeout.
"""

import os
import re
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth.models import train as jtrain
from panodepth.models.perspective import PerspectiveDepthNet as JPersp
from panodepth.parallel.mesh import make_mesh as jmake_mesh

from panodepth_torch.models import weights
from panodepth_torch.models.perspective import PerspectiveDepthNet as TPersp
from panodepth_torch.parallel import multihost as mh

from torch_port_common import PAIR_TIMEOUT, free_port, run_pair, spawn
from torch_train_common import flax_flat_any, port_params_to_jax

torch.set_num_threads(1)

TINY = dict(stage_sizes=(1, 1, 1, 1), widths=(8, 16, 16, 32),
            decoder_width=16)
SEED = 11
CLI_SMALL = ["--synth", "--batch-size", "4", "--view-size", "64",
             "--width-scale", "0.125", "--device", "cpu", "--log-every", "1"]


def _global_batches():
    """Two global batches of 4 rows; each rank's half has a mask of its
    own density, so the global normalisers differ from each half's."""
    rng = np.random.RandomState(1000)
    out = {}
    for s in range(2):
        out[f"rgb{s}"] = rng.rand(4, 32, 32, 3).astype(np.float32)
        out[f"depth{s}"] = (0.05 + 0.9 * rng.rand(4, 32, 32)).astype(
            np.float32)
        keep = np.array([0.9, 0.9, 0.5, 0.5])[:, None, None]
        out[f"mask{s}"] = rng.rand(4, 32, 32) < keep
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh_train")
    batches = _global_batches()
    np.savez(root / "in.npz", seed=SEED, **batches)
    run_pair(lambda port, r: ["tests/torch_mh_worker.py", "train", str(port),
                              str(r), str(root)])
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in (0, 1)]
    return ranks, batches


def test_process_shard_roundrobin():
    items = list(range(10))
    a, b, c = (mh.process_shard(items, i, 3) for i in range(3))
    assert a == [0, 3, 6, 9] and b == [1, 4, 7] and c == [2, 5, 8]
    assert sorted(a + b + c) == items
    with pytest.raises(ValueError):
        mh.process_shard(items, 3, 3)


def test_store_and_collectives_without_initialize():
    """One process: no store, no group; the keys read None, the barrier and
    the setter do nothing, the host copy is a copy."""
    assert not mh.initialized()
    mh.kv_set_once("panodepth/none", "x")
    assert mh.kv_try_get("panodepth/none") is None
    mh.barrier("nothing")
    t = torch.arange(3.0)
    host = mh.fetch_replicated({"a": t, "n": 2})
    assert torch.equal(host["a"], t) and host["n"] == 2
    assert mh.all_reduce([t])[0] is t


def test_two_process_steps_equal_across_ranks(trained):
    (r0, r1), _ = trained
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    keys = [k for k in r0 if k.startswith("param/")]
    assert keys and int(r0["step"]) == int(r1["step"]) == 2
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k])


def test_two_process_steps_match_jax_sharded_step(trained):
    (r0, _), batches = trained
    jmodel = JPersp(dtype=jnp.float32, **TINY)
    jparams = port_params_to_jax(jmodel, TPersp(dtype=torch.float32, **TINY),
                                 (1, 32, 32), SEED)
    tx = jtrain.make_optimizer(lr=1e-3)
    state = jtrain.TrainState(params=jparams, opt_state=tx.init(jparams),
                              step=jnp.zeros((), jnp.int32))
    mesh = jmake_mesh((2, 1), devices=jax.devices()[:2])
    step = jtrain.shard_train_step(jtrain.make_train_step(jmodel, tx), mesh,
                                   "dp")
    losses = []
    for s in range(2):
        batch = tuple(jnp.asarray(batches[f"{k}{s}"])
                      for k in ("rgb", "depth", "mask"))
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    want = flax_flat_any(state.params)
    got = {weights.flax_key(k[len("param/"):]): weights.to_flax_layout(
        k[len("param/"):], v) for k, v in r0.items() if k.startswith("param/")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, atol=1e-4,
                                   err_msg=k)


def test_store_first_writer_wins(trained):
    (r0, r1), _ = trained
    assert str(r0["kv"]) == str(r1["kv"]) == "rank0"
    assert str(r0["kv_absent"]) == str(r1["kv_absent"]) == "None"


def _cli(port, rank, ckpt, *extra):
    return ["-m", "panodepth_torch.train_cli", "perspective", "x", "y",
            str(ckpt), *CLI_SMALL, "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(rank), *extra]


def test_train_cli_two_processes(tmp_path):
    from panodepth_torch.e2e import load_model_checkpoint

    ck = tmp_path / "ck"
    outs = run_pair(lambda port, r: _cli(port, r, ck, "--steps", "2"))
    assert "[train] done" in outs[0]
    assert "[train] done" not in outs[1]  # rank 1 stays quiet
    assert "backend gloo" in outs[0] and "backend gloo" in outs[1]
    assert "the state agrees over the 2 processes" in outs[0]
    assert (ck / "perspective.config.json").exists()
    model, _ = load_model_checkpoint(str(ck / "perspective_final.params.npz"),
                                     device="cpu")
    with torch.no_grad():
        out = model(torch.zeros((1, 64, 64, 3)))
    assert out.shape == (1, 64, 64) and bool(torch.isfinite(out).all())


def test_preemption_drain_two_process(tmp_path):
    """SIGTERM to one rank of two: the stop step is agreed through the
    store, both ranks step through it, checkpoint together and exit 0."""
    ck = tmp_path / "ck"
    for attempt in range(2):  # a port taken in between is picked again
        port = free_port()
        logs = [tmp_path / f"p{r}.{attempt}.log" for r in (0, 1)]
        fps = [open(f, "w") for f in logs]
        procs = [spawn(_cli(port, r, ck, "--steps", "500", "--ckpt-every",
                            "100000"), out=fp) for r, fp in enumerate(fps)]
        try:
            deadline = time.monotonic() + PAIR_TIMEOUT
            while "step 2 " not in logs[0].read_text():
                assert time.monotonic() < deadline, logs[0].read_text()
                if any(p.poll() is not None for p in procs):
                    break
                time.sleep(0.5)
            else:
                procs[0].send_signal(signal.SIGTERM)  # one rank only
            rcs = [p.wait(timeout=PAIR_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for fp in fps:
                fp.close()
        out0, out1 = (f.read_text() for f in logs)
        if attempt == 0 and "address already in use" in (out0 + out1).lower():
            continue
        break
    assert rcs == [0, 0], (out0[-2000:], out1[-2000:])
    m = re.search(r"draining to collectively agreed step (\d+)", out0)
    assert m, out0[-3000:]
    stop_at = int(m.group(1))
    assert "collective checkpoint at step" in out0, out0[-2000:]
    assert (ck / f"perspective_{stop_at}").is_dir()
    assert not (ck / "perspective_final.params.npz").exists()


def test_partner_never_arrives_fails_at_timeout(tmp_path):
    t0 = time.monotonic()
    proc = spawn(["tests/torch_mh_worker.py", "alone", str(free_port()),
                  str(tmp_path)])
    try:
        out = proc.communicate(timeout=PAIR_TIMEOUT)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0, out[-2000:]
    assert time.monotonic() - t0 < 60
