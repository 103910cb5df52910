"""One rank of a two-process ``torch.distributed`` run of panodepth_torch on
the CPU (gloo).

Spawned by ``tests/test_torch_parallel.py`` and
``tests/test_torch_multihost.py`` (not collected by pytest); it imports
neither JAX nor the JAX package.  Modes:

    torch_mh_worker.py dp PORT RANK DIR     -- the dp merge and e2e graph
    torch_mh_worker.py train PORT RANK DIR  -- two data-parallel steps and
                                               the store's keys
    torch_mh_worker.py alone PORT DIR       -- rank 0 of 2, whose partner
                                               never comes (it must fail)

Inputs come from ``DIR/in.npz`` (written by the test); each rank writes
``DIR/rank{RANK}.npz``.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from panodepth_torch import config as tconfig  # noqa: E402
from panodepth_torch.parallel import mesh as pmesh  # noqa: E402
from panodepth_torch.parallel import multihost as mh  # noqa: E402

torch.set_num_threads(1)
NPROC = 2
# the tiny perspective net of tests/test_multihost.py and test_parallel.py
TINY_PERSP = dict(stage_sizes=(1, 1, 1, 1), widths=(8, 16, 16, 32),
                  decoder_width=16)
TINY_PANO = dict(widths=(8, 16, 16, 32))


def _layout(z, name):
    if name not in tconfig.LAYOUTS:
        tconfig.layout_from_arrays(name, z[name + "_fovs"],
                                   z[name + "_ranges"])


def _flat(z, prefix):
    """{flax path: array} of the leaves saved under ``prefix``."""
    return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}


def dp(z, out):
    """The dp merge at ``test2`` and the dp e2e graph at the two-view
    layout with the tiny nets (the test's weights, in flax's layout), on
    the global batches of ``in.npz``."""
    from panodepth_torch.e2e import build_batched_e2e
    from panodepth_torch.models import weights
    from panodepth_torch.models.panoramic import PanoBaselineNet
    from panodepth_torch.models.perspective import PerspectiveDepthNet

    mesh = pmesh.make_mesh()
    assert (mesh.dp, mesh.sp, mesh.rank) == (NPROC, 1, mh.rank())
    _layout(z, "test2")
    cfg = tconfig.MergeConfig(layout_name="test2", out_width=64)
    merged, abcd = pmesh.batched_merge(cfg, mesh)(z["emaps"], z["pmaps"])
    out.update(merge=merged.numpy(), abcd=abcd.numpy())

    _layout(z, "torch_e2e_par")
    ecfg = tconfig.MergeConfig(layout_name="torch_e2e_par", out_width=64)
    persp = weights.load_params(PerspectiveDepthNet(
        dtype=torch.float32, **TINY_PERSP), _flat(z, "persp/"))
    base = weights.load_params(PanoBaselineNet(
        dtype=torch.float32, **TINY_PANO), _flat(z, "base/"))
    full, _, _ = build_batched_e2e(
        persp.eval().requires_grad_(False), ecfg, view_width=32,
        base_model=base.eval().requires_grad_(False), base_w=64, mesh=mesh)
    e2e, bases = full(torch.from_numpy(z["rgbs"]))
    out.update(e2e=e2e.numpy(), e2e_bases=bases.numpy())


def train(z, out):
    """Two steps of the tiny perspective net (f32), data parallel over the
    two ranks, on the global batches of ``in.npz`` (4 rows, 2 a rank);
    then the store's keys."""
    from panodepth_torch.models import layers, train as ptrain
    from panodepth_torch.models.perspective import PerspectiveDepthNet

    mesh = pmesh.make_mesh()
    model = PerspectiveDepthNet(dtype=torch.float32, **TINY_PERSP)
    layers.init_params(model, torch.Generator().manual_seed(int(z["seed"])))
    if mesh.rank == 1:  # replicate must undo this
        with torch.no_grad():
            next(model.parameters()).add_(1.0)
    tx = ptrain.make_optimizer(lr=1e-3)
    state = mh.replicate(mesh, ptrain.init_state(model.train(), tx))
    step = ptrain.shard_train_step(ptrain.make_train_step(model, tx), mesh)
    losses = []
    for s in range(2):
        batch = tuple(mh.global_batch(mesh, z[f"{k}{s}"][mesh.rows(4)])
                      for k in ("rgb", "depth", "mask"))
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    host = mh.fetch_replicated(state)
    out.update(losses=np.asarray(losses), step=host.step, **{
        "param/" + k: v.numpy() for k, v in host.params.items()})

    # the store: rank 0 writes first, rank 1's later write loses
    if mesh.rank == 0:
        mh.kv_set_once("test/first", "rank0")
    mh.barrier("kv-written")
    if mesh.rank == 1:
        mh.kv_set_once("test/first", "rank1")
    mh.barrier("kv-raced")
    out.update(kv=mh.kv_try_get("test/first"),
               kv_absent=str(mh.kv_try_get("test/absent")))


def main() -> int:
    mode = sys.argv[1]
    if mode == "alone":
        port, root = sys.argv[2], sys.argv[3]
        mh.initialize(f"127.0.0.1:{port}", NPROC, 0, device="cpu",
                      timeout_s=float(os.environ.get("MH_TIMEOUT_S", 5)))
        return 0  # not reached: the partner never comes
    port, rank, root = sys.argv[2], int(sys.argv[3]), sys.argv[4]
    mh.initialize(f"127.0.0.1:{port}", NPROC, rank, device="cpu")
    z = np.load(os.path.join(root, "in.npz"))
    out = {}
    {"dp": dp, "train": train}[mode](z, out)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    mh.barrier("worker-done")
    mh.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
