"""One rank of a multi-process ``torch.distributed`` run of panodepth_torch
on the CPU (gloo).

Spawned by ``tests/test_torch_parallel.py``, ``test_torch_multihost.py``,
``test_torch_spatial.py`` and ``test_torch_latency.py`` (not collected by
pytest); it imports neither JAX nor the JAX package.  Modes:

    torch_mh_worker.py dp PORT RANK DIR     -- the dp merge and e2e graph
    torch_mh_worker.py train PORT RANK DIR  -- two data-parallel steps and
                                               the store's keys
    torch_mh_worker.py spatial PORT RANK DIR NPROC
                                            -- the width-sharded Jacobi,
                                               fuse_spatial and a (2, 2)
                                               merge mesh (NPROC = 4)
    torch_mh_worker.py latency PORT RANK DIR
                                            -- the view-parallel graph and
                                               its driver
    torch_mh_worker.py alone PORT DIR       -- rank 0 of 2, whose partner
                                               never comes (it must fail)

NPROC is the number of ranks (default 2).  Inputs come from
``DIR/in.npz`` (written by the test); each rank writes
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
NPROC = 2  # the ranks of a run unless the command line names another count
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


# the halos of tests/test_parallel.py:118-174 (7: a remainder block; 100:
# clamped to the shard's width)
HALOS = (1, 2, 5, 7, 30, 100)


def spatial(z, out):
    """``jacobi_spatial`` over the ring of every rank at each of ``HALOS``
    (30 iterations), ``fuse_spatial`` on the tiny scene at halo 1 and 10,
    and the (2, 2) mesh's ``batched_merge`` at ``test2`` 128 wide."""
    from panodepth_torch.fusion import build_fusion_plan
    from panodepth_torch.parallel import spatial as psp

    ring = pmesh.make_mesh((1, NPROC))
    for halo in HALOS:
        k = "a" if halo == 1 else "b"
        buf, tgt, cov = (torch.from_numpy(z[f"jac_{k}_{n}"])
                         for n in ("buf", "tgt", "cov"))
        out[f"jacobi{halo}"] = psp.jacobi_spatial(
            buf, tgt, cov, 30, 0.5, 1e-4, ring, halo=halo).numpy()
    _layout(z, "test2")
    plan = build_fusion_plan(tconfig.MergeConfig(layout_name="test2",
                                                 out_width=64))
    for halo in (1, 10):
        fused, _ = psp.fuse_spatial(
            torch.from_numpy(z["tiny_emap"]), torch.from_numpy(
                z["tiny_pmaps"]), plan, ring, halo=halo)
        out[f"fuse{halo}"] = fused.numpy()

    mesh = pmesh.make_mesh((2, 2))
    out.update(mesh=np.array([mesh.dp, mesh.sp, mesh.rank, mesh.dp_index,
                              mesh.sp_index]),
               dp_group=np.array(mesh.dp_group.ranks),
               sp_group=np.array(mesh.sp_group.ranks))
    cfg = tconfig.MergeConfig(layout_name="test2", out_width=128)
    merged, abcd = pmesh.batched_merge(cfg, mesh)(z["emaps"], z["pmaps"])
    out.update(merge=merged.numpy(), abcd=abcd.numpy())


class StubPersp(torch.nn.Module):
    """tests/test_latency.py's smooth stand-in for the perspective net."""

    def forward(self, x):
        g = x.mean(-1)
        return 0.2 + 0.6 * g + 0.1 * torch.cos(3.0 * g)


class StubBase(torch.nn.Module):
    """tests/test_latency.py's smooth stand-in for the baseline net."""

    def forward(self, x):
        return 0.3 + 0.5 * x.mean(-1)


def latency(z, out):
    """The view-parallel graph over the ranks: the stub nets at halo 1 and
    10 and with a given baseline, the tiny nets (the test's weights), each
    with its debug intermediates; then ``run_batch_e2e(latency=True)``
    twice on the test's files (the second run resumes)."""
    from panodepth_torch.e2e import run_batch_e2e
    from panodepth_torch.models import weights
    from panodepth_torch.models.panoramic import PanoBaselineNet
    from panodepth_torch.models.perspective import PerspectiveDepthNet
    from panodepth_torch.parallel.views import (build_latency_e2e,
                                                make_vp_mesh)

    mesh = make_vp_mesh()
    cfg = tconfig.MergeConfig(out_width=128)
    kw = dict(view_width=32, debug=True)

    def run(name, fn, *args):
        o, abcd, emap, pmaps, targets = fn(*args)
        out.update({f"{name}/out": o.numpy(), f"{name}/abcd": abcd.numpy(),
                    f"{name}/emap": emap.numpy(),
                    f"{name}/pmaps": pmaps.numpy()})
        out.update({f"{name}/target{l}": t.numpy()
                    for l, t in enumerate(targets)})

    for halo in (1, 10):
        run(f"stub{halo}", build_latency_e2e(
            StubPersp(), cfg, mesh, base_model=StubBase(), base_w=64,
            halo=halo, **kw), z["rgb"])
    run("given", build_latency_e2e(StubPersp(), cfg, mesh,
                                   baseline_shape=(32, 64), **kw),
        z["rgb"], z["baseline"])
    persp = weights.load_params(PerspectiveDepthNet(
        dtype=torch.float32, **TINY_PERSP), _flat(z, "persp/"))
    base = weights.load_params(PanoBaselineNet(
        dtype=torch.float32, **TINY_PANO), _flat(z, "base/"))
    run("real", build_latency_e2e(
        persp.eval().requires_grad_(False), cfg, mesh,
        base_model=base.eval().requires_grad_(False), base_w=64, **kw),
        z["rgb"])

    root = str(z["root"])
    _layout(z, "torch_latency_drv")
    dcfg = tconfig.MergeConfig(layout_name="torch_latency_drv", out_width=64)
    logs = []
    drv = dict(cfg=dcfg, baseline_folder=os.path.join(root, "bl"),
               view_width=64, latency=True, device="cpu", log=logs.append)
    args = (os.path.join(root, "rgb"), os.path.join(root, "gt"),
            os.path.join(root, "res_hohonet_lat"),
            os.path.join(root, "ck", "perspective_final.params.npz"))
    mets = run_batch_e2e(*args, latency_halo=4, **drv)
    again = run_batch_e2e(*args, **drv)
    out.update(driver_metrics=np.array([m.mse_result for m in mets]),
               driver_again=len(again), driver_log="\n".join(logs))


def main() -> int:
    global NPROC
    mode = sys.argv[1]
    if mode == "alone":
        port, root = sys.argv[2], sys.argv[3]
        mh.initialize(f"127.0.0.1:{port}", NPROC, 0, device="cpu",
                      timeout_s=float(os.environ.get("MH_TIMEOUT_S", 5)))
        return 0  # not reached: the partner never comes
    port, rank, root = sys.argv[2], int(sys.argv[3]), sys.argv[4]
    if len(sys.argv) > 5:
        NPROC = int(sys.argv[5])
    mh.initialize(f"127.0.0.1:{port}", NPROC, rank, device="cpu")
    z = np.load(os.path.join(root, "in.npz"))
    out = {}
    {"dp": dp, "train": train, "spatial": spatial,
     "latency": latency}[mode](z, out)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    mh.barrier("worker-done")
    mh.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
