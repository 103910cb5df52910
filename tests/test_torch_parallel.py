"""Data parallel over ranks (``panodepth_torch/parallel/mesh.py``) against
one process and against the JAX package's dp mesh
(``panodepth/parallel/mesh.py``, ``build_batched_e2e(mesh=...)``), and the
global batch's loss split over ranks (``models/train.depth_loss``'s
``reduce``) against JAX's ``depth_loss`` on the whole batch.

One pair of ranks (``tests/torch_mh_worker.py dp``, gloo on the CPU) runs
the dp merge (``test2`` at 64, batch 4) and the dp e2e graph (the two-view
layout and tiny nets of tests/test_parallel.py:64-76, one set of weights
in both packages, f32, batch 4); both ranks hold the gathered batch.  Bars: bit-equal to the
port's one-process forms (each panorama's output does not depend on its
batch); against JAX the merge bar, 4 u16 max and 0.5 mean, the cubics
the coefficients define within 2e-4 over each view's values, and the f32
e2e bar, 4 / 0.5.

The loss split runs in this process: two simulated ranks whose
reductions combine the values both ranks passed (a first pass records
them); the real collectives run in tests/test_torch_multihost.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import e2e as je
from panodepth.config import MergeConfig as JaxMergeConfig
from panodepth.config import ViewLayout, register_layout
from panodepth.models import train as jtrain
from panodepth.models.panoramic import PanoBaselineNet as JPano
from panodepth.models.perspective import PerspectiveDepthNet as JPersp
from panodepth.parallel.mesh import batched_merge as jbatched_merge
from panodepth.parallel.mesh import make_mesh as jmake_mesh

import panodepth_torch.config as tconfig
from panodepth_torch import e2e as te
from panodepth_torch import pipeline as tpipeline
from panodepth_torch.models import train as ttrain
from panodepth_torch.models import weights
from panodepth_torch.models.panoramic import PanoBaselineNet as TPano
from panodepth_torch.models.perspective import PerspectiveDepthNet as TPersp
from panodepth_torch.parallel import mesh as tmesh

from test_torch_batched import _stack
from torch_port_common import flax_flat, run_pair
from torch_train_common import port_params_to_jax

torch.set_num_threads(1)

D2R = math.pi / 180.0
MERGE_BAR = (4, 0.5)
ABCD_ATOL = 2e-4
F32_E2E_BAR = (4, 0.5)
# the two-view layout of tests/test_parallel.py:64-71, under a name of its own
FOVS = np.array([(25 * D2R, 175 * D2R, 30 * D2R, 150 * D2R),
                 (185 * D2R, 355 * D2R, 30 * D2R, 150 * D2R)])
RANGES = np.array([(170 * D2R, 30 * D2R, 40 * D2R, 140 * D2R),
                   (350 * D2R, 190 * D2R, 40 * D2R, 140 * D2R)])
register_layout(ViewLayout("torch_e2e_par", fovs=FOVS, ranges=RANGES))
tconfig.layout_from_arrays("torch_e2e_par", FOVS, RANGES)
TINY_PERSP = dict(stage_sizes=(1, 1, 1, 1), widths=(8, 16, 16, 32),
                  decoder_width=16)
TINY_PANO = dict(widths=(8, 16, 16, 32))
E2E_KW = dict(view_width=32, base_w=64)


def _u16_diff(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return int(d.max()), float(d.mean())


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The pair's gathered outputs (both ranks'), the inputs, and JAX's
    tiny nets with their weights."""
    root = tmp_path_factory.mktemp("dp")
    jcfg, tcfg, emaps, pmaps = _stack("test2", 64, 4, seed=5)
    # one set of weights for both packages: drawn by the port's flax
    # initialisers, carried to JAX in flax's layout (models/weights), the
    # tree checked against JAX's own init (a JAX init here costs ~20 s)
    jp = JPersp(dtype=jnp.float32, **TINY_PERSP)
    jb = JPano(dtype=jnp.float32, **TINY_PANO)
    pp = port_params_to_jax(jp, TPersp(dtype=torch.float32, **TINY_PERSP),
                            (1, 32, 32), 0)
    bp = port_params_to_jax(jb, TPano(dtype=torch.float32, **TINY_PANO),
                            (1, 32, 64), 1)
    rgbs = np.random.RandomState(5).rand(4, 64, 128, 3).astype(np.float32)
    lay = tconfig.LAYOUTS["test2"]()
    np.savez(root / "in.npz", emaps=emaps, pmaps=pmaps, rgbs=rgbs,
             test2_fovs=lay.fovs, test2_ranges=lay.ranges,
             torch_e2e_par_fovs=FOVS, torch_e2e_par_ranges=RANGES,
             **{"persp/" + k: v for k, v in flax_flat(pp).items()},
             **{"base/" + k: v for k, v in flax_flat(bp).items()})
    run_pair(lambda port, r: ["tests/torch_mh_worker.py", "dp", str(port),
                              str(r), str(root)])
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in (0, 1)]
    return dict(ranks=ranks, jcfg=jcfg, tcfg=tcfg, emaps=emaps, pmaps=pmaps,
                rgbs=rgbs, jp=jp, jb=jb, pp=pp, bp=bp)


def test_ranks_hold_the_same_gathered_batch(dp):
    r0, r1 = dp["ranks"]
    assert r0["merge"].shape == (4, 32, 64) and r0["merge"].dtype == np.uint16
    assert r0["abcd"].shape == (4, 2, 4)
    assert r0["e2e"].shape == (4, 32, 64) and r0["e2e"].dtype == np.uint16
    for k in ("merge", "abcd", "e2e", "e2e_bases"):
        np.testing.assert_array_equal(r0[k], r1[k])


def test_dp_merge_bit_equal_to_one_process(dp):
    out, abcd = tpipeline.compiled_merge_batched(dp["tcfg"], "auto", "cpu")(
        torch.from_numpy(dp["emaps"]), torch.from_numpy(dp["pmaps"]))
    np.testing.assert_array_equal(dp["ranks"][0]["merge"], out.numpy())
    np.testing.assert_array_equal(dp["ranks"][0]["abcd"], abcd.numpy())


def test_dp_merge_matches_jax_dp_mesh(dp):
    mesh = jmake_mesh((2, 1), devices=jax.devices()[:2])
    j_out, j_abcd = jbatched_merge(dp["jcfg"], mesh)(
        jnp.asarray(dp["emaps"]), jnp.asarray(dp["pmaps"]))
    dmax, dmean = _u16_diff(dp["ranks"][0]["merge"], j_out)
    assert dmax <= MERGE_BAR[0] and dmean <= MERGE_BAR[1], (dmax, dmean)
    # the coefficients as the cubics they define, over each view's values:
    # a cubic fit on depths within ~0.3 of each other is ill-conditioned,
    # and two f32 sum orders of its normal equations move a coefficient by
    # up to 7e-3 (JAX and the port each ~1e-2 off the float64 lstsq of
    # tests/reference_impl.py) while the curves stay within 4e-6
    got, want = dp["ranks"][0]["abcd"], np.asarray(j_abcd)
    for b in range(4):
        for v in range(2):
            pm = dp["pmaps"][b, v]
            x = np.linspace(pm.min(), pm.max(), 256)
            np.testing.assert_allclose(np.polyval(got[b, v], x),
                                       np.polyval(want[b, v], x),
                                       rtol=0, atol=ABCD_ATOL)


def _port_nets(dp):
    persp = weights.load_params(TPersp(dtype=torch.float32, **TINY_PERSP),
                                flax_flat(dp["pp"]))
    base = weights.load_params(TPano(dtype=torch.float32, **TINY_PANO),
                               flax_flat(dp["bp"]))
    return persp.eval().requires_grad_(False), \
        base.eval().requires_grad_(False)


def test_dp_e2e_bit_equal_to_one_process(dp):
    persp, base = _port_nets(dp)
    tcfg = tconfig.MergeConfig(layout_name="torch_e2e_par", out_width=64)
    full, _, _ = te.build_batched_e2e(persp, tcfg, base_model=base,
                                      device="cpu", **E2E_KW)
    out, bases = full(torch.from_numpy(dp["rgbs"]))
    np.testing.assert_array_equal(dp["ranks"][0]["e2e"], out.numpy())
    np.testing.assert_array_equal(dp["ranks"][0]["e2e_bases"], bases.numpy())


def test_dp_e2e_matches_jax_dp_mesh(dp):
    jcfg = JaxMergeConfig(layout_name="torch_e2e_par", out_width=64)
    mesh = jmake_mesh((2, 1), devices=jax.devices()[:2])
    jfull, _, _ = je.build_batched_e2e(dp["jp"], dp["pp"], jcfg, mesh=mesh,
                                       base_model=dp["jb"],
                                       base_params=dp["bp"], **E2E_KW)
    j_out, _ = jfull(jnp.asarray(dp["rgbs"]))
    dmax, dmean = _u16_diff(dp["ranks"][0]["e2e"], j_out)
    assert dmax <= F32_E2E_BAR[0] and dmean <= F32_E2E_BAR[1], (dmax, dmean)


def test_make_mesh_refuses_sp():
    """An sp axis needs as many processes as the mesh has ranks: one process
    here, so ``(1, 2)`` is refused as ``(2, 1)`` is (the four-rank run of
    tests/test_torch_spatial.py builds ``(2, 2)``)."""
    with pytest.raises(ValueError, match=r"mesh \(1, 2\) != 1 processes"):
        tmesh.make_mesh((1, 2), device="cpu")
    with pytest.raises(ValueError, match="processes"):
        tmesh.make_mesh((2, 1), device="cpu")  # one process here
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.dp, mesh.sp, mesh.rank, mesh.backend) == (1, 1, 0, None)
    assert (mesh.dp_index, mesh.sp_index) == (0, 0)
    assert mesh.sp_group.ranks == mesh.dp_group.ranks == (0,)


def test_batch_not_divisible_by_dp_refused():
    """Rank 1 of a two-rank mesh is handed a batch of 3: refused before any
    collective (the mesh is built by hand; no process group here)."""
    _, tcfg, emaps, pmaps = _stack("test2", 64, 3)
    mesh = tmesh.Mesh(dp=2, sp=1, rank=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by the dp"):
        tmesh.batched_merge(tcfg, mesh)(emaps, pmaps)
    assert mesh.rows(4) == slice(2, 4)


# --- the global batch's loss over ranks --------------------------------------


def _halves(seed=7):
    """(pred, target, teacher, mask) of 4 rows: rank 0's two rows with most
    pixels on and small errors, rank 1's with a sparse mask and large ones."""
    rng = np.random.RandomState(seed)
    shape = (4, 32, 48)
    target = (0.1 + 0.8 * rng.rand(*shape)).astype(np.float32)
    scale = np.array([0.05, 0.05, 0.4, 0.4], np.float32)[:, None, None]
    pred = np.clip(target + scale * rng.randn(*shape), 0.01, 1.5
                   ).astype(np.float32)
    # floored away from pred's floor: where pred equals the teacher the
    # error's |.| is at its kink, whose derivative PyTorch and JAX take
    # differently (0 and 1/2 of the two sides), one process as over ranks
    teacher = np.clip(target + 0.1 * rng.randn(*shape), 0.02, 1.2
                      ).astype(np.float32)
    keep = np.array([0.95, 0.95, 0.3, 0.3])[:, None, None]
    mask = rng.rand(*shape) < keep
    return pred, target, teacher, mask


class _TwoRanks:
    """Two ranks' ``reduce`` in one process: record each rank's values in a
    first pass, then answer each call with both ranks' reduction."""

    def __init__(self):
        self.seen = ([], [])
        self.calls = None

    def recording(self, r):
        def reduce(t, op):
            self.seen[r].append(t.detach().clone())
            return t.detach()
        return reduce

    def reducing(self, r):
        calls = iter(range(len(self.seen[r])))

        def reduce(t, op):
            i = next(calls)
            a, b = self.seen[0][i], self.seen[1][i]
            assert torch.equal(self.seen[r][i], t.detach())
            return torch.maximum(a, b) if op == "max" else a + b
        return reduce


def _rank_loss(r, reduce, pred, target, teacher, mask, with_teacher):
    """(pred's rows of rank ``r`` as a leaf, that rank's loss)."""
    rows = slice(2 * r, 2 * r + 2)
    p = torch.tensor(pred[rows], requires_grad=True)
    t, m = torch.tensor(target[rows]), torch.tensor(mask[rows])
    loss = ttrain.depth_loss(p, t, m, reduce=reduce)
    if with_teacher:
        loss = loss + 0.5 * ttrain.depth_loss(
            p, torch.tensor(teacher[rows]), m, reduce=reduce)
    return p, loss


def _port_dp_loss(*inputs):
    """(the ranks' summed loss, its gradient on pred) with two ranks."""
    ranks = _TwoRanks()
    for r in (0, 1):
        _rank_loss(r, ranks.recording(r), *inputs)
    total, grads = 0.0, []
    for r in (0, 1):
        p, loss = _rank_loss(r, ranks.reducing(r), *inputs)
        loss.backward()
        total = total + loss.detach()
        grads.append(p.grad.numpy())
    return float(total), np.concatenate(grads)


def _jax_loss(pred, target, teacher, mask, with_teacher):
    def fn(p):
        loss = jtrain.depth_loss(p, jnp.asarray(target), jnp.asarray(mask))
        if with_teacher:
            loss = loss + 0.5 * jtrain.depth_loss(p, jnp.asarray(teacher),
                                                  jnp.asarray(mask))
        return loss

    loss, grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(pred))
    return float(loss), np.asarray(grad)


@pytest.mark.parametrize("with_teacher", [False, True])
def test_dp_loss_is_the_global_batch_loss(with_teacher):
    pred, target, teacher, mask = _halves()
    loss, grad = _port_dp_loss(pred, target, teacher, mask, with_teacher)
    jloss, jgrad = _jax_loss(pred, target, teacher, mask, with_teacher)
    assert abs(loss - jloss) <= 1e-6 * abs(jloss), (loss, jloss)
    scale = np.abs(jgrad).max()
    assert np.abs(grad - jgrad).max() <= 1e-5 * scale
    # DDP's mean of the ranks' own losses is another function here
    own = [float(_rank_loss(r, None, pred, target, teacher, mask,
                            with_teacher)[1].detach()) for r in (0, 1)]
    assert abs(np.mean(own) - jloss) > 1e-4, (own, jloss)


def test_dp_loss_rank_parts_differ_in_threshold():
    """The halves' own BerHu thresholds differ (rank 1's errors are the
    larger), so a rank alone would take another threshold than the
    global batch's; with ``reduce`` both take the batch's largest error."""
    pred, target, _, mask = _halves()
    err = np.where(mask, np.abs(pred - target), 0)
    assert err[2:].max() > 2 * err[:2].max()
    ranks = _TwoRanks()
    for r in (0, 1):
        rows = slice(2 * r, 2 * r + 2)
        ttrain.berhu_loss(torch.tensor(pred[rows]), torch.tensor(
            target[rows]), torch.tensor(mask[rows]), ranks.recording(r))
    got = ranks.reducing(0)(ranks.seen[0][0], "max")
    assert float(got) == pytest.approx(float(err.max()), rel=1e-7)
