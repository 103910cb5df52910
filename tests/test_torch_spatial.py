"""The width-sharded Jacobi over ranks (``panodepth_torch/parallel/
spatial.py``) and the ``(dp, sp)`` mesh's merge (``parallel/mesh.py``)
against one device and against the JAX package
(tests/test_parallel.py:27-41, :118-188).

Four ranks (``tests/torch_mh_worker.py spatial``, gloo on the CPU) run
once: with two ranks a ring's left and right neighbour are one rank, and
a swapped exchange would not show.  Each check below reads the ranks'
outputs:

* ``jacobi_spatial`` over the ring of four on the (64, 128) inputs of
  tests/test_parallel.py at halo 1, 2, 5, 7 (a remainder block), 30 and
  100 (clamped to the shard's 32 columns): bit-equal to the port's
  one-device ``jacobi_plain``, and within tests/test_torch_fusion.py's
  1e-6 of JAX's ``fusion.jacobi`` (the one-device relaxations of the two
  packages differ by one f32 ulp on 5 and 14 of the 8192 values here:
  the frameworks' CPU code rounds a last bit differently);
* ``fuse_spatial`` on the tiny scene at halo 1 and 10: bit-equal to the
  port's one-device ``fuse`` and to JAX's;
* ``make_mesh((2, 2))``: each rank at ``(r // 2, r % 2)`` with its dp
  column and sp ring; its ``batched_merge`` at ``test2`` 128 wide on a
  batch of 4, within JAX's bar of JAX's merge (at most 1 u16, any
  difference on under 1 % of the pixels; the cubics within 2e-4 over each
  view's values, as tests/test_torch_parallel.py holds them) and
  bit-equal to the port's one-process ``compiled_merge_batched``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import fusion as jfusion
from panodepth.config import MergeConfig as JaxMergeConfig
from panodepth.pipeline import merge_arrays as jmerge_arrays

import panodepth_torch.config as tconfig
from panodepth_torch import fusion as tfusion
from panodepth_torch import pipeline as tpipeline
from panodepth_torch.kernels.jacobi import jacobi_plain

from torch_port_common import port_layout, run_pair

torch.set_num_threads(1)

NPROC = 4
HALOS = (1, 2, 5, 7, 30, 100)
MERGE_BAR = 1        # u16, as tests/test_parallel.py:36-37
MERGE_SHARE = 0.01   # of the pixels that may differ at all
ABCD_ATOL = 2e-4
JACOBI_ATOL = 1e-6   # port against JAX, tests/test_torch_fusion.py's bar


def _jacobi_inputs(seed, rows):
    """(buf, tgt, cov) of tests/test_parallel.py:118-174: a coverage band
    that crosses the seam."""
    rng = np.random.RandomState(seed)
    h, w = 64, 128
    buf = rng.uniform(0, 1, (h, w)).astype(np.float32)
    tgt = rng.normal(0, 0.01, (h, w)).astype(np.float32)
    cov = np.zeros((h, w), bool)
    cov[rows] = True
    return buf, tgt, cov


def _merge_inputs(batch, seed=0):
    """tests/test_parallel.py's ``_inputs`` at ``test2`` 128 wide."""
    rng = np.random.RandomState(seed)
    emaps = rng.uniform(0.05, 0.9, (batch, 32, 64)).astype(np.float32)
    pmaps = rng.uniform(0.05, 0.9, (batch, 2, 62, 64)).astype(np.float32)
    return emaps, pmaps


@pytest.fixture(scope="module")
def sp(tmp_path_factory, tiny_scene):
    """Every rank's outputs, and the inputs."""
    root = tmp_path_factory.mktemp("spatial")
    lay = port_layout("test2")
    jac = {"a": _jacobi_inputs(3, slice(10, 54)),
           "b": _jacobi_inputs(4, slice(6, 58))}
    emaps, pmaps = _merge_inputs(4)
    np.savez(root / "in.npz", emaps=emaps, pmaps=pmaps,
             tiny_emap=np.asarray(tiny_scene["emap"], np.float32),
             tiny_pmaps=np.asarray(tiny_scene["pmaps"], np.float32),
             test2_fovs=lay.fovs, test2_ranges=lay.ranges,
             **{f"jac_{k}_{n}": a for k, v in jac.items()
                for n, a in zip(("buf", "tgt", "cov"), v)})
    run_pair(lambda port, r: ["tests/torch_mh_worker.py", "spatial",
                              str(port), str(r), str(root), str(NPROC)],
             nproc=NPROC)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(NPROC)]
    return dict(ranks=ranks, jac=jac, emaps=emaps, pmaps=pmaps,
                tiny=tiny_scene)


@pytest.mark.parametrize("halo", HALOS)
def test_jacobi_spatial_bit_equal(sp, halo):
    buf, tgt, cov = sp["jac"]["a" if halo == 1 else "b"]
    want = np.asarray(jax.jit(
        lambda b, t, c: jfusion.jacobi(b, t, c, 30, 0.5, 1e-4))(
        jnp.asarray(buf), jnp.asarray(tgt), jnp.asarray(cov)))
    plain = jacobi_plain(torch.from_numpy(buf), torch.from_numpy(tgt),
                         torch.from_numpy(cov), 30, 0.5, 1e-4).numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=JACOBI_ATOL)
    for rec in sp["ranks"]:
        np.testing.assert_array_equal(rec[f"jacobi{halo}"], plain,
                                      err_msg=f"halo={halo}")


@pytest.mark.parametrize("halo", (1, 10))
def test_fuse_spatial_bit_equal(sp, tiny_cfg, halo):
    plan = jfusion.build_fusion_plan(tiny_cfg)
    emap, pmaps = (np.asarray(sp["tiny"][k], np.float32)
                   for k in ("emap", "pmaps"))
    want, _ = jfusion.fuse(jnp.asarray(emap), jnp.asarray(pmaps), plan)
    tplan = tfusion.build_fusion_plan(tconfig.MergeConfig(
        layout_name="test2", out_width=64))
    own, _ = tfusion.fuse(torch.from_numpy(emap), torch.from_numpy(pmaps),
                          tplan)
    np.testing.assert_array_equal(own.numpy(), np.asarray(want))
    for rec in sp["ranks"]:
        np.testing.assert_array_equal(rec[f"fuse{halo}"], np.asarray(want))


def test_mesh_is_shaped_right(sp):
    """Rank r sits at (r // sp, r % sp), as JAX reshapes its devices."""
    for r, rec in enumerate(sp["ranks"]):
        assert rec["mesh"].tolist() == [2, 2, r, r // 2, r % 2]
        assert rec["dp_group"].tolist() == [r % 2, r % 2 + 2]
        assert rec["sp_group"].tolist() == [2 * (r // 2), 2 * (r // 2) + 1]


def test_merge_mesh_matches_jax(sp):
    jcfg = JaxMergeConfig(layout_name="test2", out_width=128)
    ref = jax.jit(jax.vmap(lambda e, p: jmerge_arrays(e, p, jcfg)))
    j_out, j_abcd = ref(jnp.asarray(sp["emaps"]), jnp.asarray(sp["pmaps"]))
    rec = sp["ranks"][0]
    d = np.abs(rec["merge"].astype(np.int64)
               - np.asarray(j_out).astype(np.int64))
    assert d.max() <= MERGE_BAR and (d > 0).mean() < MERGE_SHARE, (
        d.max(), (d > 0).mean())
    want = np.asarray(j_abcd)
    for b in range(4):
        for v in range(2):
            pm = sp["pmaps"][b, v]
            x = np.linspace(pm.min(), pm.max(), 256)
            np.testing.assert_allclose(np.polyval(rec["abcd"][b, v], x),
                                       np.polyval(want[b, v], x),
                                       rtol=0, atol=ABCD_ATOL)


def test_merge_mesh_bit_equal_to_one_process(sp):
    port_layout("test2")
    cfg = tconfig.MergeConfig(layout_name="test2", out_width=128)
    out, abcd = tpipeline.compiled_merge_batched(cfg, "auto", "cpu")(
        torch.from_numpy(sp["emaps"]), torch.from_numpy(sp["pmaps"]))
    for rec in sp["ranks"]:
        assert rec["merge"].shape == (4, 64, 128)
        np.testing.assert_array_equal(rec["merge"], out.numpy())
        np.testing.assert_array_equal(rec["abcd"], abcd.numpy())
