"""The view-parallel latency graph (``panodepth_torch/parallel/views.py``)
and ``run_batch_e2e(latency=True)`` against the JAX package's
(tests/test_latency.py) and against the port's own single-device stages.

Two ranks (``tests/torch_mh_worker.py latency``, gloo on the CPU) run once;
each check below reads their outputs, and JAX runs here on its 8 virtual
devices:

* the stub nets of tests/test_latency.py (torch twins) at
  ``MergeConfig(out_width=128)``, views 32 wide, the baseline net 64 wide,
  halo 1 and 10: bit-equal to the port's one-process batched graph, within
  8 u16 of JAX's batched graph and of JAX's latency graph, and bit-equal
  to the port's ``fuse`` on the graph's own views, coefficients and
  baseline (tests/test_latency.py:66-91): the ranks' partial sums add in
  the single-device order at every pixel here.  JAX's test also bars
  pixels more than 1 u16 apart at 1e-3 between its two graphs; between
  the packages the port's batched graph already has 0.22 % of them (0.29
  % against JAX's latency graph, measured): the registration's f32 sums
  move the stub scene's cubics by up to 2e-3 (ROADMAP Queue 3);
* the given-baseline form ``fn(rgb, baseline)`` (:127-152), held the same
  way;
* the tiny nets (weights drawn by the port, carried to flax by
  ``port_params_to_jax``): the graph's coefficients within 1e-4 of
  ``register_views`` on its own intermediates, the fusion bit-equal to
  ``fuse`` on them (:94-124);
* the driver in both ranks: rank 0's files, the resume, the metrics
  (:155-219).

In this process (one rank): the refusals (a layout of two view shapes; a
level width the ranks do not divide), the one-rank graph within the stub
bar of JAX's latency graph and bit-equal to the port's batched graph, in
the default table and in ``packed16`` and ``pair16``, and the int8
perspective net within the int8 bar of the port's batched int8 graph.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

from panodepth.parallel.views import build_latency_e2e as jlatency
from panodepth.parallel.views import make_vp_mesh as jmake_vp_mesh

import panodepth_torch.config as tconfig
from panodepth_torch import e2e as te
from panodepth_torch import io as tio
from panodepth_torch import registration as treg
from panodepth_torch.fusion import build_fusion_plan, fuse
from panodepth_torch.models import layers as tlayers
from panodepth_torch.models import train as ttrain
from panodepth_torch.models import weights
from panodepth_torch.models.panoramic import PanoBaselineNet as TPano
from panodepth_torch.models.perspective import PerspectiveDepthNet as TPersp
from panodepth_torch.parallel import mesh as tmesh
from panodepth_torch.parallel import multihost as mh
from panodepth_torch.parallel.views import build_latency_e2e

import test_latency as jl
from conftest import make_equirect
from torch_mh_worker import TINY_PANO, TINY_PERSP, StubBase, StubPersp
from torch_port_common import flax_flat, run_pair
from torch_train_common import port_params_to_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_BAR = 8               # u16 (tests/test_latency.py:80)
INT8_BAR = (256, 24.0)     # u16 max, mean (tests/test_torch_quantize.py)
ABCD_ATOL = 1e-4
CFG = tconfig.MergeConfig(out_width=128)
STUB = dict(view_width=32, base_w=64)
D2R = math.pi / 180.0
DRV_FOVS = np.array([(25 * D2R, 175 * D2R, 30 * D2R, 150 * D2R),
                     (185 * D2R, 335 * D2R, 30 * D2R, 150 * D2R)])
DRV_RANGES = np.array([(170 * D2R, 30 * D2R, 40 * D2R, 140 * D2R),
                       (330 * D2R, 190 * D2R, 40 * D2R, 140 * D2R)])


def _u16(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return d


def _driver_files(root):
    """tests/test_latency.py:155-200's files: two 64x32 panoramas, gts,
    baselines named for a ``*hohonet*`` result folder, and a tiny
    perspective checkpoint (the port's weights in the zoo's format)."""
    rng = np.random.RandomState(7)
    for d in ("rgb", "gt", "bl", "ck"):
        (root / d).mkdir()
    for i in range(2):
        tio.save_jpg(str(root / "rgb" / f"p{i}.jpg"),
                     rng.rand(32, 64, 3).astype(np.float32))
        tio.save_png16(str(root / "gt" / f"p{i}.png"),
                       (rng.rand(32, 64) * 60000).astype(np.uint16))
        tio.save_png16(str(root / "bl" / f"p{i}.depth.png"),
                       (rng.rand(32, 64) * 60000 + 2000).astype(np.uint16))
    arch = dict(model="perspective", width_scale=0.125, view_size=64,
                pano_width=64)
    net = weights.build_model(arch, dtype=torch.float32)
    tlayers.init_params(net, torch.Generator().manual_seed(0))
    ttrain.save_params_npz(str(root / "ck" / "perspective_final.params.npz"),
                           dict(net.named_parameters()))
    import json

    (root / "ck" / "perspective.config.json").write_text(json.dumps(arch))


@pytest.fixture(scope="module")
def lat(tmp_path_factory):
    """Both ranks' outputs and the inputs."""
    root = tmp_path_factory.mktemp("latency")
    rgb = np.array(jl._rgb())
    baseline = make_equirect(64, 32)
    pp = port_params_to_jax(_jpersp(), TPersp(dtype=torch.float32,
                                              **TINY_PERSP), (1, 32, 32), 0)
    bp = port_params_to_jax(_jpano(), TPano(dtype=torch.float32, **TINY_PANO),
                            (1, 32, 64), 1)
    _driver_files(root)
    np.savez(root / "in.npz", rgb=rgb, baseline=baseline, root=str(root),
             torch_latency_drv_fovs=DRV_FOVS,
             torch_latency_drv_ranges=DRV_RANGES,
             **{"persp/" + k: v for k, v in flax_flat(pp).items()},
             **{"base/" + k: v for k, v in flax_flat(bp).items()})
    run_pair(lambda port, r: ["tests/torch_mh_worker.py", "latency",
                              str(port), str(r), str(root)])
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in (0, 1)]
    return dict(ranks=ranks, rgb=rgb, baseline=baseline, root=root)


def _jpersp():
    from panodepth.models.perspective import PerspectiveDepthNet

    return PerspectiveDepthNet(dtype=jax.numpy.float32, **TINY_PERSP)


def _jpano():
    from panodepth.models.panoramic import PanoBaselineNet

    return PanoBaselineNet(dtype=jax.numpy.float32, **TINY_PANO)


@pytest.fixture(scope="module")
def jax_latency():
    """JAX's latency graph with the stub nets on its 8 devices, halo 10."""
    fn = jlatency(jl.StubPersp(), jl.PARAMS, jl.CFG, jmake_vp_mesh(8),
                  view_width=32, base_model=jl.StubBase(),
                  base_params=jl.PARAMS, base_w=64, halo=10)
    return np.asarray(fn(jl._rgb())[0])


def _within_stub_bar(got, want):
    d = _u16(got, want)
    assert d.max() <= STUB_BAR, (d.max(), (d > 1).mean())


def _own_fuse(rec, name):
    """The port's single-device ``fuse`` on the graph's own intermediates."""
    nv = CFG.layout.num_views
    out, _ = fuse(torch.from_numpy(rec[f"{name}/emap"]),
                  list(torch.from_numpy(rec[f"{name}/pmaps"][:nv])),
                  build_fusion_plan(CFG),
                  abcd=torch.from_numpy(rec[f"{name}/abcd"]))
    return out.numpy()


@pytest.mark.parametrize("halo", (1, 10))
def test_stub_latency_matches_jax(lat, jax_latency, halo):
    got = lat["ranks"][0][f"stub{halo}/out"]
    assert got.shape == (64, 128) and got.dtype == np.uint16
    np.testing.assert_array_equal(got, _port_batched(rgb=lat["rgb"],
                                                     **STUB))
    want, _ = jl._batched_ref(jax.numpy.asarray(lat["rgb"]))
    _within_stub_bar(got, want)
    _within_stub_bar(got, jax_latency)


@pytest.mark.parametrize("halo", (1, 10))
def test_stub_latency_fuse_bit_equal(lat, halo):
    rec = lat["ranks"][0]
    assert rec[f"stub{halo}/abcd"].shape == (CFG.layout.num_views, 4)
    assert rec[f"stub{halo}/pmaps"].shape == (16, 31, 32)  # 15 views + 1
    np.testing.assert_array_equal(rec[f"stub{halo}/out"],
                                  _own_fuse(rec, f"stub{halo}"))


def test_ranks_hold_the_same_outputs(lat):
    r0, r1 = lat["ranks"]
    for k, v in r0.items():
        if k.startswith(("stub", "given", "real")):
            np.testing.assert_array_equal(v, r1[k], err_msg=k)


def test_latency_given_baseline(lat):
    import jax.numpy as jnp
    from panodepth.e2e import build_batched_e2e as jbatched

    _, jm, jf = jbatched(jl.StubPersp(), jl.PARAMS, jl.CFG, view_width=32)
    bl, pmaps = jm(jnp.asarray(lat["rgb"])[None],
                   jnp.asarray(lat["baseline"])[None])
    want = np.asarray(jf(bl, pmaps)[0][0])
    rec = lat["ranks"][0]
    _within_stub_bar(rec["given/out"], want)
    full = te.build_batched_e2e(StubPersp(), CFG, view_width=32,
                                device="cpu")[0]
    port, _ = full(torch.from_numpy(lat["rgb"][None]),
                   torch.from_numpy(lat["baseline"][None]))
    np.testing.assert_array_equal(rec["given/out"], port[0].numpy())
    assert rec["given/abcd"].shape == (CFG.layout.num_views, 4)
    np.testing.assert_array_equal(rec["given/out"], _own_fuse(rec, "given"))


def test_latency_real_nets_internal_consistency(lat):
    rec = lat["ranks"][0]
    nv = CFG.layout.num_views
    assert rec["real/out"].shape == (64, 128)
    assert np.isfinite(rec["real/abcd"]).all()
    abcd = treg.register_views(torch.from_numpy(rec["real/emap"]),
                               torch.from_numpy(rec["real/pmaps"][:nv]), CFG)
    np.testing.assert_allclose(rec["real/abcd"], abcd.numpy(), rtol=0,
                               atol=ABCD_ATOL)
    np.testing.assert_array_equal(rec["real/out"], _own_fuse(rec, "real"))


def test_run_batch_e2e_latency_driver(lat):
    res = lat["root"] / "res_hohonet_lat"
    for i in range(2):
        out = tio.read_png(str(res / f"p{i}.png"))
        assert out.shape == (32, 64) and out.dtype == np.uint16
        assert (res / f"p{i}.aligned.txt").exists()
    for rec in lat["ranks"]:
        assert rec["driver_metrics"].shape == (2,)
        assert np.isfinite(rec["driver_metrics"]).all()
        assert int(rec["driver_again"]) == 0  # the rerun skips both
        log = str(rec["driver_log"])
        assert "view-parallel latency mode over 2 ranks" in log
        assert "time_e2e_avg:" in log and "(view-parallel)" in log
        assert "skip!" in log
    np.testing.assert_array_equal(lat["ranks"][0]["driver_metrics"],
                                  lat["ranks"][1]["driver_metrics"])


# --- one process -------------------------------------------------------------


def test_latency_rejects_mixed_shape_layouts():
    fovs = np.array([(25 * D2R, 175 * D2R, 30 * D2R, 150 * D2R),
                     (185 * D2R, 305 * D2R, 30 * D2R, 150 * D2R)])
    ranges = np.array([(170 * D2R, 30 * D2R, 40 * D2R, 140 * D2R),
                       (300 * D2R, 190 * D2R, 40 * D2R, 140 * D2R)])
    tconfig.layout_from_arrays("torch_latency_mixed", fovs, ranges)
    cfg = tconfig.MergeConfig(layout_name="torch_latency_mixed",
                              out_width=128)
    with pytest.raises(ValueError, match="one view shape"):
        build_latency_e2e(StubPersp(), cfg, view_width=32,
                          baseline_shape=(32, 64), device="cpu")


def test_latency_rejects_level_width_not_divisible():
    """Three ranks do not divide the 32-wide level 0 of a 128-wide output
    (the mesh is made by hand: refused before any collective)."""
    ring = mh.Group((0, 1, 2), 0)
    mesh = tmesh.Mesh(dp=1, sp=3, rank=0, device=torch.device("cpu"),
                      dp_group=mh.Group((0,), 0), sp_group=ring)
    with pytest.raises(ValueError, match="level width 32 not divisible by "
                                         "vp=3"):
        build_latency_e2e(StubPersp(), CFG, mesh, base_model=StubBase(),
                          device="cpu", **STUB)


def _port_batched(table="auto", persp=None, base=None, cfg=CFG, rgb=None,
                  **kw):
    full = te.build_batched_e2e(persp or StubPersp(), cfg,
                                base_model=base or StubBase(),
                                extract_dtype=table, device="cpu", **kw)[0]
    return full(torch.from_numpy(rgb[None]))[0][0].numpy()


@pytest.mark.parametrize("table", ("auto", "packed16", "pair16"))
def test_latency_one_rank_matches_batched(table, jax_latency):
    """One rank: the latency graph (halo 10) is the batched graph's
    function, bit for bit, in the default table and in the 565 ones
    (tests/test_latency.py:242-278); the default within the stub bar of
    JAX's latency graph."""
    rgb = np.array(jl._rgb())
    fn = build_latency_e2e(StubPersp(), CFG, base_model=StubBase(),
                           extract_dtype=table, halo=10, device="cpu",
                           **STUB)
    got = fn(rgb)[0].numpy()
    np.testing.assert_array_equal(got, _port_batched(table, rgb=rgb, **STUB))
    if table == "auto":
        _within_stub_bar(got, jax_latency)


def test_latency_one_rank_int8():
    """The GN perspective net's int8 graph through the one-rank latency
    graph, within the int8 bar of the port's batched int8 graph."""
    gn = os.path.join(ROOT, "zoo", "gn", "perspective_final.params.npz")
    base_ck = os.path.join(ROOT, "zoo", "fastpano_final.params.npz")
    persp, _ = te.load_model_checkpoint(gn, device="cpu", quantize=True)
    base, _ = te.load_model_checkpoint(base_ck, device="cpu")
    cfg = tconfig.MergeConfig(layout_name="3fold", out_width=128)
    rgb = np.random.RandomState(3).rand(64, 128, 3).astype(np.float32)
    kw = dict(view_width=64, base_w=128)
    fn = build_latency_e2e(persp, cfg, base_model=base, halo=10,
                           device="cpu", **kw)
    got = fn(rgb)[0].numpy()
    want = _port_batched(persp=persp, base=base, cfg=cfg, rgb=rgb, **kw)
    d = _u16(got, want)
    assert d.max() <= INT8_BAR[0] and d.mean() < INT8_BAR[1], (
        d.max(), d.mean())
