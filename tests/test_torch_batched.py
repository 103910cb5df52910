"""The port's compiled and batched paths against its single-panorama forms
and against the JAX package's batched paths, on the CPU (where the
compiled forms run eagerly):

* the batched plain Jacobi and batched fusion bit-equal to per-panorama
  calls, registration of a batch bit-equal to one panorama at a time;
* ``compiled_merge`` / ``_staged`` / ``_batched`` / ``_staged_batched``
  bit-equal per panorama to ``merge_arrays``, and within the merge bar
  (1 u16) of JAX's ``compiled_merge_batched``;
* ``merge_many`` at ``stream_u16`` off and on within the CLI bar (2 u16)
  of JAX's ``merge_many``, batch 4 equal to batch 1, a missing file
  quarantined as None; ``run_batch(batch_size=4, profile=True)`` equal to
  the single run with a registration time in the manifest (mirrors
  tests/test_pipeline.py:161-230);
* ``run_batch_e2e`` with ``profile`` and ``stream`` at batch 1 and 2
  within 1 u16 and the same metrics (mirrors tests/test_e2e.py:107-122);
* ``graphs.Graphed``'s structure handling, and ``_percentile99``'s bits.

Layouts are the small ones tier-1 uses: ``test2`` at 64 wide and
``3fold`` at 64 (the model mode) and 128.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import geometry as jgeometry
from panodepth import io as jio
from panodepth.pipeline import compiled_merge_batched as jax_merge_batched
from panodepth.pipeline import merge_many as jax_merge_many

from panodepth_torch import graphs
from panodepth_torch import io as tio
from panodepth_torch import pipeline as tpipeline
from panodepth_torch import registration as treg
from panodepth_torch import e2e as te
from panodepth_torch.fusion import build_fusion_plan, fuse, fuse_batched
from panodepth_torch.kernels import jacobi as kj
from panodepth_torch.models.perspective import _percentile99

from conftest import make_equirect, smooth_depth
from test_torch_e2e import _write_rgb8_png
from torch_port_common import configs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERSP = os.path.join(ROOT, "zoo", "perspective_final.params.npz")


def _stack(layout_name, width, b, seed=0):
    """B panoramas of one layout: (emaps (B, W/2, W), pmaps (B, V, h, w)),
    each view an affine distortion of a smooth field, made with numpy."""
    jcfg, tcfg = configs(layout_name, width)
    layout = jcfg.layout
    rng = np.random.RandomState(seed)
    h, w = (48, 64) if width <= 64 else (112, 128)
    emaps, pmaps = [], []
    for k in range(b):
        emaps.append(np.clip(make_equirect(width, width // 2) * 0.9 + 0.02
                             + 0.02 * k, 0, 1).astype(np.float32))
        views = []
        for v in range(layout.num_views):
            win = jgeometry.make_window(*layout.fovs[v], xp=np)
            xg, yg = np.meshgrid(np.arange(w) / (w - 1),
                                 np.arange(h) / (h - 1))
            azi, zen = jgeometry.xy_to_spherical(win, xg, yg, xp=np)
            a, c = rng.uniform(0.7, 0.9), rng.uniform(0.02, 0.08)
            views.append(np.clip(smooth_depth(azi, zen) * a + c, 0, 1))
        pmaps.append(np.stack(views).astype(np.float32))
    return jcfg, tcfg, np.stack(emaps), np.stack(pmaps)


@pytest.mark.parametrize("b,h,w,iters", [(3, 16, 32, 9), (2, 8, 64, 5),
                                         (1, 12, 16, 3)])
def test_batched_plain_jacobi_equals_per_image(b, h, w, iters):
    rng = np.random.RandomState(b * 100 + h)
    buf = torch.tensor(rng.rand(b, h, w).astype(np.float32))
    tgt = torch.tensor(rng.normal(0, 0.01, (b, h, w)).astype(np.float32))
    cov = rng.rand(h, w) < 0.6
    cov[0], cov[-1], cov[:, 0], cov[:, -1] = True, True, True, True
    cov = torch.tensor(cov)
    got = kj.jacobi_plain(buf, tgt, cov, iters, 0.5, 1e-4)
    lap = kj.lap4_refwrap(buf)
    for k in range(b):
        # each image rolls on its own: the flat wrap never reaches the
        # next panorama
        assert torch.equal(lap[k], kj.lap4_refwrap(buf[k]))
        assert torch.equal(got[k], kj.jacobi_plain(buf[k], tgt[k], cov,
                                                   iters, 0.5, 1e-4))


@pytest.mark.parametrize("layout,width", [("test2", 64), ("3fold", 128)])
def test_batched_fusion_and_registration_equal_per_panorama(layout, width):
    _, tcfg, emaps, pmaps = _stack(layout, width, 3, seed=1)
    e, p = torch.tensor(emaps), torch.tensor(pmaps)
    abcd = treg.register_views_batched(e, p, tcfg)
    # the list form (views of several shapes) gives the same coefficients
    listed = treg.register_views_batched(
        e, [p[:, v] for v in range(p.shape[1])], tcfg)
    assert torch.equal(abcd, listed)
    plan = build_fusion_plan(tcfg)
    out, buf = fuse_batched(e, p, plan, abcd=abcd)
    assert out.shape == (3, width // 2, width) and out.dtype == torch.uint16
    for k in range(3):
        one = treg.register_views(e[k], p[k], tcfg)
        assert torch.equal(abcd[k], one)
        o, bk = fuse(e[k], p[k], plan, abcd=one)
        assert torch.equal(out[k], o) and torch.equal(buf[k], bk)


@pytest.fixture(scope="module")
def merged3():
    """Three 3fold panoramas at 128 through JAX's batched merge and the
    port's eager merge."""
    jcfg, tcfg, emaps, pmaps = _stack("3fold", 128, 3, seed=2)
    j_out, _ = jax_merge_batched(jcfg, "jnp")(jnp.asarray(emaps),
                                              jnp.asarray(pmaps))
    single = [tpipeline.merge_arrays(emaps[k], pmaps[k], tcfg, device="cpu")
              for k in range(3)]
    return dict(tcfg=tcfg, emaps=emaps, pmaps=pmaps, j_out=np.asarray(j_out),
                single=single)


@pytest.mark.parametrize("form", ["batched", "staged_batched"])
def test_compiled_batched_merge_equals_single_and_jax(merged3, form):
    tcfg, emaps, pmaps = merged3["tcfg"], merged3["emaps"], merged3["pmaps"]
    if form == "batched":
        out, abcd = tpipeline.compiled_merge_batched(tcfg, "auto", "cpu")(
            emaps, pmaps)
    else:
        reg_fn, fuse_fn = tpipeline.compiled_merge_staged_batched(
            tcfg, "auto", "cpu")
        abcd, pmaps_reg = reg_fn(emaps, pmaps)
        out = fuse_fn(emaps, pmaps_reg)
    assert out.shape == (3, 64, 128) and abcd.shape == (3, 9, 4)
    for k, (o, a) in enumerate(merged3["single"]):
        assert torch.equal(out[k], o) and torch.equal(abcd[k], a)
    d = np.abs(out.numpy().astype(np.int64)
               - merged3["j_out"].astype(np.int64))
    # XLA on the CPU divides by a reciprocal multiply, so u16 may move by 1
    assert d.max() <= 1, d.max()


@pytest.mark.parametrize("form", ["merge", "staged"])
def test_compiled_merge_equals_merge_arrays(merged3, form):
    tcfg = merged3["tcfg"]
    e, p = merged3["emaps"][1], merged3["pmaps"][1]
    want, want_abcd = merged3["single"][1]
    if form == "merge":
        out, abcd = tpipeline.compiled_merge(tcfg, "auto", "cpu")(e, p)
    else:
        reg_fn, fuse_fn = tpipeline.compiled_merge_staged(tcfg, "auto", "cpu")
        abcd, pmaps_reg = reg_fn(e, p)
        out = fuse_fn(e, pmaps_reg)
    assert torch.equal(out, want) and torch.equal(abcd, want_abcd)
    # u16 inputs normalise on the device as the host does
    out16, _ = tpipeline.compiled_merge(tcfg, "auto", "cpu")(
        np.round(e * 65535).astype(np.uint16),
        np.round(p * 65535).astype(np.uint16))
    again, _ = tpipeline.merge_arrays(
        np.round(e * 65535).astype(np.float32) / np.float32(65535),
        np.round(p * 65535).astype(np.float32) / np.float32(65535), tcfg,
        device="cpu")
    assert torch.equal(out16, again)


def _write_files(root, names, missing=None):
    """A 3fold scene per name written with the JAX package's writers (16-bit
    gt and views, an 8-bit JPEG baseline); ``missing`` gets no baseline."""
    jcfg, _, emaps, pmaps = _stack("3fold", 128, len(names), seed=3)
    layout = jcfg.layout
    for d in ("rgb", "gt", "baseline", "views"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for k, name in enumerate(names):
        jio.save_png16(os.path.join(root, "gt", name + ".png"),
                       jio.to_uint16(np.clip(emaps[k] * 1.05, 0, 1)))
        if name != missing:
            jio.save_jpg(os.path.join(root, "baseline", name + ".jpg"),
                         emaps[k][::2, ::2])
        jio.save_jpg(os.path.join(root, "rgb", name + ".jpg"),
                     np.stack([make_equirect(64, 32)] * 3, -1))
        for v in range(layout.num_views):
            jio.save_png16(os.path.join(
                root, "views", f"{name}.{layout.view_tag(v)}.png"),
                jio.to_uint16(pmaps[k, v]))
    return jcfg


def _items(root, names, layout):
    return [dict(baseline=os.path.join(root, "baseline", n + ".jpg"),
                 pmaps=tio.pmap_filenames(os.path.join(root, "views"), n,
                                          layout, ext=".png"),
                 gt=os.path.join(root, "gt", n + ".png"),
                 out=os.path.join(root, "{}", n + ".png")) for n in names]


@pytest.fixture(scope="module")
def many(tmp_path_factory):
    """Five panoramas (the third without a baseline) through JAX's and the
    port's merge_many at stream_u16 off and on, batch 4 (a padded last
    chunk), and the port's at batch 1."""
    root = str(tmp_path_factory.mktemp("many"))
    names = [f"pano_{i:04d}" for i in range(5)]
    jcfg = _write_files(root, names, missing=names[2])
    _, tcfg = configs("3fold", 128)
    runs = {}
    for who, stream, bs in (("jax", "off", 4), ("jax", "on", 4),
                            ("torch", "off", 4), ("torch", "on", 4),
                            ("torch", "off", 1)):
        tag = f"{who}_{stream}_{bs}"
        os.makedirs(os.path.join(root, tag))
        items = [dict(it, out=it["out"].format(tag))
                 for it in _items(root, names, jcfg.layout)]
        logs = []
        if who == "jax":
            res = jax_merge_many(items, jcfg, batch_size=bs,
                                 jacobi_kind="jnp", stream_u16=stream,
                                 log=logs.append)
        else:
            res = tpipeline.merge_many(items, tcfg, batch_size=bs,
                                       stream_u16=stream, log=logs.append,
                                       device="cpu")
        runs[tag] = (items, res, logs)
    return runs


@pytest.mark.parametrize("stream", ["off", "on"])
def test_merge_many_matches_jax_and_single(many, stream):
    items, res, logs = many[f"torch_{stream}_4"]
    _, jres, _ = many[f"jax_{stream}_4"]
    _, single, _ = many["torch_off_1"]
    assert len(res) == 5 and res[2] is None and jres[2] is None
    assert any("item 2 FAILED" in line for line in logs)
    for k in (0, 1, 3, 4):
        got = tio.read_png(items[k]["out"])
        np.testing.assert_array_equal(got, res[k].out_u16)
        # batch 4 gives each panorama its batch-1 bits, streamed or not
        np.testing.assert_array_equal(res[k].out_u16, single[k].out_u16)
        np.testing.assert_array_equal(res[k].abcd, single[k].abcd)
        d = np.abs(res[k].out_u16.astype(np.int64)
                   - jres[k].out_u16.astype(np.int64))
        assert d.max() <= 2, d.max()
        assert res[k].time_reg_ms is None and res[k].time_fusion_ms >= 0
        np.testing.assert_allclose(res[k].metrics.mse_result,
                                   jres[k].metrics.mse_result, rtol=1e-4,
                                   atol=2e-6)
        for tag in (".res.png", ".giv.png"):
            assert os.path.isfile(items[k]["out"] + tag)
    # the padding of the last chunk is neither written nor scored
    assert not os.path.exists(items[2]["out"])


def test_run_batch_batched_profile_matches_single(tmp_path):
    root = str(tmp_path)
    names = ["pano_0001", "pano_0002", "pano_0003"]
    _write_files(root, names)
    _, tcfg = configs("3fold", 128)
    kw = dict(views_folder=os.path.join(root, "views"),
              extract_rgb_views=False, pmap_ext=".png", log=lambda *a: None,
              device="cpu")
    dirs = [os.path.join(root, r) for r in ("single", "batched")]
    args = [os.path.join(root, d) for d in ("rgb", "gt", "baseline")]
    tpipeline.run_batch(*args, dirs[0], tcfg, **kw)
    logs = []
    tpipeline.run_batch(*args, dirs[1], tcfg, batch_size=4, profile=True,
                        **dict(kw, log=logs.append))
    for n in names:
        for suffix in (".png", ".png.res.png", ".png.giv.png"):
            np.testing.assert_array_equal(
                tio.read_png(os.path.join(dirs[0], n + suffix)),
                tio.read_png(os.path.join(dirs[1], n + suffix)))
    with open(os.path.join(dirs[1], "manifest.json")) as fp:
        man = json.load(fp)
    assert man["completed"] == names
    assert len(man["time_reg_ms"]) == len(man["time_fusion_ms"]) == 3
    assert all(t >= 0 for t in man["time_reg_ms"])
    assert any(line.startswith("time_Reg_avg:") and "n/a" not in line
               for line in logs)


def test_run_batch_e2e_profile_and_stream_batched(tmp_path):
    """Three panoramas (baselines from 16-bit files) at batch 1, and at
    batch 2 with ``stream`` off and on and with ``profile``: each within 1
    u16 of batch 1 with the same metrics."""
    rng = np.random.RandomState(9)
    for d in ("rgb", "gt", "bl"):
        (tmp_path / d).mkdir()
    for i in range(3):
        rgb = np.stack([make_equirect(128, 64)] * 3, -1) * 0.8 \
            + 0.2 * rng.rand(64, 128, 3)
        _write_rgb8_png(str(tmp_path / "rgb" / f"p{i}.png"), rgb)
        tio.save_png16(str(tmp_path / "gt" / f"p{i}.png"),
                       (rng.rand(32, 64) * 60000).astype(np.uint16))
        tio.save_png16(str(tmp_path / "bl" / f"p{i}.depth.png"),
                       (rng.rand(32, 64) * 60000 + 2000).astype(np.uint16))
    _, tcfg = configs("3fold", 64)
    outs, mets, logs = {}, {}, {}
    for bs, stream, profile in ((1, "off", False), (2, "off", False),
                                (2, "on", False), (2, "off", True),
                                (1, "on", True)):
        key = (bs, stream, profile)
        res = tmp_path / f"res_hohonet_{bs}{stream}{profile}"
        logs[key] = []
        mets[key] = te.run_batch_e2e(
            str(tmp_path / "rgb"), str(tmp_path / "gt"), str(res), PERSP,
            tcfg, baseline_folder=str(tmp_path / "bl"), view_width=64,
            batch_size=bs, stream=stream, profile=profile,
            log=logs[key].append, device="cpu")
        outs[key] = [tio.read_png(str(res / f"p{i}.png")).astype(np.int32)
                     for i in range(3)]
    base = (1, "off", False)
    for key in outs:
        assert len(mets[key]) == 3
        for a, b in zip(outs[base], outs[key]):
            assert a.shape == (32, 64) and np.abs(a - b).max() <= 1
        for m1, m2 in zip(mets[base], mets[key]):
            np.testing.assert_allclose(m1.mse_result, m2.mse_result,
                                       rtol=1e-4, atol=1e-7)
        end = logs[key][-1]
        assert ("time_Models_avg:n/a" in end) == (not key[2]), end
        assert "time_Fuse_avg:" in end


def test_graphed_structure_and_cpu_eager():
    spec_leaves = []
    args = (torch.zeros(2), [torch.ones(3), (torch.arange(4),)])
    spec = graphs._flatten(args, spec_leaves)
    assert len(spec_leaves) == 3 and hash(spec) == hash(
        graphs._flatten(args, []))
    back = graphs._unflatten(spec, iter(spec_leaves))
    assert isinstance(back[1], list) and isinstance(back[1][1], tuple)
    assert back[1][1][0] is spec_leaves[2]

    calls = []

    def fn(x, pair):
        calls.append(x.device)
        return x * 2, [pair[0] + 1, pair[1]]

    g = graphs.Graphed(fn, "cpu")
    out = g(np.ones(3, np.float32), (torch.zeros(2), torch.ones(1)))
    assert calls == [torch.device("cpu")] and len(g) == 0  # eager, no graph
    assert out[0].tolist() == [2.0] * 3 and out[1][0].tolist() == [1.0, 1.0]
    assert g.eager is fn


def _held(held, obj):
    return any(x is obj for x in held)


@pytest.mark.parametrize("path", ["merge", "extract", "latitude",
                                  "derived"])
def test_capture_holds_the_tables_it_reads(path):
    """Every cached device table and weight cast that a captured function
    reads is handed to the capture's keep-alive list, on a cache hit as on
    a miss, so a graph outlives the caches' evictions."""
    from panodepth_torch import fusion
    from panodepth_torch.models import fastpano, layers
    from panodepth_torch.ops import projection

    cpu = torch.device("cpu")
    held = []
    if path == "merge":
        _, tcfg, emaps, pmaps = _stack("test2", 64, 1)
        for _ in range(2):  # a miss, then hits
            with graphs.holding(held):
                tpipeline.merge_arrays(emaps[0], pmaps[0], tcfg,
                                       device="cpu")
        he_we, hp_wp = emaps.shape[-2:], pmaps.shape[-2:]
        tables = [fusion._inv_cov(tcfg, k, cpu)
                  for k in range(len(build_fusion_plan(tcfg).levels))]
        tables += [fusion._on_device(fusion._level0_gather_indices, tcfg,
                                     he_we, cpu),
                   treg._device_tables(tcfg, he_we, hp_wp, None, cpu)]
    elif path == "extract":
        rgb = torch.rand(8, 16, 3)
        fovs = np.array([[-0.5, 0.5, -0.4, 0.4]], np.float32)
        with graphs.holding(held):
            projection.extract_group(rgb, fovs, (4, 5))
        key = tuple(tuple(float(v) for v in row) for row in fovs)
        tables = [projection._taps(key, (4, 5), (8, 16), cpu)]
    elif path == "latitude":
        with graphs.holding(held):
            fastpano._latitude_on_device(8, 16, cpu, torch.float32)
        tables = [fastpano._latitude_on_device(8, 16, cpu, torch.float32)]
    else:
        conv = layers.Conv(3, 4)
        # the cast is kept (and held) for inference; under grad a trainable
        # conv makes it anew on every call
        with torch.no_grad():
            with graphs.holding(held):
                conv.weight()
            tables = [conv.weight()]
    assert tables and all(_held(held, t) for t in tables)
    # outside a capture nothing is collected
    n = len(held)
    fastpano._latitude_on_device(8, 16, cpu, torch.float32)
    assert len(held) == n and not graphs._HOLDING


def test_compiled_forms_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs("test2", 64)
    for factory in (tpipeline.compiled_merge, tpipeline.compiled_merge_staged,
                    tpipeline.compiled_merge_batched,
                    tpipeline.compiled_merge_staged_batched):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            factory(tcfg, "auto", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipeline.merge_many([], tcfg, device="cuda")


@pytest.mark.parametrize("n", [1, 2, 7, 101, 256 * 247, 65537])
def test_percentile99_bits_unchanged(n):
    """The host-formed ranks and weights give the bits of the former
    tensor form (f32 q, floor/ceil, weights as 0-d f32 tensors)."""
    x = torch.tensor(np.random.RandomState(n).lognormal(0, 1, (3, n))
                     .astype(np.float32))
    q = torch.tensor(99.0, dtype=torch.float32) / 100
    q = q * torch.tensor(float(n), dtype=torch.float32).sub(1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    s = torch.sort(x, dim=1).values
    want = (s[:, int(torch.clamp(low, 0, n - 1))] * (1 - high_w)
            + s[:, int(torch.clamp(high, 0, n - 1))] * high_w)
    assert torch.equal(_percentile99(x), want)
