"""panodepth_torch.synth against panodepth.synth: the scene samplers bit for
bit, the renders, the batches, the analytic special cases, and the dataset
writer.

Bars: depth within 2e-5 of JAX's (tests/test_synth.py's bar for a ray's
depth; both trace the same f32 rays, the port's directions may differ by
an ulp where XLA divides by a reciprocal); rgb within 1e-4 on all but
0.5 % of the pixels, those a silhouette or texture edge where an ulp of
the hit point flips the nearest object or a floor() (measured: no pixel
beyond 5e-5 at these sizes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import geometry as jgeometry
from panodepth import synth as jsynth

from panodepth_torch import synth as tsynth

torch.set_num_threads(1)

DEPTH_TOL = 2e-5
RGB_TOL = 1e-4
RGB_FRAC = 0.005


def _dev(scene):
    return jax.tree.map(jnp.asarray, scene)


def _port(scenes):
    return tsynth.scene_tensors(tsynth.stack_scenes(scenes), "cpu")


@pytest.mark.parametrize("version", ["v1", "v2", "mix"])
def test_sample_scene_bit_equal(version):
    for seed in range(6):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(3):  # the stream, not just its first draw
            want = jsynth.sample_scene(a, version)
            got = tsynth.sample_scene(b, version)
            for f in jsynth.Scene._fields:
                w, g = getattr(want, f), getattr(got, f)
                assert g.dtype == w.dtype and np.array_equal(g, w), f
        np.testing.assert_array_equal(tsynth.sample_view_fov(b),
                                      jsynth.sample_view_fov(a))
    with pytest.raises(ValueError):
        tsynth.sample_scene(np.random.RandomState(0), "v3")


def _close(rgb, dep, jrgb, jdep):
    dep, jdep = np.asarray(dep), np.asarray(jdep)
    assert np.abs(dep - jdep).max() <= DEPTH_TOL
    off = np.abs(np.asarray(rgb) - np.asarray(jrgb)).max(-1)
    assert np.mean(off > RGB_TOL) <= RGB_FRAC, float(off.max())


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_render_pano_matches_jax(version):
    v2 = version == "v2"
    scenes = [jsynth.sample_scene(np.random.RandomState(s), version)
              for s in (3, 4)]
    rgb, dep = tsynth.render_pano(_port(scenes), 128, 64, v2)
    assert rgb.shape == (2, 64, 128, 3) and dep.shape == (2, 64, 128)
    render = jax.jit(lambda s: jsynth.render_pano(s, 128, 64, v2))
    for i, s in enumerate(scenes):
        jrgb, jdep = render(_dev(s))
        _close(rgb[i], dep[i], jrgb, jdep)
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
    assert float(dep.min()) > 1e-3 and float(dep.max()) < 1.0


@pytest.mark.parametrize("version", ["v1", "mix"])
def test_render_view_matches_jax(version):
    v2 = version != "v1"
    rng = np.random.RandomState(7)
    scenes = [jsynth.sample_scene(rng, version) for _ in range(2)]
    fovs = np.stack([jsynth.sample_view_fov(rng) for _ in range(2)])
    rgb, dep = tsynth.render_view(_port(scenes), torch.from_numpy(fovs),
                                  48, 64, v2)
    render = jax.jit(lambda s, f: jsynth.render_view(s, f, 48, 64, v2))
    for i, s in enumerate(scenes):
        jrgb, jdep = render(_dev(s), jnp.asarray(fovs[i]))
        _close(rgb[i], dep[i], jrgb, jdep)


def test_view_matches_pano_ray():
    """A perspective pixel and the ray along the same direction see the
    same depth (both exact geometry)."""
    rng = np.random.RandomState(3)
    scene = tsynth.sample_scene(rng)
    fov = tsynth.sample_view_fov(rng)
    _, vd = tsynth.render_view(_port([scene]), torch.from_numpy(fov[None]),
                               32, 32)
    win = jgeometry.make_window(*fov.astype(np.float64), xp=np)
    for px, py in ((5, 7), (20, 11), (31, 31)):
        pos = win.corner0 + win.hedge * ((px + 0.5) / 32) \
            + win.vedge * ((py + 0.5) / 32)
        d = torch.from_numpy((pos / np.linalg.norm(pos)).astype(np.float32))
        _, d01 = tsynth._render_dirs(_port([scene]), d[None, None])
        np.testing.assert_allclose(float(vd[0, py, px]), float(d01[0, 0]),
                                   atol=DEPTH_TOL)


def test_depth_poles_valid():
    """Straight up and down rays hit the ceiling and the floor (the
    sign-preserving direction clamp)."""
    scene = _port([tsynth.sample_scene(np.random.RandomState(1))])
    for zen in (0.0, np.pi):
        d = jgeometry.spherical_to_world(np.float32(0.0), np.float32(zen),
                                         xp=np).astype(np.float32)
        _, d01 = tsynth._render_dirs(scene, torch.from_numpy(d)[None, None])
        assert float(d01[0, 0]) > 1e-3


def _empty_room():
    """tests/test_synth.py's analytic room: 2 m to +x, no furniture."""
    f32 = np.float32
    s = jsynth.sample_scene(np.random.RandomState(2))
    return s._replace(
        room_lo=np.array([-2.0, -2.0, -1.5], f32),
        room_hi=np.array([2.0, 2.0, 1.5], f32),
        sph_on=np.zeros_like(s.sph_on), box_on=np.zeros_like(s.box_on),
        cyl_on=np.zeros_like(s.cyl_on), room2_on=f32(0.0))


def _depth(scene, d):
    d = np.asarray(d, np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d))
    return float(tsynth._render_dirs(_port([scene]), d[None, None])[1][0, 0])


def test_room_union_doorway():
    """A ray through the attached room's cross-section goes on to its far
    wall; one missing the doorway, or with room2_on = 0, stops at room 1's
    wall."""
    f32 = np.float32
    s = _empty_room()
    s = s._replace(room2_lo=np.array([1.8, -0.5, -1.5], f32),
                   room2_hi=np.array([5.0, 0.5, 1.2], f32), room2_on=f32(1.0))
    m = jsynth.METERS_TO_01
    np.testing.assert_allclose(_depth(s, [1, 0, 0]), 5.0 * m, rtol=1e-5)
    miss = s._replace(room2_lo=np.array([1.8, 0.3, -1.5], f32),
                      room2_hi=np.array([5.0, 0.9, 1.2], f32))
    np.testing.assert_allclose(_depth(miss, [1, 0, 0]), 2.0 * m, rtol=1e-5)
    np.testing.assert_allclose(_depth(s._replace(room2_on=f32(0.0)),
                                      [1, 0, 0]), 2.0 * m, rtol=1e-5)


def test_cylinder_side_and_cap():
    f32 = np.float32
    s = _empty_room()
    cyl_c = np.zeros((jsynth.MAX_CYLS, 2), f32)
    cyl_r = np.full(jsynth.MAX_CYLS, 0.05, f32)
    cyl_z = np.tile(np.array([0.0, 0.1], f32), (jsynth.MAX_CYLS, 1))
    cyl_on = np.zeros(jsynth.MAX_CYLS, f32)
    cyl_c[0], cyl_r[0], cyl_z[0], cyl_on[0] = (1.0, 0.0), 0.6, (-1.5, -0.5), 1
    s = s._replace(cyl_c=cyl_c, cyl_r=cyl_r, cyl_z=cyl_z, cyl_on=cyl_on)
    m = jsynth.METERS_TO_01
    np.testing.assert_allclose(_depth(s, [1, 0, 0]), 2.0 * m, rtol=1e-5)
    d = np.array([1, 0, -1.4]) / np.linalg.norm([1, 0, -1.4])
    np.testing.assert_allclose(_depth(s, d), 0.4 / d[0] * m, rtol=1e-4)
    np.testing.assert_allclose(_depth(s, [1, 0, -0.5]), np.sqrt(1.25) * m,
                               rtol=1e-4)


def test_v1_fast_path_matches_full():
    """v2=False skips blocks that are exact no-ops on v1 scenes: depth bit
    for bit, rgb within a few ulps."""
    scenes = _port([tsynth.sample_scene(np.random.RandomState(s))
                    for s in (0, 1)])
    r1, d1 = tsynth.render_pano(scenes, 96, 48, v2=False)
    r2, d2 = tsynth.render_pano(scenes, 96, 48, v2=True)
    assert torch.equal(d1, d2)
    assert float((r1 - r2).abs().max()) <= 1e-6


@pytest.mark.parametrize("kind", ["perspective", "pano"])
def test_synth_batches_deterministic(kind):
    kw = dict(kind=kind, view_size=32, pano_width=64, seed=9, version="mix",
              device="cpu")
    a = tsynth.synth_batches(2, **kw)
    b = tsynth.synth_batches(2, **kw)
    for _ in range(2):
        (ra, da, va), (rb, db, vb) = next(a), next(b)
        assert torch.equal(ra, rb) and torch.equal(da, db)
        assert va.dtype == torch.bool and bool(va.all())
    shape = (2, 32, 32) if kind == "perspective" else (2, 32, 64)
    assert ra.shape == shape + (3,) and da.shape == shape
    a.close()
    b.close()


def test_synth_batches_draw_jax_scenes():
    """The batches render the scenes JAX's synth_batches draws from the
    same seed (the host samplers are the same stream)."""
    port = next(tsynth.synth_batches(2, "pano", pano_width=64, seed=5,
                                     device="cpu"))
    want = next(jsynth.synth_batches(2, "pano", pano_width=64, seed=5))
    for i in range(2):
        _close(port[0][i], port[1][i], want[0][i], want[1][i])


def test_write_dataset_roundtrip(tmp_path):
    """rgb/ + gt/ in the matterport naming; the u16 gt quantises the
    render exactly."""
    from panodepth_torch import io as tio

    tsynth.main(["2", str(tmp_path), "--width", "64", "--seed", "3",
                 "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "gt").iterdir())
    assert names == ["synth_0000.png", "synth_0001.png"]
    assert sorted(p.name for p in (tmp_path / "rgb").iterdir()) == [
        "synth_0000.jpg", "synth_0001.jpg"]
    rng = np.random.RandomState(3)
    scene = _port([tsynth.sample_scene(rng)])
    _, dep = tsynth.render_pano(scene, 64, v2=False)
    gt = tio.load_image01(str(tmp_path / "gt" / "synth_0000.png"))
    want = (np.clip(dep[0].numpy(), 0, 1) * 65535.0 + 0.5).astype(np.uint16)
    np.testing.assert_array_equal(
        np.round(gt * 65535.0).astype(np.uint16), want)
