"""Stage A of the port (``pipeline.extract_stage_a``) and the reference's
own command, ``0 rgb gt baseline result`` with stage A on and ``.jpg``
views, against the JAX package; the TF32 manager of the merge and the e2e
graph; the whole file and model path with Pillow, JAX and the JAX package
blocked.

Bars:

* Stage A, file names and counts: equal.  Each package's files are
  byte-equal to the port's ``jpeg.encode`` of that package's own u8
  extraction (so the codec adds no difference of its own).  The two
  extractions agree in f32 within a few ulps (atan2/acos round apart in
  XLA and PyTorch), so a u8 truncation flips by one level at a few pixels
  in 10^5; a JPEG spreads each flip over its 16x16 MCU and one pixel
  around it (fancy upsampling).  Outside those neighbourhoods the decoded
  views agree within 1.01/255, the JAX package's own bar for a float-ulp
  flip (tests/test_pipeline.py:255-257); inside them they differ by a few
  levels (3 measured at view width 96).
* CLIs: outputs within 2 u16, the bar of tests/test_torch_pipeline.py.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import cli as jcli
from panodepth import io as jio
from panodepth import pipeline as jpipeline
from panodepth.config import MergeConfig as JaxMergeConfig

from panodepth_torch import cli as tcli
from panodepth_torch import e2e as te
from panodepth_torch import io as tio
from panodepth_torch import jpeg
from panodepth_torch import pipeline as tpipeline
from panodepth_torch.config import MergeConfig

from test_torch_pipeline import _aligned, _write_verify_scene
from torch_port_common import tiny_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERSP = os.path.join(ROOT, "zoo", "perspective_final.params.npz")
BASE = os.path.join(ROOT, "zoo", "fastpano_final.params.npz")


def _rgb_panorama(seed, w=96):
    rng = np.random.RandomState(seed)
    h = w // 2
    az = np.linspace(0, 2 * np.pi, w, endpoint=False)[None, :]
    ze = np.linspace(0, np.pi, h)[:, None]
    img = np.stack([0.5 + 0.3 * np.sin(3 * az + seed) * np.sin(ze),
                    np.broadcast_to(0.5 + 0.3 * np.cos(2 * ze + az), (h, w)),
                    0.5 + 0.2 * np.cos(az - ze)], -1)
    return np.clip(img + 0.05 * rng.rand(h, w, 3), 0, 1)


def _u8(views01):
    return (np.clip(views01, 0.0, 1.0) * 255.0).astype(np.uint8)


def _flip_neighbourhood(flips):
    """Pixels of the 16x16 MCUs that hold a flip, and one pixel around."""
    h, w = flips.shape
    mh, mw = -(-h // 16), -(-w // 16)
    pad = np.zeros((mh * 16, mw * 16), bool)
    pad[:h, :w] = flips
    mcu = pad.reshape(mh, 16, mw, 16).any(axis=(1, 3))
    m = np.repeat(np.repeat(mcu, 16, 0), 16, 1)[:h, :w]
    grown = m.copy()
    grown[1:] |= m[:-1]
    grown[:-1] |= m[1:]
    out = grown.copy()
    out[:, 1:] |= grown[:, :-1]
    out[:, :-1] |= grown[:, 1:]
    return out


def test_extract_stage_a_matches_jax(tmp_path):
    rgb_dir = tmp_path / "rgb"
    rgb_dir.mkdir()
    for k in range(2):
        jio.save_jpg(str(rgb_dir / f"pano_{k}.jpg"), _rgb_panorama(k))
    files = tio.list_images(str(rgb_dir))
    jcfg, tcfg = JaxMergeConfig(out_width=128), MergeConfig(out_width=128)
    vj, vt = str(tmp_path / "views_jax"), str(tmp_path / "views_torch")
    assert jpipeline.extract_stage_a(files, vj, jcfg, width=96) == 2
    assert tpipeline.extract_stage_a(files, vt, tcfg, width=96,
                                     device="cpu") == 2
    assert sorted(os.listdir(vt)) == sorted(os.listdir(vj))
    assert len(os.listdir(vt)) == 2 * 15

    # each package's own extraction of the batch, as its stage A ran it
    stack = np.stack([jio.load_image01(f) for f in files])
    jfn, jgroups = jpipeline._compiled_extract_batched(jcfg, 96)
    tfn, tgroups = tpipeline._extract_batched(tcfg, 96, torch.device("cpu"))
    assert [g[0] for g in tgroups] == [g[0] for g in jgroups]
    jviews = [np.asarray(v) for v in jfn(jnp.asarray(stack))]
    tviews = [v.numpy() for v in tfn(torch.as_tensor(stack))]
    flipped = total = 0
    for (_, idxs), jv, tv in zip(tgroups, jviews, tviews):
        for bi, f in enumerate(files):
            raw = tio.raw_name(f)
            for j, vi in enumerate(idxs):
                name = f"{raw}.{tcfg.layout.view_tag(vi)}.jpg"
                ju8, tu8 = _u8(jv[bi, j]), _u8(tv[bi, j])
                with open(os.path.join(vj, name), "rb") as fp:
                    assert fp.read() == jpeg.encode(ju8), name
                with open(os.path.join(vt, name), "rb") as fp:
                    assert fp.read() == jpeg.encode(tu8), name
                diff = np.abs(ju8.astype(int) - tu8.astype(int))
                assert diff.max() <= 1, name
                flips = diff.max(axis=-1) > 0
                flipped += int(flips.sum())
                total += flips.size
                dj = jio.load_image01(os.path.join(vj, name))
                dt = tio.load_image01(os.path.join(vt, name))
                near = _flip_neighbourhood(flips)
                np.testing.assert_allclose(dt[~near], dj[~near],
                                           atol=1.01 / 255, err_msg=name)
    assert flipped < 1e-3 * total, (flipped, total)
    # second call: every view exists, nothing re-extracted
    assert tpipeline.extract_stage_a(files, vt, tcfg, width=96,
                                     device="cpu") == 0


def _verify_scene(root, depth_ext):
    """The verify-skill scene; with ``depth_ext`` ``.jpg`` its depth views
    are rewritten as 8-bit gray JPEGs (the JAX package's writer).  The
    second panorama's views are left out, so stage A extracts them; it has
    no baseline, so stage C quarantines it."""
    names = ["pano_0001", "pano_0002"]
    _write_verify_scene(root, names)
    views = os.path.join(root, "views")
    for f in sorted(os.listdir(views)):
        path = os.path.join(views, f)
        if f.startswith(names[1]):
            os.remove(path)
        elif depth_ext == ".jpg":
            jio.save_jpg(path[:-4] + ".jpg", jio.load_image01(path))
            os.remove(path)
    for side in ("jax", "torch"):
        shutil.copytree(views, os.path.join(root, f"views_{side}"))
    return names


def _run_both(root, *extra):
    def argv(side):
        return ["0", os.path.join(root, "rgb"), os.path.join(root, "gt"),
                os.path.join(root, "baseline"),
                os.path.join(root, f"result_{side}"), "--layout", "3fold",
                "--out-width", "256", "--views-folder",
                os.path.join(root, f"views_{side}"), *extra]

    assert jcli.main(argv("jax") + ["--platform", "cpu"]) == 0
    assert tcli.main(argv("torch") + ["--device", "cpu"]) == 0


def _assert_outputs_agree(root, name):
    rj, rt = os.path.join(root, "result_jax"), os.path.join(root, "result_torch")
    for suffix in (".png", ".png.res.png", ".png.giv.png"):
        a = jio.load_image01(os.path.join(rj, name + suffix))
        b = tio.load_image01(os.path.join(rt, name + suffix))
        assert a.shape == b.shape == (128, 256)
        d = np.abs(np.round(a * 65535).astype(np.int64)
                   - np.round(b * 65535).astype(np.int64))
        assert d.max() <= 2, (suffix, d.max())
    keys_j, vals_j = _aligned(os.path.join(rj, name + ".aligned.txt"))
    keys_t, vals_t = _aligned(os.path.join(rt, name + ".aligned.txt"))
    assert keys_t == keys_j
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-4, atol=2e-6)


@pytest.mark.parametrize("depth_ext", [".png", ".jpg"])
def test_cli_with_stage_a_matches_jax(tmp_path, depth_ext, capsys):
    """The CLIs without --no-extract: ``.png`` views under --pmap-ext .png,
    and ``.jpg`` views and a ``.jpg`` baseline at the default --pmap-ext."""
    root = str(tmp_path)
    names = _verify_scene(root, depth_ext)
    extra = ("--pmap-ext", ".png") if depth_ext == ".png" else ()
    _run_both(root, *extra)
    out = capsys.readouterr().out
    assert out.count("[run_batch] stage A done in") == 2
    _assert_outputs_agree(root, names[0])
    # stage A wrote the second panorama's RGB views in both packages
    lt = MergeConfig(layout_name="3fold").layout
    for v in range(lt.num_views):
        f = f"{names[1]}.{lt.view_tag(v)}{depth_ext}"
        a = jio.load_image01(os.path.join(root, "views_jax", f))
        b = tio.load_image01(os.path.join(root, "views_torch", f))
        assert a.shape == b.shape and a.shape[1] == 1024 and a.ndim == 3
        if depth_ext == ".png":  # lossless: only the f32 flips differ
            d = np.abs(a - b) * 255
            assert d.max() <= 1.01 and (d > 0.5).mean() < 1e-3
    for side in ("jax", "torch"):
        man = os.path.join(root, f"result_{side}", "manifest.json")
        with open(man) as fp:
            text = fp.read()
        assert f'"{names[0]}"' in text and "quarantined" in text
    # resume: the views exist and the result too
    _run_both(root, *extra)
    out = capsys.readouterr().out
    assert out.count("0/2 skip!") == 2


def test_true_f32_restores_the_callers_flags(monkeypatch):
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cd.allow_tf32)
    seen = []

    def spy(fn):
        def wrapped(*args, **kw):
            seen.append((mm.allow_tf32, cd.allow_tf32))
            return fn(*args, **kw)
        return wrapped

    try:
        for flags in ((True, True), (True, False), (False, True)):
            mm.allow_tf32, cd.allow_tf32 = flags
            with tpipeline.true_f32():
                assert (mm.allow_tf32, cd.allow_tf32) == (False, False)
            assert (mm.allow_tf32, cd.allow_tf32) == flags
        with pytest.raises(KeyError):
            with tpipeline.true_f32():
                raise KeyError("restored on the way out")
        assert (mm.allow_tf32, cd.allow_tf32) == (False, True)

        # the entry points: flags as the caller left them, TF32 off inside,
        # and the same output as with TF32 off throughout
        monkeypatch.setattr(tpipeline.registration, "register_views",
                            spy(tpipeline.registration.register_views))
        monkeypatch.setattr(te, "predict_depth01", spy(te.predict_depth01))
        sc = tiny_scene()
        persp, _ = te.load_model_checkpoint(PERSP, device="cpu")
        base, _ = te.load_model_checkpoint(BASE, device="cpu")
        rgb = torch.as_tensor(_rgb_panorama(3, 64)[None].astype(np.float32))
        cfg = MergeConfig(layout_name="3fold", out_width=128)
        full, _, _ = te.build_batched_e2e(persp, cfg, view_width=64,
                                          base_model=base, base_w=64,
                                          device="cpu")
        outs = {}
        for flags in ((False, False), (True, True)):
            mm.allow_tf32, cd.allow_tf32 = flags
            seen.clear()
            merged, _ = tpipeline.merge_arrays(sc["emap"], sc["pmaps"],
                                               sc["tcfg"], device="cpu")
            e2e_out, _ = full(rgb)
            assert (mm.allow_tf32, cd.allow_tf32) == flags
            assert seen and all(s == (False, False) for s in seen), seen
            outs[flags] = (merged.numpy(), e2e_out.numpy())
        for a, b in zip(outs[(False, False)], outs[(True, True)]):
            np.testing.assert_array_equal(a, b)
    finally:
        mm.allow_tf32, cd.allow_tf32 = saved


def test_port_path_runs_without_pillow_jax_or_panodepth(tmp_path):
    """Stage A, the merge and the model mode on JPEG panoramas, in a
    process where Pillow, JAX and the JAX package cannot be imported."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("PIL", "jax", "panodepth"):
            sys.modules[name] = None  # any import of them now fails
        sys.path.insert(0, {ROOT!r})
        import os
        import numpy as np
        from panodepth_torch import cli, io as pio
        root = {str(tmp_path)!r}
        for d in ("rgb", "gt", "baseline", "views"):
            os.makedirs(os.path.join(root, d))
        az = np.linspace(0, 2 * np.pi, 128, endpoint=False)[None, :]
        ze = np.linspace(0, np.pi, 64)[:, None]
        for k in range(2):
            rgb = np.stack([0.5 + 0.3 * np.sin(az + k) * np.sin(ze),
                            0.5 + 0.2 * np.cos(ze + 0 * az),
                            0.4 + 0.2 * np.cos(2 * az - ze)], -1)
            pio.save_jpg(os.path.join(root, "rgb", f"p{{k}}.jpg"), rgb)
            pio.save_jpg(os.path.join(root, "baseline", f"p{{k}}.jpg"),
                         rgb[::2, ::2, 1])
            pio.save_png16(os.path.join(root, "gt", f"p{{k}}.png"),
                           pio.to_uint16(rgb[..., 2]))
        head = ["0"] + [os.path.join(root, d) for d in
                        ("rgb", "gt", "baseline")]
        common = ["--layout", "3fold", "--out-width", "256", "--device",
                  "cpu"]
        cli.main(head + [os.path.join(root, "result")] + common
                 + ["--views-folder", os.path.join(root, "views")])
        assert len(os.listdir(os.path.join(root, "views"))) == 18
        cli.main(head + [os.path.join(root, "result_e2e")] + common
                 + ["--persp-ckpt", {PERSP!r}, "--baseline-ckpt", {BASE!r}])
        for res in ("result", "result_e2e"):
            for k in range(2):
                out = pio.read_png(os.path.join(root, res, f"p{{k}}.png"))
                assert out.shape == (128, 256) and out.dtype == np.uint16
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("PIL", "jax", "panodepth") and sys.modules[m] is not None]
        print("ok", bad)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok []"
