"""The plain reference (``portbench/reference``) against the program at
the tiny layout, with the program's nets in float32: the nets' outputs
agree to float32 rounding, the reference's registration fits each view at
least as well as the program's (least squares by QR in float64 against
the program's float32 normal equations), and its fusion gives the program's
u16 panorama bit for bit from the same maps and float32 cubics.  The reference
imports nothing of the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tiny import ROOT, cell

from portbench.harness.pool import make_pool
from portbench.reference import layout as L
from portbench.reference.e2e import CLAMP, Reference, fit_cubic


@pytest.fixture(scope="module", params=["e2e_nf_b8", "e2e_int8_b8"])
def both(request):
    from panodepth_torch import e2e as te

    c = cell(request.param)
    cfg = c.config
    persp, _ = te.load_model_checkpoint(
        str(ROOT / cfg["perspective"]["checkpoint"]), device="cpu",
        dtype=torch.float32, quantize=cfg["perspective"]["int8"])
    base, _ = te.load_model_checkpoint(
        str(ROOT / cfg["baseline"]["checkpoint"]), device="cpu",
        dtype=torch.float32)
    from portbench.harness import program

    _, models, fuse = te.build_batched_e2e(
        persp, program.merge_config(cfg), view_width=32, base_model=base,
        base_w=128, device="cpu")
    rgb = torch.from_numpy(make_pool(5, 2, cfg["rgb_shape"], "cpu"))
    return cfg, models, fuse, Reference(cfg, str(ROOT), "cpu"), rgb


def test_nets_agree(both):
    cfg, models, _, ref, rgb = both
    bases, pmaps = models(rgb)
    for k in range(rgb.shape[0]):
        rb, rp = ref.models(rgb[k].float() / 255.0)
        assert (bases[k] - rb).abs().max() < 1e-5
        for v in range(len(rp)):
            # the int8 graph's codes flip where float32 roundings differ
            tol = 2e-2 if cfg["perspective"]["int8"] else 1e-5
            assert (pmaps[v][k] - rp[v]).abs().max() < tol


def test_registration_is_least_squares(both):
    from panodepth_torch import registration as R

    from portbench.harness.program import merge_config

    cfg, models, _, ref, rgb = both
    bases, pmaps = models(rgb)
    for k in range(rgb.shape[0]):
        pm = [p[k] for p in pmaps]
        got = R.register_views_batched(bases[k:k + 1], [p[None] for p in pm],
                                       merge_config(cfg))[0]
        for v in range(len(pm)):
            d0, d1 = _samples(ref, bases[k], pm[v], v)
            want = fit_cubic(d0, d1)
            assert _rss(d0, d1, want) <= _rss(d0, d1, got[v]) * (1 + 1e-9)
            assert torch.allclose(ref.register(bases[k], pm)[v], want,
                                  rtol=1e-9, atol=0)


def _rss(d0, d1, c):
    c = c.double()
    return float((((c[0] * d0 + c[1]) * d0 + c[2]) * d0 + c[3] - d1)
                 .pow(2).sum())


def _samples(ref, emap, pm, v):
    x, y, azi, zen = L.sample_grid(ref.fovs[v], ref.ranges[v])
    he, we = emap.shape
    hp, wp = pm.shape
    d0 = pm[np.clip((y * (hp - 1)).astype(int), 0, hp - 1),
            np.clip((x * (wp - 1)).astype(int), 0, wp - 1)]
    d1 = emap[np.clip((zen / np.pi * (he - 1)).astype(int), 0, he - 1),
              np.clip((azi / L.TWO_PI * (we - 1)).astype(int), 0, we - 1)]
    return tuple(torch.clamp(t, *CLAMP).double().reshape(-1)
                 for t in (d0, d1))


def test_fusion_is_bit_equal(both):
    from panodepth_torch import registration as R

    cfg, models, fuse, ref, rgb = both
    bases, pmaps = models(rgb)
    out, _ = fuse(bases, pmaps)
    from portbench.harness.program import merge_config

    abcd = R.register_views_batched(bases, pmaps, merge_config(cfg))
    want = ref.fuse(bases, [[p[k] for p in pmaps]
                            for k in range(rgb.shape[0])], abcd)
    assert torch.equal(out.to(torch.int32), want)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference"
            ".e2e, portbench.counts.work; print(sorted({m.split('.')[0] for "
            "m in sys.modules} & {'panodepth_torch', 'panodepth', 'jax', "
            "'flax', 'jaxlib', 'optax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
