"""The port's e2e serving artifact (``panodepth_torch.serve.export_e2e``)
against the JAX package's (``panodepth.serve.export_e2e``): the zoo's
trained NF perspective net and FastPanoNet, both packages' nets in f32, at
tests/test_torch_e2e.py's sizes (its two-view layout, out 64, views 64,
the baseline net 64 wide: the checkpoints' sidecars say so), u8 64x128 RGB,
batch 2.

Bars: against JAX within max 4 / mean 0.5 u16 (tests/test_torch_e2e.py's
f32 bar, pinned at this layout in ROADMAP Queue 3); against the port's
eager ``full`` bit-equal, also after a load in a fresh process.  The export
is the first thing the nets and the device caches see: the eager graph
after it, on the same nets, returns real tensors, bit-equal to a fresh
process's eager run.  Then the fake-parameter path of
``models/layers.Derived`` and the kernels' operators on meta tensors.
"""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import e2e as je
from panodepth import serve as jserve
from panodepth.config import MergeConfig as JaxMergeConfig
from panodepth.config import ViewLayout, register_layout

import panodepth_torch.config as tconfig
from panodepth_torch import e2e as te
from panodepth_torch import fusion as tfusion
from panodepth_torch import registration as tregistration
from panodepth_torch import serve as tserve
from panodepth_torch.kernels import groupnorm as kg
from panodepth_torch.kernels import jacobi as kj
from panodepth_torch.models import layers
from panodepth_torch.models import fastpano as tfastpano
from panodepth_torch.ops import projection as tprojection

from conftest import make_equirect
from torch_port_common import zoo_pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERSP = os.path.join(ROOT, "zoo", "perspective_final.params.npz")
BASE = os.path.join(ROOT, "zoo", "fastpano_final.params.npz")
D2R = math.pi / 180.0
F32_BAR = (4, 0.5)

# tests/test_torch_e2e.py's two views, under a name of this module's own
FOVS = np.array([(25 * D2R, 175 * D2R, 30 * D2R, 150 * D2R),
                 (185 * D2R, 355 * D2R, 30 * D2R, 150 * D2R)])
RANGES = np.array([(170 * D2R, 30 * D2R, 40 * D2R, 140 * D2R),
                   (350 * D2R, 190 * D2R, 40 * D2R, 140 * D2R)])
register_layout(ViewLayout("serve_e2e", fovs=FOVS, ranges=RANGES))
tconfig.layout_from_arrays("serve_e2e", FOVS, RANGES)
JCFG = JaxMergeConfig(layout_name="serve_e2e", out_width=64)
TCFG = tconfig.MergeConfig(layout_name="serve_e2e", out_width=64)

_JAX_LOAD = je.load_model_checkpoint
_PORT_LOAD = te.load_model_checkpoint


def _rgbs():
    """Two u8 (64, 128, 3) panoramas: smooth colour fields and noise."""
    rng = np.random.RandomState(3)
    out = []
    for k in range(2):
        az = np.linspace(0, 2 * np.pi, 128, endpoint=False)[None, :]
        ze = np.linspace(0, np.pi, 64)[:, None]
        r = 0.5 + 0.3 * np.sin(3 * az + k) * np.sin(ze)
        g = np.broadcast_to(0.5 + 0.3 * np.cos(2 * ze + az), (64, 128))
        img = np.stack([r, g, make_equirect(128, 64)], -1)
        img = np.clip(img + 0.05 * rng.rand(64, 128, 3), 0, 1)
        out.append((img * 255 + 0.5).astype(np.uint8))
    return np.stack(out)


def _f32_jax_loader(path, **kw):
    model, params, arch = _JAX_LOAD(path, **kw)
    return model.clone(dtype=jnp.float32), params, arch


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_e2e")
    path = str(tmp / "e2e.pt2")
    # the baseline net 64 wide, as in tests/test_torch_e2e.py (where the
    # f32 bar is pinned)
    ckpts = zoo_pair(str(tmp), 64)
    nets = []

    def port_loader(ckpt, **kw):
        net, arch = _PORT_LOAD(ckpt, **dict(kw, dtype=torch.float32))
        nets.append(net)
        return net, arch

    # the export is the first call of the nets and of the device caches
    for cache in (tfusion._on_device, tfusion._inv_cov,
                  tregistration._device_tables, tprojection._taps,
                  tfastpano._latitude_on_device):
        cache.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te, "load_model_checkpoint", port_loader)
        program = tserve.export_e2e(path, TCFG, batch=2, persp_ckpt=ckpts[0],
                                    baseline_ckpt=ckpts[1],
                                    rgb_shape=(64, 128), view_width=64,
                                    device="cpu")
    rgbs = _rgbs()
    # the nets the export ran, called eagerly after it
    full, _, _ = te.build_batched_e2e(nets[0], TCFG, view_width=64,
                                      base_model=nets[1], base_w=64,
                                      device="cpu")
    kj.LAUNCHES = kg.LAUNCHES = 0
    eager = full.eager(torch.from_numpy(rgbs))
    assert kj.LAUNCHES == kg.LAUNCHES == 0  # the CPU runs no kernel
    jpath = str(tmp / "e2e.xla")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je, "load_model_checkpoint", _f32_jax_loader)
        jserve.export_e2e(jpath, JCFG, batch=2, persp_ckpt=ckpts[0],
                          baseline_ckpt=ckpts[1], rgb_shape=(64, 128),
                          view_width=64)
    j_out = jserve.load(jpath)(jnp.asarray(rgbs))[0]
    return dict(path=path, program=program, rgbs=rgbs, eager=eager, tmp=tmp,
                j=np.asarray(j_out), meta=tserve.read_meta(path)[0])


_XPROC = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)  # the CPU convs' sum order, as in this process
sys.path.insert(0, sys.argv[4])
import panodepth_torch.config as tconfig
from panodepth_torch import e2e, serve
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
data = np.load(sys.argv[2])
rgbs = data["rgbs"]
out = serve.load(sys.argv[1])(rgbs)
tconfig.layout_from_arrays("serve_e2e", data["fovs"], data["ranges"])
nets = [e2e.load_model_checkpoint(p, device="cpu", dtype=torch.float32)[0]
        for p in (data["persp"].item(), data["base"].item())]
full, _, _ = e2e.build_batched_e2e(
    nets[0], tconfig.MergeConfig(layout_name="serve_e2e", out_width=64),
    view_width=64, base_model=nets[1], base_w=64, device="cpu")
eager = full.eager(torch.from_numpy(rgbs))
np.savez(sys.argv[3], out=out[0].numpy(), base=out[1].numpy(),
         eager_out=eager[0].numpy(), eager_base=eager[1].numpy())
"""


@pytest.fixture(scope="module")
def xproc(e2e):
    """The artifact loaded and run, and the eager graph run, in a fresh
    process that imports no JAX."""
    tmp = e2e["tmp"]
    np.savez(tmp / "in.npz", rgbs=e2e["rgbs"], fovs=FOVS, ranges=RANGES,
             persp=PERSP, base=BASE)
    r = subprocess.run(
        [sys.executable, "-c", _XPROC, e2e["path"], str(tmp / "in.npz"),
         str(tmp / "out.npz"), ROOT], capture_output=True, text=True,
        timeout=600, cwd=str(tmp))
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def test_e2e_artifact_matches_jax(e2e, xproc):
    out = xproc["out"]
    assert out.shape == e2e["j"].shape == (2, 32, 64)
    assert out.dtype == np.uint16
    d = np.abs(out.astype(np.int64) - e2e["j"].astype(np.int64))
    assert d.max() <= F32_BAR[0] and d.mean() < F32_BAR[1], (d.max(),
                                                             d.mean())


def test_e2e_artifact_bit_equal_to_eager(e2e, xproc):
    """The artifact, loaded in a fresh process, against the eager graph
    here (after the export) and there (no export in that process)."""
    out, base = e2e["eager"]
    for want in (out, base):
        assert type(want) is torch.Tensor  # not a tracer's fake tensor
    for key, want in (("out", out), ("base", base), ("eager_out", out),
                      ("eager_base", base)):
        np.testing.assert_array_equal(xproc[key], want.numpy())


def test_e2e_artifact_meta(e2e):
    meta = e2e["meta"]
    assert meta["kind"] == "e2e" and meta["view_width"] == 64
    assert meta["in_shapes"] == [[2, 64, 128, 3]]
    assert meta["in_dtypes"] == ["uint8"] and meta["device"] == "cpu"
    assert meta["persp"] == "perspective" and meta["baseline"] == "fastpano"
    # the CPU routes run the plain versions: no kernel operator
    assert meta["kernels"] == tserve.kernel_nodes(e2e["program"]) == {}
    # the conv kernels are constants of the program, cast once: the graph
    # casts no net weight per call
    assert not any(n.op == "placeholder" and n.name.startswith("p_")
                   for n in e2e["program"].graph.nodes)


class _Owner(torch.nn.Module):
    """A bf16 conv that is the traced module's own submodule: the tracer
    makes its parameters fake."""

    def __init__(self):
        super().__init__()
        self.conv = layers.Conv(3, 4)

    def forward(self, x):
        return self.conv(x)


def test_derived_under_fake_parameters():
    """A Derived module whose parameters the tracer made fake refuses,
    before an eager call and after one: a cast kept from an eager call
    could be older than the parameters it is exported with."""
    torch.manual_seed(0)
    x = torch.rand(1, 3, 8, 8)
    owner = _Owner()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="fake parameters"):
            torch.export.export(owner, (x,), strict=False)
        owner(x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_ops_fake_on_meta(dtype):
    """The operators' fake implementations give the kernels' output shapes
    and dtypes (what an exported graph records)."""
    x = torch.empty(2, 8, 5, 7, dtype=dtype, device="meta")
    c = torch.empty(8, device="meta")
    for out_dtype in (torch.bfloat16, torch.float32):
        y = torch.ops.panodepth_torch.group_norm(x, c, c, 4, 1e-6, True,
                                                 out_dtype)
        assert y.shape == x.shape and y.dtype == out_dtype
        assert y.device.type == "meta"
    buf = torch.empty(3, 16, 40, device="meta")
    cov = torch.empty(16, 40, dtype=torch.bool, device="meta")
    y = torch.ops.panodepth_torch.jacobi(buf, buf, cov, 7, 0.5, 1e-4)
    assert y.shape == buf.shape and y.dtype == torch.float32
    # no CPU implementation: the operator raises on CPU tensors
    with pytest.raises(NotImplementedError):
        torch.ops.panodepth_torch.jacobi(torch.zeros(4, 4), torch.zeros(4, 4),
                                         torch.ones(4, 4, dtype=torch.bool),
                                         1, 0.5, 1e-4)
