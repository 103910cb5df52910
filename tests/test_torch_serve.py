"""Serving artifacts of the port (``panodepth_torch.serve``) against the JAX
package's (``panodepth.serve``): the merge artifact, exported on the CPU
with the plain Jacobi, at the JAX tests' sizes (3fold, out 256, u16 64x128
baselines and 96x128 views, batch 2).

Bars: the port's artifact against JAX's ``jnp`` artifact within 1 u16 (XLA
on the CPU divides by a reciprocal multiply; ROADMAP Queue 3) and abcd
within 1e-4; against the port's own eager merge bit-equal, also after a
load in a fresh process.  The export runs before any eager merge of the
process (the device caches cleared first): the eager merge after it
returns real tensors, bit-equal to a fresh process's.
"""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panodepth import serve as jserve
from panodepth.config import MergeConfig as JaxMergeConfig

from panodepth_torch import fusion as tfusion
from panodepth_torch import pipeline as tpipeline
from panodepth_torch import registration as tregistration
from panodepth_torch import serve as tserve
import panodepth_torch.config as tconfig
from panodepth_torch.config import MergeConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = MergeConfig(out_width=256, layout_name="3fold")
JCFG = JaxMergeConfig(out_width=256, layout_name="3fold")
SHAPES = dict(emap_shape=(64, 128), pmap_shape=(96, 128))


def _inputs(seed=0, b=2):
    rng = np.random.RandomState(seed)
    v = TCFG.layout.num_views
    return (rng.randint(0, 65536, (b, 64, 128)).astype(np.uint16),
            rng.randint(0, 65536, (b, v, 96, 128)).astype(np.uint16))


@pytest.fixture(scope="module")
def merge(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    path = str(tmp / "merge.pt2")
    # the export is the first merge of this process: no table cached yet
    for cache in (tfusion._on_device, tfusion._inv_cov,
                  tregistration._device_tables):
        cache.cache_clear()
    program = tserve.export_merge(path, TCFG, batch=2, dtype="uint16",
                                  jacobi="auto", device="cpu", **SHAPES)
    emaps, pmaps = _inputs()
    fn = tpipeline._merge_fn(TCFG, "auto")
    eager = fn(torch.from_numpy(emaps), torch.from_numpy(pmaps))
    art = tserve.load(path)
    got = art(emaps, pmaps)
    jpath = str(tmp / "merge.xla")
    jserve.export_merge(jpath, JCFG, batch=2, dtype="uint16",
                        jacobi_kind="jnp", **SHAPES)
    j_out, j_abcd = jserve.load(jpath)(jnp.asarray(emaps), jnp.asarray(pmaps))
    return dict(path=path, program=program, art=art, emaps=emaps,
                pmaps=pmaps, eager=eager, got=got, tmp=tmp,
                j=(np.asarray(j_out), np.asarray(j_abcd)))


def test_merge_artifact_matches_jax(merge):
    out, abcd = merge["got"]
    j_out, j_abcd = merge["j"]
    assert out.shape == j_out.shape == (2, 128, 256)
    assert out.dtype == torch.uint16
    d = np.abs(out.numpy().astype(np.int64) - j_out.astype(np.int64))
    assert d.max() <= 1, d.max()
    np.testing.assert_allclose(abcd.numpy(), j_abcd, rtol=0, atol=1e-4)


def test_merge_artifact_bit_equal_to_eager(merge):
    for got, want in zip(merge["got"], merge["eager"]):
        assert type(want) is torch.Tensor  # not a tracer's fake tensor
        assert torch.equal(got, want)
    # the compiled form (eager on the CPU) and a second call agree too
    again = merge["art"](*_inputs())
    batched = tpipeline.compiled_merge_batched(TCFG, "auto", "cpu")(
        *_inputs())
    for a, b, c in zip(again, batched, merge["eager"]):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_merge_artifact_meta(merge):
    meta = merge["art"].meta
    assert meta["kind"] == "merge" and meta["batch"] == 2
    assert meta["in_shapes"] == [[2, 64, 128], [2, 9, 96, 128]]
    assert meta["in_dtypes"] == ["uint16", "uint16"]
    assert meta["device"] == "cpu" and meta["torch"] == torch.__version__
    assert meta["tf32"] is False and meta["layout"] == "3fold"
    assert meta["out_width"] == 256 and meta["dtype"] == "uint16"
    # the CPU route runs the plain Jacobi: no kernel operator in the graph
    assert meta["kernels"] == tserve.kernel_nodes(merge["program"]) == {}
    with open(merge["path"] + ".meta.json") as fp:
        assert json.load(fp) == meta


_XPROC = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)  # the CPU's sum order, as in this process
sys.path.insert(0, sys.argv[4])
from panodepth_torch import pipeline, serve
import panodepth_torch.config as tconfig
from panodepth_torch.config import MergeConfig
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
art = serve.load(sys.argv[1])
data = np.load(sys.argv[2])
ins = [data[k] for k in sorted(data.files)]
out = art(*ins)
eager = pipeline._merge_fn(MergeConfig(out_width=256, layout_name="3fold"),
                           "auto")(*[torch.from_numpy(a) for a in ins])
np.savez(sys.argv[3], out=out[0].numpy(), abcd=out[1].numpy(),
         eager_out=eager[0].numpy(), eager_abcd=eager[1].numpy())
"""


def test_merge_artifact_cross_process(merge):
    """A fresh process that imports no JAX loads the artifact: the same
    bits; its eager merge (no export in that process) gives the bits the
    eager merge gave here after the export."""
    tmp = merge["tmp"]
    np.savez(tmp / "in.npz", a0=merge["emaps"], a1=merge["pmaps"])
    r = subprocess.run(
        [sys.executable, "-c", _XPROC, merge["path"], str(tmp / "in.npz"),
         str(tmp / "out.npz"), ROOT], capture_output=True, text=True,
        timeout=600, cwd=str(tmp))
    assert r.returncode == 0, r.stderr[-3000:]
    got = np.load(tmp / "out.npz")
    out, abcd = merge["eager"]
    for key, want in (("out", out), ("abcd", abcd), ("eager_out", out),
                      ("eager_abcd", abcd)):
        np.testing.assert_array_equal(got[key], want.numpy())


def test_load_without_sidecar_describe_and_run(merge, capsys):
    """Only the .pt2 deployed: shapes, dtypes and device come from the
    program's placeholders; describe and run work through main."""
    bare = str(merge["tmp"] / "bare.pt2")
    shutil.copy(merge["path"], bare)
    assert tserve.main(["describe", merge["path"]]) == 0  # the sidecar's
    out = capsys.readouterr().out
    assert "merge graph for cpu" in out and "[2, 64, 128]:uint16" in out
    art = tserve.load(bare)
    assert art.meta["in_dtypes"] == ["uint16", "uint16"]
    assert art.meta["in_shapes"][0] == [2, 64, 128]
    assert art.meta["device"] == "cpu" and art.meta["kernels"] == {}
    assert "sidecar missing" in art.describe()
    for got, want in zip(art(*_inputs()), merge["eager"]):
        assert torch.equal(got, want)
    assert tserve.main(["run", bare]) == 0
    out = capsys.readouterr().out
    assert "ran ok" in out and "sidecar missing" in out
    assert "(2, 128, 256)" in out


def test_call_runs_without_tf32_and_restores_flags(merge):
    art = merge["art"]
    seen = []
    eager = art.graphed.eager

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return eager(*args)

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    art.graphed.eager = spy
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        art(*_inputs())
        assert seen == [(False, False)]
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        art.graphed.eager = eager
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_load_refuses_another_device(merge):
    with pytest.raises(ValueError, match="exported for cpu"):
        tserve.load(merge["path"], device="meta")


def test_load_gives_the_saved_program(merge):
    """``serve.load`` adds nothing to the program: its graph and signature
    are ``torch.export.load``'s."""
    got = tserve.load(merge["path"]).program
    want = torch.export.load(merge["path"])
    assert str(got.graph) == str(want.graph)
    assert got.graph_signature == want.graph_signature


def test_int8_program_names_both_kernel_operators():
    """A ``--persp-int8`` program on the card holds each QConv as two
    kernel nodes, ``panodepth_torch::quantize_nhwc`` and
    ``panodepth_torch::qconv``: one QConv's ops traced by ``torch.export``
    on fake CUDA tensors (no card needed) and counted by
    ``serve.kernel_nodes`` under the names ``serve.KERNEL_OPS`` lists."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from panodepth_torch.kernels import qconv as kq

    class QConvOps(torch.nn.Module):
        def forward(self, x, wq, scale, bias):
            xq, sx = kq.quantize_nhwc(x, "kernel")
            return kq.resolve("kernel")(xq, wq, sx, scale, bias, (3, 3),
                                        (1, 1), ((1, 1), (1, 1)))

    with FakeTensorMode():
        ep = torch.export.export(QConvOps(), (
            torch.empty(1, 32, 8, 8, device="cuda"),
            torch.empty(16, 320, dtype=torch.int8, device="cuda"),
            torch.empty(16, device="cuda"), torch.empty(16, device="cuda")))
    ops = (f"{kq.OPS}::qconv", f"{kq.OPS}::quantize_nhwc")
    assert set(ops) <= set(tserve.KERNEL_OPS)
    assert tserve.kernel_nodes(ep) == {op: 1 for op in ops}


def test_export_refuses_persp_int8_and_cuda_without_card(tmp_path, capsys):
    """``export-e2e --persp-int8`` (refused until it was ported) exports the
    zoo GN perspective net's int8 graph beside FastPanoNet on the CPU (two
    views 64 wide, out 64, u8 64x128 RGB, batch 1; the baseline net 64
    wide): the artifact loads and runs bit-equal to the in-process graph
    (the plain int8 conv in the program: the CPU has no kernel).  The
    CUDA export without a card is refused."""
    from panodepth_torch import e2e as te

    import math

    d2r = math.pi / 180.0
    fovs = np.array([(25 * d2r, 175 * d2r, 30 * d2r, 150 * d2r),
                     (185 * d2r, 355 * d2r, 30 * d2r, 150 * d2r)])
    ranges = np.array([(170 * d2r, 30 * d2r, 40 * d2r, 140 * d2r),
                       (350 * d2r, 190 * d2r, 40 * d2r, 140 * d2r)])
    tconfig.layout_from_arrays("serve_int8", fovs, ranges)
    zoo = os.path.join(ROOT, "zoo")
    ckpts = []
    for sub, name, width in (("gn", "perspective", None),
                             ("", "fastpano", 64)):
        src = os.path.join(zoo, sub, f"{name}_final.params.npz")
        os.symlink(src, tmp_path / os.path.basename(src))
        with open(os.path.join(zoo, sub, f"{name}.config.json")) as fp:
            arch = json.load(fp)
        if width:
            arch["pano_width"] = width
        (tmp_path / f"{name}.config.json").write_text(json.dumps(arch))
        ckpts.append(str(tmp_path / os.path.basename(src)))
    path = str(tmp_path / "int8.pt2")
    assert tserve.main(["export-e2e", path, "--persp-ckpt", ckpts[0],
                        "--baseline-ckpt", ckpts[1], "--persp-int8",
                        "--batch", "1", "--rgb-shape", "64x128",
                        "--out-width", "64", "--layout", "serve_int8",
                        "--view-width", "64", "--device", "cpu"]) == 0
    assert "[serve] wrote" in capsys.readouterr().out
    art = tserve.load(path)
    assert art.meta["persp_int8"] is True and art.meta["kernels"] == {}
    persp, _ = te.load_model_checkpoint(ckpts[0], device="cpu",
                                        quantize=True)
    base, _ = te.load_model_checkpoint(ckpts[1], device="cpu")
    full, _, _ = te.build_batched_e2e(
        persp, MergeConfig(layout_name="serve_int8", out_width=64),
        view_width=64, base_model=base, base_w=64, device="cpu")
    rgb = np.random.RandomState(4).randint(0, 256, (1, 64, 128, 3)).astype(
        np.uint8)
    got, want = art(rgb), full.eager(torch.tensor(rgb))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.export_merge(str(tmp_path / "m.pt2"), TCFG, batch=1,
                                **SHAPES)
