"""The kernels' wrappers (Jacobi and GroupNorm): routing, launch counting,
argument checks, the nvcc build's naming, and (on a CUDA card only) each
kernel against its plain twin.

The card tests carry the ``cuda`` marker and skip without a card; the
decision is made inside the fixture, never at import.  On a card, run
them with ``python -m pytest --noconftest tests/test_torch_kernels.py -m
cuda`` (this file needs neither JAX nor ``tests/conftest.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from panodepth_torch.kernels import _build
from panodepth_torch.kernels import groupnorm as kgn
from panodepth_torch.kernels import jacobi as kj
from panodepth_torch.models import norm as tnorm

torch.set_num_threads(1)


def _case(h, w, seed, device="cpu"):
    rng = np.random.RandomState(seed)
    buf = torch.tensor(rng.rand(h, w).astype(np.float32), device=device)
    tgt = torch.tensor(rng.normal(0, 0.01, (h, w)).astype(np.float32),
                       device=device)
    cov = rng.rand(h, w) < 0.6
    cov[0], cov[-1], cov[:, 0], cov[:, -1] = True, True, True, True
    return buf, tgt, torch.tensor(cov, device=device)


def test_auto_on_cpu_routes_to_plain_and_counts_no_launch():
    buf, tgt, cov = _case(16, 32, 0)
    before = kj.LAUNCHES
    got = kj.resolve("auto")(buf, tgt, cov, 9, 0.5, 1e-4)
    assert kj.LAUNCHES == before
    torch.testing.assert_close(got, kj.jacobi_plain(buf, tgt, cov, 9, 0.5,
                                                    1e-4), rtol=0, atol=0)
    assert kj.resolve("torch") is kj.jacobi_plain
    assert kj.resolve("kernel") is kj.cuda_jacobi
    with pytest.raises(ValueError, match="jacobi must be one of"):
        kj.resolve("pallas")


@pytest.mark.parametrize("bad", ["cpu_tensor", "f64", "shape", "strided",
                                 "batched_cov"])
def test_cuda_jacobi_refuses_bad_arguments(bad):
    on_card = bad != "cpu_tensor" and torch.cuda.is_available()
    buf, tgt, cov = _case(8, 16, 1, device="cuda" if on_card else "cpu")
    args = dict(buf=buf, target=tgt, covered=cov)
    if bad == "f64":
        args["target"] = tgt.double()
    elif bad == "shape":
        args["covered"] = cov[:4]
    elif bad == "strided":
        args["buf"] = buf.t()
    elif bad == "batched_cov":  # the mask is one (H, W) for the batch
        args = dict(buf=torch.stack([buf, buf]), target=torch.stack([tgt, tgt]),
                    covered=torch.stack([cov, cov]))
    # a CPU tensor fails the device check first; on a card the others fail
    # their own check.  No call launches a kernel or falls back.
    before = kj.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        kj.cuda_jacobi(args["buf"], args["target"], args["covered"], 3,
                       0.5, 1e-4)
    assert kj.LAUNCHES == before


def test_build_names_and_missing_nvcc(monkeypatch, tmp_path):
    path = _build.library_path("jacobi")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libjacobi-")
    assert path == _build.library_path("jacobi")  # stable for one source
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("nvcc is installed at its default place")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,iters", [(256, 512, 200), (512, 1024, 100),
                                       (1024, 2048, 50), (512, 1024, 150),
                                       (1024, 2048, 100), (2048, 4096, 50),
                                       (5, 7, 3), (50, 130, 20),
                                       (24, 64, 1)])
def test_cuda_kernel_bit_equal_to_plain(cuda_device, h, w, iters):
    buf, tgt, cov = _case(h, w, h + iters, device=cuda_device)
    kj.LAUNCHES = 0
    got = kj.cuda_jacobi(buf, tgt, cov, iters, 0.5, 1e-4)
    plan = kj.plan_for(h, w, iters)
    assert kj.LAUNCHES == kj.launches_for(h, w, iters) == plan.launches
    want = kj.jacobi_plain(buf, tgt, cov, iters, 0.5, 1e-4)
    torch.cuda.synchronize()
    # the kernel rounds after every operation, as PyTorch does: bit-equal
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_kernel_zero_iterations_and_input_untouched(cuda_device):
    buf, tgt, cov = _case(8, 16, 3, device=cuda_device)
    keep = buf.clone()
    out = kj.cuda_jacobi(buf, tgt, cov, 0, 0.5, 1e-4)
    assert torch.equal(out, keep) and out.data_ptr() != buf.data_ptr()
    kj.cuda_jacobi(buf, tgt, cov, 5, 0.5, 1e-4)
    torch.cuda.synchronize()
    assert torch.equal(buf, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,iters", [(3, 256, 512, 200),
                                         (3, 1024, 2048, 50),
                                         (2, 50, 130, 20), (4, 5, 7, 3)])
def test_cuda_batched_kernel_equals_plain_and_alone(cuda_device, b, h, w,
                                                    iters):
    """A (B, H, W) batch with one mask: bit-equal to the plain twin and to
    each panorama launched alone, in the launches of one panorama."""
    cases = [_case(h, w, h + k, device=cuda_device) for k in range(b)]
    buf = torch.stack([c[0] for c in cases])
    tgt = torch.stack([c[1] for c in cases])
    cov = cases[0][2]
    kj.LAUNCHES = 0
    got = kj.cuda_jacobi(buf, tgt, cov, iters, 0.5, 1e-4)
    assert kj.LAUNCHES == kj.launches_for(h, w, iters)
    want = kj.jacobi_plain(buf, tgt, cov, iters, 0.5, 1e-4)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k in range(b):
        alone = kj.cuda_jacobi(buf[k].contiguous(), tgt[k].contiguous(), cov,
                               iters, 0.5, 1e-4)
        torch.cuda.synchronize()
        assert torch.equal(got[k], alone)


@pytest.mark.cuda
def test_cuda_graph_merge_equals_eager(cuda_device):
    """compiled_merge (a CUDA graph) and compiled_merge_batched give the
    eager merge's bits; replays launch without ticking the counter."""
    from panodepth_torch import config as tconfig
    from panodepth_torch import graphs, pipeline

    cfg = tconfig.MergeConfig(layout_name="3fold", out_width=256)
    rng = np.random.RandomState(4)
    emaps = rng.uniform(0.2, 0.8, (2, 128, 256)).astype(np.float32)
    pmaps = rng.uniform(0.2, 0.8, (2, 9, 112, 128)).astype(np.float32)
    want = [pipeline.merge_arrays(emaps[k], pmaps[k], cfg) for k in range(2)]
    fn = pipeline.compiled_merge(cfg, "auto", cuda_device)
    fn.clear()
    per = sum(kj.launches_for(lvl.height, lvl.width, lvl.iterations)
              for lvl in pipeline.build_fusion_plan(cfg).levels)
    kj.LAUNCHES = 0
    for k in (0, 1, 0):
        out, abcd = fn(emaps[k], pmaps[k])
        assert torch.equal(out, want[k][0]) and torch.equal(abcd, want[k][1])
    # warm-ups and the capture tick the counter; the replays do not
    assert kj.LAUNCHES == (graphs.WARMUP + 1) * per and len(fn) == 1
    out, abcd = pipeline.compiled_merge_batched(cfg, "auto", cuda_device)(
        emaps, pmaps)
    for k in range(2):
        assert torch.equal(out[k], want[k][0])
        assert torch.equal(abcd[k], want[k][1])


@pytest.mark.cuda
def test_cuda_graph_outlives_evicted_tables(cuda_device):
    """A captured merge replays right after every device-table cache is
    cleared and the freed memory is handed out again: the graph holds the
    tables it reads."""
    from panodepth_torch import config as tconfig
    from panodepth_torch import fusion, pipeline, registration
    from panodepth_torch.models import fastpano
    from panodepth_torch.ops import projection

    cfg = tconfig.MergeConfig(layout_name="3fold", out_width=256)
    rng = np.random.RandomState(5)
    emap = rng.uniform(0.2, 0.8, (128, 256)).astype(np.float32)
    pmaps = rng.uniform(0.2, 0.8, (9, 112, 128)).astype(np.float32)
    want = pipeline.merge_arrays(emap, pmaps, cfg)
    fn = pipeline.compiled_merge(cfg, "auto", cuda_device)
    fn.clear()
    fn(emap, pmaps)  # captured
    for cache in (fusion._on_device, fusion._inv_cov,
                  registration._device_tables, projection._taps,
                  fastpano._latitude_on_device):
        cache.cache_clear()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 20,), -7.0, device=cuda_device)
            for _ in range(64)]
    out, abcd = fn(emap, pmaps)  # replayed
    assert torch.equal(out, want[0]) and torch.equal(abcd, want[1])
    del junk


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda_device):
    """A function that syncs with the host cannot be captured: the call
    raises, and never runs the function eagerly instead."""
    from panodepth_torch import graphs

    def syncs(x):
        return x * float(x.sum())

    g = graphs.Graphed(syncs, cuda_device)
    with pytest.raises(graphs.CaptureError, match="capture failed"):
        g(torch.ones(4, device=cuda_device))
    assert len(g) == 0
    # the card goes on working after the failed capture
    assert float((torch.ones(3, device=cuda_device) * 2).sum()) == 6.0


# --- the GroupNorm kernel (csrc/groupnorm.cu) -----------------------------

def _gn_case(shape, groups, seed, device="cpu", dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.normal(0.3, 1.7, shape).astype(np.float32),
                     device=device).to(dtype)
    c = shape[1]
    scale = torch.tensor(rng.uniform(0.5, 2, c).astype(np.float32),
                         device=device)
    bias = torch.tensor(rng.uniform(-1, 1, c).astype(np.float32),
                        device=device)
    return x, scale, bias


def test_groupnorm_build_name():
    path = _build.library_path("groupnorm")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libgroupnorm-")
    assert "groupnorm" in _build.SOURCES and "jacobi" in _build.SOURCES


@pytest.mark.parametrize("bad", ["cpu_tensor", "f64", "scale_shape",
                                 "groups", "strided"])
def test_cuda_group_norm_refuses_bad_arguments(bad):
    on_card = bad != "cpu_tensor" and torch.cuda.is_available()
    x, scale, bias = _gn_case((2, 8, 4, 4), 4, 1,
                              device="cuda" if on_card else "cpu")
    groups = 4
    if bad == "f64":
        x = x.double()
    elif bad == "scale_shape":
        scale = scale[:4]
    elif bad == "groups":
        groups = 3
    elif bad == "strided":
        x = x.transpose(2, 3)
    before = kgn.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        kgn.cuda_group_norm(x, scale, bias, groups)
    assert kgn.LAUNCHES == before


def _bf16_steps_off(got, want, f32_tol):
    """Largest |got - want| in bf16 steps at ``want``'s magnitude, beyond
    ``f32_tol`` (near 0 the steps are finer than the f32 statistics' own
    error)."""
    w = want.float().abs()
    step = torch.where(w > 0, torch.exp2(torch.floor(torch.log2(w)) - 7),
                       torch.zeros_like(w))
    off = ((got.float() - want.float()).abs() - f32_tol).clamp_min(0)
    return float((off / torch.clamp_min(step, 2.0 ** -133)).max())


def test_bf16_steps_off_counts_steps():
    want = torch.tensor([1.0, 3.0, -0.5]).to(torch.bfloat16)
    got = torch.tensor([1.0078125, 3.0, -0.50390625]).to(torch.bfloat16)
    assert _bf16_steps_off(got, want, 0.0) == 1.0  # one step each
    assert _bf16_steps_off(want, want, 0.0) == 0.0
    zero = torch.zeros(1, dtype=torch.bfloat16)
    tiny = torch.full((1,), 1e-9).to(torch.bfloat16)
    assert _bf16_steps_off(tiny, zero, 0.0) > 1  # 1e-9 from 0
    assert _bf16_steps_off(tiny, zero, 1e-8) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [
    ((1, 24, 128, 256), 8), ((1, 48, 64, 128), 16), ((1, 96, 32, 64), 32),
    ((1, 192, 16, 32), 32), ((1, 384, 8, 16), 32), ((2, 96, 128, 256), 32),
    ((2, 24, 128, 256), 8), ((1, 96, 128, 256), 32), ((1, 4, 512, 1024), 1),
    ((3, 20, 7, 9), 4), ((1, 4, 1, 1), 4),
    # the other zoo families' shapes: group size 1 (HoHoNet, SliceNet),
    # one-row and four-row horizon activations (HoHoNet), the six cube
    # faces (UniFuse-class, BiFuse), one panorama's 15 views (the GN
    # perspective net), and a span shorter than one vector
    ((1, 16, 256, 512), 16), ((1, 16, 128, 256), 16), ((1, 256, 1, 32), 32),
    ((1, 256, 4, 32), 32), ((6, 32, 64, 64), 32), ((6, 256, 8, 8), 32),
    ((15, 32, 128, 128), 32), ((15, 128, 16, 16), 32), ((15, 512, 8, 8), 32),
    ((2, 12, 1, 5), 12)])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [False, True])
def test_cuda_group_norm_matches_plain(cuda_device, shape, groups, in_dtype,
                                       relu):
    """f32 output within 16 f32 ulps of its largest magnitude (at least 1):
    the sums' order differs and rsqrtf is not correctly rounded; bf16
    output within 1 bf16 step at each value beyond that bound."""
    x, scale, bias = _gn_case(shape, groups, sum(shape), cuda_device,
                              in_dtype)
    # (1, 96, 128, 256) in f32 takes the shared-memory opt-in above 48 KB,
    # (1, 4, 512, 1024) in f32 does not fit even 16 blocks (read twice)
    plan = kgn.plan_for(shape[0], shape[1], shape[2] * shape[3], groups,
                        x.element_size())
    if shape == (1, 96, 128, 256) and in_dtype == torch.float32:
        assert plan.opt_in
    if shape == (1, 4, 512, 1024) and in_dtype == torch.float32:
        assert not plan.staged
    for out_dtype in (torch.float32, torch.bfloat16):
        kgn.LAUNCHES = 0
        got = kgn.cuda_group_norm(x, scale, bias, groups, 1e-6, relu,
                                  out_dtype)
        assert kgn.LAUNCHES == kgn.launches_per_call() == 1
        want = kgn.group_norm_plain(x, scale, bias, groups, 1e-6, relu,
                                    out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == x.shape
        assert bool(torch.isfinite(got).all())
        tol = 16 * 2.0 ** -23 * max(1.0, float(want.float().abs().max()))
        if out_dtype == torch.bfloat16:
            assert _bf16_steps_off(got, want, tol) <= 1
        else:
            assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [
    ((2, 24, 128, 256), 8), ((2, 96, 128, 256), 32), ((2, 96, 64, 128), 32),
    ((2, 384, 8, 16), 32), ((3, 20, 6, 10), 4), ((6, 32, 64, 64), 32),
    ((6, 256, 8, 8), 32), ((15, 128, 128, 128), 32), ((15, 512, 8, 8), 32),
    ((2, 16, 256, 512), 16), ((2, 256, 1, 32), 32)])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
def test_cuda_group_norm_batch_invariant(cuda_device, shape, groups,
                                         in_dtype):
    """An image normalises to the same bits alone and in a batch: the
    cluster plan, and so the f32 sum order, does not depend on N.  (The
    vector accesses start at 16-byte addresses, so this holds where an
    image's C*HW is a multiple of 8, as at every FastPanoNet shape;
    (3, 20, 6, 10) has channels of 60, off the vector grid.)"""
    x, scale, bias = _gn_case(shape, groups, sum(shape) + 1, cuda_device,
                              in_dtype)
    both = kgn.cuda_group_norm(x, scale, bias, groups, 1e-6, True)
    for i in range(shape[0]):
        alone = kgn.cuda_group_norm(x[i:i + 1].contiguous(), scale, bias,
                                    groups, 1e-6, True)
        torch.cuda.synchronize()
        assert torch.equal(both[i:i + 1], alone)


@pytest.mark.cuda
def test_cuda_group_norm_constant_group_and_module_route(cuda_device):
    x, scale, bias = _gn_case((2, 8, 16, 16), 4, 5, cuda_device,
                              torch.float32)
    x[:, :2] = 0.1  # group 0: one value, variance ~ 0
    got = kgn.cuda_group_norm(x, scale, bias, 4)
    want = kgn.group_norm_plain(x, scale, bias, 4)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2.0 ** -10
    m = tnorm.GroupNorm(8, 4, fuse_relu=True).to(cuda_device)
    kgn.LAUNCHES = 0
    with torch.no_grad():
        y = m(x.to(torch.bfloat16))  # auto: the kernel on a CUDA tensor
    assert kgn.LAUNCHES == 1 and float(y.min()) >= 0.0
    # the kernel has no backward: under grad (the trainable scale and bias
    # require it) auto takes flax's differentiable form, launching nothing,
    # and the kernel route refuses
    y = m(x.requires_grad_(True))
    y.sum().backward()
    assert kgn.LAUNCHES == 1 and x.grad is not None
    tnorm.set_route(m, "kernel")
    with pytest.raises(RuntimeError, match="no backward"):
        m(x)
    assert kgn.LAUNCHES == 1


@pytest.mark.cuda
def test_cuda_operators_take_any_strides_and_export(cuda_device):
    """The operators (what an exported graph calls) make their inputs
    contiguous themselves, so a channels-last activation or a transposed
    map gets the bits of its contiguous copy; an exported function holds
    each as one node and replays them bit-equal to the eager call."""
    x, scale, bias = _gn_case((2, 32, 12, 20), 8, 7, cuda_device,
                              torch.bfloat16)
    cl = x.to(memory_format=torch.channels_last)
    assert not cl.is_contiguous()
    got = torch.ops.panodepth_torch.group_norm(cl, scale, bias, 8, 1e-6,
                                                True, torch.float32)
    want = kgn.cuda_group_norm(x, scale, bias, 8, 1e-6, True)
    buf, tgt, cov = _case(64, 32, 9, device=cuda_device)
    got_j = torch.ops.panodepth_torch.jacobi(buf.t(), tgt.t(), cov.t(), 20,
                                             0.5, 1e-4)
    want_j = kj.cuda_jacobi(buf.t().contiguous(), tgt.t().contiguous(),
                            cov.t().contiguous(), 20, 0.5, 1e-4)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_j, want_j)

    class Both(torch.nn.Module):
        def forward(self, x, buf, tgt):
            y = kgn.cuda_group_norm(x, scale, bias, 8, 1e-6, True)
            return y, kj.cuda_jacobi(buf, tgt, cov, 20, 0.5, 1e-4)

    program = torch.export.export(Both(), (x, buf, tgt), strict=False)
    names = sorted(n.target.name() for n in program.graph.nodes
                   if isinstance(n.target, torch._ops.OpOverload)
                   and n.target.name().startswith("panodepth_torch::"))
    assert names == ["panodepth_torch::group_norm", "panodepth_torch::jacobi"]
    kgn.LAUNCHES = kj.LAUNCHES = 0
    y, z = program.module()(x, buf, tgt)
    torch.cuda.synchronize()
    assert kgn.LAUNCHES == 1 and kj.LAUNCHES == kj.launches_for(64, 32, 20)
    assert torch.equal(y, want)
    assert torch.equal(z, kj.cuda_jacobi(buf, tgt, cov, 20, 0.5, 1e-4))


# --- the int8 conv (csrc/qconv.cu, kernels/qconv.py) ---


def _qconv_case(n, h, w, cin, cout, k, stride, seed, device="cpu"):
    """Codes, prepared weights, scales, bias and lax's SAME pads of one
    int8 conv, made with numpy from ``seed``."""
    from panodepth_torch.kernels import qconv as kq
    from panodepth_torch.models.layers import same_pads

    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.normal(0, 1, (n, cin, h, w)).astype(np.float32))
    xq, sx = kq.quantize_activation(x.to(torch.bfloat16))
    wq = torch.tensor(rng.randint(-127, 128, (cout, cin, k, k)).astype(
        np.int8))
    scale = torch.tensor(rng.uniform(1e-3, 1e-2, cout).astype(np.float32))
    bias = torch.tensor(rng.normal(0, 0.5, cout).astype(np.float32))
    pads = (same_pads(h, k, stride), same_pads(w, k, stride))
    return tuple(t.to(device) for t in (
        kq.to_nhwc(xq), kq.prepare_weight(wq), sx, scale, bias)) + (
        (k, k), (stride, stride), pads)


def test_qconv_plain_sums_are_exact_and_layouts_pad():
    """The plain twin's float64 conv equals an int64 conv of the same codes
    (stem-like 7x7/2 with 3 channels padded to 16; a 3x3/2 with lax's
    asymmetric pads), and the layouts pad with zeros."""
    from panodepth_torch.kernels import qconv as kq

    for n, h, w, cin, cout, k, s in ((2, 16, 20, 3, 8, 7, 2),
                                     (1, 10, 12, 24, 16, 3, 2)):
        xq, wq, sx, scale, bias, kern, strides, pads = _qconv_case(
            n, h, w, cin, cout, k, s, seed=cin)
        assert xq.shape == (n, h, w, 16 * -(-cin // 16))
        assert wq.shape[1] % 64 == 0 and not wq[:, k * k * xq.shape[3]:].any()
        assert not xq[..., cin:].any()
        sums = kq.qconv_sums_plain(xq, wq, kern, strides, pads)
        x = np.pad(xq.numpy()[..., :cin].astype(np.int64),
                   ((0, 0), pads[0], pads[1], (0, 0)))
        wk = wq[:, :k * k * xq.shape[3]].reshape(cout, k, k, -1).numpy()[
            ..., :cin].astype(np.int64)
        ho, wo = sums.shape[2:]
        want = np.zeros((n, cout, ho, wo), np.int64)
        for r in range(k):
            for c in range(k):
                patch = x[:, r:r + s * ho:s, c:c + s * wo:s, :]
                want += np.einsum("nhwi,oi->nohw", patch, wk[:, r, c, :])
        np.testing.assert_array_equal(sums.numpy(), want)
        y = kq.qconv_plain(xq, wq, sx, scale, bias, kern, strides, pads)
        assert y.dtype == torch.bfloat16 and y.shape == sums.shape


def test_qconv_auto_on_cpu_routes_to_plain_and_counts_no_launch():
    from panodepth_torch.kernels import qconv as kq

    case = _qconv_case(2, 8, 8, 16, 8, 3, 1, seed=1)
    before = kq.LAUNCHES
    got = kq.resolve("auto")(*case)
    assert kq.LAUNCHES == before
    assert torch.equal(got, kq.qconv_plain(*case))
    assert kq.resolve("torch") is kq.qconv_plain
    assert kq.resolve("kernel") is kq.cuda_qconv
    with pytest.raises(ValueError, match="qconv route"):
        kq.resolve("xla")
    assert "qconv" in _build.SOURCES
    assert _build.library_path("qconv").name.startswith("libqconv-")


@pytest.mark.parametrize("bad", ["cpu_tensor", "f32_codes", "cin_16",
                                 "k_64", "scale_shape", "strided"])
def test_cuda_qconv_refuses_bad_arguments(bad):
    from panodepth_torch.kernels import qconv as kq

    on_card = bad != "cpu_tensor" and torch.cuda.is_available()
    xq, wq, sx, scale, bias, kern, strides, pads = _qconv_case(
        1, 8, 8, 16, 8, 3, 1, seed=2, device="cuda" if on_card else "cpu")
    err = ValueError
    if bad in ("cpu_tensor", "f32_codes"):
        err = TypeError
    if bad == "f32_codes":
        xq = xq.float()
    elif bad == "cin_16":
        xq = xq[..., :8].contiguous()
    elif bad == "k_64":
        wq = wq[:, :32].contiguous()
    elif bad == "scale_shape":
        scale = scale[:4].contiguous()
    elif bad == "strided":
        xq = xq.transpose(1, 2)
    if not on_card and bad != "cpu_tensor":
        err = TypeError  # a CPU tensor is refused first
    with pytest.raises(err):
        kq.cuda_qconv(xq, wq, sx, scale, bias, kern, strides, pads)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", [
    (2, 64, 64, 3, 8, 7, 2), (2, 32, 32, 8, 16, 3, 2),
    (2, 32, 32, 8, 16, 1, 2), (3, 17, 23, 40, 24, 3, 1),
    (1, 9, 130, 16, 136, 3, 2)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_cuda_qconv_bit_equal_to_plain(cuda_device, n, h, w, cin, cout, k,
                                       stride, out_dtype):
    """The kernel's int32 sums and output against the plain twin's on the
    same codes: bit-equal, with and without a bias, at odd sizes (pixels
    and channels not multiples of the tile, stride 2 on odd sizes)."""
    from panodepth_torch.kernels import qconv as kq

    xq, wq, sx, scale, bias, kern, strides, pads = _qconv_case(
        n, h, w, cin, cout, k, stride, seed=h + cout, device=cuda_device)
    for b in (bias, None):
        before = kq.LAUNCHES
        y, acc = kq.cuda_qconv_sums(xq, wq, sx, scale, b, kern, strides,
                                    pads, out_dtype)
        y2 = kq.cuda_qconv(xq, wq, sx, scale, b, kern, strides, pads,
                           out_dtype)
        torch.cuda.synchronize()
        assert kq.LAUNCHES == before + 2
        assert torch.equal(acc, kq.qconv_sums_plain(xq, wq, kern, strides,
                                                    pads))
        want = kq.qconv_plain(xq, wq, sx, scale, b, kern, strides, pads,
                              out_dtype)
        assert torch.equal(y, want) and torch.equal(y2, want)


@pytest.mark.cuda
def test_cuda_qconv_small_net_shapes_bit_equal(cuda_device):
    """Every QConv of a small int8 GN perspective net on its real inputs
    (the kernel against the plain twin, sums and output), then the whole
    net through the kernel against the plain route: bit-equal."""
    from panodepth_torch.kernels import qconv as kq
    from panodepth_torch.models import layers, quantize
    from panodepth_torch.models.perspective import PerspectiveDepthNet

    net = PerspectiveDepthNet(stage_sizes=(1, 1), widths=(16, 32),
                              decoder_width=16)
    layers.init_params(net, torch.Generator().manual_seed(0))
    qnet = quantize.quantize_perspective(net.to(cuda_device))
    rgb = torch.tensor(np.random.RandomState(0).rand(2, 64, 64, 3).astype(
        np.float32), device=cuda_device)
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, args[0].clone())))
        for m in quantize.qconvs(qnet)]
    with torch.no_grad():
        kq.LAUNCHES = 0
        got = qnet(rgb)
        torch.cuda.synchronize()
        assert kq.LAUNCHES == len(quantize.qconvs(qnet)) == 17
        for h in hooks:
            h.remove()
        for m, x in calls:
            xq, sx = kq.quantize_activation(x)
            kh, kw = m.kernel_q.shape[2:]
            pads = (layers.same_pads(x.shape[2], kh, m.strides[0]),
                    layers.same_pads(x.shape[3], kw, m.strides[1]))
            args = (kq.to_nhwc(xq), m.weight(), sx, m.scale, m.bias,
                    (kh, kw), m.strides, pads, m.dtype)
            y, acc = kq.cuda_qconv_sums(*args)
            torch.cuda.synchronize()
            assert torch.equal(acc, kq.qconv_sums_plain(*args[:2], *args[5:8]))
            assert torch.equal(y, kq.qconv_plain(*args))
        plain = layers.set_qconv_route(qnet, "torch")(rgb)
        assert torch.equal(got, plain)


# --- the activation's quantization (csrc/quantize.cu) and qconv's plans ---


def _activation(n, c, h, w, dtype, seed, device="cpu"):
    """An NCHW activation made with numpy from ``seed``: image 0 normal,
    image 1 all zero (sx = 1e-8/127), image 2 on exact rounding ties
    (amax 127/8, so sx = 1/8 and (k + 0.5)/8 divides to k + 0.5) with
    -0.0 among them, the rest normal at scales 1e-3 .. 1e3."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, c, h, w)) * 10.0 ** rng.uniform(-3, 3, (n, 1, 1, 1))
    if n > 1:
        x[1] = 0.0
    if n > 2:
        ties = (rng.randint(-127, 127, (c, h, w)) + 0.5) / 8
        ties.flat[0] = 127 / 8
        ties.flat[1::5] = -0.0
        x[2] = ties
    return torch.tensor(x.astype(np.float32)).to(dtype).to(device)


def test_quantize_auto_on_cpu_routes_to_plain_and_counts_no_launch():
    from panodepth_torch.kernels import qconv as kq

    x = _activation(3, 5, 4, 6, torch.float32, seed=3)
    before = kq.QUANTIZE_LAUNCHES
    q, sx = kq.quantize_nhwc(x)
    assert kq.QUANTIZE_LAUNCHES == before
    want_q, want_sx = kq.quantize_activation(x)
    assert torch.equal(q, kq.to_nhwc(want_q)) and torch.equal(sx, want_sx)
    assert q.shape == (3, 4, 6, 16) and not q[..., 5:].any()
    assert kq.resolve("torch", "quantize") is kq.quantize_nhwc_plain
    assert kq.resolve("kernel", "quantize") is kq.cuda_quantize_nhwc
    with pytest.raises(ValueError, match="qconv route"):
        kq.quantize_nhwc(x, "xla")
    with pytest.raises(ValueError, match="op must be"):
        kq.resolve("auto", "relu")
    assert "quantize" in _build.SOURCES
    assert _build.library_path("quantize").name.startswith("libquantize-")


@pytest.mark.parametrize("bad", ["cpu_tensor", "f64", "three_d", "empty",
                                 "other_plan", "tma_unaligned",
                                 "three_blocks"])
def test_cuda_quantize_refuses_bad_arguments(bad):
    from panodepth_torch.kernels import qconv as kq

    on_card = bad != "cpu_tensor" and torch.cuda.is_available()
    x = _activation(2, 3, 4, 4, torch.float32, seed=4,
                    device="cuda" if on_card else "cpu")
    err = TypeError if bad in ("cpu_tensor", "f64") or not on_card \
        else ValueError
    if bad == "f64":
        x = x.double()
    elif bad == "three_d":
        x = x[0]
    elif bad == "empty":
        x = x[:, :, :0]
    call = kq.cuda_quantize_nhwc
    # plans the kernel does not take (run_quantize_plan): another shape's,
    # TMA on an input 4 bytes off its alignment, three blocks an SM
    plan = kq.quantize_plan(2, 3, 16)
    if bad == "other_plan":
        plan = kq.quantize_plan(2, 3, 64)
    elif bad == "tma_unaligned":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
    elif bad == "three_blocks":
        plan = dataclasses.replace(plan, blocks_per_sm=3)
    if bad in ("other_plan", "tma_unaligned", "three_blocks"):
        assert plan.tma
        call = functools.partial(kq.run_quantize_plan, plan=plan)
    before = kq.QUANTIZE_LAUNCHES
    with pytest.raises(err):
        call(x)
    assert kq.QUANTIZE_LAUNCHES == before


def test_fake_implementations_under_export():
    """A QConv's two operators, traced by ``torch.export`` on fake CUDA
    tensors (no card needed): one node each, with the plain twins' output
    shapes and types."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from panodepth_torch.kernels import qconv as kq

    pads = (kq.same_pads(17, 7, 2),) * 2

    class OneQConv(torch.nn.Module):
        def forward(self, x, wq, scale, bias):
            xq, sx = kq.quantize_nhwc(x, "kernel")
            return kq.resolve("kernel")(xq, wq, sx, scale, bias, (7, 7),
                                        (2, 2), pads, torch.bfloat16)

    with FakeTensorMode():
        args = (torch.empty(2, 3, 17, 17, device="cuda"),
                torch.empty(8, 64 * 13, dtype=torch.int8, device="cuda"),
                torch.empty(8, device="cuda"), torch.empty(8, device="cuda"))
        ep = torch.export.export(OneQConv(), args)
    nodes = {str(n.target): n.meta["val"] for n in ep.graph.nodes
             if n.op == "call_function" and "panodepth_torch" in
             str(n.target)}
    assert set(nodes) == {f"{kq.OPS}.quantize_nhwc.default",
                          f"{kq.OPS}.qconv.default"}
    q, sx = nodes[f"{kq.OPS}.quantize_nhwc.default"]
    want_q, want_sx = kq.quantize_nhwc_plain(torch.zeros(2, 3, 17, 17))
    assert (q.shape, q.dtype, sx.shape, sx.dtype) == (
        want_q.shape, want_q.dtype, want_sx.shape, want_sx.dtype)
    y = nodes[f"{kq.OPS}.qconv.default"]
    assert y.shape == (2, 8, 9, 9) and y.dtype == torch.bfloat16
    assert y.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w", [(4, 3, 17, 23), (4, 32, 8, 8),
                                     (3, 512, 4, 4), (1, 40, 9, 130),
                                     (5, 64, 66, 66), (3, 128, 128, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quantize_bit_equal_to_plain(cuda_device, n, c, h, w, dtype):
    """The kernels' codes and scales against the plain twin's on the card:
    bit-equal, ties, zeros, -0.0 and mixed ranges included, each call two
    launches; a strided input is made contiguous first."""
    from panodepth_torch.kernels import qconv as kq

    x = _activation(n, c, h, w, dtype, seed=n * c + h, device=cuda_device)
    for arg in (x, x.transpose(2, 3).contiguous().transpose(2, 3)):
        before = kq.QUANTIZE_LAUNCHES
        q, sx = kq.cuda_quantize_nhwc(arg)
        torch.cuda.synchronize()
        assert kq.QUANTIZE_LAUNCHES == before + kq.QUANTIZE_KERNELS
        want_q, want_sx = kq.quantize_nhwc_plain(x)
        assert torch.equal(sx.view(torch.int32), want_sx.view(torch.int32))
        assert torch.equal(q, want_q)


def _nan_in_one(x):
    """``x`` (3 images or more) with one NaN in image 1."""
    x = x.clone()
    x[1, x.shape[1] // 2, 0, 1] = float("nan")
    return x


def _quantize_edge(case, device):
    """The smoke's edge inputs (``chip_smoke.QUANTIZE_EDGES``'s kinds)."""
    kind, (n, c, h, w), dtype = case
    x = _activation(n, c, h, w, dtype, seed=n + c + h, device=device)
    if kind == "offset":  # a view 4 bytes into its storage
        flat = torch.empty(x.numel() + 8, dtype=dtype, device=device)
        step = 4 // x.element_size()
        x = flat[step:step + x.numel()].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 == 4
    elif kind == "nan":
        x = _nan_in_one(x)
    return x


QUANTIZE_EDGE_CASES = [
    ("plain", (1, 3, 64, 64), torch.float32),
    ("plain", (3, 40, 33, 64), torch.bfloat16),
    ("plain", (3, 40, 7, 11), torch.float32),
    ("plain", (3, 3, 7, 11), torch.bfloat16),
    ("offset", (3, 64, 32, 32), torch.float32),
    ("offset", (3, 16, 9, 9), torch.bfloat16),
    ("nan", (3, 128, 16, 16), torch.float32),
    ("nan", (3, 40, 7, 11), torch.bfloat16),
    ("plain", (2, 64, 512, 512), torch.bfloat16)]


def _hold_quantize(x, q, sx):
    """The kernel's codes and scales against the plain twin's: bit-equal,
    but for an image with a NaN: its scale NaN, its codes -127 where the
    channel is real (fmaxf(NaN, -127)) and 0 in the padding."""
    from panodepth_torch.kernels import qconv as kq

    want_q, want_sx = kq.quantize_nhwc_plain(x)
    bad = torch.isnan(x.float()).flatten(1).any(1)
    assert torch.equal(torch.isnan(sx), bad)
    ok = ~bad
    assert torch.equal(sx[ok].view(torch.int32), want_sx[ok].view(torch.int32))
    assert torch.equal(q[ok], want_q[ok])
    c = x.shape[1]
    assert (q[bad][..., :c] == -127).all() and not q[bad][..., c:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUANTIZE_EDGE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_cuda_quantize_edge_cases(cuda_device, case):
    """N = 1, C = 3 and 40, 7x11 pixels (rows TMA refuses), an input 4
    bytes off its alignment, an all-zero image, ties, -0.0, a NaN in one
    image of three and a 512-view's input (the L2 path): one launch each,
    bit-equal to the plain twin but where a NaN is."""
    from panodepth_torch.kernels import qconv as kq

    x = _quantize_edge(case, cuda_device)
    plan = kq.quantize_plan(*x.shape[:2], x[0, 0].numel(), x.dtype,
                            x.data_ptr() % 16 == 0, kq._sms(x.device))
    assert plan.l2 == (case[1] == (2, 64, 512, 512))
    assert plan.tma == (x.data_ptr() % 16 == 0
                        and x[0, 0].numel() * x.element_size() % 16 == 0)
    before = kq.QUANTIZE_LAUNCHES
    q, sx = kq.cuda_quantize_nhwc(x)
    torch.cuda.synchronize()
    assert kq.QUANTIZE_LAUNCHES == before + 1 == before + kq.QUANTIZE_KERNELS
    _hold_quantize(x, q, sx)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,dtype", [
    (15, 512, 8, 8, torch.float32), (15, 128, 32, 32, torch.bfloat16),
    (5, 40, 17, 23, torch.float32), (4, 64, 64, 64, torch.float32)])
def test_cuda_quantize_plans_bit_equal(cuda_device, n, c, h, w, dtype):
    """Every form of the kernel: one or two blocks an SM, one image a wave
    up to all, plain loads in place of TMA, slices of several tiles (the
    L2 path on an image that would fit): each bit-equal to the plain
    twin; a plan of another shape is refused."""
    import dataclasses

    from panodepth_torch.kernels import qconv as kq

    x = _activation(n, c, h, w, dtype, seed=c + h, device=cuda_device)
    want_q, want_sx = kq.quantize_nhwc_plain(x)
    base = kq.quantize_plan(n, c, h * w, dtype, True, kq._sms(x.device))
    plans = {base, dataclasses.replace(base, tma=False, bw=base.width, nb=1),
             dataclasses.replace(base, k=2, ipw=1)}
    for bps in kq.Q_BLOCKS_PER_SM:
        for ipw in (1, 2, n):
            try:
                plans.add(kq.quantize_plan(n, c, h * w, dtype, True,
                                           kq._sms(x.device), bps, ipw))
            except ValueError:
                continue
    for plan in plans:
        if plan.smem_bytes > kq.smem_max(plan.blocks_per_sm):
            continue
        q, sx = kq.run_quantize_plan(x, plan)
        torch.cuda.synchronize()
        assert torch.equal(q, want_q), plan
        assert torch.equal(sx.view(torch.int32), want_sx.view(torch.int32))
    with pytest.raises(ValueError, match="plan"):
        kq.run_quantize_plan(x[:, :, :1], base)


@pytest.mark.cuda
def test_cuda_quantize_graph_replays(cuda_device):
    """Captured in a CUDA graph and replayed on new inputs: the image words
    come zeroed for every replay (the memset node), so each replay's
    codes and scales are the plain twin's of its input."""
    from panodepth_torch.kernels import qconv as kq

    xs = [_activation(15, 64, 64, 64, torch.float32, seed=s,
                      device=cuda_device) for s in range(3)]
    static = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kq.cuda_quantize_nhwc(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, sx = kq.cuda_quantize_nhwc(static)
    for x in xs + xs[::-1]:
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        want_q, want_sx = kq.quantize_nhwc_plain(x)
        assert torch.equal(q, want_q)
        assert torch.equal(sx.view(torch.int32), want_sx.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,k,stride,pads", [
    (1, 64, 64, 3, 32, 7, 2, None), (2, 9, 9, 512, 136, 3, 1, None),
    (1, 8, 8, 512, 512, 3, 1, None), (3, 15, 13, 40, 64, 3, 2,
                                      ((0, 2), (1, 0))),
    (1, 7, 11, 16, 8, 1, 2, ((0, 0), (0, 0))),
    (2, 6, 64, 64, 24, 3, 1, ((0, 2), (2, 0)))])
def test_cuda_qconv_plans_bit_equal(cuda_device, n, h, w, cin, cout, k,
                                    stride, pads):
    """Every form of the kernel (32-, 64- and 128-wide tiles, rings of 3
    to 6 stages, K split 1 to 4 ways where it has the tiles) against the
    plain twin: sums and output bit-equal, at N = 1, the stem's 7x7/2,
    explicit asymmetric pads and widths off the tile."""
    from panodepth_torch.kernels import qconv as kq

    xq, wq, sx, scale, bias, kern, strides, same = _qconv_case(
        n, h, w, cin, cout, k, stride, seed=cin + cout, device=cuda_device)
    pads = same if pads is None else pads
    want_acc = kq.qconv_sums_plain(xq, wq, kern, strides, pads)
    want = kq.qconv_plain(xq, wq, sx, scale, bias, kern, strides, pads)
    base = kq.qconv_plan(n, h, w, xq.shape[3], cout, k, k, stride, stride,
                         pads)
    tried = set()
    for bn in kq.TILE_N:
        for stages in (3, 4, 6):
            for splits in (1, 2, 3, 4, base.splits):
                plan = kq.QConvPlan(base.m, cout, base.ktaps, bn, stages,
                                    splits)
                if splits > plan.ktiles or (bn, stages, splits) in tried:
                    continue
                tried.add((bn, stages, splits))
                y, acc = kq.run_plan(xq, wq, sx, scale, bias, kern, strides,
                                     pads, plan=plan)
                torch.cuda.synchronize()
                assert torch.equal(acc, want_acc), plan
                assert torch.equal(y, want), plan
    with pytest.raises(ValueError, match="does not take"):
        kq.run_plan(xq, wq, sx, scale, bias, kern, strides, pads,
                    plan=kq.QConvPlan(base.m, cout, base.ktaps, 96, 4, 1))
