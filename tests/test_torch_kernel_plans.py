"""The kernels' launch plans (``kernels/jacobi.plan_for``,
``kernels/groupnorm.plan_for``), checked on the CPU, and the GroupNorm
wrapper's refusal of tensors that require grad.

The plans are pure Python, so the CPU reaches what the card's kernels are
told to do: every output pixel or element covered by exactly one tile or
slice, shared memory and cluster sizes within what an H100 grants, the
block counts the coarse shapes need, and launch counts equal to the
wrappers'.  ``_emulate_jacobi`` replays a plan's windows in PyTorch on the
CPU (flat-index gather, garbage at the window's ring, interior written
back) and is held bit-equal to the plain Jacobi, as the kernel is on the
card.  ``_emulate_group_norm`` replays a plan's slices (per-slice f32
sums combined in rank order, then channel by channel) and is held to the
plain GroupNorm within the bar of ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from panodepth_torch.config import MergeConfig
from panodepth_torch.fusion import build_fusion_plan
from panodepth_torch.kernels import groupnorm as kgn
from panodepth_torch.kernels import jacobi as kj
from panodepth_torch.models import norm as tnorm

torch.set_num_threads(1)

SMS = 132
SMEM_MAX = 232448
SMEM_DEFAULT = 48 * 1024


def _levels(out_width):
    plan = build_fusion_plan(MergeConfig(out_width=out_width))
    return [(lvl.height, lvl.width, lvl.iterations) for lvl in plan.levels]


ODD_LEVELS = [(5, 7, 3), (50, 130, 20), (24, 64, 1)]
LEVELS = sorted(set(_levels(2048) + _levels(4096))) + ODD_LEVELS


@pytest.mark.parametrize("h,w,iters", LEVELS)
def test_jacobi_plan_covers_each_pixel_once(h, w, iters):
    p = kj.plan_for(h, w, iters)
    win_h, win_w = p.window
    assert (p.cols, p.rows) in kj.TILES and 1 <= p.warps <= kj.MAX_WARPS
    assert 1 <= p.halo <= iters and p.tile[0] >= 1 and p.tile[1] >= 1
    # what each block writes, as csrc/jacobi.cu decides it: window cells at
    # least `halo` from the window's edge that fall inside the level
    count = np.zeros((h, w), np.int32)
    gx, gy = p.grid
    ly, lx = np.meshgrid(np.arange(win_h), np.arange(win_w), indexing="ij")
    inner = ((ly >= p.halo) & (ly < win_h - p.halo) & (lx >= p.halo)
             & (lx < win_w - p.halo))
    for by in range(gy):
        for bx in range(gx):
            y = by * p.tile[0] - p.halo + ly
            x = bx * p.tile[1] - p.halo + lx
            keep = inner & (y < h) & (x < w)
            np.add.at(count, (y[keep], x[keep]), 1)
    assert (count == 1).all()
    # shared memory: the edge buffer, within the card's 227 KB and the
    # default 48 KB unless the plan opts in
    assert p.smem_bytes <= SMEM_MAX
    if not p.opt_in:
        assert p.smem_bytes <= SMEM_DEFAULT
    assert p.warps * 32 <= 1024
    # the window's flat indices stay 32-bit
    assert (h + win_h + 1) * w < 2 ** 31
    assert kj.launches_for(h, w, iters) == p.launches == -(-iters // p.halo)


def test_jacobi_plan_fills_the_card_at_512x256():
    """The 512x256 level launches at least 132 blocks, or puts at least 16
    warps on each SM it uses (at most one block per SM)."""
    p = kj.plan_for(256, 512, 200)
    assert p.blocks >= SMS or (p.warps >= 16 and p.blocks <= SMS)
    # fewer launches per panorama than the 45 of the 64x56-window form
    for width in (2048, 4096):
        total = sum(kj.launches_for(h, w, it) for h, w, it in _levels(width))
        assert total < 45 * (1 if width == 2048 else 2)


def _emulate_jacobi(plan, buf, tgt, cov, step, reg):
    """The kernel's algorithm in PyTorch: every launch gathers each block's
    window by flat index modulo N, relaxes the window (window-local rolls:
    the ring takes garbage taps, as in the kernel; a warp's strip of rows
    that no later step needs is left as it is) and writes the interior."""
    h, w = buf.shape
    n = h * w
    win_h, win_w = plan.window
    gx, gy = plan.grid
    by, bx, ly, lx = torch.meshgrid(torch.arange(gy), torch.arange(gx),
                                    torch.arange(win_h), torch.arange(win_w),
                                    indexing="ij")
    y = by * plan.tile[0] - plan.halo + ly
    x = bx * plan.tile[1] - plan.halo + lx
    flat = torch.remainder(y * w + x, n).reshape(-1, win_h, win_w)
    inner = ((ly >= plan.halo) & (ly < win_h - plan.halo)
             & (lx >= plan.halo) & (lx < win_w - plan.halo)
             & (y < h) & (x < w)).reshape(-1, win_h, win_w)
    t, c = tgt.reshape(-1)[flat], cov.reshape(-1)[flat]
    strip = torch.arange(win_h).view(win_h, 1) // plan.rows * plan.rows
    omr = 1.0 - reg
    done = 0
    cur = buf
    while done < plan.iterations:
        steps = min(plan.halo, plan.iterations - done)
        b = cur.reshape(-1)[flat]
        for s in range(steps):
            taps = (torch.roll(b, 1, 2) + torch.roll(b, -1, 2)
                    + torch.roll(b, 1, 1) + torch.roll(b, -1, 1))
            upd = b + (t - (b - 0.25 * taps)) * step
            upd = torch.clamp(upd * omr + b * reg, 0.0, 1.0)
            # a warp's strip of rows outside the rows still needed skips
            live = (strip + plan.rows > s + 1) & (strip < win_h - s - 1)
            b = torch.where(c & live, upd, b)
        nxt = torch.full_like(cur, float("nan")).reshape(-1)
        nxt[flat[inner]] = b[inner]
        cur = nxt.view(h, w)
        done += steps
    return cur


@pytest.mark.parametrize("h,w,iters", [(256, 512, 40)] + ODD_LEVELS)
def test_jacobi_plan_emulated_bit_equal_to_plain(h, w, iters):
    rng = np.random.RandomState(h * w + iters)
    buf = torch.tensor(rng.rand(h, w).astype(np.float32))
    tgt = torch.tensor(rng.normal(0, 0.01, (h, w)).astype(np.float32))
    cov = rng.rand(h, w) < 0.6
    cov[0], cov[-1], cov[:, 0], cov[:, -1] = True, True, True, True
    cov = torch.tensor(cov)
    plan = kj.plan_for(h, w, iters)
    assert plan.launches > 1 or iters <= plan.halo
    got = _emulate_jacobi(plan, buf, tgt, cov, 0.5, 1e-4)
    want = kj.jacobi_plain(buf, tgt, cov, iters, 0.5, 1e-4)
    assert torch.equal(got, want)


# FastPanoNet's norms at a 256x512 input: (HW, C, G) of its 29 calls
FASTPANO_SHAPES = [(32768, 96, 32), (32768, 24, 8), (8192, 96, 32),
                   (8192, 48, 16), (2048, 96, 32), (512, 192, 32),
                   (512, 96, 32), (128, 384, 32)]
# the other zoo families' norms at the full configuration (panoramas
# 256x512, views 256x256): (N, C, HW, G) of the e2e graph's calls, N the
# six cube faces or one panorama's 15 views (_family_norm_calls)
FAMILY_CALLS = {
    # GN PerspectiveDepthNet on 15 views
    (15, 32, 16384, 32), (15, 128, 16384, 32), (15, 64, 4096, 32),
    (15, 128, 4096, 32), (15, 128, 1024, 32), (15, 128, 256, 32),
    (15, 256, 256, 32), (15, 512, 64, 32),
    # UniFuse-class and BiFuse: the equirect branch, the cube branch
    (1, 32, 32768, 32), (1, 64, 8192, 32), (1, 128, 2048, 32),
    (1, 256, 512, 32), (6, 32, 4096, 32), (6, 64, 1024, 32),
    (6, 128, 256, 32), (6, 256, 64, 32),
    # HoHoNet: the one-row height squeeze, group size 1 at 16 wide
    (1, 256, 128, 32), (1, 256, 32, 32), (1, 16, 131072, 16),
    (1, 16, 32768, 16), (1, 32, 8192, 32), (1, 64, 2048, 32),
}
FAMILY_SHAPES = sorted({(hw, c, g) for _, c, hw, g in FAMILY_CALLS})
FAMILY_NETS = {  # sidecar, input, GroupNorm calls per forward
    "gn_perspective": ({"model": "perspective"}, (15, 256, 256, 3), 29),
    "panoramic": ({"model": "panoramic"}, (1, 256, 512, 3), 31),
    "hohonet": ({"model": "hohonet"}, (1, 256, 512, 3), 18),
    "bifuse": ({"model": "bifuse"}, (1, 256, 512, 3), 38),
    "slicenet": ({"model": "slicenet"}, (1, 256, 512, 3), 16),
}
GN_CASES = ([(n, c, hw, g) for hw, c, g in FASTPANO_SHAPES for n in (1, 2)]
            + sorted(FAMILY_CALLS | {(1, c, hw, g) for _, c, hw, g in
                                     FAMILY_CALLS})
            + [(3, 20, 63, 4), (1, 4, 1, 4)])


def _family_norm_calls(arch, shape):
    """(N, C, HW, G, input type) of every GroupNorm call of a net in one
    forward, traced on the meta device (shapes only, no arithmetic)."""
    from panodepth_torch.models import weights

    with torch.device("meta"):
        net = weights.build_model(arch)
    calls = []
    for m in net.modules():
        if isinstance(m, tnorm.GroupNorm):
            m.register_forward_pre_hook(lambda mod, args: calls.append((
                args[0].shape[0], args[0].shape[1], args[0][0, 0].numel(),
                mod.num_groups, args[0].dtype)))
    with torch.no_grad():
        net(torch.empty(shape, device="meta"))
    return calls


@pytest.mark.parametrize("family", list(FAMILY_NETS))
def test_family_norm_shapes_are_the_nets_own(family):
    """The table above is what each zoo family's net runs: its norm count
    per forward, bf16 inputs, and every call's (N, C, HW, G)."""
    arch, shape, count = FAMILY_NETS[family]
    calls = _family_norm_calls(arch, shape)
    assert len(calls) == count
    for n, c, hw, g, dtype in calls:
        assert dtype == torch.bfloat16
        assert (n, c, hw, g) in FAMILY_CALLS
        # each (image, group) span sits on the 8-element vector grid, so an
        # image normalises to the same bits alone and in the call's batch
        assert (c // g * hw) % kgn.VEC == 0


def test_family_calls_table_lists_only_what_the_nets_run():
    traced = {call[:4] for arch, shape, _ in FAMILY_NETS.values()
              for call in _family_norm_calls(arch, shape)}
    assert traced == FAMILY_CALLS


@pytest.mark.parametrize("n,c,hw,g", GN_CASES)
@pytest.mark.parametrize("in_bytes", [2, 4])
def test_group_norm_plan_slices_cover_each_span_once(n, c, hw, g, in_bytes):
    p = kgn.plan_for(n, c, hw, g, in_bytes)
    span = c // g * hw
    assert p.span == span
    assert p.cluster in (1, 2, 4, 8, 16) and p.slice % kgn.VEC == 0
    seen = np.zeros(n * c * hw, np.int32)
    for image in range(n):
        for group in range(g):
            slices = p.slices(image, group)
            assert len(slices) == p.cluster
            for s0, s1 in slices:
                seen[s0:s1] += 1
            starts = [s0 for s0, _ in slices]
            assert starts == sorted(starts)
    assert (seen == 1).all()
    # shared memory per block: within the card's 227 KB beside the kernel's
    # static variables, and the default 48 KB unless the plan opts in
    assert p.smem_bytes + kgn.SMEM_STATIC <= SMEM_MAX
    if not p.opt_in:
        assert p.smem_bytes + kgn.SMEM_STATIC <= SMEM_DEFAULT
    # every slice of a zoo net is kept in shared memory (one read)
    if (hw, c, g) in FASTPANO_SHAPES or (hw, c, g) in FAMILY_SHAPES:
        assert p.staged
    # enough blocks for the 132 SMs where the cluster size and the span
    # allow it
    assert (p.blocks >= SMS or p.cluster == kgn.MAX_CLUSTER
            or span // (2 * p.cluster) < kgn.MIN_SLICE)


def test_group_norm_plan_block_counts_and_opt_in():
    stem1 = kgn.plan_for(1, 24, 32768, 8, 2)
    stem2 = kgn.plan_for(2, 24, 32768, 8, 2)
    # at batch 1 eight groups of 16 blocks are the most clusters allow
    assert stem1.blocks == 128 and stem1.cluster == 16
    # at batch 2 the same clusters (the plan does not depend on the batch)
    assert stem2.blocks >= SMS and stem2.cluster == stem1.cluster
    # f32 input at the widest span takes the shared-memory opt-in
    wide = kgn.plan_for(1, 96, 32768, 32, 4)
    assert wide.staged and wide.opt_in and wide.smem_bytes > SMEM_DEFAULT
    # a span too large for 16 blocks' shared memory is read twice
    huge = kgn.plan_for(1, 4, 512 * 1024, 1, 4)
    assert huge.cluster == 16 and not huge.staged and huge.smem_bytes == 0


def _emulate_group_norm(x, scale, bias, groups, eps, plan):
    """The kernel's partition in PyTorch: each slice summed in f64, the
    cluster's pairs combined in rank order, the means rounded to f32, then
    the slice normalised channel by channel."""
    xf = x.reshape(-1).to(torch.float32)
    xd = xf.to(torch.float64)
    y = torch.empty_like(xf)
    count = float(plan.span)
    for image in range(plan.n):
        for group in range(groups):
            pairs = [(xd[s0:s1].sum(), (xd[s0:s1] * xd[s0:s1]).sum())
                     for s0, s1 in plan.slices(image, group)]
            t1 = torch.zeros((), dtype=torch.float64)
            t2 = torch.zeros((), dtype=torch.float64)
            for p1, p2 in pairs:
                t1, t2 = t1 + p1, t2 + p2
            mean = (t1 / count).to(torch.float32)
            mean2 = (t2 / count).to(torch.float32)
            inv = torch.rsqrt(torch.clamp_min(mean2 - mean * mean, 0.0) + eps)
            for s0, s1 in plan.slices(image, group):
                for c in range(s0 // plan.hw, -(-s1 // plan.hw)):
                    a, b = max(s0, c * plan.hw), min(s1, (c + 1) * plan.hw)
                    ch = c % plan.channels
                    y[a:b] = (xf[a:b] - mean) * (inv * scale[ch]) + bias[ch]
    return y.view(x.shape)


@pytest.mark.parametrize("shape,groups", [((2, 8, 64, 96), 4),
                                          ((1, 12, 64, 101), 3),
                                          ((1, 8, 64, 96), 2)])
def test_group_norm_plan_emulated_matches_plain(shape, groups):
    rng = np.random.RandomState(sum(shape))
    x = torch.tensor(rng.normal(0.3, 1.7, shape).astype(np.float32))
    scale = torch.tensor(rng.uniform(0.5, 2, shape[1]).astype(np.float32))
    bias = torch.tensor(rng.uniform(-1, 1, shape[1]).astype(np.float32))
    n, c = shape[:2]
    plan = kgn.plan_for(n, c, x[0, 0].numel(), groups, 4)
    assert plan.cluster > 1  # the slices really split each span
    got = _emulate_group_norm(x, scale, bias, groups, 1e-6, plan)
    want = kgn.group_norm_plain(x, scale, bias, groups, 1e-6)
    tol = 16 * 2.0 ** -23 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


def test_group_norm_partition_gives_the_plain_bits_where_variance_cancels():
    """bf16 inputs whose mean is 100 times their spread (the fast
    variance's condition ~1e4, as in a smooth image channel): f32 sums in
    two orders would differ by thousands of f32 ulps there; the f64 sums of
    the kernel's partition and of the plain version are exact, so the two
    give the same bits."""
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.normal(2.0, 0.02, (2, 32, 128, 128)).astype(
        np.float32)).to(torch.bfloat16)
    scale = torch.tensor(rng.uniform(0.5, 2, 32).astype(np.float32))
    bias = torch.tensor(rng.uniform(-1, 1, 32).astype(np.float32))
    plan = kgn.plan_for(2, 32, 128 * 128, 32, 2)
    assert plan.cluster > 1
    got = _emulate_group_norm(x, scale, bias, 32, 1e-6, plan)
    want = kgn.group_norm_plain(x, scale, bias, 32, 1e-6)
    assert torch.equal(got, want)
    # the premise: the variance from f32 sums depends on their order here
    xf = x.float().reshape(2, 32, -1)

    def f32_var(t):
        m, m2 = t.sum(-1) / t.shape[-1], (t * t).sum(-1) / t.shape[-1]
        return m2 - m * m

    assert not torch.equal(f32_var(xf), f32_var(xf.flip(-1)))


@pytest.mark.parametrize("c,hw,g", [(c, hw, g) for hw, c, g in
                                    FASTPANO_SHAPES + FAMILY_SHAPES]
                         + [(20, 63, 4)])
@pytest.mark.parametrize("in_bytes", [2, 4])
def test_group_norm_plan_does_not_depend_on_the_batch(c, hw, g, in_bytes):
    """Every image's span is split alike at any batch, so its sums run
    in one order and it normalises to the same bits at batch 1 (the CLI)
    and at batch 2 (the e2e call)."""
    one = kgn.plan_for(1, c, hw, g, in_bytes)
    for n in (2, 3, 6, 8, 15):
        p = kgn.plan_for(n, c, hw, g, in_bytes)
        assert (p.cluster, p.slice, p.staged, p.smem_bytes, p.opt_in) == (
            one.cluster, one.slice, one.staged, one.smem_bytes, one.opt_in)
        assert p.blocks == n * one.blocks
        span = one.span
        assert [(a - span * g * (n - 1), b - span * g * (n - 1))
                for a, b in p.slices(n - 1, g - 1)] == one.slices(0, g - 1)


def test_group_norm_plan_emulated_is_batch_invariant():
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.normal(0.3, 1.7, (2, 8, 64, 96)).astype(np.float32))
    scale = torch.tensor(rng.uniform(0.5, 2, 8).astype(np.float32))
    bias = torch.tensor(rng.uniform(-1, 1, 8).astype(np.float32))
    both = _emulate_group_norm(x, scale, bias, 4, 1e-6,
                               kgn.plan_for(2, 8, 64 * 96, 4, 4))
    for i in range(2):
        plan = kgn.plan_for(1, 8, 64 * 96, 4, 4)
        assert plan.cluster > 1
        alone = _emulate_group_norm(x[i:i + 1].contiguous(), scale, bias, 4,
                                    1e-6, plan)
        assert torch.equal(both[i:i + 1], alone)


@pytest.mark.parametrize("grad_on", ["x", "scale", "bias"])
def test_cuda_group_norm_refuses_grad_before_the_device_check(grad_on):
    x = torch.randn(2, 8, 4, 4)
    scale, bias = torch.ones(8), torch.zeros(8)
    args = dict(x=x, scale=scale, bias=bias)
    args[grad_on] = args[grad_on].clone().requires_grad_(True)
    before = kgn.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        kgn.cuda_group_norm(args["x"], args["scale"], args["bias"], 4)
    # without grad mode the same call gets as far as the device check
    with torch.no_grad():
        with pytest.raises(TypeError, match="CUDA tensor"):
            kgn.cuda_group_norm(args["x"], args["scale"], args["bias"], 4)
    assert kgn.LAUNCHES == before


def test_grad_on_the_cpu_routes_through_the_twin():
    """``auto`` on a CPU tensor takes the differentiable twin, so gradients
    flow; the ``kernel`` route refuses rather than dropping them."""
    m = tnorm.GroupNorm(8, 4)
    x = torch.randn(2, 8, 4, 4, requires_grad=True)
    m(x).square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    tnorm.set_route(m, "kernel")
    with pytest.raises(RuntimeError, match="no backward"):
        m(x)


# --- qconv's launch plan (kernels/qconv.qconv_plan) and the quantization ---

# the 21 int8 conv shapes of the zoo GN perspective net on 15 views at
# 256x256: (H, W, Cin, Cout, k, stride) of the conv's input
GN_INT8_SHAPES = [
    (256, 256, 3, 32, 7, 2), (128, 128, 32, 64, 3, 2), (64, 64, 64, 64, 3, 1),
    (128, 128, 32, 64, 1, 2), (64, 64, 64, 128, 3, 2),
    (32, 32, 128, 128, 3, 1), (64, 64, 64, 128, 1, 2),
    (32, 32, 128, 256, 3, 2), (16, 16, 256, 256, 3, 1),
    (32, 32, 128, 256, 1, 2), (16, 16, 256, 512, 3, 2),
    (8, 8, 512, 512, 3, 1), (16, 16, 256, 512, 1, 2), (8, 8, 512, 128, 3, 1),
    (16, 16, 128, 128, 3, 1), (16, 16, 256, 128, 3, 1),
    (64, 64, 128, 128, 3, 1), (64, 64, 64, 128, 3, 1),
    (128, 128, 128, 128, 3, 1), (128, 128, 128, 64, 3, 1),
    (256, 256, 64, 32, 3, 1)]
# odd shapes (N, H, W, Cin, Cout, k, stride): N = 1, widths off the tile
ODD_QCONV = [(1, 7, 11, 16, 8, 1, 2), (3, 15, 13, 40, 64, 3, 2),
             (2, 9, 9, 512, 136, 3, 1), (1, 64, 64, 3, 32, 7, 2),
             (2, 8, 8, 16, 65, 3, 1)]
QCONV_CASES = [(15,) + s for s in GN_INT8_SHAPES] + ODD_QCONV


def test_gn_int8_shapes_are_the_nets_own():
    """The table above is the int8 GN net's: every QConv call of a forward
    (at 64x64, so the sizes are a quarter of 256x256's)."""
    from panodepth_torch.models import layers, quantize
    from panodepth_torch.models.perspective import PerspectiveDepthNet

    net = PerspectiveDepthNet()
    layers.init_params(net, torch.Generator().manual_seed(0))
    qnet = quantize.quantize_perspective(net)
    seen = set()
    hooks = [m.register_forward_pre_hook(lambda mod, a: seen.add((
        4 * a[0].shape[2], 4 * a[0].shape[3], a[0].shape[1],
        mod.kernel_q.shape[0], mod.kernel_q.shape[2], mod.strides[0])))
        for m in quantize.qconvs(qnet)]
    with torch.no_grad():
        qnet(torch.rand(1, 64, 64, 3))
    for h in hooks:
        h.remove()
    assert seen == set(GN_INT8_SHAPES) and len(GN_INT8_SHAPES) == 21


@pytest.mark.parametrize("n,h,w,cin,cout,k,stride", QCONV_CASES)
def test_qconv_plan_tiles_cover_the_gemm(n, h, w, cin, cout, k, stride):
    """The tiles cover M, N and K once; the narrowest tile that holds Cout;
    K split only where the tiles number fewer than the SMs, into splits
    of at least MIN_SPLIT_KTILES K tiles, none empty, and no more work
    blocks than SMs; shared memory and the workspace as the kernel takes
    them."""
    from panodepth_torch.kernels import qconv as kq

    cinp = -(-cin // kq.CIN_ALIGN) * kq.CIN_ALIGN
    p = kq.qconv_plan(n, h, w, cinp, cout, k, k, stride, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    assert p.m == n * ho * wo and p.ktaps == k * k * cinp
    assert (p.m_tiles - 1) * kq.BM < p.m <= p.m_tiles * kq.BM
    assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
    assert (p.ktiles - 1) * kq.BK < p.ktaps <= p.ktiles * kq.BK
    per = p.ktiles_per_split
    assert (p.splits - 1) * per < p.ktiles <= p.splits * per
    assert p.bn == min([t for t in kq.TILE_N if cout <= t] + [128])
    if p.splits > 1:
        assert p.tiles < kq.SMS and p.blocks <= kq.SMS
        assert per >= kq.MIN_SPLIT_KTILES
    else:
        assert p.tiles >= kq.SMS or p.ktiles < 2 * kq.MIN_SPLIT_KTILES \
            or p.tiles * 2 > kq.SMS
    assert kq.MIN_STAGES <= p.stages <= kq.MAX_STAGES
    assert p.smem_bytes <= kq.SMEM_MAX
    assert p.workspace_bytes == (0 if p.splits == 1 else 4 * (
        -(-p.tiles // 4) * 4 + p.tiles * p.splits * kq.BM * p.bn))


def test_qconv_plan_splits_the_small_layers_of_the_net():
    """At 15 views the 16x16 and 8x8 layers split K (8x8, 512 -> 512:
    M = 960, K = 4608, 32 tiles, 4 splits, 128 blocks); the 32x32 and
    larger layers have a tile an SM or more and do not."""
    from panodepth_torch.kernels import qconv as kq

    for h, w, cin, cout, k, s in GN_INT8_SHAPES:
        p = kq.qconv_plan(15, h, w, -(-cin // 16) * 16, cout, k, k, s, s)
        if h // s >= 32:
            assert p.splits == 1, (h, cin, cout, k, s)
        elif k == 3:
            assert p.splits > 1, (h, cin, cout, k, s)
    p = kq.qconv_plan(15, 8, 8, 512, 512, 3, 3, 1, 1)
    assert (p.m, p.ktaps, p.tiles, p.splits, p.blocks) == (
        960, 4608, 32, 4, 128)


def _emulate_qconv_sums(xq, wq, kernel, strides, pads, plan):
    """The kernel's blocks in numpy: each (tile, split) multiplies its
    rows of the implicit im2col (zero where the pad falls or past K) by
    its tile's weight rows over its K tiles, and the splits of a tile are
    added; returns the (N, Cout, Ho, Wo) int32 sums."""
    from panodepth_torch.kernels import qconv as kq

    kh, kw = kernel
    n, h, w, cinp = xq.shape
    (t, b), (l, r) = pads
    x = np.pad(xq.numpy().astype(np.int64), ((0, 0), (t, b), (l, r), (0, 0)))
    ho = (h + t + b - kh) // strides[0] + 1
    wo = (w + l + r - kw) // strides[1] + 1
    cols = np.stack([x[:, i:i + strides[0] * ho:strides[0],
                       j:j + strides[1] * wo:strides[1], :]
                     for i in range(kh) for j in range(kw)], axis=3)
    a = np.zeros((plan.m_tiles * kq.BM, plan.ktiles * kq.BK), np.int64)
    a[:plan.m, :plan.ktaps] = cols.reshape(n * ho * wo, -1)
    bmat = np.zeros((plan.n_tiles * plan.bn, plan.ktiles * kq.BK), np.int64)
    bmat[:wq.shape[0], :wq.shape[1]] = wq.numpy()
    out = np.zeros((a.shape[0], bmat.shape[0]), np.int64)
    per = plan.ktiles_per_split
    for item in range(plan.blocks):
        split, tile = item % plan.splits, item // plan.splits
        bm = (tile % plan.m_tiles) * kq.BM
        bn = (tile // plan.m_tiles) * plan.bn
        ks = slice(split * per * kq.BK,
                   min(plan.ktiles, (split + 1) * per) * kq.BK)
        out[bm:bm + kq.BM, bn:bn + plan.bn] += (
            a[bm:bm + kq.BM, ks] @ bmat[bn:bn + plan.bn, ks].T)
    out = out[:plan.m, :wq.shape[0]].reshape(n, ho, wo, -1)
    return torch.tensor(out.transpose(0, 3, 1, 2).astype(np.int32))


@pytest.mark.parametrize("n,h,w,cin,cout,k,stride,splits", [
    (2, 8, 8, 512, 64, 3, 1, None), (3, 15, 13, 40, 72, 3, 2, 2),
    (1, 16, 16, 3, 32, 7, 2, 3), (2, 9, 9, 512, 136, 3, 1, 5)])
def test_qconv_plan_emulated_equals_plain(n, h, w, cin, cout, k, stride,
                                          splits):
    """The plan's blocks, emulated, give the plain twin's int32 sums: the
    tiles and splits cover every product once (the card holds the kernel
    itself to the twin)."""
    from panodepth_torch.kernels import qconv as kq

    rng = np.random.RandomState(cin + cout)
    x = torch.tensor(rng.normal(0, 1, (n, cin, h, w)).astype(np.float32))
    xq, _ = kq.quantize_nhwc_plain(x)
    wq = kq.prepare_weight(torch.tensor(
        rng.randint(-127, 128, (cout, cin, k, k)).astype(np.int8)))
    pads = (kq.same_pads(h, k, stride), kq.same_pads(w, k, stride))
    plan = kq.qconv_plan(n, h, w, xq.shape[3], cout, k, k, stride, stride)
    if splits is not None:
        plan = kq.QConvPlan(plan.m, cout, plan.ktaps, plan.bn, plan.stages,
                            splits)
        assert plan.splits <= plan.ktiles
    got = _emulate_qconv_sums(xq, wq, (k, k), (stride, stride), pads, plan)
    assert torch.equal(got, kq.qconv_sums_plain(xq, wq, (k, k),
                                                (stride, stride), pads))


def _quantize_input(n, c, dtype, seed):
    """(N, C, 5, 7) activations made with numpy: a normal image, an
    all-zero one (sx = 1e-8/127), exact ties (k + 0.5) / 8 under amax
    127/8 with -0.0 among them, then images at scales 1e-3 .. 1e3."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, c, 5, 7)) * 10.0 ** rng.uniform(-3, 3,
                                                             (n, 1, 1, 1))
    x[1] = 0.0
    ties = (rng.randint(-127, 127, (c, 5, 7)) + 0.5) / 8
    ties.flat[0] = 127 / 8
    ties.flat[1::4] = -0.0
    x[2] = ties
    return x.astype(np.float32), dtype


@pytest.mark.parametrize("c", [3, 32, 512])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_twin_matches_jax(c, dtype):
    """``quantize_nhwc_plain`` against JAX's QConv quantization
    (panodepth/models/perspective.py:62-67) on the CPU, op by op as
    ``tests/test_torch_quantize.py`` runs JAX's QConv: the codes and the
    scales bit-equal, ties, zeros, -0.0 and mixed ranges included; the
    codes also as JAX's QConv module itself computes them (a 1x1 identity
    conv in f32 gives back xq * sx, which rounds back to the codes).
    Under ``jax.jit`` XLA folds the division by 127 into a product by
    f32(1/127), which moves sx's last bit for ~5 % of amaxes (the all-zero
    image's among them); the port keeps the true division."""
    import jax
    import jax.numpy as jnp

    from panodepth.models import perspective as jpersp
    from panodepth_torch.kernels import qconv as kq

    x, _ = _quantize_input(5, c, dtype, seed=c)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(getattr(jnp, dtype))

    def jax_codes(v):  # perspective.py:62-67
        xf = v.astype(jnp.float32)
        sx = jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True)
        sx = jnp.maximum(sx, 1e-8) / 127.0
        return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx

    jq, jsx = jax_codes(xj)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(getattr(torch, dtype))
    q, sx = kq.quantize_nhwc_plain(xt)
    assert q.shape == (5, 5, 7, -(-c // 16) * 16) and not q[..., c:].any()
    np.testing.assert_array_equal(q[..., :c].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy().view(np.int32),
                                  np.asarray(jsx).ravel().view(np.int32))
    assert float(sx[1]) == np.float32(np.float32(1e-8) / np.float32(127))
    conv = jpersp.QConv(c, (1, 1), use_bias=False, dtype=jnp.float32)
    params = {"params": {"kernel_q": jnp.eye(c, dtype=jnp.int8)[None, None],
                         "scale": jnp.ones((c,), jnp.float32)}}
    y = np.asarray(conv.apply(params, xj))
    back = np.rint(y / np.asarray(jsx)).astype(np.int8)
    np.testing.assert_array_equal(q[..., :c].numpy(), back)


# --- the quantization's launch plan (kernels/qconv.quantize_plan) ---

# the 14 quantization inputs of the zoo GN perspective net on 15 views at
# 256x256 (the inputs of its 39 int8 convs): (C, H, W, dtype)
GN_QUANTIZE_SHAPES = [
    (3, 256, 256, "bfloat16"), (32, 128, 128, "float32"),
    (64, 64, 64, "float32"), (128, 32, 32, "float32"),
    (256, 16, 16, "float32"), (512, 8, 8, "float32"),
    (128, 16, 16, "bfloat16"), (128, 16, 16, "float32"),
    (128, 32, 32, "bfloat16"), (128, 64, 64, "float32"),
    (128, 64, 64, "bfloat16"), (128, 128, 128, "float32"),
    (128, 128, 128, "bfloat16"), (64, 256, 256, "bfloat16")]
# odd inputs (N, C, H, W, dtype, aligned): N = 1, C = 3 and 40 (below and
# off 16), 7x11 pixels (rows TMA refuses), an unaligned input, a 512-view's
# decoder input (the L2 path), an image larger than the L2 cache
ODD_QUANTIZE = [
    (1, 3, 7, 11, "float32", True), (1, 3, 7, 11, "bfloat16", True),
    (3, 40, 7, 11, "bfloat16", True), (3, 40, 9, 130, "float32", True),
    (4, 3, 17, 23, "float32", True), (5, 64, 66, 66, "float32", True),
    (15, 128, 32, 32, "float32", False), (2, 16, 8, 8, "bfloat16", False),
    (2, 64, 512, 512, "bfloat16", True), (1, 64, 512, 512, "float32", True),
    (3, 600, 4, 4, "float32", True), (40, 32, 8, 8, "bfloat16", True)]
QUANTIZE_CASES = ([(15, c, h, w, dt, True)
                   for c, h, w, dt in GN_QUANTIZE_SHAPES] + ODD_QUANTIZE)


def test_gn_quantize_shapes_are_the_nets_own():
    """The table above is the int8 GN net's: every QConv input of a forward
    (at 64x64, so the sizes are a quarter of 256x256's), with its type."""
    from panodepth_torch.models import layers, quantize
    from panodepth_torch.models.perspective import PerspectiveDepthNet

    net = PerspectiveDepthNet()
    layers.init_params(net, torch.Generator().manual_seed(0))
    qnet = quantize.quantize_perspective(net)
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: seen.append((
        a[0].shape[1], 4 * a[0].shape[2], 4 * a[0].shape[3],
        str(a[0].dtype).replace("torch.", ""))))
        for m in quantize.qconvs(qnet)]
    with torch.no_grad():
        qnet(torch.rand(1, 64, 64, 3))
    for h in hooks:
        h.remove()
    assert len(seen) == 39 and set(seen) == set(GN_QUANTIZE_SHAPES)
    assert len(GN_QUANTIZE_SHAPES) == 14


def _quantize_plan(n, c, h, w, dtype, aligned, **kw):
    from panodepth_torch.kernels import qconv as kq

    return kq.quantize_plan(n, c, h * w, getattr(torch, dtype), aligned, **kw)


def _fits_somewhere(c, pixels, esize, tma, sms):
    """Whether some tile shape within a block's shared memory needs no
    more tiles than a grid of ``sms`` SMs has blocks, at some number of
    blocks an SM."""
    from panodepth_torch.kernels import qconv as kq

    for bps in kq.Q_BLOCKS_PER_SM:
        for tc, bw, nb in kq._geometries(c, pixels, esize, tma):
            p = kq.QuantizePlan(1, c, pixels, esize, tma, tc, bw, nb, 1, 1,
                                bps)
            if p.smem_bytes <= kq.smem_max(bps) and p.tiles <= sms * bps:
                return True
    return False


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,c,h,w,dtype,aligned", QUANTIZE_CASES)
def test_quantize_plan_covers_each_element_once(n, c, h, w, dtype, aligned,
                                                sms):
    """Every element of every image falls in exactly one tile of one slice
    of one wave, and every 16-channel piece of every output pixel is
    written by exactly one tile; a slice is one image's (its boxes never
    reach past the image's channels or pixels); the stages and the
    codes' tile (pixel rows of an odd number of 16-byte pieces) within
    the shared memory of the plan's blocks an SM; the grid within the
    co-resident blocks; TMA's box limits; the L2 path exactly where no
    tile within a block's shared memory lets an image's tiles fit the
    grid's blocks."""
    from panodepth_torch.kernels import qconv as kq

    p = _quantize_plan(n, c, h, w, dtype, aligned, sms=sms)
    pixels = h * w
    assert (p.n, p.c, p.pixels, p.esize) == (n, c, pixels,
                                             2 if dtype == "bfloat16" else 4)
    assert p.tma == (aligned and pixels * p.esize % 16 == 0)
    seen = np.zeros((n, c, pixels), np.uint8)
    groups = np.zeros((n, pixels, p.cinp // 16), np.uint8)
    for wave in range(p.waves):
        for block in range(p.grid):
            img = p.image(wave, block)
            if img is None:
                assert wave == p.waves - 1
                continue
            tiles = p.slice_tiles(block)
            assert 1 <= len(tiles) <= p.k
            for t in tiles:
                c0, p0 = p.tile_origin(t)
                assert 0 <= c0 < c and 0 <= p0 < pixels
                seen[img, c0:c0 + p.tc, p0:p0 + p.width] += 1
                g0 = c0 // 16
                g1 = min(c0 + -(-p.tc // 16) * 16, p.cinp) // 16
                groups[img, p0:p0 + p.width, g0:g1] += 1
    assert (seen == 1).all() and (groups == 1).all()
    assert p.tc == c or (p.tc % 32 == 0 and p.tc < c)
    assert p.bw * p.esize % 16 == 0 and p.box_bytes % kq.Q_ALIGN == 0
    if p.tma:
        assert p.bw <= kq.MAX_BOX and p.tc <= kq.MAX_BOX
    else:
        assert p.nb == 1
    assert p.blocks_per_sm in kq.Q_BLOCKS_PER_SM
    assert p.smem_bytes <= kq.smem_max(p.blocks_per_sm)
    assert p.smem_bytes == (kq.Q_STAGES * p.stage_bytes + p.code_bytes
                            + kq.Q_ALIGN)
    assert p.code_stride // 16 % 2 == 1 and p.code_stride >= p.tcp
    assert 32 <= p.code_px <= p.width or p.code_px == p.width
    assert p.code_bytes >= p.code_px * p.code_stride
    per_block = p.smem_bytes + kq.Q_SMEM_STATIC + kq.SMEM_RESERVED
    assert p.smem_bytes + kq.Q_SMEM_STATIC <= SMEM_MAX
    assert p.blocks_per_sm * per_block <= kq.SMEM_SM
    assert p.grid <= sms * p.blocks_per_sm
    assert p.l2 == (not _fits_somewhere(c, pixels, p.esize, p.tma, sms))
    image_bytes = c * pixels * p.esize
    budget = max(sms * b * kq.smem_max(b) // kq.Q_STAGES
                 for b in kq.Q_BLOCKS_PER_SM)
    if image_bytes > budget:
        assert p.l2 and p.ipw == 1
    if p.l2:
        assert p.spi * p.k >= p.tiles > (p.spi - 1) * p.k


def test_quantize_plans_of_the_net():
    """At 15 views: the small layers in one wave, every image resident (no
    L2 path), the 8.39 MB decoder images one a wave, and no wave left
    with fewer images than the one before."""
    for c, h, w, dt in GN_QUANTIZE_SHAPES:
        p = _quantize_plan(15, c, h, w, dt, True)
        assert p.tma and not p.l2
        if c * h * w <= 128 * 32 * 32:
            assert p.waves == 1, (c, h, w, dt)
        if c * h * w * p.esize > 8e6:
            assert p.ipw == 1 and p.waves == 15
        assert 15 - (p.waves - 1) * p.ipw <= p.ipw


def test_quantize_plan_options_and_refusals():
    """``blocks_per_sm`` and ``images_per_wave`` pick a candidate (the
    A/B's sweep); a shape no plan takes is refused; the plan is cached."""
    from panodepth_torch.kernels import qconv as kq

    p = _quantize_plan(15, 512, 8, 8, "float32", True, blocks_per_sm=2,
                       images_per_wave=5)
    assert (p.blocks_per_sm, p.ipw, p.waves) == (2, 5, 3)
    assert p.grid <= kq.SMS * p.blocks_per_sm
    assert _quantize_plan(15, 512, 8, 8, "float32", True) is \
        _quantize_plan(15, 512, 8, 8, "float32", True)
    with pytest.raises(ValueError, match="no plan"):
        _quantize_plan(15, 128, 128, 128, "float32", True, blocks_per_sm=2,
                       images_per_wave=15)
    with pytest.raises(ValueError, match="bf16 or f32"):
        kq.quantize_plan(2, 3, 16, torch.float64)


def _emulate_quantize(x, plan):
    """The kernel's walk in numpy: each block of each wave takes its slice's
    tiles (boxes zero past C and H*W), publishes the max of |x|'s float
    bits over them on its image's word, and once the image's words are in,
    writes the tiles' codes (padding channels 0); returns (int8 NHWC codes,
    f32 scales)."""
    xf = x.float().numpy()
    n, c = xf.shape[:2]
    flat = xf.reshape(n, c, -1)
    pixels = flat.shape[2]
    rows_pad = plan.tiles_c * plan.tc - c
    cols_pad = plan.tiles_p * plan.width - pixels
    padded = np.pad(flat, ((0, 0), (0, rows_pad), (0, cols_pad)))
    amax = np.zeros(n, np.uint32)
    q = np.zeros((n, pixels, plan.cinp), np.int8)
    for wave in range(plan.waves):
        words = {}
        for block in range(plan.grid):
            img = plan.image(wave, block)
            if img is None:
                continue
            m = np.uint32(0)
            for t in plan.slice_tiles(block):
                c0, p0 = plan.tile_origin(t)
                tile = padded[img, c0:c0 + plan.tc, p0:p0 + plan.width]
                m = max(m, np.abs(tile).view(np.uint32).max())
            words[img] = max(words.get(img, np.uint32(0)), m)
        for img, bits in words.items():
            amax[img] = bits
            a = np.array([bits], np.uint32).view(np.float32)
            s = torch.tensor(a).clamp_min(1e-8) / torch.full((), 127.0)
            for block in range(plan.grid):
                if plan.image(wave, block) != img:
                    continue
                for t in plan.slice_tiles(block):
                    c0, p0 = plan.tile_origin(t)
                    tile = torch.tensor(
                        padded[img, c0:c0 + plan.tc, p0:p0 + plan.width])
                    codes = torch.clamp(torch.round(tile / s), -127, 127) \
                        .to(torch.int8).numpy()
                    w = min(plan.width, pixels - p0)
                    vr = min(plan.tc, c - c0)
                    q[img, p0:p0 + w, c0:c0 + vr] = codes[:vr, :w].T
    sx = torch.tensor(amax.view(np.float32)).clamp_min(1e-8) \
        / torch.full((), 127.0)
    return torch.tensor(q).view(n, *x.shape[2:], plan.cinp), sx


@pytest.mark.parametrize("n,c,h,w,dtype,aligned,forced", [
    (5, 40, 7, 11, "bfloat16", True, None),
    (6, 3, 17, 23, "float32", True, None),
    (4, 64, 16, 16, "float32", True, (1, 2)),
    (3, 48, 12, 20, "float32", True, ("k", 3)),
    (7, 32, 8, 8, "bfloat16", False, None)])
def test_quantize_plan_emulated_equals_plain(n, c, h, w, dtype, aligned,
                                            forced):
    """The plan's blocks, emulated, give the plain twin's codes and scales
    bit for bit: the tiles cover every element once, zeros past C and H*W
    change no max, each image's words combine its slices (ties, zeros and
    -0.0 among the images; the card holds the kernel itself to the twin).
    ``forced``: (blocks an SM, images a wave), or a slice of k tiles (the
    L2 path) on a small image."""
    import dataclasses

    from panodepth_torch.kernels import qconv as kq

    xs, _ = _quantize_input(n, c, dtype, seed=c + n)
    x = torch.nn.functional.interpolate(torch.tensor(xs), size=(h, w),
                                        mode="nearest")
    x = x.to(getattr(torch, dtype))
    if forced and forced[0] == "k":
        plan = _quantize_plan(n, c, h, w, dtype, aligned)
        plan = dataclasses.replace(plan, k=forced[1], ipw=1)
        assert plan.l2 and plan.spi < plan.tiles
    elif forced:
        plan = _quantize_plan(n, c, h, w, dtype, aligned,
                              blocks_per_sm=forced[0],
                              images_per_wave=forced[1])
    else:
        plan = _quantize_plan(n, c, h, w, dtype, aligned)
    got_q, got_sx = _emulate_quantize(x, plan)
    want_q, want_sx = kq.quantize_nhwc_plain(x)
    assert torch.equal(got_q, want_q)
    assert torch.equal(got_sx.view(torch.int32), want_sx.view(torch.int32))


def _fast_codes(x, s):
    """``csrc/quantize.cu``'s fast_code in float32 numpy (IEEE round to
    nearest, as the kernel's intrinsics): f = x * rn(1 / s), rounded by
    adding 1.5 * 2^23, the code the low byte of the sum's bits; returns
    (codes, near a half-integer or not finite)."""
    magic = np.float32(12582912.0)
    rcp = np.float32(1) / s
    with np.errstate(invalid="ignore", over="ignore"):
        f = x * rcp
        y = f + magic
        near = ~(np.abs(f - (y - magic)) < np.float32(0.5 - 2.0 ** -15))
    codes = y.view(np.int32).astype(np.int8)  # the low byte of the bits
    return codes, near


@pytest.mark.parametrize("kind", ["normal", "ties", "bf16", "tiny"])
def test_quantize_fast_code_rule_is_exact(kind):
    """Where fast_code does not flag an element, its code is the exact
    division's (rintf(x / s) clamped), on a million elements an image
    scale: normal values, exact ties (k + 0.5) / 8 under amax 127 / 8,
    bf16 values, and an image below the 1e-8 floor; the flagged share
    stays small but for the ties, which are all flagged; a NaN scale
    flags every element."""
    rng = np.random.RandomState(len(kind))
    if kind == "ties":
        x = ((rng.randint(-127, 127, 1 << 20) + 0.5) / 8).astype(np.float32)
        x[0] = 127 / 8
    elif kind == "tiny":
        x = (rng.normal(0, 1e-9, 1 << 20)).astype(np.float32)
    else:
        x = (rng.normal(0, 1, 1 << 20)
             * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
    if kind == "bf16":
        x = torch.tensor(x).to(torch.bfloat16).float().numpy()
    amax = np.abs(x).max()
    s = np.float32(max(amax, np.float32(1e-8))) / np.float32(127)
    exact = np.clip(np.rint(x / s), -127, 127).astype(np.int32)
    codes, near = _fast_codes(x, s)
    assert (codes[~near] == exact[~near]).all()
    assert np.abs(exact).max() <= 127
    if kind == "ties":  # all but the amax, 127 / 8 itself
        assert near[1:].all() and not near[0]
    else:
        assert near.mean() < 1e-3
    codes, near = _fast_codes(np.array([1.0, np.nan, np.inf], np.float32),
                              np.float32(np.nan))
    assert near.all()
