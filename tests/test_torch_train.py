"""panodepth_torch.models.train against panodepth.models.train, and the
trainable nets: the losses, the schedule, one optimizer update, the EMA,
flax's initialisers, ``Derived`` and the GroupNorm under grad, remat,
distillation and the checkpoints.  Inputs are made with numpy from a seed.

Tolerances: the losses rel 1e-6 (f32 sums in other orders); the schedule
rel 1e-6 (both in f32; ``cos`` may differ by an ulp); one optimizer update
rel 1e-6 + abs 1e-9 (f32 element-wise arithmetic in the same order; XLA
may contract a multiply-add); the GroupNorm's training form 1e-5 of the
scale (f32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panodepth.models import norm as jnorm
from panodepth.models import train as jtrain

from panodepth_torch.kernels import groupnorm as kgn
from panodepth_torch.models import fastpano as tfast
from panodepth_torch.models import layers as tlayers
from panodepth_torch.models import norm as tnorm
from panodepth_torch.models import perspective as tpersp
from panodepth_torch.models import slicenet as tslice
from panodepth_torch.models import train as ttrain
from panodepth_torch.models import weights

from torch_port_common import flax_flat
from torch_train_common import TINY, batch, torch_batch

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    rng = np.random.RandomState(0)
    pred = (0.05 + rng.rand(3, 32, 48)).astype(np.float32)
    target = (0.05 + rng.rand(3, 32, 48)).astype(np.float32)
    mask = rng.rand(3, 32, 48) > 0.2 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    for jf, tf in ((jtrain.berhu_loss, ttrain.berhu_loss),
                   (jtrain.gradient_matching_loss,
                    ttrain.gradient_matching_loss),
                   (jtrain.depth_loss, ttrain.depth_loss)):
        want = float(jf(jnp.asarray(pred), jnp.asarray(target), jm))
        got = float(tf(_t(pred), _t(target), tm))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    same = torch.full((1, 8, 8), 0.5)
    assert float(ttrain.berhu_loss(same, same)) == 0.0
    assert float(ttrain.gradient_matching_loss(same, same)) == 0.0


@pytest.mark.parametrize("steps", [None, 1, 2, 50, 1000, 5000])
def test_schedule_matches_optax(steps):
    lr = 3e-4
    tx = ttrain.make_optimizer(lr=lr, steps=steps)
    if steps is None:
        want = optax.constant_schedule(lr)
        counts = [0, 1, 17]
    else:
        w = min(200, max(steps // 10, 1), max(steps - 1, 0))
        want = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps=w, decay_steps=steps, end_value=lr * 0.05)
        counts = sorted({0, 1, max(w - 1, 0), w, steps // 2, steps - 1})
    for c in counts:
        np.testing.assert_allclose(tx.schedule(c), float(want(c)), rtol=1e-6)
    if steps and steps > 1:
        assert tx.schedule(0) == 0.0  # the warmup starts at 0


def _tree(rng, scale):
    return {"a": (rng.randn(4, 3) * scale).astype(np.float32),
            "b": (rng.randn(7) * scale).astype(np.float32),
            "c": (rng.randn(2, 3, 5) * scale).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [0.05, 3.0])
@pytest.mark.parametrize("ema", [None, 0.9])
def test_optimizer_updates_match_optax(grad_scale, ema):
    """Three updates from fixed gradients, their global norm below 1 (no
    clip) or above (clipped), with and without the EMA, against
    ``make_optimizer(...).update``."""
    rng = np.random.RandomState(1)
    params = _tree(rng, 1.0)
    jtx = jtrain.make_optimizer(lr=1e-2, steps=20, warmup=2, ema=ema)
    ttx = ttrain.make_optimizer(lr=1e-2, steps=20, warmup=2, ema=ema)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [_t(params[k]).clone() for k in sorted(params)]
    jst, tst = jtx.init(jp), ttx.init(tp)
    for it in range(3):
        grads = _tree(rng, grad_scale)
        norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                           for g in grads.values()))
        assert (norm > 1.0) == (grad_scale > 1.0)
        ju, jst = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                             jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu = ttx.update([_t(grads[k]) for k in sorted(grads)], tst, tp)
        for k, u in zip(sorted(params), tu):
            np.testing.assert_allclose(u.numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-9)
        torch._foreach_add_(tp, tu)
        for k, p in zip(sorted(params), tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
    assert tst.count == 3
    if ema is not None:
        je = jtrain.ema_params(jst)
        for k, e in zip(sorted(params), tst.ema):
            np.testing.assert_allclose(e.numpy(), np.asarray(je[k]),
                                       rtol=1e-6, atol=1e-9)


def test_ema_of_params_recurrence():
    """make_optimizer(ema=d) tracks e <- d*e + (1-d)*p_new in the optimizer
    state, read back with ema_params; absent without the flag."""
    net = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        net.weight.fill_(1.0)
    tx = ttrain.make_optimizer(lr=1e-2, ema=0.9)
    state = ttrain.init_state(net, tx)
    np.testing.assert_array_equal(ttrain.ema_params(state)["weight"].numpy(),
                                  np.ones((1, 3), np.float32))
    e = np.ones((1, 3), np.float64)
    grads = [torch.full((1, 3), 0.5)]
    p = list(state.params.values())
    for _ in range(3):
        u = tx.update(grads, state.opt_state, p)
        with torch.no_grad():
            torch._foreach_add_(p, u)
        e = 0.9 * e + 0.1 * p[0].detach().numpy().astype(np.float64)
        np.testing.assert_allclose(ttrain.ema_params(state)["weight"].numpy(),
                                   e, rtol=1e-6)
    # the EMA lags the raw params (they moved, it smooths)
    assert not np.allclose(ttrain.ema_params(state)["weight"].numpy(),
                           p[0].detach().numpy())
    plain = ttrain.init_state(net, ttrain.make_optimizer(lr=1e-2))
    assert ttrain.ema_params(plain) is None
    with pytest.raises(ValueError):
        ttrain.make_optimizer(ema=1.0)


# --- flax's initialisers ---------------------------------------------------

_TRUNC = 0.87962566103423978


def _fresh_nets():
    gen = torch.Generator().manual_seed(0)
    nets = {"perspective_gn": tpersp.PerspectiveDepthNet(),
            "perspective_nf": tpersp.NFPerspectiveNet(),
            "fastpano": tfast.FastPanoNet(),
            "slicenet": tslice.SliceNet(widths=(8, 16, 16, 32),
                                        slice_dim=64, rnn_layers=1,
                                        height=64)}
    for net in nets.values():
        tlayers.init_params(net, gen)
    return nets


def _expected(name, module, pname, p):
    """(kind, std) flax draws parameter ``pname`` of ``module`` with."""
    if isinstance(module, tpersp.WSConv) and pname == "kernel":
        return "trunc", np.sqrt(2.0 / p[0].numel())
    if isinstance(module, tlayers.Dense) and pname == "kernel":
        return ("orthogonal", None) if module.orthogonal else (
            "trunc", np.sqrt(1.0 / p.shape[1]))
    if isinstance(module, tlayers.DenseGeneral) and pname == "kernel":
        return "trunc", np.sqrt(1.0 / module.fan_in)
    if isinstance(module, tlayers.Conv) and pname == "kernel":
        return "trunc", np.sqrt(1.0 / p[0].numel())
    if pname in ("scale", "gain"):
        return "const", 1.0
    if pname == "bias":
        return "const", getattr(module, "bias_init", 0.0)
    raise AssertionError(f"{name}.{pname}: no initialiser known")


def test_fresh_nets_follow_flax_initialisers():
    """Every parameter is trainable and drawn as flax draws it: kernels a
    normal truncated at 2 sigma with variance scale/fan_in (lecun 1, he
    2 for WSConv; the sample std within 4 standard errors, 4/sqrt(2n), of
    it where a kernel has n >= 500 values), nothing beyond
    the truncation, GRU recurrent kernels orthogonal, norms 1 / 0, the
    perspective heads' bias exactly -1.8."""
    checked = set()
    nets = _fresh_nets()
    for net_name, net in nets.items():
        for mname, module in net.named_modules():
            for pname, p in module.named_parameters(recurse=False):
                assert p.requires_grad, f"{net_name}.{mname}.{pname}"
                kind, val = _expected(net_name, module, pname, p)
                a = p.detach().numpy().astype(np.float64)
                checked.add(kind)
                if kind == "const":
                    np.testing.assert_array_equal(a, np.float32(val))
                elif kind == "orthogonal":
                    np.testing.assert_allclose(a @ a.T, np.eye(a.shape[0]),
                                               atol=1e-5)
                else:
                    assert np.abs(a).max() <= 2 * val / _TRUNC * (1 + 1e-6)
                    if a.size >= 500:
                        assert abs(a.std() / val - 1) < 4 / np.sqrt(
                            2 * a.size), (
                            net_name, mname, a.std(), val)
    assert checked == {"const", "orthogonal", "trunc"}
    heads = [nets["perspective_gn"].Conv_4.bias,
             nets["perspective_nf"].Conv_0.bias]
    for b in heads:
        assert float(b.detach()) == np.float32(-1.8)


def test_init_params_is_seeded():
    a = tlayers.init_params(tpersp.NFPerspectiveNet(**TINY),
                            torch.Generator().manual_seed(5))
    b = tlayers.init_params(tpersp.NFPerspectiveNet(**TINY),
                            torch.Generator().manual_seed(5))
    for (k, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), k


def test_loaded_checkpoint_is_an_inference_net(tmp_path):
    from panodepth_torch.e2e import load_model_checkpoint

    import os

    zoo = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "zoo")
    net, _ = load_model_checkpoint(os.path.join(zoo,
                                                "perspective_final.params.npz"),
                                   device="cpu")
    assert not any(p.requires_grad for p in net.parameters())
    assert not net.training


# --- Derived and the GroupNorm under grad ----------------------------------

def test_derived_recomputes_under_grad():
    """WSConv's standardised kernel is made anew under grad: the gradient
    reaches ``kernel`` and ``gain``, and after an update the next call sees
    the new weights; without grad the value is cached per weight version."""
    conv = tpersp.WSConv(4, 6, dtype=torch.float32)
    x = torch.rand(2, 4, 8, 8)
    y = conv(x)
    y.square().sum().backward()
    assert conv.kernel.grad is not None and conv.gain.grad is not None
    assert float(conv.kernel.grad.abs().sum()) > 0
    with torch.no_grad():
        before = conv.weight().clone()
        conv.kernel.add_(torch.randn_like(conv.kernel))
        after = conv.weight()
    assert not torch.equal(before, after)
    y2 = conv(x)
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (1, 1, 1, 1)), conv._standardize()) \
        + conv.bias[:, None, None]
    torch.testing.assert_close(y2, want, rtol=0, atol=0)
    with torch.no_grad():
        assert conv.weight() is conv.weight()  # cached for inference


@pytest.mark.parametrize("relu", [False, True])
def test_groupnorm_auto_under_grad_is_flax_form(relu):
    """Under grad, ``auto`` takes flax's differentiable computation: the
    forward and the gradients of x, scale and bias against jax.grad of the
    JAX package's GroupNorm (its flax path); no kernel launch; the
    ``kernel`` route refuses."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 16, 24).astype(np.float32) * 2 + 0.5   # NHWC
    scale = (1 + 0.1 * rng.randn(24)).astype(np.float32)
    bias = (0.1 * rng.randn(24)).astype(np.float32)
    wt = rng.randn(2, 8, 16, 24).astype(np.float32)
    jm = jnorm.GroupNorm(num_groups=4, dtype=jnp.float32, fuse_relu=relu)

    def jloss(xx, s, b):
        y = jm.apply({"params": {"scale": s, "bias": b}}, xx)
        return jnp.sum(y * wt), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    tm = tnorm.GroupNorm(24, 4, fuse_relu=relu)
    with torch.no_grad():
        tm.scale.copy_(_t(scale))
        tm.bias.copy_(_t(bias))
    tx = _t(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    before = kgn.LAUNCHES
    ty = tm(tx)
    (ty * _t(wt).permute(0, 3, 1, 2)).sum().backward()
    assert kgn.LAUNCHES == before
    tol = lambda a: 1e-5 * max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=0, atol=tol(jy))
    for got, want in ((tx.grad.permute(0, 2, 3, 1), jg[0]),
                      (tm.scale.grad, jg[1]), (tm.bias.grad, jg[2])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol(want))
    tnorm.set_route(tm, "kernel")
    with pytest.raises(RuntimeError, match="no backward"):
        tm(tx)


# --- the step: remat, distillation ------------------------------------------

def _tiny_fastpano(seed):
    net = tfast.FastPanoNet(**TINY)
    return tlayers.init_params(net, torch.Generator().manual_seed(seed))


def test_remat_step_matches_plain():
    """torch.utils.checkpoint recomputes the same ops: the same loss and
    updated params as the plain step (bf16 convs, as trained)."""
    b = torch_batch(batch((2, 32, 64), 3))
    states = []
    for remat in (False, True):
        net = _tiny_fastpano(5)
        tx = ttrain.make_optimizer(lr=1e-3)
        state = ttrain.init_state(net, tx)
        state, m = ttrain.make_train_step(net, tx, remat=remat)(state, b)
        states.append((state, m))
    (sa, ma), (sb, mb) = states
    assert float(ma["loss"]) == float(mb["loss"])
    for (k, a), b_ in zip(sa.params.items(), sb.params.values()):
        torch.testing.assert_close(a, b_, rtol=0, atol=0, msg=k)


def test_distillation_train_step():
    """The teacher term: with a perfect-ground-truth teacher at weight 1
    the loss doubles, the teacher runs without grad, and the distilled
    step trains."""
    rgb, depth, mask = torch_batch(batch((2, 32, 64), 4, masked=False))
    seen = []

    def teacher(r):
        seen.append(torch.is_grad_enabled())
        return depth

    net = _tiny_fastpano(9)
    tx = ttrain.make_optimizer(lr=1e-3)
    state = ttrain.init_state(net, tx)
    plain = ttrain.make_train_step(net, tx)
    teach = ttrain.make_train_step(net, tx, teacher_fn=teacher,
                                   distill_weight=1.0)
    l_plain, _ = plain.value_and_grad(state, (rgb, depth, mask))
    l_teach, _ = teach.value_and_grad(state, (rgb, depth, mask))
    np.testing.assert_allclose(2 * float(l_plain), float(l_teach), rtol=1e-6)
    assert seen == [False]
    losses = []
    for _ in range(5):
        state, m = teach(state, (rgb, depth, mask))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


# --- checkpoints -------------------------------------------------------------

def test_params_npz_loads_in_jax_and_back(tmp_path):
    """save_params_npz writes the zoo's format: JAX's load_params_npz takes
    it into the flax tree of the same net (every leaf the port's, rounded
    to bf16, in flax's layout), and the port reads it back bit for bit."""
    from panodepth.models.slicenet import SliceNet as JSlice

    net = tslice.SliceNet(widths=(8, 16, 16, 32), slice_dim=32,
                          rnn_layers=1, height=64)
    tlayers.init_params(net, torch.Generator().manual_seed(1))
    path = str(tmp_path / "slicenet_final.params.npz")
    ttrain.save_params_npz(path, dict(net.named_parameters()))
    jm = JSlice(widths=(8, 16, 16, 32), slice_dim=32, rnn_layers=1)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 128, 3)))
    template = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    loaded = flax_flat(jtrain.load_params_npz(path, template))
    for name, p in net.named_parameters():
        want = weights.to_flax_layout(
            name, p.detach().to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(loaded[weights.flax_key(name)], want)
    back = tslice.SliceNet(widths=(8, 16, 16, 32), slice_dim=32,
                           rnn_layers=1, height=64)
    ttrain.load_params_npz(path, back)
    for (k, a), b in zip(net.named_parameters(), back.parameters()):
        assert torch.equal(a.detach().to(torch.bfloat16).float(), b), k


def test_checkpoint_roundtrip(tmp_path):
    """The full state (params, moments, EMA, step) survives a save and a
    restore into a fresh net, and the next step is the same as without
    the round trip."""
    b = torch_batch(batch((2, 32, 64), 6))
    net = _tiny_fastpano(2)
    tx = ttrain.make_optimizer(lr=1e-3, steps=10, ema=0.99)
    state = ttrain.init_state(net, tx)
    step = ttrain.make_train_step(net, tx)
    for _ in range(2):
        state, _ = step(state, b)
    path = str(tmp_path / "fastpano_1")
    ttrain.save_checkpoint(path, state)
    ttrain.save_checkpoint(path, state)  # an existing checkpoint is replaced
    other = _tiny_fastpano(7)
    tx2 = ttrain.make_optimizer(lr=1e-3, steps=10, ema=0.99)
    st2 = ttrain.restore_checkpoint(path, ttrain.init_state(other, tx2))
    assert st2.step == 2 and st2.opt_state.count == 2
    state, ma = step(state, b)
    st2, mb = ttrain.make_train_step(other, tx2)(st2, b)
    assert float(ma["loss"]) == float(mb["loss"])
    for (k, x), y in zip(state.params.items(), st2.params.values()):
        assert torch.equal(x, y), k
    for x, y in zip(state.opt_state.ema, st2.opt_state.ema):
        assert torch.equal(x, y)
