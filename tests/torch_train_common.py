"""Shared pieces of the training parity tests (tests/test_torch_train*.py).

The same initial parameters go into both packages: the port draws them
with flax's initialisers (``layers.init_params``, from a seeded
``torch.Generator``) and hands them to JAX in flax's layout
(``weights.flax_key`` / ``to_flax_layout``, the export path of
``save_params_npz``), checked against the tree that JAX's own ``init``
would make (``jax.eval_shape``, which draws nothing).  Carrying JAX's
``init`` the other way costs 8-43 s a family on one core (it dispatches
or compiles the whole init graph); the structure check is the same.
Batches are made with numpy from a seed.

Why the gradient bars differ by family (seed 3, the shapes below; the
port's f32 gradients were within 2e-5 of the port's own float64
evaluation for FastPanoNet and the UniFuse-class net, JAX's f32 CPU
gradients 8e-3 and 6e-2 off it on a leaf): the tiny nets' GroupNorms
normalise groups of one channel over 2-32 pixels, where flax's fast
variance ``E[x²] - E[x]²`` cancels and amplifies each compiler's f32
rounding into the gradients; the two-branch nets also take their cube
taps from directions in float64 on the host, where JAX takes them in f32
on the device (ROADMAP Queue 3), so a tap on a pixel boundary routes a
pixel's gradient to the neighbouring cube pixel.  The perspective nets
hold the 1e-4 bar on every leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from panodepth.models import bifuse as jbifuse
from panodepth.models import fastpano as jfast
from panodepth.models import hohonet as jhoho
from panodepth.models import panoramic as jpano
from panodepth.models import perspective as jpersp
from panodepth.models import slicenet as jslice
from panodepth.models import train as jtrain

from panodepth_torch.models import bifuse as tbifuse
from panodepth_torch.models import fastpano as tfast
from panodepth_torch.models import hohonet as thoho
from panodepth_torch.models import layers as tlayers
from panodepth_torch.models import panoramic as tpano
from panodepth_torch.models import perspective as tpersp
from panodepth_torch.models import slicenet as tslice
from panodepth_torch.models import train as ttrain
from panodepth_torch.models import weights

from torch_port_common import flax_flat

TINY = dict(stage_sizes=(1, 1, 1, 1), widths=(8, 16, 16, 32),
            decoder_width=16)
PANO = dict(widths=(8, 16, 16, 32))
PERSP_SHAPE = (2, 64, 96)
PANO_SHAPE = (2, 64, 128)
MODES = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def family(name, jd, td):
    """(JAX net computing in ``jd``, port net computing in ``td``, batch
    shape) of a family at tiny widths."""
    if name == "perspective_gn":
        return (jpersp.PerspectiveDepthNet(dtype=jd, **TINY),
                tpersp.PerspectiveDepthNet(dtype=td, **TINY), PERSP_SHAPE)
    if name == "perspective_nf":
        return (jpersp.NFPerspectiveNet(dtype=jd, **TINY),
                tpersp.NFPerspectiveNet(dtype=td, **TINY), PERSP_SHAPE)
    if name == "panoramic_gn":
        return (jpano.PanoBaselineNet(dtype=jd, **PANO),
                tpano.PanoBaselineNet(dtype=td, **PANO), PANO_SHAPE)
    if name == "panoramic_nf":
        return (jpano.NFPanoBaselineNet(dtype=jd, **PANO),
                tpano.NFPanoBaselineNet(dtype=td, **PANO), PANO_SHAPE)
    if name == "hohonet":
        return (jhoho.HorizonDepthNet(horizon_dim=32, attn_blocks=1,
                                      dtype=jd, **PANO),
                thoho.HorizonDepthNet(horizon_dim=32, attn_blocks=1,
                                      dtype=td, height=64, **PANO),
                PANO_SHAPE)
    if name == "bifuse":
        return (jbifuse.BiFuseNet(dtype=jd, **PANO),
                tbifuse.BiFuseNet(dtype=td, **PANO), PANO_SHAPE)
    if name == "slicenet":
        return (jslice.SliceNet(slice_dim=32, rnn_layers=1, dtype=jd,
                                **PANO),
                tslice.SliceNet(slice_dim=32, rnn_layers=1, dtype=td,
                                height=64, **PANO), PANO_SHAPE)
    if name == "fastpano":
        return (jfast.FastPanoNet(dtype=jd, **TINY),
                tfast.FastPanoNet(dtype=td, **TINY), PANO_SHAPE)
    raise ValueError(name)


def nest(flat):
    """A flax params tree (nested dicts) from {flax path string: array}."""
    tree = {}
    for key, a in flat.items():
        parts = key[2:-2].split("']['")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(a)
    return tree


def port_params_to_jax(jmodel, tmodel, shape, seed):
    """Draw the port net's parameters from ``seed``; returns the same
    parameters as a flax tree for ``jmodel``, whose structure is checked
    against ``jmodel.init``'s."""
    tlayers.init_params(tmodel, torch.Generator().manual_seed(seed))
    # copies: a 1-D leaf's layout is the port's own memory, which the
    # port's step then writes in place
    flat = {weights.flax_key(k): weights.to_flax_layout(
        k, v.detach().numpy().copy()) for k, v in tmodel.named_parameters()}
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1,) + shape[1:] + (3,)))
    shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    assert shapes == {k: a.shape for k, a in flat.items()}
    return nest(flat)


def batch(shape, seed, masked=True):
    """(rgb, depth, mask) numpy arrays: rgb in [0, 1), depth in [0.05,
    0.95), a mask with ~10 % of the pixels off."""
    rng = np.random.RandomState(seed)
    rgb = rng.rand(*shape, 3).astype(np.float32)
    depth = (0.05 + 0.9 * rng.rand(*shape)).astype(np.float32)
    mask = rng.rand(*shape) > 0.1 if masked else np.ones(shape, bool)
    return rgb, depth, mask


def torch_batch(b):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in b)


def jax_value_and_grad(jmodel, jparams, b, grad_weight=0.5):
    """JAX's loss and gradients (the loss of ``make_train_step``)."""
    rgb, depth, mask = (jnp.asarray(a) for a in b)

    def loss_fn(p):
        return jtrain.depth_loss(jmodel.apply(p, rgb), depth, mask,
                                 grad_weight)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    return float(loss), {k: np.asarray(v, np.float64)
                         for k, v in flax_flat_any(grads).items()}


def flax_flat_any(params):
    """{flax path string: leaf} of a params tree, leaves as they are."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def rel_l2(got, want, floor=0.0):
    """||got - want|| / max(||want||, floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), floor, 1e-30))


def port_grads_flax(state, grads):
    """The port's gradients by flax path, in flax's layout."""
    return {weights.flax_key(k): weights.to_flax_layout(k, g.numpy())
            for k, g in zip(state.params, grads)}


def check_step(name, mode="f32", seed=3, loss_rel=1e-5, leaf_rel=1e-4,
               total_rel=1e-4):
    """One train step of family ``name`` in both packages, computing in
    ``mode`` (f32 or bf16), from the same parameters and batch: the loss
    within ``loss_rel``, the gradients' global norm and the whole gradient
    (every leaf as one vector) within ``total_rel``, and each leaf's
    gradient within ``leaf_rel`` relative L2 (a leaf whose gradient is
    under 1e-3 of the mean leaf's norm is held against that floor; None
    checks no single leaf).  Returns (JAX params, JAX grads, the port's
    state after the step, its net, the batch)."""
    jd, td = MODES[mode]
    jmodel, tmodel, shape = family(name, jd, td)
    jparams = port_params_to_jax(jmodel, tmodel, shape, seed)
    b = batch(shape, seed + 1)
    jloss, jgrads = jax_value_and_grad(jmodel, jparams, b)

    tx = ttrain.make_optimizer(lr=1e-3)
    state = ttrain.init_state(tmodel, tx)
    step = ttrain.make_train_step(tmodel, tx)
    tb = torch_batch(b)
    loss, grads = step.value_and_grad(state, tb)
    tgrads = port_grads_flax(state, grads)
    keys = sorted(jgrads)
    assert keys == sorted(tgrads)
    assert abs(float(loss) - jloss) <= loss_rel * abs(jloss), (float(loss),
                                                               jloss)
    flat = lambda g: np.concatenate([g[k].ravel() for k in keys])
    assert rel_l2(flat(tgrads), flat(jgrads)) <= total_rel
    jnorm = float(np.linalg.norm(flat(jgrads)))
    if leaf_rel is not None:
        floor = 1e-3 * jnorm / np.sqrt(len(keys))
        worst = max((rel_l2(tgrads[k], jgrads[k], floor), k) for k in keys)
        assert worst[0] <= leaf_rel, worst
    state, metrics = step(state, tb)
    assert float(metrics["loss"]) == float(loss)
    assert abs(float(metrics["grad_norm"]) - jnorm) <= total_rel * jnorm
    assert state.step == 1 and state.opt_state.count == 1
    return jparams, jgrads, state, tmodel, b


def check_updated_leaves(jparams, jgrads, state, frac, lr=1e-3):
    """The port's parameters after its first step against optax's update
    (``make_optimizer(lr)``, jitted) of JAX's gradients: every element
    within 2 * lr (Adam's first step moves an element by lr * g / (|g| +
    1e-8) plus the decay, so one whose gradient is at rounding level may
    move the other way), and at least ``frac`` of them within 1e-6 +
    1e-5 * |p|."""
    import optax

    tree = jparams
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [np.asarray(jgrads[jax.tree_util.keystr(k)], np.float32)
         for k, _ in paths])
    jtx = jtrain.make_optimizer(lr=lr)
    u, _ = jax.jit(jtx.update)(grads, jtx.init(tree), tree)
    want = flax_flat_any(optax.apply_updates(tree, u))
    close = total = 0
    for name, p in state.params.items():
        got = weights.to_flax_layout(name, p.detach().numpy())
        w = want[weights.flax_key(name)]
        d = np.abs(got - w)
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), name
        close += int(np.sum(d <= 1e-6 + 1e-5 * np.abs(w)))
        total += d.size
    assert close >= frac * total, (close, total)
