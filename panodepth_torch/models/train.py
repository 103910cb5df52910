"""Training: losses, the optimizer, the train step, checkpoints.

Counterpart of ``panodepth/models/train.py``:

* the losses ``berhu_loss``, ``gradient_matching_loss`` and
  ``depth_loss`` (train.py:22-55), ``stop_gradient`` as ``detach``; with
  a ``reduce`` (a mesh's ``all_reduce``) each rank's part of the loss of
  the global batch;
* :func:`make_optimizer` (train.py:107-137): optax's
  ``chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay))`` and
  the optional parameter EMA (``ema_of_params``), written out with optax's
  arithmetic: the clip is ``where(norm < 1, g, g / norm)`` (no epsilon),
  AdamW has b1 0.9, b2 0.999, eps 1e-8 and decays every leaf, the learning
  rate is the schedule at the update count (0 at step 0 under warmup);
* :class:`TrainState` (params, optimizer moments and EMA, step) and
  :func:`make_train_step` (train.py:147-187): one step of loss, gradients
  (``remat`` recomputes the forward in the backward,
  ``torch.utils.checkpoint``), a teacher's depth under ``no_grad`` for
  distillation, the update.  JAX's step is a pure function; this one
  updates the parameters, moments and EMA in place.  Under
  ``debug.nan_checks`` (``--debug-nans``) it checks the parameters, the
  loss, the gradients and the updated parameters for NaN;
* :func:`shard_train_step` (train.py:190-200): the step data parallel
  over a mesh's ranks.  JAX differentiates the loss of the global batch,
  whose BerHu threshold is the batch's largest error and whose
  normalisers are the batch's mask sums; so each rank takes the largest
  error and the normalisers over the ranks (``reduce``), divides its own
  sums by them, and the ranks' gradients and losses are summed: the
  gradient of the global loss, on every rank the same, so the clip,
  AdamW and the EMA keep the ranks' states equal;
* checkpoints: the full state in torch's format in a directory
  ``<model>_<tag>`` (JAX's orbax directory names), and
  :func:`save_params_npz`, the zoo's ``*.params.npz`` (flax paths, flax
  layouts, bf16 bit patterns as ``uint16``), which the JAX package's
  ``load_params_npz`` reads.

The step runs under ``pipeline.true_f32``: JAX's f32 is true f32, where
cuDNN would run the f32 output head in TF32.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .. import debug
from . import weights


def berhu_loss(pred, target, mask=None, reduce=None):
    """Reverse Huber: L1 near zero, scaled L2 beyond c = 0.2 * max|err|.
    With ``reduce(t, op)`` (``op`` ``sum`` or ``max`` over the ranks) this
    rank's part of the loss of the ranks' batches together: ``c`` from
    their largest error, this rank's sum over their mask count."""
    err = (pred - target).abs()
    if mask is not None:
        err = torch.where(mask, err, 0.0)
    top = err.max().detach()
    c = 0.2 * (top if reduce is None else reduce(top, "max")) + 1e-12
    l2 = (err * err + c * c) / (2.0 * c)
    loss = torch.where(err <= c, err, l2)
    if reduce is None:
        if mask is None:
            return loss.mean()
        return loss.sum() / torch.clamp_min(mask.sum().to(loss.dtype), 1.0)
    count = torch.tensor(loss.numel(), device=loss.device) if mask is None \
        else mask.sum()
    return loss.sum() / torch.clamp_min(
        reduce(count, "sum").to(loss.dtype), 1.0)


def gradient_matching_loss(pred, target, mask=None, scales: int = 4,
                           reduce=None):
    """Multi-scale log-depth gradient matching (MiDaS-style); ``reduce`` as
    in :func:`berhu_loss` (each scale's mask sum over the ranks)."""
    eps = 1e-4
    diff = torch.log(torch.clamp_min(pred, eps)) - torch.log(
        torch.clamp_min(target, eps))
    m = torch.ones_like(diff) if mask is None else mask.to(diff.dtype)
    total = 0.0
    for s in range(scales):
        d = diff[:, ::2 ** s, ::2 ** s]
        mm = m[:, ::2 ** s, ::2 ** s]
        gx = (d[:, :, 1:] - d[:, :, :-1]).abs() * mm[:, :, 1:] * mm[:, :, :-1]
        gy = (d[:, 1:, :] - d[:, :-1, :]).abs() * mm[:, 1:, :] * mm[:, :-1, :]
        den = mm.sum() if reduce is None else reduce(mm.sum(), "sum")
        total = total + (gx.sum() + gy.sum()) / torch.clamp_min(den, 1.0)
    return total / scales


def depth_loss(pred, target, mask=None, grad_weight: float = 0.5,
               reduce=None):
    """BerHu plus ``grad_weight`` x gradient matching; with ``reduce`` this
    rank's part of the ranks' loss (their parts sum to it)."""
    return berhu_loss(pred, target, mask, reduce) + grad_weight * \
        gradient_matching_loss(pred, target, mask, reduce=reduce)


def make_schedule(lr: float, steps: Optional[int] = None, warmup: int = 200):
    """The learning rate at an update count: optax's
    ``warmup_cosine_decay_schedule(0, lr, w, steps, 0.05 * lr)`` with ``w =
    min(warmup, max(steps // 10, 1), max(steps - 1, 0))`` (the cosine tail
    is never empty), or the constant ``lr`` without ``steps``.  Evaluated
    in f32 as optax evaluates it (the warmup's ``(0 - lr) * frac + lr``
    rounds there)."""
    if steps is None:
        return lambda count: lr
    f32 = np.float32
    w = min(warmup, max(steps // 10, 1), max(steps - 1, 0))
    end = lr * 0.05
    alpha = 0.0 if lr == 0.0 else end / lr
    decay = steps - w

    def schedule(count: int) -> float:
        if count < w:  # linear from 0 (join_schedules' boundary at w)
            frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
            return float((f32(0.0) - f32(lr)) * frac + f32(lr))
        c = min(f32(count - w), f32(decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(f32(lr) * ((f32(1) - f32(alpha)) * cosine + f32(alpha)))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together."""
    norms = torch._foreach_norm(list(tensors))
    return torch.stack(norms).square().sum().sqrt()


@dataclasses.dataclass
class OptState:
    """AdamW's moments (``mu``, ``nu``, in the parameters' order), the update
    count, and the parameter EMA (None without ``ema``)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    ema: Optional[List[torch.Tensor]] = None


class Optimizer:
    """``make_optimizer``'s chain: ``clip_by_global_norm(1.0)``, AdamW with
    optax's defaults, the EMA."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lr: float = 1e-4, weight_decay: float = 1e-5,
                 steps: Optional[int] = None, warmup: int = 200,
                 ema: Optional[float] = None):
        if ema is not None and not (0.0 < ema < 1.0):
            raise ValueError(f"ema decay must be in (0, 1), got {ema}")
        self.schedule = make_schedule(lr, steps, warmup)
        self.weight_decay, self.ema = weight_decay, ema

    def init(self, params) -> OptState:
        params = [p.detach() for p in params]
        zeros = lambda: [torch.zeros_like(p) for p in params]
        return OptState(0, zeros(), zeros(),
                        None if self.ema is None
                        else [p.detach().clone() for p in params])

    def update(self, grads, state: OptState, params, norm=None):
        """The updates for ``grads`` (to add to ``params``), as optax's
        ``update`` returns them; advances ``state`` in place (moments,
        count, and the EMA of ``params + updates``).  ``norm`` is the
        gradients' global norm where the caller has it."""
        grads = [g.detach() for g in grads]
        params = [p.detach() for p in params]
        if norm is None:
            norm = global_norm(grads)
        # clip_by_global_norm(1.0): where(norm < 1, g, g / norm)
        g = torch._foreach_div(grads, torch.where(norm < 1.0, 1.0, norm))
        # scale_by_adam: (1 - b) * g^k + b * moment, bias corrected
        b1, b2 = self.B1, self.B2
        mu = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, b2))
        lr = self.schedule(state.count)
        state.count += 1
        # optax's bias corrections 1 - b**count, taken in f32
        c = np.float32(state.count)
        mu_hat = torch._foreach_div(mu, float(1 - np.float32(b1) ** c))
        den = torch._foreach_sqrt(torch._foreach_div(
            nu, float(1 - np.float32(b2) ** c)))
        torch._foreach_add_(den, self.EPS)
        u = torch._foreach_div(mu_hat, den)
        # add_decayed_weights, then scale_by_learning_rate (-lr)
        torch._foreach_add_(u, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(u, -lr)
        state.mu, state.nu = mu, nu
        if state.ema is not None:
            d = self.ema
            new_p = torch._foreach_add(params, u)
            ema = torch._foreach_mul(state.ema, d)
            torch._foreach_add_(ema, torch._foreach_mul(new_p, 1.0 - d))
            state.ema = ema
        return u


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-5,
                   steps: Optional[int] = None, warmup: int = 200,
                   ema: Optional[float] = None) -> Optimizer:
    """AdamW with global-norm clipping; with ``steps`` a linear warmup into
    cosine decay, else a constant rate; with ``ema`` a parameter EMA of
    decay ``ema`` (read back with :func:`ema_params`)."""
    return Optimizer(lr, weight_decay, steps, warmup, ema)


@dataclasses.dataclass
class TrainState:
    """``params``: the net's parameters by name (the net's own tensors,
    updated in place); ``opt_state``: the optimizer's; ``step``: steps
    taken."""

    params: Dict[str, torch.Tensor]
    opt_state: OptState
    step: int = 0


def init_state(model: nn.Module, tx: Optional[Optimizer] = None
               ) -> TrainState:
    """The state of ``model`` as it stands (its parameters are the state's)
    with fresh optimizer moments."""
    tx = tx or make_optimizer()
    params = dict(model.named_parameters())
    return TrainState(params, tx.init(params.values()), 0)


def ema_params(state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA of the parameters by name; None when EMA is off."""
    ema = state.opt_state.ema
    return None if ema is None else dict(zip(state.params, ema))


def make_train_step(model: nn.Module, tx: Optional[Optimizer] = None,
                    grad_weight: float = 0.5, remat: bool = False,
                    teacher_fn: Optional[Callable] = None,
                    distill_weight: float = 0.5) -> Callable:
    """``step(state, (rgb, depth, mask)) -> (state, metrics)`` with metrics
    ``loss`` and ``grad_norm`` (the gradients' global norm before the clip)
    as 0-d device tensors.  ``teacher_fn`` (rgb -> depth01) adds
    ``distill_weight`` x the depth loss against its prediction, taken
    under ``no_grad``.  ``step.value_and_grad(state, batch, reduce=None)``
    gives the loss and gradients alone (with ``reduce``, this rank's part
    of the ranks' loss, :func:`depth_loss`), ``step.apply(state, loss,
    grads)`` the update."""
    from torch.utils.checkpoint import checkpoint

    from ..pipeline import true_f32

    tx = tx or make_optimizer()

    def forward(rgb):
        if remat:
            return checkpoint(model, rgb, use_reentrant=False)
        return model(rgb)

    def value_and_grad(state: TrainState, batch, reduce=None):
        """(loss, gradients in the parameters' order) at ``state``."""
        rgb, depth, mask = batch
        params = list(state.params.values())
        debug.check("parameters entering the step", state.params)
        with true_f32(), torch.enable_grad():
            pred = forward(rgb)
            loss = depth_loss(pred, depth, mask, grad_weight, reduce)
            if teacher_fn is not None:
                with torch.no_grad():
                    t = teacher_fn(rgb)
                loss = loss + distill_weight * depth_loss(
                    pred, t, mask, grad_weight, reduce)
            debug.check("loss", loss)
            try:
                grads = torch.autograd.grad(loss, params, allow_unused=True)
            except RuntimeError as e:  # anomaly mode's NaN in the backward
                if debug.nans_on() and "nan" in str(e):
                    raise FloatingPointError(
                        f"--debug-nans: NaN in the gradients: {e}") from e
                raise
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        debug.check("gradients", dict(zip(state.params, grads)))
        return loss.detach(), grads

    def apply(state: TrainState, loss, grads):
        params = list(state.params.values())
        with torch.no_grad():
            gn = global_norm(grads)
            updates = tx.update(grads, state.opt_state, params, norm=gn)
            torch._foreach_add_(params, updates)
        debug.check("parameters after the update", state.params)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gn}

    def step(state: TrainState, batch):
        return apply(state, *value_and_grad(state, batch))

    step.value_and_grad = value_and_grad
    step.apply = apply
    return step


def shard_train_step(step_fn: Callable, mesh) -> Callable:
    """``step_fn`` (from :func:`make_train_step`) data parallel over the
    ranks of ``mesh`` (``parallel/mesh.py``): each rank passes its rows of
    the global batch; the loss is the global batch's (the largest error
    and the normalisers over the ranks, ``depth_loss``'s ``reduce``), its
    gradients summed over the ranks in one all-reduce with the ranks'
    losses, and the update runs on the same sums on every rank.  The
    state must start equal on every rank (``multihost.replicate``)."""
    from ..parallel import multihost as mh

    def value_and_grad(state: TrainState, batch):
        loss, grads = step_fn.value_and_grad(state, batch,
                                             reduce=mesh.all_reduce)
        if mesh.dp == 1:
            return loss, grads
        summed = mh.all_reduce([loss.reshape(1)] + list(grads), "sum")
        debug.check("gradients summed over the ranks",
                    dict(zip(state.params, summed[1:])))
        return summed[0].reshape(()), summed[1:]

    def step(state: TrainState, batch):
        return step_fn.apply(state, *value_and_grad(state, batch))

    step.value_and_grad = value_and_grad
    step.apply = step_fn.apply
    return step


# --------------------------------------------------------------------------
# checkpoints

_STATE_FILE = "state.pt"


def save_checkpoint(path: str, state: TrainState) -> None:
    """The full state (parameters, moments, EMA, step) as ``path/state.pt``
    in torch's format; the directory is replaced whole (written beside it,
    then renamed)."""
    cpu = lambda ts: None if ts is None else [t.detach().cpu() for t in ts]
    blob = dict(
        params={k: v.detach().cpu() for k, v in state.params.items()},
        count=state.opt_state.count, mu=cpu(state.opt_state.mu),
        nu=cpu(state.opt_state.nu), ema=cpu(state.opt_state.ema),
        step=state.step)
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(blob, os.path.join(tmp, _STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _load_params(path: str, params: Dict[str, torch.Tensor]) -> dict:
    """Read a :func:`save_checkpoint` directory and copy its parameters
    into ``params`` (in place); returns the whole record."""
    blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)
    if set(blob["params"]) != set(params):
        raise ValueError(f"{path}: its parameters do not match the net's")
    with torch.no_grad():
        for name, p in params.items():
            src = blob["params"][name]
            if src.shape != p.shape:
                raise ValueError(f"param {name}: checkpoint shape "
                                 f"{tuple(src.shape)} != model shape "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
    return blob


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a :func:`save_checkpoint` directory into ``state`` (the net's
    parameters written in place, the moments onto their devices)."""
    blob = _load_params(path, state.params)
    if (blob["ema"] is None) != (state.opt_state.ema is None):
        raise ValueError(f"{path}: saved with ema "
                         f"{blob['ema'] is not None}, resumed with "
                         f"{state.opt_state.ema is not None}")
    dev = lambda ts: None if ts is None else [
        t.to(p.device) for t, p in zip(ts, state.params.values())]
    state.opt_state = OptState(int(blob["count"]), dev(blob["mu"]),
                               dev(blob["nu"]), dev(blob["ema"]))
    state.step = int(blob["step"])
    return state


def load_checkpoint_params(path: str, model: nn.Module) -> nn.Module:
    """Only the parameters of a :func:`save_checkpoint` directory, into
    ``model`` (``--init-from``)."""
    _load_params(path, dict(model.named_parameters()))
    return model


def save_params_npz(path: str, params: Dict[str, torch.Tensor]) -> None:
    """The zoo's params-only export: each parameter under its flax path,
    in flax's layout, rounded to bf16 and stored as its ``uint16`` bit
    pattern (numpy's npz has no bf16); ``weights.read_params_npz`` and
    the JAX package's ``load_params_npz`` read it."""
    arrays = {}
    for name, t in params.items():
        bits = t.detach().to(device="cpu", dtype=torch.float32).to(
            torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        arrays[weights.flax_key(name)] = weights.to_flax_layout(name, bits)
    np.savez_compressed(path, **arrays)


def load_params_npz(path: str, model: nn.Module) -> nn.Module:
    """A ``*.params.npz`` export into ``model``'s parameters."""
    return weights.load_params(model, weights.read_params_npz(path))
