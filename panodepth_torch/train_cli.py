"""Training CLI: ``python -m panodepth_torch.train_cli <model> rgb/ gt/
ckpt/ [options]``.

Counterpart of ``panodepth/train_cli.py`` on one device: every family
(``perspective`` GN or NF, ``panoramic`` GN or NF, ``hohonet``,
``bifuse``, ``slicenet``, ``fastpano``) at the JAX widths
(``--width-scale``), the step of ``models/train.py`` (AdamW with warmup
and cosine decay, ``--ema``, ``--remat``, distillation from a teacher
checkpoint, ``--distill-from``, whose GroupNorms run the CUDA kernel under
``no_grad``), held-out validation (``--eval-every``), checkpoints
``<ckpt_dir>/<model>_<tag>`` with ``--resume`` from the newest,
``<model>_final.params.npz`` (the zoo's format, which both packages load)
and the architecture sidecar ``<model>.config.json``.  SIGTERM / SIGINT
checkpoint the current step and exit 0.

The data: a dataset in the reference's folder layout (``rgb/`` and
``gt/`` under ``--dataset``'s naming, ``models/data.py``: decoded on host
threads, copied to the device from pinned memory), with ``--augment``; or,
with ``--synth``, procedural scenes rendered on the device
(``synth.synth_batches``).  On files, ``--eval-every`` holds out every
10th pair for validation, and the split stays with the run
(``eval_holdout`` in the sidecar) across ``--resume``.  ``--corrupt``
degrades the RGB on the device (``ops/corrupt.py``, its probabilities
scaled by ``--corrupt-prob``); ``--trace DIR`` writes a ``torch.profiler``
trace of three steady-state steps; ``--debug-nans`` raises
FloatingPointError on the first NaN in a step's loss, gradients or
parameters.

The zoo's FastPanoNet recipe on the card::

    python -m panodepth_torch.train_cli fastpano rgb gt ckpt \\
        --batch-size 16 --lr 3e-4 --pano-width 512 --augment --corrupt \\
        --distill-from zoo/panoramic_final.params.npz --distill-weight 0.5

(``--synth --synth-version mix`` in place of the folders trains on
procedural scenes.)  The multi-process flags are refused with the ROADMAP
item that brings them.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import time

FAMILIES = ("perspective", "panoramic", "hohonet", "bifuse", "slicenet",
            "fastpano")

# JAX flags that come with later work: parsed, so that passing one is
# refused with where it stands instead of being taken for something else
_NOT_PORTED = {
    "coordinator": "--coordinator (multi-process data parallel; ROADMAP "
                   "Queue 1 item 4)",
    "num_processes": "--num-processes (multi-process data parallel; "
                     "ROADMAP Queue 1 item 4)",
    "process_id": "--process-id (multi-process data parallel; ROADMAP "
                  "Queue 1 item 4)",
}


def build_parser():
    p = argparse.ArgumentParser(prog="panodepth_torch.train_cli")
    p.add_argument("model", choices=FAMILIES)
    p.add_argument("rgb_folder", help="RGB panoramas (unused with --synth)")
    p.add_argument("gt_folder", help="gt depth panoramas, named after the "
                                     "RGB by --dataset (unused with --synth)")
    p.add_argument("ckpt_dir")
    p.add_argument("--dataset", default="matterport")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--view-size", type=int, default=256)
    p.add_argument("--pano-width", type=int, default=512)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--width-scale", type=float, default=1.0,
                   help="scale model widths (quick experiments)")
    p.add_argument("--variant", default="gn", choices=["gn", "nf"],
                   help="perspective / panoramic variant: gn = GroupNorm, "
                        "nf = normalizer-free (weight-standardized convs)")
    p.add_argument("--synth", action="store_true",
                   help="train on procedural scenes rendered on the device "
                        "(rgb/gt folders are ignored; panodepth_torch.synth)")
    p.add_argument("--synth-version", default="v1",
                   choices=["v1", "v2", "mix"],
                   help="scene distribution for --synth (v2 adds L-rooms, "
                        "corridors, cylinders, point lights; mix = 35%% "
                        "v1 / 65%% v2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init-from", default=None,
                   help="initialize params from a checkpoint (a "
                        ".params.npz or a <model>_<tag> state directory); "
                        "optimizer state starts fresh")
    p.add_argument("--distill-from", default=None, metavar="CKPT",
                   help="distillation teacher checkpoint (a .params.npz of "
                        "any family with the same input kind): the loss "
                        "adds --distill-weight x the depth loss against the "
                        "teacher's prediction on each batch")
    p.add_argument("--distill-weight", type=float, default=0.5)
    p.add_argument("--eval-every", type=int, default=0, metavar="N",
                   help="every N steps, score a fixed held-out batch set "
                        "(drawn once from a disjoint seed) and log "
                        "val_loss; with --ema the EMA weights too")
    p.add_argument("--eval-batches", type=int, default=2,
                   help="number of held-out batches for --eval-every")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="append one JSON line per logged step / eval")
    p.add_argument("--ema", type=float, default=None, metavar="DECAY",
                   help="track an exponential moving average of the params "
                        "(e.g. 0.999); the final checkpoint also writes "
                        "<model>_final.ema.params.npz")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in ckpt_dir "
                        "(params, optimizer moments, step)")
    p.add_argument("--remat", action="store_true",
                   help="recompute activations in the backward pass "
                        "(torch.utils.checkpoint): ~1 extra forward per "
                        "step for a much smaller activation footprint")
    p.add_argument("--augment", action="store_true",
                   help="geometry-correct augmentation of file batches: "
                        "horizontal flips and a photometric gain, and "
                        "azimuth rolls of panoramic batches (--synth scenes "
                        "are unlimited and skip it)")
    p.add_argument("--corrupt", action="store_true",
                   help="camera-pipeline corruption of the RGB on the device "
                        "(JPEG artifacts, sensor noise, exposure; "
                        "ops/corrupt.py), the targets untouched; the input "
                        "size must be a multiple of 16")
    p.add_argument("--corrupt-prob", type=float, default=1.0, metavar="S",
                   help="with --corrupt: scale the stages' probabilities "
                        "(p_jpeg, p_noise, p_photo) by S")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of three steady-state "
                        "steps (the third to the fifth) into DIR as a Chrome "
                        "trace")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError on the first NaN in a "
                        "step's parameters, loss or gradients, naming it and "
                        "the step (autograd's anomaly detection on)")
    late = p.add_argument_group("not ported yet (refused)")
    for name in _NOT_PORTED:
        late.add_argument("--" + name.replace("_", "-"), default=None)
    return p


def _refusal(args):
    for name, what in _NOT_PORTED.items():
        if getattr(args, name) is not None:
            return f"{what} is not ported yet"
    if args.variant != "gn" and args.model not in ("perspective",
                                                   "panoramic"):
        return "--variant nf is a perspective/panoramic option"
    if args.resume and args.init_from:
        return ("--resume and --init-from are exclusive: resume restores "
                "params AND optimizer state")
    return None


def _latest_checkpoint(ckpt_path: str):
    """Newest full-state checkpoint directory ``<ckpt_path>_<tag>``, ranked
    by save time (mtime), the numeric tag breaking ties (``final`` last),
    as the JAX CLI ranks them: ranking ``final`` first would roll an
    extended run back to the previous run's end."""
    best = None
    for p in glob.glob(ckpt_path + "_*"):
        tag = p[len(ckpt_path) + 1:]
        if not os.path.isdir(p) or not (tag == "final" or tag.isdigit()):
            continue
        rank = (os.path.getmtime(p),
                float("inf") if tag == "final" else int(tag))
        if best is None or rank > best[0]:
            best = (rank, p)
    return None if best is None else best[1]


def batch_stream(kind: str, seed: int, batch_size: int, device, pairs=None,
                 view_size: int = 256, pano_width: int = 512,
                 synth_version="v1", augment: bool = False,
                 corrupt: bool = False, corrupt_prob: float = 1.0):
    """(source, stream) of (rgb, depth, valid) batches of ``kind`` (``pano``
    or ``perspective``) from ``seed``: file batches of ``pairs`` (host
    numpy, decoded on threads, ``augment``-ed; ``models/data.py``), or
    without ``pairs`` scenes rendered on ``device``.  With ``corrupt`` the
    stream's RGB is corrupted on ``device`` (``ops/corrupt.py``, the
    stages' probabilities scaled by ``corrupt_prob``); ``source`` is the
    stream before that, for closing.  JAX's ``make_batches``."""
    from . import synth
    from .models import data as pdata

    if pairs is None:
        batches = synth.synth_batches(
            batch_size, kind=kind, view_size=view_size,
            pano_width=pano_width, seed=seed, version=synth_version,
            device=device)
    elif kind == "perspective":
        batches = pdata.perspective_batches(pairs, batch_size,
                                            view_size=view_size, seed=seed,
                                            augment=augment)
    else:
        batches = pdata.pano_batches(pairs, batch_size, width=pano_width,
                                     seed=seed, augment=augment)
    if not corrupt:
        return batches, batches
    from .ops import corrupt as pcorrupt

    c = pcorrupt.CorruptConfig()
    ccfg = c._replace(p_jpeg=min(1.0, c.p_jpeg * corrupt_prob),
                      p_noise=min(1.0, c.p_noise * corrupt_prob),
                      p_photo=min(1.0, c.p_photo * corrupt_prob))
    return batches, pcorrupt.corrupt_batches(batches, seed, ccfg,
                                             device=device)


def to_device(batch, device):
    """A batch's arrays as tensors on ``device``: host arrays through pinned
    memory, without blocking."""
    import torch

    from .ops.corrupt import on_device

    out = []
    for a in batch:
        t = torch.as_tensor(a)
        if not on_device(t, device):
            if device.type == "cuda":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def _holdout(args, pairs, log):
    """(training pairs, validation pairs or None, holdout): every 10th pair
    held out with --eval-every, or where the sidecar of the run being
    resumed says so (the split is sticky: a later run without
    --eval-every must not train on the held-out pairs); the validation
    list padded by repetition to at least one batch."""
    holdout = bool(args.eval_every)
    sidecar = os.path.join(args.ckpt_dir, f"{args.model}.config.json")
    if not holdout and os.path.exists(sidecar):
        try:
            with open(sidecar) as fp:
                holdout = bool(json.load(fp).get("eval_holdout"))
        except (OSError, ValueError):
            pass
        if holdout:
            log("[train] maintaining the validation holdout recorded by the "
                "original run (sidecar eval_holdout)")
    if not holdout:
        return pairs, None, False
    val_pairs = pairs[::10]
    pairs = [p for i, p in enumerate(pairs) if i % 10]
    if not pairs:
        raise SystemExit("dataset too small to hold out a validation split "
                         "(--eval-every)")
    log(f"[train] holding out {len(val_pairs)} pairs for --eval-every "
        f"validation")
    while len(val_pairs) < args.batch_size:
        val_pairs = val_pairs * 2
    return pairs, val_pairs, True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refusal = _refusal(args)
    if refusal:
        raise SystemExit(f"panodepth_torch.train_cli: {refusal}")
    import torch

    from . import debug

    if args.debug_nans:
        print("[debug-nans] each step's parameters, loss and gradients are "
              "checked for NaN; autograd's anomaly detection is on")
    with debug.nan_checks(args.debug_nans), \
            torch.autograd.set_detect_anomaly(args.debug_nans):
        return _train(args)


def _train(args) -> int:
    import torch

    from . import debug
    from .models import data as pdata
    from .models import layers, train as ptrain, weights
    from .pipeline import resolve_device, true_f32

    dev = resolve_device(args.device)
    log = print
    bs = args.batch_size

    pairs = val_pairs = None
    holdout = False
    if args.synth:
        log(f"[train] on-device synthetic scenes, 1 process, device {dev}")
    else:
        pairs = pdata.discover_pairs(args.rgb_folder, args.gt_folder,
                                     args.dataset)
        if not pairs:
            raise SystemExit("no (rgb, gt) pairs found")
        pairs, val_pairs, holdout = _holdout(args, pairs, log)
        log(f"[train] {len(pairs)} pairs/host, 1 process(es), device {dev}")

    batch_kind = "perspective" if args.model == "perspective" else "pano"
    if args.corrupt:
        sz = args.view_size if batch_kind == "perspective" \
            else args.pano_width
        if sz % 16:
            raise SystemExit(f"--corrupt needs the input size to be a "
                             f"multiple of 16 (JPEG 4:2:0 MCU), got {sz}")

    # the architecture sidecar (weights.build_model reads it)
    arch = dict(model=args.model, width_scale=args.width_scale,
                view_size=args.view_size, pano_width=args.pano_width,
                eval_holdout=holdout, variant=args.variant)
    # flax's initializers from a fixed generator, as JAX's init_state draws
    # from PRNGKey(0); hohonet/slicenet fix their height to --pano-width
    model = weights.build_model(arch)
    layers.init_params(model, torch.Generator().manual_seed(0))
    model = model.to(dev).train()

    ckpt_path = os.path.abspath(os.path.join(args.ckpt_dir, args.model))
    tx = ptrain.make_optimizer(lr=args.lr, steps=args.steps, ema=args.ema)
    start_step = 0
    if args.init_from:
        if args.init_from.endswith(".npz"):
            ptrain.load_params_npz(args.init_from, model)
        else:
            ptrain.load_checkpoint_params(os.path.abspath(args.init_from),
                                          model)
        log(f"[train] params initialized from {args.init_from}")
    state = ptrain.init_state(model, tx)
    if args.resume:
        latest = _latest_checkpoint(ckpt_path)
        if latest is None:
            log(f"[train] --resume: no checkpoint under {ckpt_path}_*, "
                "starting fresh")
        else:
            state = ptrain.restore_checkpoint(latest, state)
            start_step = state.step
            log(f"[train] resumed {latest} at step {start_step}")

    def make_batches(seed, src=None, augment=None, corrupt=None):
        return batch_stream(
            batch_kind, seed, bs, dev, pairs=None if args.synth else (
                pairs if src is None else src),
            view_size=args.view_size, pano_width=args.pano_width,
            synth_version=args.synth_version,
            augment=args.augment if augment is None else augment,
            corrupt=args.corrupt if corrupt is None else corrupt,
            corrupt_prob=args.corrupt_prob)

    # a resume offsets the seed: the continued run draws a fresh stream
    # instead of replaying the batches already consumed
    source, batches = make_batches(args.seed + start_step * 131)

    teacher_fn = None
    if args.distill_from:
        from .e2e import load_model_checkpoint

        t_model, t_arch = load_model_checkpoint(args.distill_from,
                                                device=dev)
        t_kind = ("perspective" if t_arch["model"] == "perspective"
                  else "pano")
        if t_kind != batch_kind:
            raise SystemExit(
                f"--distill-from: teacher family {t_arch['model']} takes "
                f"{t_kind} batches but {args.model} trains on {batch_kind}")
        if t_kind == "perspective":
            from .models.perspective import predict_depth01

            teacher_fn = lambda rgb: predict_depth01(t_model, rgb)
        else:
            teacher_fn = t_model
        log(f"[train] distilling from {args.distill_from} "
            f"(weight {args.distill_weight})")

    step_fn = ptrain.make_train_step(model, tx, remat=args.remat,
                                     teacher_fn=teacher_fn,
                                     distill_weight=args.distill_weight)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    # the sidecar first, so that every checkpoint, an intermediate one left
    # by a crash included, can be rebuilt
    with open(os.path.join(args.ckpt_dir, f"{args.model}.config.json"),
              "w") as fp:
        json.dump(arch, fp)

    def checkpoint(tag):
        ptrain.save_checkpoint(f"{ckpt_path}_{tag}", state)
        if tag == "final":
            ptrain.save_params_npz(f"{ckpt_path}_final.params.npz",
                                   state.params)
            if args.ema is not None:
                ptrain.save_params_npz(f"{ckpt_path}_final.ema.params.npz",
                                       ptrain.ema_params(state))

    mout = open(args.metrics_out, "a") if args.metrics_out else None

    def emit(rec):
        if mout is not None:
            mout.write(json.dumps(rec) + "\n")
            mout.flush()

    # held-out validation: a fixed batch set from a seed stream disjoint
    # from training's (on files, from the held-out pairs, neither augmented
    # nor corrupted), drawn once and re-scored in place
    run_eval = None
    if args.eval_every:
        import itertools

        src, stream = make_batches(args.seed + 999_331, src=val_pairs,
                                   augment=False, corrupt=False)
        eval_data = [to_device(b, dev) for b in
                     itertools.islice(stream, args.eval_batches)]
        src.close()

        def run_eval(params):
            """The mean depth loss over the eval set with ``params`` (by
            name) in the net, its own parameters restored after."""
            own = {k: v.detach().clone() for k, v in state.params.items()}
            total = 0.0
            with torch.no_grad(), true_f32():
                for k, v in state.params.items():
                    v.copy_(params[k])
                for rgb, depth, mask in eval_data:
                    total += float(ptrain.depth_loss(model(rgb), depth, mask))
                for k, v in state.params.items():
                    v.copy_(own[k])
            return total / len(eval_data)

    trace = (debug.Trace(args.trace, "train", cuda=dev.type == "cuda")
             if args.trace else None)
    caught = {}

    def _on_signal(signum, frame):
        caught["sig"] = signal.Signals(signum).name

    prev = {s: signal.signal(s, _on_signal)
            for s in (signal.SIGTERM, signal.SIGINT)}
    interrupted = False
    t0 = time.monotonic()
    try:
        for step, batch in enumerate(batches, start=start_step):
            if step >= args.steps:
                break
            if trace is not None and step == start_step + 2:
                # skip the first step and one warm step, then trace three
                trace.start()
            with debug.where(f"train step {step}"):
                state, metrics = step_fn(state, to_device(batch, dev))
            if trace is not None and trace.running and \
                    step == start_step + 4:
                log(f"[train] profiler trace written to {trace.stop()}")
            if step % args.log_every == 0:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                rate = ((step + 1 - start_step) * bs
                        / (time.monotonic() - t0))
                log(f"[train] step {step} loss {loss:.4f} |g| {gn:.3f} "
                    f"({rate:.1f} img/s)", flush=True)
                emit(dict(step=step, loss=loss, grad_norm=gn,
                          img_per_sec=round(rate, 2)))
            if run_eval is not None and (step + 1) % args.eval_every == 0:
                rec = dict(step=step, val_loss=run_eval(state.params))
                if args.ema is not None:
                    rec["val_loss_ema"] = run_eval(ptrain.ema_params(state))
                log(f"[train] step {step} val {rec['val_loss']:.4f}"
                    + (f" (ema {rec['val_loss_ema']:.4f})"
                       if args.ema is not None else ""), flush=True)
                emit(rec)
            if caught:
                interrupted = True
                checkpoint(str(step))
                log(f"[train] {caught['sig']}: checkpointed at step "
                    f"{step + 1}; restart with --resume to continue",
                    flush=True)
                break
            if step and step % args.ckpt_every == 0:
                checkpoint(str(step))
    except BaseException:
        if trace is not None and trace.running:
            log(f"[train] profiler trace written to {trace.stop()} (the run "
                f"failed)")
        raise
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        batches.close()
        source.close()
        if mout is not None:
            mout.close()
    if trace is not None:
        if trace.running:  # the loop ended before the last traced step
            log(f"[train] profiler trace written to {trace.stop()} (short "
                f"run: fewer steady-state steps than planned)")
        elif args.steps - start_step <= 2:
            log(f"[train] --trace wrote nothing: tracing starts at step "
                f"{start_step + 2} and this run ended before it (needs at "
                f"least 3 steps)")
    if not interrupted:
        checkpoint("final")
        log(f"[train] done; checkpoint at {ckpt_path}_final "
            f"(+ params-only {ckpt_path}_final.params.npz)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
