"""Training CLI: ``python -m panodepth_torch.train_cli <model> rgb/ gt/
ckpt/ [options]``.

Counterpart of ``panodepth/train_cli.py``: every family
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
procedural scenes.)

Data parallel over processes (``parallel/multihost.py``): run one process
per rank with ``--coordinator HOST:PORT --num-processes N --process-id
i``.  ``--batch-size`` is the global batch, each rank loads its ``1/N``
(files split round-robin after the holdout, scenes from seeds of its
own), the gradients of the global batch's loss are summed over the ranks
(``models/train.shard_train_step``), and the state is replicated from
rank 0; only rank 0 logs, writes the sidecar, ``--metrics-out``, the
trace and the checkpoints, which every rank reaches together (their
digests checked equal).  A SIGTERM or SIGINT on any rank drains the run:
the rank announces a stop step through the store, every rank steps
through it, and all checkpoint under its tag and exit 0.
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

# the flags of a multi-process run, which come together
_MULTIPROCESS = ("coordinator", "num_processes", "process_id")
PREEMPT_KEY = "panodepth/preempt-stop"


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
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process data parallel: the store's address "
                        "(rank 0 serves it); run one process per rank with "
                        "--num-processes and --process-id.  --batch-size is "
                        "the global batch; each rank loads its slice, and "
                        "the gradients are summed over the ranks (nccl with "
                        "a card a rank, else gloo; parallel/multihost.py)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def _refusal(args):
    given = [n for n in _MULTIPROCESS if getattr(args, n) is not None]
    if given and len(given) < len(_MULTIPROCESS):
        flag = lambda n: "--" + n.replace("_", "-")
        return (f"{', '.join(flag(n) for n in given)} given without "
                f"{', '.join(flag(n) for n in _MULTIPROCESS if n not in given)}"
                f": a multi-process run takes --coordinator, "
                f"--num-processes and --process-id together")
    if given and not 0 <= args.process_id < args.num_processes:
        return (f"--process-id {args.process_id} outside [0, "
                f"{args.num_processes})")
    if given and args.batch_size % args.num_processes:
        return (f"--batch-size {args.batch_size} must be divisible by the "
                f"process count ({args.num_processes}): --batch-size is the "
                f"global batch, split over the ranks")
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


def _holdout(args, pairs, log, batch_size):
    """(training pairs, validation pairs or None, holdout): every 10th pair
    held out with --eval-every, or where the sidecar of the run being
    resumed says so (the split is sticky: a later run without
    --eval-every must not train on the held-out pairs); the validation
    list padded by repetition to at least one batch of ``batch_size`` (a
    rank's)."""
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
    while len(val_pairs) < batch_size:
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
    from .parallel import multihost as mh
    from .parallel.mesh import make_mesh
    from .pipeline import resolve_device, true_f32

    pidx, pcnt = 0, 1
    if args.coordinator is not None:
        # before the device is used: the rank's device comes with its rank
        pidx, pcnt = mh.initialize(args.coordinator, args.num_processes,
                                   args.process_id, device=args.device)
        dev = mh.device()
    else:
        dev = resolve_device(args.device)
    proc0 = pidx == 0
    log = print if proc0 else (lambda *a, **k: None)
    bs = args.batch_size // pcnt  # this rank's rows of the global batch

    pairs = val_pairs = None
    holdout = False
    if args.synth:
        procs = "1 process" if pcnt == 1 else f"{pcnt} processes"
        log(f"[train] on-device synthetic scenes, {procs}, device {dev}")
    else:
        pairs = pdata.discover_pairs(args.rgb_folder, args.gt_folder,
                                     args.dataset)
        if not pairs:
            raise SystemExit("no (rgb, gt) pairs found")
        # the holdout is taken before the split over the ranks, so it is
        # the same on every rank
        pairs, val_pairs, holdout = _holdout(args, pairs, log, bs)
        if pcnt > 1:
            pairs = mh.process_shard(pairs, pidx, pcnt)
            if not pairs:
                raise SystemExit(f"process {pidx}: no pairs after the split "
                                 f"over {pcnt} processes")
        log(f"[train] {len(pairs)} pairs/host, {pcnt} process(es), device "
            f"{dev}")

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
            # every rank restores the same state from the shared folder
            state = ptrain.restore_checkpoint(latest, state)
            start_step = state.step
            log(f"[train] resumed {latest} at step {start_step}")

    mesh = None
    if pcnt > 1:
        mesh = make_mesh()
        # rank 0's state on every rank: they start equal
        state = mh.replicate(mesh, state)

    def make_batches(seed, src=None, augment=None, corrupt=None):
        return batch_stream(
            batch_kind, seed, bs, dev, pairs=None if args.synth else (
                pairs if src is None else src),
            view_size=args.view_size, pano_width=args.pano_width,
            synth_version=args.synth_version,
            augment=args.augment if augment is None else augment,
            corrupt=args.corrupt if corrupt is None else corrupt,
            corrupt_prob=args.corrupt_prob)

    # each rank draws a stream of its own; a resume offsets the seed, so
    # that the continued run draws a fresh stream instead of replaying the
    # batches already consumed
    source, batches = make_batches(args.seed + pidx * 9973
                                   + start_step * 131)

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
    if mesh is not None:
        step_fn = ptrain.shard_train_step(step_fn, mesh)

    if proc0:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        # the sidecar first, so that every checkpoint, an intermediate one
        # left by a crash included, can be rebuilt
        with open(os.path.join(args.ckpt_dir, f"{args.model}.config.json"),
                  "w") as fp:
            json.dump(arch, fp)

    def checkpoint(tag):
        """Every rank calls it: the state's host copy (its digest checked
        equal over the ranks), written by rank 0, then a barrier, so that
        no rank runs ahead of the write."""
        host = state
        if pcnt > 1:
            host = mh.fetch_replicated(state)
            log(f"[train] checkpoint {tag}: the state agrees over the "
                f"{pcnt} processes (digest)", flush=True)
        if proc0:
            ptrain.save_checkpoint(f"{ckpt_path}_{tag}", host)
            if tag == "final":
                ptrain.save_params_npz(f"{ckpt_path}_final.params.npz",
                                       host.params)
                if args.ema is not None:
                    ptrain.save_params_npz(
                        f"{ckpt_path}_final.ema.params.npz",
                        ptrain.ema_params(host))
        mh.barrier(f"checkpoint-{tag}")

    mout = open(args.metrics_out, "a") if (proc0 and args.metrics_out) \
        else None

    def emit(rec):
        if mout is not None:
            mout.write(json.dumps(rec) + "\n")
            mout.flush()

    # held-out validation: a fixed batch set from a seed stream disjoint
    # from training's (on files, from the held-out pairs, neither augmented
    # nor corrupted), drawn once and re-scored in place; each rank draws
    # its own rows of the global eval batches
    run_eval = None
    if args.eval_every:
        import itertools

        src, stream = make_batches(args.seed + 999_331 + pidx * 7919,
                                   src=val_pairs, augment=False,
                                   corrupt=False)
        eval_data = [to_device(b, dev) for b in
                     itertools.islice(stream, args.eval_batches)]
        src.close()
        reduce = None if mesh is None else mesh.all_reduce

        def run_eval(params):
            """The mean depth loss over the eval set with ``params`` (by
            name) in the net, its own parameters restored after."""
            own = {k: v.detach().clone() for k, v in state.params.items()}
            total = 0.0
            with torch.no_grad(), true_f32():
                for k, v in state.params.items():
                    v.copy_(params[k])
                for rgb, depth, mask in eval_data:
                    loss = ptrain.depth_loss(model(rgb), depth, mask,
                                             reduce=reduce)
                    if reduce is not None:  # the ranks' parts
                        loss = reduce(loss, "sum")
                    total += float(loss)
                for k, v in state.params.items():
                    v.copy_(own[k])
            return total / len(eval_data)

    trace = (debug.Trace(args.trace, "train", cuda=dev.type == "cuda")
             if args.trace and proc0 else None)
    # Preemption.  SIGTERM / SIGINT set a flag; one process checkpoints the
    # step it finished and exits 0.  Several: every step is a collective,
    # so a rank that left alone would hang the others in the next one.
    # The signalled rank announces a stop step through the store (the
    # first writer wins), every rank polls it before each step and steps
    # through it, then all checkpoint together.  The loss read back after
    # each step keeps the ranks within a step of each other, so that
    # ``caught_step + 2`` is a step no rank has passed when it polls.
    caught = {}

    def _on_signal(signum, frame):
        caught["sig"] = signal.Signals(signum).name

    prev = {s: signal.signal(s, _on_signal)
            for s in (signal.SIGTERM, signal.SIGINT)}
    interrupted = False
    stop_at = None
    t0 = time.monotonic()
    try:
        for step, batch in enumerate(batches, start=start_step):
            if step >= args.steps:
                break
            if pcnt > 1 and stop_at is None:
                v = mh.kv_try_get(PREEMPT_KEY)
                if v is not None:
                    stop_at = int(v)
            if stop_at is not None and step > stop_at:
                interrupted = True
                break
            if trace is not None and step == start_step + 2:
                # skip the first step and one warm step, then trace three
                trace.start()
            with debug.where(f"train step {step}"):
                state, metrics = step_fn(state, to_device(batch, dev))
            if pcnt > 1:
                # the step sync: no rank starts step k + 1 before every
                # rank's step k is done (the drain's bound on the skew)
                metrics["loss"].item()
            if trace is not None and trace.running and \
                    step == start_step + 4:
                log(f"[train] profiler trace written to {trace.stop()}")
            if step % args.log_every == 0:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                rate = ((step + 1 - start_step) * args.batch_size
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
                if pcnt == 1:
                    interrupted = True
                    checkpoint(str(step))
                    log(f"[train] {caught['sig']}: checkpointed at step "
                        f"{step + 1}; restart with --resume to continue",
                        flush=True)
                    break
                if stop_at is None:
                    mh.kv_set_once(PREEMPT_KEY, str(step + 2))
                    # another rank's announcement may have come first
                    stop_at = int(mh.kv_try_get(PREEMPT_KEY))
                    print(f"[train] p{pidx}: {caught['sig']}: draining to "
                          f"collectively agreed step {stop_at}", flush=True)
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
    elif pcnt > 1:
        # every rank stepped through stop_at: one checkpoint together
        checkpoint(str(stop_at))
        log(f"[train] preempted: collective checkpoint at step "
            f"{stop_at + 1}; restart every process with --resume",
            flush=True)
    if mh.initialized():
        # rank 0 may still be writing when another rank's loop ends
        mh.barrier("train-done")
        mh.shutdown()
    if not interrupted:
        log(f"[train] done; checkpoint at {ckpt_path}_final "
            f"(+ params-only {ckpt_path}_final.params.npz)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
