#!/usr/bin/env python3
"""A/B of the port's CUDA kernels against an earlier form, on one card.

    python3 scripts/torch_kernel_ab.py [--old-tree DIR] [--sweep] [--sass]

``DIR`` holds an earlier checkout of the repo, or at least its
``panodepth_torch/kernels/`` and ``panodepth_torch/csrc/`` (for example
``git archive <commit> panodepth_torch | tar -x -C DIR``).  Its kernels are
called through that checkout's own wrappers (``cuda_jacobi``,
``cuda_group_norm`` and ``cuda_qconv``, whose signatures the port keeps),
which build its sources with its own flags into ``DIR``, so the script
depends on no earlier C interface.  It times, in turns old, new, new, old:

- the Jacobi, per level of the 2048-wide plan at the plan's coverage:
  CUDA events around one level (median of 9) and the kernels' device time
  under torch.profiler, with the outputs of both forms held bit-equal to
  each other and to the plain version, and the launches each wrapper
  counted;
- the GroupNorm, per FastPanoNet forward: its 29 calls on the inputs the
  zoo net gives them at 256x512 (the inputs of ``chip_smoke.py``'s phase
  groupnorm), device time under torch.profiler over 5 forwards;
- the int8 conv (``cuda_qconv``), on the 39 calls of one forward of the
  zoo GN perspective net's int8 graph on the 15 views of a panorama (the
  inputs of ``chip_smoke.py``'s int8 hold): each distinct shape and the 39
  as a set, each from a CUDA graph between CUDA events, the outputs of
  both forms bit-equal;
- the activation's quantization ahead of those 39 convs
  (``cuda_quantize_nhwc``): each distinct shape and the 39 as a set from
  CUDA graphs, codes and scales of both forms bit-equal to each other and
  to the plain pass (``quantize_nhwc_plain``, timed once beside them).

``--sweep`` times other Jacobi launch plans at each level, other
GroupNorm cluster sizes at each FastPanoNet shape (device time under the
profiler, through ``run_plan``), other qconv plans (tile width, ring
depth, split of K) at each int8 conv shape and other quantization plans
(blocks an SM, images a wave; ``run_quantize_plan``) at each of its
shapes, the evidence behind the four plan functions.  ``--kernels`` picks
which of ``jacobi,groupnorm,qconv,quantize`` to time (all by default).  ``--sass`` prints each kernel's SASS opcode counts
(``cuobjdump`` beside nvcc).  It needs one CUDA card and nvcc; it prints
the card's name and power limit and, last, one JSON line of the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (its scene, feed and profiler helpers)

# candidate Jacobi plans (cols, rows, warps, halo) for --sweep
SWEEP = ((2, 4, 16, 16), (2, 4, 8, 8), (2, 4, 16, 12), (2, 4, 16, 20),
         (2, 4, 32, 12), (2, 4, 32, 16), (2, 4, 32, 20), (4, 4, 16, 16),
         (4, 4, 32, 12), (4, 4, 32, 16), (4, 4, 32, 20))


def load_old_kernels(tree):
    """The wrapper modules (jacobi, groupnorm, and qconv where the
    checkout has it) of the earlier checkout at ``tree``, imported as a
    package of their own beside the port's."""
    import importlib
    import importlib.util

    pkg_dir = os.path.join(tree, "panodepth_torch", "kernels")
    name = "_old_panodepth_torch_kernels"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    has_qconv = os.path.isfile(os.path.join(pkg_dir, "qconv.py"))
    return (importlib.import_module(f"{name}.jacobi"),
            importlib.import_module(f"{name}.groupnorm"),
            importlib.import_module(f"{name}.qconv") if has_qconv else None)


def launches_of(module, counter, fn):
    """Kernel launches that ``module``'s wrapper counted in ``counter`` for
    one ``fn()``."""
    before = getattr(module, counter)
    fn()
    return getattr(module, counter) - before


def launches(module, fn):
    """Kernel launches that ``module``'s wrapper counted for one ``fn()``."""
    return launches_of(module, "LAUNCHES", fn)


def device_ms(fn, repeat):
    """Device time per call of ``fn`` under torch.profiler."""
    busy, _ = chip_smoke._device_profile(lambda: [fn() for _ in range(repeat)])
    return busy / repeat


def in_turns(forms, timer, rounds):
    """{form: [times]}: ``timer(fn)`` of each form in turns old, new, new,
    old (new alone without an old form)."""
    order = ("old", "new", "new", "old") if "old" in forms else ("new",)
    turns = [(name, timer(forms[name])) for _ in range(rounds)
             for name in order]
    return {n: [t for m, t in turns if m == n] for n in forms}


def jacobi_ab(old_kj, cfg, rounds, sweep):
    from panodepth_torch.fusion import build_fusion_plan
    from panodepth_torch.kernels import jacobi as kj

    rng = np.random.RandomState(chip_smoke.SEED)
    step, reg = cfg.jacobi_step, cfg.jacobi_reg
    mods = dict(new=kj, **({"old": old_kj} if old_kj else {}))
    levels = []
    for lvl in build_fusion_plan(cfg).levels:
        h, w, it = lvl.height, lvl.width, lvl.iterations
        buf = torch.tensor(rng.rand(h, w).astype(np.float32), device="cuda")
        tgt = torch.tensor(rng.normal(0, 0.01, (h, w)).astype(np.float32),
                           device="cuda")
        cov = torch.tensor(lvl.inv_cov > 0, device="cuda")
        forms = {name: (lambda m=m: m.cuda_jacobi(buf, tgt, cov, it, step,
                                                  reg))
                 for name, m in mods.items()}
        want = kj.jacobi_plain(buf, tgt, cov, it, step, reg)
        for name, fn in forms.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} jacobi not bit-equal at {w}x{h}")
        row = dict(shape=f"{w}x{h}", iterations=it,
                   launches={name: launches(mods[name], fn)
                             for name, fn in forms.items()})
        row["events_ms"] = in_turns(
            forms, lambda f: chip_smoke._median_ms(f, 9, 2), rounds)
        row["device_ms"] = in_turns(forms, lambda f: device_ms(f, 5), rounds)
        print(f"jacobi {w}x{h} x{it}: launches {row['launches']}; device ms "
              f"(profiler, in turns) {row['device_ms']!r}; CUDA-event ms "
              f"{row['events_ms']!r}")
        if sweep:
            row["sweep"] = []
            for cols, rows_, warps, halo in SWEEP:
                p = kj.JacobiPlan(h, w, it, cols, rows_, warps, min(halo, it))
                run = lambda: kj.run_plan(buf, tgt, cov, step, reg, p)
                if not torch.equal(run(), want):
                    raise AssertionError(f"plan {p} not bit-equal")
                ms = device_ms(run, 3)
                row["sweep"].append(dict(plan=[cols, rows_, warps, halo],
                                         blocks=p.blocks,
                                         launches=p.launches, device_ms=ms))
                print(f"  sweep {w}x{h}: {cols}x{rows_} per thread, {warps} "
                      f"warps, halo {halo}: {p.blocks} blocks, {p.launches} "
                      f"launches, device {ms!r} ms")
        levels.append(row)
    total = {k: {n: float(sum(np.mean(r[k][n]) for r in levels))
                 for n in mods} for k in ("device_ms", "events_ms")}
    print(f"jacobi per panorama (mean of the turns): device ms "
          f"{total['device_ms']!r}; CUDA-event ms {total['events_ms']!r}")
    return dict(levels=levels, total=total)


def group_norm_ab(old_kg, rounds, sweep):
    from panodepth_torch.e2e import load_model_checkpoint
    from panodepth_torch.kernels import groupnorm as kg

    base, _ = load_model_checkpoint(chip_smoke.BASE_CKPT)
    rgb = chip_smoke.make_rgb(chip_smoke.SEED, 2048)
    with torch.no_grad():
        calls = chip_smoke._norm_inputs(base, [rgb])
    mods = dict(new=kg, **({"old": old_kg} if old_kg else {}))
    forms = {name: (lambda g=g: [g.cuda_group_norm(
        x, m.scale, m.bias, m.num_groups, 1e-6, m.fuse_relu, m.dtype)
        for m, x in calls]) for name, g in mods.items()}
    worst = None
    if old_kg:
        worst = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(forms["old"](), forms["new"]()))
    res = in_turns(forms, lambda f: device_ms(f, 5), rounds)
    count = {name: launches(mods[name], fn) for name, fn in forms.items()}
    print(f"groupnorm per FastPanoNet forward ({len(calls)} calls): device "
          f"ms (profiler, 5 forwards a turn, in turns) {res!r}; launches "
          f"{count}; max |old - new| {worst!r}")
    out = dict(device_ms=res, calls=len(calls), launches=count,
               max_abs_old_new=worst)
    if sweep:
        # at batch 1 and at the e2e call's batch 2: plan_for takes the same
        # cluster size at both, so what that costs at batch 2 shows here
        rgb2 = chip_smoke.make_rgb(chip_smoke.SEED + 1, 2048)
        with torch.no_grad():
            calls2 = chip_smoke._norm_inputs(base, [rgb, rgb2])
        out["sweep"] = []
        seen = set()
        for m, x in calls + calls2:
            n, c = x.shape[:2]
            hw = x[0, 0].numel()
            if (n, hw, c, m.num_groups) in seen:
                continue
            seen.add((n, hw, c, m.num_groups))
            best = kg.plan_for(n, c, hw, m.num_groups, x.element_size())
            want = kg.group_norm_plain(x, m.scale, m.bias, m.num_groups,
                                       1e-6, m.fuse_relu, m.dtype)
            for k in (1, 2, 4, 8, 16):
                p = kg.GroupNormPlan(n, c, hw, m.num_groups, x.element_size(),
                                     k, kg.slice_for(best.span, k), True)
                if p.smem_bytes + kg.SMEM_STATIC > kg.SMEM_MAX:
                    continue
                run = lambda: kg.run_plan(x, m.scale, m.bias, 1e-6,
                                          m.fuse_relu, m.dtype, p)
                err = float((run() - want).abs().max())
                ms = device_ms(run, 10)
                out["sweep"].append(dict(shape=[n, hw, c, m.num_groups],
                                         cluster=k, blocks=p.blocks,
                                         device_ms=ms, max_abs_err=err,
                                         chosen=k == best.cluster))
                print(f"  sweep groupnorm (N, HW, C, G)=({n}, {hw}, {c}, "
                      f"{m.num_groups}): clusters of {k}, {p.blocks} blocks: "
                      f"device {ms * 1e3!r} us per call, max abs err vs plain"
                      f" {err!r}{' (plan_for)' if k == best.cluster else ''}")
    return out


def _graph_ms(fn):
    """Device ms of one ``fn()`` replayed from a CUDA graph."""
    return chip_smoke._graph_ms(fn, 5, 3)


def int8_calls():
    """(QConv, input) of the 39 int8 convs of one forward of the zoo GN
    perspective net's int8 graph (15 views of a panorama at 256x256)."""
    from panodepth_torch.e2e import load_model_checkpoint

    dev = torch.device("cuda")
    net, _ = load_model_checkpoint(chip_smoke.GN_PERSP_CKPT, quantize=True)
    rgb = chip_smoke._pano_feed(chip_smoke.make_rgb(chip_smoke.SEED, 2048),
                                dev)[None]
    feed = chip_smoke._family_input("gn_perspective", rgb)
    return chip_smoke._qconv_calls(net, feed)


def qconv_ab(old_kq, calls, rounds, sweep):
    """The int8 convs of one forward (``calls``)."""
    from panodepth_torch.kernels import qconv as kq

    args = [chip_smoke._qconv_args(m, x) for m, x in calls]
    mods = dict(new=kq, **({"old": old_kq} if old_kq else {}))
    shapes, rows = {}, []
    for i, ((m, x), a) in enumerate(zip(calls, args)):
        n, h, w, _ = a[0].shape
        cout, cin, kh, kw = m.kernel_q.shape
        key = (n, h, w, cin, cout, kh, m.strides[0])
        if key not in shapes:
            rows.append((key, i))
        shapes[key] = shapes.get(key, 0) + 1
    out = dict(shapes=[])
    for key, i in rows:
        a = args[i]
        forms = {name: (lambda q=q, a=a: q.cuda_qconv(*a))
                 for name, q in mods.items()}
        want = forms["new"]()
        if old_kq and not torch.equal(forms["old"](), want):
            raise AssertionError(f"qconv {key}: old and new differ")
        plan = kq.qconv_plan(*a[0].shape, a[1].shape[0], *a[5], *a[6], a[7])
        row = dict(shape=key, calls=shapes[key],
                   plan=[plan.bn, plan.stages, plan.splits],
                   graph_ms=in_turns(forms, _graph_ms, rounds))
        print(f"qconv (N, H, W, Cin, Cout, k, stride) {key} x{shapes[key]}, "
              f"plan (bn, stages, splits) {row['plan']}, {plan.blocks} "
              f"blocks: device ms from a CUDA graph, in turns "
              f"{row['graph_ms']!r}")
        if sweep:
            row["sweep"] = []
            want_acc = kq.qconv_sums_plain(*a[:2], *a[5:8])
            for bn in kq.TILE_N:
                for stages in range(kq.MIN_STAGES, kq.MAX_STAGES + 1):
                    for splits in (1, 2, 3, 4, 6, 8, 12, 16):
                        p = kq.QConvPlan(plan.m, plan.cout, plan.ktaps, bn,
                                         stages, splits)
                        if (splits > p.ktiles or p.smem_bytes > kq.SMEM_MAX
                                or (splits > 1 and p.tiles * splits
                                    > 2 * kq.SMS)):
                            continue
                        run = lambda p=p, a=a: kq.run_plan(*a, plan=p)
                        if not torch.equal(run()[1], want_acc):
                            raise AssertionError(f"plan {p} not exact")
                        ms = _graph_ms(run)
                        row["sweep"].append(dict(plan=[bn, stages, splits],
                                                 device_ms=ms))
                        print(f"  sweep {key}: bn {bn}, stages {stages}, "
                              f"splits {splits}: {p.blocks} blocks, "
                              f"{ms!r} ms"
                              + (" (qconv_plan)" if p == plan else ""))
        out["shapes"].append(row)
    sets = {name: (lambda q=q: [q.cuda_qconv(*a) for a in args])
            for name, q in mods.items()}
    out["set_graph_ms"] = in_turns(
        sets, lambda f: chip_smoke._graph_ms(f, reps=1), rounds)
    out["launches"] = {name: launches(mods[name], f)
                       for name, f in sets.items()}
    print(f"qconv, the {len(args)} convs of a forward: device ms from a "
          f"CUDA graph, in turns {out['set_graph_ms']!r}; launches "
          f"{out['launches']}")
    return out


def quantize_ab(old_kq, calls, rounds, sweep):
    """The quantization ahead of the int8 convs of one forward
    (``calls``): the earlier kernel against this one."""
    from panodepth_torch.kernels import qconv as kq

    xs = [x for _, x in calls]
    mods = dict(new=kq, **({"old": old_kq} if old_kq else {}))
    for x in xs:
        want_q, want_sx = kq.quantize_nhwc_plain(x)
        for name, q in mods.items():
            got_q, got_sx = q.cuda_quantize_nhwc(x)
            if not (torch.equal(got_q, want_q) and torch.equal(
                    got_sx.view(torch.int32), want_sx.view(torch.int32))):
                raise AssertionError(f"{name} quantize {tuple(x.shape)}: "
                                     f"not bit-equal to the plain pass")
    rows, seen = [], set()
    for x in xs:
        key = (*x.shape, str(x.dtype).replace("torch.", ""))
        if key not in seen:
            seen.add(key)
            rows.append((key, x))
    count = {key: sum(1 for y in xs if (*y.shape, str(y.dtype).replace(
        "torch.", "")) == key) for key, _ in rows}
    out = dict(shapes=[])
    for key, x in rows:
        forms = {name: (lambda q=q, x=x: q.cuda_quantize_nhwc(x))
                 for name, q in mods.items()}
        plan = chip_smoke._quantize_plan_of(x)
        nbytes = x.numel() * x.element_size() + x.numel() + x.shape[0] * 4
        row = dict(shape=key, calls=count[key],
                   plan=[plan.tc, plan.bw, plan.nb, plan.k, plan.ipw,
                         plan.spi, plan.blocks_per_sm],
                   bound_ms=nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3,
                   graph_ms=in_turns(forms, _graph_ms, rounds))
        print(f"quantize (N, C, H, W, dtype) {key} x{count[key]}: "
              f"{chip_smoke._plan_text(plan)}: device ms from a CUDA graph, "
              f"in turns {row['graph_ms']!r}, bound {row['bound_ms']!r}")
        if sweep:
            row["sweep"] = []
            want_q, want_sx = kq.quantize_nhwc_plain(x)
            n, c = x.shape[:2]
            tried = set()
            for bps in kq.Q_BLOCKS_PER_SM:
                for ipw in sorted({1, 2, 3, 4, 5, 8, n}):
                    try:
                        p = kq.quantize_plan(n, c, x[0, 0].numel(), x.dtype,
                                             True, kq._sms(x.device), bps,
                                             min(ipw, n))
                    except ValueError:
                        continue
                    if p in tried:
                        continue
                    tried.add(p)
                    run = lambda p=p, x=x: kq.run_quantize_plan(x, p)
                    q, sx = run()
                    if not (torch.equal(q, want_q) and torch.equal(sx, want_sx)):
                        raise AssertionError(f"plan {p} not bit-equal")
                    ms = _graph_ms(run)
                    row["sweep"].append(dict(
                        blocks_per_sm=bps, ipw=p.ipw, waves=p.waves,
                        grid=p.grid, stage=p.stage_bytes, l2=p.l2,
                        device_ms=ms, chosen=p == plan))
                    print(f"  sweep {key}: {bps} blocks an SM, {p.ipw} "
                          f"images a wave: {chip_smoke._plan_text(p)}: "
                          f"{ms!r} ms" + (" (quantize_plan)" if p == plan
                                          else ""))
        out["shapes"].append(row)
    sets = {name: (lambda q=q: [q.cuda_quantize_nhwc(x) for x in xs])
            for name, q in mods.items()}
    out["set_graph_ms"] = in_turns(
        sets, lambda f: chip_smoke._graph_ms(f, reps=1), rounds)
    out["plain_set_graph_ms"] = chip_smoke._graph_ms(
        lambda: [kq.quantize_nhwc_plain(x) for x in xs], reps=1)
    out["launches"] = {
        name: launches_of(mods[name], "QUANTIZE_LAUNCHES", f)
        for name, f in sets.items()}
    # each input read once, one code written per real element (not the
    # stem's padding of 3 channels to 16), the scales
    nbytes = sum(x.numel() * x.element_size() + x.numel() + x.shape[0] * 4
                 for x in xs)
    out["bound_ms"] = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
    print(f"quantize, ahead of the {len(xs)} convs (codes and scales "
          f"bit-equal): device ms from a CUDA graph, in turns "
          f"{out['set_graph_ms']!r}; the plain pass "
          f"{out['plain_set_graph_ms']!r}; launches {out['launches']}; "
          f"bound {out['bound_ms']!r} ms ({nbytes / 1e6:.1f} MB, each input "
          f"read once, the codes and scales written)")
    return out


def sass_histogram():
    """{kernel: {opcode: count}} of the new libraries' SASS."""
    import collections
    import re

    from panodepth_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = {}
    for name in _build.SOURCES:
        text = subprocess.run([cuobjdump, "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        fn = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                fn = m.group(1)
                out[fn] = collections.Counter()
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         line)
            if fn and m:
                out[fn][m.group(2).split(".")[0]] += 1
    for fn, hist in out.items():
        print(f"sass {fn[:80]}: {sum(hist.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in hist.most_common(16)))
    return {fn: dict(h) for fn, h in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-tree",
                    help="an earlier checkout to time against (its "
                         "panodepth_torch/kernels and csrc)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other launch plans per level and shape")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the old,new,new,old turns")
    ap.add_argument("--sass", action="store_true",
                    help="print the new kernels' SASS opcode counts")
    ap.add_argument("--kernels", default="jacobi,groupnorm,qconv,quantize",
                    help="which kernels to time (comma-separated)")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA card")
    from panodepth_torch import MergeConfig
    from panodepth_torch.kernels import _build

    _, smi = chip_smoke.phase_device()
    _build.build()
    sass = sass_histogram() if args.sass else None
    old_kj, old_kg, old_kq = (load_old_kernels(args.old_tree)
                              if args.old_tree else (None, None, None))
    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    res = {}
    with torch.no_grad():
        if "jacobi" in which:
            res["jacobi"] = jacobi_ab(old_kj, cfg, args.rounds, args.sweep)
        if "groupnorm" in which:
            res["group_norm"] = group_norm_ab(old_kg, args.rounds,
                                              args.sweep)
        calls = int8_calls() if which & {"qconv", "quantize"} else None
        if "qconv" in which:
            res["qconv"] = qconv_ab(old_kq, calls, args.rounds, args.sweep)
        if "quantize" in which:
            res["quantize"] = quantize_ab(old_kq, calls, args.rounds,
                                          args.sweep)
    print(smi)
    print(json.dumps(dict(card=smi, sass=sass, **res)))


if __name__ == "__main__":
    main()
