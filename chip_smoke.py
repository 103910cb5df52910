#!/usr/bin/env python3
"""Smoke run of panodepth_torch on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Run from the repository root (it puts the root on ``sys.path`` itself; no
install, no PYTHONPATH).  It needs one CUDA card and ``nvcc``, imports
nothing of JAX, of ``panodepth`` or of Pillow, and writes only to a
temporary directory and to the git-ignored ``panodepth_torch/_build/``.
Phases, each printing its elapsed seconds:

1. device  — the card's name and power limit; TF32 off.
2. build   — every CUDA source of the port compiled with nvcc (in parallel).
3. kernel  — each kernel against its plain PyTorch version at the main
             path's shapes, then timed beside it and beside its bound.
4. merge   — the main path, ``merge_arrays`` at full width (5fold_leres,
             15 views, 2048 wide) on a synthetic scene, through the kernel
             (launches counted), against the plain-Jacobi path, and scored
             against the scene's ground truth.
5. cli     — ``python -m panodepth_torch 0`` (``cli.main``) on two such
             scenes written as files, then again to check resume.

It prints a JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then non-zero and that line is not printed.
"""

from __future__ import annotations

import contextlib
import io as stdio
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_F32_FLOPS = 67e12      # f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3
SEED = 20231


class Phase:
    """Prints a phase's elapsed seconds on its own line when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        print(f"[phase] {self.name} ...", flush=True)
        return self

    def __exit__(self, *exc):
        state = "done" if exc[0] is None else "FAILED"
        print(f"[phase] {self.name} {state} in "
              f"{time.monotonic() - self.t0:.2f} s", flush=True)
        return False


def _median_ms(fn, runs, warmup):
    """Median of ``runs`` CUDA-event timings of ``fn()`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _f32_ulps(a, b):
    """Largest distance in f32 units in the last place between two tensors."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    # map the sign-magnitude bit patterns onto one monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {name} (torch.cuda.device_count() = "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build():
    from panodepth_torch.kernels import _build

    seconds = _build.build()
    for name in _build.SOURCES:
        print(f"built csrc/{name}.cu in {seconds.get(name, 0.0):.2f} s "
              f"({'compiled' if name in seconds else 'cached'})")
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())


def _jacobi_cases(plan, rng, dev):
    """(label, buf, target, covered, iterations) at the main path's shapes:
    random coverage, the plan's own coverage, and coverage on all edges."""
    cases = []
    for i, lvl in enumerate(plan.levels):
        h, w = lvl.height, lvl.width
        buf = torch.tensor(rng.rand(h, w).astype(np.float32), device=dev)
        tgt = torch.tensor(rng.normal(0, 0.01, (h, w)).astype(np.float32),
                           device=dev)
        rand_cov = torch.tensor(rng.rand(h, w) < 0.5, device=dev)
        plan_cov = torch.tensor(lvl.inv_cov > 0, device=dev)
        cases.append((f"{w}x{h} random cov", buf, tgt, rand_cov, lvl.iterations))
        cases.append((f"{w}x{h} plan cov", buf, tgt, plan_cov, lvl.iterations))
        if i == 0:
            edge = rng.rand(h, w) < 0.5
            edge[:2], edge[-2:], edge[:, :2], edge[:, -2:] = True, True, True, True
            cases.append((f"{w}x{h} all edges covered", buf, tgt,
                          torch.tensor(edge, device=dev), lvl.iterations))
    return cases


def phase_kernel(cfg):
    """Kernel vs plain version (bit-equal expected; else <= 1 f32 ulp and
    equal after u16 quantisation), then times at the plan's coverage."""
    from panodepth_torch.fusion import build_fusion_plan
    from panodepth_torch.kernels import jacobi as kj

    dev = torch.device("cuda")
    plan = build_fusion_plan(cfg)
    rng = np.random.RandomState(SEED)
    step, reg = cfg.jacobi_step, cfg.jacobi_reg
    max_abs = 0.0
    rows = []
    for label, buf, tgt, cov, iters in _jacobi_cases(plan, rng, dev):
        got = kj.cuda_jacobi(buf, tgt, cov, iters, step, reg)
        want = kj.jacobi_plain(buf, tgt, cov, iters, step, reg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ulps = _f32_ulps(got, want)
        q = lambda t: (torch.clamp(t, 0, 1) * 65535.0).to(torch.int32)
        u16_equal = torch.equal(q(got), q(want))
        print(f"jacobi {label} x{iters}: max_abs_err {err!r}, {ulps} ulp, "
              f"u16 equal {u16_equal}")
        if ulps > 1 or not u16_equal:
            raise AssertionError(f"jacobi kernel disagrees with the plain "
                                 f"version ({label}): {ulps} ulp, max abs "
                                 f"{err!r}, u16 equal {u16_equal}")
        max_abs = max(max_abs, err)
        if "plan cov" not in label:
            continue
        k_ms = _median_ms(lambda: kj.cuda_jacobi(buf, tgt, cov, iters, step,
                                                  reg), runs=7, warmup=2)
        p_ms = _median_ms(lambda: kj.jacobi_plain(buf, tgt, cov, iters, step,
                                                   reg), runs=5, warmup=1)
        h, w = buf.shape
        covered = int(cov.sum())
        rows.append(dict(shape=f"{w}x{h}", iterations=iters, covered=covered,
                         ms=k_ms, plain_ms=p_ms,
                         bytes=13 * h * w,           # buf, target, out f32; cov u8
                         ops=14 * covered * iters))  # per covered pixel-iteration
        print(f"jacobi {w}x{h} x{iters}: kernel {k_ms!r} ms, plain {p_ms!r} ms "
              f"(median of 7 / 5 CUDA-event runs)")
    total_bytes = sum(r["bytes"] for r in rows)
    total_ops = sum(r["ops"] for r in rows)
    bytes_ms = total_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = total_ops / PEAK_F32_FLOPS * 1e3
    summary = dict(
        ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        max_abs_err=max_abs, levels=rows)
    print(f"jacobi per panorama: kernel {summary['ms']!r} ms, plain "
          f"{summary['plain_ms']!r} ms, bound {summary['bound_ms']!r} ms "
          f"({summary['bound_by']}: {total_ops} ops, {total_bytes} bytes)")
    return summary


def _view_shape(fov, width=1024):
    """(height, width) of a stage-A view (Main.cpp:250-272)."""
    fovx, fovy = abs(fov[1] - fov[0]), abs(fov[3] - fov[2])
    aspect = math.tan(fovx / 2.0) / math.tan(fovy / 2.0)
    return int(round(width / aspect)), width


def _equirect(width, height, fn):
    x = np.arange(width, dtype=np.float64) / (width - 1) * 2 * math.pi
    y = np.arange(height, dtype=np.float64) / (height - 1) * math.pi
    ag, zg = np.meshgrid(x, y)
    return fn(ag, zg)


def make_scene(cfg, seed):
    """u16 scene: gt at out width, an artifact-ridden baseline at half
    width, and per-view affine-distorted views at the stage-A view size."""
    from panodepth_torch import geometry
    from panodepth_torch.io import to_uint16

    rng = np.random.RandomState(seed)
    phase = rng.uniform(0, 2 * math.pi, 3)

    def smooth(azi, zen):
        return (0.45 + 0.18 * np.sin(azi + phase[0]) * np.sin(zen)
                + 0.12 * np.cos(2 * azi) * np.cos(zen)
                + 0.08 * np.sin(zen * 2.0))

    def detail(azi, zen):
        return np.clip(smooth(azi, zen)
                       + 0.03 * np.sin(5 * azi + phase[1]) * np.sin(4 * zen), 0, 1)

    def artifact(azi, zen):
        return np.clip(smooth(azi, zen) * 0.9 + 0.03
                       + 0.08 * np.sin(6 * azi + phase[2]) * np.sin(5 * zen), 0, 1)

    layout = cfg.layout
    gt = to_uint16(_equirect(cfg.out_width, cfg.out_height, detail))
    base = to_uint16(_equirect(cfg.out_width // 2, cfg.out_height // 2, artifact))
    windows = geometry.layout_windows(layout.fovs)
    views = []
    for v in range(layout.num_views):
        h, w = _view_shape(layout.fovs[v], 1024)
        xg, yg = np.meshgrid(np.arange(w) / (w - 1), np.arange(h) / (h - 1))
        azi, zen = geometry.xy_to_spherical(geometry.window_at(windows, v), xg, yg)
        scale, offset = rng.uniform(0.72, 0.88), rng.uniform(0.02, 0.08)
        views.append(to_uint16(detail(azi, zen) * scale + offset))
    return dict(gt=gt, base=base, views=views)


def _as01(u16):
    return u16.astype(np.float32) / np.float32(65535.0)


def phase_merge(cfg, scene):
    """The main path through the kernel, its launch count, the plain path's
    output, the score against gt, and the warm time per panorama."""
    from panodepth_torch import merge_arrays, paired_metrics
    from panodepth_torch.kernels import jacobi as kj

    dev = torch.device("cuda")
    emap = torch.tensor(_as01(scene["base"]), device=dev)
    pmaps = torch.tensor(np.stack([_as01(v) for v in scene["views"]]), device=dev)
    gt = torch.tensor(_as01(scene["gt"]), device=dev)
    per_level = [kj.launches_for(it) for it in cfg.schedule]
    expected = sum(per_level)

    kj.LAUNCHES = 0
    out, abcd = merge_arrays(emap, pmaps, cfg, jacobi="auto")
    torch.cuda.synchronize()
    launches = kj.LAUNCHES
    print(f"merge (auto): jacobi kernel launches {launches} (expected "
          f"{expected} = {'+'.join(map(str, per_level))} for the "
          f"{'/'.join(map(str, cfg.schedule))} iterations)")
    if launches != expected:
        raise AssertionError(f"main path launched the jacobi kernel "
                             f"{launches} times, expected {expected}")
    if out.shape != (cfg.out_height, cfg.out_width) or out.dtype != torch.uint16:
        raise AssertionError(f"bad output {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(abcd).all()):
        raise AssertionError("non-finite registration coefficients")

    plain, _ = merge_arrays(emap, pmaps, cfg, jacobi="torch")
    torch.cuda.synchronize()
    diff = (out.to(torch.int32) - plain.to(torch.int32)).abs()
    print(f"merge: kernel path vs plain-Jacobi path, u16 max diff "
          f"{int(diff.max())}, differing pixels {int((diff > 0).sum())}")
    if int(diff.max()) != 0:
        raise AssertionError("u16 output of the kernel path differs from "
                             "the plain-Jacobi path")

    m = paired_metrics(gt, emap, out.to(torch.float32) / 65535.0,
                       align_way=cfg.align_way, cap_depth=cfg.cap_depth,
                       zenith_range=cfg.zenith_range)
    m.print()
    if not m.mse_result < m.mse_given:
        raise AssertionError("fused output does not beat the baseline on RMSE")

    times = []
    for _ in range(6):  # one warm-up, then five timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merge_arrays(emap, pmaps, cfg, jacobi="auto")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    warm_ms = float(np.median(times[1:]))
    print(f"merge warm time per panorama (device-resident inputs, host clock "
          f"to synchronize, median of 5): {warm_ms!r} ms; runs {times[1:]!r}")
    _profile_merge(lambda: merge_arrays(emap, pmaps, cfg, jacobi="auto"),
                   warm_ms)
    return out.cpu().numpy(), launches, warm_ms


def _profile_merge(run, warm_ms):
    """Device time by kernel over one warm merge (torch.profiler), and the
    device's busy share of the unprofiled warm time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    from torch.autograd import DeviceType

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the kernels themselves (device-side events); the CPU-side operators
    # that launched them carry the same time and are left out of the sum
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        print("merge profile: the profiler saw no device time (not measured)")
        return
    print(f"merge profile: device busy {busy_ms!r} ms of the warm "
          f"{warm_ms!r} ms (idle share {1 - busy_ms / warm_ms!r}); "
          f"top device time by name (ms, calls):")
    for e in events[:12]:
        if device_us(e) > 0:
            print(f"  {device_us(e) / 1e3:9.4f} ms  {e.count:6d}  {e.key[:90]}")


def phase_cli(cfg, scenes, merged0):
    """``panodepth_torch.cli.main`` on two scenes written as files, then
    again for resume."""
    from panodepth_torch import cli, io as pio
    from panodepth_torch.kernels import jacobi as kj

    layout = cfg.layout
    names = [f"pano_{i:04d}" for i in range(len(scenes))]
    with tempfile.TemporaryDirectory(prefix="panodepth_smoke_") as root:
        d = {k: os.path.join(root, k) for k in
             ("rgb", "gt", "baseline", "views", "result_hohonet")}
        for path in d.values():
            os.makedirs(path)
        for name, sc in zip(names, scenes):
            # stage C reads only the names of the RGB panoramas
            pio.save_png16(os.path.join(d["rgb"], name + ".png"),
                           np.zeros((8, 16), np.uint16))
            pio.save_png16(os.path.join(d["gt"], name + ".png"), sc["gt"])
            pio.save_png16(os.path.join(d["baseline"], name + ".depth.png"),
                           sc["base"])
            for v, view in enumerate(sc["views"]):
                pio.save_png16(os.path.join(
                    d["views"], f"{name}.{layout.view_tag(v)}.png"), view)
        argv = ["0", d["rgb"], d["gt"], d["baseline"], d["result_hohonet"],
                "--no-extract", "--pmap-ext", ".png", "--views-folder",
                d["views"], "--layout", cfg.layout_name,
                "--out-width", str(cfg.out_width)]

        kj.LAUNCHES = 0
        if cli.main(argv) != 0:
            raise AssertionError("cli.main returned non-zero")
        launches = kj.LAUNCHES
        print(f"cli: jacobi kernel launches {launches} for {len(names)} "
              f"panoramas")
        if launches != len(names) * sum(kj.launches_for(it)
                                        for it in cfg.schedule):
            raise AssertionError(f"cli launched the kernel {launches} times")
        for name in names:
            for suffix in (".png", ".aligned.txt", ".png.res.png",
                           ".png.giv.png"):
                f = os.path.join(d["result_hohonet"], name + suffix)
                if not os.path.isfile(f):
                    raise AssertionError(f"cli did not write {f}")
        manifest = os.path.join(d["result_hohonet"], "manifest.json")
        with open(manifest) as fp:
            done = json.load(fp)
        if done["completed"] != names or done["quarantined"]:
            raise AssertionError(f"manifest: {done}")
        got = pio.read_png(os.path.join(d["result_hohonet"], names[0] + ".png"))
        if not np.array_equal(got, merged0):
            raise AssertionError("cli output differs from the in-memory merge "
                                 "of the same scene")
        print("cli: outputs written; first panorama equals the in-memory merge")

        kj.LAUNCHES = 0
        log = stdio.StringIO()
        with contextlib.redirect_stdout(log):
            cli.main(argv)
        skips = log.getvalue().count("skip!")
        with open(manifest) as fp:
            again = json.load(fp)
        print(f"cli resume: {skips} skip! lines, {kj.LAUNCHES} launches")
        if skips != len(names) or kj.LAUNCHES or again["skipped"] != names:
            raise AssertionError("resume did not skip the finished panoramas")


def main():
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card")
    from panodepth_torch import MergeConfig

    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    with Phase("device"):
        name, smi = phase_device()
    with Phase("build"):
        phase_build()
    with Phase("kernel"):
        jac = phase_kernel(cfg)
    with Phase("merge"):
        scenes = [make_scene(cfg, SEED + i) for i in range(2)]
        merged0, launches, warm_ms = phase_merge(cfg, scenes[0])
    with Phase("cli"):
        phase_cli(cfg, scenes, merged0)

    kernels = [dict(
        name="jacobi", route="cuda", source="panodepth_torch/csrc/jacobi.cu",
        replaces="panodepth/kernels/jacobi.py:98",
        launches=launches, max_abs_err=jac["max_abs_err"],
        ms=jac["ms"], kernel_ms=jac["ms"], plain_ms=jac["plain_ms"],
        bound_ms=jac["bound_ms"], bound_by=jac["bound_by"], library_ms=None,
        levels=jac["levels"])]
    print(f"merge warm ms per panorama: {warm_ms!r}; card: {smi}")
    print(f"chip_smoke wall time: {time.monotonic() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
