#!/usr/bin/env python3
"""Smoke run of panodepth_torch on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Run from the repository root (it puts the root on ``sys.path`` itself; no
install, no PYTHONPATH).  It needs one CUDA card, ``nvcc`` and ``g++``,
imports nothing of JAX, of ``panodepth`` or of Pillow, and writes only to a
temporary directory and to the git-ignored ``panodepth_torch/_build/``.
Phases, each printing its elapsed seconds:

1. device  — the card's name and power limit.
2. build   — every CUDA source of the port (the Jacobi, the GroupNorm, the
             int8 conv, the activation's quantization) compiled with nvcc
             and the JPEG and PNG codecs with g++ (in parallel), with
             ptxas's registers, shared memory and spills per kernel, and
             the zlib the PNG codec found (header, run-time version).
3. kernel  — the Jacobi kernel bit-equal to its plain PyTorch version at
             every level of the 2048 and the 4096 plan, each level's launch
             plan printed; the 2048 levels timed beside the plain version
             and the bound.
4. merge   — the main path, ``merge_arrays`` at full width (5fold_leres,
             15 views, 2048 wide) on a synthetic scene, through the kernel
             (launches counted), against the plain-Jacobi path, and scored
             against the scene's ground truth.  Then the library functions
             the main path does not call, each once on the card against
             the port on the CPU: ``fit_poly`` (degrees 1-4, 2^20
             samples), ``fit_reciprocal``, ``fit_cubic_global`` (the
             merge's result), ``solve_depth_by_smoothing`` (at 512 wide,
             bit-equal), ``resample_view``, ``depth_view_to_equirect``,
             ``rotate_equirect`` and ``extract_view_elevated`` at 2048.
5. cli     — ``python -m panodepth_torch 0`` (``cli.main``) on two such
             scenes written as files (the first scene's baseline and views
             with Paeth and Average rows, as libpng and OpenCV write them,
             its output bit-equal to the in-memory merge), then again to
             check resume; then
             ``python -m panodepth_torch.analyze`` (``analyze.main``) on the
             first result against its gt, ``--laplacian --json`` and
             ``--mono360 --json``, on the card equal to ``--device cpu``
             within 1e-5 relative.
6. groupnorm — the GroupNorm kernel against its plain version on the 29
             inputs FastPanoNet's norms get at a 256x512 input (the zoo
             weights, a synthetic panorama), as bf16 -> f32 as the path
             runs them and as f32 -> f32, bf16 -> bf16, with and without
             ReLU; a near-constant group and an odd shape; each shape's
             cluster plan; then the 29-call set timed (kernel, plain
             version, ``F.group_norm``) and its device time under the
             profiler, the kernel's and ``F.group_norm``'s.
7. models  — both zoo nets loaded from ``zoo/`` (FastPanoNet 1x256x512,
             NFPerspectiveNet 15x256x256): norm launches counted, outputs
             finite in 0~1, the baseline of the kernel route against the
             plain route.
8. e2e     — the slice's main path, ``build_batched_e2e`` at full width
             (5fold_leres, 2048, views 256, baseline CNN 512) on two
             synthetic panoramas, replayed from CUDA graphs: launches of
             both kernels counted at the capture and seen again in a
             replay under the profiler, the graph bit-equal to its eager
             stages, the u16 output against the plain routes', each
             panorama at batch 1 against batch 2 (within 1 u16) and, for
             the record, the first tensor that differed when each net ran
             on the whole batch; warm time per panorama (models, fuse,
             total) and the device's idle share.
9. cli-e2e — ``cli.main`` in model mode on two RGB panoramas written as
             8-bit RGB PNGs, with ``--baseline-ckpt`` and with baseline
             files, then again to check resume.
10. stage-a — the reference's own command, ``0 rgb gt baseline result``
             with stage A on and the default ``.jpg`` views, on two
             2048x1024 RGB panoramas written as JPEG by the port's codec
             (5fold_leres, out 2048, views 1024): the 15 view files of each
             panorama byte-equal to the codec's encode of the in-memory
             extraction; then the scene's depth views and baselines as
             8-bit gray JPEGs, stage A skipping them and the u16 output
             equal to ``merge_arrays`` on the decoded arrays, Jacobi
             launches counted, resume; model mode on the JPEG panoramas
             equal to the same command on PNG copies of their pixels; no
             Pillow imported; codec and stage-A times.
11. graphs — the compiled merge forms (``compiled_merge``, ``_staged``,
             ``_batched`` at B = 4 and 24) bit-equal to the eager merge per
             panorama, a replay's kernels under the profiler, one 4096
             merge through a graph against the eager plain-Jacobi path,
             ``merge_many`` on files at batch 4 (stream off and on,
             profiled); the host's loads: one panorama's 16 files decoded
             by the Python twin, the native codec and the native
             prefetcher (Up-filtered, and phase cli's Paeth/Average set),
             ``merge_many`` at batch 24 on one scene's files (host ms a
             panorama, idle share, outputs bit-equal to batch 4's); the
             CLIs with ``--batch-size 4 --profile`` (file mode) and
             ``--batch-size 2 --profile --stream on`` (model mode) against
             the single-panorama outputs, with resume; then
             eager and graph times in turns (eager, graph, graph, eager):
             the merge at batch 1, the batched graph at 4 and 24, the e2e
             graph at batch 2 (and its eager stages) and 8, each with the
             device's idle share.  After the batch-4 merge, the dp pair
             (below) is awaited and its outputs are held bit-equal to it
             and to phase e2e's batch-2 graph.
12. batched — the Jacobi kernel on a batch of panoramas with one mask,
             bit-equal to the plain version and to each panorama alone at
             every level of the 2048 plan (B = 3) and at 4096x2048 (B =
             2), one launch sequence per batch; the 2048 pyramid timed per
             panorama at B = 1, 4 and 24.
13. families — each of the zoo's other checkpoints at full width (the GN
             perspective net on the 15 views of 5fold_leres at 256, the
             UniFuse-class, HoHoNet, BiFuse and SliceNet baselines at
             256x512): every GroupNorm call of one forward held against the
             plain version (each image of a multi-image call bit-equal to
             itself alone), the calls per forward, their shapes, the set
             timed (kernel, plain, ``F.group_norm``) with its bound; the net
             through the kernel against the plain route; the e2e graph at
             batch 2 with the family (each baseline beside the NF
             perspective net, the GN perspective net beside FastPanoNet):
             launches counted at the capture, the graph bit-equal to eager,
             kernel routes against plain routes, batch 2 against batch 1,
             time per panorama and idle share.  The GN net's int8 graph
             (``load_model_checkpoint(quantize=True)``): each of its 39
             int8 convs on the 15 views' real activations, the qconv
             kernel's int32 sums and bf16 output bit-equal to the plain
             twin's and the sums to ``F.unfold`` + ``torch._int_mm``'s, each
             distinct shape (with its launch plan) and the 39 as a set
             timed (kernel, plain, unfold + _int_mm, the bf16 ``F.conv2d``)
             with the bound; the quantization kernel's codes and scales
             bit-equal to the plain pass's on the 39 inputs and on edge
             inputs (N = 1, C = 3 and 40, 7x11 pixels, a 4-byte offset,
             zeros, ties, a NaN in one image of three, a 512-view's input
             on the L2 path), each shape (with its plan) and the set
             timed (kernel, plain) with the bound; the
             net's output within JAX's 0.12 relative RMS of the float
             net's; the int8 e2e graph beside FastPanoNet (the checks
             above, kernel routes equal to plain routes, 39 qconv and 39
             quantize launches a forward), its u16 distance from the bf16 GN
             graph's and both timed in turns.  Then the model-mode CLI with
             the BiFuse baseline and the GN perspective net, with resume,
             ``--base-width 256`` refused for HoHoNet, and the CLI with
             ``--persp-int8`` (files equal to the in-process int8 graph's).
14. serve  — the serving path: ``python -m panodepth_torch.serve``
             exports, each in a child process of its own (SliceNet's, the
             longest, started after phase build, the others with phase
             stage-a),
             the 2048 merge (batch 4, u16 512x1024 baselines, 15 988x1024
             views), the e2e graph with FastPanoNet + NF (batch 2, u8
             1024x2048 RGB, views 256) and the e2e graph of each other
             family and of the int8 GN graph (``--persp-int8``, batch 1);
             export seconds and artifact bytes.  Each
             artifact loaded (load seconds; the merge and e2e ones here,
             each family's in its export child, which holds it when this
             process says so, one child at a time): its kernel operator
             nodes (3 ``jacobi``; 29 ``group_norm`` a FastPanoNet forward),
             the launches of its first call and of a replay under the
             profiler (26 Jacobi launches a batch, one GroupNorm launch a
             norm call, 39 qconv and 39 quantize launches an int8
             forward), its outputs
             bit-equal to the in-process ``compiled_merge_batched`` or
             ``e2e.full`` graph; the merge and e2e ones again after a load
             in a fresh process that imports no JAX; the ``daemon`` on the e2e
             artifact (8 clients, 2 quality-95 JPEG panoramas each, every
             PNG answer bit-equal to the direct call: latency p50/p99, batch
             fill, panoramas/s, host decode and encode ms) and on the merge
             artifact (.npz); the replays timed in turns against the
             in-process graphs (artifact, graph, graph, artifact) with
             device busy and idle share.  The artifacts live in a temporary
             directory, deleted at the end.  Phase train's ``train_cli``
             children (started before phase cli-e2e) are awaited before
             the first artifact is loaded; they and the exports (one
             thread each) run at background priority.
15. train  — training at full width, batch 16 (the zoo recipe, lr 3e-4,
             mix scenes rendered on the card): FastPanoNet with the zoo's
             UniFuse-class distillation teacher and the NF perspective net
             (256x256 views), each with render ms a batch, steps/s and
             img/s with the render included and excluded, device busy and
             idle share of a step (profiler), peak memory, the GroupNorm
             launches of a step (the student's 0, the teacher's one per
             norm call, 31) and the loss falling over 20 steps on a fixed
             batch (the recipe's warmup schedule); two steps of the UniFuse-class, HoHoNet, BiFuse,
             SliceNet and GN perspective nets (steps/s); one f32 step of a
             narrow FastPanoNet on the card against the CPU's; ``evaluate``
             on the zoo FastPanoNet on 16 v1 scenes (RMSE and delta1 beside
             zoo/README.md's, kernel route against plain route, launches
             counted).  Training on files: a dataset of 40 mix scenes at
             Matterport3D's 1024x512 written by ``synth.write_dataset``
             (seconds); a batch of 16 pairs decoded on 1 thread and on the
             pool (ms, bit-equal); both nets above on the files with
             --augment --corrupt, timed in turns against --synth --corrupt
             (files, synth, synth, files), with the corruption's device ms,
             busy and idle share of a file step and its GroupNorm launches;
             the corruption on the card against the CPU on the same draws;
             ``evaluate --corrupt`` (RMSE beside the clean one, launches);
             ``evaluate --int8`` on the zoo GN perspective net (RMSE and
             delta1 beside the float graph's, qconv and quantize launches
             counted);
             the merge CLI with --debug-nans on phase cli's first scene
             (eager: 26 Jacobi launches, output bit-equal to phase cli's);
             then the ``train_cli`` children (run beside phases cli-e2e
             and stage-a): 3 steps on --synth as a two-process run
             (``--coordinator``, both ranks on cuda:0 over gloo, 8 rows
             each: both exit 0, only rank 0 says ``[train] done``, each
             names its backend, the final checkpoint's digest agrees over
             the ranks, each rank's teacher runs 31 GroupNorm launches a
             step; each rank's step ms and device time), and 4 on the
             files in one process with --eval-every 2
             --trace (the holdout lines, finite val_loss, a trace holding
             the card's kernels), each child's ``fastpano_final.params.npz``
             run in the e2e graph beside the zoo NF net (``_family_e2e``'s
             checks).

The dp pair: two ranks of this script (``--dp-worker RANK PORT DIR``) at
background priority, started before phase e2e (they import meanwhile and
touch the card once it has ended, with phase train's children) and
awaited in phase graphs after its compiled forms (which time and profile
nothing), both on cuda:0 over gloo: ``parallel.mesh.
batched_merge`` at 5fold_leres 2048 on a batch of 4 scenes (2 a rank) and
``build_batched_e2e(mesh=make_mesh())`` with the zoo nets on the two
panoramas (1 a rank), the Jacobi's and the GroupNorm's launches counted in
each rank, each rank's ms a panorama, the gathered outputs the same on
both ranks.  Then the sp axis over the same two ranks (``make_mesh((1,
2))``): ``parallel.spatial.jacobi_spatial`` at every level of the 2048
pyramid at halo 1 and 10 on a mask of full-width rows, the Jacobi kernel
on the shards' extended buffers against the plain ``step_ext`` schedule
and one process's kernel on the full width (bit-equal, launches counted);
``batched_merge`` on the (1, 2) mesh (halo 10) against phase graphs'
one-process batch-4 merge (bit-equal); the view-parallel latency graph
(``parallel.views.build_latency_e2e``, vp = 2, halo 10) with the zoo nets
on phase e2e's two panoramas: within the route bar of phase e2e's batch-2
graph, bit-equal to one process's ``fuse`` on its own intermediates, the
ranks' baselines equal, each call's ms and collectives, the Jacobi's and
the GroupNorm's launches; and ``run_batch_e2e(latency=True)`` on the two
panoramas as PNG files in both ranks (rank 0's files equal to the graph's
outputs, the rerun skipping both).  The --synth train run's ranks are this script too
(``--train-rank ARGV``): ``train_cli.main(ARGV)`` with the steps timed.

Launch counts: a graph's kernels are counted by their wrappers at the two
warm-up calls and the capture (``graph_launches``); a replay launches them
without counting, and the profiler sees them there.

The device phase leaves PyTorch's TF32 flags as they are: the merge and
the e2e stages turn TF32 off while they run (``pipeline.true_f32``), and
phases merge and e2e check that a caller's flags survive them and do not
change the output.

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
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
PYCACHE = os.path.join(ROOT, "panodepth_torch", "_build", "pycache")
if __name__ == "__main__" and os.path.isdir(os.path.dirname(os.path.dirname(
        PYCACHE))):
    # the bytecode of every module this run compiles goes to one cache in
    # the git-ignored build directory, which its child processes (exports,
    # train runs, the fresh load) read: where the installed packages keep
    # no bytecode, each new process would compile torch's sources again
    # (~10 s of a child's start)
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE

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
    return name, smi


def phase_build():
    from panodepth_torch.kernels import _build

    seconds = _build.build(_build.SOURCES + _build.HOST_SOURCES)
    for name in _build.SOURCES + _build.HOST_SOURCES:
        print(f"built {_build.source_path(name).name} in "
              f"{seconds.get(name, 0.0):.2f} s "
              f"({'compiled' if name in seconds else 'cached'})")
        # ptxas -v: one entry line per kernel, then its spills and registers
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                print("  " + line.split("'")[1][:100])
            elif "registers" in line or "spill" in line:
                print("    " + line.strip())
    from panodepth_torch.utils import nativeio

    zl = nativeio.zlib_info()
    print(f"pngio (the PNG codec and prefetcher): built with "
          f"{_build.gxx_path()} {' '.join(_build.GXX_FLAGS)} ... "
          f"{' '.join(_build.LINK_FLAGS['pngio'])}; zlib {zl['version']} at "
          f"run time, built against zlib.h {zl['header']}")


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


def jacobi_launches(cfg):
    """Jacobi launches per level of ``cfg``'s pyramid, by the kernel's plan."""
    from panodepth_torch.fusion import build_fusion_plan
    from panodepth_torch.kernels import jacobi as kj

    return [kj.launches_for(lvl.height, lvl.width, lvl.iterations)
            for lvl in build_fusion_plan(cfg).levels]


def graph_launches(per_call):
    """Launches counted when a call captures a new graph: the warm-up calls
    and the captured call (a replay launches the kernels again without
    counting them; torch.profiler sees those)."""
    from panodepth_torch import graphs

    return (graphs.WARMUP + 1) * per_call


def fresh_graphs():
    """Drop the cached compiled merges (and their graphs), so that the next
    call of each captures anew and its launches are counted."""
    from panodepth_torch import pipeline

    for factory in (pipeline.compiled_merge, pipeline.compiled_merge_staged,
                    pipeline.compiled_merge_batched,
                    pipeline.compiled_merge_staged_batched):
        factory.cache_clear()
    torch.cuda.empty_cache()


def phase_kernel(cfg, cfg_4096):
    """Kernel vs plain version, bit-equal, at every level of both plans;
    then the 2048 levels timed at the plan's coverage."""
    from panodepth_torch.fusion import build_fusion_plan
    from panodepth_torch.kernels import jacobi as kj

    dev = torch.device("cuda")
    step, reg = cfg.jacobi_step, cfg.jacobi_reg
    max_abs = 0.0
    rows = []
    for c in (cfg, cfg_4096):
        for lvl in build_fusion_plan(c).levels:
            p = kj.plan_for(lvl.height, lvl.width, lvl.iterations)
            print(f"jacobi plan {c.out_width}: {lvl.width}x{lvl.height} "
                  f"x{lvl.iterations}: window {p.window[1]}x{p.window[0]} "
                  f"({p.cols}x{p.rows} per thread, {p.warps} warps), tile "
                  f"{p.tile[1]}x{p.tile[0]}, {p.halo} iterations per "
                  f"launch, grid {p.grid[0]}x{p.grid[1]} = {p.blocks} blocks,"
                  f" {p.launches} launches, {p.smem_bytes} B shared")
    rng = np.random.RandomState(SEED)
    cases = ([(c, "2048") for c in _jacobi_cases(build_fusion_plan(cfg), rng,
                                                 dev)]
             + [(c, "4096") for c in _jacobi_cases(
                 build_fusion_plan(cfg_4096), rng, dev)])
    for (label, buf, tgt, cov, iters), plan_name in cases:
        got = kj.cuda_jacobi(buf, tgt, cov, iters, step, reg)
        want = kj.jacobi_plain(buf, tgt, cov, iters, step, reg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = torch.equal(got, want)
        print(f"jacobi {plan_name} plan, {label} x{iters}: bit-equal "
              f"{equal}, max_abs_err {err!r}, {_f32_ulps(got, want)} ulp")
        if not equal:
            raise AssertionError(f"jacobi kernel is not bit-equal to the "
                                 f"plain version ({plan_name} plan, {label}):"
                                 f" max abs {err!r}")
        max_abs = max(max_abs, err)
        if "plan cov" not in label or plan_name != "2048":
            continue
        k_ms = _median_ms(lambda: kj.cuda_jacobi(buf, tgt, cov, iters, step,
                                                  reg), runs=7, warmup=2)
        p_ms = _median_ms(lambda: kj.jacobi_plain(buf, tgt, cov, iters, step,
                                                   reg), runs=5, warmup=1)
        h, w = buf.shape
        covered = int(cov.sum())
        rows.append(dict(shape=f"{w}x{h}", iterations=iters, covered=covered,
                         ms=k_ms, plain_ms=p_ms,
                         launches=kj.launches_for(h, w, iters),
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
    windows = geometry.layout_windows(layout.fovs)
    # each view's distortion, drawn in view order
    draws = [(rng.uniform(0.72, 0.88), rng.uniform(0.02, 0.08))
             for _ in range(layout.num_views)]

    def view(v):
        h, w = _view_shape(layout.fovs[v], 1024)
        xg, yg = np.meshgrid(np.arange(w) / (w - 1), np.arange(h) / (h - 1))
        azi, zen = geometry.xy_to_spherical(geometry.window_at(windows, v), xg, yg)
        scale, offset = draws[v]
        return to_uint16(detail(azi, zen) * scale + offset)

    # numpy's ufuncs drop the GIL: the maps are made on threads
    gt, base, *views = _threaded(
        [lambda: to_uint16(_equirect(cfg.out_width, cfg.out_height, detail)),
         lambda: to_uint16(_equirect(cfg.out_width // 2,
                                     cfg.out_height // 2, artifact))]
        + [lambda v=v: view(v) for v in range(layout.num_views)])
    return dict(gt=gt, base=base, views=views)


def _threaded(calls):
    """The results of the no-argument ``calls``, run on a pool of threads
    (host numpy work that releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return [f.result() for f in [pool.submit(c) for c in calls]]


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
    per_level = jacobi_launches(cfg)
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

    _hold_tf32_flags("merge", out,
                     lambda: merge_arrays(emap, pmaps, cfg, jacobi="auto")[0])

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
    merged = out.cpu().numpy()
    library = _library_checks(cfg, scene, merged, emap, pmaps)
    return merged, launches, warm_ms, library


# the library functions of phase merge, the card against the port on the
# CPU on the same inputs: fitted curves on a grid (f32 sums in another
# order), bilinear samplers (f32 trigonometry, and the card divides by a
# Python number as a multiply by its reciprocal), nearest samplers (the
# share of pixels whose tap crossed a cell boundary by that ulp); the
# smoother is the same f32 arithmetic, held bit-equal
LIB_CURVE_ABS = 1e-4
LIB_BILINEAR_ABS = 1e-4
LIB_NEAREST_SHARE = 1e-3


def _library_checks(cfg, scene, merged0, emap, pmaps):
    """Each function of the JAX package's single-device surface that the
    main path does not call, once on the card and once on the CPU on the
    same inputs: ``fit_poly`` (degrees 1-4), ``fit_reciprocal``,
    ``fit_cubic_global``, ``solve_depth_by_smoothing`` (at 512 wide: its
    500 rounds on the CPU), ``resample_view``, ``rotate_equirect``,
    ``extract_view_elevated`` and ``depth_view_to_equirect`` (the last four
    at 2048 wide)."""
    from panodepth_torch import MergeConfig, fusion, geometry
    from panodepth_torch import registration as reg
    from panodepth_torch.ops import projection, sampling

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.RandomState(SEED)
    grid = np.linspace(0.05, 0.95, 181)
    found = {}

    def once(fn, *args):
        """fn on the card (host ms to synchronize) and on the CPU."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fn(*[a.to(dev) for a in args])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return card, fn(*[a.to(cpu) for a in args]), ms

    def held(name, value, bar, ms, note=""):
        found[name] = dict(value=value, bar=bar, ms=ms)
        print(f"merge library: {name}: {value!r} (bar {bar!r}) in "
              f"{ms:.2f} ms on the card{note}")
        if not value <= bar:
            raise AssertionError(f"{name} on the card differs from the CPU "
                                 f"by {value!r}, over its bar {bar!r}")

    def curve_gap(a, b):
        a, b = (np.asarray(t.detach().cpu(), np.float64) for t in (a, b))
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            return float("inf")
        return float(np.abs(np.polyval(a, grid) - np.polyval(b, grid)).max())

    x = torch.tensor(rng.uniform(0.05, 0.95, 1 << 20).astype(np.float32))
    ones = torch.ones_like(x)
    for deg in (1, 2, 3, 4):
        true = rng.uniform(-0.5, 0.8, deg + 1)
        y = torch.tensor((np.polyval(true, x.numpy().astype(np.float64))
                          + rng.normal(0, 1e-3, x.shape[0])).astype(
                              np.float32))
        card, host, ms = once(lambda a, b, w: reg.fit_poly(a, b, w, deg),
                              x, y, ones)
        held(f"fit_poly degree {deg}, 2^20 samples, curve max abs",
             curve_gap(card, host), LIB_CURVE_ABS, ms)
    xr = torch.tensor(rng.uniform(0.1, 0.9, 4096).astype(np.float32))
    yr = 0.7 / (1.3 * xr + 0.4) + 0.05
    card, host, ms = once(reg.fit_reciprocal, xr, yr, torch.ones_like(xr))
    g = torch.tensor(grid.astype(np.float32))
    gap = float((reg.apply_reciprocal(g, card.cpu())
                 - reg.apply_reciprocal(g, host)).abs().max())
    held("fit_reciprocal, 50 LM steps, curve max abs", gap, LIB_CURVE_ABS,
         ms)
    result01 = torch.tensor(merged0.astype(np.float32) / np.float32(65535.0))
    card, host, ms = once(lambda r, e: reg.fit_cubic_global(
        r, e, cfg.zenith_range), result01, emap.cpu())
    held("fit_cubic_global (the merge's 1024x2048 result against its "
         "baseline), curve max abs", curve_gap(card, host), LIB_CURVE_ABS,
         ms)

    cfg512 = MergeConfig(layout_name="5fold_leres", out_width=512)
    plan512 = fusion.build_fusion_plan(cfg512)
    views = pmaps.cpu()
    (c_u16, c_buf), (h_u16, h_buf), ms = once(
        lambda p: fusion.solve_depth_by_smoothing(p, plan512), views)
    held("solve_depth_by_smoothing (512x256, 500 rounds, 15 views "
         "988x1024), u16 max diff",
         int((c_u16.cpu().to(torch.int32) - h_u16.to(torch.int32)).abs()
             .max()), 0, ms,
         f"; buffer max abs {float((c_buf.cpu() - h_buf).abs().max())!r}")

    def nearest_share(card, host):
        return float((card.cpu() != host).float().mean())

    plan = fusion.build_fusion_plan(cfg)
    v = 7
    win = geometry.window_at(plan.windows, v)
    card, host, ms = once(lambda p: fusion.resample_view(
        p, win, cfg.out_width, cfg.out_height), views[v])
    held("resample_view (view 7 onto 2048x1024), share of pixels that "
         "differ", nearest_share(card, host), LIB_NEAREST_SHARE, ms)
    fov = cfg.layout.fovs[v]
    (card, card_in), (host, host_in), ms = once(
        lambda p: projection.depth_view_to_equirect(p, fov, cfg.out_width,
                                                    cfg.out_height),
        views[v])
    held("depth_view_to_equirect (view 7 onto 2048x1024), share of pixels "
         "that differ", nearest_share(card, host), LIB_NEAREST_SHARE, ms,
         f"; inside masks differ at {nearest_share(card_in, host_in)!r}")
    gt01 = torch.tensor(_as01(scene["gt"]))
    card, host, ms = once(lambda i: sampling.rotate_equirect(
        i, yaw=0.3, pitch=0.2, roll=-0.1), gt01)
    held("rotate_equirect (the 1024x2048 gt), max abs",
         float((card.cpu() - host).abs().max()), LIB_BILINEAR_ABS, ms)
    card, host, ms = once(lambda i: projection.extract_view_elevated(
        i, fov, 1024), gt01)
    held(f"extract_view_elevated (view 7, {tuple(host.shape)} from the gt), "
         f"max abs", float((card.cpu() - host).abs().max()),
         LIB_BILINEAR_ABS, ms)
    return found


def _hold_tf32_flags(label, want, run):
    """``run()`` with a caller's TF32 flags on: the flags survive the call
    and the output equals ``want`` (computed under the default flags)."""
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cd.allow_tf32)
    try:
        mm.allow_tf32 = cd.allow_tf32 = True
        got = run()
        torch.cuda.synchronize()
        flags = (mm.allow_tf32, cd.allow_tf32)
    finally:
        mm.allow_tf32, cd.allow_tf32 = saved
    same = torch.equal(got, want)
    print(f"{label}: with the caller's TF32 flags on, flags after the call "
          f"{flags}, output bit-equal {same}")
    if flags != (True, True) or not same:
        raise AssertionError(f"{label}: the TF32 flags did not survive the "
                             f"call, or TF32 changed the output")


def _profile_merge(run, warm_ms):
    """Device time by kernel over one warm merge (torch.profiler), and the
    device's busy share of the unprofiled warm time."""
    busy_ms, events = _device_profile(run)
    if busy_ms <= 0:
        print("merge profile: the profiler saw no device time (not measured)")
        return
    print(f"merge profile: device busy {busy_ms!r} ms of the warm "
          f"{warm_ms!r} ms (idle share {1 - busy_ms / warm_ms!r}); "
          f"top device time by name (ms, calls):")
    for ms, count, name in events[:12]:
        if ms > 0:
            print(f"  {ms:9.4f} ms  {count:6d}  {name[:90]}")


# the rows of the first scene's baseline and views in phase cli: Paeth and
# Average, the filters libpng and OpenCV choose for smooth depth rows
PAETH_AVERAGE = (4, 3, 4, 4)


def phase_cli(cfg, scenes, merged0, root):
    """``panodepth_torch.cli.main`` on two scenes written as files into
    ``root`` (the first scene's baseline and views with Paeth and Average
    rows, the second's as ``io.save_png16`` writes them), then again for
    resume.  Returns the analysis check's numbers and the first scene's 16
    input files, which phase graphs decodes again."""
    from panodepth_torch import cli, io as pio
    from panodepth_torch.kernels import jacobi as kj

    layout = cfg.layout
    names = [f"pano_{i:04d}" for i in range(len(scenes))]
    d = {k: os.path.join(root, k) for k in
         ("rgb", "gt", "baseline", "views", "result_hohonet")}
    for path in d.values():
        os.makedirs(path)
    writes = []
    for name, sc in zip(names, scenes):
        # stage C reads only the names of the RGB panoramas
        pio.save_png16(os.path.join(d["rgb"], name + ".png"),
                       np.zeros((8, 16), np.uint16))
        pio.save_png16(os.path.join(d["gt"], name + ".png"), sc["gt"])
        files = [os.path.join(d["baseline"], name + ".depth.png")] + [
            os.path.join(d["views"], f"{name}.{layout.view_tag(v)}.png")
            for v in range(layout.num_views)]
        if name == names[0]:
            paeth_files = files
        for f, m in zip(files, [sc["base"]] + list(sc["views"])):
            writes.append(
                (lambda f=f, m=m: write_png_filtered(f, m, PAETH_AVERAGE))
                if name == names[0] else
                (lambda f=f, m=m: pio.save_png16(f, m)))
    _threaded(writes)
    with open(paeth_files[1], "rb") as fp:
        kinds = _png_row_filters(fp.read())
    print(f"cli: {names[0]}'s baseline and {layout.num_views} views "
          f"written with the row filters {sorted(kinds)} (Paeth 4, "
          f"Average 3)")
    if kinds != {3, 4}:
        raise AssertionError(f"cli: the Paeth files' rows are {kinds}")
    argv = ["0", d["rgb"], d["gt"], d["baseline"], d["result_hohonet"],
            "--no-extract", "--pmap-ext", ".png", "--views-folder",
            d["views"], "--layout", cfg.layout_name,
            "--out-width", str(cfg.out_width)]

    fresh_graphs()
    kj.LAUNCHES = 0
    if cli.main(argv) != 0:
        raise AssertionError("cli.main returned non-zero")
    launches = kj.LAUNCHES
    want = graph_launches(sum(jacobi_launches(cfg)))
    print(f"cli: jacobi kernel launches {launches} for {len(names)} "
          f"panoramas (expected {want}: one graph captured, then "
          f"replayed)")
    if launches != want:
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
    print(f"cli: outputs written; first panorama (its inputs Paeth- and "
          f"Average-filtered, through the native prefetcher: "
          f"{_prefetch_route()}) bit-equal to the in-memory merge "
          f"merged0: True")

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
    return _analyze_check(
        os.path.join(d["gt"], names[0] + ".png"),
        os.path.join(d["result_hohonet"], names[0] + ".png")), paeth_files


def _png_row_filters(data):
    """The set of row filter kinds of a PNG's bytes (one IDAT, gray)."""
    w, h, depth = struct.unpack(">IIB", data[16:25])
    at = 33  # the first chunk after IHDR
    length, = struct.unpack(">I", data[at:at + 4])
    raw = np.frombuffer(zlib.decompress(data[at + 8:at + 8 + length]),
                        np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


def _prefetch_route():
    from panodepth_torch.utils import nativeio

    return (f"{min(8, nativeio._ncpu())} threads, {nativeio._ncpu()} CPUs "
            f"in this process's affinity")


# the analysis CLI on the card against the same call on the CPU
ANALYZE_REL = 1e-5


def _analyze_check(gt, result):
    """``python -m panodepth_torch.analyze`` (``analyze.main``) on the
    merge's output against its gt, with ``--laplacian --json`` and with
    ``--mono360 --json``, on the card and with ``--device cpu``: equal
    within ANALYZE_REL relative."""
    from panodepth_torch import analyze

    def record(*argv):
        out = stdio.StringIO()
        with contextlib.redirect_stdout(out):
            if analyze.main([gt, result, "--json", *argv]) != 0:
                raise AssertionError(f"analyze {argv} returned non-zero")
        return json.loads(out.getvalue().strip().splitlines()[-1])

    recs = {}
    for mode in (("--laplacian",), ("--mono360",)):
        t0 = time.perf_counter()
        card = record(*mode)
        card_s = time.perf_counter() - t0
        cpu = record(*mode, "--device", "cpu")
        worst = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
                    for k in cpu)
        print(f"analyze {' '.join(mode)} --json on the card ({card_s:.2f} s):"
              f" {card}; against --device cpu: largest relative difference "
              f"{worst!r} (bound {ANALYZE_REL})")
        if card.keys() != cpu.keys() or not worst <= ANALYZE_REL:
            raise AssertionError(f"analyze {mode}: card {card}, cpu {cpu}")
        recs[mode[0].lstrip("-")] = dict(card, cpu_rel=worst)
    return recs


# --- the e2e slice: GroupNorm kernel, the zoo nets, the on-device graph ---

ZOO = os.path.join(ROOT, "zoo")
PERSP_CKPT = os.path.join(ZOO, "perspective_final.params.npz")
BASE_CKPT = os.path.join(ZOO, "fastpano_final.params.npz")
GN_CALLS = 29          # GroupNorms of FastPanoNet (zoo/fastpano.config.json)
# the GroupNorm kernel against its plain version: f32 output within this
# many f32 ulps of the output's largest magnitude (at least 1) -- the two sum
# in different orders and rsqrtf is not correctly rounded; bf16 output
# within 1 bf16 step at each value's magnitude beyond that f32 bound (the
# two round f32 values that differ by it); a near-constant group (var ~ 0,
# so rsqrt(var + eps)
# ~ 1000 amplifies the sums' rounding) within GN_FLAT_ABS
GN_F32_ULPS = 16
GN_FLAT_ABS = 2.0 ** -10
# the baseline CNN through the kernel against the plain route, in 0~1: both
# are the same bf16 net, differing only by the norms' f32 sum order
BASE_ROUTE_ABS = 4e-3
# u16 output of the e2e graph through the kernels against the plain
# routes: two bf16 runs of one graph that differ by rounding only, which
# the cubic registration amplifies; set from the port-vs-JAX bf16
# difference at tests/test_torch_e2e.py's two-view layout (max 111, mean
# 17.4) before the first run on the card
E2E_ROUTE_MAX_U16 = 256
E2E_ROUTE_MEAN_U16 = 24.0
# u16 max between two bf16 graphs whose nets see other batches (the
# latency graph's 8 views a call against the batched graph's 15): the bar
# tests/test_torch_e2e.py holds bf16 graphs of another float order to;
# measured 515 and 573 on an H100 (PERF.md; the route bar's 256 was exceeded),
# the mean within E2E_ROUTE_MEAN_U16 (3.5, 5.7)
BF16_ORDER_MAX_U16 = 2048


def make_rgb(seed, width):
    """u8 RGB panorama (width/2, width, 3): smooth colour fields with
    texture and noise, made from ``seed``."""
    rng = np.random.RandomState(seed)
    ph = rng.uniform(0, 2 * math.pi, 6)

    def colour(azi, zen):
        r = (0.5 + 0.25 * np.sin(2 * azi + ph[0]) * np.sin(zen)
             + 0.15 * np.cos(3 * zen + ph[1]))
        g = (0.5 + 0.25 * np.cos(azi + ph[2]) * np.sin(2 * zen)
             + 0.1 * np.sin(5 * azi + ph[3]))
        b = (0.45 + 0.3 * np.cos(zen + ph[4])
             + 0.05 * np.sin(9 * azi + 7 * zen + ph[5]))
        return np.stack([r, g, b], -1)

    img = _equirect(width, width // 2, colour)
    img = img + rng.normal(0, 0.02, img.shape)
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def write_png_filtered(path, arr, kinds):
    """A PNG of ``arr`` (uint8 or uint16, gray (H, W) or RGB (H, W, 3))
    whose row y carries the filter ``kinds[y % len(kinds)]`` (0 None, 1
    Sub, 2 Up, 3 Average, 4 Paeth), filtered here from the specification
    (the predictors read the unfiltered bytes, so whole arrays at once),
    deflated at level 1."""
    h, w = arr.shape[:2]
    depth = 16 if arr.dtype == np.uint16 else 8
    colour = 0 if arr.ndim == 2 else 2
    bpp = (1 if arr.ndim == 2 else 3) * depth // 8
    rows = arr.astype(">u2" if depth == 16 else np.uint8).view(np.uint8)
    x = rows.reshape(h, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1}
    if 4 in kinds:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred[4] = np.where((pa <= pb) & (pa <= pc), a,
                           np.where(pb <= pc, b, c))
    ys = np.arange(h) % len(kinds)
    out = np.empty((h, x.shape[1] + 1), np.uint8)
    out[:, 0] = np.asarray(kinds, np.uint8)[ys]
    for j, k in enumerate(kinds):
        sel = ys == j
        out[sel, 1:] = ((x - pred[k])[sel] & 0xFF).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(out.tobytes(), 1))
                 + chunk(b"IEND", b""))


def write_png_rgb8(path, rgb):
    """An 8-bit RGB PNG (filter None on every row); the package writes no
    RGB PNG of its own."""
    write_png_filtered(path, rgb, (0,))


def _bf16_steps_off(got, want, f32_tol):
    """Largest |got - want| of two bf16 tensors in units of one bf16 step
    at ``want``'s magnitude, after allowing ``f32_tol`` (near 0 the bf16
    steps are finer than the f32 statistics' own error)."""
    w = want.float().abs()
    step = torch.where(w > 0, torch.exp2(torch.floor(torch.log2(w)) - 7),
                       torch.zeros_like(w))
    off = ((got.float() - want.float()).abs() - f32_tol).clamp_min(0)
    return float((off / torch.clamp_min(step, 2.0 ** -133)).max())


def fast_variance_condition(x, groups, eps=1e-6):
    """(N, G) condition number of flax's fast variance ``E[x²] - E[x]²`` on
    each (image, group) of ``x``: ``(E[x²] + E[x]²) / (var + eps)``, in f64.
    A rounding of the sums reaches the variance, and so every output,
    multiplied by it: 1 for a group centred on 0, ~100 for a smooth image
    channel whose mean is ten times its spread (the kernel and the plain
    version take exact f64 sums, so none reaches them)."""
    xg = x.reshape(x.shape[0], groups, -1).double()
    mean, mean2 = xg.mean(-1), (xg * xg).mean(-1)
    return (mean2 + mean * mean) / ((mean2 - mean * mean).clamp_min(0) + eps)


def _gn_hold(label, x, scale, bias, groups, relu, out_dtype, flat=False):
    """The GroupNorm kernel against its plain version on one input, within
    the bars above; returns the max abs difference."""
    from panodepth_torch.kernels import groupnorm as kg

    got = kg.cuda_group_norm(x, scale, bias, groups, 1e-6, relu, out_dtype)
    want = kg.group_norm_plain(x, scale, bias, groups, 1e-6, relu, out_dtype)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    if flat:
        ok, why = err <= GN_FLAT_ABS, f"max abs {err!r} <= {GN_FLAT_ABS}"
    else:
        tol = GN_F32_ULPS * 2.0 ** -23 * max(
            1.0, float(want.float().abs().max()))
        if out_dtype == torch.bfloat16:
            u = _bf16_steps_off(got, want, tol)
            ok, why = u <= 1, f"{u!r} bf16 steps <= 1"
        else:
            ok, why = err <= tol, (f"max abs {err!r} <= {tol!r} ({GN_F32_ULPS}"
                                   f" f32 ulp of the scale)")
    if not (ok and finite):
        raise AssertionError(f"groupnorm kernel disagrees with the plain "
                             f"version ({label}): {why} is "
                             f"{ok}, finite {finite}")
    return err


def _device_profile(run, attempts=3):
    """(device busy ms, kernel events sorted by device time) over ``run()``
    under torch.profiler; busy 0.0 when the profiler saw no device time in
    ``attempts`` profiles of ``run()`` (a profile that sees none is taken
    again: the profiler has come back empty while another process used
    the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        # the kernels themselves (device-side events); the CPU-side
        # operators that launched them carry the same time and are left
        # out of the sum
        events = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA),
                        key=device_us, reverse=True)
        if events:
            break
        print(f"profiler: no device records in profile {attempt + 1}")
    return sum(device_us(e) for e in events) / 1e3, [
        (device_us(e) / 1e3, e.count, e.key) for e in events]


def _pano_feed(rgb_u8, dev):
    """A u8 panorama as the CLI decodes it (k / 255 in f32), on the card."""
    return torch.tensor(rgb_u8.astype(np.float32) / np.float32(255.0),
                        device=dev)


def _norm_inputs(base, rgbs_u8):
    """(module, input) of each of FastPanoNet's norms in one forward of the
    panoramas ``rgbs_u8`` as one batch, fed as the e2e graph feeds it."""
    from panodepth_torch.models import norm as pnorm
    from panodepth_torch.ops.resize import resize_bilinear_nhwc

    dev = torch.device("cuda")
    feed = resize_bilinear_nhwc(
        torch.stack([_pano_feed(r, dev) for r in rgbs_u8]), (256, 512))
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, args[0].contiguous().clone())))
        for m in base.modules() if isinstance(m, pnorm.GroupNorm)]
    pnorm.set_route(base, "torch")
    base(feed)
    pnorm.set_route(base, "auto")
    for h in hooks:
        h.remove()
    if len(calls) != GN_CALLS:
        raise AssertionError(f"FastPanoNet ran {len(calls)} norms, "
                             f"expected {GN_CALLS}")
    return calls


def phase_groupnorm(base, rgbs_u8):
    """The kernel against its plain version on the inputs of FastPanoNet's
    29 norms at a 256x512 input, at batch 1 (the CLI's) and at batch 2
    (the e2e call's; each image also held bit-equal to itself alone), then
    the 29-call set of batch 1 timed."""
    import torch.nn.functional as F
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.models import norm as pnorm

    dev = torch.device("cuda")
    calls = _norm_inputs(base, rgbs_u8[:1])
    shapes = sorted({(int(x[0, 0].numel()), x.shape[1], m.num_groups)
                     for m, x in calls}, reverse=True)
    print(f"groupnorm: {len(calls)} calls per forward over {len(shapes)} "
          f"shapes (HW, C, G): {shapes}; inputs {calls[0][1].dtype}")
    first = {}  # the first call of each shape
    for m, x in calls:
        first.setdefault((int(x[0, 0].numel()), x.shape[1], m.num_groups),
                         (m, x))
    for (hw, c, g), (_, x) in first.items():
        for n in (1, 2):  # the CLI's batch and the e2e call's
            p = kg.plan_for(n, c, hw, g, x.element_size())
            print(f"groupnorm plan N={n} (HW, C, G)=({hw}, {c}, {g}): "
                  f"clusters of {p.cluster}, {p.blocks} blocks, slice "
                  f"{p.slice}, {p.smem_bytes} B shared"
                  f"{' (opt-in)' if p.opt_in else ''}")

    hold = _gn_hold
    max_abs = 0.0
    seen = set()
    for m, x in calls:
        key = (int(x[0, 0].numel()), x.shape[1], m.num_groups)
        # the path's own call: bf16 in, the module's output type and ReLU
        err = hold(f"{key} path", x, m.scale, m.bias, m.num_groups,
                   m.fuse_relu, m.dtype)
        max_abs = max(max_abs, err)
        if key in seen:
            continue
        seen.add(key)
        line = []
        for xin in (x, x.float()):
            for relu in (False, True):
                for od in (torch.float32, torch.bfloat16):
                    e = hold(f"{key} {xin.dtype}->{od} relu={relu}", xin,
                             m.scale, m.bias, m.num_groups, relu, od)
                    line.append(f"{e:.2e}")
        print(f"groupnorm {key}: max abs err vs plain (bf16|f32 in x "
              f"relu off|on x f32|bf16 out): {' '.join(line)}")
    # the e2e call's own inputs: both panoramas in one batch, so every plan
    # the main path launches is held; and each image of the batch normalised
    # alone gives the same bits (the plan does not depend on the batch)
    calls2 = _norm_inputs(base, rgbs_u8[:2])
    for m, x in calls2:
        key = (int(x[0, 0].numel()), x.shape[1], m.num_groups)
        err = hold(f"{key} batch {x.shape[0]} path", x, m.scale, m.bias,
                   m.num_groups, m.fuse_relu, m.dtype)
        max_abs = max(max_abs, err)
        both = kg.cuda_group_norm(x, m.scale, m.bias, m.num_groups, 1e-6,
                                  m.fuse_relu, m.dtype)
        for i in range(x.shape[0]):
            alone = kg.cuda_group_norm(x[i:i + 1].contiguous(), m.scale,
                                       m.bias, m.num_groups, 1e-6,
                                       m.fuse_relu, m.dtype)
            torch.cuda.synchronize()
            if not torch.equal(both[i:i + 1], alone):
                raise AssertionError(f"groupnorm {key}: image {i} of the "
                                     f"batch differs from itself alone")
    print(f"groupnorm: the {len(calls2)} calls of a batch-{len(rgbs_u8[:2])}"
          f" forward (the e2e call's plans) agree with the plain version, "
          f"each image bit-equal to itself at batch 1")
    rng = np.random.RandomState(SEED)
    odd = torch.tensor(rng.normal(0.3, 1.7, (3, 20, 7, 9)).astype(np.float32),
                       device=dev)
    sc = torch.tensor(rng.uniform(0.5, 2, 20).astype(np.float32), device=dev)
    bi = torch.tensor(rng.uniform(-1, 1, 20).astype(np.float32), device=dev)
    for od in (torch.float32, torch.bfloat16):
        for relu in (False, True):
            hold(f"odd (3, 20, 7, 9) G4 -> {od}", odd.to(torch.bfloat16), sc,
                 bi, 4, relu, od)
    flat = odd.clone()
    # group 0 of every image holds one value, so E[x^2] - E[x]^2 rounds to
    # about 0 either side and the clamp at 0 keeps rsqrt finite; group 1
    # of image 0 holds one large value (its x - mean is exactly 0)
    flat[:, :5] = 0.1
    flat[0, 5:10] = 1000.0
    e = hold("near-constant groups", flat, sc, bi, 4, False, torch.float32,
             flat=True)
    print(f"groupnorm: odd shape and near-constant groups pass "
          f"(near-constant max abs err {e!r}, no NaN)")

    xs32 = [x.float() for _, x in calls]

    def kernel_set():
        for m, x in calls:
            kg.cuda_group_norm(x, m.scale, m.bias, m.num_groups, 1e-6,
                               m.fuse_relu, m.dtype)

    def plain_set():
        for m, x in calls:
            kg.group_norm_plain(x, m.scale, m.bias, m.num_groups, 1e-6,
                                m.fuse_relu, m.dtype)

    def library_set():
        for (m, _), x in zip(calls, xs32):
            F.group_norm(x, m.num_groups, m.scale, m.bias, 1e-6)

    # device time per call of each shape's path call, and of a call that
    # moves next to nothing: the per-launch floor
    tiny = torch.zeros((1, 4, 1, 1), dtype=torch.bfloat16, device=dev)
    per_shape = {}
    floor_norm = pnorm.GroupNorm(4, 4).requires_grad_(False).to(dev)
    for key, (m, x) in [("floor (1, 4, 1, 1) G4", (floor_norm, tiny))] \
            + list(first.items()):
        busy, _ = _device_profile(lambda: [kg.cuda_group_norm(
            x, m.scale, m.bias, m.num_groups, 1e-6, m.fuse_relu, m.dtype)
            for _ in range(10)])
        per_shape[str(key)] = busy / 10
        print(f"groupnorm {key}: device {busy / 10 * 1e3!r} us per call "
              f"(profiler, 10 calls)")
    k_ms = _median_ms(kernel_set, runs=7, warmup=2)
    p_ms = _median_ms(plain_set, runs=5, warmup=1)
    l_ms = _median_ms(library_set, runs=7, warmup=2)
    busy_ms, events = _device_profile(kernel_set)
    lib_busy_ms, lib_events = _device_profile(library_set)
    elements = sum(x.numel() for _, x in calls)
    nbytes = sum(x.numel() * (x.element_size() + torch.empty(
        (), dtype=m.dtype).element_size()) for m, x in calls)
    ops = 8 * elements  # 3 for the sums, 5 to normalise (ReLU not counted)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    summary = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                   device_ms=busy_ms, library_device_ms=lib_busy_ms,
                   per_call_device_ms=per_shape,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   max_abs_err=max_abs, elements=elements, bytes=nbytes,
                   calls=len(calls))
    print(f"groupnorm per forward ({len(calls)} calls, {elements} elements, "
          f"{nbytes} bytes): kernel {k_ms!r} ms (device busy {busy_ms!r} ms "
          f"under the profiler), plain {p_ms!r} ms, F.group_norm {l_ms!r} ms "
          f"(device busy {lib_busy_ms!r} ms under the profiler, on f32 "
          f"copies of the inputs) (CUDA events, median of 7 / 5 / 7), bound "
          f"{summary['bound_ms']!r} ms ({summary['bound_by']})")
    for ms, count, name in events[:4] + lib_events[:4]:
        print(f"  {ms:9.4f} ms  {count:6d}  {name[:90]}")
    return summary


def phase_models(persp, base, rgb_u8):
    """Both zoo nets on a synthetic panorama: norm launches, outputs in
    0~1, the baseline of the kernel route against the plain route."""
    from panodepth_torch import MergeConfig
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.models import norm as pnorm
    from panodepth_torch.models.perspective import predict_depth01
    from panodepth_torch.ops.projection import extract_group, view_groups
    from panodepth_torch.ops.resize import resize_bilinear_nhwc

    dev = torch.device("cuda")
    rgb = _pano_feed(rgb_u8, dev)[None]
    feed = resize_bilinear_nhwc(rgb, (256, 512))
    per_call = kg.launches_per_call()
    kg.LAUNCHES = 0
    out = pnorm.set_route(base, "auto")(feed)
    torch.cuda.synchronize()
    launches = kg.LAUNCHES
    print(f"models: FastPanoNet {tuple(feed.shape)} -> {tuple(out.shape)}, "
          f"groupnorm launches {launches} (expected {GN_CALLS} x {per_call})")
    if launches != GN_CALLS * per_call:
        raise AssertionError(f"FastPanoNet launched the groupnorm kernel "
                             f"{launches} times")
    if out.shape != (1, 256, 512) or not bool(
            ((out >= 0) & (out <= 1)).all()):
        raise AssertionError("baseline CNN output is not finite 0~1 "
                             "of shape (1, 256, 512)")
    plain = pnorm.set_route(base, "torch")(feed)
    pnorm.set_route(base, "auto")
    diff = (out - plain).abs()
    print(f"models: baseline, kernel route vs plain route: max abs "
          f"{float(diff.max())!r}, mean {float(diff.mean())!r} "
          f"(bound {BASE_ROUTE_ABS})")
    if float(diff.max()) > BASE_ROUTE_ABS:
        raise AssertionError("baseline CNN: kernel route differs from the "
                             "plain route")

    layout = MergeConfig(layout_name="5fold_leres").layout
    (shape, idxs), = view_groups(layout, 256).items()
    views = extract_group(rgb, layout.fovs[idxs], shape)[0]
    views = resize_bilinear_nhwc(views, (256, 256))
    kg.LAUNCHES = 0
    depth = predict_depth01(persp, views)
    torch.cuda.synchronize()
    print(f"models: NFPerspectiveNet {tuple(views.shape)} (views {shape}) -> "
          f"{tuple(depth.shape)}, range [{float(depth.min())!r}, "
          f"{float(depth.max())!r}], groupnorm launches {kg.LAUNCHES}")
    if depth.shape != (15, 256, 256) or kg.LAUNCHES or not bool(
            ((depth >= 0) & (depth <= 1)).all()):
        raise AssertionError("perspective CNN output is not finite 0~1 of "
                             "shape (15, 256, 256), or it ran a norm")
    base_ms = _median_ms(lambda: base(feed), runs=5, warmup=1)
    persp_ms = _median_ms(lambda: predict_depth01(persp, views), runs=5,
                          warmup=1)
    print(f"models: FastPanoNet 1x256x512 {base_ms!r} ms, NFPerspectiveNet "
          f"15x256x256 with the 99th-percentile map {persp_ms!r} ms "
          f"(CUDA events, median of 5)")
    return dict(base_ms=base_ms, persp_ms=persp_ms)


def _before_repair(persp, base, rgbs, cfg):
    """The e2e chain with each net run on the whole batch, as the e2e graph
    ran before its nets ran one panorama per call: baselines, pmaps, abcd
    and output of panorama 0 at batch 2 against batch 1, and the first of
    these that differs."""
    from panodepth_torch import pipeline, registration
    from panodepth_torch.fusion import build_fusion_plan, fuse
    from panodepth_torch.models.perspective import predict_depth01
    from panodepth_torch.ops.projection import extract_group, view_groups
    from panodepth_torch.ops.resize import (resize_bilinear,
                                            resize_bilinear_nhwc)

    (shape, idxs), = view_groups(cfg.layout, 256).items()
    feed = resize_bilinear_nhwc(rgbs, (256, 512))
    views = resize_bilinear_nhwc(extract_group(
        rgbs, cfg.layout.fovs[idxs], shape).reshape(-1, *shape, 3), (256, 256))
    n = len(idxs)
    got = {}
    with pipeline.true_f32():
        for b in (2, 1):
            bases = base(feed[:b])
            pm = predict_depth01(persp, views[:b * n]).reshape(b, n, 256, 256)
            pm0 = resize_bilinear(pm[0], shape)
            abcd = registration.register_views(bases[0], pm0, cfg)
            out, _ = fuse(bases[0], pm0, build_fusion_plan(cfg), abcd=abcd)
            got[b] = dict(baselines=bases[0], pmaps=pm0, abcd=abcd, output=out)
    first, lines = None, []
    for key in ("baselines", "pmaps", "abcd", "output"):
        a, b = got[2][key].float(), got[1][key].float()
        d = float((a - b).abs().max())
        lines.append(f"{key} max |diff| {d!r}")
        if first is None and d > 0:
            first = key
    torch.cuda.synchronize()
    print(f"e2e before the repair (each net on the whole batch), panorama 0 "
          f"at batch 2 vs batch 1: {'; '.join(lines)}; first tensor that "
          f"differs: {first}")
    # what the repair costs the card: both nets on the batch of 2 against
    # one panorama per call, device busy under the profiler
    with pipeline.true_f32():
        whole, _ = _device_profile(lambda: (base(feed),
                                            predict_depth01(persp, views)))
        each, _ = _device_profile(lambda: [
            (base(feed[k:k + 1]), predict_depth01(persp, views[k * n:(k + 1)
                                                                * n]))
            for k in range(2)])
    print(f"e2e nets device busy per panorama at batch 2: each net on the "
          f"whole batch {whole / 2!r} ms, one panorama per call "
          f"{each / 2!r} ms")
    return dict(first=first, nets_busy_ms_per_pano=dict(whole=whole / 2,
                                                        each=each / 2))


# the views of each gather table on the card against the port on the CPU:
# the taps' f32 ray angles and weights differ by an ulp, and bilinear
# sampling is continuous (tests/test_torch_sampling.py: 1e-4 against JAX)
TABLE_VIEWS_ABS = 1e-4
# _percentile99's top-k forms against the sort: lo + f (hi - lo) against
# lo (1 - f) + hi f, an f32 ulp or two of the value
P99_REL = 1e-6


def _resize_ms(events):
    """Device ms and launches of the antialiased resizes in a profile."""
    hits = [(ms, n) for ms, n, name in events
            if "upsample" in name or "interp" in name or "_aa" in name]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


def _e2e_box_feed(full, rgbs_u8, want):
    """The graph with ``PANODEPTH_BASE_FEED=box`` on the u8 panoramas: a
    capture of its own beside the bilinear graph's on the same input (the
    variable is in the graph's key), its launches as the bilinear
    graph's, its replay bit-equal to its eager stages, its bf16 feed equal
    to the CPU's; both graphs timed in turns and profiled."""
    from panodepth_torch.e2e import box_feed
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj

    dev = torch.device("cuda")
    u8 = torch.stack([torch.from_numpy(r) for r in rgbs_u8]).to(dev)
    b = u8.shape[0]

    def feed(value):
        if value is None:
            os.environ.pop("PANODEPTH_BASE_FEED", None)
        else:
            os.environ["PANODEPTH_BASE_FEED"] = value

    outs, launches = {}, {}
    try:
        for name, value in (("bilinear", None), ("box", "box")):
            feed(value)
            kj.LAUNCHES = kg.LAUNCHES = 0
            outs[name] = full(u8)
            torch.cuda.synchronize()
            launches[name] = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
        eager = full.eager(u8)
        torch.cuda.synchronize()
        same = all(torch.equal(a, e) for a, e in zip(outs["box"], eager))
        card_feed = box_feed(u8, (256, 512))
        host_feed = box_feed(u8.cpu(), (256, 512))
        feed_same = torch.equal(card_feed.cpu(), host_feed)
        d = (outs["box"][0].to(torch.int32)
             - outs["bilinear"][0].to(torch.int32)).abs()
        print(f"e2e box feed: u8 {tuple(u8.shape)}; launches at the capture "
              f"{launches['box']} (the bilinear graph's on the same input "
              f"{launches['bilinear']}, expected {want}); the replay "
              f"bit-equal to the eager stages: {same}; the bf16 feed "
              f"{tuple(card_feed.shape)} on the card bit-equal to the CPU's: "
              f"{feed_same}; u16 distance from the bilinear graph (max, "
              f"mean) ({int(d.max())}, {float(d.float().mean())!r})")
        if launches["box"] != launches["bilinear"] or \
                launches["box"] != want:
            raise AssertionError(f"box-feed graph launches {launches}")
        if not same:
            raise AssertionError("the box-feed graph differs from its eager "
                                 "stages")
        if not feed_same:
            raise AssertionError("the box feed on the card differs from the "
                                 "CPU's")
        if int(d.max()) == 0:
            raise AssertionError("the box feed changed nothing: the graph "
                                 "of the bilinear feed was replayed")
        times = {}
        for name, value in (("bilinear", None), ("box", "box"),
                            ("box", "box"), ("bilinear", None)):
            feed(value)
            times.setdefault(name, []).append(_timed(lambda: full(u8)))
        found = {}
        for name, value in (("bilinear", None), ("box", "box")):
            feed(value)
            host = float(np.median(times[name]))
            busy, events = _device_profile(lambda: full(u8))
            rs_ms, rs_n = _resize_ms(events)
            found[name] = dict(ms_per_pano=host / b, turns=times[name],
                               busy_ms_per_pano=busy / b,
                               idle_share=1 - busy / host,
                               resize_ms=rs_ms, resize_launches=rs_n)
            print(f"e2e {name} feed graph (batch {b}, u8 input, in turns "
                  f"bilinear, box, box, bilinear): {host / b!r} ms a "
                  f"panorama, turns {times[name]!r}; device busy {busy!r} "
                  f"ms a call, idle share {1 - busy / host!r}; antialiased "
                  f"resizes {rs_ms!r} ms in {rs_n} launches")
    finally:
        feed(None)
    return dict(found, launches=launches["box"], u16_from_bilinear=(
        int(d.max()), float(d.float().mean())))


def _e2e_tables(rgb_u8):
    """One panorama's 15-view extraction from each gather table on the card
    against the port on the CPU, ``pair16`` bit-equal to ``packed16``, and
    each table's device ms (pack and gathers, from a CUDA graph)."""
    from panodepth_torch import MergeConfig
    from panodepth_torch.ops import projection
    from panodepth_torch.pipeline import _as01

    dev = torch.device("cuda")
    layout = MergeConfig(layout_name="5fold_leres").layout
    (shape, idxs), = projection.view_groups(layout, 256).items()
    fovs = layout.fovs[idxs]
    u8 = torch.from_numpy(rgb_u8)

    def extract(rgb, table):
        src = rgb if table in projection.PACKED else _as01(rgb)
        return projection.extract_group(projection.make_table(src, table),
                                        fovs, shape, table)

    card_u8 = u8.to(dev)
    found, views = {}, {}
    for table in ("f32", "bf16", "packed", "packed16", "pair16", "pair16d"):
        views[table] = extract(card_u8, table)
        host = extract(u8, table)
        err = float((views[table].cpu() - host).abs().max())
        ms = _graph_ms(lambda: extract(card_u8, table), reps=5, runs=5)
        found[table] = dict(ms=ms, max_abs_vs_cpu=err)
        print(f"e2e table {table}: 15 views {tuple(views[table].shape)} from "
              f"a 1024x2048 u8 panorama, {ms!r} ms on the card (pack and "
              f"gathers, CUDA graph of 5); against the CPU max abs {err!r} "
              f"(bar {TABLE_VIEWS_ABS})")
        if not err <= TABLE_VIEWS_ABS:
            raise AssertionError(f"the {table} table's views on the card "
                                 f"differ from the CPU's")
    pair_same = torch.equal(views["pair16"], views["packed16"])
    print(f"e2e table pair16 bit-equal to packed16 on the card: {pair_same}")
    if not pair_same:
        raise AssertionError("the pair16 views differ from packed16's")
    return found


def _e2e_p99(persp, rgb_u8):
    """``_percentile99`` in each ``PANODEPTH_P99`` mode on the NF net's
    output for one panorama's 15 views at 256x256: topk and approx against
    sort, and each mode's device ms."""
    from panodepth_torch import MergeConfig
    from panodepth_torch.models.perspective import _percentile99
    from panodepth_torch.ops import projection
    from panodepth_torch.ops.resize import resize_bilinear_nhwc

    dev = torch.device("cuda")
    layout = MergeConfig(layout_name="5fold_leres").layout
    (shape, idxs), = projection.view_groups(layout, 256).items()
    rgb = _pano_feed(rgb_u8, dev)[None]
    views = resize_bilinear_nhwc(projection.extract_group(
        rgb, layout.fovs[idxs], shape)[0], (256, 256))
    with torch.no_grad():
        flat = persp(views).reshape(len(idxs), -1)
    found, vals = {}, {}
    try:
        for mode in ("sort", "topk", "approx"):
            os.environ["PANODEPTH_P99"] = mode
            vals[mode] = _percentile99(flat)
            ms = _graph_ms(lambda: _percentile99(flat), reps=5, runs=5)
            rel = float(((vals[mode] - vals["sort"]).abs()
                         / vals["sort"].abs()).max())
            found[mode] = dict(ms=ms, max_rel_vs_sort=rel)
            print(f"e2e p99 {mode}: {tuple(flat.shape)} f32 -> "
                  f"{float(vals[mode].min())!r}..{float(vals[mode].max())!r}, "
                  f"{ms!r} ms on the card (CUDA graph of 5), max rel vs sort "
                  f"{rel!r} (bar {P99_REL})")
            if not rel <= P99_REL:
                raise AssertionError(f"p99 {mode} differs from the sort")
    finally:
        os.environ.pop("PANODEPTH_P99", None)
    if not torch.equal(vals["topk"], vals["approx"]):
        raise AssertionError("p99 approx differs from topk")
    return found


def phase_e2e(persp, base, rgbs_u8):
    """The main path: the batched e2e graph at full width on two panoramas,
    through both kernels and replayed from CUDA graphs, against its eager
    stages and the plain routes, batch 2 against batch 1, timed and
    profiled."""
    from panodepth_torch import MergeConfig
    from panodepth_torch.e2e import build_batched_e2e
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj

    dev = torch.device("cuda")
    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    b = len(rgbs_u8)
    rgbs = torch.stack([_pano_feed(r, dev) for r in rgbs_u8])
    build = lambda **kw: build_batched_e2e(persp, cfg, view_width=256,
                                           base_model=base, base_w=512, **kw)
    full, models_stage, fuse_stage = build()
    # one Jacobi launch sequence for the batch; one FastPanoNet forward per
    # panorama; counted at the warm-ups and the capture
    want_j = graph_launches(sum(jacobi_launches(cfg)))
    want_g = graph_launches(b * GN_CALLS * kg.launches_per_call())

    kj.LAUNCHES = kg.LAUNCHES = 0
    out, bases = full(rgbs)
    torch.cuda.synchronize()
    launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
    print(f"e2e: {b} panoramas {tuple(rgbs.shape)} -> {tuple(out.shape)} "
          f"{out.dtype}; launches {launches} at the capture (expected "
          f"jacobi {want_j}, group_norm {want_g})")
    if launches != dict(jacobi=want_j, group_norm=want_g):
        raise AssertionError(f"e2e launches {launches}")
    if out.shape != (b, 1024, 2048) or out.dtype != torch.uint16:
        raise AssertionError(f"bad e2e output {tuple(out.shape)} {out.dtype}")
    if not bool(((bases >= 0) & (bases <= 1)).all()):
        raise AssertionError("e2e baselines are not finite 0~1")
    eager, eager_bases = full.eager(rgbs)
    torch.cuda.synchronize()
    same = torch.equal(out, eager) and torch.equal(bases, eager_bases)
    print(f"e2e: the graph's output and baselines bit-equal to the eager "
          f"stages: {same}")
    if not same:
        raise AssertionError("e2e graph differs from its eager stages")

    # a graph captured while the caller's TF32 flags are on
    _hold_tf32_flags("e2e", out, lambda: build()[0](rgbs)[0])

    plain_full, _, _ = build(jacobi="torch", groupnorm="torch")
    plain, _ = plain_full.eager(rgbs)
    torch.cuda.synchronize()
    diff = (out.to(torch.int32) - plain.to(torch.int32)).abs()
    dmax, dmean = int(diff.max()), float(diff.float().mean())
    print(f"e2e: kernel routes vs plain routes, u16 max diff {dmax}, mean "
          f"{dmean!r} (bounds {E2E_ROUTE_MAX_U16}, {E2E_ROUTE_MEAN_U16})")
    if dmax > E2E_ROUTE_MAX_U16 or dmean > E2E_ROUTE_MEAN_U16:
        raise AssertionError("e2e u16 output of the kernel routes differs "
                             "from the plain routes'")

    # the CLI runs one panorama per call: each panorama at batch 1 gives
    # its batch-2 output (each net runs one panorama per call)
    singles = [full(rgbs[k:k + 1])[0][0] for k in range(b)]
    torch.cuda.synchronize()
    batch_diff = []
    for k, single in enumerate(singles):
        d1 = (out[k].to(torch.int32) - single.to(torch.int32)).abs()
        batch_diff.append((int(d1.max()), float(d1.float().mean())))
    print(f"e2e: batch 2 vs batch 1 per panorama: u16 (max, mean) "
          f"{batch_diff} (bound: max <= 1)")
    before = _before_repair(persp, base, rgbs, cfg)
    if max(d for d, _ in batch_diff) > 1:
        raise AssertionError("a panorama's e2e output depends on its batch")

    models_ms, fuse_ms, total_ms = [], [], []
    for _ in range(6):  # one warm-up, then five timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bs, pm = models_stage(rgbs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fuse_stage(bs, pm)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        models_ms.append((t1 - t0) * 1e3 / b)
        fuse_ms.append((t2 - t1) * 1e3 / b)
        total_ms.append((t2 - t0) * 1e3 / b)
    warm = {k: float(np.median(v[1:])) for k, v in
            (("models", models_ms), ("fuse", fuse_ms), ("total", total_ms))}
    print(f"e2e warm time per panorama (batch {b}, the two stage graphs, "
          f"host clock to synchronize, median of 5): models "
          f"{warm['models']!r} ms, fuse {warm['fuse']!r} ms, total "
          f"{warm['total']!r} ms; totals {total_ms[1:]!r}")
    bs, pm = models_stage(rgbs)
    stage_busy = dict(models=_device_profile(lambda: models_stage(rgbs))[0],
                      fuse=_device_profile(lambda: fuse_stage(bs, pm))[0])
    print(f"e2e device busy per panorama by stage (torch.profiler): models "
          f"{stage_busy['models'] / b!r} ms of the warm {warm['models']!r} "
          f"ms, fuse {stage_busy['fuse'] / b!r} ms of the warm "
          f"{warm['fuse']!r} ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full(rgbs)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, events = _device_profile(lambda: full(rgbs))
    kernel_ms = {}
    if busy_ms > 0:
        print(f"e2e profile of one {b}-panorama replay: device busy "
              f"{busy_ms!r} ms of the unprofiled {call_ms!r} ms (idle share "
              f"{1 - busy_ms / call_ms!r}); top device time by name "
              f"(ms, calls):")
        for ms, count, name in events[:14]:
            print(f"  {ms:9.4f} ms  {count:6d}  {name[:90]}")
        print("e2e profile, the port's own kernels in the replay (ms, "
              "launches):")
        for ms, count, name in events:
            for key, tag in (("jacobi", "jacobi_tile"),
                             ("group_norm", "gn_cluster")):
                if tag in name:
                    print(f"  {ms:9.4f} ms  {count:6d}  {name[:90]}")
                    k = kernel_ms.setdefault(key, dict(ms=0.0, launches=0))
                    k["ms"] += ms
                    k["launches"] += count
        replayed = {k: v["launches"] for k, v in kernel_ms.items()}
        want = dict(jacobi=want_j // graph_launches(1),
                    group_norm=want_g // graph_launches(1))
        print(f"e2e replay launches seen by the profiler {replayed} "
              f"(expected {want})")
        if replayed != want:
            raise AssertionError("the e2e replay did not run the kernels "
                                 "of its capture")
    else:
        print("e2e profile: the profiler saw no device time (not measured)")
    options = dict(box=_e2e_box_feed(full, rgbs_u8, launches),
                   tables=_e2e_tables(rgbs_u8[0]),
                   p99=_e2e_p99(persp, rgbs_u8[0]))
    return dict(single0=singles[0].cpu().numpy(), options=options,
                batch2=out.cpu().numpy(),
                singles=[x.cpu().numpy() for x in singles],
                bases=bases.cpu().numpy(),
                launches=launches, warm=warm, busy_ms=busy_ms,
                stage_busy_ms=stage_busy, kernel_ms=kernel_ms,
                call_ms=call_ms, route_diff=(dmax, dmean),
                batch_diff=batch_diff, before_repair=before)


def phase_cli_e2e(rgbs_u8, gt_u16, e2e):
    """``cli.main`` in model mode on RGB PNGs: the baseline CNN form and the
    baseline-file form, then resume."""
    from panodepth_torch import MergeConfig, cli, io as pio
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj

    names = [f"pano_{i:04d}" for i in range(len(rgbs_u8))]
    # the CLI's defaults: 5fold_leres at 2048
    per_pano = sum(jacobi_launches(MergeConfig()))
    gn_per_forward = GN_CALLS * kg.launches_per_call()
    with tempfile.TemporaryDirectory(prefix="panodepth_smoke_e2e_") as root:
        d = {k: os.path.join(root, k) for k in
             ("rgb", "gt", "baseline", "result_ckpt", "result_hohonet")}
        for path in d.values():
            os.makedirs(path)
        for name, rgb in zip(names, rgbs_u8):
            write_png_rgb8(os.path.join(d["rgb"], name + ".png"), rgb)
        pio.save_png16(os.path.join(d["gt"], names[0] + ".png"), gt_u16)
        for name, base in zip(names, e2e["bases"]):
            pio.save_png16(os.path.join(d["baseline"], name + ".depth.png"),
                           pio.to_uint16(base))
        head = ["0", d["rgb"], d["gt"], d["baseline"]]
        ckpt = ["--persp-ckpt", PERSP_CKPT]
        # each run builds its graphs: one capture at batch 1 serves both
        # panoramas
        forms = (("baseline CNN", d["result_ckpt"],
                  ckpt + ["--baseline-ckpt", BASE_CKPT], 1),
                 ("baseline files", d["result_hohonet"], ckpt, 0))
        for label, result, extra, forwards in forms:
            kj.LAUNCHES = kg.LAUNCHES = 0
            if cli.main(head + [result] + extra) != 0:
                raise AssertionError("cli.main returned non-zero")
            launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
            print(f"cli-e2e ({label}): launches {launches} for "
                  f"{len(names)} panoramas")
            if launches != dict(
                    jacobi=graph_launches(per_pano),
                    group_norm=graph_launches(forwards * gn_per_forward)):
                raise AssertionError(f"cli-e2e ({label}) launches "
                                     f"{launches}")
            want = [n + ".png" for n in names] + [names[0] + ".aligned.txt"]
            missing = [f for f in want
                       if not os.path.isfile(os.path.join(result, f))]
            if missing:
                raise AssertionError(f"cli-e2e ({label}) did not write "
                                     f"{missing}")
            got = pio.read_png(os.path.join(result, names[0] + ".png"))
            if got.shape != (1024, 2048) or got.dtype != np.uint16:
                raise AssertionError(f"cli-e2e output {got.shape} {got.dtype}")
            if label == "baseline CNN":
                diff = np.abs(got.astype(np.int32)
                              - e2e["single0"].astype(np.int32))
                print(f"cli-e2e: first panorama vs the in-memory graph at "
                      f"batch 1: u16 max diff {int(diff.max())}, mean "
                      f"{float(diff.mean())!r}")
                if (int(diff.max()) > E2E_ROUTE_MAX_U16
                        or float(diff.mean()) > E2E_ROUTE_MEAN_U16):
                    raise AssertionError("cli-e2e output differs from the "
                                         "in-memory graph")
        kj.LAUNCHES = kg.LAUNCHES = 0
        log = stdio.StringIO()
        with contextlib.redirect_stdout(log):
            cli.main(head + [d["result_ckpt"]] + forms[0][2])
        skips = log.getvalue().count("skip!")
        print(f"cli-e2e resume: {skips} skip! lines, launches jacobi "
              f"{kj.LAUNCHES}, group_norm {kg.LAUNCHES}")
        if skips != len(names) or kj.LAUNCHES or kg.LAUNCHES:
            raise AssertionError("model-mode resume did not skip the "
                                 "finished panoramas")


# --- the zoo's other model families ---

GN_PERSP_CKPT = os.path.join(ZOO, "gn", "perspective_final.params.npz")
# each family's checkpoint, the net it is paired with in the e2e graph (the
# GN perspective net with FastPanoNet, each baseline with the NF
# perspective net), and the GroupNorms of one forward
FAMILIES = {
    "gn_perspective": (GN_PERSP_CKPT, "fastpano", 29),
    "panoramic": (os.path.join(ZOO, "panoramic_final.params.npz"), "nf", 31),
    "hohonet": (os.path.join(ZOO, "hohonet_final.params.npz"), "nf", 18),
    "bifuse": (os.path.join(ZOO, "bifuse_final.params.npz"), "nf", 38),
    "slicenet": (os.path.join(ZOO, "slicenet_final.params.npz"), "nf", 16),
}
# a family's net (0~1 output) through the kernel against the plain route:
# the CPU tests' bf16 bar of the port against JAX, where every conv sums in
# another order (here only the norms' f32 sums do)
FAMILY_ROUTE_ABS = 1e-2


def _family_input(name, rgb01):
    """What the e2e graph feeds a family's net from one panorama (1, H, W,
    3): the 256x512 resize, or the 15 views of 5fold_leres at view width
    256, resized to 256x256."""
    from panodepth_torch import MergeConfig
    from panodepth_torch.ops.projection import extract_group, view_groups
    from panodepth_torch.ops.resize import resize_bilinear_nhwc

    if name != "gn_perspective":
        return resize_bilinear_nhwc(rgb01, (256, 512))
    layout = MergeConfig(layout_name="5fold_leres").layout
    (shape, idxs), = view_groups(layout, 256).items()
    views = extract_group(rgb01, layout.fovs[idxs], shape)[0]
    return resize_bilinear_nhwc(views, (256, 256))


def _family_forward(name, net, feed):
    """The net as the e2e graph runs it: 0~1 depth."""
    from panodepth_torch.models.perspective import predict_depth01

    return predict_depth01(net, feed) if name == "gn_perspective" \
        else net(feed)


def _family_norm_calls(name, net, feed):
    """(module, input) of every GroupNorm call of one forward on ``feed``."""
    from panodepth_torch.models import norm as pnorm

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, args[0].contiguous().clone())))
        for m in net.modules() if isinstance(m, pnorm.GroupNorm)]
    pnorm.set_route(net, "torch")
    _family_forward(name, net, feed)
    pnorm.set_route(net, "auto")
    for h in hooks:
        h.remove()
    return calls


def _family_groupnorm(name, net, feed, count):
    """Every GroupNorm call of one forward held against the plain version,
    each image of a multi-image call bit-equal to itself alone; the calls
    timed as a set (kernel, plain, ``F.group_norm``) with their bound."""
    import torch.nn.functional as F
    from panodepth_torch.kernels import groupnorm as kg

    calls = _family_norm_calls(name, net, feed)
    if len(calls) != count:
        raise AssertionError(f"{name} ran {len(calls)} norms, expected "
                             f"{count}")
    shapes = sorted({(x.shape[0], x.shape[1], int(x[0, 0].numel()),
                      m.num_groups) for m, x in calls})
    max_abs, cond, seen = 0.0, 1.0, set()
    for m, x in calls:
        key = (x.shape[0], x.shape[1], int(x[0, 0].numel()), m.num_groups)
        max_abs = max(max_abs, _gn_hold(f"{name} {key}", x, m.scale, m.bias,
                                        m.num_groups, m.fuse_relu, m.dtype))
        cond = max(cond, float(fast_variance_condition(x, m.num_groups).max()))
        if x.shape[0] == 1 or key in seen:
            continue
        seen.add(key)
        both = kg.cuda_group_norm(x, m.scale, m.bias, m.num_groups, 1e-6,
                                  m.fuse_relu, m.dtype)
        for i in range(x.shape[0]):
            alone = kg.cuda_group_norm(x[i:i + 1].contiguous(), m.scale,
                                       m.bias, m.num_groups, 1e-6,
                                       m.fuse_relu, m.dtype)
            torch.cuda.synchronize()
            if not torch.equal(both[i:i + 1], alone):
                raise AssertionError(f"groupnorm {name} {key}: image {i} "
                                     f"differs from itself alone")
    xs32 = [x.float() for _, x in calls]

    def kernel_set():
        for m, x in calls:
            kg.cuda_group_norm(x, m.scale, m.bias, m.num_groups, 1e-6,
                               m.fuse_relu, m.dtype)

    def plain_set():
        for m, x in calls:
            kg.group_norm_plain(x, m.scale, m.bias, m.num_groups, 1e-6,
                                m.fuse_relu, m.dtype)

    def library_set():
        for (m, _), x in zip(calls, xs32):
            F.group_norm(x, m.num_groups, m.scale, m.bias, 1e-6)

    k_ms = _median_ms(kernel_set, runs=7, warmup=2)
    p_ms = _median_ms(plain_set, runs=5, warmup=1)
    l_ms = _median_ms(library_set, runs=7, warmup=2)
    busy_ms, _ = _device_profile(kernel_set)
    lib_busy_ms, _ = _device_profile(library_set)
    elements = sum(x.numel() for _, x in calls)
    nbytes = sum(x.numel() * (x.element_size() + torch.empty(
        (), dtype=m.dtype).element_size()) for m, x in calls)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 8 * elements / PEAK_F32_FLOPS * 1e3
    print(f"families {name}: {len(calls)} groupnorm calls per forward over "
          f"{len(shapes)} shapes (N, C, HW, G) {shapes}; kernel vs plain max "
          f"abs {max_abs!r} (largest condition of a group's fast variance "
          f"{cond!r}), every image of a multi-image call bit-equal to "
          f"itself alone; per forward ({elements} elements, {nbytes} bytes): "
          f"kernel {k_ms!r} ms (device {busy_ms!r} ms), plain {p_ms!r} ms, "
          f"F.group_norm {l_ms!r} ms (device {lib_busy_ms!r} ms, f32 copies), "
          f"bound {max(bytes_ms, ops_ms)!r} ms "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    return dict(calls=len(calls), shapes=shapes, max_abs_err=max_abs,
                max_condition=cond,
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, device_ms=busy_ms,
                library_device_ms=lib_busy_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _family_e2e(name, persp, base, rgbs, replay_count=True,
                route_bar=(E2E_ROUTE_MAX_U16, E2E_ROUTE_MEAN_U16),
                keep=False):
    """The e2e graph at full width with the family's pair, batch 2: launches
    counted at the capture, graph bit-equal to eager, kernel routes against
    plain routes (within ``route_bar``), batch 2 against batch 1, warm
    time and idle share; with ``replay_count`` the profiler must see every
    GroupNorm (and int8 conv) launch of a replay (without it the count is
    printed: phase train's graph on freshly trained weights read 57 of 58
    in most profiles, with its launches at the capture exact).  ``keep``
    adds the graph and its u16 output to the returned numbers."""
    from panodepth_torch import MergeConfig
    from panodepth_torch.e2e import build_batched_e2e
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj
    from panodepth_torch.kernels import qconv as kq
    from panodepth_torch.models import norm as pnorm
    from panodepth_torch.models.quantize import qconvs as qconvs_of

    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    b = rgbs.shape[0]
    norms = sum(isinstance(m, pnorm.GroupNorm) for net in (persp, base)
                for m in net.modules())
    qconvs = len(qconvs_of(persp))
    build = lambda **kw: build_batched_e2e(persp, cfg, view_width=256,
                                           base_model=base, base_w=512, **kw)
    full, _, _ = build()
    want = dict(jacobi=graph_launches(sum(jacobi_launches(cfg))),
                group_norm=graph_launches(b * norms * kg.launches_per_call()),
                qconv=graph_launches(b * qconvs),
                quantize=graph_launches(b * qconvs * kq.QUANTIZE_KERNELS))
    kj.LAUNCHES = kg.LAUNCHES = kq.LAUNCHES = kq.QUANTIZE_LAUNCHES = 0
    out, bases = full(rgbs)
    torch.cuda.synchronize()
    launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES,
                    qconv=kq.LAUNCHES, quantize=kq.QUANTIZE_LAUNCHES)
    if launches != want:
        raise AssertionError(f"families {name} e2e launches {launches}, "
                             f"expected {want}")
    if out.shape != (b, 1024, 2048) or out.dtype != torch.uint16 or not bool(
            ((bases >= 0) & (bases <= 1)).all()):
        raise AssertionError(f"families {name}: bad e2e output")
    eager, eager_bases = full.eager(rgbs)
    torch.cuda.synchronize()
    if not (torch.equal(out, eager) and torch.equal(bases, eager_bases)):
        raise AssertionError(f"families {name}: e2e graph differs from its "
                             f"eager stages")
    plain, _ = build(jacobi="torch", groupnorm="torch",
                     qconv="torch")[0].eager(rgbs)
    diff = (out.to(torch.int32) - plain.to(torch.int32)).abs()
    route = (int(diff.max()), float(diff.float().mean()))
    if route[0] > route_bar[0] or route[1] > route_bar[1]:
        raise AssertionError(f"families {name}: kernel routes vs plain "
                             f"routes {route}")
    batch_diff = []
    for k in range(b):
        d1 = (out[k].to(torch.int32)
              - full(rgbs[k:k + 1])[0][0].to(torch.int32)).abs()
        batch_diff.append((int(d1.max()), float(d1.float().mean())))
    if max(d for d, _ in batch_diff) > 1:
        raise AssertionError(f"families {name}: a panorama's output depends "
                             f"on its batch: {batch_diff}")
    times = []
    for _ in range(6):  # one warm-up, then five timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full(rgbs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    call_ms = float(np.median(times[1:]))
    want_seen = (b * norms, b * qconvs, b * qconvs * kq.QUANTIZE_KERNELS)
    # the profiler drops records while another process works on the card
    # (an export child may, PERF.md section 7): a replay whose profile
    # counts fewer launches is profiled again, up to three times, and
    # every profile that fell short is printed
    for attempt in range(3):
        busy_ms, events = _device_profile(lambda: full(rgbs))
        gn_seen = sum(n for _, n, key in events if "gn_cluster" in key)
        q_seen = sum(n for _, n, key in events if "qconv_kernel" in key)
        qz_seen = sum(n for _, n, key in events if "quantize_kernel" in key)
        if not (replay_count and busy_ms > 0) or (
                gn_seen, q_seen, qz_seen) == want_seen:
            break
        print(f"families {name}: profile {attempt + 1} of the replay saw "
              f"{(gn_seen, q_seen, qz_seen)} launches, expected {want_seen}")
    gn_ms = sum(ms for ms, _, key in events if "gn_cluster" in key)
    q_ms = sum(ms for ms, _, key in events if "qconv_kernel" in key)
    qz_ms = sum(ms for ms, _, key in events if "quantize_kernel" in key)
    if replay_count and busy_ms > 0 and (gn_seen, q_seen,
                                         qz_seen) != want_seen:
        raise AssertionError(f"families {name}: the replay ran {gn_seen} "
                             f"groupnorm, {q_seen} qconv and {qz_seen} "
                             f"quantize launches, expected {b * norms}, "
                             f"{b * qconvs} and "
                             f"{b * qconvs * kq.QUANTIZE_KERNELS}")
    idle = 1 - busy_ms / call_ms if busy_ms > 0 else None
    print(f"families {name} e2e (batch {b}, {norms} norms"
          + (f" and {qconvs} int8 convs" if qconvs else "")
          + f" a panorama): "
          f"launches {launches} at the capture; graph bit-equal to eager; "
          f"kernel vs plain routes u16 (max, mean) {route} (bounds "
          f"{route_bar}); batch 2 vs batch 1 "
          f"{batch_diff}; graph {call_ms / b!r} ms a panorama (host clock, "
          f"median of 5), device busy {busy_ms!r} of {call_ms!r} ms a call "
          f"(idle share {idle!r}), groupnorm {gn_ms!r} ms in {gn_seen} "
          f"launches" + (f", qconv {q_ms!r} ms in {q_seen} launches, "
                         f"quantize {qz_ms!r} ms in {qz_seen} launches"
                         if qconvs else "")
          + "; top device time by name (ms, calls):")
    for ms, count, key in events[:8]:
        print(f"  {ms:9.4f} ms  {count:6d}  {key[:90]}")
    return dict(launches=launches, route_diff=route, batch_diff=batch_diff,
                ms_per_pano=call_ms / b, call_ms=call_ms, busy_ms=busy_ms,
                idle_share=idle, groupnorm_graph_ms=gn_ms,
                qconv_graph_ms=q_ms, quantize_graph_ms=qz_ms,
                norms_per_pano=norms,
                qconvs_per_pano=qconvs,
                **(dict(graph=full, out=out) if keep else {}))


# --- the int8 perspective graph (the GN net quantized, the qconv kernel) ---

GN_INT8_QCONVS = 39    # int8 convs a forward: every conv of the GN net but
                       # its f32 head (perspective.py:80-200)
INT8_REL_BAR = 0.12    # the int8 net against the float one, relative RMS
                       # (JAX's bar, tests/test_quantize.py:68)
PEAK_INT8_OPS = 1979e12  # int8 tensor cores, dense (H100 SXM, 700 W)


def _graph_ms(fn, reps=10, runs=5):
    """Device ms of one ``fn()``: ``reps`` calls captured in a CUDA graph
    and the graph replayed between CUDA events (median of ``runs``), so
    that the host's time to launch is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _median_ms(graph.replay, runs, 1) / reps


def _qconv_calls(net, feed):
    """(module, input) of every QConv call of one forward on ``feed``."""
    from panodepth_torch.models.quantize import qconvs

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, args[0].clone())))
        for m in qconvs(net)]
    with torch.no_grad():
        net(feed)
    for h in hooks:
        h.remove()
    return calls


def _qconv_args(m, x):
    """The kernel's arguments for the QConv ``m`` on its input ``x``: the
    quantization pass as the layer runs it."""
    from panodepth_torch.kernels import qconv as kq
    from panodepth_torch.models.layers import same_pads

    kh, kw = m.kernel_q.shape[2:]
    pads = (same_pads(x.shape[2], kh, m.strides[0]),
            same_pads(x.shape[3], kw, m.strides[1]))
    xq, sx = kq.quantize_nhwc_plain(x)
    return (xq, m.weight(), sx, m.scale, m.bias, (kh, kw), m.strides, pads,
            m.dtype)


def _qconv_library(args):
    """(run, check) of the library yardstick on one call's codes: ``F.unfold``
    (in f16, exact for int8 codes) to an int8 (M, K) matrix, then
    ``torch._int_mm`` (cuBLASLt), the int32 sums back in NCHW."""
    import torch.nn.functional as F

    xq, wq, _, _, _, (kh, kw), strides, pads = args[:8]
    n, h, w, cinp = xq.shape
    cout = wq.shape[0]
    wk = wq[:, :kh * kw * cinp].reshape(cout, kh, kw, cinp).permute(
        0, 3, 1, 2).reshape(cout, -1).contiguous()
    (t, b), (l, r) = pads
    x16 = F.pad(xq.permute(0, 3, 1, 2).to(torch.float16), (l, r, t, b))
    ho = (h + t + b - kh) // strides[0] + 1
    wo = (w + l + r - kw) // strides[1] + 1

    def run():
        cols = F.unfold(x16, (kh, kw), stride=strides)
        a = cols.transpose(1, 2).reshape(-1, wk.shape[1]).to(torch.int8)
        return torch._int_mm(a, wk.t())

    def sums():
        return run().view(n, ho * wo, cout).permute(0, 2, 1).reshape(
            n, cout, ho, wo)

    return run, sums


def _qconv_bf16_conv(m, x):
    """The bf16 ``F.conv2d`` of the same shape (the float graph's conv, on
    its padded input): the other yardstick."""
    import torch.nn.functional as F
    from panodepth_torch.models.layers import same_pads

    kh, kw = m.kernel_q.shape[2:]
    (t, b), (l, r) = (same_pads(x.shape[2], kh, m.strides[0]),
                      same_pads(x.shape[3], kw, m.strides[1]))
    xp = F.pad(x.to(torch.bfloat16), (l, r, t, b))
    w = (m.kernel_q.float() * m.scale[:, None, None, None]).to(torch.bfloat16)
    return lambda: F.conv2d(xp, w, stride=m.strides)


# the quantization kernel's edge inputs (name, (N, C, H, W), dtype): N = 1
# with C = 3, C = 40, 7x11 pixels (rows TMA refuses), a view 4 bytes off
# its alignment, a NaN in one image of three, a 512-view's decoder input
# (the L2 path); every input of three images or more has an all-zero
# image and one on exact rounding ties (_quantize_edge_input)
QUANTIZE_EDGES = (
    ("n1_c3", (1, 3, 256, 256), "float32"),
    ("c40", (3, 40, 64, 64), "bfloat16"),
    ("px7x11_bf16", (3, 64, 7, 11), "bfloat16"),
    ("px7x11_f32", (3, 64, 7, 11), "float32"),
    ("offset4", (3, 128, 32, 32), "float32"),
    ("nan", (3, 128, 16, 16), "float32"),
    ("l2_path", (2, 64, 512, 512), "bfloat16"))


def _quantize_edge_input(name, shape, dtype):
    """An edge input made with numpy from SEED: images at scales 1e-3 ..
    1e3; with three images or more, image 1 all zero (sx = 1e-8 / 127) and
    image 2 on exact ties ((k + 0.5) / 8 under amax 127 / 8, -0.0 among
    them); ``nan``: one NaN in image 1; ``offset4``: a view 4 bytes into
    its storage."""
    n, c, h, w = shape
    rng = np.random.RandomState(SEED + c + h)
    x = rng.normal(0, 1, shape) * 10.0 ** rng.uniform(-3, 3, (n, 1, 1, 1))
    if n > 2:
        x[1] = 0.0
        ties = (rng.randint(-127, 127, (c, h, w)) + 0.5) / 8
        ties.flat[0] = 127 / 8
        ties.flat[1::5] = -0.0
        x[2] = ties
    if name == "nan":
        x[1, c // 2, 0, 1] = np.nan
    t = torch.tensor(x.astype(np.float32), device="cuda").to(
        getattr(torch, dtype))
    if name == "offset4":
        step = 4 // t.element_size()
        flat = torch.zeros(t.numel() + 8, dtype=t.dtype, device="cuda")
        t = flat[step:step + t.numel()].view(t.shape).copy_(t)
    return t


def _quantize_plan_of(x):
    from panodepth_torch.kernels import qconv as kq

    return kq.quantize_plan(*x.shape[:2], x[0, 0].numel(), x.dtype,
                            x.data_ptr() % 16 == 0, kq._sms(x.device))


def _plan_text(p):
    return (f"plan {'TMA' if p.tma else 'plain loads'}, tiles {p.tc} ch x "
            f"{p.nb} x {p.bw} px, {p.tiles} an image, k {p.k}, {p.ipw} "
            f"images a wave x {p.spi} blocks, {p.waves} waves, "
            f"{p.blocks_per_sm} blocks an SM, stage {p.stage_bytes} B")


def _quantize_edges():
    """The kernel on QUANTIZE_EDGES: one launch each; codes and scales
    bit-equal to the plain pass's, but for an image holding a NaN: its
    scale NaN as the plain pass's, its real channels' codes -127
    (fmaxf(NaN, -127); the plain pass casts NaN), its padding 0."""
    from panodepth_torch.kernels import qconv as kq

    out = []
    for name, shape, dtype in QUANTIZE_EDGES:
        x = _quantize_edge_input(name, shape, dtype)
        plan = _quantize_plan_of(x)
        before = kq.QUANTIZE_LAUNCHES
        q, sx = kq.cuda_quantize_nhwc(x)
        torch.cuda.synchronize()
        launches = kq.QUANTIZE_LAUNCHES - before
        want_q, want_sx = kq.quantize_nhwc_plain(x)
        bad = torch.isnan(x.float()).flatten(1).any(1)
        ok = ~bad
        c = shape[1]
        same = (q.shape == want_q.shape
                and torch.equal(torch.isnan(sx), bad)
                and torch.equal(sx[ok].view(torch.int32),
                                want_sx[ok].view(torch.int32))
                and torch.equal(q[ok], want_q[ok])
                and bool((q[bad][..., :c] == -127).all())
                and not bool(q[bad][..., c:].any()))
        print(f"int8 quantize edge {name} {shape} {dtype}"
              f"{' at a 4-byte offset' if x.data_ptr() % 16 else ''}: "
              f"{_plan_text(plan)}; {launches} launch; codes and scales "
              f"bit-equal to the plain pass's"
              + (f" but image(s) {bad.nonzero().flatten().tolist()} with a "
                 f"NaN: scale NaN, codes -127" if bool(bad.any()) else "")
              + (": OK" if same else ": DIFFER"))
        if not same or launches != 1 or plan.l2 != (name == "l2_path"):
            raise AssertionError(f"quantize edge {name}: kernel and plain "
                                 f"differ, {launches} launches, or the L2 "
                                 f"path {plan.l2}")
        out.append(dict(name=name, shape=list(shape), dtype=dtype,
                        tma=plan.tma, l2=plan.l2, launches=launches))
    return out


def _quantize_hold(calls):
    """The activation's quantization ahead of each int8 conv of one
    forward (``calls``: (QConv, input) pairs): the kernel's codes and
    scales bit-equal to the plain twin's on all of them, one launch each;
    each distinct input shape (with its plan) and the set timed from CUDA
    graphs (kernel, plain pass) beside the bound (bytes: each input read
    once, the codes and scales written); then the edge inputs
    (:func:`_quantize_edges`)."""
    from panodepth_torch.kernels import qconv as kq

    shapes, rows, kern, plain = {}, [], [], []
    total_bytes, max_abs = 0, 0
    before = kq.QUANTIZE_LAUNCHES
    for _, x in calls:
        q, sx = kq.cuda_quantize_nhwc(x)
        want_q, want_sx = kq.quantize_nhwc_plain(x)
        code_err = int((q.int() - want_q.int()).abs().max())
        sx_bits = int((sx.view(torch.int32) != want_sx.view(torch.int32))
                      .sum())
        if q.shape != want_q.shape or code_err or sx_bits:
            raise AssertionError(
                f"quantize: kernel and plain differ at {tuple(x.shape)} "
                f"{x.dtype}: codes max abs {code_err}, {sx_bits} scales "
                f"differ in their bits")
        max_abs = max(max_abs, code_err)
        # the bytes the function needs: the input read once, one code
        # written per real element (not the stem's padding of 3 channels
        # to 16), the scales
        nbytes = (x.numel() * x.element_size() + x.numel()
                  + sx.numel() * sx.element_size())
        total_bytes += nbytes
        kern.append(lambda x=x: kq.cuda_quantize_nhwc(x))
        plain.append(lambda x=x: kq.quantize_nhwc_plain(x))
        key = (*x.shape, str(x.dtype).replace("torch.", ""))
        shapes[key] = shapes.get(key, 0) + 1
        if shapes[key] == 1:
            rows.append((key, len(kern) - 1, nbytes))
    launches = kq.QUANTIZE_LAUNCHES - before
    if launches != len(calls) * kq.QUANTIZE_KERNELS:
        raise AssertionError(f"quantize: {launches} launches for "
                             f"{len(calls)} calls")
    table = []
    for key, i, nbytes in rows:
        t = dict(kernel=_graph_ms(kern[i], 5, 3),
                 plain=_graph_ms(plain[i], 5, 3))
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        plan = _quantize_plan_of(calls[i][1])
        table.append(dict(shape=key, calls=shapes[key], bytes=nbytes,
                          bound_ms=bound, kernel_ms=t["kernel"],
                          plain_ms=t["plain"],
                          plan=[plan.tc, plan.bw, plan.nb, plan.k, plan.ipw,
                                plan.spi, plan.blocks_per_sm]))
        print(f"int8 quantize (N, C, H, W, dtype) {key} x{shapes[key]}: "
              f"kernel {t['kernel']!r} ms, plain {t['plain']!r} ms, bound "
              f"{bound!r} ms ({nbytes / 1e6:.3f} MB); {_plan_text(plan)}")
    per_set = dict(kernel=_graph_ms(lambda: [f() for f in kern], reps=1),
                   plain=_graph_ms(lambda: [f() for f in plain], reps=1))
    bound = total_bytes / PEAK_BYTES_PER_S * 1e3
    print(f"int8 quantize: {len(calls)} calls a forward over {len(rows)} "
          f"shapes in {launches} launches, codes and scales bit-equal to "
          f"the plain pass's; the set ({total_bytes / 1e6:.1f} MB): kernel "
          f"{per_set['kernel']!r} ms, plain {per_set['plain']!r} ms from "
          f"CUDA graphs, bound {bound!r} ms (bytes)")
    edges = _quantize_edges()
    return dict(calls=len(calls), shapes=table, max_abs_err=float(max_abs),
                ms=per_set["kernel"], plain_ms=per_set["plain"],
                bound_ms=bound, bound_by="bytes", bytes=total_bytes,
                launches_per_call=kq.QUANTIZE_KERNELS, edges=edges)


def _qconv_hold(net, feed):
    """Every int8 conv of one forward of the int8 GN net on ``feed`` (the
    15 views of a panorama at 256x256, real activations of the zoo
    weights): the kernel's int32 sums and bf16 output bit-equal to the
    plain twin's and the sums to the library's; each distinct shape timed
    (kernel, plain, ``F.unfold`` + ``torch._int_mm``, the bf16
    ``F.conv2d``; all but the plain twin from CUDA graphs, the device's
    time) with its bound and its launch plan, then the 39 calls as a set;
    then the quantization ahead of each (:func:`_quantize_hold`)."""
    from panodepth_torch.kernels import qconv as kq

    calls = _qconv_calls(net, feed)
    if len(calls) != GN_INT8_QCONVS:
        raise AssertionError(f"int8: {len(calls)} qconv calls a forward, "
                             f"expected {GN_INT8_QCONVS}")
    max_abs, shapes, rows = 0.0, {}, []
    total_ops = total_bytes = 0
    sets = dict(kernel=[], plain=[], library=[], bf16_conv=[])
    for m, x in calls:
        args = _qconv_args(m, x)
        with torch.no_grad():
            y, acc = kq.cuda_qconv_sums(*args)
            want = kq.qconv_plain(*args)
            want_acc = kq.qconv_sums_plain(*args[:2], *args[5:8])
            lib_run, lib_sums = _qconv_library(args)
            lib_acc = lib_sums()
        torch.cuda.synchronize()
        if not (torch.equal(acc, want_acc) and torch.equal(lib_acc, acc)):
            raise AssertionError(f"int8: qconv sums differ at "
                                 f"{tuple(x.shape)} {m.kernel_q.shape}")
        max_abs = max(max_abs, float((y.float() - want.float()).abs().max()))
        n, h, w, cinp = args[0].shape
        cout, cin, kh, kw = m.kernel_q.shape
        ho, wo = y.shape[2:]
        ops = 2 * n * ho * wo * cout * kh * kw * cin
        # the bytes the conv needs: the codes and weight codes at their
        # own channel count (not the kernel's padding of the stem's 3 to
        # 16, nor K's to the tile), the scales, the bias, the output
        nbytes = (n * h * w * cin + cout * kh * kw * cin
                  + sum(t.numel() * t.element_size() for t in
                        (args[2], args[3], args[4]) if t is not None)
                  + y.numel() * y.element_size())
        total_ops += ops
        total_bytes += nbytes
        sets["kernel"].append(lambda a=args: kq.cuda_qconv(*a))
        sets["plain"].append(lambda a=args: kq.qconv_plain(*a))
        sets["library"].append(lib_run)
        sets["bf16_conv"].append(_qconv_bf16_conv(m, x))
        key = (n, h, w, cin, cout, kh, m.strides[0])
        shapes[key] = shapes.get(key, 0) + 1
        if shapes[key] == 1:
            plan = kq.qconv_plan(n, h, w, cinp, cout, kh, kw, *m.strides,
                                 args[7])
            rows.append((key, len(sets["kernel"]) - 1, ops, nbytes,
                         dict(bn=plan.bn, stages=plan.stages,
                              splits=plan.splits, blocks=plan.blocks)))
    if max_abs != 0.0:
        raise AssertionError(f"int8: qconv kernel vs plain max abs {max_abs}")
    table = []
    with torch.no_grad():
        for key, i, ops, nbytes, plan in rows:
            t = dict(kernel=_graph_ms(sets["kernel"][i], 5, 3),
                     plain=_median_ms(sets["plain"][i], 2, 1),
                     library=_graph_ms(sets["library"][i], 5, 3),
                     bf16_conv=_graph_ms(sets["bf16_conv"][i], 5, 3))
            bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S) * 1e3
            table.append(dict(shape=key, calls=shapes[key], ops=ops,
                              bytes=nbytes, bound_ms=bound, plan=plan, **{
                                  f"{k}_ms": v for k, v in t.items()}))
            print(f"int8 qconv (N, H, W, Cin, Cout, k, stride) {key} x"
                  f"{shapes[key]}, plan {plan}: kernel {t['kernel']!r} ms, "
                  f"plain "
                  f"{t['plain']!r} ms, unfold + _int_mm {t['library']!r} ms, "
                  f"bf16 F.conv2d {t['bf16_conv']!r} ms, bound {bound!r} ms "
                  f"({ops / 1e9:.3f} G int8 ops, {nbytes / 1e6:.3f} MB)")
        run_all = {k: (lambda fns=fns: [f() for f in fns])
                   for k, fns in sets.items()}
        per_set = {k: _median_ms(run, 2, 1) if k == "plain"
                   else _graph_ms(run, reps=1) for k, run in run_all.items()}
        host_ms = _median_ms(run_all["kernel"], 5, 1)
        busy_ms, _ = _device_profile(lambda: [f() for f in sets["kernel"]])
    ops_ms = total_ops / PEAK_INT8_OPS * 1e3
    bytes_ms = total_bytes / PEAK_BYTES_PER_S * 1e3
    print(f"int8 qconv: {len(calls)} calls a forward over {len(rows)} "
          f"shapes, kernel vs plain (sums and bf16 output) max abs "
          f"{max_abs!r}, sums equal to unfold + _int_mm's; the set "
          f"({total_ops / 1e12:.4f} T int8 ops, {total_bytes / 1e6:.1f} MB): "
          f"kernel {per_set['kernel']!r} ms from a CUDA graph (eager "
          f"{host_ms!r} ms host-timed, device busy {busy_ms!r} ms), plain "
          f"{per_set['plain']!r} ms, unfold + _int_mm "
          f"{per_set['library']!r} ms, bf16 F.conv2d "
          f"{per_set['bf16_conv']!r} ms, bound {max(ops_ms, bytes_ms)!r} ms "
          f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
    with torch.no_grad():
        quantize = _quantize_hold(calls)
    return dict(calls=len(calls), shapes=table, max_abs_err=max_abs,
                ms=per_set["kernel"], device_ms=busy_ms, eager_ms=host_ms,
                plain_ms=per_set["plain"], library_ms=per_set["library"],
                bf16_conv_ms=per_set["bf16_conv"],
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops=total_ops, bytes=total_bytes, quantize=quantize)


def _int8_e2e(gn_net, base, rgbs, feed, gn_e2e):
    """The int8 graph of the zoo GN perspective net: its convs against the
    plain twin (:func:`_qconv_hold`), the net's output against the float
    net's (relative RMS under JAX's bar), then the e2e graph beside
    FastPanoNet at batch 2 (``_family_e2e``'s checks, the kernel routes
    equal to the plain routes), its u16 distance from the bf16 GN graph's
    (``gn_e2e``) and both timed in turns."""
    from panodepth_torch.e2e import load_model_checkpoint
    from panodepth_torch.models.quantize import int8_param_bytes

    int8_net, _ = load_model_checkpoint(GN_PERSP_CKPT, quantize=True)
    held = _qconv_hold(int8_net, feed)
    with torch.no_grad():
        y8 = int8_net(feed).float()
        yf = gn_net(feed).float()
    rel = float(torch.sqrt(torch.mean((y8 - yf) ** 2))
                / torch.sqrt(torch.mean(yf ** 2)))
    print(f"int8 net: output against the bf16 GN net on the 15 views, "
          f"relative RMS {rel!r} (bar {INT8_REL_BAR}); parameters "
          f"{int8_param_bytes(int8_net)} bytes against "
          f"{sum(p.numel() * p.element_size() for p in gn_net.parameters())}")
    if not rel < INT8_REL_BAR:
        raise AssertionError(f"int8 net: relative RMS {rel}")
    e2e = _family_e2e("gn_int8", int8_net, base, rgbs, route_bar=(0, 0.0),
                      keep=True)
    d = (e2e.pop("out").to(torch.int32)
         - gn_e2e["out"].to(torch.int32)).abs()
    vs_bf16 = (int(d.max()), float(d.float().mean()))
    runs = dict(bf16=lambda: gn_e2e["graph"](rgbs),
                int8=lambda: e2e["graph"](rgbs))
    turns = {"bf16": [], "int8": []}
    for form in ("bf16", "int8", "int8", "bf16"):
        turns[form].append(_timed(runs[form]))
    ab = {}
    for form, run in runs.items():
        host = float(np.median(turns[form]))
        busy, _ = _device_profile(run)
        ab[form] = dict(ms_per_pano=host / 2, turns=turns[form],
                        busy_ms_per_pano=busy / 2,
                        idle_share=(1 - busy / host) if busy > 0 else None)
    print(f"int8 e2e: u16 (max, mean) against the bf16 GN graph {vs_bf16}; "
          f"in turns (bf16, int8, int8, bf16): bf16 {ab['bf16']!r}, int8 "
          f"{ab['int8']!r} (ms a panorama, host clock to synchronize, "
          f"median; device busy ms a panorama; idle share)")
    # the graph stays for phase families' CLI check (popped there)
    return dict(qconv=held, net_rel_rms=rel, e2e=e2e, vs_bf16_u16=vs_bf16,
                ab=ab, graph=e2e.pop("graph"))


def phase_families(persp, base, rgbs_u8):
    """Each of the zoo's other checkpoints at full width: its GroupNorm
    calls against the plain version, the net through the kernel against
    the plain route, then the e2e graph with it (batch 2)."""
    from panodepth_torch.e2e import load_model_checkpoint
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.models import norm as pnorm

    dev = torch.device("cuda")
    rgbs = torch.stack([_pano_feed(r, dev) for r in rgbs_u8])
    out = {}
    for name, (ckpt, pair, count) in FAMILIES.items():
        net, _ = load_model_checkpoint(ckpt)
        feed = _family_input(name, rgbs[:1])
        gn = _family_groupnorm(name, net, feed, count)
        kg.LAUNCHES = 0
        got = _family_forward(name, pnorm.set_route(net, "auto"), feed)
        torch.cuda.synchronize()
        launches = kg.LAUNCHES
        plain = _family_forward(name, pnorm.set_route(net, "torch"), feed)
        pnorm.set_route(net, "auto")
        diff = float((got - plain).abs().max())
        print(f"families {name}: net {tuple(feed.shape)} -> "
              f"{tuple(got.shape)}, {launches} groupnorm launches; kernel "
              f"route vs plain route max abs {diff!r} (bound "
              f"{FAMILY_ROUTE_ABS})")
        if launches != count * kg.launches_per_call() or not bool(
                ((got >= 0) & (got <= 1)).all()) or diff > FAMILY_ROUTE_ABS:
            raise AssertionError(f"families {name}: net check failed")
        pair_persp, pair_base = (net, base) if pair == "fastpano" \
            else (persp, net)
        e2e = _family_e2e(name, pair_persp, pair_base, rgbs,
                          keep=name == "gn_perspective")
        if name == "gn_perspective":
            out["gn_int8"] = _int8_e2e(net, base, rgbs, feed, e2e)
            del e2e["graph"], e2e["out"]
        out[name] = dict(groupnorm=gn, net_route_abs=diff, e2e=e2e)
        del net
        torch.cuda.empty_cache()
    return out


def phase_families_cli(rgbs_u8, int8_graph):
    """The model-mode CLI with the BiFuse baseline and the GN perspective
    net, then resume; ``--base-width`` refused for HoHoNet; then with
    FastPanoNet and the GN net's int8 graph (``--persp-int8``): the files
    equal to the in-process int8 graph's (``int8_graph``) panorama by
    panorama."""
    from panodepth_torch import MergeConfig, cli, io as pio
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj

    names = [f"pano_{i:04d}" for i in range(len(rgbs_u8))]
    per_pano = sum(jacobi_launches(MergeConfig()))
    norms = FAMILIES["bifuse"][2] + FAMILIES["gn_perspective"][2]
    with tempfile.TemporaryDirectory(prefix="panodepth_smoke_fam_") as root:
        d = {k: os.path.join(root, k) for k in ("rgb", "gt", "bl", "res")}
        for path in d.values():
            os.makedirs(path)
        for name, rgb in zip(names, rgbs_u8):
            write_png_rgb8(os.path.join(d["rgb"], name + ".png"), rgb)
        argv = ["0", d["rgb"], d["gt"], d["bl"], d["res"], "--persp-ckpt",
                GN_PERSP_CKPT, "--baseline-ckpt", FAMILIES["bifuse"][0]]
        kj.LAUNCHES = kg.LAUNCHES = 0
        if cli.main(argv) != 0:
            raise AssertionError("cli.main returned non-zero")
        launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
        want = dict(jacobi=graph_launches(per_pano),
                    group_norm=graph_launches(norms * kg.launches_per_call()))
        print(f"families cli (bifuse + GN perspective): launches {launches} "
              f"for {len(names)} panoramas (expected {want})")
        if launches != want:
            raise AssertionError("families cli launches")
        for name in names:
            got = pio.read_png(os.path.join(d["res"], name + ".png"))
            if got.shape != (1024, 2048) or got.dtype != np.uint16:
                raise AssertionError(f"families cli output {got.shape}")
        kj.LAUNCHES = kg.LAUNCHES = 0
        log = stdio.StringIO()
        with contextlib.redirect_stdout(log):
            cli.main(argv)
        skips = log.getvalue().count("skip!")
        print(f"families cli resume: {skips} skip! lines, launches jacobi "
              f"{kj.LAUNCHES}, group_norm {kg.LAUNCHES}")
        if skips != len(names) or kj.LAUNCHES or kg.LAUNCHES:
            raise AssertionError("families cli resume did not skip")
        refused = ["0", d["rgb"], d["gt"], d["bl"], os.path.join(root, "r2"),
                   "--persp-ckpt", PERSP_CKPT, "--baseline-ckpt",
                   FAMILIES["hohonet"][0], "--base-width", "256"]
        try:
            cli.main(refused)
        except SystemExit as e:
            msg = str(e.code)
        else:
            raise AssertionError("--base-width with hohonet was not refused")
        print(f"families cli: --base-width 256 with hohonet refused: {msg}")
        if "fixed-width decoder" not in msg:
            raise AssertionError(f"unexpected refusal: {msg}")

        from panodepth_torch.kernels import qconv as kq

        res8 = os.path.join(root, "res_int8")
        argv = ["0", d["rgb"], d["gt"], d["bl"], res8, "--persp-ckpt",
                GN_PERSP_CKPT, "--baseline-ckpt", BASE_CKPT, "--persp-int8"]
        kj.LAUNCHES = kg.LAUNCHES = kq.LAUNCHES = kq.QUANTIZE_LAUNCHES = 0
        if cli.main(argv) != 0:
            raise AssertionError("cli.main --persp-int8 returned non-zero")
        launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES,
                        qconv=kq.LAUNCHES, quantize=kq.QUANTIZE_LAUNCHES)
        want = dict(jacobi=graph_launches(per_pano), group_norm=graph_launches(
            (GN_CALLS + FAMILIES["gn_perspective"][2])
            * kg.launches_per_call()), qconv=graph_launches(GN_INT8_QCONVS),
            quantize=graph_launches(GN_INT8_QCONVS * kq.QUANTIZE_KERNELS))
        dev = torch.device("cuda")
        same = []
        for name, rgb in zip(names, rgbs_u8):
            got = pio.read_png(os.path.join(res8, name + ".png"))
            mem = int8_graph(_pano_feed(rgb, dev)[None])[0][0].cpu().numpy()
            same.append(bool(np.array_equal(got, mem)))
        print(f"families cli --persp-int8 (fastpano + the GN net's int8 "
              f"graph): launches {launches} for {len(names)} panoramas "
              f"(expected {want}); files equal to the in-process int8 "
              f"graph's at batch 1: {same}")
        if launches != want or not all(same):
            raise AssertionError("families cli --persp-int8")
    return launches


# --- stage A: the reference's own command, JPEG throughout ---


def _view_files(views, raw, layout):
    return [os.path.join(views, f"{raw}.{layout.view_tag(v)}.jpg")
            for v in range(layout.num_views)]


def phase_stage_a(cfg, scenes, rgbs_u8):
    """``cli.main`` with stage A on and the default ``.jpg`` views on two
    JPEG panoramas, stage A checked against the in-memory extraction, the
    merge against ``merge_arrays``, model mode against PNG copies; then
    the codec's and stage A's times."""
    import importlib.util

    from panodepth_torch import cli, io as pio, jpeg, pipeline
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj

    dev = torch.device("cuda")
    layout = cfg.layout
    names = [f"pano_{i:04d}" for i in range(len(rgbs_u8))]
    per_pano = sum(jacobi_launches(cfg))
    with tempfile.TemporaryDirectory(prefix="panodepth_smoke_a_") as root:
        d = {k: os.path.join(root, k) for k in
             ("rgb", "rgb_png", "gt", "baseline", "views", "result",
              "result_e2e", "result_e2e_png")}
        for path in d.values():
            os.makedirs(path)
        for name, rgb, sc in zip(names, rgbs_u8, scenes):
            with open(os.path.join(d["rgb"], name + ".jpg"), "wb") as fp:
                fp.write(jpeg.encode(rgb))
            pio.save_png16(os.path.join(d["gt"], name + ".png"), sc["gt"])
            # the default (bifuse) naming, an 8-bit gray JPEG
            pio.save_jpg(os.path.join(d["baseline"], name + ".jpg"),
                         _as01(sc["base"]))
        head = ["0", d["rgb"], d["gt"], d["baseline"]]
        size = ["--layout", cfg.layout_name, "--out-width", str(cfg.out_width)]
        argv = head + [d["result"], "--views-folder", d["views"]] + size

        # 1. the reference's command with stage A on, into an empty folder
        if cli.main(argv) != 0:
            raise AssertionError("cli.main returned non-zero")
        files = pio.list_images(d["rgb"])
        stack = torch.tensor(np.stack([pio.load_image01(f) for f in files]),
                             device=dev)
        fn, groups = pipeline._extract_batched(cfg, 1024, dev)
        views = [v.cpu().numpy() for v in fn(stack)]
        checked = 0
        for (shape, idxs), group in zip(groups, views):
            for bi, name in enumerate(names):
                outs = _view_files(d["views"], name, layout)
                for j, vi in enumerate(idxs):
                    u8 = (np.clip(group[bi, j], 0.0, 1.0) * 255.0).astype(
                        np.uint8)
                    with open(outs[vi], "rb") as fp:
                        data = fp.read()
                    if jpeg.decode(data).shape != shape + (3,):
                        raise AssertionError(f"{outs[vi]}: wrong shape")
                    if data != jpeg.encode(u8):
                        raise AssertionError(f"{outs[vi]} is not the encode "
                                             f"of the in-memory extraction")
                    checked += 1
        if checked != len(names) * layout.num_views or len(
                os.listdir(d["views"])) != checked:
            raise AssertionError(f"stage A wrote {len(os.listdir(d['views']))}"
                                 f" view files, expected {checked}")
        print(f"stage-a: the reference's command wrote {checked} view files "
              f"({layout.num_views} per panorama, shapes "
              f"{[g[0] for g in groups]}), each byte-equal to the codec's "
              f"encode of the in-memory extraction")

        # 2. the views replaced by depth maps as 8-bit gray JPEGs; the
        # default command again: stage A skips, stage C merges them
        for name, sc in zip(names, scenes):
            for path, view in zip(_view_files(d["views"], name, layout),
                                  sc["views"]):
                pio.save_jpg(path, _as01(view))
        shutil.rmtree(d["result"])
        stamps = {f: os.stat(os.path.join(d["views"], f)).st_mtime_ns
                  for f in os.listdir(d["views"])}
        fresh_graphs()
        kj.LAUNCHES = 0
        log = stdio.StringIO()
        with contextlib.redirect_stdout(log):
            if cli.main(argv) != 0:
                raise AssertionError("cli.main returned non-zero")
        launches = kj.LAUNCHES
        if {f: os.stat(os.path.join(d["views"], f)).st_mtime_ns
                for f in os.listdir(d["views"])} != stamps:
            raise AssertionError("stage A rewrote existing views")
        skipped = pipeline.extract_stage_a(files, d["views"], cfg)
        print(f"stage-a: default .jpg run: stage A extracted {skipped} (views"
              f" untouched), jacobi launches {launches} (expected "
              f"{graph_launches(per_pano)}: one graph for both panoramas)")
        if skipped or launches != graph_launches(per_pano):
            raise AssertionError("stage-a: stage A re-extracted or the merge "
                                 "missed the kernel")
        for name in names:
            emap = pio.load_image01(os.path.join(d["baseline"], name + ".jpg"))
            pmaps = np.stack([pio.load_image01(f) for f in
                              _view_files(d["views"], name, layout)])
            want, _ = pipeline.merge_arrays(emap, pmaps, cfg)
            got = pio.read_png(os.path.join(d["result"], name + ".png"))
            if not np.array_equal(got, want.cpu().numpy()):
                raise AssertionError(f"{name}: the .jpg run's output differs "
                                     f"from merge_arrays on the decoded "
                                     f"arrays")
        print("stage-a: each output equals merge_arrays on the decoded "
              "JPEG baseline and views")
        kj.LAUNCHES = 0
        log = stdio.StringIO()
        with contextlib.redirect_stdout(log):
            cli.main(argv)
        skips = log.getvalue().count("skip!")
        print(f"stage-a resume: {skips} skip! lines, {kj.LAUNCHES} launches")
        if skips != len(names) or kj.LAUNCHES:
            raise AssertionError("resume did not skip the finished panoramas")

        # 3. model mode on the JPEG panoramas against PNG copies of them
        ckpt = ["--persp-ckpt", PERSP_CKPT, "--baseline-ckpt", BASE_CKPT] + size
        for name, f in zip(names, files):
            with open(f, "rb") as fp:
                write_png_rgb8(os.path.join(d["rgb_png"], name + ".png"),
                               jpeg.decode(fp.read(), f))
        kj.LAUNCHES = kg.LAUNCHES = 0
        if cli.main(head + [d["result_e2e"]] + ckpt) != 0:
            raise AssertionError("cli.main returned non-zero")
        launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
        cli.main(["0", d["rgb_png"]] + head[2:] + [d["result_e2e_png"]]
                 + ckpt)
        for name in names:
            a = pio.read_png(os.path.join(d["result_e2e"], name + ".png"))
            b = pio.read_png(os.path.join(d["result_e2e_png"], name + ".png"))
            if (a.shape != (cfg.out_height, cfg.out_width)
                    or not np.array_equal(a, b)):
                raise AssertionError(f"{name}: model mode on the JPEG differs"
                                     f" from model mode on its PNG copy")
        print(f"stage-a: model mode on the JPEG panoramas equals the PNG "
              f"copies' run; launches {launches}")
        want_gn = graph_launches(GN_CALLS * kg.launches_per_call())
        if launches != dict(jacobi=graph_launches(per_pano),
                            group_norm=want_gn):
            raise AssertionError(f"stage-a model mode launches {launches}")

        # 4. no Pillow; the probe imports nothing
        print(f"stage-a: Pillow importable on this machine: "
              f"{importlib.util.find_spec('PIL') is not None}; "
              f"imported: {'PIL' in sys.modules}")
        if "PIL" in sys.modules:
            raise AssertionError("the port imported Pillow")

        # 5. times
        with open(files[0], "rb") as fp:
            pano_jpeg = fp.read()
        view_u8 = u8  # the last view checked in 1., 988x1024 RGB

        def host_ms(run, n=5):
            times = []
            for _ in range(n + 1):
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times[1:]))

        dec_ms = host_ms(lambda: jpeg.decode(pano_jpeg))
        enc_ms = host_ms(lambda: jpeg.encode(view_u8))
        ext_ms = _median_ms(lambda: fn(stack), runs=7, warmup=2)
        walls = []
        for k in range(3):
            out = os.path.join(root, f"views_timed_{k}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipeline.extract_stage_a(files, out, cfg)
            walls.append((time.perf_counter() - t0) * 1e3 / len(files))
            shutil.rmtree(out)
        times = dict(decode_ms=dec_ms, encode_ms=enc_ms, extract_ms=ext_ms,
                     wall_ms_per_pano=float(np.median(walls)))
        print(f"stage-a times: decode one {rgbs_u8[0].shape} RGB JPEG "
              f"{dec_ms!r} ms, encode one {view_u8.shape} view {enc_ms!r} ms"
              f" (host clock, "
              f"median of 5), extract {layout.num_views} views of a "
              f"batch-{len(files)} stack "
              f"{ext_ms!r} ms (device, CUDA events, median of 7), stage A "
              f"wall {times['wall_ms_per_pano']!r} ms per panorama (median "
              f"of 3 runs of 2 panoramas: {walls!r})")
    return times


# --- the compiled and batched paths: CUDA graphs, the batched Jacobi ---


def phase_batched(cfg, cfg_4096):
    """The Jacobi kernel over a batch of panoramas with one mask: bit-equal
    to the plain version and to each panorama launched alone, at every
    level of the 2048 plan at B = 3 and at the 4096 plan's largest level at
    B = 2; then the 2048 pyramid timed per panorama at B = 1, 4 and 24."""
    from panodepth_torch.fusion import build_fusion_plan
    from panodepth_torch.kernels import jacobi as kj

    dev = torch.device("cuda")
    step, reg = cfg.jacobi_step, cfg.jacobi_reg
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def stack(b, lvl):
        shape = (b, lvl.height, lvl.width)
        buf = torch.rand(shape, generator=gen, device=dev)
        tgt = torch.randn(shape, generator=gen, device=dev) * 0.01
        return buf, tgt, torch.tensor(lvl.inv_cov > 0, device=dev)

    levels = build_fusion_plan(cfg).levels
    cases = [(3, lvl, "2048") for lvl in levels] + [
        (2, build_fusion_plan(cfg_4096).levels[-1], "4096")]
    for b, lvl, name in cases:
        buf, tgt, cov = stack(b, lvl)
        kj.LAUNCHES = 0
        got = kj.cuda_jacobi(buf, tgt, cov, lvl.iterations, step, reg)
        launches = kj.LAUNCHES
        want = kj.jacobi_plain(buf, tgt, cov, lvl.iterations, step, reg)
        alone = [kj.cuda_jacobi(buf[k].contiguous(), tgt[k].contiguous(), cov,
                                lvl.iterations, step, reg) for k in range(b)]
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        each = all(torch.equal(got[k], a) for k, a in enumerate(alone))
        print(f"jacobi batched {name} plan, B={b} {lvl.width}x{lvl.height} "
              f"x{lvl.iterations}: bit-equal to plain {equal}, each "
              f"panorama bit-equal to itself alone {each}, {launches} "
              f"launches for the batch")
        if not (equal and each) or launches != kj.launches_for(
                lvl.height, lvl.width, lvl.iterations):
            raise AssertionError(f"batched jacobi kernel disagrees ({name}, "
                                 f"B={b}, {lvl.width}x{lvl.height})")
    per_pano = {}
    for b in (1, 4, 24):
        stacks = [stack(b, lvl) for lvl in levels]

        def pyramid():
            for (buf, tgt, cov), lvl in zip(stacks, levels):
                kj.cuda_jacobi(buf, tgt, cov, lvl.iterations, step, reg)

        per_pano[b] = _median_ms(pyramid, runs=5, warmup=1) / b
        del stacks
        torch.cuda.empty_cache()
    print(f"jacobi batched, the 2048 pyramid per panorama (CUDA events, "
          f"median of 5): " + ", ".join(f"B={b} {ms!r} ms" for b, ms in
                                        per_pano.items())
          + f"; {sum(jacobi_launches(cfg))} launches per batch")
    return per_pano


def _timed(run, n=5):
    """Median host time (ms) of ``run()`` ended by a synchronize, after one
    warm-up call."""
    times = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def _write_cli_scene(root, cfg, scenes, names):
    """File mode's folders for ``scenes``: placeholder RGB panoramas, 16-bit
    gt, baselines (``<raw>.depth.png``, read by result folders named
    ``*hohonet*``) and views."""
    from panodepth_torch import io as pio

    d = {k: os.path.join(root, k) for k in ("rgb", "gt", "baseline",
                                            "views")}
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
                d["views"], f"{name}.{cfg.layout.view_tag(v)}.png"), view)
    return d


def _host_decode(up_files, paeth_files, rounds=3):
    """ms to decode one panorama's 16 u16 PNGs (a baseline and 15 views) on
    this host, three ways: the Python twin (``io.read_png_py``) one file
    after another, the native codec (``io.read_png``) one after another,
    and the native prefetcher on 8 threads.  On the Up-filtered files the
    twin once and the native ways in turns (``rounds`` each, medians); on
    the Paeth/Average files the native ways so, and the twin on one file
    only.  Every way's arrays bit-equal."""
    from panodepth_torch import io as pio
    from panodepth_torch.utils import nativeio

    def prefetched(files):
        with nativeio.BatchPrefetcher(files, threads=8) as pf:
            return [pf.get(i) for i in range(len(files))]

    ways = dict(twin_serial=lambda fs: [pio.read_png_py(f) for f in fs],
                native_serial=lambda fs: [pio.read_png(f) for f in fs],
                prefetcher=prefetched)
    turns, got = {}, {}

    def run(key, way, files):
        t0 = time.perf_counter()
        got[key] = ways[way](files)
        turns.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)

    run("up twin_serial", "twin_serial", up_files)
    for files, tag in ((up_files, "up"), (paeth_files, "paeth")):
        for _ in range(rounds):
            for way in ("native_serial", "prefetcher"):
                run(f"{tag} {way}", way, files)
    run("paeth twin_serial one file", "twin_serial", paeth_files[1:2])
    same = (all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in
                zip(got["up twin_serial"], got["up native_serial"],
                    got["up prefetcher"]))
            and all(np.array_equal(a, b) for a, b in zip(
                got["paeth native_serial"], got["paeth prefetcher"]))
            and np.array_equal(got["paeth twin_serial one file"][0],
                               got["paeth native_serial"][1]))
    ms = {k: float(np.median(v)) for k, v in turns.items()}
    shape = got["up native_serial"][1].shape
    print(f"graphs: host decode of one panorama's {len(up_files)} u16 PNGs "
          f"(baseline {got['up native_serial'][0].shape}, views {shape}; "
          f"{_prefetch_route()}), ms: Up-filtered: Python twin serial "
          f"{ms['up twin_serial']!r}, native serial "
          f"{ms['up native_serial']!r}, prefetcher (8 threads) "
          f"{ms['up prefetcher']!r}; Paeth/Average: native serial "
          f"{ms['paeth native_serial']!r}, prefetcher "
          f"{ms['paeth prefetcher']!r}, Python twin on one view "
          f"{ms['paeth twin_serial one file']!r}; every way bit-equal "
          f"{same}; turns {turns!r}")
    if not same:
        raise AssertionError("graphs: the host decodes differ")
    return dict(ms=ms, turns=turns, cpus=nativeio._ncpu(),
                threads=min(8, nativeio._ncpu()))


MANY_BATCH = 24


def _merge_many_b24(d, name, cfg, root, want, dev):
    """``merge_many`` at batch 24 on 24 items that share one scene's files
    (no gt: the loads, the graph and the writes), each written to a file of
    its own, in one call under the profiler that replays the batch-24
    graph captured earlier in the phase (no launch counted): host ms a
    panorama of that call, the device's busy share of it; every output
    bit-equal to ``want`` (the batch-4 run's)."""
    from panodepth_torch import io as pio, pipeline
    from panodepth_torch.kernels import jacobi as kj

    os.makedirs(os.path.join(root, "b24"))
    items = [dict(baseline=os.path.join(d["baseline"], name + ".depth.png"),
                  pmaps=pio.pmap_filenames(d["views"], name, cfg.layout,
                                           ext=".png"),
                  out=os.path.join(root, "b24", f"{j}.png"))
             for j in range(MANY_BATCH)]
    host = {}

    def run():
        t0 = time.perf_counter()
        res = pipeline.merge_many(items, cfg, batch_size=MANY_BATCH,
                                  device=dev, log=lambda *a: None)
        torch.cuda.synchronize()
        host.setdefault("ms", []).append((time.perf_counter() - t0) * 1e3)
        host["res"] = res

    kj.LAUNCHES = 0
    busy, _ = _device_profile(run)
    ms = host["ms"][-1]
    same = (all(r is not None and np.array_equal(r.out_u16, want)
                for r in host["res"])
            and all(np.array_equal(pio.read_png(it["out"]), want)
                    for it in items))
    idle = 1 - busy / ms if busy > 0 else None
    print(f"graphs: merge_many batch {MANY_BATCH} on one scene's files "
          f"({_prefetch_route()}), a replay ({kj.LAUNCHES} launches "
          f"counted), under the profiler: {ms!r} ms, {ms / MANY_BATCH!r} "
          f"host ms a panorama, device busy {busy!r} ms, idle share "
          f"{idle!r}; calls {host['ms']!r}; outputs and files bit-equal to "
          f"the batch-4 run's {same}")
    if not same:
        raise AssertionError("graphs: merge_many at batch 24 differs")
    if kj.LAUNCHES:
        raise AssertionError("graphs: merge_many at batch 24 captured its "
                             "graph anew")
    return dict(host_ms_per_pano=ms / MANY_BATCH, calls_ms=host["ms"],
                busy_ms=busy, idle_share=idle)


def phase_graphs(cfg, cfg_4096, scenes, persp, base, rgbs_u8, e2e, dp,
                 smi, paeth_files):
    """The compiled merge forms against the eager merge (batch 1, staged,
    batched at B = 4 and 24), the dp pair's gathered merge and e2e outputs
    against the batch-4 merge and phase e2e's batch-2 graph (``dp``,
    :meth:`DPPair.check`), one 4096 merge through the graph against the
    plain path, ``merge_many`` on files, both CLIs with --batch-size and
    --profile (and --stream on in model mode) with resume, and the
    eager/graph times in turns.  Between them the host's loads: one
    panorama's 16 files decoded by the Python twin, the native codec and
    the prefetcher (``paeth_files``: phase cli's Paeth/Average set), and
    ``merge_many`` at batch 24 on files."""
    from panodepth_torch import cli, fusion, io as pio, pipeline, registration
    from panodepth_torch.e2e import build_batched_e2e
    from panodepth_torch.models import fastpano
    from panodepth_torch.ops import projection
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj

    dev = torch.device("cuda")
    per_pano = sum(jacobi_launches(cfg))
    ins = [(torch.tensor(_as01(sc["base"]), device=dev),
            torch.tensor(np.stack([_as01(v) for v in sc["views"]]),
                         device=dev)) for sc in scenes]
    eager = [pipeline.merge_arrays(e, p, cfg) for e, p in ins]

    def same(label, got, want):
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"graphs: {label}: bit-equal {ok}")
        if not ok:
            raise AssertionError(f"{label} differs")

    parts = _Parts("graphs")
    # 1. the compiled forms against the eager merge
    fresh_graphs()
    kj.LAUNCHES = 0
    fn = pipeline.compiled_merge(cfg, "auto", dev)
    for k in (0, 1, 0):
        same(f"compiled_merge scene {k} (u16, abcd) vs merge_arrays",
             fn(*ins[k]), eager[k])
    print(f"graphs: compiled_merge launches {kj.LAUNCHES} (expected "
          f"{graph_launches(per_pano)}: captured once, replayed twice)")
    if kj.LAUNCHES != graph_launches(per_pano):
        raise AssertionError("compiled_merge launch count")
    reg_fn, fuse_fn = pipeline.compiled_merge_staged(cfg, "auto", dev)
    abcd, pmaps_reg = reg_fn(*ins[0])
    same("compiled_merge_staged vs merge_arrays and compiled_merge",
         (fuse_fn(ins[0][0], pmaps_reg), abcd), eager[0])
    # a graph holds the device tables it reads: clear every table cache,
    # hand the freed memory out again, and replay
    for cache in (fusion._on_device, fusion._inv_cov,
                  registration._device_tables, projection._taps,
                  fastpano._latitude_on_device):
        cache.cache_clear()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 28,), -7.0, device=dev)
    same("compiled_merge replayed after its tables' caches were cleared "
         "and their memory reused", fn(*ins[1]), eager[1])
    del junk
    order = [0, 1, 1, 0]
    e4 = torch.stack([ins[k][0] for k in order])
    p4 = torch.stack([ins[k][1] for k in order])
    kj.LAUNCHES = 0
    fn4 = pipeline.compiled_merge_batched(cfg, "auto", dev)
    out4, abcd4 = fn4(e4, p4)
    batched_launches = kj.LAUNCHES
    print(f"graphs: compiled_merge_batched B=4 launches {batched_launches} "
          f"(expected {graph_launches(per_pano)}: {per_pano} per batch)")
    if batched_launches != graph_launches(per_pano):
        raise AssertionError("batched merge launch count")
    same("compiled_merge_batched B=4 (scenes 0, 1, 1, 0), each vs its "
         "batch-1 merge", [*out4, *abcd4],
         [eager[k][0] for k in order] + [eager[k][1] for k in order])
    if tuple(order) != DP_ORDER:
        raise AssertionError("the dp pair merges another batch")
    # the pair has run beside what came before; nothing from here on may
    # share the card with it (profiles, times)
    dp.wait()
    dp_checked = dp.check(out4.cpu().numpy(), abcd4.cpu().numpy(),
                          e2e["batch2"], smi)
    busy, events = _device_profile(lambda: fn4(e4, p4))
    tiles = sum(c for _, c, n in events if "jacobi_tile" in n)
    print(f"graphs: one B=4 replay under the profiler: device busy "
          f"{busy!r} ms, jacobi_tile launches {tiles}")
    if busy <= 0:
        raise AssertionError("graphs: the profiler saw no device time in "
                             "the B=4 replay")
    if tiles != per_pano:
        raise AssertionError("the batched replay did not run its kernels")
    order24 = [0, 1] * 12
    e24 = torch.stack([ins[k][0] for k in order24])
    p24 = torch.stack([ins[k][1] for k in order24])
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out24, abcd24 = fn4(e24, p24)
    torch.cuda.synchronize()
    memory = dict(peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9,
                  kept_gb=(torch.cuda.memory_allocated() - held) / 1e9)
    same("compiled_merge_batched B=24, each vs its batch-1 merge",
         [*out24, *abcd24],
         [eager[k][0] for k in order24] + [eager[k][1] for k in order24])
    busy, events = _device_profile(lambda: fn4(e24, p24))
    print(f"graphs: B=24 merge capture: device memory peak "
          f"{memory['peak_gb']!r} GB above the inputs, kept after it "
          f"{memory['kept_gb']!r} GB (graph pool, static inputs, output); "
          f"one replay: device busy {busy!r} ms; top device time by name "
          f"(ms, calls):")
    for ms, count, name in events[:8]:
        print(f"  {ms:9.4f} ms  {count:6d}  {name[:90]}")

    parts.done("compiled forms, the dp pair")
    # 2. one 4096 merge through the graph against the plain path
    sc4 = make_scene(cfg_4096, SEED)
    e, p = (torch.tensor(_as01(sc4["base"]), device=dev),
            torch.tensor(np.stack([_as01(v) for v in sc4["views"]]),
                         device=dev))
    kj.LAUNCHES = 0
    out, abcd = pipeline.compiled_merge(cfg_4096, "auto", dev)(e, p)
    launches_4096 = kj.LAUNCHES
    want = pipeline.merge_arrays(e, p, cfg_4096, jacobi="torch")
    same(f"4096 merge {tuple(out.shape)} through the graph ({launches_4096} "
         f"launches at capture) vs the eager plain-Jacobi path", (out, abcd),
         want)
    m = pio_metrics(sc4, e, out, cfg_4096)
    print(f"graphs: 4096 merge RMSE given {math.sqrt(m.mse_given)!r} -> "
          f"result {math.sqrt(m.mse_result)!r}")
    if not m.mse_result < m.mse_given:
        raise AssertionError("4096 output does not beat the baseline")
    # the batched graph's capture at B = 24 stays for merge_many at batch 24
    # below; the CLIs start from fresh graphs
    del sc4, e, p, e24, p24, out24

    names = [f"pano_{i:04d}" for i in range(len(scenes))]
    with tempfile.TemporaryDirectory(prefix="panodepth_smoke_g_") as root:
        d = _write_cli_scene(root, cfg, scenes, names)
        single = [eager[k][0].cpu().numpy() for k in range(len(scenes))]

        parts.done("4096")
        # 3. merge_many on files, batch 4, stream off and on, profile
        def items(tag):
            os.makedirs(os.path.join(root, tag))
            its = []
            for j, k in enumerate(order + [0]):
                n = names[k]
                its.append(dict(
                    baseline=os.path.join(d["baseline"], n + ".depth.png"),
                    pmaps=pio.pmap_filenames(d["views"], n, cfg.layout,
                                             ext=".png"),
                    gt=os.path.join(d["gt"], n + ".png"),
                    out=os.path.join(root, tag, f"{j}.png")))
            its[-1]["baseline"] += ".missing"
            return its

        many, many_out = {}, {}
        for tag, kw in (("off", dict(stream_u16="off")),
                        ("on", dict(stream_u16="on")),
                        ("profile", dict(profile=True))):
            its = items(tag)
            res = pipeline.merge_many(its, cfg, batch_size=4, device=dev,
                                      log=lambda *a: None, **kw)
            diffs = [int(np.abs(r.out_u16.astype(np.int32)
                                - single[k].astype(np.int32)).max())
                     for r, k in zip(res, order)]
            reg = [r.time_reg_ms for r in res[:4]]
            print(f"graphs: merge_many batch 4 ({tag}): u16 max diff per "
                  f"item vs the single-panorama path {diffs}; missing item "
                  f"quarantined {res[4] is None}; time_reg_ms {reg}, "
                  f"time_fusion_ms {[r.time_fusion_ms for r in res[:4]]}")
            many[tag] = max(diffs)
            many_out[tag] = res[0].out_u16
            if res[4] is not None or (
                    max(diffs) > (1 if tag == "on" else 0)):
                raise AssertionError(f"merge_many ({tag}) differs")
            if (tag == "profile") != all(t is not None for t in reg):
                raise AssertionError(f"merge_many ({tag}) time_reg_ms {reg}")
            if not all(np.array_equal(pio.read_png(it["out"]), r.out_u16)
                       for it, r in zip(its, res[:4])):
                raise AssertionError("merge_many wrote other files")
        parts.done("merge_many")
        # the host's loads: one panorama's files three ways; merge_many at
        # batch 24 on files
        up_files = [os.path.join(d["baseline"], names[0] + ".depth.png")] + \
            pio.pmap_filenames(d["views"], names[0], cfg.layout, ext=".png")
        loads = _host_decode(up_files, paeth_files)
        loads["merge_many_b24"] = _merge_many_b24(
            d, names[0], cfg, root, many_out["off"], dev)
        parts.done("host loads")

        # 4. the CLIs: file mode --batch-size 4 --profile; model mode
        # --batch-size 2 --profile --stream on; then resume
        result = os.path.join(root, "result_hohonet")
        argv = ["0", d["rgb"], d["gt"], d["baseline"], result, "--no-extract",
                "--pmap-ext", ".png", "--views-folder", d["views"],
                "--layout", cfg.layout_name, "--out-width",
                str(cfg.out_width), "--batch-size", "4", "--profile"]
        fresh_graphs()
        kj.LAUNCHES = 0
        log = stdio.StringIO()
        with contextlib.redirect_stdout(log):
            if cli.main(argv) != 0:
                raise AssertionError("cli.main returned non-zero")
        launches = kj.LAUNCHES
        with open(os.path.join(result, "manifest.json")) as fp:
            man = json.load(fp)
        ok = all(np.array_equal(pio.read_png(os.path.join(result, n + ".png")),
                                single[k]) for k, n in enumerate(names))
        print(f"graphs: cli file mode --batch-size 4 --profile: outputs "
              f"equal to the single-panorama merge {ok}; jacobi launches "
              f"{launches}; time_reg_ms {man['time_reg_ms']}, "
              f"time_fusion_ms {man['time_fusion_ms']}; "
              f"{[l for l in log.getvalue().splitlines() if 'time_Reg' in l]}")
        if not ok or man["completed"] != names or len(
                man["time_reg_ms"]) != len(names) or launches != \
                graph_launches(per_pano):
            raise AssertionError("cli file mode batched/profiled run")
        kj.LAUNCHES = 0
        with contextlib.redirect_stdout(stdio.StringIO()) as log:
            cli.main(argv)
        if log.getvalue().count("skip!") != len(names) or kj.LAUNCHES:
            raise AssertionError("batched cli resume did not skip")

        rgb_dir = os.path.join(root, "rgb_e2e")
        os.makedirs(rgb_dir)
        for n, rgb in zip(names, rgbs_u8):
            write_png_rgb8(os.path.join(rgb_dir, n + ".png"), rgb)
        result = os.path.join(root, "result_e2e")
        argv = ["0", rgb_dir, d["gt"], d["baseline"], result, "--persp-ckpt",
                PERSP_CKPT, "--baseline-ckpt", BASE_CKPT, "--batch-size", "2",
                "--profile", "--stream", "on"]
        kj.LAUNCHES = kg.LAUNCHES = 0
        log = stdio.StringIO()
        with contextlib.redirect_stdout(log):
            if cli.main(argv) != 0:
                raise AssertionError("cli.main returned non-zero")
        e2e_launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
        diffs = [int(np.abs(pio.read_png(os.path.join(result, n + ".png"))
                            .astype(np.int32)
                            - e2e["singles"][k].astype(np.int32)).max())
                 for k, n in enumerate(names)]
        end = [l for l in log.getvalue().splitlines() if "time_Models" in l]
        print(f"graphs: cli model mode --batch-size 2 --profile --stream on: "
              f"u16 max diff vs the in-memory graph at batch 1 {diffs}; "
              f"launches {e2e_launches}; {end}")
        if max(diffs) > 1 or not end or "n/a" in end[0]:
            raise AssertionError("cli model mode batched/profiled/streamed")
        kj.LAUNCHES = kg.LAUNCHES = 0
        with contextlib.redirect_stdout(stdio.StringIO()) as log:
            cli.main(argv)
        if (log.getvalue().count("skip!") != len(names) or kj.LAUNCHES
                or kg.LAUNCHES):
            raise AssertionError("model-mode cli resume did not skip")

    parts.done("the CLIs")
    # 5. eager and graph times in turns (eager, graph, graph, eager)
    fresh_graphs()
    times = {}

    def turn(key, run, n=5):
        times.setdefault(key, []).append(_timed(run, n))

    merge_eager = lambda: pipeline.merge_arrays(*ins[0], cfg)
    merge_graph = lambda: pipeline.compiled_merge(cfg, "auto", dev)(*ins[0])
    for key, run in (("merge_b1_eager", merge_eager),
                     ("merge_b1_graph", merge_graph),
                     ("merge_b1_graph", merge_graph),
                     ("merge_b1_eager", merge_eager)):
        turn(key, run)
    fn4 = pipeline.compiled_merge_batched(cfg, "auto", dev)
    turn("merge_b4_graph", lambda: fn4(e4, p4))
    e24 = torch.stack([ins[k][0] for k in order24])
    p24 = torch.stack([ins[k][1] for k in order24])
    turn("merge_b24_graph", lambda: fn4(e24, p24), n=3)
    full, _, _ = build_batched_e2e(persp, cfg, view_width=256,
                                   base_model=base, base_w=512)
    rgbs = torch.stack([_pano_feed(r, dev) for r in rgbs_u8])
    rgbs8 = torch.cat([rgbs] * 4)
    for key, run in (("e2e_b2_eager", lambda: full.eager(rgbs)),
                     ("e2e_b2_graph", lambda: full(rgbs)),
                     ("e2e_b2_graph", lambda: full(rgbs)),
                     ("e2e_b2_eager", lambda: full.eager(rgbs))):
        turn(key, run)
    turn("e2e_b8_graph", lambda: full(rgbs8), n=3)
    runs = dict(merge_b1_eager=(merge_eager, 1), merge_b1_graph=(
        merge_graph, 1), merge_b4_graph=(lambda: fn4(e4, p4), 4),
        merge_b24_graph=(lambda: fn4(e24, p24), 24),
        e2e_b2_eager=(lambda: full.eager(rgbs), 2),
        e2e_b2_graph=(lambda: full(rgbs), 2),
        e2e_b8_graph=(lambda: full(rgbs8), 8))
    table = {}
    for key, (run, b) in runs.items():
        host = float(np.median(times[key]))
        busy, _ = _device_profile(run)
        table[key] = dict(ms_per_pano=host / b, turns=times[key],
                          busy_ms_per_pano=busy / b,
                          idle_share=(1 - busy / host) if busy > 0 else None)
        print(f"graphs A/B {key}: {host / b!r} ms per panorama (host clock "
              f"to synchronize, median of the turns {times[key]!r} ms per "
              f"call), device busy {busy / b!r} ms per panorama, idle share "
              f"{table[key]['idle_share']!r}")
    parts.done("eager and graph times")
    return dict(batched_launches=batched_launches,
                launches_4096=launches_4096, many=many, memory_b24=memory,
                host_loads=loads,
                e2e_cli_launches=e2e_launches, table=table, dp=dp_checked)


# ---------------------------------------------------------------------------
# phase serve: the exported artifacts, loaded and served

SERVE_MERGE_BATCH = 4
SERVE_E2E_BATCH = 2
SERVE_CLIENTS = 8      # client threads of the daemon burst
SERVE_REQUESTS = 32    # image requests per client: 256 latency samples
# a fresh process: load each artifact named on the command line, run it on
# its saved inputs and save the outputs; prints load seconds, cold ms and
# launches as JSON
_FRESH_LOAD = r"""
import json, os, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
from panodepth_torch import serve
from panodepth_torch.kernels import groupnorm as kg, jacobi as kj
report = {}
for name in sys.argv[3:]:
    base = os.path.join(sys.argv[2], name)
    t0 = time.monotonic()
    art = serve.load(base + ".pt2")
    load_s = time.monotonic() - t0
    with np.load(base + ".in.npz") as z:
        ins = [z[k] for k in sorted(z.files)]
    kj.LAUNCHES = kg.LAUNCHES = 0
    t0 = time.monotonic()
    outs = [o.cpu().numpy() for o in art(*ins)]
    cold_ms = (time.monotonic() - t0) * 1e3
    np.savez(base + ".fresh.npz", *outs)
    report[name] = dict(load_s=load_s, cold_ms=cold_ms, launches=dict(
        jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES))
bad = sorted(m for m in sys.modules if m in ("jax", "panodepth", "PIL")
             or m.startswith(("jax.", "panodepth.", "PIL.")))
if bad:
    raise SystemExit(f"the fresh process imported {bad}")
print(json.dumps(report))
"""


# an export child of a family's e2e artifact: the export, then the artifact
# loaded and held in the same process (:func:`export_and_hold`)
_EXPORT_HOLD = r"""
import sys
import chip_smoke
chip_smoke.export_and_hold(sys.argv[1], sys.argv[2:])
"""


# the niceness of the children that run beside the checks (the exports,
# the train CLI runs): the host's cores go to this process first, whose
# profiler must see every launch of the replays it checks
BACKGROUND_NICE = 10
# an export child traces on one thread: eight of them beside the checks
# would otherwise each start a pool as wide as the host
ONE_THREAD = dict(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                  OPENBLAS_NUM_THREADS="1")


def _background():
    os.nice(BACKGROUND_NICE)


def _serve_cli(*args):
    """``python -m panodepth_torch.serve ARGS`` in a child process started
    from the repository root, at background priority."""
    return subprocess.Popen([sys.executable, "-m", "panodepth_torch.serve",
                             *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            preexec_fn=_background, env=dict(
                                os.environ, **ONE_THREAD))


def _child_output(proc, label, timeout=600):
    """The child's output once it exited 0; raises with its output if not."""
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"serve {label}: exit {proc.returncode}\n"
                             f"{out[-4000:]}")
    return out


def _exported(out, label, path):
    """Seconds, bytes and kernel nodes of an export child's artifact, from
    the child's output ``out``."""
    line, = [l for l in out.splitlines() if l.startswith("[serve] wrote")]
    seconds = float(line.rsplit(" in ", 1)[1].split()[0])
    with open(path + ".meta.json") as fp:
        meta = json.load(fp)
    info = dict(export_s=seconds, bytes=os.path.getsize(path),
                kernels=meta["kernels"])
    print(f"serve export {label}: {info['bytes']} bytes in {seconds!r} s, "
          f"kernel nodes {info['kernels']}")
    return info


# each kernel's wrapper module, its launch counter there and its name in
# a profile
_COUNTED = dict(jacobi=("jacobi", "LAUNCHES", "jacobi_tile"),
                group_norm=("groupnorm", "LAUNCHES", "gn_cluster"),
                qconv=("qconv", "LAUNCHES", "qconv_kernel"),
                quantize=("qconv", "QUANTIZE_LAUNCHES", "quantize_kernel"))


def _launch_counters(keys):
    """{key: a function reading the launch count} of the kernels ``keys``,
    their counts set to 0."""
    import importlib

    reads = {}
    for k in keys:
        mod_name, attr, _ = _COUNTED[k]
        mod = importlib.import_module(f"panodepth_torch.kernels.{mod_name}")
        setattr(mod, attr, 0)
        reads[k] = (lambda mod=mod, attr=attr: getattr(mod, attr))
    return reads


def _replay_kernels(run, want):
    """(device busy ms, {kernel: launches}) of one ``run()`` under the
    profiler, for the kernels of ``want`` ({kernel: launches expected}).
    The profiler drops records at times (PERF.md section 7), so a profile
    that counts other launches is taken again, up to three in all, as in
    phase families, and each that fell short is printed."""
    for attempt in range(3):
        busy, events = _device_profile(run)
        seen = {k: sum(c for _, c, n in events if _COUNTED[k][2] in n)
                for k in want}
        if seen == want:
            break
        print(f"profiler: profile {attempt + 1} of the replay saw {seen}, "
              f"expected {want}")
    return busy, seen


def _hold_loaded(label, art, ins, want, nodes, per_call,
                 before_replay=None):
    """A loaded artifact's kernel nodes, the launches of its first call
    (warm-ups and capture) and of a replay, and its outputs bit-equal to
    the in-process graph's ``want``; returns its numbers.
    ``before_replay()``, if given, runs between the first call and the
    profiled replay."""
    from panodepth_torch import serve

    got_nodes = serve.kernel_nodes(art.program)
    counters = _launch_counters(per_call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = art(*ins)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: read() for k, read in counters.items()}
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    if before_replay is not None:
        before_replay()
    busy, replayed = _replay_kernels(lambda: art(*ins), per_call)
    print(f"serve {label}: kernel nodes {got_nodes} (expected {nodes}); "
          f"launches at the first call {launches} (expected "
          f"{ {k: graph_launches(v) for k, v in per_call.items()} }), in a "
          f"replay {replayed}; cold first call {cold_ms!r} ms; outputs "
          f"bit-equal to the in-process graph {equal}")
    if got_nodes != nodes:
        raise AssertionError(f"serve {label}: kernel nodes {got_nodes}")
    if launches != {k: graph_launches(v) for k, v in per_call.items()}:
        raise AssertionError(f"serve {label}: launches {launches}")
    if busy <= 0:
        raise AssertionError(f"serve {label}: the profiler saw no device "
                             f"time in a replay")
    if replayed != per_call:
        raise AssertionError(f"serve {label}: a replay ran {replayed}")
    if not equal:
        raise AssertionError(f"serve {label}: the loaded artifact differs "
                             f"from the in-process graph")
    return dict(cold_ms=cold_ms, launches=launches, replayed=replayed,
                nodes=got_nodes)


def _serve_daemon(art, label, bodies, ctype, want, clients, requests,
                  refusals=()):
    """A Daemon on ``art`` (loopback, any port) and a burst from ``clients``
    threads of ``requests`` posts each, body ``k % len(bodies)`` in turn;
    every answer must decode to ``want[k]``.  Then /healthz, /describe and
    each of ``refusals`` (path, body or None for a GET, content type,
    status code, text of the error): the daemon must answer with that code
    and text.  Returns the /stats snapshot and the burst's wall seconds."""
    import threading
    import urllib.error
    import urllib.request

    from panodepth_torch import daemon as pdaemon
    from panodepth_torch import io as pio

    d = pdaemon.Daemon(art, port=0, max_delay_ms=10.0)
    server = threading.Thread(target=d.serve_forever, daemon=True)
    server.start()
    url = "http://%s:%d" % d.address
    answers, errors = {}, []

    def client(c):
        try:
            for r in range(requests):
                k = (c * requests + r) % len(bodies)
                req = urllib.request.Request(url + "/infer", data=bodies[k],
                                             headers={"Content-Type": ctype})
                with urllib.request.urlopen(req, timeout=300) as resp:
                    body = resp.read()
                if ctype.startswith("image/"):
                    same = np.array_equal(pio.read_png("answer", body),
                                          want[k])
                else:
                    got = np.load(stdio.BytesIO(body))
                    same = all(np.array_equal(got[f"out{j}"], w)
                               for j, w in enumerate(want[k]))
                answers[(c, r)] = same
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(url + "/describe", timeout=30) as resp:
            described = json.loads(resp.read())
        if health != dict(status="ok", kind=art.meta["kind"],
                          batch=d.batcher.batch) or described != art.meta:
            raise AssertionError(f"serve daemon {label}: /healthz {health}")
        for path, body, rtype, code, text in refusals:
            req = urllib.request.Request(url + path, data=body,
                                         headers={"Content-Type": rtype})
            try:
                urllib.request.urlopen(req, timeout=60).close()
                got = (200, "")
            except urllib.error.HTTPError as e:
                got = (e.code, json.loads(e.read())["error"])
            if got[0] != code or text not in got[1]:
                raise AssertionError(f"serve daemon {label}: {path} gave "
                                     f"{got}, expected {code} {text!r}")
        print(f"serve daemon {label}: /healthz, /describe and "
              f"{len(refusals)} refusals "
              f"{[r[3] for r in refusals]} as expected")
    finally:
        d.stop()
        server.join(timeout=30)
    if errors or len(answers) != clients * requests:
        raise AssertionError(f"serve daemon {label}: {len(answers)} answers,"
                             f" errors {errors[:3]}")
    differ = sum(not same for same in answers.values())
    if differ:
        raise AssertionError(f"serve daemon {label}: {differ} answers "
                             f"differ from the direct artifact call")
    # the burst, and the warm-up (a request, but no latency sample)
    if stats["requests"] != stats["items"] or \
            stats["requests"] != clients * requests + 1:
        raise AssertionError(f"serve daemon {label}: stats {stats}")
    return stats, wall


# the families' e2e artifacts (batch 1): each family with its pair, and the
# GN perspective net's int8 graph beside FastPanoNet (--persp-int8);
# SliceNet's export, the longest (90-135 s), is loaded last
SERVE_FAMILIES = tuple(n for n in FAMILIES if n != "slicenet") + (
    "gn_int8", "slicenet")
SERVE_EARLY = ("slicenet",)
SERVE_EXPORTS = ("merge", "e2e") + SERVE_FAMILIES[:-1]


def _parent_says(word, name):
    """Wait for the line ``word`` on stdin (an :func:`export_and_hold`
    child's cue from the parent)."""
    if sys.stdin.readline().strip() != word:
        raise SystemExit(f"serve {name}: the parent did not say {word}")


def export_and_hold(name, argv):
    """An export child's work for the family artifact ``name``:
    ``serve.main(argv)``, the export as ``python -m panodepth_torch.serve``
    runs it.  On the parent's ``load`` (when phase serve begins: no
    profiled check may run while a child works on the card) the artifact
    is loaded here and the same pair's in-process graph built beside it,
    and a line says so.  On the parent's ``go`` (every child at once) the
    loaded artifact is held against the in-process graph on the first e2e
    panorama (:func:`_hold_loaded`: kernel nodes, launches at the first
    call, outputs bit-equal), and a line says so; on the parent's
    ``profile`` (one child at a time, the others idle) the replay is
    profiled and its launches counted.  The numbers are printed in JSON
    after ``HOLD_DONE``; the child ends when the parent closes its
    stdin."""
    from panodepth_torch import MergeConfig, serve
    from panodepth_torch.e2e import build_batched_e2e, load_model_checkpoint
    from panodepth_torch.kernels import qconv as kq
    from panodepth_torch.models import norm as pnorm

    if serve.main(argv) != 0:
        raise SystemExit(f"serve {name}: the export failed")
    sys.stdout.flush()
    _parent_says("load", name)
    t0 = time.perf_counter()
    art = serve.load(argv[1])
    load_s = time.perf_counter() - t0
    if name == "gn_int8":
        net, _ = load_model_checkpoint(GN_PERSP_CKPT, quantize=True)
        pair = "fastpano"
    else:
        ckpt, pair, _ = FAMILIES[name]
        net, _ = load_model_checkpoint(ckpt)
    p_net, b_net = ((net, load_model_checkpoint(BASE_CKPT)[0])
                    if pair == "fastpano"
                    else (load_model_checkpoint(PERSP_CKPT)[0], net))
    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    norms = sum(isinstance(m, pnorm.GroupNorm)
                for n in (p_net, b_net) for m in n.modules())
    jac_op, gn_op, q_op, quant_op = serve.KERNEL_OPS
    nodes = {jac_op: 3, gn_op: norms}
    per_call = dict(jacobi=sum(jacobi_launches(cfg)), group_norm=norms)
    if name == "gn_int8":
        nodes[q_op] = nodes[quant_op] = per_call["qconv"] = GN_INT8_QCONVS
        per_call["quantize"] = GN_INT8_QCONVS * kq.QUANTIZE_KERNELS
    fam_graph = build_batched_e2e(p_net, cfg, view_width=256,
                                  base_model=b_net, base_w=512)[0]
    # the phase's e2e input (phase groupnorm's first panorama)
    x = torch.tensor(make_rgb(SEED, 2048)[None], device="cuda")
    print(f"{HOLD_READY} {name}: loaded in {load_s!r} s in the export "
          f"child", flush=True)
    _parent_says("go", name)

    def cue():
        print(f"{HOLD_CALLED} {name}", flush=True)
        _parent_says("profile", name)

    info = _hold_loaded(f"families {name}", art, [x], fam_graph(x), nodes,
                        per_call, before_replay=cue)
    print(HOLD_DONE, json.dumps(dict(load_s=load_s, **info)), flush=True)
    sys.stdin.read()


# the lines an export_and_hold child prints once it has loaded its
# artifact, once it has called it, and with its numbers
HOLD_READY, HOLD_CALLED, HOLD_DONE = "serve ready", "serve called", \
    "serve held"


def _tell(proc, word):
    """Write the line ``word`` to an :func:`export_and_hold` child."""
    proc.stdin.write(word + "\n")
    proc.stdin.flush()


def _read_until(proc, prefix, label):
    """A child's output up to and including its first line that starts
    with ``prefix``; raises with the output if the child ends first."""
    lines = []
    while not (lines and lines[-1].startswith(prefix)):
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"serve {label}: exit {proc.wait()} before "
                                 f"{prefix!r}\n{''.join(lines)[-4000:]}")
        lines.append(line)
    return "".join(lines)


def _hold_child(name, argv):
    """:func:`export_and_hold` of ``name`` in a child process started from
    the repository root, at background priority, its stdin a pipe."""
    return subprocess.Popen([sys.executable, "-c", _EXPORT_HOLD, name, *argv],
                            cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, preexec_fn=_background,
                            env=dict(os.environ, **ONE_THREAD))


def serve_exports_start(cfg, tmp, names):
    """``python -m panodepth_torch.serve export-*`` of each artifact in
    ``names`` (``merge``, ``e2e`` or a family) into ``tmp``, each in a
    child process of its own; returns {name: process}."""
    path = lambda name: os.path.join(tmp, name + ".pt2")
    pairs = dict(e2e=(PERSP_CKPT, BASE_CKPT, SERVE_E2E_BATCH))
    for name, (ckpt, pair, _) in FAMILIES.items():
        pairs[name] = ((ckpt, BASE_CKPT) if pair == "fastpano"
                       else (PERSP_CKPT, ckpt)) + (1,)
    pairs["gn_int8"] = (GN_PERSP_CKPT, BASE_CKPT, 1)
    procs = {}
    for name in names:
        if name == "merge":
            procs[name] = _serve_cli(
                "export-merge", path("merge"), "--batch",
                str(SERVE_MERGE_BATCH), "--layout", cfg.layout_name,
                "--out-width", str(cfg.out_width))
            continue
        p_ckpt, b_ckpt, b = pairs[name]
        argv = ["export-e2e", path(name), "--batch", str(b),
                "--persp-ckpt", p_ckpt, "--baseline-ckpt", b_ckpt,
                "--view-width", "256", "--layout", cfg.layout_name,
                "--out-width", str(cfg.out_width),
                *(["--persp-int8"] if name == "gn_int8" else [])]
        procs[name] = (_serve_cli(*argv) if name == "e2e"
                       else _hold_child(name, argv))
    return procs


def phase_serve(cfg, scenes, persp, base, rgbs_u8, tmp, procs, trainers):
    """The serving path: the 2048 merge (batch 4) and e2e (FastPanoNet + NF,
    batch 2) exported by ``python -m panodepth_torch.serve`` and every other
    family's e2e graph at batch 1, each export in a child process of its
    own into ``tmp`` (``procs``: those started earlier, SERVE_EARLY and
    SERVE_EXPORTS; any other starts here).  The merge and e2e artifacts
    are loaded here and held bit-equal to their in-process graphs with
    their kernel nodes and launches, then in a fresh process, and the
    daemon serves both; each family's artifact is loaded in its export
    child (:func:`export_and_hold`) once this phase begins and held there,
    one child at a time; then the replays are timed in turns against the
    in-process graphs.
    ``trainers`` (phase train's ``train_cli`` children, started before
    phase cli-e2e) are awaited before the first artifact is loaded."""
    from panodepth_torch import daemon as pdaemon
    from panodepth_torch import jpeg, pipeline, serve
    from panodepth_torch.e2e import build_batched_e2e

    dev = torch.device("cuda")
    per_batch = sum(jacobi_launches(cfg))
    path = lambda name: os.path.join(tmp, name + ".pt2")
    t_phase, marks = time.monotonic(), {}
    try:
        # (a) every export not started yet, at once
        procs.update(serve_exports_start(cfg, tmp, [
            name for name in ("merge", "e2e", *SERVE_FAMILIES)
            if name not in procs]))
        # no train child beside the profiled checks below
        trainers.wait()
        # each family's export child loads its artifact from now on
        for name in SERVE_FAMILIES:
            _tell(procs[name], "load")
        # meanwhile the inputs and the in-process graphs' outputs
        order = [0, 1, 1, 0]
        emaps = np.stack([scenes[k]["base"] for k in order])
        pmaps = np.stack([np.stack(scenes[k]["views"]) for k in order])
        rgbs = np.stack(rgbs_u8)
        graph = dict(
            merge=pipeline.compiled_merge_batched(cfg, "auto", dev),
            e2e=build_batched_e2e(persp, cfg, view_width=256,
                                  base_model=base, base_w=512)[0])
        ins = dict(merge=[torch.tensor(emaps, device=dev),
                          torch.tensor(pmaps, device=dev)],
                   e2e=[torch.tensor(rgbs, device=dev)])
        want = {k: graph[k](*ins[k]) for k in graph}
        np.savez(os.path.join(tmp, "merge.in.npz"), a0=emaps, a1=pmaps)
        np.savez(os.path.join(tmp, "e2e.in.npz"), a0=rgbs)
        exports = {k: _exported(_child_output(procs.pop(k), k), k, path(k))
                   for k in ("merge", "e2e")}
        for k in ("merge", "e2e"):
            procs["fresh_" + k] = subprocess.Popen(
                [sys.executable, "-c", _FRESH_LOAD, ROOT, tmp, k], cwd=tmp,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        # (b), (c) loaded here: kernel nodes, launches, bit-equal
        arts, loaded = {}, {}
        # a jacobi node per pyramid level, a group_norm node per norm
        # call (29 a FastPanoNet forward, one forward a panorama)
        jac_op, gn_op, _, _ = serve.KERNEL_OPS
        gn_calls = SERVE_E2E_BATCH * GN_CALLS
        expect = dict(
            merge=({jac_op: 3}, dict(jacobi=per_batch, group_norm=0)),
            e2e=({jac_op: 3, gn_op: gn_calls},
                 dict(jacobi=per_batch, group_norm=gn_calls)))
        load_s = {}
        for k in ("merge", "e2e"):
            t0 = time.perf_counter()
            arts[k] = serve.load(path(k))
            load_s[k] = time.perf_counter() - t0
            print(f"serve {k}: loaded in {load_s[k]!r} s")
        # the holds profile a replay: first every other process's work on
        # the card ends (the fresh loads, the children's loads)
        fresh = {k: json.loads(_child_output(
            procs.pop("fresh_" + k), "fresh load").splitlines()[-1])[k]
            for k in ("merge", "e2e")}
        ready = {name: _read_until(procs[name], HOLD_READY, name)
                 for name in SERVE_FAMILIES}
        marks["loads"] = time.monotonic() - t_phase
        for k in ("merge", "e2e"):
            loaded[k] = dict(load_s=load_s[k], **exports[k], **_hold_loaded(
                k, arts[k], ins[k], want[k], *expect[k]))

        # (f) the daemon: a burst of JPEG panoramas at the e2e artifact,
        # a few .npz merges at the merge artifact
        panos = _threaded([lambda i=i: make_rgb(SEED + 10 + i, 2048)
                           for i in range(4)])
        bodies = [jpeg.encode(p, quality=95) for p in panos]
        t0 = time.perf_counter()
        decoded = [pdaemon.decode_image_rgb(b) for b in bodies]
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(bodies)
        direct = np.concatenate([arts["e2e"](np.stack(decoded[i:i + 2]))[
            0].cpu().numpy() for i in range(0, len(decoded), 2)])
        t0 = time.perf_counter()
        for d in direct:
            pdaemon.encode_png16(d)
        encode_ms = (time.perf_counter() - t0) * 1e3 / len(direct)
        progressive = bytearray(bodies[0])
        progressive[progressive.index(b"\xff\xc0") + 1] = 0xC2
        stats, wall = _serve_daemon(
            arts["e2e"], "e2e", bodies, "image/jpeg", direct,
            SERVE_CLIENTS, SERVE_REQUESTS, refusals=[
                ("/infer", bytes(progressive), "image/jpeg", 400,
                 "progressive JPEG is not supported"),
                ("/infer", jpeg.encode(panos[0][:512]), "image/jpeg",
                 400, "artifact expects"),
                ("/infer", b"x" * 64, "application/npz", 400, ""),
                ("/nope", None, "text/plain", 404, "no route")])
        n_req = SERVE_CLIENTS * SERVE_REQUESTS
        daemon = dict(
            requests=n_req, wall_s=wall, panos_per_s=n_req / wall,
            p50_ms=stats.get("latency_ms_p50"),
            p99_ms=stats.get("latency_ms_p99"),
            mean_fill=stats["mean_batch_fill"],
            batches=stats["batches"], decode_ms=decode_ms,
            encode_ms=encode_ms, jpeg_bytes=[len(b) for b in bodies])
        print(f"serve daemon e2e: {n_req} JPEG requests from "
              f"{SERVE_CLIENTS} clients in {wall!r} s "
              f"({daemon['panos_per_s']!r} panoramas/s), every PNG "
              f"bit-equal to the direct call; latency p50 "
              f"{daemon['p50_ms']!r} ms, p99 {daemon['p99_ms']!r} ms; "
              f"mean batch fill {daemon['mean_fill']!r} over "
              f"{daemon['batches']} batches (the warm-up's batch "
              f"included, its latency not); "
              f"host decode {decode_ms!r} ms, PNG16 encode "
              f"{encode_ms!r} ms a panorama; stats {stats}")
        npz = []
        for k in (0, 1):
            buf = stdio.BytesIO()
            np.savez(buf, in0=emaps[k], in1=pmaps[k])
            npz.append(buf.getvalue())
        bad = stdio.BytesIO()
        np.savez(bad, in0=emaps[0][:256], in1=pmaps[0])
        m_stats, m_wall = _serve_daemon(
            arts["merge"], "merge", npz, "application/npz",
            [[t[k].cpu().numpy() for t in want["merge"]] for k in (0, 1)],
            3, 1, refusals=[
                ("/infer", bad.getvalue(), "application/npz", 400,
                 "expected shape"),
                ("/infer", bodies[0], "image/jpeg", 400, "npz")])
        daemon["merge_npz"] = dict(requests=3, wall_s=m_wall,
                                   p50_ms=m_stats.get("latency_ms_p50"),
                                   mean_fill=m_stats["mean_batch_fill"])
        print(f"serve daemon merge: 3 .npz requests in {m_wall!r} s, "
              f"each answer bit-equal to the direct call; stats "
              f"{m_stats}")

        marks["daemon"] = time.monotonic() - t_phase
        # (c) again in the fresh process
        for k in ("merge", "e2e"):
            with np.load(os.path.join(tmp, k + ".fresh.npz")) as z:
                same = all(np.array_equal(z[f"arr_{j}"], w.cpu().numpy())
                           for j, w in enumerate(want[k]))
            print(f"serve {k} in a fresh process (no JAX): loaded in "
                  f"{fresh[k]['load_s']!r} s, cold first call "
                  f"{fresh[k]['cold_ms']!r} ms, launches "
                  f"{fresh[k]['launches']}, outputs bit-equal to the "
                  f"in-process graph here {same}")
            if not same or fresh[k]["launches"] != loaded[k]["launches"]:
                raise AssertionError(f"serve {k}: the fresh process "
                                     f"differs")
            loaded[k]["fresh"] = fresh[k]

        # (e) every other family, batch 1: its export child has loaded
        # the artifact and built its in-process graph; the children make
        # their first calls at once, then profile a replay one at a time
        # while the others wait
        families = {}
        for name in SERVE_FAMILIES:
            _tell(procs[name], "go")
        out = {name: ready[name] + _read_until(procs[name], HOLD_CALLED, name)
               for name in SERVE_FAMILIES}
        for name in SERVE_FAMILIES:
            _tell(procs[name], "profile")
            out[name] += _read_until(procs[name], HOLD_DONE, name)
        for name in SERVE_FAMILIES:
            proc = procs.pop(name)
            proc.stdin.close()
            out[name] += proc.stdout.read()
            if proc.wait() != 0:
                raise AssertionError(f"serve {name}: exit {proc.returncode}"
                                     f"\n{out[name][-4000:]}")
            info = _exported(out[name], name, path(name))
            lines = out[name].splitlines()
            print("\n".join(line for line in lines
                            if line.startswith(("serve ", "profiler:"))
                            and not line.startswith((HOLD_CALLED,
                                                     HOLD_DONE))))
            done, = [line for line in lines if line.startswith(HOLD_DONE)]
            info.update(json.loads(done[len(HOLD_DONE):]))
            families[name] = info
        marks["family holds"] = time.monotonic() - t_phase
        print(f"serve: seconds into the phase at the end of each part "
              f"{marks}")
        print(f"serve gn_int8: the int8 artifact {families['gn_int8']['bytes']}"
              f" bytes against the bf16 GN graph's "
              f"{families['gn_perspective']['bytes']} (the perspective net's "
              f"weights as int8 codes)")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()

    # (d) the replays in turns against the in-process graphs, with no
    # child running
    for k, b in (("merge", SERVE_MERGE_BATCH), ("e2e", SERVE_E2E_BATCH)):
        runs = dict(artifact=lambda: arts[k](*ins[k]),
                    graph=lambda: graph[k](*ins[k]))
        turns = {"artifact": [], "graph": []}
        for form in ("artifact", "graph", "graph", "artifact"):
            turns[form].append(_timed(runs[form]))
        for form, run in runs.items():
            host = float(np.median(turns[form]))
            busy, _ = _device_profile(run)
            loaded[k][form] = dict(
                ms_per_pano=host / b, turns=turns[form],
                busy_ms_per_pano=busy / b,
                idle_share=(1 - busy / host) if busy > 0 else None)
            print(f"serve A/B {k} b{b} {form}: {host / b!r} ms per "
                  f"panorama (host clock to synchronize, median of the "
                  f"turns {turns[form]!r} ms per call), device busy "
                  f"{busy / b!r} ms per panorama, idle share "
                  f"{loaded[k][form]['idle_share']!r}")
    del arts
    torch.cuda.empty_cache()
    return dict(loaded, daemon=daemon, families=families)


# --- phase train: training on the card ---------------------------------------

TRAIN_BATCH = 16       # the zoo recipe's batch (zoo/README.md, retrain_zoo.sh)
TRAIN_LR = 3e-4
TEACHER_CKPT = os.path.join(ZOO, "panoramic_final.params.npz")
TEACHER_NORMS = 31     # the UniFuse-class teacher's GroupNorms a forward
TRAIN_TIMED = 4        # steps timed per reading
TRAIN_FALL_STEPS = 20  # steps on one fixed batch whose loss must fall
# the recipe's schedule (zoo/README.md: 14000 steps for the panoramic
# families, 18000 for the perspective net; 200 warmup steps)
TRAIN_STEPS = {"pano": 14000, "perspective": 18000}
# the card's f32 step against the CPU's on the same weights and batch (a
# narrow FastPanoNet computing in f32, TF32 off): the loss's relative
# bar (f32 sums in other orders); the gradient norm's (the tiny groups'
# fast variance amplifies those orders: the CPU tests measured up to 8e-3
# on a leaf between two f32 compilers, ~1e-3 on the whole gradient)
TRAIN_CPU_LOSS_REL = 1e-4
TRAIN_CPU_GN_REL = 1e-2
# evaluate on the zoo FastPanoNet (16 v1 scenes, seed 77 000) against the
# JAX package's numbers on the v5e (zoo/README.md): quality, not speed;
# beyond 5 % the smoke says so (the reason is written in PERF.md)
ZOO_FASTPANO_RMSE, ZOO_FASTPANO_DELTA1 = 0.0082, 0.958
TRAIN_CLI_TIMEOUT = 240
TRAIN_CLI_STEPS = 3    # the --synth child's steps
# the file dataset: procedural mix scenes at Matterport3D's 1024x512, written
# by the port's writer (quality-95 JPEG RGB, 16-bit PNG gt); every 10th
# pair held out by the train CLI's --eval-every
TRAIN_FILES = 40
TRAIN_FILES_WIDTH = 1024
TRAIN_FILES_HELD_OUT = 4
# the corruption on the card against the CPU on the same draws: the bar of
# tests/test_torch_corrupt.py (a share of the pixels, the mean difference)
CORRUPT_SHARE, CORRUPT_MEAN = 5e-3, 1e-3


def _train_net(arch, dtype=torch.bfloat16, seed=0):
    """A fresh net of ``arch`` drawn as flax draws it, on the card."""
    from panodepth_torch.models import layers, weights

    net = weights.build_model(arch, dtype=dtype)
    layers.init_params(net, torch.Generator().manual_seed(seed))
    return net.to("cuda").train()


def _timed_steps(step, state, batches):
    """ms per step over ``batches`` (a list: render excluded; an iterator:
    render included), host clock to a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for batch in batches:
        state, m = step(state, batch)
        n += 1
        if n == TRAIN_TIMED:
            break
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, m


def _train_reading(label, net, kind, teacher=None, size=None, files=None):
    """The readings of one configuration at batch 16: render ms, steps/s
    and img/s with the render included and excluded, device busy and idle
    share of a step, peak memory; the GroupNorm launches of a step (the
    student's and the teacher's); the loss falling on a fixed batch; then,
    with ``files``, the same net on the file dataset (:func:`_train_files`)."""
    from panodepth_torch import synth
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.models import train as ptrain

    teacher_launches = [0]

    def teacher_fn(rgb):
        before = kg.LAUNCHES
        out = teacher(rgb)
        teacher_launches[0] += kg.LAUNCHES - before
        return out

    tx = ptrain.make_optimizer(lr=TRAIN_LR, steps=TRAIN_STEPS[kind])
    state = ptrain.init_state(net, tx)
    step = ptrain.make_train_step(
        net, tx, teacher_fn=teacher_fn if teacher is not None else None)
    gen = synth.synth_batches(TRAIN_BATCH, kind=kind, view_size=size,
                              pano_width=size, seed=SEED, version="mix")
    try:
        for _ in range(2):  # warm-up: cuDNN plans, the allocator
            state, m = step(state, next(gen))
        torch.cuda.synchronize()
        render = []
        fixed = []
        for _ in range(TRAIN_TIMED):
            t0 = time.perf_counter()
            fixed.append(next(gen))
            torch.cuda.synchronize()
            render.append((time.perf_counter() - t0) * 1e3)
        render_ms = float(np.median(render))
        # the steps' own peak: above what the process holds before them
        # (the earlier phases' nets and caches, this net and its moments)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        excl_ms, m = _timed_steps(step, state, fixed)
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        incl_ms, _ = _timed_steps(step, state, gen)
    finally:
        gen.close()
    batch = fixed[0]
    kg.LAUNCHES, teacher_launches[0] = 0, 0
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    total, by_teacher = kg.LAUNCHES, teacher_launches[0]
    student = total - by_teacher
    busy_ms, events = _device_profile(lambda: step(state, batch))
    idle = 1 - busy_ms / excl_ms if busy_ms > 0 else None
    # the loss on one fixed batch over 20 steps (in the recipe's warmup):
    # the mean of the last five below the mean of the first five
    losses = []
    for _ in range(TRAIN_FALL_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    finite = bool(np.isfinite(losses).all())
    print(f"train {label}: batch {TRAIN_BATCH}, render {render_ms!r} ms a "
          f"batch; step {excl_ms!r} ms render excluded "
          f"({1e3 / excl_ms!r} steps/s, {TRAIN_BATCH * 1e3 / excl_ms!r} "
          f"img/s), {incl_ms!r} ms render included ({1e3 / incl_ms!r} "
          f"steps/s, {TRAIN_BATCH * 1e3 / incl_ms!r} img/s); device busy "
          f"{busy_ms!r} ms a step (idle share {idle!r}); peak memory "
          f"{peak_gb!r} GiB above the {held / 2 ** 30!r} GiB held before "
          f"the steps; groupnorm launches a step: student {student}, "
          f"teacher {by_teacher}; loss on a fixed batch {losses[0]!r} -> "
          f"{losses[-1]!r} over {TRAIN_FALL_STEPS} steps; top device time "
          f"(ms, calls):")
    for ms, count, key in events[:6]:
        print(f"  {ms:9.4f} ms  {count:6d}  {key[:90]}")
    if not finite or not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"train {label}: the loss did not fall: "
                             f"{losses}")
    if student != 0:
        raise AssertionError(f"train {label}: the student's norms launched "
                             f"{student} groupnorm kernels")
    if teacher is not None and by_teacher != \
            TEACHER_NORMS * kg.launches_per_call():
        raise AssertionError(f"train {label}: the teacher launched "
                             f"{by_teacher} groupnorm kernels, expected "
                             f"{TEACHER_NORMS}")
    on_files = None
    if files is not None:
        on_files = _train_files(label, step, state, kind, size, files,
                                teacher is not None, teacher_launches)
    return dict(files=on_files, render_ms=render_ms, step_ms=excl_ms,
                step_ms_render=incl_ms,
                steps_per_s=1e3 / excl_ms, steps_per_s_render=1e3 / incl_ms,
                img_per_s=TRAIN_BATCH * 1e3 / excl_ms,
                img_per_s_render=TRAIN_BATCH * 1e3 / incl_ms,
                busy_ms=busy_ms, idle_share=idle, peak_gib=peak_gb,
                held_gib=held / 2 ** 30,
                launches_student=student, launches_teacher=by_teacher,
                loss_first=losses[0], loss_last=losses[-1])


def _write_files(root):
    """The file dataset: ``synth.write_dataset`` on the card into ``root``
    (rgb/ and gt/ in Matterport3D's naming)."""
    from panodepth_torch import synth

    t0 = time.perf_counter()
    synth.write_dataset(root, TRAIN_FILES, width=TRAIN_FILES_WIDTH, seed=SEED,
                        version="mix", device="cuda", log=lambda *a: None)
    secs = time.perf_counter() - t0
    files = dict(rgb=os.path.join(root, "rgb"), gt=os.path.join(root, "gt"))
    print(f"train files: {TRAIN_FILES} mix scenes at {TRAIN_FILES_WIDTH}x"
          f"{TRAIN_FILES_WIDTH // 2} (quality-95 JPEG RGB, 16-bit PNG gt) "
          f"written in {secs!r} s")
    return dict(files, write_s=secs)


def _train_decode(files):
    """ms to decode a batch of 16 pairs on one thread and on the pool, in
    turns (1, pool, pool, 1); the two bit-equal."""
    from panodepth_torch.models import data as pdata

    pairs = pdata.discover_pairs(files["rgb"], files["gt"])[:TRAIN_BATCH]
    n = pdata.DECODE_THREADS
    turns = {1: [], n: []}
    out = {}
    for threads in (1, n, n, 1):
        t0 = time.perf_counter()
        out[threads] = pdata._load_pair_chunk(pairs, threads)
        turns[threads].append((time.perf_counter() - t0) * 1e3)
    same = all(np.array_equal(a, b) for pa, pb in zip(out[1], out[n])
               for a, b in zip(pa, pb))
    cpus = len(os.sched_getaffinity(0))
    ms = {t: float(np.median(v)) for t, v in turns.items()}
    print(f"train files decode: a batch of {TRAIN_BATCH} pairs ({TRAIN_BATCH} "
          f"JPEG + {TRAIN_BATCH} 16-bit PNG at {TRAIN_FILES_WIDTH}x"
          f"{TRAIN_FILES_WIDTH // 2}) {ms[1]!r} ms on 1 thread, {ms[n]!r} ms "
          f"on {n} threads ({os.cpu_count()} CPUs, {cpus} in this process's "
          f"affinity; turns {turns!r}); pool bit-equal to serial {same}")
    if not same:
        raise AssertionError("train files: the threaded decode differs from "
                             "the serial decode")
    png = _train_decode_png(pairs, os.path.join(
        os.path.dirname(files["rgb"]), "rgb_png"))
    return dict(ms_1_thread=ms[1], ms_pool=ms[n], threads=n, cpus=cpus,
                turns={str(k): v for k, v in turns.items()}, png=png)


def _train_decode_png(pairs, root):
    """The batch's pairs with each RGB rewritten into ``root`` as an 8-bit
    RGB PNG with Paeth and Average rows: a chunk of PNGs only, which
    ``_load_pair_chunk`` decodes through one native ``BatchPrefetcher``
    (counted here); its arrays bit-equal to ``io.load_image01`` file by
    file, the RGB also to the JPEG's."""
    from panodepth_torch import io as pio
    from panodepth_torch.models import data as pdata
    from panodepth_torch.utils import nativeio

    os.makedirs(root, exist_ok=True)
    png_pairs = [(os.path.join(root, os.path.splitext(os.path.basename(r))[0]
                               + ".png"), g) for r, g in pairs]
    _threaded([lambda r=r, p=p: write_png_filtered(p, pio.read_image(r),
                                                   PAETH_AVERAGE)
               for (r, _), (p, _) in zip(pairs, png_pairs)])
    made = nativeio.BatchPrefetcher
    opened = []

    class Counted(made):
        def __init__(self, *a, **k):
            opened.append(len(a[0]))
            super().__init__(*a, **k)

    nativeio.BatchPrefetcher = Counted
    try:
        t0 = time.perf_counter()
        got = pdata._load_pair_chunk(png_pairs, pdata.DECODE_THREADS)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        nativeio.BatchPrefetcher = made
    t0 = time.perf_counter()
    want = [tuple(pio.load_image01(f) for f in pair) for pair in png_pairs]
    ms_files = (time.perf_counter() - t0) * 1e3
    same = all(np.array_equal(a, b) for ga, wa in zip(got, want)
               for a, b in zip(ga, wa))
    same_jpeg = all(np.array_equal(g[0], pio.load_image01(r))
                    for g, (r, _) in zip(got, pairs))
    route = (f"one prefetcher over {opened[0]} files" if opened == [
        2 * len(pairs)] else f"prefetchers {opened}")
    print(f"train files decode, all PNG: {len(pairs)} pairs (RGB as 8-bit "
          f"PNG with Paeth/Average rows, 16-bit PNG gt) through "
          f"_load_pair_chunk on {pdata.DECODE_THREADS} threads: {route}, "
          f"{ms!r} ms; io.load_image01 file by file {ms_files!r} ms; "
          f"bit-equal {same}, RGB bit-equal to the JPEG's {same_jpeg}")
    if not (same and same_jpeg and opened == [2 * len(pairs)]):
        raise AssertionError("train files: the all-PNG chunk did not go "
                             "through one prefetcher bit-equal to "
                             "load_image01")
    return dict(ms=ms, ms_files=ms_files, files=opened[0])


def _train_files(label, step, state, kind, size, files, has_teacher,
                 teacher_launches):
    """The net of :func:`_train_reading` on the file dataset with --augment
    --corrupt (``train_cli.batch_stream``: decode on the pool, augment,
    corrupt on the card, pinned copies), timed in turns against the same
    net on --synth batches with --corrupt (files, synth, synth, files: 2
    warm-ups, then ``TRAIN_TIMED`` steps, decode or render included); the
    corruption's device ms a batch; device busy and idle share of a file
    step; its GroupNorm launches (the student's 0, the teacher's 31)."""
    from panodepth_torch import train_cli
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.models import data as pdata
    from panodepth_torch.ops import corrupt as pcorrupt

    dev = torch.device("cuda")
    pairs = pdata.discover_pairs(files["rgb"], files["gt"])
    kw = dict(view_size=size, pano_width=size, corrupt=True)
    streams = dict(
        files=train_cli.batch_stream(kind, SEED, TRAIN_BATCH, dev, pairs=pairs,
                                     augment=True, **kw),
        synth=train_cli.batch_stream(kind, SEED, TRAIN_BATCH, dev,
                                     synth_version="mix", **kw))
    feeds = {k: (train_cli.to_device(b, dev) for b in stream)
             for k, (_, stream) in streams.items()}
    turns = {"files": [], "synth": []}
    try:
        for form in ("files", "synth", "synth", "files"):
            for _ in range(2):
                state, _ = step(state, next(feeds[form]))
            ms, m = _timed_steps(step, state, feeds[form])
            turns[form].append(ms)
            if not math.isfinite(float(m["loss"])):
                raise AssertionError(f"train {label} {form}: loss {m}")
        kg.LAUNCHES, teacher_launches[0] = 0, 0
        state, _ = step(state, next(feeds["files"]))
        torch.cuda.synchronize()
        teacher, student = teacher_launches[0], kg.LAUNCHES - teacher_launches[0]
        busy_ms, _ = _device_profile(lambda: step(state, next(feeds["files"])))
        rgb = next(feeds["synth"])[0]
    finally:
        for feed in feeds.values():
            feed.close()
        for source, stream in streams.values():
            stream.close()
            source.close()
    corrupt_ms = _median_ms(lambda: pcorrupt.corrupt(
        rgb, pcorrupt.batch_generator(SEED, 0, dev)), runs=5, warmup=1)
    ms = {k: float(np.median(v)) for k, v in turns.items()}
    idle = 1 - busy_ms / ms["files"] if busy_ms > 0 else None
    print(f"train {label} on files (--augment --corrupt, {len(pairs)} pairs) "
          f"against --synth --corrupt, in turns (files, synth, synth, files; "
          f"decode or render included): files {ms['files']!r} ms a step "
          f"({1e3 / ms['files']!r} steps/s, {TRAIN_BATCH * 1e3 / ms['files']!r}"
          f" img/s), synth {ms['synth']!r} ms ({1e3 / ms['synth']!r} steps/s, "
          f"{TRAIN_BATCH * 1e3 / ms['synth']!r} img/s); turns {turns!r}; a "
          f"file step's device busy {busy_ms!r} ms (idle share {idle!r}); "
          f"corruption {corrupt_ms!r} ms a batch of {TRAIN_BATCH} on the "
          f"card (CUDA events); groupnorm launches a file step: student "
          f"{student}, teacher {teacher}")
    if student != 0:
        raise AssertionError(f"train {label} on files: the student's norms "
                             f"launched {student} groupnorm kernels")
    if has_teacher and teacher != TEACHER_NORMS * kg.launches_per_call():
        raise AssertionError(f"train {label} on files: the teacher launched "
                             f"{teacher} groupnorm kernels, expected "
                             f"{TEACHER_NORMS}")
    return dict(step_ms=ms["files"], steps_per_s=1e3 / ms["files"],
                img_per_s=TRAIN_BATCH * 1e3 / ms["files"],
                synth_step_ms=ms["synth"], synth_steps_per_s=1e3 / ms["synth"],
                turns=turns, busy_ms=busy_ms, idle_share=idle,
                corrupt_ms=corrupt_ms, launches_student=student,
                launches_teacher=teacher, rgb=rgb)


def _train_corrupt_card_vs_cpu(rgb):
    """The corruption on the card against the CPU on the same draws (made
    on the host), on a batch of the main path's shape."""
    from panodepth_torch.ops import corrupt as pcorrupt

    draws = pcorrupt.draw(rgb.shape, torch.Generator().manual_seed(SEED))
    got = pcorrupt.apply(rgb, draws).cpu().numpy()
    want = pcorrupt.apply(rgb.cpu(), draws).numpy()
    d = np.abs(got.astype(np.float64) - want)
    noise = pcorrupt.eval_noise(rgb.shape, 0)
    e = np.abs(pcorrupt.eval_corruption(rgb, noise=noise).cpu().numpy()
               .astype(np.float64)
               - pcorrupt.eval_corruption(rgb.cpu(), noise=noise).numpy())
    out = dict(share=float((d > 0).mean()), mean=float(d.mean()),
               max=float(d.max()), eval_share=float((e > 0).mean()),
               eval_mean=float(e.mean()), eval_max=float(e.max()))
    print(f"train corruption card vs cpu (same draws, {tuple(rgb.shape)}): "
          f"apply differs on a share {out['share']!r} of the values, mean "
          f"{out['mean']!r}, max {out['max']!r}; eval_corruption share "
          f"{out['eval_share']!r}, mean {out['eval_mean']!r}, max "
          f"{out['eval_max']!r} (bars: share {CORRUPT_SHARE}, mean "
          f"{CORRUPT_MEAN})")
    if max(out["share"], out["eval_share"]) > CORRUPT_SHARE or \
            max(out["mean"], out["eval_mean"]) > CORRUPT_MEAN:
        raise AssertionError("train: the corruption on the card differs from "
                             "the CPU's")
    return out


def _train_families():
    """The other families and the GN perspective net, full width, batch
    16: two steps each (the second timed), finite losses."""
    from panodepth_torch import synth
    from panodepth_torch.models import train as ptrain

    out = {}
    for name, arch in (
            ("panoramic", dict(model="panoramic")),
            ("hohonet", dict(model="hohonet", pano_width=512)),
            ("bifuse", dict(model="bifuse")),
            ("slicenet", dict(model="slicenet", pano_width=512)),
            ("gn_perspective", dict(model="perspective", variant="gn"))):
        net = _train_net(arch)
        kind = "perspective" if arch["model"] == "perspective" else "pano"
        gen = synth.synth_batches(TRAIN_BATCH, kind=kind, view_size=256,
                                  pano_width=512, seed=SEED + 1, version="mix")
        batches = [next(gen) for _ in range(2)]
        gen.close()
        tx = ptrain.make_optimizer(lr=TRAIN_LR)
        state = ptrain.init_state(net, tx)
        step = ptrain.make_train_step(net, tx)
        state, m0 = step(state, batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m1 = step(state, batches[1])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        losses = (float(m0["loss"]), float(m1["loss"]))
        print(f"train {name}: batch {TRAIN_BATCH}, losses {losses!r}, second "
              f"step {ms!r} ms ({1e3 / ms!r} steps/s)")
        if not np.isfinite(losses).all():
            raise AssertionError(f"train {name}: loss not finite {losses}")
        out[name] = dict(steps_per_s=1e3 / ms, step_ms=ms, losses=losses)
        del net, state, step
        torch.cuda.empty_cache()
    return out


def _train_card_vs_cpu():
    """One f32 step of a narrow FastPanoNet on the card and on the CPU from
    the same weights and batch: the loss and the gradient norm."""
    from panodepth_torch import synth
    from panodepth_torch.models import layers, train as ptrain, weights

    arch = dict(model="fastpano", width_scale=0.25)
    gen = synth.synth_batches(4, kind="pano", pano_width=256, seed=SEED,
                              version="mix")
    batch = next(gen)
    gen.close()
    got = {}
    for dev in ("cuda", "cpu"):
        net = weights.build_model(arch, dtype=torch.float32)
        layers.init_params(net, torch.Generator().manual_seed(3))
        net = net.to(dev)
        tx = ptrain.make_optimizer(lr=TRAIN_LR)
        state = ptrain.init_state(net, tx)
        step = ptrain.make_train_step(net, tx)
        state, m = step(state, tuple(t.to(dev) for t in batch))
        got[dev] = (float(m["loss"]), float(m["grad_norm"]))
    (lc, gc), (lp, gp) = got["cuda"], got["cpu"]
    loss_rel, gn_rel = abs(lc - lp) / abs(lp), abs(gc - gp) / abs(gp)
    print(f"train card vs cpu (FastPanoNet x0.25, f32, 4x128x256): loss "
          f"{lc!r} / {lp!r} (rel {loss_rel!r}, bar {TRAIN_CPU_LOSS_REL}), "
          f"grad norm {gc!r} / {gp!r} (rel {gn_rel!r}, bar "
          f"{TRAIN_CPU_GN_REL})")
    if loss_rel > TRAIN_CPU_LOSS_REL or gn_rel > TRAIN_CPU_GN_REL:
        raise AssertionError("train: the card's step disagrees with the "
                             "CPU's")
    return dict(loss=(lc, lp), grad_norm=(gc, gp), loss_rel=loss_rel,
                grad_norm_rel=gn_rel)


# --- the multi-process runs: phase train's trainer ranks, the dp pair ---------

TRAIN_RANKS = 2        # the --synth child's processes, both on cuda:0 (gloo)
DP_ORDER = (0, 1, 1, 0)  # the dp merge's batch of scenes (phase graphs' B=4)
DP_TIMEOUT = 240


def _free_port():
    """A port the system has just handed out (a bind to port 0)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_line(rec):
    """A rank's numbers as the ``[smoke-rank]`` JSON line its parent reads."""
    print("[smoke-rank] " + json.dumps(rec), flush=True)


def _rank_record(out, label):
    """The ``[smoke-rank]`` record a rank printed in ``out``."""
    lines = [l for l in out.splitlines() if l.startswith("[smoke-rank] ")]
    if len(lines) != 1:
        raise AssertionError(f"{label}: {len(lines)} [smoke-rank] lines\n"
                             f"{out[-3000:]}")
    return json.loads(lines[0][len("[smoke-rank] "):])


def train_rank(argv):
    """One rank of phase train's two-process run (``python3 chip_smoke.py
    --train-rank ARGV...``): ``train_cli.main(ARGV)`` with each step of the
    sharded step timed to a synchronize and the third profiled, then the
    rank's GroupNorm launches and times as a ``[smoke-rank]`` line."""
    from panodepth_torch import train_cli
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.models import train as ptrain

    times, busy = [], []
    shard = ptrain.shard_train_step

    def timed_shard(step_fn, mesh):
        step = shard(step_fn, mesh)

        def timed(state, batch):
            out = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(times) == 2:  # one profile, never a second step
                busy.append(_device_profile(
                    lambda: out.append(step(state, batch)), attempts=1)[0])
            else:
                out.append(step(state, batch))
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out[0]
        return timed

    ptrain.shard_train_step = timed_shard
    kg.LAUNCHES = 0
    rc = train_cli.main(argv)
    _rank_line(dict(rank=int(argv[argv.index("--process-id") + 1]),
                    group_norm=kg.LAUNCHES, step_ms=times, busy_ms=busy))
    return rc


def dp_rank(rank, port, root):
    """One rank of the dp pair (``python3 chip_smoke.py --dp-worker RANK PORT
    DIR``), both on cuda:0 over gloo: ``batched_merge`` at 5fold_leres 2048
    on the batch of 4 scenes ``DP_ORDER`` and the e2e graph with the zoo
    nets on the two panoramas, each rank its half; the Jacobi and GroupNorm
    launches of each, ms a panorama; rank 0 writes the gathered outputs to
    ``DIR/dp_out.npz``, each rank the sha256 of its gathered outputs."""
    import hashlib

    from panodepth_torch import MergeConfig
    from panodepth_torch.e2e import build_batched_e2e, load_model_checkpoint
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj
    from panodepth_torch.parallel import mesh as pmesh
    from panodepth_torch.parallel import multihost as mh
    from panodepth_torch.parallel import views  # noqa: F401

    # started while phase e2e runs: the imports happen meanwhile, and the
    # card is touched once the main process says that phase, which
    # profiles, has ended
    deadline = time.monotonic() + DP_TIMEOUT
    while not os.path.exists(os.path.join(root, "go")):
        if time.monotonic() > deadline:
            raise TimeoutError("dp rank: the main process never said go")
        time.sleep(0.05)
    mh.initialize(f"127.0.0.1:{port}", TRAIN_RANKS, rank, device="cuda")
    mesh = pmesh.make_mesh()
    # the collectives of parallel/multihost.py hand gloo CUDA tensors
    dev = mesh.device
    ones = mh.all_reduce([torch.ones(3, device=dev)])[0]
    got = torch.full((3,), float(rank), device=dev)
    mh.broadcast_([got])
    gathered = mh.all_gather(torch.full((1, 2), rank, dtype=torch.uint16,
                                        device=dev))
    gloo_cuda = dict(
        all_reduce=ones.device.type == "cuda" and bool((ones == 2).all()),
        broadcast=bool((got == 0).all()),
        all_gather=gathered.cpu().tolist() == [[0, 0], [1, 1]])
    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    z = np.load(os.path.join(root, "dp_in.npz"))
    # the global batch on the card: each rank's rows are views of it
    emaps = torch.from_numpy(np.stack([_as01(z[f"base{k}"])
                                       for k in DP_ORDER])).to(mesh.device)
    pmaps = torch.from_numpy(np.stack([_as01(z[f"views{k}"])
                                       for k in DP_ORDER])).to(mesh.device)
    rows = len(DP_ORDER) // mesh.dp
    merge = pmesh.batched_merge(cfg, mesh)
    kj.LAUNCHES = 0
    out, abcd = merge(emaps, pmaps)
    torch.cuda.synchronize()
    merge_launches = dict(jacobi=kj.LAUNCHES)
    merge_ms = _timed(lambda: merge(emaps, pmaps)) / rows
    del emaps, pmaps

    persp, _ = load_model_checkpoint(PERSP_CKPT, device=mesh.device)
    base, _ = load_model_checkpoint(BASE_CKPT, device=mesh.device)
    full, _, _ = build_batched_e2e(persp, cfg, view_width=256,
                                   base_model=base, base_w=512, mesh=mesh)
    rgbs = torch.stack([_pano_feed(z[f"rgb{k}"], mesh.device)
                        for k in range(2)])
    kj.LAUNCHES = kg.LAUNCHES = 0
    e2e, _ = full(rgbs)
    torch.cuda.synchronize()
    e2e_launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
    e2e_ms = _timed(lambda: full(rgbs)) / (len(rgbs) // mesh.dp)
    del full
    got = dict(merge=out.cpu().numpy(), abcd=abcd.cpu().numpy(),
               e2e=e2e.cpu().numpy())
    # the sp axis: the sharded Jacobi, the sp merge, the latency graph
    ring = pmesh.make_mesh((1, TRAIN_RANKS))
    collectives = _counted_collectives()
    sharded = _sp_jacobi_checks(ring, cfg)
    sp = _sp_merge(cfg, ring, z)
    lat = _latency_rank(cfg, ring, persp, base, z, root, collectives)
    got.update(sp_merge=sp.pop("out"), sp_abcd=sp.pop("abcd"),
               lat=lat.pop("out"), lat_drv=lat.pop("driver_out"))
    # the digests of what every rank holds; rank 0 alone ran the graph
    # over a ring of one
    sha256 = {k: hashlib.sha256(v.tobytes()).hexdigest()
              for k, v in got.items()}
    if rank == 0:
        np.savez(os.path.join(root, "dp_out.npz"),
                 lat_one_rank=lat.pop("one_rank_out"), **got)
    lat.pop("one_rank_out", None)
    mh.barrier("dp-done")
    _rank_line(dict(
        rank=rank, backend=mesh.backend, dp=mesh.dp, gloo_cuda=gloo_cuda,
        merge_launches=merge_launches, e2e_launches=e2e_launches,
        merge_ms_per_pano=merge_ms, e2e_ms_per_pano=e2e_ms,
        sharded_jacobi=sharded, sp_merge=sp, latency=lat, sha256=sha256))
    mh.shutdown()
    return 0


SP_HALOS = (1, 10)   # the sharded Jacobi's halos checked on the card
LAT_HALO = 10        # the latency graph's halo (the CLI's default)
LAT_VIEW, LAT_BASE = 256, 512  # phase e2e's view and baseline widths
LAT_ABCD_ATOL = 1e-4  # cubics against register_views (tests/test_latency.py)


def _counted_collectives():
    """Wrap the collectives of ``parallel/multihost.py`` that the sp paths
    call: {name: [calls, host ms]} of every call from here on (each
    collective's host time: gloo waits for its CUDA tensors)."""
    from panodepth_torch.parallel import multihost as mh

    counts = {}
    for name in ("all_gather", "reduce_scatter", "ring_exchange"):
        def wrapped(*args, _fn=getattr(mh, name), _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                c = counts.setdefault(_name, [0, 0.0])
                c[0] += 1
                c[1] += (time.perf_counter() - t0) * 1e3
        setattr(mh, name, wrapped)
    return counts


def _sharded_launches(h, w_local, iterations, halo):
    """Jacobi launches of ``jacobi_local`` on one rank's (h, w_local) shard
    with the kernel on its extended buffers, by the kernel's plan."""
    from panodepth_torch.kernels import jacobi as kj

    k = min(max(1, halo), w_local)
    blocks = [k] * (iterations // k) + ([iterations % k]
                                        if iterations % k else [])
    return sum(kj.launches_for(h, w_local + 2 * k, bs) for bs in blocks)


def _sp_jacobi_checks(ring, cfg):
    """``jacobi_spatial`` over the two ranks at every level of ``cfg``'s
    pyramid and each of ``SP_HALOS``, random buffers and targets from the
    seed and a mask of full-width rows (it covers the seam): the kernel on
    the shards' extended buffers against the plain ``step_ext`` schedule
    and against one process's ``cuda_jacobi`` on the full width, all
    bit-equal; the kernel route's launches and ms, the plain route's ms."""
    from panodepth_torch.kernels import jacobi as kj
    from panodepth_torch.parallel.spatial import jacobi_spatial

    dev = ring.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    for lvl in _levels(cfg):
        h, w = lvl.height, lvl.width
        buf = torch.rand((h, w), generator=gen, device=dev)
        tgt = (torch.rand((h, w), generator=gen, device=dev) - 0.5) * 0.02
        cov = torch.zeros((h, w), dtype=torch.bool, device=dev)
        cov[h // 10: h - h // 10] = True
        args = (buf, tgt, cov, lvl.iterations, cfg.jacobi_step,
                cfg.jacobi_reg)
        full = kj.cuda_jacobi(*args)
        for halo in SP_HALOS:
            torch.cuda.synchronize()
            kj.LAUNCHES = 0
            t0 = time.perf_counter()
            kern = jacobi_spatial(*args, ring, halo=halo, jacobi="kernel")
            torch.cuda.synchronize()
            kern_ms = (time.perf_counter() - t0) * 1e3
            launches = kj.LAUNCHES
            t0 = time.perf_counter()
            plain = jacobi_spatial(*args, ring, halo=halo, jacobi="torch")
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            out.append(dict(
                level=[h, w], iterations=lvl.iterations, halo=halo,
                kernel_vs_plain=bool(torch.equal(kern, plain)),
                kernel_vs_full_width=bool(torch.equal(kern, full)),
                launches=launches, expected_launches=_sharded_launches(
                    h, w // ring.sp, lvl.iterations, halo),
                kernel_ms=kern_ms, plain_ms=plain_ms))
    return out


def _sp_merge(cfg, ring, z):
    """``batched_merge`` on the ``(1, 2)`` mesh: the dp pair's batch of 4
    scenes, the relaxation sharded over the two ranks (``SP_HALO``); its
    Jacobi launches a call and ms a panorama."""
    from panodepth_torch.kernels import jacobi as kj
    from panodepth_torch.parallel import mesh as pmesh

    emaps = torch.from_numpy(np.stack([_as01(z[f"base{k}"])
                                       for k in DP_ORDER])).to(ring.device)
    pmaps = torch.from_numpy(np.stack([_as01(z[f"views{k}"])
                                       for k in DP_ORDER])).to(ring.device)
    merge = pmesh.batched_merge(cfg, ring)
    kj.LAUNCHES = 0
    out, abcd = merge(emaps, pmaps)
    torch.cuda.synchronize()
    launches = kj.LAUNCHES
    ms = _timed(lambda: merge(emaps, pmaps), n=2) / len(DP_ORDER)
    return dict(out=out.cpu().numpy(), abcd=abcd.cpu().numpy(),
                launches=launches, expected_launches=sum(
                    _sharded_launches(lvl.height, lvl.width // ring.sp,
                                      lvl.iterations, pmesh.SP_HALO)
                    for lvl in _levels(cfg)), ms_per_pano=ms)


def _levels(cfg):
    """The levels of ``cfg``'s fusion pyramid."""
    from panodepth_torch.fusion import build_fusion_plan

    return build_fusion_plan(cfg).levels


def _latency_rank(cfg, ring, persp, base, z, root, collectives):
    """The latency graph (vp = 2, ``LAT_HALO``, its debug outputs) with the
    zoo nets on the two panoramas: its Jacobi and GroupNorm launches over
    the two calls (the first captures the rank's stage), each call's ms
    and collectives, its output against one process's ``fuse`` (the
    kernel) on its own intermediates, the digests of its baselines; then
    ``run_batch_e2e(latency=True, profile=True)`` on the panoramas written
    as PNG files, twice (the second resumes), each panorama's ms, rank
    0's files against the graph's output.

    The nets see this rank's 8 views a call where the batched graph's
    see 15, so the graph's bits differ from the batched graph's by the
    nets' bf16 batch dependence.  The stages are held apart: the rank's
    depths bit-equal to one process's perspective net on the same 8
    views, the cubics within 1e-4 of ``register_views`` on the graph's
    own intermediates, the fusion bit-equal to ``fuse`` on them; and rank
    0 runs the graph over a ring of one (every view in one call), whose
    output phase graphs holds bit-equal to the batched graph's."""
    import hashlib

    from panodepth_torch import io as pio
    from panodepth_torch import registration
    from panodepth_torch.e2e import depths_of, run_batch_e2e
    from panodepth_torch.fusion import build_fusion_plan, fuse
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.kernels import jacobi as kj
    from panodepth_torch.ops.projection import extract_group, view_shape
    from panodepth_torch.parallel import mesh as pmesh
    from panodepth_torch.parallel import multihost as mh
    from panodepth_torch.parallel.views import build_latency_e2e
    from panodepth_torch.pipeline import true_f32

    dev = ring.device
    nv = cfg.layout.num_views
    fn = build_latency_e2e(persp, cfg, ring, view_width=LAT_VIEW,
                           base_model=base, base_w=LAT_BASE, halo=LAT_HALO,
                           debug=True)
    rgbs = [_pano_feed(z[f"rgb{k}"], dev) for k in range(2)]
    collectives.clear()
    kj.LAUNCHES = kg.LAUNCHES = 0
    got, ms, calls = [], [], []
    for rgb in rgbs:
        before = {k: list(v) for k, v in collectives.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got.append(fn(rgb))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        calls.append({k: [v[0] - before.get(k, [0, 0.0])[0],
                          v[1] - before.get(k, [0, 0.0])[1]]
                      for k, v in collectives.items()})
    launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
    per_call = sum(_sharded_launches(lvl.height, lvl.width // ring.sp,
                                     lvl.iterations, LAT_HALO)
                   for lvl in _levels(cfg))
    expected = dict(jacobi=len(rgbs) * per_call,
                    group_norm=graph_launches(
                        GN_CALLS * kg.launches_per_call()))
    # this rank's views, as the graph pads and splits them
    per = -(-nv // ring.sp)
    fovs = np.concatenate([cfg.layout.fovs] + [cfg.layout.fovs[:1]] * (
        per * ring.sp - nv))[ring.sp_index * per:(ring.sp_index + 1) * per]
    shape = view_shape(cfg.layout.fovs[0], LAT_VIEW)
    own = []
    for rgb, (out, abcd, emap, pmaps, _) in zip(rgbs, got):
        one, _ = fuse(emap, list(pmaps[:nv]), build_fusion_plan(cfg),
                      jacobi_fn=kj.cuda_jacobi, abcd=abcd)
        with true_f32():
            depths = depths_of(persp, extract_group(rgb[None], fovs,
                                                    shape)[0])
            fit = registration.register_views(emap, pmaps[:nv], cfg)
        mine = pmaps[ring.sp_index * per:(ring.sp_index + 1) * per]
        own.append(dict(equal=bool(torch.equal(one, out)),
                        differ=int((one != out).sum()),
                        depths_equal=bool(torch.equal(depths, mine)),
                        abcd_vs_register_views=float(
                            (fit - abcd).abs().max()),
                        emap_sha256=hashlib.sha256(
                            emap.cpu().numpy().tobytes()).hexdigest()))
    outs = [g[0] for g in got]
    del got
    solo = None
    if ring.rank == 0:  # every view in one call: the batched graph's bits
        group = mh.Group((ring.rank,), 0)
        one_rank = pmesh.Mesh(1, 1, ring.rank, dev, ring.backend, group,
                              group)
        fn1 = build_latency_e2e(persp, cfg, one_rank, view_width=LAT_VIEW,
                                base_model=base, base_w=LAT_BASE,
                                halo=LAT_HALO)
        solo = torch.stack([fn1(r)[0] for r in rgbs]).cpu().numpy()
        del fn1

    # the driver on the two panoramas as PNG files (rank 0 writes them)
    folders = {k: os.path.join(root, "lat_" + k) for k in ("rgb", "res")}
    if ring.rank == 0:
        os.makedirs(folders["rgb"])
        for k in range(2):
            write_png_rgb8(os.path.join(folders["rgb"], f"p{k}.png"),
                           z[f"rgb{k}"])
    mh.barrier("latency-files")
    logs = []
    drv = dict(baseline_ckpt=BASE_CKPT, view_width=LAT_VIEW,
               base_width=LAT_BASE, latency=True, latency_halo=LAT_HALO,
               profile=True, log=logs.append, device=dev)
    kj.LAUNCHES = kg.LAUNCHES = 0
    t0 = time.perf_counter()
    run_batch_e2e(folders["rgb"], os.path.join(root, "no_gt"),
                  folders["res"], PERSP_CKPT, cfg, **drv)
    driver_s = time.perf_counter() - t0
    driver_launches = dict(jacobi=kj.LAUNCHES, group_norm=kg.LAUNCHES)
    again = run_batch_e2e(folders["rgb"], os.path.join(root, "no_gt"),
                          folders["res"], PERSP_CKPT, cfg, **drv)
    files = [pio.read_png(os.path.join(folders["res"], f"p{k}.png"))
             for k in range(2)]
    return dict(
        out=torch.stack(outs).cpu().numpy(), one_rank_out=solo,
        launches=launches, expected_launches=expected, ms=ms,
        driver_ms=[float(l.split("latency e2e ")[1].split(" ms")[0])
                   for l in logs if "latency e2e" in l],
        collectives=calls, own_fuse=own,
        driver_out=np.stack(files), driver_s=driver_s,
        driver_launches=driver_launches, driver_again=len(again),
        driver_skips=sum("skip!" in l for l in logs),
        driver_line=[l for l in logs if "time_e2e_avg" in l])



class DPPair:
    """The dp pair: two ranks of :func:`dp_rank` in child processes at
    background priority, started with phase train's children on inputs
    written here (phase merge's scenes, the two panoramas), awaited before
    phase batched; phase graphs holds their gathered outputs bit-equal to
    the one-process batch-4 merge and batch-2 e2e graph (:meth:`check`)."""

    def __init__(self, scenes, rgbs_u8):
        self.root = tempfile.mkdtemp(prefix="panodepth_smoke_dp_")
        t0 = time.monotonic()
        np.savez(os.path.join(self.root, "dp_in.npz"), **{
            f"base{k}": sc["base"] for k, sc in enumerate(scenes)}, **{
            f"views{k}": np.stack(sc["views"]) for k, sc in
            enumerate(scenes)}, **{
            f"rgb{k}": r for k, r in enumerate(rgbs_u8)})
        self.write_s = time.monotonic() - t0
        port = _free_port()
        self.logs = [os.path.join(self.root, f"rank{r}.log")
                     for r in range(TRAIN_RANKS)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                     "--dp-worker", str(r), str(port), self.root],
                    cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                    text=True, preexec_fn=_background,
                    env=dict(os.environ, **ONE_THREAD)))
        self.t0 = t0
        print(f"dp: two ranks started (inputs written in {self.write_s:.2f} "
              f"s)", flush=True)

    def go(self):
        """Let the ranks, which have imported what they run, touch the
        card."""
        with open(os.path.join(self.root, "go"), "w"):
            pass

    def wait(self):
        """Wait for both ranks; the records of both (raises unless both
        exited 0)."""
        recs = []
        for r, (proc, log) in enumerate(zip(self.procs, self.logs)):
            try:
                proc.wait(timeout=DP_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            with open(log) as fp:
                out = fp.read()
            if proc.returncode != 0:
                raise AssertionError(f"dp rank {r}: exit {proc.returncode}\n"
                                     f"{out[-4000:]}")
            recs.append(_rank_record(out, f"dp rank {r}"))
        print(f"dp: both ranks have ended ({time.monotonic() - self.t0:.2f} "
              f"s after their start)", flush=True)
        self.recs = recs
        return recs

    def check(self, merge4, abcd4, e2e2, smi):
        """The gathered outputs (both ranks' hashes equal) bit-equal to the
        one-process batch-4 merge (``merge4``, ``abcd4``) and batch-2 e2e
        graph (``e2e2``), and each rank's launches: the Jacobi's 26 and
        the GroupNorm's 29 a forward, counted at the warm-ups and the
        capture of its graph (a batch of 2 and of 1 a rank)."""
        from panodepth_torch import MergeConfig
        from panodepth_torch.kernels import groupnorm as kg

        z = np.load(os.path.join(self.root, "dp_out.npz"))
        want = dict(merge=merge4, abcd=abcd4, e2e=e2e2)
        equal = {k: bool(np.array_equal(z[k], v)) for k, v in want.items()}
        same_hash = self.recs[0]["sha256"] == self.recs[1]["sha256"]
        per_pano = sum(jacobi_launches(MergeConfig(
            layout_name="5fold_leres", out_width=2048)))
        want_launches = dict(
            merge_launches=dict(jacobi=graph_launches(per_pano)),
            e2e_launches=dict(jacobi=graph_launches(per_pano),
                              group_norm=graph_launches(
                                  GN_CALLS * kg.launches_per_call())))
        launches_ok = all(rec[k] == v for rec in self.recs
                          for k, v in want_launches.items())
        gloo_ok = all(all(rec["gloo_cuda"].values()) for rec in self.recs)
        print(f"dp: gloo's collectives on CUDA tensors (all-reduce, "
              f"broadcast, all-gather of u16), each rank: "
              f"{[rec['gloo_cuda'] for rec in self.recs]}")
        for rec in self.recs:
            print(f"dp rank {rec['rank']} of {rec['dp']} ({rec['backend']}): "
                  f"merge launches {rec['merge_launches']}, e2e launches "
                  f"{rec['e2e_launches']} (expected {want_launches}); ms a "
                  f"panorama (host clock to a synchronize, median of 5, both "
                  f"ranks and other work sharing the card): merge "
                  f"{rec['merge_ms_per_pano']!r}, e2e "
                  f"{rec['e2e_ms_per_pano']!r}; card: {smi}")
        print(f"dp: gathered outputs bit-equal to one process (batch-4 "
              f"merge, batch-2 e2e graph) {equal}; both ranks hold the same "
              f"bits {same_hash}")
        sp_ok = self._check_sp(z, merge4, abcd4, e2e2, smi)
        if not (all(equal.values()) and same_hash and launches_ok
                and gloo_ok and sp_ok):
            raise AssertionError("dp pair: outputs or launches")
        return dict(ranks=self.recs, equal=equal, write_s=self.write_s)

    def _check_sp(self, z, merge4, abcd4, e2e2, smi):
        """The pair's sp work: the sharded Jacobi bit-equal to the plain
        schedule and the full-width kernel at every level and halo; the sp
        merge bit-equal to the one-process batch-4 merge; the latency graph
        within the route bar of phase e2e's batch-2 graph, bit-equal to
        one process's ``fuse`` on its own intermediates, the ranks' emaps
        equal; the driver's files equal to the graph's output, its rerun
        skipping both; every launch count as the plans say."""
        ok = True
        for rec in self.recs:
            r = rec["rank"]
            for c in rec["sharded_jacobi"]:
                good = (c["kernel_vs_plain"] and c["kernel_vs_full_width"]
                        and c["launches"] == c["expected_launches"])
                ok &= good
                print(f"sp rank {r}: jacobi_spatial {c['level'][1]}x"
                      f"{c['level'][0]} ({c['iterations']} it.) halo "
                      f"{c['halo']}: kernel on the shards = plain step_ext "
                      f"{c['kernel_vs_plain']}, = full-width kernel "
                      f"{c['kernel_vs_full_width']}; launches "
                      f"{c['launches']} (expected {c['expected_launches']}); "
                      f"host ms kernel {c['kernel_ms']!r}, plain "
                      f"{c['plain_ms']!r}")
            sp = rec["sp_merge"]
            ok &= sp["launches"] == sp["expected_launches"]
            print(f"sp rank {r}: batched_merge on the (1, 2) mesh: Jacobi "
                  f"launches {sp['launches']} a call "
                  f"(expected {sp['expected_launches']}), ms a panorama "
                  f"(host clock, median of 2) {sp['ms_per_pano']!r}")
            lat = rec["latency"]
            ok &= lat["launches"] == lat["expected_launches"]
            ok &= all(o["equal"] and o["depths_equal"]
                      and o["abcd_vs_register_views"] <= LAT_ABCD_ATOL
                      for o in lat["own_fuse"])
            ok &= lat["driver_launches"] == lat["expected_launches"]
            ok &= lat["driver_again"] == 0 and lat["driver_skips"] == 2
            print(f"latency rank {r} (vp = 2, halo {LAT_HALO}): ms a "
                  f"panorama (host clock) of the debug graph's two calls "
                  f"{lat['ms']!r} (the first captures), of the driver's "
                  f"(its graph without the debug outputs, the copy to "
                  f"the host included) {lat['driver_ms']!r}; collectives a "
                  f"call {{name: [calls, host ms]}} {lat['collectives']!r}; "
                  f"launches over the two calls {lat['launches']} "
                  f"(expected {lat['expected_launches']}); own fuse "
                  f"bit-equal {[o['equal'] for o in lat['own_fuse']]} "
                  f"(pixels apart {[o['differ'] for o in lat['own_fuse']]}); "
                  f"the rank's depths = one process's net on its 8 views "
                  f"{[o['depths_equal'] for o in lat['own_fuse']]}; cubics "
                  f"against register_views on its intermediates, max abs "
                  f"{[o['abcd_vs_register_views'] for o in lat['own_fuse']]} "
                  f"(bar {LAT_ABCD_ATOL}); "
                  f"driver {lat['driver_s']!r} s, launches "
                  f"{lat['driver_launches']}, rerun skipped "
                  f"{lat['driver_skips']} ({lat['driver_again']} merged), "
                  f"{lat['driver_line']}; card: {smi}")
        emaps = [[o["emap_sha256"] for o in rec["latency"]["own_fuse"]]
                 for rec in self.recs]
        ok &= emaps[0] == emaps[1]
        sp_equal = dict(merge=bool(np.array_equal(z["sp_merge"], merge4)),
                        abcd=bool(np.array_equal(z["sp_abcd"], abcd4)))
        drv_equal = bool(np.array_equal(z["lat_drv"], z["lat"]))
        route = []
        for k in range(2):
            d = np.abs(z["lat"][k].astype(np.int64)
                       - e2e2[k].astype(np.int64))
            route.append((int(d.max()), float(d.mean())))
        one_rank = bool(np.array_equal(z["lat_one_rank"], e2e2))
        ok &= all(sp_equal.values()) and drv_equal and one_rank and all(
            m <= BF16_ORDER_MAX_U16 and mean <= E2E_ROUTE_MEAN_U16
            for m, mean in route)
        print(f"sp: the (1, 2) merge bit-equal to one process's batch-4 "
              f"merge {sp_equal}; the latency graph over a ring of one "
              f"bit-equal to phase e2e's batch-2 graph {one_rank}; over "
              f"two ranks against it, u16 (max, mean) per panorama "
              f"{route} (bars: max {BF16_ORDER_MAX_U16}, mean "
              f"{E2E_ROUTE_MEAN_U16}; the nets see 8 views a call, not "
              f"15); the ranks' emaps equal {emaps[0] == emaps[1]}; "
              f"rank 0's driver files equal to the graph's output "
              f"{drv_equal}")
        return ok

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.root, ignore_errors=True)


class Trainers:
    """Phase train's ``train_cli`` runs in child processes: the zoo recipe
    with its teacher for 3 steps on --synth as two ranks of one run
    (``--coordinator``, both on cuda:0 over gloo, 8 rows each, through
    :func:`train_rank`), and for 4 steps on the file dataset (written here
    on the card) with --augment --corrupt --eval-every 2 --trace in one
    process.  Started before phase cli-e2e (:meth:`start`),
    awaited when phase serve begins, before its profiled checks
    (:meth:`wait`), checked in phase train; each child's output goes to a
    file in ``root``."""

    def __init__(self):
        self.root = tempfile.mkdtemp(prefix="panodepth_smoke_train_")
        self.ckpt = {k: os.path.join(self.root, "ckpt_" + k)
                     for k in ("synth", "files")}
        self.trace = os.path.join(self.root, "trace")
        self.procs, self.logs, self.files = {}, {}, None

    def _spawn(self, name, args, rank=None):
        """``train_cli`` with ``args`` in a child; with ``rank``, as a rank of
        the two-process run through :func:`train_rank`."""
        self.logs[name] = os.path.join(self.root, name + ".log")
        cmd = ["-m", "panodepth_torch.train_cli"] if rank is None else [
            os.path.join(ROOT, "chip_smoke.py"), "--train-rank"]
        env = dict(os.environ, PYTHONPATH=ROOT)
        if rank is not None:  # two ranks beside the other children
            env.update(ONE_THREAD)
        with open(self.logs[name], "w") as out:
            self.procs[name] = subprocess.Popen(
                [sys.executable, *cmd, *args],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, text=True,
                env=env, preexec_fn=_background)

    def start(self):
        t0 = time.monotonic()
        self.files = _write_files(os.path.join(self.root, "files"))
        recipe = ["--batch-size", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
                  "--pano-width", "512", "--log-every", "1",
                  "--distill-from", TEACHER_CKPT, "--distill-weight", "0.5"]
        port = _free_port()
        for r in range(TRAIN_RANKS):
            self._spawn(f"synth{r}", [
                "fastpano", "x", "x", self.ckpt["synth"], "--synth",
                "--synth-version", "mix", "--steps", str(TRAIN_CLI_STEPS),
                *recipe, "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(TRAIN_RANKS), "--process-id", str(r)],
                rank=r)
        self._spawn("files", ["fastpano", self.files["rgb"],
                              self.files["gt"], self.ckpt["files"],
                              "--augment", "--corrupt", "--steps", "4",
                              "--eval-every", "2", "--trace", self.trace,
                              *recipe])
        self.t0 = t0
        print(f"train: the train_cli children started (the file dataset "
              f"written first; --synth as {TRAIN_RANKS} ranks) in "
              f"{time.monotonic() - t0:.2f} s", flush=True)

    def wait(self):
        """Wait for both children (no check here)."""
        for proc in self.procs.values():
            try:
                proc.wait(timeout=TRAIN_CLI_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if self.procs:
            print(f"train: the train_cli children have ended (awaited "
                  f"{time.monotonic() - self.t0:.2f} s after their start)",
                  flush=True)

    def output(self, name):
        """The child's output once it exited 0; raises with it if not."""
        proc = self.procs[name]
        proc.wait(timeout=TRAIN_CLI_TIMEOUT)
        with open(self.logs[name]) as fp:
            out = fp.read()
        if proc.returncode != 0:
            raise AssertionError(f"train_cli {name}: exit {proc.returncode}"
                                 f"\n{out[-4000:]}")
        return out

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.root, ignore_errors=True)


def _train_cli_files_check(trainers, persp, rgbs_u8):
    """The file child's holdout lines, finite val_loss, a trace with the
    card's kernels, and its exports run in the e2e graph beside the zoo NF
    net."""
    from panodepth_torch.e2e import load_model_checkpoint

    out = trainers.output("files")
    trace, tmp = trainers.trace, trainers.ckpt["files"]
    lines = [line for line in out.splitlines() if "[train]" in line]
    print("train_cli files: " + " | ".join(lines)[-900:])
    held = TRAIN_FILES_HELD_OUT
    for want in (f"[train] holding out {held} pairs for --eval-every "
                 f"validation",
                 f"[train] {TRAIN_FILES - held} pairs/host, 1 process(es)"):
        if not any(line.startswith(want) for line in lines):
            raise AssertionError(f"train_cli files: no line {want!r}")
    vals = [float(line.split()[-1]) for line in lines if " val " in line]
    if len(vals) != 2 or not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"train_cli files: val_loss {vals}")
    traces = [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"train_cli files: traces {traces}")
    with open(os.path.join(trace, traces[0])) as fp:
        events = json.load(fp)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"train_cli files: val_loss {vals!r}; trace {traces[0]} holds "
          f"{len(events)} events, {kernels} of them the card's kernels")
    if kernels == 0:
        raise AssertionError("train_cli files: the trace holds no kernel of "
                             "the card")
    base, _ = load_model_checkpoint(os.path.join(tmp,
                                                 "fastpano_final.params.npz"))
    dev = torch.device("cuda")
    rgbs = torch.stack([_pano_feed(r, dev) for r in rgbs_u8])
    e2e = _family_e2e("trained_files_fastpano", persp, base, rgbs,
                      replay_count=False)
    return dict(e2e, val_loss=vals, trace_kernels=kernels,
                trace_events=len(events))


def _merge_debug_nans(cfg, scene, merged0):
    """The merge CLI with --debug-nans on phase cli's first scene: the
    stages run eagerly (the Jacobi's launches counted), the output
    bit-equal to phase cli's."""
    from panodepth_torch import cli, io as pio
    from panodepth_torch.kernels import jacobi as kj

    layout = cfg.layout
    name = "pano_0000"
    with tempfile.TemporaryDirectory(prefix="panodepth_smoke_nans_") as root:
        d = {k: os.path.join(root, k) for k in
             ("rgb", "gt", "baseline", "views", "result_hohonet")}
        for path in d.values():
            os.makedirs(path)
        pio.save_png16(os.path.join(d["rgb"], name + ".png"),
                       np.zeros((8, 16), np.uint16))
        pio.save_png16(os.path.join(d["gt"], name + ".png"), scene["gt"])
        pio.save_png16(os.path.join(d["baseline"], name + ".depth.png"),
                       scene["base"])
        for v, view in enumerate(scene["views"]):
            pio.save_png16(os.path.join(
                d["views"], f"{name}.{layout.view_tag(v)}.png"), view)
        argv = ["0", d["rgb"], d["gt"], d["baseline"], d["result_hohonet"],
                "--no-extract", "--pmap-ext", ".png", "--views-folder",
                d["views"], "--layout", cfg.layout_name,
                "--out-width", str(cfg.out_width), "--debug-nans"]
        kj.LAUNCHES = 0
        t0 = time.perf_counter()
        log = stdio.StringIO()
        with contextlib.redirect_stdout(log):
            if cli.main(argv) != 0:
                raise AssertionError("cli.main --debug-nans returned non-zero")
        secs = time.perf_counter() - t0
        launches = kj.LAUNCHES
        got = pio.read_png(os.path.join(d["result_hohonet"], name + ".png"))
    want = sum(jacobi_launches(cfg))
    same = bool(np.array_equal(got, merged0))
    print(f"merge cli --debug-nans: {launches} jacobi launches (eager, "
          f"expected {want}), output bit-equal to phase cli's {same}, "
          f"{secs!r} s; it said {log.getvalue().splitlines()[0]!r}")
    if launches != want or not same:
        raise AssertionError("merge cli --debug-nans: launches or output")
    return dict(launches=launches, seconds=secs)


def _train_cli_ranks(trainers, smi):
    """The two-process --synth run: both ranks exited 0, only rank 0 said
    ``[train] done``, each named its backend, rank 0 logged the final
    checkpoint's digest agreeing over the ranks, and each rank's teacher
    ran 31 GroupNorm launches a step; each rank's step ms and idle share."""
    outs = [trainers.output(f"synth{r}") for r in range(TRAIN_RANKS)]
    recs = [_rank_record(out, f"train_cli rank {r}")
            for r, out in enumerate(outs)]
    print("train_cli rank 0: " + " | ".join(
        line for line in outs[0].splitlines()
        if line.startswith(("[train]", "[multihost]")))[-900:])
    want = TEACHER_NORMS * TRAIN_CLI_STEPS
    backends = [next((l.split("backend ")[1].split()[0]
                      for l in out.splitlines()
                      if l.startswith("[multihost]")), None) for out in outs]
    done = ["[train] done" in out for out in outs]
    digest = (f"[train] checkpoint final: the state agrees over the "
              f"{TRAIN_RANKS} processes (digest)") in outs[0]
    for rec, backend in zip(recs, backends):
        steady = rec["step_ms"][1]
        print(f"train_cli rank {rec['rank']} ({backend}): group_norm "
              f"launches {rec['group_norm']} (expected {want}: the teacher's "
              f"{TEACHER_NORMS} a step); step ms (host clock to a "
              f"synchronize, batch {TRAIN_BATCH // TRAIN_RANKS} a rank, both "
              f"ranks and other work sharing the card) {rec['step_ms']!r}, "
              f"the third step's device busy {rec['busy_ms']!r} ms, idle "
              f"share {1 - rec['busy_ms'][0] / steady!r} of the second's; "
              f"card: {smi}")
    print(f"train_cli ranks: [train] done by rank {done}, backends "
          f"{backends}, final digest agreed {digest}")
    if done != [True] + [False] * (TRAIN_RANKS - 1) or not digest or \
            None in backends or any(r["group_norm"] != want for r in recs):
        raise AssertionError("train_cli ranks: done lines, digest, backend "
                             "or teacher launches")
    return dict(ranks=recs, backends=backends)


def _train_cli_check(trainers, persp, rgbs_u8, smi):
    """The two-process --synth run's ranks (:func:`_train_cli_ranks`) and
    its exports: the sidecar, ``fastpano_final`` and its npz, which
    ``load_model_checkpoint`` reads; the e2e graph (both kernels) on those
    weights beside the zoo NF net."""
    from panodepth_torch.e2e import load_model_checkpoint

    ranks = _train_cli_ranks(trainers, smi)
    tmp = trainers.ckpt["synth"]
    for name in ("fastpano.config.json", "fastpano_final",
                 "fastpano_final.params.npz"):
        if not os.path.exists(os.path.join(tmp, name)):
            raise AssertionError(f"train_cli wrote no {name}")
    base, arch = load_model_checkpoint(
        os.path.join(tmp, "fastpano_final.params.npz"))
    dev = torch.device("cuda")
    rgbs = torch.stack([_pano_feed(r, dev) for r in rgbs_u8])
    out = _family_e2e("trained_fastpano", persp, base, rgbs,
                      replay_count=False)
    # for the record: the profiler's count of one eager forward's launches
    feed = _family_input("fastpano", rgbs[:1])
    with torch.no_grad():
        _, events = _device_profile(lambda: base(feed))
    seen = sum(n for _, n, key in events if "gn_cluster" in key)
    print(f"train_cli weights: one eager forward under the profiler, "
          f"{seen} groupnorm launches of {GN_CALLS}")
    return dict(out, eager_profiled_launches=seen, ranks=ranks)


def _train_evaluate():
    """``evaluate`` on the zoo FastPanoNet, 16 v1 scenes at seed 77 000,
    through the kernel (launches counted) and through the plain route."""
    from panodepth_torch.kernels import groupnorm as kg
    from panodepth_torch.models import evaluate as peval

    kg.LAUNCHES = 0
    t0 = time.perf_counter()
    got = peval.evaluate(BASE_CKPT, count=16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kg.LAUNCHES
    plain = peval.evaluate(BASE_CKPT, count=16, groupnorm="torch")
    diff = {k: abs(got[k] - plain[k]) for k in ("rmse", "mae", "delta1")}
    off = got["rmse"] / ZOO_FASTPANO_RMSE - 1
    print(f"train evaluate zoo fastpano (16 v1 scenes, seed 77000): rmse "
          f"{got['rmse']!r} (zoo/README.md {ZOO_FASTPANO_RMSE}, "
          f"{100 * off:+.1f} %), delta1 {got['delta1']!r} "
          f"({ZOO_FASTPANO_DELTA1}), mae {got['mae']!r}, constant floor "
          f"{got['rmse_const']!r}; {launches} groupnorm launches, "
          f"{secs!r} s; kernel vs plain route |diff| {diff!r}")
    if launches != 4 * GN_CALLS * kg.launches_per_call():
        raise AssertionError(f"evaluate: {launches} groupnorm launches, "
                             f"expected {4 * GN_CALLS} (4 batches)")
    if max(diff.values()) > 1e-6 or not np.isfinite(got["rmse"]):
        raise AssertionError(f"evaluate: kernel route vs plain route {diff}")
    if abs(off) > 0.05:
        print(f"train evaluate: rmse {100 * off:+.1f} % off the zoo's "
              f"number (PERF.md says why)")
    kg.LAUNCHES = 0
    bad = peval.evaluate(BASE_CKPT, count=16, corrupt=True)
    torch.cuda.synchronize()
    bad_launches = kg.LAUNCHES
    print(f"train evaluate --corrupt zoo fastpano (the same scenes, "
          f"eval_corruption: gain 0.85, gamma 1.15, noise 0.02, JPEG q40): "
          f"rmse {bad['rmse']!r} against clean {got['rmse']!r} (delta "
          f"{bad['rmse'] - got['rmse']!r}), delta1 {bad['delta1']!r} against "
          f"{got['delta1']!r}; {bad_launches} groupnorm launches")
    if bad_launches != 4 * GN_CALLS * kg.launches_per_call() or not \
            bad["corrupt"] or not np.isfinite(bad["rmse"]):
        raise AssertionError(f"evaluate --corrupt: {bad_launches} groupnorm "
                             f"launches, record {bad}")
    from panodepth_torch.kernels import qconv as kq

    kq.LAUNCHES = kq.QUANTIZE_LAUNCHES = 0
    i8 = peval.evaluate(GN_PERSP_CKPT, count=16, int8=True)
    torch.cuda.synchronize()
    i8_launches, i8_quantize = kq.LAUNCHES, kq.QUANTIZE_LAUNCHES
    fl = peval.evaluate(GN_PERSP_CKPT, count=16)
    print(f"train evaluate --int8 zoo GN perspective net (16 v1 scenes, "
          f"seed 77000): rmse {i8['rmse']!r}, delta1 {i8['delta1']!r}; "
          f"without --int8 rmse {fl['rmse']!r}, delta1 {fl['delta1']!r}; "
          f"{i8_launches} qconv and {i8_quantize} quantize launches")
    if (i8_launches, i8_quantize) != (
            4 * GN_INT8_QCONVS, 4 * GN_INT8_QCONVS * kq.QUANTIZE_KERNELS) or \
            not i8["int8"] or not np.isfinite(i8["rmse"]):
        raise AssertionError(f"evaluate --int8: {i8_launches} qconv and "
                             f"{i8_quantize} quantize launches, record {i8}")
    return dict(got, launches=launches, seconds=secs,
                route_diff=diff, rmse_off=off,
                corrupt=dict(bad, launches=bad_launches),
                gn_int8=dict(rmse=i8["rmse"], delta1=i8["delta1"],
                             launches=i8_launches,
                             quantize_launches=i8_quantize,
                             float_rmse=fl["rmse"],
                             float_delta1=fl["delta1"]))


class _Parts:
    """Seconds of a phase's parts, each printed as it ends."""

    def __init__(self, phase):
        self.phase, self.seconds, self.t0 = phase, {}, time.monotonic()

    def done(self, name):
        now = time.monotonic()
        self.seconds[name] = now - self.t0
        self.t0 = now
        print(f"[part] {self.phase} {name} in {self.seconds[name]:.2f} s",
              flush=True)


def phase_train(cfg, scenes, merged0, persp, rgbs_u8, trainers, smi):
    """Training at full width on the card: FastPanoNet with the zoo recipe
    and its distillation teacher, the NF perspective net, each also on the
    file dataset (decode, --augment, --corrupt) in turns against --synth,
    two steps of each other family, the card's step against the CPU's, the
    corruption on the card against the CPU's, ``evaluate`` on the zoo's
    FastPanoNet clean and with --corrupt, the merge CLI with --debug-nans,
    and ``trainers``' two ``train_cli`` runs (--synth as two ranks; files
    with the holdout and --trace; run beside phases cli-e2e and stage-a)
    with the e2e graph on their weights."""
    from panodepth_torch.e2e import load_model_checkpoint

    parts = _Parts("train")
    files = trainers.files
    decode = _train_decode(files)
    parts.done("decode")
    teacher, _ = load_model_checkpoint(TEACHER_CKPT)
    fast = _train_reading("fastpano + teacher", _train_net(
        dict(model="fastpano")), "pano", teacher=teacher, size=512,
        files=files)
    del teacher
    torch.cuda.empty_cache()
    parts.done("fastpano readings")
    nf = _train_reading("perspective nf", _train_net(
        dict(model="perspective", variant="nf")), "perspective", size=256,
        files=files)
    torch.cuda.empty_cache()
    parts.done("perspective readings")
    others = _train_families()
    parts.done("other families")
    card_cpu = _train_card_vs_cpu()
    corrupt_cpu = _train_corrupt_card_vs_cpu(fast["files"].pop("rgb"))
    nf["files"].pop("rgb")
    ev = _train_evaluate()
    nans = _merge_debug_nans(cfg, scenes[0], merged0)
    parts.done("card vs cpu, evaluate, merge --debug-nans")
    cli_e2e = _train_cli_check(trainers, persp, rgbs_u8, smi)
    cli_files = _train_cli_files_check(trainers, persp, rgbs_u8)
    parts.done("train_cli children's checks")
    return dict(fastpano=fast, perspective_nf=nf, families=others,
                card_vs_cpu=card_cpu, corrupt_card_vs_cpu=corrupt_cpu,
                evaluate=ev, cli_e2e=cli_e2e, cli_files=cli_files,
                decode=decode, files_write_s=files["write_s"],
                merge_debug_nans=nans, parts=parts.seconds)


def pio_metrics(scene, emap, out, cfg):
    """The u16 output scored against the scene's gt."""
    from panodepth_torch import paired_metrics

    gt = torch.tensor(_as01(scene["gt"]), device=emap.device)
    return paired_metrics(gt, emap, out.to(torch.float32) / 65535.0,
                          align_way=cfg.align_way, cap_depth=cfg.cap_depth,
                          zenith_range=cfg.zenith_range)


def main():
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card")
    from panodepth_torch import MergeConfig
    from panodepth_torch.e2e import load_model_checkpoint

    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    with Phase("device"):
        name, smi = phase_device()
    with Phase("build"):
        phase_build()
    cfg_4096 = MergeConfig(layout_name="5fold_leres", out_width=4096)
    serve_tmp = tempfile.mkdtemp(prefix="panodepth_smoke_serve_")
    cli_tmp = tempfile.mkdtemp(prefix="panodepth_smoke_cli_")
    trainers = Trainers()
    dp = None
    # SliceNet's export, the longest (90-135 s), runs from here on, the
    # other exports from phase stage-a on, each a child at background
    # priority on one thread, so that phase families times its graphs
    # beside none and phase serve finds the artifacts written
    early = serve_exports_start(cfg, serve_tmp, SERVE_EARLY)
    try:
        with Phase("kernel"):
            jac = phase_kernel(cfg, cfg_4096)
        with Phase("merge"):
            scenes = _threaded([lambda i=i: make_scene(cfg, SEED + i)
                                for i in range(2)])
            merged0, merge_launches, warm_ms, library = phase_merge(
                cfg, scenes[0])
        with Phase("cli"):
            analyzed, paeth_files = phase_cli(cfg, scenes, merged0, cli_tmp)
        with Phase("groupnorm"):
            persp, _ = load_model_checkpoint(PERSP_CKPT)
            base, _ = load_model_checkpoint(BASE_CKPT)
            rgbs = _threaded([lambda i=i: make_rgb(SEED + i, 2048)
                              for i in range(2)])
            gn = phase_groupnorm(base, rgbs)
        with Phase("models"):
            models = phase_models(persp, base, rgbs[0])
        # the dp pair starts here and imports while phase e2e runs; it
        # touches the card after it (dp.go)
        dp = DPPair(scenes, rgbs)
        with Phase("e2e"):
            e2e = phase_e2e(persp, base, rgbs)
        # phase train's train_cli children (the --synth run as two ranks)
        # and the dp pair run beside phases cli-e2e and stage-a, which
        # profile nothing (~20 s); the dp pair is awaited and checked in
        # phase graphs after its compiled forms, the train_cli children
        # awaited when phase serve begins, before its profiled checks
        dp.go()
        trainers.start()
        with Phase("cli-e2e"):
            phase_cli_e2e(rgbs, scenes[0]["gt"], e2e)
        early.update(serve_exports_start(cfg, serve_tmp, SERVE_EXPORTS))
        with Phase("stage-a"):
            stage_a = phase_stage_a(cfg, scenes, rgbs)
        with Phase("graphs"):
            graphs = phase_graphs(cfg, cfg_4096, scenes, persp, base, rgbs,
                                  e2e, dp, smi, paeth_files)
        with Phase("batched"):
            batched = phase_batched(cfg, cfg_4096)
        with Phase("families"):
            families = phase_families(persp, base, rgbs)
            families["gn_int8"]["cli_launches"] = phase_families_cli(
                rgbs, families["gn_int8"].pop("graph"))
        with Phase("serve"):
            served = phase_serve(cfg, scenes, persp, base, rgbs, serve_tmp,
                                 early, trainers)
        with Phase("train"):
            trained = phase_train(cfg, scenes, merged0, persp, rgbs,
                                  trainers, smi)
    finally:
        for proc in early.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(serve_tmp, ignore_errors=True)
        shutil.rmtree(cli_tmp, ignore_errors=True)
        trainers.close()
        if dp is not None:
            dp.close()

    int8 = families["gn_int8"]
    quantized = int8["qconv"]["quantize"]
    kernels = [dict(
        name="jacobi", route="cuda", source="panodepth_torch/csrc/jacobi.cu",
        replaces="panodepth/kernels/jacobi.py:98",
        launches=e2e["launches"]["jacobi"], max_abs_err=jac["max_abs_err"],
        ms=jac["ms"], kernel_ms=jac["ms"], plain_ms=jac["plain_ms"],
        bound_ms=jac["bound_ms"], bound_by=jac["bound_by"], library_ms=None,
        launches_by_path=dict(
            merge=merge_launches, e2e=e2e["launches"]["jacobi"],
            merge_batched=graphs["batched_launches"],
            e2e_graph=e2e["launches"]["jacobi"],
            serve_merge=served["merge"]["launches"]["jacobi"],
            serve_e2e=served["e2e"]["launches"]["jacobi"],
            merge_debug_nans=trained["merge_debug_nans"]["launches"],
            **{f"dp_merge_rank{r['rank']}": r["merge_launches"]["jacobi"]
               for r in graphs["dp"]["ranks"]},
            **{f"dp_e2e_rank{r['rank']}": r["e2e_launches"]["jacobi"]
               for r in graphs["dp"]["ranks"]},
            **{f"sp_merge_rank{r['rank']}": r["sp_merge"]["launches"]
               for r in graphs["dp"]["ranks"]},
            **{f"latency_rank{r['rank']}": r["latency"]["launches"]["jacobi"]
               for r in graphs["dp"]["ranks"]},
            **{f"latency_driver_rank{r['rank']}": r["latency"][
                "driver_launches"]["jacobi"] for r in graphs["dp"]["ranks"]}),
        ms_per_pano_by_batch=batched,
        device_ms_in_e2e_graph=e2e["kernel_ms"].get("jacobi"),
        levels=jac["levels"]), dict(
        name="group_norm", route="cuda",
        source="panodepth_torch/csrc/groupnorm.cu",
        replaces="panodepth/kernels/groupnorm.py:128",
        launches=e2e["launches"]["group_norm"], max_abs_err=gn["max_abs_err"],
        ms=gn["ms"], plain_ms=gn["plain_ms"], bound_ms=gn["bound_ms"],
        bound_by=gn["bound_by"], library_ms=gn["library_ms"],
        device_ms=gn["device_ms"], library_device_ms=gn["library_device_ms"],
        calls_per_forward=gn["calls"],
        device_ms_in_e2e_graph=e2e["kernel_ms"].get("group_norm"),
        launches_by_path=dict(
            e2e=e2e["launches"]["group_norm"],
            e2e_graph=e2e["launches"]["group_norm"],
            **{f"e2e_{k}": v["e2e"]["launches"]["group_norm"]
               for k, v in families.items()},
            serve_merge=served["merge"]["launches"]["group_norm"],
            serve_e2e=served["e2e"]["launches"]["group_norm"],
            **{f"serve_{k}": v["launches"]["group_norm"]
               for k, v in served["families"].items()},
            train_student=trained["fastpano"]["launches_student"],
            train_teacher=trained["fastpano"]["launches_teacher"],
            evaluate=trained["evaluate"]["launches"],
            e2e_trained_fastpano=trained["cli_e2e"]["launches"][
                "group_norm"],
            train_files_teacher=trained["fastpano"]["files"][
                "launches_teacher"],
            evaluate_corrupt=trained["evaluate"]["corrupt"]["launches"],
            e2e_trained_files_fastpano=trained["cli_files"]["launches"][
                "group_norm"],
            **{f"dp_e2e_rank{r['rank']}": r["e2e_launches"]["group_norm"]
               for r in graphs["dp"]["ranks"]},
            **{f"latency_rank{r['rank']}": r["latency"]["launches"][
                "group_norm"] for r in graphs["dp"]["ranks"]},
            **{f"latency_driver_rank{r['rank']}": r["latency"][
                "driver_launches"]["group_norm"]
               for r in graphs["dp"]["ranks"]},
            **{f"train_cli_rank{r['rank']}_teacher": r["group_norm"]
               for r in trained["cli_e2e"]["ranks"]["ranks"]}),
        families={k: dict(v["groupnorm"], e2e_ms_per_pano=v["e2e"][
            "ms_per_pano"], e2e_idle_share=v["e2e"]["idle_share"])
            for k, v in families.items() if "groupnorm" in v}), dict(
        name="qconv", route="cuda", source="panodepth_torch/csrc/qconv.cu",
        # not a TPU kernel: the port's own kernel for XLA's int8 conv
        replaces="panodepth/models/perspective.py:68",
        launches=int8["e2e"]["launches"]["qconv"],
        max_abs_err=int8["qconv"]["max_abs_err"], ms=int8["qconv"]["ms"],
        plain_ms=int8["qconv"]["plain_ms"],
        bound_ms=int8["qconv"]["bound_ms"],
        bound_by=int8["qconv"]["bound_by"],
        library_ms=int8["qconv"]["library_ms"],
        bf16_conv_ms=int8["qconv"]["bf16_conv_ms"],
        device_ms=int8["qconv"]["device_ms"],
        calls_per_forward=int8["qconv"]["calls"],
        device_ms_in_e2e_graph=int8["e2e"]["qconv_graph_ms"],
        launches_by_path=dict(
            e2e_gn_int8=int8["e2e"]["launches"]["qconv"],
            cli_int8=int8["cli_launches"]["qconv"],
            serve_gn_int8=served["families"]["gn_int8"]["launches"]["qconv"],
            evaluate_int8=trained["evaluate"]["gn_int8"]["launches"]),
        shapes=int8["qconv"]["shapes"]), dict(
        name="quantize_nhwc", route="cuda",
        source="panodepth_torch/csrc/quantize.cu",
        # not a TPU kernel: XLA's fusion of QConv's quantization
        replaces="panodepth/models/perspective.py:62",
        launches=int8["e2e"]["launches"]["quantize"],
        max_abs_err=quantized["max_abs_err"], ms=quantized["ms"],
        plain_ms=quantized["plain_ms"], bound_ms=quantized["bound_ms"],
        bound_by=quantized["bound_by"], library_ms=None,
        calls_per_forward=quantized["calls"],
        launches_per_call=quantized["launches_per_call"],
        device_ms_in_e2e_graph=int8["e2e"]["quantize_graph_ms"],
        launches_by_path=dict(
            e2e_gn_int8=int8["e2e"]["launches"]["quantize"],
            cli_int8=int8["cli_launches"]["quantize"],
            serve_gn_int8=served["families"]["gn_int8"]["launches"][
                "quantize"],
            evaluate_int8=trained["evaluate"]["gn_int8"][
                "quantize_launches"]),
        shapes=quantized["shapes"], edges=quantized["edges"])]
    print(f"merge warm ms per panorama: {warm_ms!r}; merge library: "
          f"{library!r}; e2e warm ms per "
          f"panorama: {e2e['warm']!r}, device busy {e2e['busy_ms']!r} of "
          f"{e2e['call_ms']!r} ms per 2-panorama call; e2e options: "
          f"{e2e['options']!r}; nets: {models!r}; "
          f"stage A: {stage_a!r}; graphs: {graphs!r}; analyze: "
          f"{analyzed!r}; int8: {int8!r}; serve: {served!r}; "
          f"train: {trained!r}; card: {smi}")
    print(f"chip_smoke wall time: {time.monotonic() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rank"]:
        raise SystemExit(train_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--dp-worker"]:
        raise SystemExit(dp_rank(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4]))
    main()
