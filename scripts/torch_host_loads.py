#!/usr/bin/env python3
"""The merge's file loads on the host, for one checkout or two in turns.

    python3 scripts/torch_host_loads.py [--old-tree DIR] [--rounds 2]
                                        [--decode-only] [--cpus N]

Writes ``chip_smoke.py``'s first scene (5fold_leres at 2048: a 1024x512
baseline and 15 views 1024 wide, u16 PNGs) into a temporary directory
twice: as ``io.save_png16`` writes it (every row Up) and with Paeth and
Average rows (``chip_smoke.write_png_filtered``), the filters libpng and
OpenCV choose.  Then each checkout runs in a child process of its own
(with ``--old-tree``, in turns: old, new, new, old, ``--rounds`` times
two), which prints one JSON line:

* ``load_ms``: one panorama's 16 files through ``pipeline._load_inputs``
  (the route that checkout takes), median of 3; on the Paeth files only
  where the checkout has the native codec (a Python Paeth decode takes
  about a second a file);
* with the native codec, the Python twin (``io.read_png_py``) one file
  after another on the Up files and on one Paeth view, and the native
  codec one after another against the prefetcher on 8 threads (in turns,
  six times each, medians);
* without ``--decode-only`` (which runs on the CPU), on the card:
  ``merge_many`` at batch 24 on 24 items sharing the Up files, a first
  call (the capture) and one under the profiler: host ms a panorama,
  device busy ms and idle share, and the sha256 of the outputs.

``--cpus N`` pins each child to the first N CPUs of its affinity (its own
threads only), so that the prefetcher (capped at the affinity) is timed
against the serial decode on a host of N CPUs.

An earlier checkout needs only its ``panodepth_torch/`` unpacked into
``DIR`` (``git archive <commit> panodepth_torch | tar -x -C DIR``, into a
git-ignored directory); its sources build into ``DIR``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 24


def _write_scene(root):
    """The scene's 16 files under ``root``/up and ``root``/paeth; returns
    {kind: [baseline, views...]}."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from panodepth_torch import MergeConfig, io as pio

    cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
    sc = cs.make_scene(cfg, cs.SEED)
    maps = [sc["base"]] + list(sc["views"])
    files = {}
    for kind in ("up", "paeth"):
        os.makedirs(os.path.join(root, kind))
        files[kind] = [os.path.join(root, kind, f"m{i:02d}.png")
                       for i in range(len(maps))]
    cs._threaded(
        [lambda f=f, m=m: pio.save_png16(f, m)
         for f, m in zip(files["up"], maps)]
        + [lambda f=f, m=m: cs.write_png_filtered(f, m, cs.PAETH_AVERAGE)
           for f, m in zip(files["paeth"], maps)])
    return files


def _median_ms(fn, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def child(tree, files, decode_only, cpus, root):
    """One checkout's readings (run with that checkout first on the path);
    the merge's outputs go under ``root`` and are removed."""
    if cpus:
        os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:cpus])
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from panodepth_torch import MergeConfig, io as pio, pipeline

    native = hasattr(pio, "read_png_py")
    rec = dict(tree=tree, native=native, cpus=len(os.sched_getaffinity(0)))
    load = {}
    for kind in ("up", "paeth") if native else ("up",):
        fs = files[kind]
        load[kind] = _median_ms(lambda: pipeline._load_inputs(fs[0], fs[1:]))
    rec["load_ms"] = load
    if native:
        from panodepth_torch.utils import nativeio

        def prefetched(fs):
            with nativeio.BatchPrefetcher(fs, threads=8) as pf:
                return [pf.get(i) for i in range(len(fs))]

        up, paeth = files["up"], files["paeth"]
        dec = dict(
            up_twin_serial=_median_ms(
                lambda: [pio.read_png_py(f) for f in up], 1),
            paeth_twin_one_view=_median_ms(
                lambda: pio.read_png_py(paeth[1]), 1),
            prefetcher_threads=min(8, nativeio._ncpu(), len(up)))
        for kind, fs in (("up", up), ("paeth", paeth)):
            turns = dict(native_serial=[], prefetcher=[])
            for _ in range(3):  # in turns: serial, prefetcher, prefetcher,
                for way in ("native_serial", "prefetcher", "prefetcher",
                            "native_serial"):  # serial
                    turns[way].append(_median_ms(
                        (lambda: [pio.read_png(f) for f in fs])
                        if way == "native_serial" else
                        (lambda: prefetched(fs)), 1))
            for way, ts in turns.items():
                dec[f"{kind}_{way}"] = sorted(ts)[len(ts) // 2]
        rec["decode_ms"] = dec
    if not decode_only:
        sys.path.insert(1, ROOT)
        import chip_smoke as cs

        cfg = MergeConfig(layout_name="5fold_leres", out_width=2048)
        out = tempfile.mkdtemp(prefix="merge_", dir=root)
        items = [dict(baseline=files["up"][0], pmaps=files["up"][1:],
                      out=os.path.join(out, f"{j}.png")) for j in range(BATCH)]
        calls = []

        def run():
            t0 = time.perf_counter()
            res = pipeline.merge_many(items, cfg, batch_size=BATCH,
                                      device="cuda", log=lambda *a: None)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0) * 1e3)
            return res

        res = run()
        busy, _ = cs._device_profile(run)
        digest = hashlib.sha256(b"".join(
            np.ascontiguousarray(r.out_u16).tobytes() for r in res))
        shutil.rmtree(out)
        rec["merge_many_b24"] = dict(
            calls_ms=calls, host_ms_per_pano=calls[-1] / BATCH,
            busy_ms=busy, idle_share=(1 - busy / calls[-1]) if busy else None,
            sha256=digest.hexdigest())
    print(json.dumps(rec))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-tree", help="directory holding an earlier "
                    "checkout's panodepth_torch/")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--decode-only", action="store_true",
                    help="the decodes only (no card needed)")
    ap.add_argument("--cpus", type=int, default=0,
                    help="pin each child to this many CPUs")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "FILES_JSON"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        with open(args.child[1]) as fp:
            child(args.child[0], json.load(fp), args.decode_only, args.cpus,
                  os.path.dirname(args.child[1]))
        return
    sys.path.insert(0, ROOT)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi"
    print(f"host: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} in "
          f"this process's affinity; card: {smi or 'none'}")
    with tempfile.TemporaryDirectory(prefix="panodepth_loads_") as root:
        files = _write_scene(root)
        spec = os.path.join(root, "files.json")
        with open(spec, "w") as fp:
            json.dump(files, fp)
        order = ["new"] if not args.old_tree else \
            ["old", "new", "new", "old"] * args.rounds
        trees = dict(new=ROOT, old=os.path.abspath(args.old_tree or ROOT))
        recs = []
        for tag in order:
            cmd = [sys.executable, os.path.abspath(__file__), "--child",
                   trees[tag], spec, "--cpus", str(args.cpus)] + (
                       ["--decode-only"] if args.decode_only else [])
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=900)
            if out.returncode:
                raise SystemExit(f"{tag} tree failed:\n{out.stdout}\n"
                                 f"{out.stderr}")
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            rec["turn"] = tag
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    if args.old_tree and not args.decode_only:
        hashes = {r["merge_many_b24"]["sha256"] for r in recs}
        print(f"merge_many batch {BATCH} outputs equal over the trees: "
              f"{len(hashes) == 1}")
        if len(hashes) != 1:
            raise SystemExit("the trees' outputs differ")


if __name__ == "__main__":
    main()
