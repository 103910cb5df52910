#!/usr/bin/env python3
"""Where the quantization kernel's time goes, by switching its parts off.

    python3 scripts/quantize_probe.py

Builds ``panodepth_torch/csrc/quantize.cu`` again with one or more of its
parts removed by rewriting the source (the wait for an image's blocks,
the absmax, the codes' arithmetic, their stores, the whole codes pass,
the exact redo of the codes near a tie; a sleep between the wait's
polls), into the git-ignored
``panodepth_torch/_build/probe/``, and
times each form with the plan ``kernels/qconv.quantize_plan`` gives, from
a CUDA graph, on some of the GN perspective net's quantization inputs at
15 views (random activations).  The forms without a part compute wrong
codes: they are for timing only.  It needs one CUDA card and nvcc, prints
the card's name and power limit, then one line a shape (ms a call of each
form) and, last, a JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (its device line and graph timer)
from panodepth_torch.kernels import _build  # noqa: E402
from panodepth_torch.kernels import qconv as kq  # noqa: E402

# (text in csrc/quantize.cu, its replacement) for each part switched off
PARTS = {
    "wait": ("    while (ld_acquire(w + 1) < static_cast<unsigned>(spi))",
             "    while (0)"),
    "absmax": ("  m = max(m, tile_absmax<T>(smem + st * p.stage, p, c0));",
               "  m = max(m, 0u);"),
    "math": ("      unsigned mask = codes16(src, p.bw, 16 * g, vr, rcp, lo, "
             "hi);",
             "      unsigned mask = lo[0] = lo[1] = lo[2] = lo[3] = hi[0] = "
             "hi[1] = hi[2] = hi[3] = 0;"),
    "stores": ("      if (p0 + r0 + pc < p.pixels)", "      if (0)"),
    "codes": ("      tile_codes<T>(smem + st * p.stage,",
              "      if (0) tile_codes<T>(smem + st * p.stage,"),
    "div": ("      while (mask) {", "      while (0) {"),
    "sleep": ("      if (clock64() - t0 > (1LL << 34)) __trap();\n"
              "    const float a",
              "      { __nanosleep(128); if (clock64() - t0 > (1LL << 34)) "
              "__trap(); }\n    const float a"),
}
FORMS = {"full": (), "no wait": ("wait",), "no absmax": ("absmax",),
         "no tie check": ("div",), "no code math": ("math",),
         "no stores": ("stores",), "no codes": ("codes",),
         "sleep in the wait": ("sleep",),
         "loads only": ("wait", "absmax", "codes")}
# (N, C, H, W, dtype): the net's largest inputs and two small ones
SHAPES = [(15, 64, 256, 256, "bfloat16"), (15, 128, 128, 128, "float32"),
          (15, 128, 64, 64, "float32"), (15, 64, 64, 64, "float32"),
          (15, 512, 8, 8, "float32"), (15, 128, 16, 16, "bfloat16")]


def build_forms():
    """{form: the loaded library} of every form, nvcc runs in parallel."""
    src = _build.source_path("quantize").read_text()
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for form, parts in FORMS.items():
        text = src
        for part in parts:
            old, new = PARTS[part]
            if text.count(old) != 1:
                raise SystemExit(f"quantize_probe: csrc/quantize.cu no "
                                 f"longer has the {part} line this probe "
                                 f"rewrites")
            text = text.replace(old, new)
        name = "quantize_" + form.replace(" ", "_").replace(",", "")
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[form] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for form, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"quantize_probe: nvcc failed on {form}:\n{log}")
        lib = ctypes.CDLL(str(so))
        kq.set_quantize_argtypes(lib)
        libs[form] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("quantize_probe: needs a CUDA card")
    _, smi = chip_smoke.phase_device()
    libs = build_forms()
    rng = np.random.RandomState(chip_smoke.SEED)
    rows = []
    for n, c, h, w, dtype in SHAPES:
        x = torch.tensor(rng.normal(0, 1, (n, c, h, w)).astype(np.float32),
                         device="cuda").to(getattr(torch, dtype))
        plan = chip_smoke._quantize_plan_of(x)
        want_q, _ = kq.quantize_nhwc_plain(x)
        got_q, _ = kq._quantize_launch(x, plan, libs["full"])
        if not torch.equal(got_q, want_q):
            raise AssertionError(f"quantize_probe: the full form differs "
                                 f"from the plain pass at {(n, c, h, w)}")
        ms = {form: chip_smoke._graph_ms(
            lambda lib=lib: kq._quantize_launch(x, plan, lib), 5, 3)
            for form, lib in libs.items()}
        rows.append(dict(shape=[n, c, h, w, dtype], ms=ms))
        print(f"quantize_probe (N, C, H, W) {(n, c, h, w)} {dtype}, "
              f"{chip_smoke._plan_text(plan)}: "
              + ", ".join(f"{form} {t:.4f}" for form, t in ms.items())
              + " ms")
    print(smi)
    print(json.dumps(dict(card=smi, shapes=rows)))


if __name__ == "__main__":
    main()
