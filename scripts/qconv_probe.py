#!/usr/bin/env python3
"""Where the int8 conv kernel's time goes, by switching its parts off.

    python3 scripts/qconv_probe.py

Builds ``panodepth_torch/csrc/qconv.cu`` again with one or more of its
parts removed by rewriting the source (the A gather's reads become
zero-fills, B's TMA loads are skipped, the wgmma's are skipped, the output
stores are skipped; every barrier, wait and the staging stay), into the
git-ignored ``panodepth_torch/_build/probe/``, and times each form with
the plan ``kernels/qconv.qconv_plan`` gives, from a CUDA graph, on the GN
perspective net's largest int8 conv shapes at 15 views (random codes).
The forms without a part compute wrong sums: they are for timing only.
It needs one CUDA card and nvcc, prints the card's name and power limit,
then one line a shape (ms a call of each form) and, last, a JSON line.
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

# (text in csrc/qconv.cu, its replacement) for each part switched off
PARTS = {
    "A": ("      cp_async16(dst + i * 32 * BK, ok ? x + a_row[i] + off : x,",
          "      cp_async16(dst + i * 32 * BK, x, 0 *"),  # size (0 * ok) ? ...
    "B": ("      mbar_expect_tx(bar0 + 8 * stage, BN * BK);\n"
          "      tma_load_2d(",
          "      mbar_expect_tx(bar0 + 8 * stage, 0);\n"
          "      if (0) tma_load_2d("),
    "mma": ("      wgmma_tile<BN>(acc, sw128_desc(a_st + 32 * k),",
            "      if (0) wgmma_tile<BN>(acc, sw128_desc(a_st + 32 * k),"),
    "stores": ("    if (c >= p.cout) break;", "    break;"),
    "fence": ("    fence_proxy_async();\n    wgmma_wait<1>();",
              "    wgmma_wait<1>();"),
}
FORMS = {"full": (), "no A": ("A",), "no B": ("B",), "no mma": ("mma",),
         "no stores": ("stores",), "stores only": ("A", "B", "mma"),
         "none": ("A", "B", "mma", "stores"), "no fence": ("fence",)}
# (N, H, W, Cin, Cout, k, stride): the net's largest convs at 15 views
SHAPES = [(15, 128, 128, 128, 128, 3, 1), (15, 256, 256, 64, 32, 3, 1),
          (15, 256, 256, 3, 32, 7, 2), (15, 128, 128, 128, 64, 3, 1),
          (15, 64, 64, 128, 128, 3, 1), (15, 8, 8, 512, 512, 3, 1)]


def build_forms():
    """{form: the loaded library} of every form, nvcc runs in parallel."""
    src = _build.source_path("qconv").read_text()
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for form, parts in FORMS.items():
        text = src
        for part in parts:
            old, new = PARTS[part]
            if text.count(old) != 1:
                raise SystemExit(f"qconv_probe: csrc/qconv.cu no longer has "
                                 f"the {part} line this probe rewrites")
            text = text.replace(old, new)
        name = form.replace(" ", "_")
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
            raise SystemExit(f"qconv_probe: nvcc failed on {form}:\n{log}")
        lib = ctypes.CDLL(str(so))
        kq.set_qconv_argtypes(lib)
        libs[form] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("qconv_probe: needs a CUDA card")
    _, smi = chip_smoke.phase_device()
    libs = build_forms()
    rng = np.random.RandomState(chip_smoke.SEED)
    rows = []
    for n, h, w, cin, cout, k, s in SHAPES:
        cinp = -(-cin // kq.CIN_ALIGN) * kq.CIN_ALIGN
        xq = torch.tensor(rng.randint(-127, 128, (n, h, w, cinp)).astype(
            np.int8), device="cuda")
        wq = kq.prepare_weight(torch.tensor(rng.randint(
            -127, 128, (cout, cin, k, k)).astype(np.int8))).cuda()
        sx = torch.rand(n, device="cuda")
        scale = torch.rand(cout, device="cuda") * 1e-3
        bias = torch.rand(cout, device="cuda")
        pads = (kq.same_pads(h, k, s), kq.same_pads(w, k, s))
        ho, wo = kq.out_size(h, k, s, pads[0]), kq.out_size(w, k, s, pads[1])
        plan = kq.qconv_plan(n, h, w, cinp, cout, k, k, s, s, pads)
        y = torch.empty(n, cout, ho, wo, dtype=torch.bfloat16, device="cuda")
        ws = torch.empty(max(1, plan.workspace_bytes), dtype=torch.uint8,
                         device="cuda")
        times = {}
        for form, lib in libs.items():
            def run(lib=lib):
                err = lib.panodepth_qconv(
                    xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                    scale.data_ptr(), bias.data_ptr(), y.data_ptr(), 1, None,
                    ws.data_ptr(), n, h, w, cinp, cout, k, k, wq.shape[1], s,
                    s, pads[0][0], pads[1][0], ho, wo, plan.bn, plan.stages,
                    plan.splits, plan.smem_bytes,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"qconv_probe: {form} failed ({err})")
            times[form] = chip_smoke._graph_ms(run, 5, 5)
        shape = (n, h, w, cin, cout, k, s)
        rows.append(dict(shape=shape, plan=[plan.bn, plan.stages,
                                            plan.splits], ms=times))
        print(f"qconv_probe {shape} plan (bn, stages, splits) "
              f"{rows[-1]['plan']}: " + ", ".join(
                  f"{f} {t!r} ms" for f, t in times.items()))
    print(smi)
    print(json.dumps(dict(card=smi, shapes=rows)))


if __name__ == "__main__":
    main()
