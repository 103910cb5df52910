"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and its PNG, PFM, JPEG and BMP paths run without Pillow.

Both checks run in a subprocess, since this test process has JAX loaded
(tests/conftest.py imports it).
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_port_imports_neither_jax_nor_panodepth():
    out = _run("""
        import importlib, pkgutil, sys
        sys.path.insert(0, ".")
        import panodepth_torch
        names = ["panodepth_torch"] + [
            m.name for m in pkgutil.walk_packages(panodepth_torch.__path__,
                                                  "panodepth_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "panodepth", "PIL", "flax", "optax")
                     or m.startswith(("jax.", "panodepth.", "PIL.", "flax.",
                                      "optax.")))
        # the e2e, serving and training slices' modules (files and
        # corruption too) are among those imported
        need = {"panodepth_torch.e2e", "panodepth_torch.kernels.groupnorm",
                "panodepth_torch.serve", "panodepth_torch.daemon",
                "panodepth_torch.models.norm",
                "panodepth_torch.models.weights",
                "panodepth_torch.models.layers",
                "panodepth_torch.models.perspective",
                "panodepth_torch.models.fastpano",
                "panodepth_torch.ops.projection",
                "panodepth_torch.ops.resize",
                "panodepth_torch.models.train",
                "panodepth_torch.models.evaluate",
                "panodepth_torch.synth", "panodepth_torch.train_cli",
                "panodepth_torch.models.data", "panodepth_torch.ops.corrupt",
                "panodepth_torch.debug", "panodepth_torch.kernels.qconv",
                "panodepth_torch.models.quantize",
                "panodepth_torch.ops.maps", "panodepth_torch.analyze"}
        print(len(names), sorted(need - set(names)), bad)
    """)
    n, rest = out.split(" ", 1)
    assert int(n) >= 29, out  # every module of the package was imported
    assert rest.strip() == "[] []", out


def test_png_and_pfm_without_pillow():
    out = _run("""
        import sys
        sys.modules["PIL"] = None  # any import of Pillow now fails
        sys.path.insert(0, ".")
        import numpy as np
        from panodepth_torch import io as pio, jpeg
        import tempfile, os, struct
        rng = np.random.RandomState(0)
        with tempfile.TemporaryDirectory() as d:
            u16 = rng.randint(0, 65536, (17, 33)).astype(np.uint16)
            pio.save_png16(os.path.join(d, "a.png"), u16)
            assert np.array_equal(pio.read_png(os.path.join(d, "a.png")), u16)
            back = pio.load_image01(os.path.join(d, "a.png"))
            assert np.array_equal(back, u16.astype(np.float32) / np.float32(65535))
            f = rng.rand(5, 7).astype(np.float32) * 5
            with open(os.path.join(d, "b.pfm"), "wb") as fp:  # little-endian Pf
                fp.write(b"Pf\\n7 5\\n-1.0\\n" + f.astype("<f4").tobytes())
            assert np.array_equal(pio.load_pfm(os.path.join(d, "b.pfm")), f)
            # a JPEG of 8x8 blocks of one gray each holds only DC terms,
            # which the quality-95 table reproduces exactly
            g = np.kron(rng.randint(0, 256, (3, 5)), np.ones((8, 8)))
            g = g.astype(np.uint8)
            # save_jpg truncates v * 255: (k + 0.5) / 255 comes back as k
            pio.save_jpg(os.path.join(d, "c.jpg"), (g + 0.5) / 255)
            assert np.array_equal(pio.read_image(os.path.join(d, "c.jpg")), g)
            yx = np.mgrid[:9, :14]
            rgb = np.stack([yx[0] * 20 + 30, yx[1] * 12 + 40,
                            yx[0] * 9 + yx[1] * 7], -1).astype(np.uint8)
            pio.save_jpg(os.path.join(d, "d.jpg"), (rgb + 0.5) / 255)
            back = pio.read_image(os.path.join(d, "d.jpg"))
            assert np.array_equal(back, jpeg.decode(jpeg.encode(rgb)))
            assert np.abs(back.astype(int) - rgb).mean() < 8
            # a 24-bit bottom-up BMP, rows padded to 4 bytes
            stride = (14 * 3 + 3) // 4 * 4
            rows = np.zeros((9, stride), np.uint8)
            rows[:, :42] = rgb[::-1, :, ::-1].reshape(9, 42)
            with open(os.path.join(d, "e.bmp"), "wb") as fp:
                fp.write(b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
                         + struct.pack("<IiiHHIIiiII", 40, 14, 9, 1, 24, 0,
                                       rows.size, 0, 0, 0, 0)
                         + rows.tobytes())
            assert np.array_equal(pio.read_image(os.path.join(d, "e.bmp")), rgb)
            assert np.array_equal(pio.load_image01(os.path.join(d, "e.bmp")),
                                  rgb.astype(np.float32) / np.float32(255))
        assert "PIL" not in sys.modules or sys.modules["PIL"] is None
        print("ok")
    """)
    assert out.strip() == "ok"
