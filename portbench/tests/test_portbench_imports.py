"""No run may hold JAX or the JAX package once its window has closed: the
check compares each module's top-level name whole, so the port
(``panodepth_torch``) passes and the JAX package (``panodepth``) does
not.  Without a card the harness prints no result and exits non-zero."""

import subprocess
import sys
import types

from tiny import ROOT

from portbench.harness import main


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.delitem(sys.modules, "panodepth", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setitem(sys.modules, "panodepth_torch_extra",
                        types.ModuleType("panodepth_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert "panodepth" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "panodepth.config",
                        types.ModuleType("panodepth.config"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert main.forbidden_modules() == ["jaxlib", "panodepth"]


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.harness."
            "main, portbench.harness.closed, portbench.harness.openloop, "
            "portbench.harness.program, panodepth_torch.e2e, "
            "panodepth_torch.serve, panodepth_torch.daemon; "
            "from portbench.harness.main import forbidden_modules; "
            "print(forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "e2e_nf_b8", "--seed", str(2 ** 31 + 3), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                       "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA device" in r.stderr
