"""The port's benchmark: ``python3 portbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.
See ``portbench/harness/main.py``."""

import time

STARTED = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# every compiler cache of the process inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[0] = ROOT

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
