"""The Jacobi wrapper: routing, launch counting, argument checks, the
nvcc build's naming, and (on a CUDA card only) the kernel against its
plain twin.

The card tests carry the ``cuda`` marker and skip without a card; the
decision is made inside the fixture, never at import.  On a card, run
them with ``python -m pytest --noconftest tests/test_torch_kernels.py -m
cuda`` (this file needs neither JAX nor ``tests/conftest.py``).
"""

import numpy as np
import pytest
import torch

from panodepth_torch.kernels import _build
from panodepth_torch.kernels import jacobi as kj

torch.set_num_threads(1)


def _case(h, w, seed, device="cpu"):
    rng = np.random.RandomState(seed)
    buf = torch.tensor(rng.rand(h, w).astype(np.float32), device=device)
    tgt = torch.tensor(rng.normal(0, 0.01, (h, w)).astype(np.float32),
                       device=device)
    cov = rng.rand(h, w) < 0.6
    cov[0], cov[-1], cov[:, 0], cov[:, -1] = True, True, True, True
    return buf, tgt, torch.tensor(cov, device=device)


def test_auto_on_cpu_routes_to_plain_and_counts_no_launch():
    buf, tgt, cov = _case(16, 32, 0)
    before = kj.LAUNCHES
    got = kj.resolve("auto")(buf, tgt, cov, 9, 0.5, 1e-4)
    assert kj.LAUNCHES == before
    torch.testing.assert_close(got, kj.jacobi_plain(buf, tgt, cov, 9, 0.5,
                                                    1e-4), rtol=0, atol=0)
    assert kj.resolve("torch") is kj.jacobi_plain
    assert kj.resolve("kernel") is kj.cuda_jacobi
    with pytest.raises(ValueError, match="jacobi must be one of"):
        kj.resolve("pallas")


@pytest.mark.parametrize("bad", ["cpu_tensor", "f64", "shape", "strided"])
def test_cuda_jacobi_refuses_bad_arguments(bad):
    on_card = bad != "cpu_tensor" and torch.cuda.is_available()
    buf, tgt, cov = _case(8, 16, 1, device="cuda" if on_card else "cpu")
    args = dict(buf=buf, target=tgt, covered=cov)
    if bad == "f64":
        args["target"] = tgt.double()
    elif bad == "shape":
        args["covered"] = cov[:4]
    elif bad == "strided":
        args["buf"] = buf.t()
    # a CPU tensor fails the device check first; on a card the others fail
    # their own check.  No call launches a kernel or falls back.
    before = kj.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        kj.cuda_jacobi(args["buf"], args["target"], args["covered"], 3,
                       0.5, 1e-4)
    assert kj.LAUNCHES == before


def test_build_names_and_missing_nvcc(monkeypatch, tmp_path):
    path = _build.library_path("jacobi")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libjacobi-")
    assert path == _build.library_path("jacobi")  # stable for one source
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("nvcc is installed at its default place")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,iters", [(256, 512, 200), (512, 1024, 100),
                                       (1024, 2048, 50), (5, 7, 3),
                                       (50, 130, 20), (24, 64, 1)])
def test_cuda_kernel_bit_equal_to_plain(cuda_device, h, w, iters):
    buf, tgt, cov = _case(h, w, h + iters, device=cuda_device)
    kj.LAUNCHES = 0
    got = kj.cuda_jacobi(buf, tgt, cov, iters, 0.5, 1e-4)
    assert kj.LAUNCHES == kj.launches_for(iters) == -(-iters // 8)
    want = kj.jacobi_plain(buf, tgt, cov, iters, 0.5, 1e-4)
    torch.cuda.synchronize()
    # the kernel rounds after every operation, as PyTorch does: bit-equal
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_kernel_zero_iterations_and_input_untouched(cuda_device):
    buf, tgt, cov = _case(8, 16, 3, device=cuda_device)
    keep = buf.clone()
    out = kj.cuda_jacobi(buf, tgt, cov, 0, 0.5, 1e-4)
    assert torch.equal(out, keep) and out.data_ptr() != buf.data_ptr()
    kj.cuda_jacobi(buf, tgt, cov, 5, 0.5, 1e-4)
    torch.cuda.synchronize()
    assert torch.equal(buf, keep)
