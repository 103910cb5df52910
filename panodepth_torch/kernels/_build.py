"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (with the headers ``csrc/*.cuh`` it includes)
exposes a plain ``extern "C"`` interface, so it is
compiled by ``nvcc`` alone into a shared library (seconds) instead of
through ``torch.utils.cpp_extension`` (whose sources include PyTorch's
headers and take minutes) and loaded with :class:`ctypes.CDLL`.  Host
sources, ``csrc/<name>.cpp`` (the JPEG codec, the PNG codec and prefetcher),
take the same route through ``g++``, so they build wherever the port runs,
the CPU included; a source's link flags (:data:`LINK_FLAGS`) follow it on
the command line.

The build runs at first use, never at import.  Libraries go to
``panodepth_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and its compile and link flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  A build writes ``*.<pid>.tmp``
and renames it into place, so concurrent processes that build the same
source are safe.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("jacobi", "groupnorm", "qconv",  # CUDA sources, csrc/<name>.cu
           "quantize")
HOST_SOURCES = ("jpeg", "pngio")  # host C++ sources, csrc/<name>.cpp
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the kernels round like the plain PyTorch versions
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
# after the source: the prefetcher's threads, and zlib's runtime library by
# its soname (no development symlink needed)
LINK_FLAGS = {"pngio": ("-pthread", "-l:libz.so.1")}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def gxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("g++ not found (set CXX or put g++ on PATH); the "
                       "host codecs are built from csrc/*.cpp at first use")


def source_path(name: str) -> Path:
    """``csrc/<name>.cpp`` for a host source, else ``csrc/<name>.cu``."""
    return CSRC_DIR / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _flags(name: str):
    return GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def library_path(name: str) -> Path:
    """The library built from the current source, its headers
    (``csrc/*.cuh``, for a CUDA source) and the compile and link flags."""
    src = source_path(name).read_bytes()
    if name not in HOST_SOURCES:
        src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    flags = (*_flags(name), *LINK_FLAGS.get(name, ()))
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library among ``names``, all compiler processes
    started together.  Returns seconds per library built; raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    compilers = {n: gxx_path() if n in HOST_SOURCES else nvcc_path()
                 for n in todo}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compilers[name], *_flags(name), "-o", str(tmp),
               str(source_path(name)), *LINK_FLAGS.get(name, ())]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(compilers[name])} failed on "
                          f"csrc/{source_path(name).name} (exit "
                          f"{proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output from the build of the current source (for a
    ``csrc/<name>.cu``, ptxas's registers, shared memory and spills per
    kernel)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built first if
    missing (one build per process however many threads ask)."""
    with _LOAD_LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]
