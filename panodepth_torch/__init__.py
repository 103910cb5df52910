"""panodepth_torch — panodepth on PyTorch and CUDA.

A port of the JAX package ``panodepth`` (which stays the reference) to
PyTorch, with every TPU kernel on its path rewritten by hand for NVIDIA
Hopper.  This package covers the file-mode merge, the reference's stage C
(``MergeDepthMaps``, Depth.cpp:754-930): per-view cubic registration by
normal equations, multiresolution Laplacian fusion whose Jacobi relaxation
runs as a CUDA kernel (``csrc/jacobi.cu``), u16 output and scoring; and the
on-device e2e graph (``e2e``): RGB panorama -> the baseline CNN (any zoo
family) and the perspective CNN on the extracted views, whose GroupNorms
run as a CUDA kernel (``csrc/groupnorm.cu``) -> the merge.

It imports neither ``jax`` nor anything of ``panodepth``.
"""

from .config import LAYOUTS, MergeConfig, ViewLayout, ZENITH_RANGE, five_fold_leres
from .metrics import Metrics, error_metrics, paired_metrics
from .pipeline import merge_arrays, merge_depth_maps, run_batch

__version__ = "0.1.0"
