"""Data parallel over ranks: the ``dp`` mesh, the batched merge, and the
wrapper that runs a batched function on each rank's rows.

Counterpart of ``panodepth/parallel/mesh.py``.  JAX shards a batch over
the devices of one ``jax.sharding.Mesh`` and returns global arrays; here
the ``dp`` axis is the ranks of the process group
(``parallel/multihost.py``): every rank is handed the global batch, runs
its ``B / dp`` rows through the same graphed function, and the outputs
are gathered so that every rank holds the whole batch's, as JAX's global
arrays hold it.  The merge and the e2e graph are per panorama, so the
forward needs no collective; the gather runs after the CUDA graph's
replay, outside it (a gloo collective cannot be captured).

The ``sp`` axis (the fusion stencils sharded over the panorama's width)
comes with ``parallel/spatial.py``; ``sp > 1`` is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..config import MergeConfig
from . import multihost as mh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(dp, sp)`` mesh as this rank sees it: ``dp`` ranks (the world
    size), ``sp`` (1), this rank and its device; ``backend`` is the process
    group's (None for one process, which runs no collective)."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    backend: Optional[str] = None

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``, dp-major."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} is not divisible by the dp "
                             f"axis size {self.dp}")
        per = batch // self.dp
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks (``sum`` or ``max``), detached: the
        ``reduce`` of ``models/train``'s losses."""
        if self.dp == 1:
            return t.detach()
        return mh.all_reduce([t], op)[0]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows ``t``, in rank order."""
        return t if self.dp == 1 else mh.all_gather(t)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device=None) -> Mesh:
    """The ``(dp, sp)`` mesh over the ranks of :func:`multihost.initialize`
    (default ``(world, 1)``), on the rank's device; without it, one
    process on ``device`` (default ``cuda``)."""
    if mh.initialized():
        world, rank, dev = mh.world(), mh.rank(), mh.device()
    else:
        from ..pipeline import resolve_device

        world, rank, dev = 1, 0, resolve_device(device or "cuda")
    dp, sp = shape if shape is not None else (world, 1)
    if sp != 1:
        raise ValueError(
            f"mesh {(dp, sp)}: sp > 1, the fusion sharded over the "
            f"panorama's width, comes with parallel/spatial.py (ROADMAP "
            f"Queue 1 item 2) and is not ported yet")
    if dp * sp != world:
        raise ValueError(f"mesh {(dp, sp)} != {world} processes")
    return Mesh(dp, sp, rank, dev, mh.backend())


def _rows(x, rows: slice, mesh: Mesh):
    """``x`` (a tensor, a host array or a list of them) cut to ``rows`` on
    the mesh's device."""
    if isinstance(x, (list, tuple)):
        return [_rows(v, rows, mesh) for v in x]
    return mh.global_batch(mesh, x[rows])


def _gathered(y, mesh: Mesh):
    if isinstance(y, (list, tuple)):
        return type(y)(_gathered(v, mesh) for v in y)
    return mesh.all_gather(y)


def _batch(args) -> int:
    first = args[0]
    while isinstance(first, (list, tuple)):
        first = first[0]
    return first.shape[0]


class DataParallel:
    """A batched function (a ``graphs.Graphed`` stage) on a mesh: each rank
    runs its rows of the global batch, and every output (a tensor, or a
    list or tuple of them) is gathered over the ranks."""

    def __init__(self, fn: Callable, mesh: Mesh):
        self.fn, self.mesh = fn, mesh

    def __call__(self, *args):
        rows = self.mesh.rows(_batch(args))
        return _gathered(self.fn(*(_rows(a, rows, self.mesh) for a in args)),
                         self.mesh)


def batched_merge(cfg: MergeConfig, mesh: Mesh, jacobi: str = "auto"):
    """The merge of a global batch over the mesh: ``fn(emaps (B, He, We),
    pmaps (B, V, Hp, Wp)) -> (out_u16 (B, H, W), abcd (B, V, 4))`` on every
    rank, each rank merging its ``B / dp`` rows through
    ``pipeline.compiled_merge_batched`` (the Jacobi kernel on the card).
    ``B`` must be divisible by ``dp``."""
    from ..pipeline import compiled_merge_batched

    return DataParallel(compiled_merge_batched(cfg, jacobi, mesh.device),
                        mesh)
