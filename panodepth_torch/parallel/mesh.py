"""Data and spatial parallel over ranks: the ``(dp, sp)`` mesh, the
batched merge, and the wrapper that runs a batched function on each rank's
rows.

Counterpart of ``panodepth/parallel/mesh.py``.  JAX shards a batch over
the devices of one ``jax.sharding.Mesh`` and returns global arrays; here
the ``dp`` axis is the ranks of the process group
(``parallel/multihost.py``): every rank is handed the global batch, runs
its ``B / dp`` rows through the same graphed function, and the outputs
are gathered so that every rank holds the whole batch's, as JAX's global
arrays hold it.  The merge and the e2e graph are per panorama, so the
forward needs no collective; the gather runs after the CUDA graph's
replay, outside it (a gloo collective cannot be captured).

The ``sp`` axis shards the fusion's relaxation over the panorama's width
(``parallel/spatial.py``): rank ``r`` sits at ``(r // sp, r % sp)``, the
``sp`` ranks of a dp row form a ring and the ``dp`` ranks of a column
gather the batch.  With ``sp > 1`` the merge's registration and fusion
targets stay one CUDA graph a rank, and the relaxation runs eagerly
between the ring's collectives, which no graph can capture.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..config import MergeConfig
from . import multihost as mh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(dp, sp)`` mesh as this rank sees it: the axis sizes, this
    rank and its device; ``backend`` is the process group's (None for one
    process, which runs no collective); ``dp_group`` the ranks of this
    rank's dp column, ``sp_group`` its sp ring (None: the whole world)."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    dp_group: Optional[mh.Group] = None
    sp_group: Optional[mh.Group] = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        """This rank's place in its sp ring: its width shard."""
        return self.rank % self.sp

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``, dp-major."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} is not divisible by the dp "
                             f"axis size {self.dp}")
        per = batch // self.dp
        return slice(self.dp_index * per, (self.dp_index + 1) * per)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks (``sum`` or ``max``), detached: the
        ``reduce`` of ``models/train``'s losses (dp meshes only)."""
        if self.dp == 1:
            return t.detach()
        if self.sp != 1:
            raise ValueError(f"all_reduce over the dp axis of a mesh with "
                             f"sp = {self.sp}")
        return mh.all_reduce([t], op)[0]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every dp row's rows ``t``, in rank order, over this rank's dp
        column."""
        return t if self.dp == 1 else mh.all_gather(t, self.dp_group)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device=None) -> Mesh:
    """The ``(dp, sp)`` mesh over the ranks of :func:`multihost.initialize`
    (default ``(world, 1)``), on the rank's device; without it, one
    process on ``device`` (default ``cuda``).  ``dp * sp`` must be the
    number of processes; every rank calls it with the same shape (its sub-
    groups are made collectively)."""
    if mh.initialized():
        world, rank, dev = mh.world(), mh.rank(), mh.device()
    else:
        from ..pipeline import resolve_device

        world, rank, dev = 1, 0, resolve_device(device or "cuda")
    dp, sp = shape if shape is not None else (world, 1)
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f"mesh {(dp, sp)} != {world} processes")
    dp_group, sp_group = mh.mesh_groups(dp, sp)
    return Mesh(dp, sp, rank, dev, mh.backend(), dp_group, sp_group)


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


# iterations between the sp ring's halo exchanges in the merge (bit-equal
# at every depth; JAX's partitioned merge exchanges every iteration)
SP_HALO = 10


def batched_merge(cfg: MergeConfig, mesh: Mesh, jacobi: str = "auto"):
    """The merge of a global batch over the mesh: ``fn(emaps (B, He, We),
    pmaps (B, V, Hp, Wp)) -> (out_u16 (B, H, W), abcd (B, V, 4))`` on every
    rank, each dp row merging its ``B / dp`` rows.  With ``sp == 1``
    through ``pipeline.compiled_merge_batched`` (the Jacobi kernel on the
    card); with ``sp > 1`` its registration and level targets are one
    graph (:func:`spatial_merge`) and the relaxation ``jacobi_spatial``
    over the sp ring, ``SP_HALO`` iterations between exchanges.  ``B``
    must be divisible by ``dp``, every level's width by ``sp``."""
    if mesh.sp == 1:
        from ..pipeline import compiled_merge_batched

        fn = compiled_merge_batched(cfg, jacobi, mesh.device)
    else:
        fn = spatial_merge(cfg, mesh, jacobi)
    return DataParallel(fn, mesh)


def spatial_merge(cfg: MergeConfig, mesh: Mesh, jacobi: str = "auto"):
    """``pipeline.compiled_merge_batched``'s function with the relaxation
    width-sharded over the mesh's sp ring: registration, the level-0
    buffer and every level's target from one ``graphs.Graphed`` stage, then
    each level's ``jacobi_spatial`` eagerly (its collectives cannot be
    captured), the buffer whole on every rank between levels.  Bit-equal
    to the one-process merge."""
    from .. import debug, graphs, registration
    from ..fusion import (_inv_cov, build_fusion_plan, init_level0,
                          level_target, upsample2x)
    from ..pipeline import _as01, _first_channel, true_f32
    from .spatial import jacobi_spatial

    plan = build_fusion_plan(cfg)
    for lvl in plan.levels:
        if lvl.width % mesh.sp:
            raise ValueError(f"level width {lvl.width} not divisible by "
                             f"sp={mesh.sp}")

    @true_f32()
    def targets(emaps, pmaps):
        emaps, pmaps = _first_channel(_as01(emaps)), _as01(pmaps)
        abcd = registration.register_views_batched(emaps, pmaps, cfg)
        debug.check("registration result", abcd)
        return abcd, init_level0(emaps, plan.levels[0], cfg), [
            level_target(pmaps, plan, i, abcd=abcd)[0]
            for i in range(len(plan.levels))]

    stage = graphs.Graphed(targets, mesh.device, name="spatial_merge.targets")

    def merge(emaps, pmaps):
        abcd, buf, tgts = stage(emaps, pmaps)
        for i, lvl in enumerate(plan.levels):
            if i:
                buf = upsample2x(buf)
            buf = jacobi_spatial(
                buf.contiguous(), tgts[i], _inv_cov(cfg, i, mesh.device) > 0,
                lvl.iterations, cfg.jacobi_step, cfg.jacobi_reg, mesh,
                halo=SP_HALO, jacobi=jacobi)
        debug.check("fusion result", buf)
        return (torch.clamp(buf, 0.0, 1.0) * 65535.0).to(torch.uint16), abcd

    return merge
