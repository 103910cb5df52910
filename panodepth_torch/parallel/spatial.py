"""The Jacobi relaxation sharded over the panorama's width, with explicit
ring halo exchanges.

Counterpart of ``panodepth/parallel/spatial.py``.  Each rank of a ring
(the mesh's ``sp`` ring, or the ``vp`` ranks of ``parallel/views.py``)
owns a contiguous width shard of the level and trades edge columns with
its two ring neighbours (``multihost.ring_exchange``: one all-gather of
every rank's edge blocks, where JAX runs two ``ppermute``s).

The azimuth seam keeps the reference's flat-index semantics
(``fusion.lap4_refwrap``): the columns that cross the seam (rank 0's left
edge, the last rank's right edge) are rolled by one row before they are
sent.  The flat-index wrap is a uniform row roll of any crossing block, so
the rolled block keeps both the adjacency inside the halo and the
halo/owned boundary exactly.

``halo=k`` is temporal blocking: k-wide halos are exchanged and k
iterations run locally between exchanges, on the shard extended by the
halos.  A stale edge corrupts one more column a iteration, and the k
halo columns are thrown away after the block, so the owned interior is
bit-equal to one device's relaxation at every k.  The targets and the
coverage do not change over the schedule: their halos are exchanged once.

What runs the k local iterations on the extended ``(H, w + 2k)`` buffer:

- the plain version (:func:`step_ext`, JAX's ``step_ext`` op for op): the
  outermost columns edge-padded, rows rolled vertically;
- on the card, ``kernels.jacobi.cuda_jacobi``: its taps wrap at flat
  indices modulo ``H * (w + 2k)``, which differs from the plain version's
  only in the outermost column on each side, a halo column; the
  difference moves inwards one column a iteration and after ``bs <= k``
  iterations has not passed the k columns thrown away.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import jacobi as kjacobi
from . import multihost as mh

__all__ = ["jacobi_local", "jacobi_spatial", "fuse_spatial", "step_ext"]


def _exchange(xs, width: int, group: mh.Group):
    """Each (..., H, w) tensor of ``xs`` extended by ``width`` columns from
    both ring neighbours, the seam's blocks row-rolled before they are
    sent; one collective for all of ``xs``."""
    n, idx = group.size, group.index
    send_l = [x[..., :width] for x in xs]
    send_r = [x[..., -width:] for x in xs]
    if idx == 0:
        send_l = [torch.roll(b, -1, -2) for b in send_l]
    if idx == n - 1:
        send_r = [torch.roll(b, 1, -2) for b in send_r]
    from_left, from_right = mh.ring_exchange(send_l, send_r, group)
    return [torch.cat([a, x, b], -1)
            for a, x, b in zip(from_left, xs, from_right)]


def step_ext(buf, target, covered, step, reg):
    """One Jacobi update of an extended-width buffer (..., H, w): the
    outermost columns edge-padded, rows rolled; the op order of
    ``kernels.jacobi.jacobi_plain`` (bit-equality)."""
    pad = torch.cat([buf[..., :1], buf, buf[..., -1:]], -1)
    lap = buf - 0.25 * (pad[..., :-2] + pad[..., 2:]
                        + torch.roll(buf, 1, -2) + torch.roll(buf, -1, -2))
    upd = buf + (target - lap) * step
    upd = upd * (1.0 - reg) + buf * reg
    upd = torch.clamp(upd, 0.0, 1.0)
    return torch.where(covered, upd, buf)


def _relax_ext(ext, tgt_e, cov_e, iterations, step, reg, jacobi: str):
    """``iterations`` updates of the extended buffer: the CUDA kernel
    (``jacobi`` ``kernel``, or ``auto`` on a CUDA tensor) or the plain
    :func:`step_ext` (``torch``, or ``auto`` on a CPU tensor)."""
    kjacobi.resolve(jacobi)  # refuse an unknown kind
    if jacobi == "kernel" or (jacobi == "auto" and ext.device.type == "cuda"):
        return kjacobi.cuda_jacobi(ext.contiguous(), tgt_e.contiguous(),
                                   cov_e.contiguous(), iterations, step, reg)
    for _ in range(iterations):
        ext = step_ext(ext, tgt_e, cov_e, step, reg)
    return ext


def jacobi_local(buf, target, covered, iterations, step, reg,
                 group: mh.Group, halo: int = 1, jacobi: str = "auto"):
    """The width-sharded relaxation of this rank's shard: ``buf`` and
    ``target`` are its (H, w) columns (or a (B, H, w) stack), ``covered``
    its (H, w) bool mask; ``group`` is the ring, this rank at
    ``group.index``.  Exchanges ring halos and returns the relaxed shard.
    Exposed apart so that ``parallel/views.py`` runs it on the shards its
    reduce-scatter leaves.  ``halo`` is clamped to the shard's width; the
    blocks are ``[k, ..., k, remainder]``, one exchange each."""
    k = min(max(1, int(halo)), buf.shape[-1])
    blocks = [k] * (iterations // k) + ([iterations % k]
                                        if iterations % k else [])
    tgt_e, cov_e = _exchange([target, covered], k, group)
    for bs in blocks:
        ext = _exchange([buf], k, group)[0]
        ext = _relax_ext(ext, tgt_e, cov_e, bs, step, reg, jacobi)
        buf = ext[..., k:-k]
    return buf


def jacobi_spatial(buf, target, covered, iterations, step, reg, mesh,
                   halo: int = 1, jacobi: str = "auto"):
    """Width-sharded Jacobi, the numerics of ``fusion.jacobi``: ``buf`` and
    ``target`` are the whole (H, W) level (or a (B, H, W) stack) on every
    rank of the mesh's sp ring, ``covered`` its (H, W) mask; each rank
    relaxes its shard of ``W / sp`` columns (:func:`jacobi_local`) and the
    shards are gathered, so that every rank returns the whole level.
    ``halo`` is the temporal-blocking depth: a ``halo``-column exchange
    buys ``halo`` local iterations (``halo=1`` exchanges every
    iteration)."""
    group = mesh.sp_group or mh.world_group()
    n, d = group.size, group.index
    w = buf.shape[-1]
    if w % n:
        raise ValueError(f"width {w} is not divisible by the {n} ranks of "
                         f"the ring")
    wl = w // n
    cols = slice(d * wl, (d + 1) * wl)
    out = jacobi_local(buf[..., cols], target[..., cols], covered[..., cols],
                       iterations, step, reg, group, halo=halo, jacobi=jacobi)
    return mh.all_gather(out.contiguous(), group, axis=-1)


def fuse_spatial(emap, pmaps, plan, mesh, abcd=None, halo: int = 1,
                 jacobi: str = "auto"):
    """``fusion.fuse`` with :func:`jacobi_spatial` as the relaxation (bit-
    equal to it at every ``halo``; the 200/100/50 schedules at ``halo=10``
    run 20/10/5 exchanges a level instead of 200/100/50)."""
    from ..fusion import fuse

    relax = functools.partial(jacobi_spatial, mesh=mesh, halo=halo,
                              jacobi=jacobi)
    return fuse(emap, pmaps, plan, jacobi_fn=relax, abcd=abcd)
