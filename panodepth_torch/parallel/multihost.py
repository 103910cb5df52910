"""Multi-process data parallel on ``torch.distributed``.

Counterpart of ``panodepth/parallel/multihost.py``.  JAX runs one process
per host under ``jax.distributed`` and one global mesh over every
process's devices; here each process is one rank of a process group and
computes on one device, its rank's:

* :func:`initialize` -- one ``torch.distributed.TCPStore`` at the
  coordinator ``HOST:PORT`` (rank 0 serves it) and the process group on
  it: ``nccl`` when the rank's device is CUDA and every rank has a card
  of its own, ``gloo`` otherwise (two ranks sharing one card, or the
  CPU).  Rank ``r`` computes on ``cuda:{r % device_count}``, or on the
  CPU when the caller asks for it.  A rank that cannot reach the store,
  or whose partners never arrive, raises at the timeout: nothing falls
  back to one process;
* :func:`process_shard` -- the round-robin slice of a work list;
* :func:`global_batch` -- this rank's rows of a global batch on its
  device (rank ``r`` holds rows ``[r * per, (r + 1) * per)``, dp-major
  as in JAX);
* :func:`replicate` -- rank 0's values broadcast into every rank's
  tensors, in place;
* :func:`fetch_replicated` -- the host copy of a replicated state,
  checked equal on every rank by a digest (the port has no global array
  that makes a divergence impossible, so the check takes its place);
* :func:`barrier`, :func:`kv_set_once`, :func:`kv_try_get` -- the
  store's barrier and first-writer-wins keys (the preemption drain of
  ``train_cli``); no-ops without :func:`initialize`;
* :func:`all_reduce`, :func:`all_gather` -- the collectives the mesh and
  the sharded train step use;
* :func:`mesh_groups` -- the sub-groups of a ``(dp, sp)`` mesh: each sp
  ring and each dp column (:class:`Group`), over which
  :func:`all_gather`, :func:`reduce_scatter` (a sum, one part a rank
  along an axis) and :func:`ring_exchange` (the ring neighbours' edge
  blocks, ``parallel/spatial.py``'s halos) run.

Each collective takes the tensors where they are: ``gloo`` takes host
and CUDA tensors alike (it stages a card's tensors through host memory
itself; every collective used here was checked on the card), ``nccl``
only the rank's card, to which a host tensor is copied.  Collectives see
every dtype as bytes where they compute nothing (the broadcast, the
gather, the ring exchange, which is one all-gather), so u16 and bf16
tensors travel as they are.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600  # the store's and the collectives' timeout (JAX's barrier)

_STATE = dict(store=None, rank=0, world=1, device=None, backend=None,
              barriers={}, groups={})


def initialize(coordinator: str, num_processes: int, process_id: int,
               device="cuda", timeout_s: float = TIMEOUT_S
               ) -> Tuple[int, int]:
    """Join the process group of ``num_processes`` ranks whose store rank 0
    serves at ``coordinator`` (``HOST:PORT``), as rank ``process_id``.
    Call once, before the rank's device is used.  Returns ``(rank,
    world)``; raises if the store or a partner is not reached within
    ``timeout_s``."""
    if _STATE["store"] is not None:
        raise RuntimeError("multihost.initialize was already called")
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator must be HOST:PORT, got "
                         f"{coordinator!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                f"pass device='cpu' (CLI --device cpu) to run on the CPU")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", process_id % count)
        torch.cuda.set_device(dev)
        if num_processes <= count:
            backend, why = "nccl", f"one card a rank ({count} cards)"
        else:
            backend, why = "gloo", (f"{num_processes} ranks share "
                                    f"{count} card(s)")
    else:
        backend, why = "gloo", "ranks on the CPU"
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world_size=num_processes,
                          is_master=process_id == 0, timeout=timeout)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _STATE.update(store=store, rank=process_id, world=num_processes,
                  device=dev, backend=backend)
    print(f"[multihost] rank {process_id} of {num_processes}: backend "
          f"{backend} ({why}), device {dev}", flush=True)
    return process_id, num_processes


def initialized() -> bool:
    return _STATE["store"] is not None


def rank() -> int:
    return _STATE["rank"]


def world() -> int:
    return _STATE["world"]


def device() -> Optional[torch.device]:
    """The rank's device (None without :func:`initialize`)."""
    return _STATE["device"]


def backend() -> Optional[str]:
    return _STATE["backend"]


def shutdown() -> None:
    """Leave the process group (after a final :func:`barrier`)."""
    if _STATE["store"] is None:
        return
    dist.destroy_process_group()
    _STATE.update(store=None, rank=0, world=1, device=None, backend=None,
                  barriers={}, groups={})


def process_shard(items: Sequence, index: int, count: int) -> list:
    """This process's round-robin slice ``items[index::count]`` (datasets
    sorted by scene still spread over the ranks)."""
    if not 0 <= index < count:
        raise ValueError(f"process index {index} outside [0, {count})")
    return list(items[index::count])


# --------------------------------------------------------------------------
# collectives


def _to_comm(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: on the rank's card for nccl."""
    if _STATE["backend"] == "nccl" and t.device != _STATE["device"]:
        return t.to(_STATE["device"])
    return t.contiguous()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a flat u8 tensor (a view where ``t`` is contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def all_reduce(tensors, op: str = "sum"):
    """The elementwise ``sum`` or ``max`` over the ranks of each tensor
    (new tensors on their own devices), one collective for each dtype."""
    tensors = list(tensors)
    if _STATE["world"] == 1:
        return tensors
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([_to_comm(tensors[i].detach().reshape(-1))
                          for i in idx])
        dist.all_reduce(flat, red)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.reshape(tensors[i].shape).to(tensors[i].device)
    return out


@dataclasses.dataclass(frozen=True)
class Group:
    """Ranks that run collectives together: their global ``ranks`` in the
    group's order, this rank's ``index`` among them and the process group
    (``pg``; None for the whole world)."""

    ranks: Tuple[int, ...]
    index: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def world_group() -> Group:
    """Every rank of :func:`initialize` (this process alone without it)."""
    return Group(tuple(range(_STATE["world"])), _STATE["rank"])


def mesh_groups(dp: int, sp: int) -> Tuple[Group, Group]:
    """This rank's ``(dp column, sp ring)`` of the ``(dp, sp)`` mesh over
    the ranks: rank ``r`` sits at ``(r // sp, r % sp)``, as JAX reshapes its
    devices.  A group that is the whole world runs on the default process
    group; the others are made by ``dist.new_group``, every rank making
    every group in the same order (each sp ring, then each dp column), once
    a mesh shape."""
    world, r = _STATE["world"], _STATE["rank"]
    if dp * sp != world:
        raise ValueError(f"mesh {(dp, sp)} != {world} processes")
    key = (dp, sp)
    if key not in _STATE["groups"]:
        rings = [tuple(i * sp + j for j in range(sp)) for i in range(dp)]
        columns = [tuple(i * sp + j for i in range(dp)) for j in range(sp)]
        made = {}
        for ranks in rings + columns:
            if 1 < len(ranks) < world and ranks not in made:
                made[ranks] = dist.new_group(list(ranks))
        ring, column = rings[r // sp], columns[r % sp]
        _STATE["groups"][key] = tuple(
            Group(ranks, ranks.index(r), made.get(ranks))
            for ranks in (column, ring))
    return _STATE["groups"][key]


def all_gather(t: torch.Tensor, group: Optional[Group] = None,
               axis: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``axis``, in the
    group's rank order (default: every rank), on ``t``'s device."""
    group = group or world_group()
    if group.size == 1:
        return t
    src = _to_comm(_bytes(t))
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat([p.to(t.device).view(t.dtype).reshape(t.shape)
                      for p in parts], axis)


def reduce_scatter(t: torch.Tensor, axis: int,
                   group: Optional[Group] = None) -> torch.Tensor:
    """The sum of every rank's ``t`` (equal shapes) over the group, cut into
    ``group.size`` equal parts along ``axis``: this rank's part, on ``t``'s
    device.  With two ranks each element is ``a + b``, the sum in either
    order; ``t``'s size along ``axis`` must divide by the group's."""
    group = group or world_group()
    n = group.size
    if t.shape[axis] % n:
        raise ValueError(f"reduce_scatter: size {t.shape[axis]} along axis "
                         f"{axis} is not divisible by {n} ranks")
    if n == 1:
        return t
    parts = [_to_comm(p) for p in t.chunk(n, axis)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group.pg)
    return out.to(t.device)


def ring_exchange(left, right, group: Optional[Group] = None):
    """The ring neighbours' edge blocks: ``left`` and ``right`` are lists of
    this rank's blocks for its left and right neighbour (the same shapes
    and dtypes on every rank); returns ``(from_left, from_right)``, the
    left neighbour's ``right`` blocks and the right neighbour's ``left``
    ones.  One all-gather of every rank's blocks as bytes; a ring of one
    rank is its own neighbour on both sides."""
    group = group or world_group()
    n, i = group.size, group.index
    if n == 1:
        return list(right), list(left)
    blocks = list(left) + list(right)
    sizes = [b.numel() * b.element_size() for b in blocks]
    src = torch.cat([_to_comm(_bytes(b)) for b in blocks])
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group.pg)

    def blocks_of(part):
        return [p.to(b.device).view(b.dtype).reshape(b.shape)
                for p, b in zip(part.split(sizes), blocks)]

    k = len(left)
    return (blocks_of(parts[(i - 1) % n])[k:],
            blocks_of(parts[(i + 1) % n])[:k])


def broadcast_(tensors) -> None:
    """Rank 0's values written into each rank's ``tensors`` in place, as
    one broadcast of their bytes."""
    tensors = list(tensors)
    if _STATE["world"] == 1 or not tensors:
        return
    flat = torch.cat([_to_comm(_bytes(t)) for t in tensors])
    dist.broadcast(flat, src=0)
    sizes = [t.numel() * t.element_size() for t in tensors]
    with torch.no_grad():
        for t, part in zip(tensors, flat.split(sizes)):
            t.copy_(part.to(t.device).view(t.dtype).reshape(t.shape))


# --------------------------------------------------------------------------
# trees: tensors in dicts, lists, tuples and dataclasses, numbers beside


def _leaves(tree, kind=torch.Tensor, out=None):
    """The items of ``kind`` in ``tree``, in order."""
    out = [] if out is None else out
    if isinstance(tree, kind):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, kind, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, kind, out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), kind, out)
    return out


def _map(tree, fn):
    """``tree`` with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    return tree


def global_batch(mesh, local):
    """This rank's rows of the global batch (``local``, a host array or a
    tensor) on the mesh's device, from pinned memory."""
    t = local if isinstance(local, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(local))
    if t.device == mesh.device:
        return t
    if mesh.device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(mesh.device, non_blocking=True)


def replicate(mesh, tree):
    """``tree`` with rank 0's values on every rank: each tensor written in
    place (a net's parameters stay its own), one broadcast for all; the
    numbers of the tree must agree already (they come from the same
    checkpoint or step count), which :func:`fetch_replicated` checks."""
    broadcast_(_leaves(tree))
    return tree


class ReplicaMismatch(RuntimeError):
    """The ranks' copies of a replicated state differ."""


def fetch_replicated(tree):
    """The host copy of a replicated ``tree`` (every tensor on the CPU).
    With more than one rank, every rank's digest of it (for each tensor
    the float64 sum and sum of squares, and the tree's numbers) is
    gathered, and a difference raises :class:`ReplicaMismatch`."""
    host = _map(tree, lambda t: t.detach().to("cpu"))
    if _STATE["world"] == 1:
        return host
    parts = []
    for t in _leaves(host):
        x = t.to(torch.float64)
        parts += [x.sum(), (x * x).sum()]
    parts += [torch.tensor(float(v), dtype=torch.float64)
              for v in _leaves(host, (int, float))]
    digest = torch.stack(parts)
    every = all_gather(digest[None])
    differ = (every != every[:1]).any(0)
    if bool(differ.any()):
        raise ReplicaMismatch(
            f"the replicated state differs between ranks at "
            f"{int(differ.sum())} of {digest.numel()} digest entries")
    return host


# --------------------------------------------------------------------------
# the store


def barrier(name: str = "panodepth", timeout_ms: int = TIMEOUT_S * 1000
            ) -> None:
    """Wait until every rank reached the barrier ``name`` (a name may be
    used again: each use is a barrier of its own).  Runs on the store, so
    it needs no device.  A no-op without :func:`initialize`."""
    store = _STATE["store"]
    if store is None:
        return
    uses = _STATE["barriers"]
    uses[name] = uses.get(name, 0) + 1
    key = f"panodepth/barrier/{name}/{uses[name]}"
    if store.add(key, 1) == _STATE["world"]:
        store.set(key + "/open", "1")
    store.wait([key + "/open"],
               datetime.timedelta(milliseconds=timeout_ms))


def kv_set_once(key: str, value: str) -> None:
    """Set ``key`` unless it is set: the first writer wins, a later one
    loses silently.  A no-op without :func:`initialize`."""
    store = _STATE["store"]
    if store is not None:
        store.compare_set(key, "", value)


def kv_try_get(key: str) -> Optional[str]:
    """``key``'s value without waiting, or None where it is not set or
    without :func:`initialize`."""
    store = _STATE["store"]
    if store is None or not store.check([key]):
        return None
    return store.get(key).decode()
