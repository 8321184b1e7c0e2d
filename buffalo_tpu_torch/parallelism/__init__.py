"""Device mesh and the two collectives of the row-sharded epochs.

PyTorch counterpart of ``buffalo_tpu.parallelism``.  The JAX package
builds a 1-D ``jax.sharding.Mesh`` and lets XLA insert the collectives;
here a :class:`Mesh` is an ordered list of shards, each a torch device,
and the epochs call the collectives themselves:

* :func:`all_gather_rows` — the shard-ordered concatenation of a
  row-sharded table (the fixed side of a half epoch, top-k candidates);
* :func:`all_reduce_sum` — the sum of per-shard partials (gramians,
  losses, column sums).

Inside a process both are copies and sums over the local shards.  When
the mesh spans processes (:func:`initialize_distributed` was called),
they then go through ``torch.distributed`` (``all_gather`` /
``all_reduce``) on its default group: NCCL between cards, gloo on the
CPU.  That holds at world size 1 too, so a one-process group really runs
its backend.  Several shards may sit on one device (``devices=["cuda:0"]
* 4``, or ``["cpu"] * 8`` as the JAX tests' 8 fake CPU devices); the
gathered table is then made once per device, not once per shard.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


class Mesh:
    """The shards this process holds, in global shard order.

    ``devices``: one ``torch.device`` per local shard (repeats allowed);
    ``group``: the ``torch.distributed`` process group the collectives
    cross, or None inside one process; ``size``: the global shard count;
    ``first``: the global index of this process's first shard.
    """

    def __init__(self, devices: Sequence, group=None, size: int = None,
                 first: int = 0):
        import torch

        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.size = int(size if size is not None else len(self.devices))
        self.first = int(first)
        if self.size % len(self.devices):
            raise ValueError(f"{len(self.devices)} local shards do not "
                             f"divide a mesh of {self.size}")

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def shards(self) -> List[int]:
        """Global indices of the local shards."""
        return list(range(self.first, self.first + self.local_size))

    @property
    def unique_devices(self) -> list:
        """The local devices, each once, in shard order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    @property
    def backend(self) -> Optional[str]:
        if self.group is None:
            return None
        import torch.distributed as dist
        return dist.get_backend(self.group)

    def __repr__(self):
        return (f"Mesh(size={self.size}, first={self.first}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"backend={self.backend})")


def num_devices() -> int:
    """Cards visible to this process (1 without a card: the CPU)."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def world_size() -> int:
    """Processes in the distributed job (1 outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _group():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _first_card(cards: int, local: int, rank: int) -> int:
    """This process's first card when each process takes ``local`` of
    the ``cards`` its host shows: the host holds ``cards // local`` such
    processes, and this one is the ``LOCAL_RANK``-th of them (as
    ``torchrun`` sets it) or, without that variable, the rank's place on
    its host with ranks numbered host by host.  A process that sees only
    its own cards (``CUDA_VISIBLE_DEVICES``) starts at card 0."""
    slot = int(os.environ.get("LOCAL_RANK", rank))
    return (slot % max(cards // local, 1)) * local


def get_mesh(num_devices: Optional[int] = None,
             devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``num_devices`` shards (global, across processes).

    ``devices=None`` takes this process's first cards, the JAX rule of
    ``jax.devices()[:num_devices]``, and raises when there are fewer
    cards than asked: shards share a device only where the caller names
    them (``devices=["cuda:0"] * 4``).  Without a card and without
    ``devices`` the mesh is the CPU alone.  When
    :func:`initialize_distributed` has run, ``num_devices`` counts every
    process's shards; ``devices`` then names this process's (or all of
    them, in rank order), and with ``devices=None`` several processes on
    one host take consecutive runs of its cards (``_first_card``).  A
    group on NCCL makes the mesh's first card the current device.
    """
    import torch

    group = _group()
    world, rank = 1, 0
    if group is not None:
        import torch.distributed as dist
        world, rank = dist.get_world_size(), dist.get_rank()
    if devices is not None:
        devices = list(devices)
        if num_devices is None:
            num_devices = len(devices) * world
        if world > 1 and len(devices) == num_devices:
            per = num_devices // world
            devices = devices[rank * per:(rank + 1) * per]
    else:
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if num_devices is None:
            num_devices = max(cards, 1) * world
        local = -(-int(num_devices) // world)
        if cards == 0:
            if local > 1:
                raise RuntimeError(
                    f"a mesh of {num_devices} shards asked for, but there "
                    "is no card; name the devices (e.g. devices=['cpu'] * "
                    f"{local}) to put several shards on one device")
            devices = ["cpu"]
        elif local > cards:
            raise RuntimeError(
                f"a mesh of {num_devices} shards needs {local} cards per "
                f"process, this process sees {cards}; name the devices "
                "(e.g. devices=['cuda:0'] * n) to share one card")
        else:
            first = _first_card(cards, local, rank)
            devices = [f"cuda:{first + i}" for i in range(local)]
    num_devices = int(num_devices)
    if len(devices) * world != num_devices:
        raise ValueError(f"{len(devices)} local devices x {world} "
                         f"processes != {num_devices} shards")
    mesh = Mesh(devices, group=group, size=num_devices,
                first=rank * len(devices))
    if mesh.backend == "nccl" and mesh.devices[0].type == "cuda":
        torch.cuda.set_device(mesh.devices[0])
    return mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, **kwargs) -> int:
    """Join a multi-process job (``torch.distributed.init_process_group``).

    The counterpart of ``buffalo_tpu.parallelism.initialize_distributed``
    (``jax.distributed.initialize``).  ``coordinator_address`` is
    "host:port" (a TCP store, as JAX's) or a full init method
    ("tcp://...", "file://..."); ``backend`` defaults to NCCL when a card
    is visible and gloo otherwise.  Nothing on a host tells a program of
    its cluster: give the address, ``num_processes`` and ``process_id``.
    Calling it again once initialized is a no-op, as in the JAX package.
    Returns the world size.
    """
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    method = coordinator_address
    if method is not None and "://" not in method:
        method = f"tcp://{method}"
    if backend == "nccl":  # one card per process until a mesh says more
        torch.cuda.set_device(_first_card(torch.cuda.device_count(), 1,
                                          int(process_id or 0)))
    dist.init_process_group(backend=backend, init_method=method,
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    return dist.get_world_size()


def shutdown_distributed():
    """Destroy the default process group, if any."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_local_copy(array) -> np.ndarray:
    """A tensor or array as a numpy array on this host (``host_local_copy``
    :91); a row-sharded table goes through ``gather_table``, which
    all-gathers the other processes' shards first."""
    if hasattr(array, "detach"):
        return array.detach().cpu().numpy()
    return np.asarray(array)


# ------------------------------------------------------------ collectives
def _per_device(mesh: Mesh, full, like: Sequence):
    """``full`` (on the first local device) placed once per device and
    listed per shard of ``like``."""
    out = {full.device: full}
    res = []
    for t in like:
        if t.device not in out:
            out[t.device] = full.to(t.device)
        res.append(out[t.device])
    return res


def _dist_all_gather(mesh: Mesh, local):
    """The processes' ``local`` tensors concatenated along dim 0 in rank
    order; the fused ``all_gather_into_tensor`` when the backend has it,
    else the list form."""
    import torch
    import torch.distributed as dist

    local = local.contiguous()
    world = dist.get_world_size(mesh.group)
    out = torch.empty((world * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    try:
        dist.all_gather_into_tensor(out, local, group=mesh.group)
    except (RuntimeError, NotImplementedError, AttributeError):
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local, group=mesh.group)
        torch.cat(parts, out=out)
    all_gather_rows.dist_calls += 1
    return out


def all_gather_rows(mesh: Mesh, shards: Sequence,
                    first_only: bool = False):
    """The row-sharded table ``shards`` (one tensor per local shard, equal
    shapes) concatenated in global shard order: one tensor per local
    device, listed per shard (shards on one device share it), or with
    ``first_only`` the one on the first local device.  One local shard
    and no process group: the shard itself, no copy."""
    import torch

    all_gather_rows.calls += 1
    if len(shards) != mesh.local_size:
        raise ValueError(f"{len(shards)} shards for a mesh holding "
                         f"{mesh.local_size}")
    dev0 = shards[0].device
    if len(shards) == 1:
        local = shards[0]
    else:
        local = torch.cat([s.to(dev0) for s in shards])
    if mesh.group is not None:
        local = _dist_all_gather(mesh, local)
    return local if first_only else _per_device(mesh, local, shards)


all_gather_rows.calls = 0
all_gather_rows.dist_calls = 0


def all_reduce_sum(mesh: Mesh, partials: Sequence,
                   first_only: bool = False):
    """The sum of local ``partials`` (equal shapes; one per local shard,
    or this process's one contribution), added in order on the first
    one's device and then over the processes: one tensor per device,
    listed per partial, or with ``first_only`` the first one's."""
    import torch.distributed as dist

    all_reduce_sum.calls += 1
    if not partials:
        raise ValueError("nothing to reduce")
    dev0 = partials[0].device
    total = partials[0].clone()
    for t in partials[1:]:
        total += t.to(dev0)
    if mesh.group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
        all_reduce_sum.dist_calls += 1
    return total if first_only else _per_device(mesh, total, partials)


all_reduce_sum.calls = 0
all_reduce_sum.dist_calls = 0


def reset_counts():
    """Zero the collectives' call counters."""
    for f in (all_gather_rows, all_reduce_sum):
        f.calls = 0
        f.dist_calls = 0


def shard_table(mesh: Mesh, table: np.ndarray) -> list:
    """This process's row shards of a host table whose height is a
    multiple of ``mesh.size``, each a tensor on its shard's device."""
    import torch

    n = table.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards")
    S = n // mesh.size
    return [torch.from_numpy(np.ascontiguousarray(
        table[g * S:(g + 1) * S])).to(dev, copy=True)
        for g, dev in zip(mesh.shards, mesh.devices)]


def write_back(mesh: Mesh, shards: Sequence, full) -> None:
    """Each local shard takes its rows of ``full``, a table gathered by
    ``all_gather_rows`` and then updated (nothing to do when ``full`` is
    the one shard itself)."""
    if full is shards[0]:
        return
    S = shards[0].shape[0]
    for g, t in zip(mesh.shards, shards):
        t.copy_(full[g * S:(g + 1) * S])


def gather_table(mesh: Mesh, shards: Sequence) -> np.ndarray:
    """The whole row-sharded table on the host (every process gets it)."""
    return host_local_copy(all_gather_rows(mesh, shards)[0])
