"""Point-shard meshes over torch.distributed (port of dr3_tpu.parallel.mesh).

The reference is single-process (SURVEY §2); the JAX package shards map
points and their observations over a ``jax.sharding.Mesh`` with XLA
collectives. Here a mesh is a small value: the process group (one rank,
an OS process, per card; the JAX package's processes), this rank's
device, and the number of point shards the rank holds. A rank's shards
are a leading axis of its data; the collectives run over the group (NCCL
on the card, gloo on the CPU: the device decides, never a flag).

* ``make_mesh(n)`` in one process gives ``n`` shards on this rank's device
  — what the JAX package's ``n`` virtual CPU devices stand for;
  ``make_mesh()`` gives one shard (one card, one chip).
* ``make_mesh_2d`` is the [hosts, points] layout, its host axis the ranks
  (as ``jax.process_count()`` counts processes): each rank's shards summed
  in a fixed order before the one reduction across ranks (the JAX
  package's psum over ICI, then DCN).

JAX's ``shard_spec`` / ``replicated`` return JAX shardings and have no
counterpart. Every collective of the port stays behind this module and
parallel/dist_ba.py.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from dr3_tpu_torch.utils.device import resolve as resolve_device

POINT_AXIS = "points"  # canonical mesh axis name for map/observation sharding
HOST_AXIS = "hosts"    # cross-process (rank) axis of the 2-level mesh


class Mesh(NamedTuple):
    """Point shards over ranks: ``shape`` shards in all (a grid over
    ``axis_names``), ``n_local`` of them on this rank's ``device``;
    ``group`` is the process group the partial sums are reduced over, or
    None in a single process."""

    group: Optional[object]
    device: torch.device
    n_local: int
    shape: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        """Point shards over all ranks."""
        return math.prod(self.shape)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)


def _group_and_device(device) -> tuple:
    """(the default process group or None, this rank's device). With a
    group, the device follows its backend: an NCCL rank's card is
    ``cuda:LOCAL_RANK`` (set by :func:`distributed_init`), a gloo rank's the
    CPU; a device asked for must agree with it."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    if group is None:
        return None, resolve_device(device, "make_mesh")
    nccl = dist.get_backend(group) == "nccl"
    dev = (torch.device("cuda", torch.cuda.current_device()) if nccl
           else torch.device("cpu"))
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"make_mesh: device {device} on a {dist.get_backend(group)} group "
                         f"(NCCL ranks hold CUDA tensors, gloo ranks CPU tensors)")
    return group, dev


def make_mesh(n_devices: Optional[int] = None, axis: str = POINT_AXIS,
              device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` point shards (default: one per rank).
    With a process group of W ranks, ``n_devices`` must be a multiple of W
    and each rank holds ``n_devices / W`` shards. ``device`` (default the
    card, or the group's) is where a single process keeps its shards."""
    group, dev = _group_and_device(device)
    world = 1 if group is None else dist.get_world_size(group)
    n = world if n_devices is None else int(n_devices)
    if n < 1 or n % world:
        raise ValueError(f"{n} point shards over {world} ranks")
    return Mesh(group, dev, n // world, (n,), (axis,))


def make_mesh_2d(n_hosts: Optional[int] = None, n_devices: Optional[int] = None,
                 device=None) -> Mesh:
    """Two-level [hosts, points] mesh (SURVEY §7 config 5), one host entry
    per rank; the point/observation axis shards over both axes, each rank's
    shards summed in a fixed order before the one reduction across ranks.
    ``n_hosts`` defaults to the world size (1 in a single process, where
    the host axis still exists for code-path parity); in a single process
    ``n_hosts`` > 1 lays that many virtual hosts over the process's
    shards. ``n_devices`` (default ``n_hosts``) counts shards over all
    hosts."""
    group, dev = _group_and_device(device)
    world = 1 if group is None else dist.get_world_size(group)
    if n_hosts is None:
        n_hosts = world
    if world > 1 and n_hosts != world:
        raise ValueError(f"{n_hosts} hosts on a group of {world} ranks (one host entry "
                         f"per rank)")
    n = n_hosts if n_devices is None else int(n_devices)
    if n < 1 or n % n_hosts:
        raise ValueError(f"{n} devices not divisible by {n_hosts} hosts")
    return Mesh(group, dev, n // world, (n_hosts, n // n_hosts), (HOST_AXIS, POINT_AXIS))


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None) -> bool:
    """Join the default process group for a multi-process run.

    Arguments omitted are read from torchrun's environment contract
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``). ``coordinator`` is ``host:port`` or an init-method URL
    (``tcp://...``, ``file://...``). Does nothing and returns False in a
    single-process run, so every CLI can call it unconditionally.

    The device (default the card) decides the backend: NCCL with one rank
    per card (rank ``LOCAL_RANK`` takes ``cuda:LOCAL_RANK``; more ranks on
    a host than visible cards raises), gloo on the CPU. A failed
    initialisation raises."""
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "0") or 0)
    if process_id is None and env.get("RANK") is not None:
        process_id = int(env["RANK"])
    if not coordinator or num_processes <= 1 or process_id is None:
        return False
    dev = resolve_device(device, "distributed_init")
    backend = "gloo"
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"distributed_init: local rank {local} but "
                               f"{torch.cuda.device_count()} visible cards; NCCL takes "
                               f"one rank per card")
        torch.cuda.set_device(local)
        backend = "nccl"
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    return True


def distributed_shutdown() -> None:
    """Leave the default process group of a multi-process run: a barrier
    first, so that no rank closes its connections while a peer is still
    in a collective over them, then ``destroy_process_group``. Does
    nothing when no group was joined. A caller drops its meshes (which
    hold the group) before, so that the group is torn down here and not
    while the interpreter exits."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    dist.destroy_process_group()


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
