"""Rank meshes (port of ``kmc_tpu/parallel/mesh.py``).

torch has no single-process SPMD partitioner, so the counterpart of a JAX
device mesh is the ``torch.distributed`` world: one process (rank) a card,
NCCL between cards, gloo between CPU processes.  A mesh here is a
description of the world from this rank's side:

* ``replica_mesh``: the ranks as one replica ("dp") axis; rank p holds the
  contiguous block ``[p * R / W, (p + 1) * R / W)`` of the leading replica
  axis, the block that ``NamedSharding(mesh, P("dp"))`` puts on device p;
* ``grid_mesh``: the ranks as an (nx, ny) grid in row-major order for a
  domain-decomposed lattice (``parallel/halo.py``), with each rank's four
  periodic neighbours.

Without a process group the world is this process alone (rank 0 of 1),
so every helper also runs unsharded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kmc_tpu_torch.state import SimState, resolve_device


class ReplicaMesh(NamedTuple):
    rank: int
    size: int
    device: torch.device


class GridMesh(NamedTuple):
    shape: tuple[int, int]    # (nx, ny): ranks along rows, along columns
    rank: int
    coords: tuple[int, int]   # this rank's (ix, iy)
    up: int                   # rank holding the rows above (ix - 1)
    down: int                 # rows below (ix + 1)
    left: int                 # columns to the left (iy - 1)
    right: int                # columns to the right (iy + 1)
    device: torch.device


def world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device=None) -> torch.device:
    """This rank's device: the current card (``distributed.initialize``
    sets it to the rank's) unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def replica_mesh(device=None) -> ReplicaMesh:
    """The world as a 1-D replica mesh."""
    rank, size = world()
    return ReplicaMesh(rank, size, rank_device(device))


def grid_mesh(shape, device=None) -> GridMesh:
    """The world as an (nx, ny) rank grid, rank = ix * ny + iy; the grid
    must hold every rank."""
    nx, ny = (int(s) for s in shape)
    rank, size = world()
    if nx * ny != size:
        raise ValueError(f"a {nx} x {ny} rank grid needs {nx * ny} ranks, "
                         f"the world has {size}")
    ix, iy = divmod(rank, ny)
    return GridMesh(
        shape=(nx, ny), rank=rank, coords=(ix, iy),
        up=((ix - 1) % nx) * ny + iy, down=((ix + 1) % nx) * ny + iy,
        left=ix * ny + (iy - 1) % ny, right=ix * ny + (iy + 1) % ny,
        device=rank_device(device))


def replica_sharding(mesh: ReplicaMesh, n_replicas: int) -> slice:
    """This rank's slice of the leading replica axis of ``n_replicas``."""
    if n_replicas % mesh.size:
        raise ValueError(f"{n_replicas} replicas do not divide over "
                         f"{mesh.size} ranks")
    per = n_replicas // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_replicated_state(state: SimState, mesh: ReplicaMesh) -> SimState:
    """This rank's block of every leaf of an ensemble state, on its
    device."""
    sl = replica_sharding(mesh, state.step.shape[0])
    return SimState(*(x[sl].to(mesh.device).clone() for x in state))
