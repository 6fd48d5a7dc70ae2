"""Multi-process runtime (port of ``kmc_tpu/parallel/distributed.py``).

One process (rank) a card, joined by ``torch.distributed``: NCCL between
cards, gloo between CPU processes, and only when the caller passes
``device="cpu"``.  There is no fallback from NCCL to gloo or from the card
to the CPU: where ``KMC_COORDINATOR`` is set and the group cannot be
formed, ``initialize`` raises.

Launch N ranks with the same command and the variables

    KMC_COORDINATOR=host:port KMC_NUM_PROCESSES=N KMC_PROCESS_ID=i

(rank i takes card i % cards).  Without them every helper is the exact
single-process form: ``initialize`` does nothing, the world is one rank
and ``all_hosts_mean`` is the identity.
"""

from __future__ import annotations

import datetime
import os

import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.parallel.mesh import ReplicaMesh, replica_mesh, world
from kmc_tpu_torch.state import SimState, resolve_device

DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None,
               timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group named by the arguments or the ``KMC_*``
    variables; returns whether a group was formed.  A no-op (False) when
    no coordinator is given or set, or when this process has joined
    already."""
    import torch.distributed as dist

    if coordinator is None:
        coordinator = os.environ.get("KMC_COORDINATOR")
    if coordinator is None or dist.is_initialized():
        return False
    if num_processes is None:
        num_processes = int(os.environ["KMC_NUM_PROCESSES"])
    if process_id is None:                        # NB: 0 is a valid id
        process_id = int(os.environ["KMC_PROCESS_ID"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_replica_mesh(device=None) -> ReplicaMesh:
    """The replica mesh over every rank of the world."""
    return replica_mesh(device)


def host_local_ensemble(cfg: SimConfig, replicas_per_host: int,
                        seed: int | None = None, device=None) -> SimState:
    """This rank's replica block: rank p of W starts
    init_ensemble(cfg, replicas_per_host, seed=(seed or 0) * W + p), so the
    global ensemble is the concatenation of the per-rank blocks in rank
    order (not init_ensemble(cfg, replicas_per_host * W)).  No data moves
    between ranks."""
    from kmc_tpu_torch.parallel.ensemble import init_ensemble

    mesh = global_replica_mesh(device)
    return init_ensemble(cfg, replicas_per_host,
                         seed=(seed or 0) * mesh.size + mesh.rank,
                         device=mesh.device)


def _wire_device() -> torch.device:
    """Where a tensor must be for the group's backend."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_hosts_mean(x):
    """Mean of ``x`` over the ranks (an all-reduce); the identity at world
    size 1.  Floating inputs keep their dtype, others come back float32;
    the sum is made in float64."""
    import torch.distributed as dist

    if world()[1] == 1:
        return x
    t = torch.as_tensor(x)
    out_dtype = t.dtype if t.is_floating_point() else torch.float32
    buf = t.to(_wire_device(), torch.float64).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return (buf / world()[1]).to(t.device, out_dtype)


def gather_to_rank0(tensors):
    """Each tensor's blocks from every rank, concatenated along the leading
    axis in rank order, on rank 0 (on its device); None on the other
    ranks.  Every rank passes tensors of the same shapes.  At world size 1
    the tensors come back as they are."""
    import torch.distributed as dist

    rank, size = world()
    tensors = list(tensors)
    if size == 1:
        return tensors
    wire = _wire_device()
    out = [] if rank == 0 else None
    for t in tensors:
        # bools travel as bytes: not every backend reduces or gathers bool
        send = t.to(wire, torch.uint8 if t.dtype == torch.bool
                    else t.dtype).contiguous()
        parts = ([torch.empty_like(send) for _ in range(size)] if rank == 0
                 else None)
        dist.gather(send, parts, dst=0)
        if rank == 0:
            out.append(torch.cat(parts).to(t.device, t.dtype))
    return out


def gather_replicas(state):
    """The ensemble (a SimState or an Observables) gathered from the
    replica blocks of every rank, on rank 0; None on the other ranks."""
    parts = gather_to_rank0(state)
    return None if parts is None else type(state)(*parts)
