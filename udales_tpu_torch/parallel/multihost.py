"""Several processes, one mesh (port of ``udales_tpu.parallel.multihost``).

The reference spans hosts with MPI ranks (modmpi.f90 initmpi).  Here each
rank is one process in a ``torch.distributed`` group, started by
``torchrun`` (which sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
LOCAL_RANK) or by the caller, with NCCL between CUDA devices or gloo on the
CPU.  Every process builds the same whole-domain State and keeps its own
block of it (`shard_state_global`); the Model takes the mesh
(``run.Model(..., mesh=global_mesh())``).

A single-process run never needs this module.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, map_state, shard_state


def free_port() -> int:
    """A free TCP port on localhost (for a group on one machine)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device="cuda", timeout: float = 600.0):
    """Initialize the default process group (once; later calls return the
    group as it is).  Returns (rank, world_size).

    With no arguments the values come from torchrun's environment
    (MASTER_ADDR:MASTER_PORT, RANK, WORLD_SIZE); without it, one process on
    a free localhost port.  `coordinator_address` is "host:port".  The
    backend is `backend` as given, else "nccl" for `device` "cuda" and
    "gloo" for "cpu"; nothing falls back to another.  On CUDA the process
    takes device LOCAL_RANK (else its rank) modulo the visible devices, and
    raises without one.  A collective that waits longer than `timeout`
    seconds fails."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif num_processes == 1:
            coordinator_address = f"localhost:{free_port()}"
        else:
            raise ValueError("init_distributed: no coordinator address; pass "
                             "one or set MASTER_ADDR and MASTER_PORT")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device (pass "
                               "device='cpu' to run on the CPU)")
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes,
                            timeout=timedelta(seconds=timeout))
    return dist.get_rank(), dist.get_world_size()


def global_mesh(nprocx: int | None = None, nprocy: int | None = None,
                host_staged: bool = False) -> Mesh:
    """A mesh over every process of the group.  Defaults to the most-square
    factorization of the world size with nprocx >= nprocy, the heuristic the
    reference suggests for nprocx/nprocy (docs/udales-2decomp.md)."""
    n = dist.get_world_size()
    if nprocx is None or nprocy is None:
        nprocy = int(np.floor(np.sqrt(n)))
        while n % nprocy != 0:
            nprocy -= 1
        nprocx = n // nprocy
    return make_mesh(nprocx, nprocy, host_staged=host_staged)


def shard_state_global(state, mesh: Mesh, device="cuda"):
    """This process's block of every leaf of `state`, the same
    whole-domain (host) State on every process, on `device`."""
    return map_state(lambda path, leaf: leaf.to(device),
                     shard_state(state, mesh))
