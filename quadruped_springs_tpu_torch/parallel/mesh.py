"""Process group, device mesh and rank launcher: the communication layer.

Port of ``quadruped_springs_tpu.parallel.mesh``. Where the JAX package
shards one program over a ('dcn', 'ici') mesh of devices, the port runs one
process per device under ``torch.distributed``: NCCL between cards, gloo
between CPU processes. Scenario batches split into contiguous row blocks,
one per rank (``scenario_rows``, the counterpart of the JAX
``scenario_sharding``); global reductions are collectives of the default
group. ``launch`` starts and joins the ranks of one machine.

Nothing in a cluster tells a process its rank: ``init_distributed`` takes
the address, world size and rank from its caller (world size 1 and a free
localhost port by default).
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SCENARIO_AXES = ("dcn", "ici")


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device=None) -> torch.device:
    """Join (or form) the default process group; return this rank's device.

    `device` is a device type, the card ("cuda") unless the caller names
    another: the backend is then NCCL and the rank takes card rank mod the
    local card count; on "cpu" it is gloo. world_size defaults to 1 and
    rank to 0; init_method to tcp://localhost on a free port, which only a
    world of one can find (a larger world passes the address). A process
    already in a group keeps it.
    """
    device_type = torch.device(device if device is not None else "cuda").type
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA card (pass device='cpu' for gloo)")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device_type)
    if dist.is_initialized():
        return dev
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_distributed: a world of several ranks needs an "
                             "init_method (tcp://host:port)")
        init_method = f"tcp://localhost:{free_port()}"
    backend = "nccl" if device_type == "cuda" else "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(minutes=10), **kw)
    return dev


def scenario_mesh(device_type: str | None = None):
    """The ('dcn', 'ici') DeviceMesh of the default group: hosts x ranks per
    host. One host here, so (1, world): its ranks' cards on a CUDA machine,
    or its CPU processes."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type if device_type is not None else "cuda"
    world = dist.get_world_size()
    per_host = min(world, torch.cuda.device_count()) if device_type == "cuda" else world
    return init_device_mesh(device_type, (world // per_host, per_host),
                            mesh_dim_names=SCENARIO_AXES)


def _position(mesh=None) -> tuple[int, int]:
    """(this rank's index, the number of ranks) over all axes of `mesh`, or
    of the default group (one rank when no group exists)."""
    if mesh is not None:
        coord, shape = mesh.get_coordinate(), mesh.mesh.shape
        idx = 0
        for c, s in zip(coord, shape):
            idx = idx * s + c
        return idx, mesh.size()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def scenario_rows(n_rows: int, mesh=None) -> slice:
    """The contiguous block of a batch of n_rows that this rank owns; the
    batch must divide evenly over the ranks."""
    idx, world = _position(mesh)
    if n_rows % world:
        raise ValueError(f"a batch of {n_rows} does not divide over {world} ranks")
    per = n_rows // world
    return slice(idx * per, (idx + 1) * per)


def _rank_main(rank, world_size, init_method, device_type, fn, args, results):
    if device_type == "cpu":      # the ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init_distributed(init_method=init_method, world_size=world_size, rank=rank,
                     device=device_type)
    try:
        results.put((rank, fn(rank, world_size, *args)))
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, args: tuple = (), device=None,
           timeout: float | None = None) -> list:
    """Run fn(rank, world_size, *args) in world_size spawned processes that
    form one process group on this machine (NCCL on the cards, one per rank,
    unless `device` is "cpu": gloo); return the ranks' results in rank order.

    fn must be importable by the children (a module-level function). A rank
    that fails raises here, with its traceback, and the others are stopped;
    after `timeout` seconds every rank still running is killed and
    TimeoutError raised.
    """
    device_type = torch.device(device if device is not None else "cuda").type
    if device_type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"launch: {world_size} ranks need {world_size} CUDA cards, "
                           f"found {torch.cuda.device_count()}")
    results = mp.get_context("spawn").SimpleQueue()
    init_method = f"tcp://localhost:{free_port()}"
    ctx = mp.spawn(_rank_main, (world_size, init_method, device_type, fn, args, results),
                   nprocs=world_size, join=False)
    out = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        done = False
        while True:
            # drain before joining: a rank blocks on a full pipe until read
            while not results.empty():
                rank, value = results.get()
                out[rank] = value
            if done:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"launch: ranks still running after {timeout} s")
            done = ctx.join(timeout=0.1)      # raises if a rank failed
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
