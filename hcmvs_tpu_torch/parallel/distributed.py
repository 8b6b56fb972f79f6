"""Multi-process runtime: torch.distributed, the global (view, tile) mesh
and its collectives (PyTorch port of
``hcmvs_tpu/parallel/distributed.py``).

The reference's only cross-process mechanism is the filesystem (run.sh
moves the depth-map directories between stages; ref: run.sh:1-20).  Here
every process joins one ``torch.distributed`` process group and owns its
shards of the (view, tile) mesh (``parallel.sharding``): the cross-view
reads of the geometric phase, the filter and fusion read maps that an
all-gather has made whole on every process, and the row bands of a view
trade their edge rows inside their tile group (``gather_in_group``,
timed by its caller as ``parallel.halo``).

Backends: ``nccl`` for CUDA and ``gloo`` for the CPU unless the caller
names one.  Gloo also carries CUDA tensors (``all_gather``,
``all_reduce``, ``broadcast``), staged through host memory: that is how
two processes share one card, where NCCL refuses two ranks on one
device.  Every collective is timed into ``utils.profiling``'s report as
``parallel.all_gather`` / ``parallel.broadcast`` / ``parallel.halo``.

On the CPU (tests, no card): processes rendezvous through a ``file://``
path and use Gloo; ``parallel.mh_check.launch`` starts them.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from hcmvs_tpu_torch.utils.profiling import stage_timer

# how long a collective may wait for the other processes: a dead rank
# fails the others after this, it does not hang them
TIMEOUT_S = 300


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device=None) -> bool:
    """Join the process group (idempotent); returns whether one is up.

    With no arguments, reads HCMVS_COORDINATOR (``host:port``, or any
    ``init_method`` URL such as ``file:///path``) / HCMVS_NUM_PROCESSES /
    HCMVS_PROCESS_ID, then torchrun's RANK / WORLD_SIZE (``env://``).  A
    run with none of these is a single process: a no-op, False.
    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo``
    otherwise."""
    if dist.is_initialized():
        return True
    env = os.environ
    init_method = init_method or env.get("HCMVS_COORDINATOR")
    if world_size is None and "HCMVS_NUM_PROCESSES" in env:
        world_size = int(env["HCMVS_NUM_PROCESSES"])
    if rank is None and "HCMVS_PROCESS_ID" in env:
        rank = int(env["HCMVS_PROCESS_ID"])
    if init_method is None and world_size is None and "RANK" in env:
        init_method = "env://"
        world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    if init_method is None and not world_size:
        return False                      # single-process mode
    if init_method is None:
        raise ValueError("a process group of "
                         f"{world_size} needs an init_method "
                         "(HCMVS_COORDINATOR)")
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    device = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size or 1,
        rank=rank or 0, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def local_device(device) -> torch.device:
    """This process's device: a CUDA request maps rank r to card
    r mod the card count (every rank on card 0 of a one-card machine)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def world() -> tuple:
    """(rank, world size): (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(n_tile: int = 1, device="cuda",
                shards_per_process: Optional[int] = None):
    """The (view, tile) mesh over every process of the group
    (``shards_per_process`` shards a process; by default one, or as many
    as it takes for the processes to hold ``n_tile`` bands), view-major
    in process order as the JAX package's
    (``hcmvs_tpu/parallel/distributed.py:59-66``): ``n *
    shards_per_process // n_tile`` view blocks of ``n_tile`` row bands.
    ``torch.distributed``'s ``DeviceMesh`` of dims ("view", "tile") over
    the processes is attached, and its "tile" group, when a tile group
    spans several processes; a single process without a group gets a
    mesh of its own shards."""
    from torch.distributed.device_mesh import init_device_mesh

    from hcmvs_tpu_torch.parallel.sharding import make_device_mesh
    device = local_device(device)
    rank, n = world()
    if shards_per_process is None:
        shards_per_process = max(1, -(-n_tile // n))
    shards = n * shards_per_process
    if n_tile < 1 or shards % n_tile:
        raise ValueError(f"{shards} shards do not split into row bands of "
                         f"{n_tile}")
    mesh = make_device_mesh(shards // n_tile, n_tile, device=device)
    if dist.is_initialized():
        procs = mesh.tile_procs
        mesh.device_mesh = init_device_mesh(
            device.type, (n // procs, procs),
            mesh_dim_names=("view", "tile"))
        if procs > 1:
            mesh.tile_group = mesh.device_mesh.get_group("tile")
    return mesh


def fetch(x: torch.Tensor, blocks: List[range]) -> torch.Tensor:
    """A view-sharded tensor made whole on every process (the JAX
    package's all-gather to a replicated array): the rows of every
    process's block, concatenated in process order:
    ``x`` holds this process's rows (len(blocks[rank]), ...), and process
    p's block is ``blocks[p]`` (blocks may differ in length: they are
    padded to the longest for the collective).  Booleans travel as uint8.
    Without a process group, ``x`` itself."""
    if not dist.is_initialized():
        return x
    longest = max(len(b) for b in blocks)
    send = x.to(torch.uint8) if x.dtype == torch.bool else x
    if send.shape[0] < longest:
        pad = send.new_zeros((longest - send.shape[0],) + send.shape[1:])
        send = torch.cat([send, pad])
    send = send.contiguous()
    parts = [torch.empty_like(send) for _ in blocks]
    with stage_timer("parallel.all_gather", block_on=send.device):
        dist.all_gather(parts, send)
    out = torch.cat([p[:len(b)] for p, b in zip(parts, blocks)])
    return out.to(torch.bool) if x.dtype == torch.bool else out


def gather_in_group(x: torch.Tensor, group, size: int
                    ) -> List[torch.Tensor]:
    """Every process's ``x`` (the same shape and dtype on each) in the
    process group ``group`` of ``size`` processes, in the group's rank
    order: an all-gather, untimed (the caller times it under its own
    name)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return parts


def sum_in_rank_order(x: torch.Tensor) -> torch.Tensor:
    """The sum over processes of each one's ``x``, added in rank order
    (an all-gather, then a fixed-order sum: every process gets the same
    bits, whatever the backend's own reduction order would be).  Without
    a process group, ``x`` itself."""
    if not dist.is_initialized():
        return x
    send = x.contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size())]
    with stage_timer("parallel.all_gather", block_on=send.device):
        dist.all_gather(parts, send)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def replicated(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Host data of process ``src`` on every process (a broadcast; every
    process passes a tensor of the same shape and dtype)."""
    if not dist.is_initialized():
        return x
    x = x.contiguous()
    with stage_timer("parallel.broadcast", block_on=x.device):
        dist.broadcast(x, src)
    return x


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
