"""Data parallelism: a device mesh for serving, DDP for training.

The port of the JAX package's parallel/mesh.py. There one SPMD program
runs over a jax.sharding.Mesh: parameters replicated, the batch sharded
over the 'data' axis, XLA inserting the gradient all-reduce; BatchNorm
and the loss see the whole batch. Here the two uses take PyTorch's two
idioms:

 * serving, one process over several cards (`KeyEstimator(mesh=...)`):
   `make_mesh` names the devices, `replicate` puts one eval-mode copy of
   the model on each, `shard_batch` splits the rows evenly; each shard
   runs its CQT and model on its own device;
 * training, one process per card (torchrun): `init_data_parallel`
   starts the process group, the trainer wraps the model in
   DistributedDataParallel and each rank takes `rank_rows` of every
   micro-batch of the same shuffled global batch. BatchNorm statistics,
   dropout masks and the loss's batch-wide normalizers are taken over
   the global micro-batch (models/blocks.py, train/loss.py), so a step
   computes what the JAX sharded step computes.

`fit_data_mesh` leaves devices idle when the batch does not divide over
all of them; a DDP rank cannot stay idle (every rank takes part in
every collective), so a world size that does not divide the micro-batch
raises instead. The port's mesh has one axis, 'data'.
"""

from __future__ import annotations

import copy
import datetime
import math
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


# ---------------------------------------------------------------------------
# serving: one process, several devices
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """Devices along the 'data' axis (a device may appear more than
    once: two replicas on one card)."""
    devices: tuple
    axis_names: tuple = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(mesh_shape: Sequence[int] = (),
              axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A 'data' mesh over `devices` (default: every visible CUDA device),
    the first prod(mesh_shape) of them (all with mesh_shape ())."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available (pass "
                               "devices=[...] to build a mesh of others)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not mesh_shape:
        mesh_shape = (len(devices),)
    if len(mesh_shape) != 1 or tuple(axis_names[:1]) != ("data",):
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} / axes "
                         f"{tuple(axis_names)}: the port's mesh has one "
                         "'data' axis")
    n = int(mesh_shape[0])
    if not 1 <= n <= len(devices):
        raise ValueError(f"mesh of {n} devices from {len(devices)}")
    if len({d.type for d in devices[:n]}) != 1:
        raise ValueError(f"mesh devices of mixed types: {devices[:n]}")
    return Mesh(tuple(devices[:n]), ("data",))


def fit_data_mesh(batch_size: int, mesh_shape: Sequence[int] = (),
                  axis_names: Sequence[str] = ("data",),
                  devices: Optional[Sequence] = None) -> Mesh:
    """A 'data' mesh no larger than what the batch divides evenly: with
    an explicit mesh_shape the caller's; otherwise the largest device
    count d <= len(devices) with batch_size % d == 0."""
    if mesh_shape:
        return make_mesh(mesh_shape, axis_names, devices)
    n = make_mesh((), axis_names, devices).size
    d = max(k for k in range(1, n + 1) if batch_size % k == 0)
    return make_mesh((d,), axis_names, devices)


def replicate(module: torch.nn.Module, mesh: Mesh) -> list:
    """One eval-mode copy of `module` on each mesh device, all loaded
    from one state_dict."""
    state = module.state_dict()
    out = []
    for dev in mesh.devices:
        m = copy.deepcopy(module).to(dev)
        m.load_state_dict(state)
        out.append(m.eval())
    return out


def shard_batch(batch, mesh: Mesh, *, batch_dim: int = 0) -> list:
    """Split every tensor of `batch` (a tensor or a dict of them) along
    `batch_dim` into mesh.size equal row blocks, block i on device i, as
    the JAX P('data') sharding places them; a tensor with no such
    dimension is copied whole to every device. Returns one batch per
    device."""
    def shards(x):
        if x.ndim <= batch_dim:
            return [x.to(d) for d in mesh.devices]
        n = x.shape[batch_dim]
        if n % mesh.size:
            raise ValueError(f"{n} rows along dim {batch_dim} do not "
                             f"divide over {mesh.size} devices")
        k = n // mesh.size
        return [x.narrow(batch_dim, i * k, k).to(d)
                for i, d in enumerate(mesh.devices)]
    if isinstance(batch, dict):
        per_key = {name: shards(x) for name, x in batch.items()}
        return [{name: s[i] for name, s in per_key.items()}
                for i in range(mesh.size)]
    return shards(batch)


# ---------------------------------------------------------------------------
# training: one process per device
# ---------------------------------------------------------------------------

def init_data_parallel(device="cuda", backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       timeout_s: float = 300.0) -> torch.device:
    """Start the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/MASTER_PORT; or the arguments, and an
    init_method such as 'file:///path/store') and return this rank's
    device: cuda:LOCAL_RANK for a CUDA `device`, else the CPU. The
    backend defaults to nccl on CUDA and gloo on the CPU; nccl without
    CUDA raises, and so does a rendezvous that does not complete within
    timeout_s."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_data_parallel: CUDA is not available "
                               "(pass device='cpu' to train on the CPU)")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError("init_data_parallel: the nccl backend needs a "
                           f"CUDA device, got {device}")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def start_data_parallel(device) -> torch.device:
    """The device an entry point runs on: under torchrun (WORLD_SIZE set)
    the process group is started, or taken as a caller started it, and
    this rank's device returned (cuda:LOCAL_RANK, or the CPU for a CPU
    `device`); with no group, `device` itself."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        if device.type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return device
    if "WORLD_SIZE" in os.environ:
        return init_data_parallel(device)
    return device


def data_world() -> tuple:
    """(rank, world size) of the process group, or (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_rows(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s contiguous rows of a global micro-batch of n rows;
    n must divide evenly (a DDP rank cannot sit out a collective)."""
    if n % world:
        raise ValueError(f"a micro-batch of {n} rows does not divide over "
                         f"{world} ranks")
    k = n // world
    return slice(rank * k, (rank + 1) * k)


def check_mesh_shape(mesh_shape: Sequence[int], world: int) -> None:
    """A Config.mesh_shape must name the group's world size (() takes
    whatever the group has)."""
    if mesh_shape and math.prod(mesh_shape) != world:
        raise ValueError(f"Config.mesh_shape {tuple(mesh_shape)} asks for "
                         f"{math.prod(mesh_shape)} ranks; the process group "
                         f"has {world}")


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the group in place (no autograd); returns it."""
    dist.all_reduce(t)
    return t


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank src's integer on every rank (through a CUDA tensor on nccl,
    which takes no other)."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, src)
    return int(t.item())


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if data_world()[1] > 1:
        dist.barrier()
