"""The port's device mesh on torch.distributed (the counterpart of JAX's
`jax.sharding.Mesh` in timemachine_tpu/parallel/).

JAX runs one program over many devices; here every rank of a process group
runs the same program (SPMD) and a mesh is a 1-D
`torch.distributed.device_mesh.DeviceMesh` over the default group's ranks,
with JAX's axis names ("replica", "spatial", "rows"). The mesh code's
collectives are all-reduce, all-gather and broadcast over the mesh's
group, through the helpers here; each takes mesh=None to mean one local
rank (no collective), as JAX's mesh=None means everything local.

Where no process group is initialized, `make_mesh` makes a one-rank group
on a torch.distributed.HashStore (no network, no environment variables):
nccl on the card, gloo on the CPU. Several ranks are started by
`spawn_ranks` (torch.multiprocessing, a file:// store) on the backend
`default_backend` picks: nccl where each rank has a card of its own, gloo
on the CPU and for ranks that share a card (nccl refuses two ranks on one
card). gloo has no collective for every CUDA operation, so on a gloo group
the helpers stage CUDA tensors through the host.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from timemachine_torch.device import resolve_device


def _mesh_device(devices) -> torch.device:
    """The device type a mesh's `devices` argument names: None the card, a
    device (or its name), or a sequence of devices of one type, one a rank."""
    if devices is None or isinstance(devices, (str, torch.device)):
        return resolve_device(devices)
    types = {torch.device(d).type for d in devices}
    if len(types) != 1:
        raise ValueError(f"make_mesh: devices of one type, got {sorted(types)}")
    if len(devices) != world_size():
        raise ValueError(f"make_mesh: {len(devices)} devices for {world_size()} ranks: one device a rank")
    return torch.device(types.pop())


def world_size() -> int:
    """The default process group's size, 1 where none is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def default_backend(device=None, n_ranks: int = 1) -> str:
    """The process group backend for n_ranks ranks on `device` (None: the
    card): nccl where each rank has a card of its own, else gloo."""
    cuda = resolve_device(device).type == "cuda"
    return "nccl" if cuda and n_ranks <= torch.cuda.device_count() else "gloo"


def ensure_process_group(device=None):
    """Initialize a one-rank default group on a HashStore where none is:
    nccl for the card, gloo for the CPU."""
    if not dist.is_initialized():
        dist.init_process_group(default_backend(device), store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(devices=None, axis_name: str = "replica", ranks=None):
    """A 1-D DeviceMesh named (axis_name,) over the ranks `ranks` of the
    default process group (None: every rank), on the card unless `devices`
    names the CPU (a device, its name, or one device a rank). Every rank of
    the group calls it; a rank outside `ranks` gets a mesh it is not in."""
    device = _mesh_device(devices)
    ensure_process_group(device)
    from torch.distributed.device_mesh import DeviceMesh

    if device.type == "cuda":  # each rank its card (ranks beyond the cards share them)
        torch.cuda.set_device(device.index if device.index is not None else dist.get_rank() % torch.cuda.device_count())

    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    return DeviceMesh(device.type, ranks, mesh_dim_names=(axis_name,))


def _axis(mesh, axis_name: Optional[str]) -> int:
    names = mesh.mesh_dim_names or ()
    if axis_name is None or axis_name in names:
        return 0 if axis_name is None else names.index(axis_name)
    raise ValueError(f"the mesh has axes {names}, not {axis_name!r}")


def mesh_group(mesh, axis_name: Optional[str] = None):
    return mesh.get_group(_axis(mesh, axis_name))


def mesh_size(mesh, axis_name: Optional[str] = None) -> int:
    """Ranks along the axis; 1 for mesh None."""
    return 1 if mesh is None else mesh.size(_axis(mesh, axis_name))


def mesh_rank(mesh, axis_name: Optional[str] = None) -> int:
    """This rank's index along the axis; 0 for mesh None."""
    return 0 if mesh is None else mesh.get_local_rank(_axis(mesh, axis_name))


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, mesh, axis_name: Optional[str] = None) -> torch.Tensor:
    """t summed over the mesh's ranks, in place (returned); integer tensors
    sum exactly."""
    if mesh is None:
        return t
    group = mesh_group(mesh, axis_name)
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, mesh, axis_name: Optional[str] = None) -> torch.Tensor:
    """Every rank's t (of one shape on every rank) joined along dim 0 in rank order."""
    if mesh is None:
        return t
    group = mesh_group(mesh, axis_name)
    src = t.detach().contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh_size(mesh, axis_name))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if staged else out


def broadcast(t: torch.Tensor, mesh, src: int = 0, axis_name: Optional[str] = None) -> torch.Tensor:
    """t of the mesh's rank `src` on every rank, in place (returned)."""
    if mesh is None:
        return t
    group = mesh_group(mesh, axis_name)
    root = dist.get_global_rank(group, src)
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src=root, group=group)
        return t.copy_(host)
    dist.broadcast(t, src=root, group=group)
    return t


def replica_slice(n_replicas: int, mesh, axis_name: Optional[str] = None) -> slice:
    """The replicas of this rank: replica r lives on rank r // (K / ranks).
    K must divide over the ranks."""
    ranks = mesh_size(mesh, axis_name)
    if n_replicas % ranks:
        raise ValueError(f"{n_replicas} replicas do not divide over {ranks} ranks")
    per = n_replicas // ranks
    lo = mesh_rank(mesh, axis_name) * per
    return slice(lo, lo + per)


def _rank_main(rank: int, fn: Callable, n_ranks: int, backend: str, init_method: str, args: tuple):
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n_ranks)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n_ranks: int, args: Sequence = (), backend: str = "gloo", store_dir=None):
    """Run fn(rank, *args) in n_ranks new processes, each rank of one
    default process group on `backend` over a file:// store in store_dir (a
    new temporary directory where None); return when every rank has ended,
    raising if one failed. fn must be importable by name (a module-level
    function), as torch.multiprocessing's spawn requires."""
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, args=(fn, n_ranks, backend, init_method, tuple(args)), nprocs=n_ranks, join=True)
