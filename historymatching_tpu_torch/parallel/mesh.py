"""Device mesh helpers for ensemble ("ens") parallelism (PyTorch counterpart
of `historymatching_tpu.parallel.mesh`).

The only parallel axis is the ensemble member. On one device members are
the leading tensor axis; across devices the port runs one process a device
(`torch.distributed`), and a 1-D `DeviceMesh` over the process group's
ranks, named "ens", takes the place of JAX's 1-D `Mesh`. The DTensor
placements `Shard(axis)` and `Replicate()` take the place of
`NamedSharding` with `P("ens")` and `P()`.

`ens_mesh` joins the process group the caller set up
(`torch.distributed.init_process_group`, with its own address, world size
and rank); without one it makes a world of one over an in-memory store, so
a single process needs no set-up, as JAX's mesh of one device needs none.

A member-sharded tensor is a DTensor placed `Shard(0)` on the mesh: each
rank holds its N/world members. The analyses and EnOpt run on the ranks'
members (`local_members`); a sum over members is each rank's partial sum,
all-reduced over the group with `torch.distributed` (`reduce_members`,
`member_mean`); the few places that need every member gather them
(`gather_members`). Without a mesh the same functions are local: the
reduction is the partial sum itself, so one code path serves both, and on
a world of one it does the unsharded run's operations in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

ENS_AXIS = "ens"


def ens_mesh(n_devices=None, devices=None) -> DeviceMesh:
    """A 1-D mesh over the ensemble axis: one rank of the process group a
    device.

    `devices` is the device type ("cuda", the default, or "cpu"), or a
    sequence of torch devices, one a rank, whose type is taken (on CUDA,
    rank r then runs on `devices[r]`). `n_devices`, where given, must be
    the world size: every rank of the group takes part. Without a process
    group a world of one is made (NCCL on CUDA, gloo on the CPU)."""
    if devices is None or isinstance(devices, str):
        kind, per_rank = devices or "cuda", None
    else:
        per_rank = [torch.device(d) for d in devices]
        kind = per_rank[0].type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.HashStore(),
                                rank=0, world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"ens_mesh: n_devices={n_devices}, but the process group has {world} "
                         "ranks (one a device)")
    if kind == "cuda":
        torch.cuda.set_device(per_rank[rank] if per_rank else rank % torch.cuda.device_count())
    return init_device_mesh(kind, (world,), mesh_dim_names=(ENS_AXIS,))


def ens_spec(mesh=None):
    """The placements of a member-sharded tensor (JAX: `P("ens")`)."""
    return (Shard(0),)


def shard_ens(x, mesh, axis=0):
    """`x` (the same on every rank) as a DTensor on the mesh's devices with
    axis `axis` (the members) sharded over the ranks."""
    return distribute_tensor(torch.as_tensor(x), mesh, [Shard(axis)])


def replicate(x, mesh):
    """`x` as a DTensor replicated on every rank of the mesh."""
    return distribute_tensor(torch.as_tensor(x), mesh, [Replicate()])


def member_mesh(x):
    """The mesh of a member-sharded tensor (a DTensor placed `Shard(0)`),
    else None: a plain tensor is one every rank holds whole."""
    if isinstance(x, DTensor) and tuple(x.placements) == (Shard(0),):
        return x.device_mesh
    return None


def local_members(x, mesh):
    """This rank's members of `x`: the local shard of a member-sharded
    DTensor (another placement is redistributed first), or the rank's
    contiguous block of a tensor that every rank holds whole (as JAX's
    `shard_map` splits an unsharded input). Without a mesh, `x` whole."""
    if mesh is None:
        return whole(x)
    if isinstance(x, DTensor):
        if tuple(x.placements) != (Shard(0),):
            x = x.redistribute(mesh, [Shard(0)])
        return x.to_local()
    return x[member_rows(x.shape[0], mesh)]


def whole(x):
    """A tensor every rank holds whole: a DTensor gathered to its full
    value, anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def as_members(t, mesh, dim=0):
    """This rank's members `t` as the member-sharded DTensor they are part
    of, the members on axis `dim`; `t` itself without a mesh."""
    if mesh is None:
        return t
    return DTensor.from_local(t, mesh, [Shard(dim)], run_check=False)


def member_map(fn, x):
    """`fn` applied to the members of `x`: to each rank's own members of a
    member-sharded tensor, the result member-sharded; else to `x`."""
    mesh = member_mesh(x)
    return fn(x) if mesh is None else as_members(fn(x.to_local()), mesh)


def reduce_members(t, mesh):
    """A sum over members from each rank's partial sum `t`, all-reduced in
    place over the mesh's group; `t` as it is without a mesh."""
    if mesh is not None:
        dist.all_reduce(t, group=mesh.get_group())
    return t


def n_members(t, mesh):
    """The ensemble size of which `t` holds this rank's (equal) share."""
    return t.shape[0] * (1 if mesh is None else mesh.size())


def member_mean(t, mesh):
    """The mean over every rank's members of `t` (member axis first): the
    ranks' partial sums all-reduced, over N; the same operations with and
    without a mesh."""
    return reduce_members(t.sum(0), mesh) / n_members(t, mesh)


def member_rows(N, mesh):
    """This rank's block of member indices of an N-member ensemble, a
    slice (every member without a mesh)."""
    if mesh is None:
        return slice(None)
    if N % mesh.size():
        raise ValueError(f"N={N} not divisible by mesh size {mesh.size()}")
    k = N // mesh.size()
    r = mesh.get_local_rank()
    return slice(r * k, (r + 1) * k)


def gather_members(t, mesh):
    """Every rank's members of `t` (member axis first), all-gathered in rank
    order, so in member order; booleans travel as bytes. `t` itself
    without a mesh."""
    if mesh is None:
        return t
    u = t.to(torch.uint8) if t.dtype == torch.bool else t
    full = DTensor.from_local(u.contiguous(), mesh, [Shard(0)]).full_tensor()
    return full.bool() if t.dtype == torch.bool else full
