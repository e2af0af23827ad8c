"""The process group and the port's "mesh" (counterpart of the
`jax.sharding.Mesh` objects of isogs_slam_tpu/parallel/).

One process per rank, launched by `python -m torch.distributed.run`; every
rank holds one identical copy of the replicated state. A `Mesh` names the
ranks that hold a shard of a sharded program: ranks 0 .. size - 1 of the
world. The world may be larger than the mesh; a rank outside it holds no
shard and adds zeros to every collective, so the collectives always run
over the whole world and every rank ends with the same result.

The device count is the world size: a knob that asks for more shards than
there are ranks is clamped to the world size by the caller. At world size 1
(no process group) every collective is the identity, so the sharded
programs run unchanged on one rank.

Backend: NCCL when each rank has a card of its own; gloo when ranks share
a card or run on the CPU. Tensors stay on each rank's device either way
(gloo takes CUDA tensors for all_reduce and broadcast). All-gather is built
as an all_reduce of a zero-padded [size, ...] buffer, which is exact, on
every backend but NCCL.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import resolve_device


class Mesh(NamedTuple):
    group: object | None    # the process group (None at world size 1)
    rank: int               # this process's rank in the world
    size: int               # ranks that hold a shard (<= world)
    world: int              # ranks in the world
    device: torch.device    # this rank's device
    backend: str | None     # "nccl", "gloo" or None at world size 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    """Rank 0 alone writes files and progress lines."""
    return world_rank() == 0


def _launch_env() -> tuple[int, int, int, int]:
    """(rank, world, local rank, local world) that torch.distributed.run
    sets; (0, 1, 0, 1) outside it."""
    e = os.environ
    return (int(e.get("RANK", 0)), int(e.get("WORLD_SIZE", 1)),
            int(e.get("LOCAL_RANK", 0)), int(e.get("LOCAL_WORLD_SIZE", 1)))


def rank_device(device) -> torch.device:
    """This rank's device: its own card when there is one card per local
    rank, else the shared card (or the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    _, _, local, _ = _launch_env()
    if dev.index is not None and world_size() == 1:
        return dev
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def pick_backend(device) -> str:
    """NCCL when every local rank has a card of its own, else gloo."""
    dev = torch.device(device)
    _, _, _, local_world = _launch_env()
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def init_distributed(device="cuda") -> torch.device:
    """Join the process group that torch.distributed.run describes (its
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT), once; return this
    rank's device. Outside torch.distributed.run (WORLD_SIZE unset or 1)
    nothing is initialised and `device` is returned. Prints the backend
    and the rank's device."""
    rank, world, _, _ = _launch_env()
    dev = torch.device(device)
    if world <= 1:
        return dev
    if not is_initialized():
        backend = pick_backend(dev)
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        dev = rank_device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank)
    dev = rank_device(dev)
    print(f"[parallel] rank {rank} of {world} on {dev} "
          f"(backend {dist.get_backend()})", flush=True)
    return dev


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of the first n_devices ranks (all of them by default) with
    this rank's device; n_devices is clamped to the world size by the
    caller, as the reference clamps to its devices. The card unless the
    caller asks for "cpu": without a card it raises (resolve_device)."""
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks asked for, the world has "
                         f"{world}")
    device = resolve_device(device)
    dev = rank_device(device) if world > 1 else device
    return Mesh(group=dist.group.WORLD if world > 1 else None,
                rank=world_rank(), size=n, world=world, device=dev,
                backend=dist.get_backend() if world > 1 else None)


def shard_range(n: int, mesh: Mesh) -> tuple[int, int, int]:
    """(lo, hi, per): this rank's contiguous range of an axis of n items
    padded to a multiple of the mesh size (per items a shard); empty for a
    rank outside the mesh. hi may pass n: those items are padding."""
    per = -(-n // mesh.size)
    if mesh.rank >= mesh.size:
        return 0, 0, per
    return mesh.rank * per, (mesh.rank + 1) * per, per


def all_reduce_(t: torch.Tensor, mesh: Mesh, op: str = "sum"):
    """In-place all_reduce over the world ("sum" or "max")."""
    if mesh.world > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=mesh.group)
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0):
    if mesh.world > 1:
        dist.broadcast(t, src=src, group=mesh.group)
    return t


def all_gather_shards(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Concatenate each mesh rank's shard x [per, ...] along dim 0 ->
    [size * per, ...] on every rank (a rank outside the mesh passes any
    x of the same shape; it is not part of the result)."""
    if mesh.world == 1:
        return x
    x = x.contiguous()
    if mesh.backend == "nccl" and mesh.size == mesh.world:
        out = x.new_empty((mesh.world * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out
    buf = x.new_zeros((mesh.size,) + x.shape)
    if mesh.rank < mesh.size:
        buf[mesh.rank] = x
    if buf.dtype == torch.bool:
        buf = buf.to(torch.uint8)
        dist.all_reduce(buf, group=mesh.group)
        return buf.to(torch.bool).reshape((-1,) + x.shape[1:])
    dist.all_reduce(buf, group=mesh.group)
    return buf.reshape((-1,) + x.shape[1:])


class _AllGatherShards(torch.autograd.Function):
    """all_gather_shards whose backward hands each rank the slice of the
    cotangent that its shard produced (the downstream computation is
    replicated, so every rank holds the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.per = x.shape[0]
        return all_gather_shards(x, mesh)

    @staticmethod
    def backward(ctx, g):
        m, per = ctx.mesh, ctx.per
        if m.rank >= m.size:
            return g.new_zeros((per,) + g.shape[1:]), None
        return g[m.rank * per: (m.rank + 1) * per], None


def all_gather_shards_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _AllGatherShards.apply(x, mesh)


class _ReplicatedInputs(torch.autograd.Function):
    """Identity on replicated tensors that sharded work reads; the
    backward all-reduces the per-rank partial cotangents, packed into one
    collective (the psum that reverse-mode differentiation of a shard_map
    inserts for a replicated input)."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([
            (g if g is not None else torch.zeros(s, device=ctx.mesh.device)
             ).reshape(-1).to(torch.float32)
            for g, s in zip(gs, ctx.shapes)])
        all_reduce_(flat, ctx.mesh)
        out, o = [], 0
        for s in ctx.shapes:
            n = int(torch.Size(s).numel())
            out.append(flat[o:o + n].reshape(s))
            o += n
        return (None, *out)


def replicated_inputs(tensors, mesh: Mesh) -> tuple:
    """Mark replicated tensors read by sharded work: their gradients are
    summed over the ranks in the backward (one all_reduce for all)."""
    return _ReplicatedInputs.apply(mesh, *tensors)


def gather_object(obj, mesh: Mesh) -> list:
    """[each rank's obj] (picklable host objects) on every rank."""
    if mesh.world == 1:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def replica_max_diff(tensors, mesh: Mesh) -> float:
    """max over ranks and tensors of |t - rank 0's t| (booleans and
    integers as floats): 0.0 when every rank holds rank 0's copy bit for
    bit (NaNs compare by position)."""
    if mesh.world == 1:
        return 0.0
    worst = torch.zeros((), dtype=torch.float64, device=mesh.device)
    for t in tensors:
        t = torch.as_tensor(t).to(mesh.device)
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        ref = t.clone()
        broadcast_(ref, mesh)
        a, b = t.to(torch.float64), ref.to(torch.float64)
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        d = torch.where(nan_a | nan_b,
                        (nan_a != nan_b).to(torch.float64),
                        (a - b).abs())
        if d.numel():
            worst = torch.maximum(worst, d.max())
    all_reduce_(worst, mesh, op="max")
    return float(worst)


def barrier():
    if is_initialized():
        dist.barrier()


def shutdown():
    """Leave the process group (after a last barrier)."""
    if is_initialized():
        dist.barrier()
        dist.destroy_process_group()
