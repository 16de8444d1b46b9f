"""Device meshes over ``torch.distributed``: the world, the meshes over its
ranks, and the move between global tensors and each rank's block (the
torch form of a JAX ``Mesh`` with ``NamedSharding`` / ``shard_map``
in_specs and out_specs).

A mesh holds one rank a device: NCCL on ``"cuda"`` (each rank on its
own card), gloo on ``"cpu"``. A global tensor is the same on every rank
(a JAX host array), and each rank takes its block without a collective;
an output block becomes a ``DTensor`` whose placements name the mesh
dimensions it is sharded over. ``torch.distributed`` is imported where a
mesh is used, never when this module is imported.
"""

from __future__ import annotations

import math
import os

import torch

DEVICES = {"cuda": "nccl", "cpu": "gloo"}


def world_size(device: str) -> int:
    """The number of ranks. A process group not yet initialised is set up
    from the environment (``torchrun`` sets MASTER_ADDR, MASTER_PORT, RANK
    and WORLD_SIZE): NCCL for ``"cuda"``, gloo for ``"cpu"``. On
    ``"cuda"`` each rank takes its own card, LOCAL_RANK (else the rank
    modulo the cards)."""
    import torch.distributed as dist

    if device not in DEVICES:
        raise ValueError(f"device must be one of {sorted(DEVICES)}; got "
                         f"{device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA card; pass device='cpu' "
                           "for a gloo mesh on the CPU")
    if not dist.is_initialized():
        if device == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(DEVICES[device])
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return dist.get_world_size()


def make_mesh(device: str, shape: tuple, names: tuple):
    """A mesh of ``shape`` over the world's first prod(shape) ranks, in
    rank order; every rank of the world must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    world = world_size(device)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh= takes a torch.distributed DeviceMesh (parallel."
            f"ensemble_mesh, parallel.mesh_2d); got {type(mesh).__name__}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")


def mesh_dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: "
                         f"{names})")
    return names.index(axis)


def _placements(mesh, dims: dict):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dims[m]) if m in dims else Replicate()
            for m in range(mesh.ndim)]


def take(x, mesh, dims: dict):
    """This rank's block of ``x``, sharded as ``dims`` ({mesh dim: tensor
    dim}) says and replicated over the other mesh dims: a DTensor laid out
    so gives its local tensor, a global tensor its contiguous block (a
    view). Anything else (a python number, None) passes through. A tensor
    on another device than the rank's (another type than the mesh's,
    another card than the current one) raises: nothing is staged."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, torch.Tensor):
        return x
    if x.device.type != mesh.device_type or (
            x.is_cuda and x.device.index != torch.cuda.current_device()):
        raise ValueError(
            f"a tensor on {x.device} on a {mesh.device_type} mesh whose rank "
            f"runs on its own device: put the inputs there (no staging)")
    if isinstance(x, DTensor):
        if (x.device_mesh != mesh
                or list(x.placements) != _placements(mesh, dims)):
            raise ValueError(
                f"a DTensor placed {tuple(x.placements)} on another layout "
                f"than {tuple(_placements(mesh, dims))} over this mesh")
        return x.to_local()
    coord = mesh.get_coordinate()
    for m, d in dims.items():
        n = mesh.size(m)
        if x.shape[d] % n:
            raise ValueError(f"size {x.shape[d]} of dim {d} must divide "
                             f"the mesh's {n} shards")
        rows = x.shape[d] // n
        x = x.narrow(d, coord[m] * rows, rows)
    return x


def shard(local: torch.Tensor, mesh, dims: dict):
    """The DTensor of this rank's block ``local``: sharded over the mesh
    dims as ``dims`` ({mesh dim: tensor dim}) says, replicated over the
    others; no collective (every rank's block has the same shape)."""
    from torch.distributed.tensor import DTensor

    shape = list(local.shape)
    for m, d in dims.items():
        shape[d] *= mesh.size(m)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local.contiguous(), mesh,
                              _placements(mesh, dims), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def full(x):
    """The global view of a DTensor (a collective on every rank of its
    mesh); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x
