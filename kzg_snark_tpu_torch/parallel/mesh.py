"""Process meshes and the counted collectives of the multi-device layer.

Counterpart of ``kzg_snark_tpu/parallel/mesh.py``.  The JAX package runs
one process over a ``jax.sharding.Mesh`` of devices; here every rank is one
process driving one device, joined by ``torch.distributed``: NCCL between
GPUs, gloo on the CPU (gloo also takes CUDA tensors, so several ranks can
share one card, which NCCL refuses).  ``make_mesh`` gives a one-axis
``DeviceMesh`` named ("shard",) over the initialized process group.

``shard_axis`` and ``replicated`` have no counterpart: they build
``NamedSharding``s of a global array, and the port keeps no global array.
Each rank holds its own slice in the layouts of ``ntt_dist`` and
``msm_dist``, and what crosses ranks moves through the collectives below,
each counted by name and bytes (``utils/build.count_collective``) as the
kernels count their launches; those counts stand where the JAX package
parsed its compiled HLO.

Every entry point takes ``device_type="cuda"`` unless the caller names the
CPU; the backend is the caller's choice (NCCL for CUDA, gloo for the CPU,
when none is named), and nothing switches backend or device on failure.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.build import count_collective

AXIS = "shard"

# all_gather_into_tensor's newer name (torch 2.13 warns on the old one;
# the card's torch 2.11 has only the old one).
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def init_ranks(backend: str | None = None, init_method: str = "env://",
               world_size: int | None = None, rank: int | None = None,
               device_type: str = "cuda") -> None:
    """Join this process to the group as ``rank`` of ``world_size`` (with
    ``env://``, None reads ``RANK`` / ``WORLD_SIZE``).  On the card the
    rank drives ``cuda:rank % device_count``; the backend defaults to NCCL
    there and to gloo on the CPU."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    device = None
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    # NCCL binds its communicator to the rank's device up front.
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            device_id=device if backend == "nccl" else None)


def make_mesh(n_devices: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """One-axis mesh ("shard",) over the first ``n_devices`` ranks (all of
    them when None).  Every rank of the group calls it."""
    have = dist.get_world_size()
    n = have if n_devices is None else n_devices
    if have < n:
        raise ValueError(f"requested {n} devices, have {have}")
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(AXIS,))


def axis_group(mesh: DeviceMesh, axis=AXIS):
    """(group, size, this rank's index) of a mesh axis, or of a tuple of
    axes flattened major-first (("host", "chip"): the flat index is
    host * chips + chip).  A tuple must name every axis of a mesh that
    spans the whole group, so its group is the default one."""
    if isinstance(axis, str):
        dim = mesh.mesh_dim_names.index(axis)
        return mesh.get_group(axis), mesh.size(dim), \
            mesh.get_local_rank(axis)
    if tuple(axis) != tuple(mesh.mesh_dim_names):
        raise ValueError(f"axes {tuple(axis)} must be the mesh's "
                         f"{mesh.mesh_dim_names}, in order")
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError("a mesh flattened over several axes must span "
                         "the whole process group in rank order")
    return None, len(ranks), ranks.index(dist.get_rank())


def all_to_all(send: torch.Tensor, group=None) -> torch.Tensor:
    """send (D, ...): block e goes to rank e of the group; returns (D, ...)
    whose block e came from rank e.  Counts the (D - 1) / D of the buffer
    that leaves this rank."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    D = send.shape[0]
    count_collective("all_to_all",
                     send.numel() * send.element_size() * (D - 1) // D)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def all_gather(x: torch.Tensor, size: int, group=None) -> torch.Tensor:
    """x (...) from each of the group's ``size`` ranks -> (size, ...) in
    rank order, on every rank.  Counts the (size - 1) copies that reach
    this rank."""
    x = x.contiguous()
    out = torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    count_collective("all_gather", x.numel() * x.element_size() * (size - 1))
    _all_gather_single(out, x[None], group=group)
    return out
