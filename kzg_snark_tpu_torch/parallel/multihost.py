"""Two-axis meshes (host, chip) and the hierarchical MSM.

Counterpart of ``kzg_snark_tpu/parallel/multihost.py``.  A rank is one
process driving one device; a "host" is a group of ranks on one machine
(the ranks torchrun starts on one node), whose "chip" axis rides NVLink
within the machine while the "host" axis crosses the network.  Reductions
run hierarchically: the chip group first, then the few surviving bytes
cross hosts.

``initialize_multihost`` wraps ``init_process_group`` at
``tcp://coordinator``; with no arguments it reads torchrun's variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the
counterpart of JAX's auto-detection on pods.  ``flat_spec`` has no
counterpart: it named a ``PartitionSpec`` over both axes, and the port
shards by hand (``ntt_dist`` takes ``axis=(HOST_AXIS, CHIP_AXIS)``, the
flat rank host-major).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import cuda_fr
from ..ops.msm import msm_context
from .mesh import all_gather, axis_group, init_ranks

HOST_AXIS = "host"
CHIP_AXIS = "chip"


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         device_type: str = "cuda") -> None:
    """Join the group at ``tcp://coordinator`` ("address:port") as rank
    ``process_id`` of ``num_processes``; each None is read from torchrun's
    variables.  ``backend`` and ``device_type`` as ``init_ranks``."""
    env = os.environ
    if coordinator is None:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    init_ranks(backend, f"tcp://{coordinator}", num_processes, process_id,
               device_type)


def make_mesh2(num_hosts: int | None = None,
               chips_per_host: int | None = None,
               device_type: str = "cuda") -> DeviceMesh:
    """Two-axis mesh (host, chip) over ranks 0 .. hosts * chips - 1, host
    major.  Defaults: chips from torchrun's ``LOCAL_WORLD_SIZE`` (else the
    ranks left per host), hosts from what remains."""
    world = dist.get_world_size()
    if chips_per_host is None:
        chips_per_host = int(os.environ.get(
            "LOCAL_WORLD_SIZE", world // (num_hosts or 1)))
    if num_hosts is None:
        num_hosts = world // chips_per_host
    if num_hosts * chips_per_host > world:
        raise ValueError(f"requested {num_hosts} x {chips_per_host} "
                         f"devices, have {world}")
    grid = torch.arange(num_hosts * chips_per_host).reshape(num_hosts,
                                                            chips_per_host)
    return DeviceMesh(device_type, grid, mesh_dim_names=(HOST_AXIS,
                                                         CHIP_AXIS))


def _ladder_sum(curve, points: torch.Tensor, scalars: torch.Tensor
                ) -> torch.Tensor:
    """sum_i s_i P_i by ``g1_ladder`` launches of at most ``LADDER_POINTS``
    points, their results added by the complete-add tree."""
    fc, step = curve.f.consts, cuda_fr.LADDER_POINTS
    parts = [cuda_fr.g1_ladder(fc, points[..., a:a + step].contiguous(),
                               scalars[None, :, a:a + step].contiguous())
             for a in range(0, points.shape[-1], step)]
    return curve.tree_sum(torch.cat(parts, dim=-1))


def msm_multihost(mesh: DeviceMesh, points: torch.Tensor,
                  scalars: torch.Tensor, curve_type: str = "bn254",
                  impl: str = "fused", device="cuda") -> torch.Tensor:
    """sum_i s_i P_i with the points split over (host, chip): each rank's
    contiguous shard (flat rank host-major), then the hierarchical
    combine: all_gather over the chip group and a fold, all_gather of the
    host partials over the host group and a fold (one point a host crosses
    hosts).  Folds on the complete ``g1_add`` (K6); the result (3, L, 1) is
    the same on every rank.

    points (3, L, N) with Z = 1, scalars (8, N) canonical, N a multiple of
    the mesh's ranks.  The JAX precondition N = 1024 k x ranks came from
    its fused kernel's lane tiling; the port's MSM takes any shard size.
    ``impl``: "fused" runs the port's single-device MSM on the shard (its
    route by the shard's size: the bucket kernels from 2048 points);
    "small" the bit-serial ladder (``g1_ladder``, 256 points a launch)."""
    if impl not in ("fused", "small"):
        raise ValueError(f"impl {impl!r}: 'fused' or 'small'")
    ctx = msm_context(curve_type, device)
    curve = ctx.curve
    H, C = mesh.mesh.shape
    N = points.shape[-1]
    if N % (H * C):
        raise ValueError(f"N = {N} is not a multiple of the mesh's "
                         f"{H * C} ranks")
    chip_group, _, chip = axis_group(mesh, CHIP_AXIS)
    host_group, _, host = axis_group(mesh, HOST_AXIS)
    s = N // (H * C)
    a = (host * C + chip) * s
    pts, sc = points[..., a:a + s].contiguous(), \
        scalars[:, a:a + s].contiguous()
    part = ctx.msm(pts, sc) if impl == "fused" else \
        _ladder_sum(curve, pts, sc)
    chip_parts = all_gather(part[..., 0], C, chip_group)        # (C, 3, L)
    acc = curve.tree_sum(chip_parts.permute(1, 2, 0))
    host_parts = all_gather(acc[..., 0], H, host_group)         # (H, 3, L)
    return curve.tree_sum(host_parts.permute(1, 2, 0))
