"""Distributed MSM: the points split across ranks, each rank's partial sum
combined by an ``all_gather`` and a fold.

Counterpart of ``kzg_snark_tpu/parallel/msm_dist.py``.  Every rank holds the
global (3, L, N) points and (8, N) scalars and takes its contiguous shard of
N / D (the JAX package splits the MSM's lanes; the contract is the same
affine point, not its lane order).  Each rank runs the port's
single-device MSM on its shard, so the route follows the shard's size as
``MsmContext.msm`` chooses it (``g1_ladder`` up to 256 points, K9 / K6
below 2048, ``msm_accumulate`` + ``msm_reduce`` from 2048).  Only the
(3, L, 1) partials cross ranks: one ``all_gather``, then
``CurveOps.tree_sum`` on the complete ``g1_add`` (K6), since a partial may
be the identity.  The result is the same on every rank.

N is padded to a multiple of D with the generator and zero scalars, as the
JAX ``msm`` pads: zero digits are dropped from the bucket schedule, so the
repeated generator is sound under the incomplete add.  The JAX
``window_bits`` has no counterpart: the port's routes choose their own
windows (the bucket route's table by the shard's size, the scan route's 8
bits), as its ``MsmContext`` does.  Both curves: BLS12-381 at 12-word Fq.
"""

from __future__ import annotations

import torch

from ..ops import cuda_fr
from ..ops.msm import msm_context
from ..utils.build import COLLECTIVES
from .mesh import AXIS, all_gather, axis_group


class DistMsmContext:
    """MSM over the D ranks of the mesh's "shard" axis; every rank calls
    each method together with the same global inputs."""

    def __init__(self, curve_type: str, mesh, device="cuda"):
        self.base = msm_context(curve_type, device)
        self.curve = self.base.curve
        self.mesh = mesh
        self.group, self.D, self.index = axis_group(mesh, AXIS)
        self.issued: dict | None = None   # collectives of the last call

    def _pad(self, points, scalars, multiple: int):
        """Generator points and zero scalars up to a multiple of
        ``multiple``."""
        pad = -points.shape[-1] % multiple
        if pad:
            gen = self.base._gen
            points = torch.cat([points, gen.expand(3, gen.shape[1], pad)],
                               dim=-1)
            scalars = torch.cat([scalars, scalars.new_zeros(
                (scalars.shape[0], pad))], dim=-1)
        return points, scalars

    def _fold(self, part: torch.Tensor) -> torch.Tensor:
        """This rank's (3, L, 1) partial -> the sum over the axis, on every
        rank: all_gather, then the complete-add tree."""
        parts = all_gather(part[..., 0], self.D, self.group)   # (D, 3, L)
        return self.curve.tree_sum(parts.permute(1, 2, 0))

    def _shard(self, points, scalars, lo: int, width: int):
        """This rank's contiguous shard of the columns lo .. lo + width."""
        s = width // self.D
        a = lo + self.index * s
        return points[..., a:a + s].contiguous(), \
            scalars[:, a:a + s].contiguous()

    def msm(self, points: torch.Tensor, scalars: torch.Tensor,
            complete: bool | None = None) -> torch.Tensor:
        """sum_i scalars[i] points[i] over the axis -> (3, L, 1).

        points (3, L, N) with Z = 1, scalars (8, N) canonical limbs, as
        ``MsmContext.msm`` takes them (``complete`` likewise)."""
        before = COLLECTIVES.copy()
        points, scalars = self._pad(points, scalars, self.D)
        pts, sc = self._shard(points, scalars, 0, points.shape[-1])
        out = self._fold(self.base.msm(pts, sc, complete))
        self.issued = dict(COLLECTIVES - before)
        return out

    def default_chunk(self, n: int) -> int:
        """Global width of one ``msm_small`` step: at most
        ``LADDER_POINTS`` points a rank."""
        return min(-(-n // self.D) * self.D, self.D * cuda_fr.LADDER_POINTS)

    def msm_small(self, points: torch.Tensor, scalars: torch.Tensor,
                  chunk: int | None = None) -> torch.Tensor:
        """The bit-serial distributed MSM (the JAX ``msm_small``): steps of
        ``chunk`` global points, a rank's shard of each one ``g1_ladder``
        launch folded over the axis (one all_gather a step), the steps'
        sums added by the complete-add tree."""
        before = COLLECTIVES.copy()
        chunk = self.default_chunk(points.shape[-1]) if chunk is None \
            else chunk
        if chunk % self.D or chunk // self.D > cuda_fr.LADDER_POINTS:
            raise ValueError(f"chunk {chunk}: a multiple of the {self.D} "
                             f"ranks of at most {cuda_fr.LADDER_POINTS} "
                             f"points a rank")
        points, scalars = self._pad(points, scalars, chunk)
        fc = self.curve.f.consts
        steps = []
        for lo in range(0, points.shape[-1], chunk):
            pts, sc = self._shard(points, scalars, lo, chunk)
            steps.append(self._fold(cuda_fr.g1_ladder(fc, pts, sc[None])))
        out = self.curve.tree_sum(torch.cat(steps, dim=-1))
        self.issued = dict(COLLECTIVES - before)
        return self.curve.checked_output(out, "msm_small")

    def collective_stats(self, n: int, chunk: int | None = None) -> dict:
        """The JAX ``collective_stats`` keys but its HLO count: the
        collectives this rank's last ``msm`` or ``msm_small`` issued
        ("collectives_issued", None before the first), and the analytic
        bytes of an ``msm_small`` of n points at the curve's limb count
        (8 words at BN254, 12 at BLS12-381): one Jacobian partial a step
        from each other rank.  The JAX ``nbits`` only sized the program it
        compiled; the bytes never depended on it."""
        L = self.curve.num_limbs
        chunk = self.default_chunk(n) if chunk is None else chunk
        partial_bytes = 3 * L * 4
        return {
            "n": n, "devices": self.D, "chunk": chunk,
            "collectives_issued": self.issued,
            "bytes_local_points_per_device": 3 * L * 4 * (n // self.D),
            "bytes_cross_mesh_per_device_per_msm":
                -(-n // chunk) * (self.D - 1) * partial_bytes,
            "single_device_cross_bytes": 0,
        }
