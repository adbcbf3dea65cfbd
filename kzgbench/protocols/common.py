"""Set-up shared by the protocols: the SRS, the port's contexts, the pool."""

from __future__ import annotations

import numpy as np
import torch

from kzg_snark_tpu_torch.models.kzg import KZG
from kzg_snark_tpu_torch.models.plonk.device import PlonkDeviceCore
from kzg_snark_tpu_torch.ops.msm import msm_context
from kzg_snark_tpu_torch.ops.ntt import ntt_context

from ..generator import make_pool
from ..plain.curves import CURVES


class PortCell:
    """One configuration on the port: the device SRS of n points from
    ``KZG(backend="cuda").setup``, the MSM, NTT and opening contexts, and
    the pool of input batches, each (8, batch, n) canonical Fr words."""

    def __init__(self, config: dict, traffic: dict, seed: int, tau: int,
                 device: torch.device, span):
        self.curve = CURVES[config["curve"]]
        self.n = n = config["n"]
        self.batch = traffic["batch"]
        self.span = span
        self.kzg = KZG(config["curve"], backend="cuda", device=device)
        self.srs, _ = self.kzg.setup(n - 1, tau=tau)
        self.ctx = msm_context(config["curve"], device)
        self.be = self.ctx.scalar_backend
        self.ntt = ntt_context(config["curve"], n, device)
        self.core = PlonkDeviceCore(config["curve"], n, device)
        self.points = self.srs.points                     # (3, L, n)
        self.pool = make_pool(self.curve.r, n, self.batch,
                              traffic["pool_batches"], seed, device)

    def pool_words(self, slot: int) -> np.ndarray:
        """The inputs of pool batch ``slot`` as (8, batch, n) uint32."""
        return self.pool[slot].cpu().numpy().view(np.uint32)

    def coefficients(self, slot: int) -> torch.Tensor:
        """iNTT of the batch's values: (8, batch, n) Montgomery."""
        words = self.pool[slot]
        with self.span("intt"):
            mont = self.be.to_mont(words.reshape(8, -1)).reshape(words.shape)
            return self.ntt.intt(mont)

    def commit(self, coeffs: torch.Tensor, count: int, name: str) -> list:
        """Commitments of (8, k, m) Montgomery coefficient rows against the
        first m SRS points, in one k-set MSM -> affine int pairs."""
        with self.span(name):
            canon = self.be.from_mont(coeffs.reshape(8, -1))
            scalars = canon.reshape(coeffs.shape).transpose(0, 1).contiguous()
            pts = self.ctx.msm(self.points[..., :coeffs.shape[-1]], scalars)
            out = self.ctx.curve.to_affine_ints(pts)
        assert len(out) == count
        return out
