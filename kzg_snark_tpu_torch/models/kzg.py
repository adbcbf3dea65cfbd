"""KZG with a "cuda" backend: SRS and commitments on the device.

Subclass of the JAX package's host ``KZG`` (which has no JAX import): open,
check and batch_check are inherited and run on the host; ``setup`` builds
the G1 powers with ``ops/srs.setup_g1_powers`` and ``commit`` runs the
bucket MSM against the device SRS.  Commitments are always normalized to
(x, y, 1), so transcripts hash the same bytes as the host backend with
``normalize_commitments=True``.
"""

from __future__ import annotations

from kzg_snark_tpu.models.kzg import KZG as HostKZG

from ..ops import msm as msm_mod
from ..ops.fr import canonical_device
from ..ops.srs import setup_g1_powers


class KZG(HostKZG):
    def __init__(self, curve_type: str = "bn254", rng=None, device="cuda"):
        super().__init__(curve_type=curve_type, backend="cuda", rng=rng,
                         normalize_commitments=True)
        self.device = canonical_device(device)

    def setup(self, max_degree: int, tau: int | None = None):
        """ck = DeviceSRS [G1, ..., tau^d G1], rk = tau G2."""
        if tau is None:
            tau = int(self.rng.random_element(self.Fq))
        tau = tau % self.curve_order
        ck = setup_g1_powers(self, tau, max_degree, device=self.device)
        return ck, self.multiply(self.G2, tau)

    def commit(self, ck, polynomials):
        max_degree = len(ck) - 1
        out = []
        for poly in self._as_polys(polynomials):
            if poly.degree() > max_degree:
                raise ValueError(
                    f"Polynomial degree {poly.degree()} exceeds maximum "
                    f"allowed degree {max_degree}")
            out.append(msm_mod.commit(self, ck, poly))
        return out
