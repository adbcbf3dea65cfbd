"""PLONK indexer: preprocessing into (ipk, ivk).

Behavioral equivalent of ``plonk/indexer.py``: KZG setup
(:43), selector + permutation encoding (:46-50), commitment to the eight
index polynomials in fixed qM,qL,qR,qO,qC,S_sigma1,S_sigma2,S_sigma3 order
(:64-89), and the ipk/ivk dict layouts (:92-118).
"""

from __future__ import annotations

from ...rng import Rng
from ..kzg import KZG
from .encoder import Encoder

POLY_ORDER = ["qM", "qL", "qR", "qO", "qC", "S_sigma1", "S_sigma2", "S_sigma3"]


class Indexer:
    def __init__(self, curve_type: str = "bn254", backend: str = "host",
                 rng: Rng | None = None):
        self.kzg = KZG(curve_type=curve_type, backend=backend, rng=rng)
        self.encoder = Encoder(self.kzg.Fq, rng=self.kzg.rng)

    def preprocess(self, qM, qL, qR, qO, qC, perm, max_degree: int,
                   tau: int | None = None):
        ck, rk = self.kzg.setup(max_degree, tau=tau)

        self.encoder.update_state(qM, qL, qR, qO, qC, perm)
        selector_polys = self.encoder.encode_selectors()
        permutation_polys = self.encoder.encode_permutation()

        indexer_polys = {
            name: selector_polys[name] if name in selector_polys
            else permutation_polys[name]
            for name in POLY_ORDER
        }
        poly_list = [indexer_polys[name] for name in POLY_ORDER]
        commitments_list = self.kzg.commit(ck, poly_list)
        indexer_commitments = dict(zip(POLY_ORDER, commitments_list))

        ipk = {
            "ck": ck,
            "polynomials": indexer_polys,
            "commitments": indexer_commitments,
            "subgroups": {
                "H": self.encoder.H,
                "n": self.encoder.n,
                "g": self.encoder.g,
                "k1": self.encoder.k1,
                "k2": self.encoder.k2,
            },
            "vanishing_poly": self.encoder.v_H,
            "sigma_star": permutation_polys["sigma_star"],
        }
        ivk = {
            "rk": rk,
            "commitments": indexer_commitments,
            "subgroups": {
                "n": self.encoder.n,
                "g": self.encoder.g,
                "k1": self.encoder.k1,
                "k2": self.encoder.k2,
            },
        }
        return ipk, ivk
