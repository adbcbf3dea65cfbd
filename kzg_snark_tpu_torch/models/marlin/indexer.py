"""Marlin indexer: preprocessing into (ipk, ivk).

Behavioral equivalent of ``marlin/indexer.py``: KZG setup,
star-matrix construction M* = M^T with column i scaled by u_H(H[i], H[i])
(:47-54), re-encoding over the star matrices, committing the nine
row/col/val polynomials in fixed A,B,C x row,col,val order (:66-83), and the
ipk/ivk dict layouts (:86-121).
"""

from __future__ import annotations

from ...rng import Rng
from ..kzg import KZG
from .encoder import Encoder


class Indexer:
    def __init__(self, curve_type: str = "bn254", backend: str = "host",
                 rng: Rng | None = None):
        self.kzg = KZG(curve_type=curve_type, backend=backend, rng=rng)
        self.encoder = Encoder(self.kzg.Fq)

    def preprocess(self, A, B, C, max_degree: int, tau: int | None = None):
        ck, rk = self.kzg.setup(max_degree, tau=tau)

        self.encoder.update_state(A, B, C)

        # Star matrices: M* = M^T with column i scaled by u_H(H[i], H[i])
        # (reference marlin/indexer.py:47-54).
        A_star, B_star, C_star = A.T, B.T, C.T
        for i in range(A.ncols()):
            u = self.encoder.u_H(self.encoder.H[i], self.encoder.H[i])
            A_star.scale_column(i, u)
            B_star.scale_column(i, u)
            C_star.scale_column(i, u)
        self.encoder.update_state(A_star, B_star, C_star)

        encoded_matrices = self.encoder.encode_matrices()

        indexer_polys = {}
        indexer_polys_list = []
        for matrix in ["A", "B", "C"]:
            for poly_type in ["row", "col", "val"]:
                key = f"{poly_type}_{matrix}"
                indexer_polys[key] = encoded_matrices[key]
                indexer_polys_list.append(encoded_matrices[key])

        index_commitments = self.kzg.commit(ck, indexer_polys_list)
        commitments = {}
        i = 0
        for matrix in ["A", "B", "C"]:
            for poly_type in ["row", "col", "val"]:
                commitments[f"{poly_type}_{matrix}"] = index_commitments[i]
                i += 1

        ipk = {
            "ck": ck,
            "A": A, "B": B, "C": C,
            "polynomials": indexer_polys,
            "commitments": commitments,
            "subgroups": {
                "H": self.encoder.H,
                "K": self.encoder.K,
                "g_H": self.encoder.g_H,
                "g_K": self.encoder.g_K,
                "n": self.encoder.n,
                "m": self.encoder.m,
            },
            "vanishing_polys": {
                "v_H": self.encoder.v_H,
                "v_K": self.encoder.v_K,
            },
        }
        ivk = {
            "rk": rk,
            "commitments": commitments,
            "subgroups": {
                "n": self.encoder.n,
                "m": self.encoder.m,
                "g_H": self.encoder.g_H,
            },
            "vanishing_polys": {
                "v_H": self.encoder.v_H,
                "v_K": self.encoder.v_K,
            },
        }
        return ipk, ivk
