"""Marlin R1CS encoder: arithmetization into polynomial form.

Behavioral equivalent of ``marlin/encoder.py`` (class
Encoder): domain construction (:36-55), the u_H bivariate helper (:69-85),
matrix encoding into row/col/val polynomials over K (:87-132), witness
encoding with the v_H_x quotient optimization (:134-189), and zA/zB/zC
linear-combination encoding (:191-234).

Domains are generated deterministically (g = gen^((r-1)/n)) instead of
Sage's implementation-defined ``nth_root``; see
``ops.host.field.FieldElement.nth_root_of_unity``.
"""

from __future__ import annotations

from ...ops.host.fft import fft_interpolation
from ...ops.host.field import FieldElement, scalar_field
from ...ops.host.poly import Poly


class Encoder:
    def __init__(self, q: int | type[FieldElement]):
        if isinstance(q, int):
            # accept the raw modulus like the reference (encoder.py:14-23)
            from ...ops.host.field import prime_field
            from ... import constants as C
            if q == C.BN254_R:
                self.Fq = scalar_field("bn254")
            elif q == C.BLS12_381_R:
                self.Fq = scalar_field("bls12_381")
            else:
                self.Fq = prime_field(q, 0, 0, "F")
        else:
            self.Fq = q
        self.X = Poly.x(self.Fq)

    # ------------------------------------------------------------------
    def update_state(self, A, B, C) -> None:
        """Domain sizes, generators, subgroups, vanishing polynomials
        (reference marlin/encoder.py:25-55)."""
        self.A, self.B, self.C = A, B, C
        self.n = self.find_subgroup_size(max(A.nrows(), A.ncols()))
        self.m = self.find_subgroup_size(max(
            len(A.nonzero_positions()),
            len(B.nonzero_positions()),
            len(C.nonzero_positions()),
        ))
        self.g_H = self.Fq.nth_root_of_unity(self.n)
        self.g_K = self.Fq.nth_root_of_unity(self.m)
        self.H = [self.g_H ** i for i in range(self.n)]
        self.K = [self.g_K ** i for i in range(self.m)]
        self.v_H = Poly.vanishing(self.Fq, self.n)
        self.v_K = Poly.vanishing(self.Fq, self.m)

    @staticmethod
    def find_subgroup_size(n: int) -> int:
        """Smallest power of two >= n (reference marlin/encoder.py:57-67)."""
        return 2 ** ((n - 1).bit_length())

    # ------------------------------------------------------------------
    def u_H(self, a, b):
        """u_H(a, b) = (v_H(a) - v_H(b)) / (a - b), with the formal
        derivative at a == b (reference marlin/encoder.py:69-85).

        v_H = X^n - 1, so the derivative at a is n a^(n-1) (= n / a for a
        in H), in O(log n) products instead of a dense degree-n Horner."""
        if a == b:
            return self.Fq(self.n) * a ** (self.n - 1)
        return (self.v_H(a) - self.v_H(b)) / (a - b)

    def u_H_poly(self, alpha) -> Poly:
        """u_H(alpha, X) as a polynomial in X:
        (alpha^n - X^n)/(alpha - X) = sum_i alpha^(n-1-i) X^i.

        The reference evaluates the same expression through Sage fraction
        coercion (marlin/prover.py:127-130); here the closed form is built
        directly — an O(n) loop instead of a polynomial division.
        """
        alpha = self.Fq(int(alpha)) if not isinstance(alpha, FieldElement) else alpha
        coeffs = [alpha ** (self.n - 1 - i) for i in range(self.n)]
        return Poly(self.Fq, coeffs)

    # ------------------------------------------------------------------
    def encode_matrices(self) -> dict:
        """row/col/val polynomials per matrix over K, with values divided by
        u_H diagonal factors (reference marlin/encoder.py:87-132)."""
        u_H_diag = {h: self.u_H(h, h) for h in self.H}
        encoded = {}
        for name, M in [("A", self.A), ("B", self.B), ("C", self.C)]:
            nonzero_positions = list(M.nonzero_positions())
            row_values = [self.Fq(0)] * self.m
            col_values = [self.Fq(0)] * self.m
            val_values = [self.Fq(0)] * self.m
            for k, (i, j) in enumerate(nonzero_positions):
                row_values[k] = self.H[i]
                col_values[k] = self.H[j]
                val_values[k] = self.Fq(int(M[i, j])) / (
                    u_H_diag[self.H[i]] * u_H_diag[self.H[j]]
                )
            encoded[f"row_{name}"] = fft_interpolation(row_values, self.g_K)
            encoded[f"col_{name}"] = fft_interpolation(col_values, self.g_K)
            encoded[f"val_{name}"] = fft_interpolation(val_values, self.g_K)
        return encoded

    # ------------------------------------------------------------------
    def encode_witness(self, z, x_size: int) -> dict:
        """Split z into (x, w); interpolate x over H[:x_size]; encode w as
        w_poly = (interp(values) ) // v_H_x with exactness assert; rebuild
        z_poly = w_poly * v_H_x + x_poly (reference marlin/encoder.py:134-189)."""
        z = [self.Fq(int(zi)) for zi in z]
        x, w = z[:x_size], z[x_size:]

        x_points = [(self.H[i], x[i]) for i in range(len(x))]
        x_poly = Poly.lagrange(self.Fq, x_points)

        v_H_x = Poly(self.Fq, [1])
        for i in range(len(x)):
            v_H_x = v_H_x * Poly(self.Fq, [-self.H[i], 1])

        values = [self.Fq(0)] * len(x)
        for i, wi in enumerate(w):
            values.append(wi - x_poly(self.H[i + len(x)]))
        padding_size = self.n - len(values)
        if padding_size > 0:
            values.extend([self.Fq(0)] * padding_size)

        f = fft_interpolation(values, self.g_H)
        w_poly = f // v_H_x
        assert w_poly * v_H_x == f, "w_poly is not well-defined"
        z_poly = w_poly * v_H_x + x_poly

        return {
            "x_poly": x_poly,
            "w_poly": w_poly,
            "z_poly": z_poly,
            "x": x,
            "w": w,
            "v_H_x": v_H_x,
        }

    # ------------------------------------------------------------------
    def encode_linear_combinations(self, z) -> dict:
        """zA = A z, zB = B z, zC = C z, padded to n and interpolated over H
        (reference marlin/encoder.py:191-234)."""
        z_vec = [self.Fq(int(zi)) for zi in z]
        zA_list = self.A.matvec(z_vec)
        zB_list = self.B.matvec(z_vec)
        zC_list = self.C.matvec(z_vec)
        for lst in (zA_list, zB_list, zC_list):
            if len(lst) < self.n:
                lst.extend([self.Fq(0)] * (self.n - len(lst)))
        return {
            "zA_poly": fft_interpolation(zA_list, self.g_H),
            "zB_poly": fft_interpolation(zB_list, self.g_H),
            "zC_poly": fft_interpolation(zC_list, self.g_H),
            "zA": zA_list,
            "zB": zB_list,
            "zC": zC_list,
        }
