"""Host-side radix-2 finite-field FFT (exact oracle for the device NTT).

Behavioral equivalent of the reference's recursive implementation
(``fft_ff.py:3-85``): natural-order input and output,
``fft(coeffs, w)[i] == p(w^i)``.  Because field arithmetic is exact, any
mathematically correct NTT produces bit-identical canonical field elements,
so this iterative in-place form matches the reference's recursive one
value-for-value.
"""

from __future__ import annotations

from typing import Sequence

from .field import FieldElement
from .poly import Poly


def _bit_reverse_permute(values: list) -> list:
    n = len(values)
    bits = n.bit_length() - 1
    out = [None] * n
    for i in range(n):
        j = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
        out[j] = values[i]
    return out


def fft_ff(coeffs: Sequence, w: FieldElement, field=None) -> list:
    """Evaluate the polynomial with ``coeffs`` at powers of ``w``
    (reference fft_ff.py:3-37).  ``len(coeffs)`` must be a power of two and
    ``w`` a root of unity of that exact order (the only way the reference
    ever calls it)."""
    field = field or type(w)
    n = len(coeffs)
    if n == 1:
        return [coeffs[0] if isinstance(coeffs[0], FieldElement) else field(coeffs[0])]
    assert n & (n - 1) == 0, "FFT length must be a power of 2"
    w = w if isinstance(w, FieldElement) else field(w)
    assert (w ** n) == 1, "w must satisfy w^n = 1"

    vals = [c if isinstance(c, FieldElement) else field(c) for c in coeffs]
    vals = _bit_reverse_permute(vals)

    # Precompute the twiddle ladder once per call.
    span = 1
    while span < n:
        step = w ** (n // (2 * span))
        for start in range(0, n, 2 * span):
            tw = field(1)
            for k in range(span):
                a = vals[start + k]
                b = vals[start + k + span] * tw
                vals[start + k] = a + b
                vals[start + k + span] = a - b
                tw = tw * step
        span *= 2
    return vals


def ifft_ff(values: Sequence, w: FieldElement, field=None) -> list:
    """Inverse FFT: forward FFT with w^-1, then scale by n^-1
    (reference fft_ff.py:39-58)."""
    field = field or type(w)
    n = len(values)
    w = w if isinstance(w, FieldElement) else field(w)
    result = fft_ff(values, w ** (-1), field)
    n_inv = field(n) ** (-1)
    return [x * n_inv for x in result]


def fft_interpolation(values: Sequence, g: FieldElement, field=None) -> Poly:
    """Interpolate ``values`` over the subgroup generated by ``g`` and return
    a polynomial (reference fft_ff.py:60-85)."""
    field = field or type(g)
    n = len(values)
    assert (n & (n - 1)) == 0, "Length of values must be a power of 2"
    g = g if isinstance(g, FieldElement) else field(g)
    # Reference asserts multiplicative_order(g) >= n; for our deterministic
    # domain generators the order is exactly n.
    assert g ** n == 1, "g must generate a subgroup of order n"
    coeffs = ifft_ff(values, g, field)
    return Poly(field, coeffs)
