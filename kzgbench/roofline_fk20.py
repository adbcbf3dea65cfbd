"""The yardstick of the FK20 cell proofs' kernel metrics: the work of their
two grouped MSMs, frozen with the benchmark as ``roofline.py`` is.

A batch of k blobs of n values in cells of l (m = n / l, N = 2m) makes
N groups of l points with k sets (the circulant's products), then k groups
of N + 2 points with N sets (the G1 transform, m + 2 nonzero scalars a
set).  The work of each is what a signed-digit bucket method at this
file's window width needs for that many terms a set, costed with
``roofline.py``'s formula products: the same counts as
``roofline.accumulate_work`` and ``reduce_work`` a (group, set), times the
groups.  A change to the program's window width or its transform changes
the kernel time and leaves this alone.
"""

from __future__ import annotations

from .roofline import ADD, DOUBLE, MADD, formula_products

# The window width c by group size: the port's cost model when the
# benchmark's FK20 cell was written (W (n madd + 2^c add), 4 <= c <= 10).
_MADD_Q, _ADD_Q = 3 * 4 + 4 * 7, 3 * 5 + 4 * 11


def window_bits(n: int, scalar_bits: int) -> int:
    def cost(c):
        W = -(-(scalar_bits + 1) // c)
        return W * (n * _MADD_Q + (1 << c) * _ADD_Q)
    return min(range(4, 11), key=cost)


def grouped_calls(config: dict, k: int) -> list:
    """(groups, nonzero scalars a set, sets) of a batch's two grouped MSMs:
    N groups of l points and k sets; then k groups of N + 2 points and N
    sets (the cells), each set with m + 2 nonzero scalars (the
    transform's rows, their m - 1 equal entries taken once)."""
    n = config["n"]
    l = min(config["field_elements_per_cell"], n // 4)
    m = n // l
    return [(2 * m, l, k), (k, m + 2, 2 * m)]


def _shape(n: int, scalar_bits: int) -> tuple[int, int, int]:
    c = window_bits(n, scalar_bits)
    return c, -(-(scalar_bits + 1) // c), 1 << (c - 1)


def accumulate_work(G: int, n: int, k: int, limbs: int, scalar_bits: int
                    ) -> tuple[float, float]:
    """(bytes, products) of the buckets' fills: k W (n - B) mixed adds a
    group; the points and the scalars read once."""
    c, W, B = _shape(n, scalar_bits)
    adds = G * k * W * max(n - B, 0)
    return (4.0 * G * n * (2 * limbs + 8 * k),
            float(adds) * formula_products(limbs, MADD))


def reduce_work(G: int, n: int, k: int, limbs: int, scalar_bits: int
                ) -> tuple[float, float]:
    """(bytes, products) of the running sums, 2 (B - 1) complete adds a
    window, and the fold, c (W - 1) doublings and W - 1 adds a set."""
    c, W, B = _shape(n, scalar_bits)
    adds = G * k * (W * 2 * (B - 1) + (W - 1))
    dbls = G * k * c * (W - 1)
    return (4.0 * 3 * limbs * G * k * W * B,
            float(adds) * formula_products(limbs, ADD)
            + float(dbls) * formula_products(limbs, DOUBLE))


def roofline_pct(record, pattern: str, work) -> float | None:
    """Share (%) of the kernels matching ``pattern`` of the bound of the
    batch's grouped MSMs' ``work``, against their traced time a batch."""
    from .metrics import kernel_s_per_batch
    from .roofline import bound_s
    t = kernel_s_per_batch(record, pattern)
    if t is None or not record.rates or "field_elements_per_cell" not in \
            record.config:
        return None
    nbytes = products = 0.0
    for G, n, k in grouped_calls(record.config, record.traffic["batch"]):
        b, p = work(G, n, k, record.base_limbs, record.curve.r.bit_length())
        nbytes += b
        products += p
    return 100.0 * bound_s(record.rates, nbytes, products)[0] / t
