"""The yardstick of the kernel metrics: peaks, products and bucket-method work.

Frozen with the benchmark, so a roofline share reads the same work whatever
implements it: the work of an MSM is what a signed-digit bucket method at
this file's window width needs for the cell's n and k, costed with the
curve formulas' product counts; a change to the program's window width,
GLV or the fold changes the kernel time and leaves this alone.

The peaks: HBM bytes/s from NVIDIA's H100 SXM data sheet; 32x32-bit integer
products at 64 a clock an SM (compute capability 9.0), times the card's SM
count and top SM clock, both read in the run.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT_MUL_PER_SM_CLK = 64
H100_SXM_MAX_SM_MHZ = 1980.0       # used only when nvidia-smi gives nothing

# (squarings, products) of the curve formulas on Jacobian coordinates, a =
# 0: dbl-2009-l, add-2007-bl and madd-2007-bl.
DOUBLE = (5, 2)
ADD = (5, 11)
MADD = (4, 7)

# The window width c by log2 n of this benchmark's bucket method (the
# port's measured table as it stood when the benchmark was written); above
# it one more bit a doubling of n.
WINDOW_BITS_BY_LOG_N = {11: 9, 12: 10, 13: 10, 14: 10, 15: 10, 16: 10,
                        17: 12, 18: 12}


def mont_products(limbs: int) -> int:
    """32x32-bit products of one CIOS Montgomery product: 136 at 8 words,
    300 at 12."""
    return 2 * limbs * limbs + limbs


def sqr_products(limbs: int) -> int:
    """A Montgomery squaring, each cross product once: 108 at 8, 234 at
    12."""
    return limbs * (limbs + 1) // 2 + limbs * limbs + limbs


def formula_products(limbs: int, ops: tuple) -> int:
    return ops[0] * sqr_products(limbs) + ops[1] * mont_products(limbs)


def window_bits(n: int) -> int:
    lg = max(n, 1).bit_length() - 1
    lo, hi = min(WINDOW_BITS_BY_LOG_N), max(WINDOW_BITS_BY_LOG_N)
    if lg > hi:
        return min(WINDOW_BITS_BY_LOG_N[hi] + lg - hi, 16)
    return WINDOW_BITS_BY_LOG_N[max(lg, lo)]


def msm_shape(n: int, scalar_bits: int) -> tuple[int, int, int]:
    """(c, windows W, buckets a window B) of the bucket method on n points:
    signed digits, W = ceil((bits + 1) / c), B = 2^(c - 1)."""
    c = window_bits(n)
    return c, -(-(scalar_bits + 1) // c), 1 << (c - 1)


def accumulate_work(n: int, k: int, limbs: int, scalar_bits: int
                    ) -> tuple[float, float]:
    """(bytes, products) of filling the buckets of k MSMs over n points:
    every digit mixed-added into its bucket but the first a bucket, k W (n
    - B) adds; the points (2 L words) and the scalars (8 words) read
    once."""
    c, W, B = msm_shape(n, scalar_bits)
    adds = k * W * max(n - B, 0)
    return (4.0 * n * (2 * limbs + 8 * k),
            float(adds) * formula_products(limbs, MADD))


def reduce_work(n: int, k: int, limbs: int, scalar_bits: int
                ) -> tuple[float, float]:
    """(bytes, products) of summing the buckets: sum_m m B_m by running
    sums, 2 (B - 1) complete adds a window, then the fold over windows,
    c (W - 1) doublings and W - 1 adds a set; the bucket sums (3 L words)
    read once."""
    c, W, B = msm_shape(n, scalar_bits)
    adds = k * (W * 2 * (B - 1) + (W - 1))
    dbls = k * c * (W - 1)
    return (4.0 * 3 * limbs * k * W * B,
            float(adds) * formula_products(limbs, ADD)
            + float(dbls) * formula_products(limbs, DOUBLE))


def bound_s(rates: dict, nbytes: float, products: float) -> tuple[float, str]:
    """(seconds, "bytes" or "products"): the larger of the two times."""
    t_bytes = nbytes / rates["bytes_per_s"]
    t_ops = products / rates["products_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "products")


def smi(query: str) -> str:
    """One field of nvidia-smi for card 0, or "" where it gives nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else ""


def device_rates(torch) -> dict:
    """The card's peaks, its top SM clock and its power limit."""
    fields = smi("clocks.max.sm,power.limit").split(",")
    try:
        clock_mhz = float(fields[0].split()[0])
        clock_from = "nvidia-smi"
    except (ValueError, IndexError):
        clock_mhz, clock_from = H100_SXM_MAX_SM_MHZ, "data sheet"
    power = fields[1].strip() if len(fields) > 1 else "not read"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"bytes_per_s": HBM_BYTES_PER_S,
            "products_per_s": sms * INT_MUL_PER_SM_CLK * clock_mhz * 1e6,
            "sms": sms, "sm_clock_mhz": clock_mhz, "clock_from": clock_from,
            "power_limit": power}
