"""scan_ms (field and scans): device ms a traced batch of the chains'
kernels by name, ``k_scan*``, ``k_fr_inv*`` and ``k_fr_pow*``, wherever
launched."""

from . import kernel_s_per_batch


def read(record):
    s = kernel_s_per_batch(record, r"^k_(scan|fr_inv|fr_pow)\b")
    return None if s is None else 1e3 * s
