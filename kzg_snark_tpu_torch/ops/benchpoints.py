"""Pseudo-random G1 bases for MSM checks.

Counterpart of ``kzg_snark_tpu/ops/benchpoints.py``: P_i = k_i G with k_i
odd 128-bit multipliers from ``random.Random(seed)``, so the incomplete
bucket add is sound on the basis and any MSM has a one-multiplication host
oracle: sum_i s_i P_i = (sum_i s_i k_i mod r) G.  The basis is built on the
device (128 complete mixed adds of 2^j G, K9, as the JAX build does) and
normalized to Z = 1; the JAX package's disk cache is not kept.
"""

from __future__ import annotations

import random

import torch

from .fr import FieldBackend
from .g1 import curve_ops, generator
from .limbs import ints_to_words, to_tensor

K_BITS = 128


def normalize_points(f: FieldBackend, pts: torch.Tensor) -> torch.Tensor:
    """(3, L, n) Jacobian -> the same points with Z = 1 (no identities)."""
    zinv = f.batch_inv(pts[2].contiguous())
    zinv2 = f.mul(zinv, zinv)
    ax = f.mul(pts[0], zinv2)
    ay = f.mul(pts[1], f.mul(zinv2, zinv))
    return torch.stack([ax, ay, f.full(f.one_mont, ax.shape[1])])


def random_point_basis(curve_type: str, size: int, seed: int,
                       device="cuda") -> tuple[torch.Tensor, list[int]]:
    """(points (3, L, size) with Z = 1 on ``device``, multipliers k_i), G
    the curve's generator."""
    from .host import curve as hc
    from .host.field import base_field

    rng = random.Random(seed)
    ks = [(rng.getrandbits(K_BITS) | (1 << (K_BITS - 1)) | 1)
          for _ in range(size)]

    Fp = base_field(curve_type)
    gx, gy = generator(curve_type)
    P = (Fp(gx), Fp(gy), Fp(1))
    bx, by = [], []
    for _ in range(K_BITS):
        a = hc.normalize(P)
        bx.append(int(a[0]))
        by.append(int(a[1]))
        P = hc.double(P)
    curve = curve_ops(curve_type, device)
    f = curve.f
    bases = curve.from_affine_ints(bx, by)                 # (3, L, K_BITS)
    kw = to_tensor(ints_to_words(ks), device)              # (8, size)
    acc = curve.identity((size,)).contiguous()
    for j in range(K_BITS):
        word = (kw[j // 32].to(torch.int64) >> (j % 32)) & 1
        taken = curve.add_mixed(acc, bases[0, :, j:j + 1],
                                bases[1, :, j:j + 1])
        acc = torch.where((word == 1)[None, None], taken, acc)
    return normalize_points(f, acc), ks
