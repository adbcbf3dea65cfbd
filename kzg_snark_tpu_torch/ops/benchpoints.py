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


def edge_scalar_sets(curve_type: str, ks: list[int], seed: int
                     ) -> list[list[int]]:
    """Three scalar sets over the n = len(ks) points P_i = k_i G of
    ``random_point_basis``: uniform below r; 0, 1, r - 1 and (n >= 5) a
    duplicate among uniform values; and (n >= 2) k_1, r - k_0 and zeros,
    whose sum is the identity."""
    from .. import constants as C
    r = C.BN254_R if curve_type == "bn254" else C.BLS12_381_R
    n = len(ks)
    rng = random.Random(seed)
    sets = [[rng.randrange(r) for _ in range(n)] for _ in range(3)]
    sets[1][:3] = [0, 1, r - 1][:n]
    if n >= 5:
        sets[1][4] = sets[1][3]
    sets[2] = ([ks[1], r - ks[0]] + [0] * n)[:n] if n >= 2 else [0]
    return sets


def adversarial_values(p: int, limbs: int) -> list[int]:
    """Canonical values that stress a Montgomery product's carries: 0, 1,
    p - 1 and its neighbours, all-ones low words, p less a power of the
    word, R mod p and R^2 mod p (R = 2^(32 limbs))."""
    R = 1 << (32 * limbs)
    vals = [0, 1, 2, 3, p - 1, p - 2, p - 3, (p - 1) // 2, (p + 1) // 2,
            R % p, R * R % p, (R - 1) % p]
    vals += [(1 << (32 * k)) - 1 for k in range(1, limbs + 1)]
    vals += [p - (1 << (32 * k)) for k in range(limbs)]
    return sorted({v % p for v in vals})


def edge_batches(curve_type: str, pts: torch.Tensor) -> dict:
    """Inputs for the curve kernels' case analysis from k points ``pts``
    (3, L, k) with Z = 1: {"add": (p, q), "mixed": [(acc, qx, qy), ...]}.

    The add's lanes, k each: distinct points, P = Q, P = -Q, an identity
    operand on either side and on both, and triples of adversarial field
    values (not on the curve: the formulas are the same arithmetic) against
    other such triples and against themselves.  Finite points are rescaled
    to Jacobian representatives (l^2 X, l^3 Y, l) with l adversarial, so
    coordinates near p and all-ones words reach the products.  The mixed
    add's batches: q one point a lane (qn = m) and one q for all lanes
    (qn = 1), each with distinct points, P = q (the doubling), P = -q, the
    identity and adversarial triples as the accumulator."""
    curve = curve_ops(curve_type, pts.device)
    f = curve.f
    k = pts.shape[2]
    adv = adversarial_values(f.modulus, f.num_limbs)
    cyc = lambda shift: f.from_ints(  # noqa: E731
        [adv[(i + shift) % len(adv)] for i in range(k)])
    nonzero = [v for v in adv if v]
    lam = f.from_ints([nonzero[i % len(nonzero)] for i in range(k)])

    def scaled(x, y):
        lam2 = f.mul(lam, lam)
        return torch.stack([f.mul(x, lam2), f.mul(y, f.mul(lam2, lam)), lam])

    x, y = pts[0].contiguous(), pts[1].contiguous()
    xr, yr = x.roll(1, -1).contiguous(), y.roll(1, -1).contiguous()
    ident = curve.identity((k,))
    raw = torch.stack([cyc(0), cyc(1), cyc(2)])
    raw2 = torch.stack([cyc(3), cyc(5), cyc(7)])
    P = scaled(x, y)
    p = torch.cat([P, P, pts, ident, P, ident, raw, raw], dim=-1)
    q = torch.cat([torch.stack([xr, yr, pts[2]]), pts,
                   scaled(x, f.neg(y)), P, ident, ident, raw2, raw], dim=-1)
    mixed = []
    acc = torch.cat([P, P, scaled(x, f.neg(y)), ident, raw], dim=-1)
    qx = torch.cat([xr, x, x, x, cyc(4)], dim=-1)
    qy = torch.cat([yr, y, y, y, cyc(6)], dim=-1)
    mixed.append((acc.contiguous(), qx.contiguous(), qy.contiguous()))
    x0, y0 = x[:, :1].expand(-1, k), y[:, :1].expand(-1, k)
    acc1 = torch.cat([P, scaled(x0, y0), scaled(x0, f.neg(y0)), ident, raw],
                     dim=-1)
    mixed.append((acc1.contiguous(), x[:, :1].contiguous(),
                  y[:, :1].contiguous()))
    return {"add": (p.contiguous(), q.contiguous()), "mixed": mixed}


def fold_edge_partials(curve_type: str, pts: torch.Tensor, c: int,
                       windows: int, pieces: int) -> torch.Tensor:
    """Block partials (3, L, 4 windows pieces) of four scalar sets for the
    MSM's fold launch (``msm_kernel.reduce_horner`` with ``windows``
    windows of c bits), from points ``pts`` (3, L, k > windows pieces)
    with Z = 1, each doubled to a representative with Z != 1:

    * set 0: the top window's total P, the next window's 2^c P, so at that
      Horner step the total equals the accumulator (the complete add's
      doubling); every other window's total the identity;
    * set 1: the same with -2^c P (the opposite case: the accumulator
      turns into the identity, and the doublings after it skip);
    * set 2: every partial the identity (all-zero scalars);
    * set 3: distinct points in every partial.

    In sets 0 and 1 a window's total T lies in its pieces as T - Q, Q and
    identities (pieces > 1), so the window totals' tree meets P + (-P) in
    the empty windows.  Plain formulas only: no kernel launches."""
    from . import cuda_fr

    curve = curve_ops(curve_type, pts.device)
    f = cuda_fr.PlainField(curve.f.consts)
    k = windows * pieces
    jac = cuda_fr.double_formula(f, pts[..., :k + 1].contiguous())
    ident = curve.identity((1,))
    P = jac[..., k:]
    scaled = P
    for _ in range(c):
        scaled = cuda_fr.double_formula(f, scaled)

    def neg(T):
        return torch.stack([T[0], f.neg(T[1]), T[2]])

    def window(T):
        if pieces == 1:
            return T
        Q = jac[..., :1]
        return torch.cat([cuda_fr.add_formula(f, T, neg(Q)), Q]
                         + [ident] * (pieces - 2), dim=-1)

    sets = []
    for top in (scaled, neg(scaled)):
        sets += [window(ident)] * (windows - 2) + [window(top), window(P)]
    sets += [ident.expand(-1, -1, k), jac[..., :k]]
    return torch.cat(sets, dim=-1).contiguous()


def generator_multiples(curve_type: str, n: int, device) -> torch.Tensor:
    """The structured basis [(i + 1) G] (3, L, n) with Z = 1, by host adds:
    with equal scalars a bucket's running sum meets its next point (G + 2G
    = 3G), the complete add's doubling and the incomplete add's fault."""
    from .host import curve as hc
    from .host.field import base_field

    Fp = base_field(curve_type)
    gx, gy = generator(curve_type)
    g = (Fp(gx), Fp(gy), Fp(1))
    pt, xs, ys = g, [], []
    for _ in range(n):
        a = hc.normalize(pt)
        xs.append(int(a[0]))
        ys.append(int(a[1]))
        pt = hc.add(pt, g)
    return curve_ops(curve_type, device).from_affine_ints(xs, ys).contiguous()
