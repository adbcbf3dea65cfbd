"""The port's MSM against the JAX package's digit recoding and the host
oracle.

``signed_digits`` must equal the JAX recoding.  The MSM (plain versions of
the kernels on the CPU) must equal the host sum over ``random_point_basis``
(P_i = k_i G, so the oracle is (sum s_i k_i) G), with scalars 0, 1, r - 1
and duplicates, on each route the JAX ``MsmContext`` would take: bit-serial
(n <= 256: 64, 200), scan Pippenger on K9 (300, 1024) and the bucket pass
(2048); all-zero scalars give the identity on every route.  A structured
basis [(i+1) G] runs with ``complete=True``.
"""

import functools

import numpy as np
import pytest
import torch

from kzg_snark_tpu import constants as C
from kzg_snark_tpu.ops.fr import fr_backend as jax_fr_backend
from kzg_snark_tpu.ops.host import curve as hc
from kzg_snark_tpu.ops.host.field import base_field
from kzg_snark_tpu.ops.msm_kernel import signed_digits as jax_signed_digits
from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor
from kzg_snark_tpu_torch.ops.msm import MsmContext, msm_context
from kzg_snark_tpu_torch.ops.msm_kernel import lanes_for, signed_digits

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)

R = C.BN254_R
Fp = base_field("bn254")
G1 = (Fp(1), Fp(2), Fp(1))


def scalars(n, seed):
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    out[:4] = [0, 1, R - 1, R - 1]          # edge values and a duplicate
    out[4] = out[5]
    return out


def host_point(total):
    a = hc.normalize(hc.multiply(G1, total % R))
    return None if a is None else (int(a[0]), int(a[1]))


def test_signed_digits_match_jax():
    from kzg_snark_tpu.ops.fr import ints_to_limb_array
    s = scalars(64, 1)
    jax_limbs = ints_to_limb_array(s, 16)
    want = np.asarray(jax_signed_digits(jax_fr_backend("bn254"), jax_limbs,
                                        254, pad=False))
    got = signed_digits(to_tensor(ints_to_words(s), "cpu"), 254).numpy()
    assert np.array_equal(want.astype(np.int64), got.astype(np.int64))


def test_lanes_for():
    assert lanes_for(16) == 1
    assert lanes_for(64) == 4
    assert lanes_for(1024) == 64
    assert lanes_for(1 << 16) == 256


@functools.lru_cache(maxsize=None)
def basis(n):
    return random_point_basis("bn254", n, seed=n)


@pytest.mark.parametrize("n", [64, 1024])
def test_msm_matches_host_oracle(n):
    pts, ks = basis(n)
    ctx = msm_context("bn254")
    s = scalars(n, n + 1)
    got = ctx.curve.to_affine_ints(ctx.msm(pts, ctx.scalars_to_limbs(s)))
    assert got == [host_point(sum(a * b for a, b in zip(s, ks)))]


@pytest.mark.parametrize("n, route", [(200, "small"), (300, "scan"),
                                      (2048, "bucket")])
def test_msm_routes_match_host_oracle(n, route):
    assert MsmContext.route(n) == route
    pts, ks = basis(n)
    ctx = msm_context("bn254")
    s = scalars(n, n + 2)
    got = ctx.curve.to_affine_ints(ctx.msm(pts, ctx.scalars_to_limbs(s)))
    assert got == [host_point(sum(a * b for a, b in zip(s, ks)))]
    zero = ctx.msm(pts, ctx.scalars_to_limbs([0] * n))
    assert ctx.curve.to_affine_ints(zero) == [None]


def test_msm_many_matches_single():
    n = 64
    pts, ks = random_point_basis("bn254", n, seed=7)
    ctx = msm_context("bn254")
    sets = [scalars(n, 10 + j) for j in range(3)]
    sets[2] = [0] * n                       # an all-zero scalar set
    lim = torch.stack([ctx.scalars_to_limbs(s) for s in sets])
    got = ctx.curve.to_affine_ints(ctx.fused.msm_many(pts, lim))
    assert got == [host_point(sum(a * b for a, b in zip(s, ks)))
                   for s in sets]


def test_structured_basis_complete():
    n = 64
    ctx = msm_context("bn254")
    aff = [hc.normalize(hc.multiply(G1, i + 1)) for i in range(n)]
    pts = ctx.curve.from_affine_ints([int(a[0]) for a in aff],
                                     [int(a[1]) for a in aff])
    s = scalars(n, 3)
    got = ctx.curve.to_affine_ints(
        ctx.msm(pts, ctx.scalars_to_limbs(s), complete=True))
    assert got == [host_point(sum(a * (i + 1) for i, a in enumerate(s)))]
