"""The port's ``CurveOps`` against the JAX package's, representative by
representative.

The port's curve formulas are the JAX package's (``ops/regcurve.py``), so
add, double and the mixed adds must give equal Jacobian (X, Y, Z) integers
on the same inputs, including the identity, P + P and P + (-P).  The JAX
functions run eagerly (``add_xla`` etc.); the K7 plain version is also held
to the JAX Pallas ``fused_curve_double`` in interpret mode.
"""

import numpy as np
import pytest
import torch

from kzg_snark_tpu.ops.g1 import curve_ops as jax_curve_ops
from kzg_snark_tpu.ops.host import curve as hc
from kzg_snark_tpu.ops.host.field import base_field
from kzg_snark_tpu_torch.ops import cuda_fr
from kzg_snark_tpu_torch.ops.g1 import curve_ops
from kzg_snark_tpu_torch.utils.convert import (points16_to_tensor,
                                               tensor_to_limbs16)

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)

W = 8


def same(jax_pts, port_pts):
    return all(np.array_equal(np.asarray(jax_pts)[c],
                              tensor_to_limbs16(port_pts[c]))
               for c in range(3))


@pytest.fixture(scope="module")
def curves():
    return jax_curve_ops("bn254"), curve_ops("bn254")


@pytest.fixture(scope="module")
def points(curves):
    """Affine multiples k G for numpy-seeded k, lifted to Jacobian inputs
    with Z != 1 by a doubling, and the pair lists that hit every case."""
    jc, tc = curves
    Fp = base_field("bn254")
    G = (Fp(1), Fp(2), Fp(1))
    ks = [int(k) for k in np.random.default_rng(8).integers(2, 1 << 40, W)]
    aff = [hc.normalize(hc.multiply(G, k)) for k in ks]
    xs, ys = [int(a[0]) for a in aff], [int(a[1]) for a in aff]
    jp = jc.from_affine_ints(xs, ys)
    tp = tc.from_affine_ints(xs, ys)
    assert same(jp, tp)
    jd, td = jc.double_xla(jp), tc.double(tp)
    return jp, tp, jd, td


def test_double(curves, points):
    jc, tc = curves
    jp, tp, jd, td = points
    assert same(jd, td)
    assert same(jc.double_xla(jd), tc.double(td))
    ident_j, ident_t = jc.identity((W,)), tc.identity((W,))
    assert same(jc.double_xla(ident_j), tc.double(ident_t))


def test_add_cases(curves, points):
    jc, tc = curves
    jp, tp, jd, td = points
    neg_j = jp.at[1].set(jc.f.neg(jp[1]))
    neg_t = torch.stack([tp[0], tc.f.neg(tp[1]), tp[2]])
    ident_j, ident_t = jc.identity((W,)), tc.identity((W,))
    roll_j, roll_t = np.roll(np.asarray(jd), 1, axis=-1), td.roll(1, -1)
    for (a_j, b_j), (a_t, b_t) in [
            ((jd, roll_j), (td, roll_t)),           # general, Z != 1
            ((jp, jp), (tp, tp)),                   # P + P
            ((jd, jd), (td, td)),                   # P + P, Z != 1
            ((jp, neg_j), (tp, neg_t)),             # P + (-P)
            ((ident_j, jd), (ident_t, td)),         # O + P
            ((jd, ident_j), (td, ident_t)),         # P + O
            ((ident_j, ident_j), (ident_t, ident_t))]:
        assert same(jc.add_xla(a_j, b_j), tc.add(a_t, b_t.contiguous()))


def test_mixed_adds(curves, points):
    jc, tc = curves
    jp, tp, jd, td = points
    f = cuda_fr.PlainField(tc.f.consts)
    roll_j, roll_t = np.roll(np.asarray(jp), 1, axis=-1), tp.roll(1, -1)
    ident_j, ident_t = jc.identity((W,)), tc.identity((W,))
    neg_j = jd.at[1].set(jc.f.neg(jd[1]))
    neg_t = torch.stack([td[0], tc.f.neg(td[1]), td[2]])
    for acc_j, acc_t in [(jd, td), (ident_j, ident_t), (neg_j, neg_t)]:
        assert same(jc.add_mixed_xla_fast(acc_j, roll_j[0], roll_j[1]),
                    cuda_fr.add_mixed_fast_formula(f, acc_t, roll_t[0],
                                                   roll_t[1]))
        assert same(jc.add_mixed_xla(acc_j, roll_j[0], roll_j[1]),
                    cuda_fr.add_mixed_formula(f, acc_t, roll_t[0],
                                              roll_t[1]))
    # the doubling case: the complete mixed add doubles
    assert same(jc.add_mixed_xla(jp, jp[0], jp[1]),
                cuda_fr.add_mixed_formula(f, tp, tp[0], tp[1]))


def test_add_mixed_and_tree_sum_points(curves, points):
    """The port's add_mixed (complete add with q lifted to Z = 1) and
    tree_sum give the same affine points as the JAX package's."""
    jc, tc = curves
    jp, tp, jd, td = points
    want = jc.to_affine_ints(jc.add_mixed_xla(jd, jp[0], jp[1]))
    assert tc.to_affine_ints(tc.add_mixed(td, tp[0], tp[1])) == want
    assert tc.to_affine_ints(tc.tree_sum(td)) == jc.to_affine_ints(
        jc.tree_sum(jd))


def test_double_plain_matches_pallas_fused_double(curves):
    """K7's plain version against the JAX Pallas kernel in interpret mode
    at 128 points (the block layout of tests/test_pallas.py)."""
    from kzg_snark_tpu.ops import pallas_fr
    from kzg_snark_tpu.ops.msm import msm_context

    ctx = msm_context("bn254")
    P = ctx._generator_pad(128)
    old = pallas_fr._INTERPRET
    pallas_fr._INTERPRET = True
    try:
        want = pallas_fr.fused_curve_double(ctx.curve, P)
    finally:
        pallas_fr._INTERPRET = old
    _, tc = curves
    got = cuda_fr.g1_double_plain(tc.f.consts, points16_to_tensor(P))
    assert same(want, got)
