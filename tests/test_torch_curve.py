"""The port's ``CurveOps`` against the JAX package's, representative by
representative.

The port's curve formulas are the JAX package's (``ops/regcurve.py``), so
add, double and the mixed adds must give equal Jacobian (X, Y, Z) integers
on the same inputs, including the identity, P + P and P + (-P).  The JAX
functions run eagerly (``add_xla`` etc.); the K7 and K9 plain versions are
also held to the JAX Pallas wrappers with interpret mode set, as
``tests/test_pallas.py`` runs them (at 128 points the wrappers serve the
call from the XLA formulas), and K9's to ``RegCurve.add_mixed``, the body of
``_add_mixed_call``.  The g++ build of K9's thread body must agree too.
``scale`` and ``scale_const`` (one ``g1_ladder`` launch on the card, its
plain version here) give the Jacobian words of the JAX ``CurveOps.scale``
under ``jax.jit`` (one compile, 64 bits).
"""

import jax.numpy as jnp
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
    return jax_curve_ops("bn254"), curve_ops("bn254", "cpu")


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
    """The port's add_mixed (K9) gives the JAX package's representative,
    and tree_sum the same affine points."""
    jc, tc = curves
    jp, tp, jd, td = points
    assert same(jc.add_mixed_xla(jd, jp[0], jp[1]),
                tc.add_mixed(td, tp[0], tp[1]))
    assert tc.to_affine_ints(tc.tree_sum(td)) == jc.to_affine_ints(
        jc.tree_sum(jd))


@pytest.fixture(scope="module")
def mixed_cases(curves, points):
    """Accumulators (port and JAX) whose lane 0 is the identity, lane 1
    equals q and lane 2 equals -q, and the affine q (per lane)."""
    jc, tc = curves
    jp, tp, jd, td = points
    q = tp.roll(1, -1)
    acc = td.clone()
    acc[:, :, 0] = tc.identity()[:, :, 0]
    acc[:, :, 1] = q[:, :, 1]
    acc[:, :, 2] = torch.stack([q[0, :, 2], tc.f.neg(q[1, :, 2:3])[:, 0],
                                q[2, :, 2]])
    acc_j = jnp.asarray(np.stack([tensor_to_limbs16(acc[c])
                                  for c in range(3)]))
    q_j = jnp.asarray(np.stack([tensor_to_limbs16(q[c]) for c in range(3)]))
    return acc, q, acc_j, q_j


def test_k9_plain_matches_jax_add_mixed(curves, mixed_cases):
    jc, tc = curves
    acc, q, acc_j, q_j = mixed_cases
    fc = tc.f.consts
    want = jc.add_mixed_xla(acc_j, q_j[0], q_j[1])
    assert same(want, cuda_fr.g1_add_mixed_plain(fc, acc, q[0], q[1]))
    # one q broadcast over the batch (column period 1)
    want = jc.add_mixed_xla(acc_j, q_j[0][:, 1:2], q_j[1][:, 1:2])
    got = cuda_fr.g1_add_mixed_plain(fc, acc, q[0, :, 1:2].contiguous(),
                                     q[1, :, 1:2].contiguous())
    assert same(want, got)
    # the equal lane doubles, the opposite lane is the identity
    out = cuda_fr.g1_add_mixed_plain(fc, acc, q[0], q[1])
    assert torch.equal(out[:, :, 1], tc.double(acc[:, :, 1:2])[:, :, 0])
    assert bool((out[2, :, 2] == 0).all())


def test_k9_plain_matches_regcurve_kernel_body(curves, mixed_cases):
    """The body of ``_add_mixed_call`` is ``RegCurve.add_mixed`` over
    register limbs; evaluated eagerly on the same points."""
    from kzg_snark_tpu.ops.regcurve import RegCurve
    from kzg_snark_tpu.ops.regfield import reg_field

    jc, tc = curves
    acc, q, acc_j, q_j = mixed_cases
    rc = RegCurve(reg_field(jc.f.modulus))
    regs = lambda a: [a[i][None] for i in range(a.shape[0])]  # noqa: E731
    out = rc.add_mixed(tuple(regs(acc_j[c]) for c in range(3)),
                       regs(q_j[0]), regs(q_j[1]))
    want = np.stack([np.concatenate([np.asarray(r) for r in out[c]])
                     for c in range(3)])
    assert same(want, cuda_fr.g1_add_mixed_plain(tc.f.consts, acc, q[0],
                                                  q[1]))


def test_k9_plain_matches_pallas_fused_add_mixed(curves):
    """As ``tests/test_pallas.py`` runs the Pallas wrappers: interpret mode
    set, 128 points, one broadcast q."""
    from kzg_snark_tpu.ops import pallas_fr
    from kzg_snark_tpu.ops.msm import msm_context

    ctx = msm_context("bn254")
    P = ctx.curve.double_xla(ctx._generator_pad(128))
    g = ctx._generator_pad(1)
    old = pallas_fr._INTERPRET
    pallas_fr._INTERPRET = True
    try:
        want = pallas_fr.fused_curve_add_mixed(ctx.curve, P, g[0], g[1])
    finally:
        pallas_fr._INTERPRET = old
    _, tc = curves
    gt = points16_to_tensor(g, device="cpu")
    got = cuda_fr.g1_add_mixed_plain(tc.f.consts,
                                     points16_to_tensor(P, device="cpu"),
                                     gt[0].contiguous(), gt[1].contiguous())
    assert same(want, got)


@pytest.mark.parametrize("qn", [1, W])
def test_k9_host_build_matches_plain(curves, mixed_cases, qn):
    """The kernel's thread body, built with g++, on the same values."""
    from kzg_snark_tpu_torch.utils.build import host_lib

    _, tc = curves
    acc, q, _, _ = mixed_cases
    fc = tc.f.consts
    qx, qy = q[0, :, :qn].contiguous(), q[1, :, :qn].contiguous()
    out = torch.empty_like(acc)
    host_lib().host_g1_add_mixed(acc.data_ptr(), qx.data_ptr(),
                                 qy.data_ptr(), qn, out.data_ptr(), W, fc.ptr)
    assert torch.equal(out, cuda_fr.g1_add_mixed_plain(fc, acc, qx, qy))


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
    got = cuda_fr.g1_double_plain(tc.f.consts,
                                  points16_to_tensor(P, device="cpu"))
    assert same(want, got)


SCALE_BITS = 64


@pytest.fixture(scope="module")
def scale_case(curves):
    """16 points (the identity, Z = 1 multiples of G, their doubles with
    Z != 1) for both packages, and the JAX ``scale`` under one
    ``jax.jit`` of a (64,) bit array."""
    import jax

    jc, tc = curves
    Fp = base_field("bn254")
    G = (Fp(1), Fp(2), Fp(1))
    ks = [int(k) for k in np.random.default_rng(9).integers(2, 1 << 40, 8)]
    aff = [hc.normalize(hc.multiply(G, k)) for k in ks]
    xs, ys = [int(a[0]) for a in aff], [int(a[1]) for a in aff]
    jp, tp = jc.from_affine_ints(xs, ys), tc.from_affine_ints(xs, ys)
    jp = jnp.concatenate([jp, jc.double_xla(jp)], axis=-1)
    tp = torch.cat([tp, tc.double(tp)], dim=-1)
    jp = jp.at[:, :, 0].set(jc.identity()[:, :, 0])
    tp[:, :, 0] = tc.identity()[:, :, 0]
    assert same(jp, tp)
    return jp, tp, jax.jit(jc.scale)


def _bits(k):
    return np.array([(k >> i) & 1 for i in range(SCALE_BITS)], np.uint32)


def test_scale_matches_jax(curves, scale_case):
    _, tc = curves
    jp, tp, jax_scale = scale_case
    k = int(np.random.default_rng(10).integers(1, 1 << 63)) | (1 << 63)
    bits = _bits(k)
    assert same(jax_scale(jp, jnp.asarray(bits)), tc.scale(tp, bits))


@pytest.mark.parametrize("k", [0, 1, 5])
def test_scale_const_matches_jax(curves, scale_case, k):
    """``scale_const(pts, k)`` against the JAX ``scale`` of k's bits padded
    to 64 (rows past the top bit leave acc as it is); at k = 0 also the JAX
    ``scale_const``, the identity."""
    jc, tc = curves
    jp, tp, jax_scale = scale_case
    got = tc.scale_const(tp, k)
    assert same(jax_scale(jp, jnp.asarray(_bits(k))), got)
    assert torch.equal(got, tc.scale(tp, _bits(k)[:max(k.bit_length(), 1)]))
    if k == 0:
        assert same(jc.scale_const(jp, 0), got)


@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_fixed_base_table_plain_matches_jax(curve_type):
    """The SRS table module (``fixed_base_table_plain``, the words the
    table kernel must give) against the JAX package's
    ``ops/srs._fixed_base_table`` under ``jax.jit`` on the CPU, at c = 3,
    W = 5 of the curve's generator: equal affine points.  The two build
    each row in another order (the JAX one adds the window base step by
    step, the port doubles the step a level), so their Jacobian words
    differ."""
    from kzg_snark_tpu.ops.srs import _fixed_base_table
    from kzg_snark_tpu_torch import constants as TC
    from kzg_snark_tpu_torch.ops.srs import fixed_base_table_plain

    c, windows = 3, 5
    g1 = TC.BN254_G1 if curve_type == "bn254" else TC.BLS12_381_G1
    jc, tc = jax_curve_ops(curve_type), curve_ops(curve_type, "cpu")
    base_j = jc.from_affine_ints([g1[0]], [g1[1]])
    base_t = tc.from_affine_ints([g1[0]], [g1[1]]).contiguous()
    assert same(base_j, base_t)
    want = tc.to_affine_ints(points16_to_tensor(
        _fixed_base_table(jc, base_j, c, windows), "cpu"))
    got = tc.to_affine_ints(fixed_base_table_plain(tc.f.consts, base_t, c,
                                                   windows))
    assert got == want and len(got) == windows << c
    Fp = base_field(curve_type)
    G = (Fp(g1[0]), Fp(g1[1]), Fp(1))
    for j, v in ((0, 0), (0, 1), (1, 7), (windows - 1, 5)):
        pt = hc.normalize(hc.multiply(G, v << (c * j))) if v else None
        assert got[(j << c) + v] == (None if pt is None else
                                     (int(pt[0]), int(pt[1])))
