"""The CUDA kernels' thread bodies, built for the CPU with g++, against the
plain PyTorch versions.

``csrc/host_check.cpp`` loops over the thread indices of each launch and
calls the same ``__host__ __device__`` code the kernels run, so this checks
the kernels' arithmetic and indexing on a machine without a card.  Exact
equality: the arithmetic is integer.  The bodies run at both limb counts
the kernels are instantiated at: 8 words (BN254, BLS12-381 Fr) and 12
(BLS12-381 Fq), chosen by the consts block as on the card.
"""

import ctypes
import functools
import random

import numpy as np
import pytest
import torch

from kzg_snark_tpu import constants as C
from kzg_snark_tpu_torch.ops import cuda_fr
from kzg_snark_tpu_torch.ops.benchpoints import (adversarial_values,
                                                  edge_batches,
                                                  edge_scalar_sets,
                                                  fold_edge_partials,
                                                  generator_multiples,
                                                  random_point_basis)
from kzg_snark_tpu_torch.ops.fr import fq_backend, fr_backend
from kzg_snark_tpu_torch.ops.limbs import (FieldConsts, ints_to_words,
                                           to_tensor, to_words,
                                           words_to_ints)
from kzg_snark_tpu_torch.ops.msm_kernel import (bucket_schedule, horner_plain,
                                                msm_accumulate_plain,
                                                point_table, signed_digits,
                                                window_bits,
                                                window_sums_plain)
from kzg_snark_tpu_torch.ops.ntt import ntt_context
from kzg_snark_tpu_torch.ops import ntt_stage
from kzg_snark_tpu_torch.ops.ntt_stage import ntt_pass_plain, pass_plan
from kzg_snark_tpu_torch.ops.srs import fixed_base_table_plain
from kzg_snark_tpu_torch.ops.scan import (fr_pow_plain, fr_scan_plain,
                                          inv_consts)
from kzg_snark_tpu_torch.utils.build import host_lib

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    return host_lib()


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _words(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(to_words(t))


def _random_field(p, n, seed):
    rng = random.Random(seed)
    return ([0, 1, p - 1] + [rng.randrange(p) for _ in range(n)])[:n]


def _backend(modulus):
    """The port's CPU field backend of ``modulus``."""
    for curve in ("bn254", "bls12_381"):
        for make in (fr_backend, fq_backend):
            be = make(curve, "cpu")
            if be.modulus == modulus:
                return be
    raise KeyError(modulus)


MODULI = [C.BN254_R, C.BN254_P, C.BLS12_381_R, C.BLS12_381_P]
MODULUS_IDS = ["fr", "fq", "bls-fr", "bls-fq"]


@pytest.mark.parametrize("modulus", MODULI, ids=MODULUS_IDS)
@pytest.mark.parametrize("op", [0, 1, 2], ids=["mul", "add", "sub"])
def test_field_ewise(lib, modulus, op):
    be = _backend(modulus)
    fc = FieldConsts(modulus)
    assert fc.num_limbs == (12 if modulus == C.BLS12_381_P else 8)
    a = be.from_ints(_random_field(modulus, 64, 1))
    b = be.from_ints(_random_field(modulus, 64, 2)[::-1])
    plain = [cuda_fr.mul_plain, cuda_fr.add_plain, cuda_fr.sub_plain][op]
    for bb in (b, b[:, 3:4].contiguous()):              # dense, broadcast
        aw, bw = _words(a), _words(bb)
        out = np.empty_like(aw)
        lib.host_fr_ewise(op, _ptr(aw), 64, 1, _ptr(bw), bb.shape[1],
                          int(bb.shape[1] != 1), _ptr(out), 64, fc.ptr)
        assert np.array_equal(out, _words(plain(fc, a, bb)))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("op", [0, 1], ids=["mul", "add"])
def test_fr_scan(lib, op, reverse):
    """The scan's tiling, element indexing, identity, publication and
    look-back (csrc/scan.cuh) against fr_scan_plain: widths around one and
    two tiles, a total alone, and one column read with step 0.  The sums
    take zero entries; the products none, since a zero would make every
    later prefix zero and hide the tiles after it."""
    _check_scan(lib, fr_backend("bn254", "cpu"), op, reverse)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("op", [0, 1], ids=["mul", "add"])
def test_fr_scan_bls_fq(lib, op, reverse):
    """The scan's thread bodies at 12 words (BLS12-381 Fq)."""
    _check_scan(lib, fq_backend("bls12_381", "cpu"), op, reverse)


def _host_scan(lib, fc, op, a, ld, inc, n, reverse, out, total):
    """The scan under g++ on a fresh state, blocks in ticket order."""
    state = np.zeros(lib.host_scan_state_words(n), dtype=np.uint32)
    assert lib.host_fr_scan_state(
        op, _ptr(a), ld, inc, n, int(reverse),
        None if out is None else _ptr(out),
        None if total is None else _ptr(total), _ptr(state), 0,
        lib.host_scan_window(), fc.ptr) == 0


def _check_scan(lib, be, op, reverse):
    fc = be.consts
    L = fc.num_limbs
    tile = lib.host_scan_tile()
    vals = _random_field(be.modulus, 2 * tile + 77, 5)
    if op == 1:
        vals[tile // 2::97] = [0] * len(vals[tile // 2::97])
    else:
        vals = [v or 1 for v in vals]
    a = be.from_ints(vals)
    aw = _words(a)
    ld = aw.shape[1]
    for n in (1, 2, tile - 1, tile, tile + 1, 2 * tile + 77):
        want, want_total = fr_scan_plain(fc, a[:, :n], op, reverse)
        out = np.empty((L, n), dtype=np.uint32)
        total = np.empty((L, 1), dtype=np.uint32)
        _host_scan(lib, fc, op, aw, ld, 1, n, reverse, out, total)
        assert np.array_equal(out, _words(want)), n
        assert np.array_equal(total, _words(want_total)), n
        total[:] = 0
        _host_scan(lib, fc, op, aw, ld, 1, n, reverse, None, total)
        assert np.array_equal(total, _words(want_total)), n
    n = tile + 3
    col = aw[:, 3:].copy()              # column 0 of col is column 3 of a
    want, _ = fr_scan_plain(fc, a[:, 3:4].expand(L, n), op, reverse)
    out = np.empty((L, n), dtype=np.uint32)
    _host_scan(lib, fc, op, col, col.shape[1], 0, n, reverse, out, None)
    assert np.array_equal(out, _words(want))


@pytest.mark.parametrize("schedule", [0, 1], ids=["in-order",
                                                  "aggregates-first"])
@pytest.mark.parametrize("op", [0, 1], ids=["mul", "add"])
@pytest.mark.parametrize("field", ["bn254-fr", "bls-fq"])
def test_fr_scan_single_pass(lib, field, op, schedule):
    """The single-pass scan (k_scan) emulated block by block on one state
    kept across calls, as the wrapper keeps a stream's (the values of
    earlier, longer scans stay behind): each block's aggregate, its
    look-back over the published records (csrc/scan.cuh
    scan_lookback_value, a window of tiles a step) and its inclusive
    prefix, in start order; "aggregates-first" publishes every aggregate
    before the first look-back and runs the look-backs from the last tile
    down, so each walks back through windows of aggregates to tile 0.
    Look-back windows of the kernel's SCAN_WINDOW tiles and of 32 tiles
    (the same code; 34 tiles then take two steps).  Widths 1, 2, T - 1, T,
    T + 1, 3 T + 5, 32 tiles less and more one element, and 34 tiles,
    forward and reverse, a total alone and a column read with step 0,
    against fr_scan_plain at 8 and 12 words; the state's counters and
    flags are zero after every scan."""
    be = (fr_backend("bn254", "cpu") if field == "bn254-fr"
          else fq_backend("bls12_381", "cpu"))
    fc = be.consts
    L = fc.num_limbs
    T = lib.host_scan_tile()
    window = 32 * T
    n_max = window + T + 1              # 34 tiles
    vals = _random_field(be.modulus, n_max, 7 + op)
    if op == 1:
        vals[5::11] = [0] * len(vals[5::11])
    else:
        vals = [v or 1 for v in vals]
    a = be.from_ints(vals)
    aw = _words(a)
    state = np.zeros(lib.host_scan_state_words(n_max), dtype=np.uint32)
    windows = (lib.host_scan_window(), 32)

    def run(x, ld, inc, n, reverse, want_scan, steps):
        out = np.empty((L, n), dtype=np.uint32) if want_scan else None
        total = np.empty((L, 1), dtype=np.uint32)
        assert lib.host_fr_scan_state(
            op, _ptr(x), ld, inc, n, int(reverse),
            None if out is None else _ptr(out), _ptr(total), _ptr(state),
            schedule, steps, fc.ptr) == 0
        flags = state.reshape(-1, 32)[:, 0]     # the ticket, then a tile's
        assert state[1] == 0 and not flags.any()
        return out, total

    for n in (n_max, 1, 2, T - 1, T, T + 1, 3 * T + 5, window - 1,
              window + 1):
        for reverse in (False, True):
            want, want_total = fr_scan_plain(fc, a[:, :n], op, reverse)
            for steps in windows:
                out, total = run(aw, n_max, 1, n, reverse, True, steps)
                assert np.array_equal(out, _words(want)), (n, reverse)
                assert np.array_equal(total, _words(want_total)), (n,
                                                                   reverse)
                _, total = run(aw, n_max, 1, n, reverse, False, steps)
                assert np.array_equal(total, _words(want_total)), (n,
                                                                   reverse)
    n = 3 * T + 5
    col = aw[:, 3:].copy()              # column 0 of col is column 3 of a
    want, want_total = fr_scan_plain(fc, a[:, 3:4].expand(L, n), op)
    for steps in windows:
        out, total = run(col, col.shape[1], 0, n, False, True, steps)
        assert np.array_equal(out, _words(want))
        assert np.array_equal(total, _words(want_total))


def _exponent_words(e, limbs):
    return np.ascontiguousarray(ints_to_words([e], limbs)[:, 0])


def _host_pow(lib, fc, a, e):
    """fr_pow under g++ by the kernel's route for e, on (L, n) a."""
    aw = _words(a)
    out = np.empty_like(aw)
    lib.host_fr_pow(_ptr(aw), a.shape[1], _ptr(_exponent_words(
        e, fc.num_limbs)), e.bit_length(),
        ctypes.addressof(inv_consts(fc.modulus)), _ptr(out), fc.ptr)
    return out


@pytest.mark.parametrize("modulus", MODULI, ids=MODULUS_IDS)
def test_fr_pow(lib, modulus):
    """fr_pow against fr_pow_plain, under Fr and Fq, with e = 0 on a zero
    entry (one) and inverses of zero (zero): square-and-multiply on the
    PROD_CHAIN squaring and product for e in {0, 1, 2, 2^16, a random
    254-bit e}, the inversion route for e = p - 2 (a ragged tile)."""
    be = _backend(modulus)
    fc = FieldConsts(modulus)
    e_rand = random.Random(modulus % 997).getrandbits(254) | 1 << 253
    for e in (0, 1, 2, 1 << 16, e_rand, modulus - 2):
        assert lib.host_pow_route(_ptr(_exponent_words(e, fc.num_limbs)),
                                  fc.ptr) == (e == modulus - 2)
        a = be.from_ints(_random_field(modulus, 24, e % 1000))
        out = _host_pow(lib, fc, a, e)
        assert np.array_equal(out, _words(fr_pow_plain(fc, a, e))), e


@pytest.mark.parametrize("modulus", MODULI, ids=MODULUS_IDS)
def test_fr_pow_inversion_route(lib, modulus):
    """The inversion route (e = p - 2: each tile's pair trees and
    butterflies around one safegcd, as k_fr_inv runs them) against
    fr_pow_plain at widths 1, T - 1, T, T + 1 and 3 T + 5 (T the tile):
    0, 1, 2, p - 1 and R mod p among random values, zeros on both sides of
    the first tile edge, a tile of zeros and a zero in the ragged last
    tile.  The widths are prefixes of one array: the plain version is
    elementwise."""
    be = _backend(modulus)
    fc = FieldConsts(modulus)
    T = lib.host_scan_tile()
    n = 3 * T + 5
    vals = [0, 1, 2, modulus - 1, fc.R % modulus] + [
        random.Random(modulus % 991).randrange(1, modulus)
        for _ in range(n - 5)]
    vals[T - 1] = vals[T] = 0
    vals[2 * T:3 * T] = [0] * T
    vals[n - 2] = 0
    a = be.from_ints(vals)
    e = modulus - 2
    want = _words(fr_pow_plain(fc, a, e))
    for m in (1, T - 1, T, T + 1, n):
        out = _host_pow(lib, fc, a[:, :m].contiguous(), e)
        assert np.array_equal(out, want[:, :m]), m


@pytest.mark.parametrize("modulus", MODULI, ids=MODULUS_IDS)
def test_safegcd_inverse(lib, modulus):
    """The safegcd alone (csrc/inv.cuh fe_inv_raw, 8 or 12 words) against
    Python's pow(x, -1, p) on plain integers: 0 (to 0), 1, 2, p - 1, p - 2,
    R mod p, p // 2, 2^k below p, and random values."""
    fc = FieldConsts(modulus)
    L = fc.num_limbs
    vals = [0, 1, 2, modulus - 1, modulus - 2, fc.R % modulus,
            modulus // 2] + [1 << k for k in range(0, modulus.bit_length(),
                                                   37)]
    vals += _random_field(modulus, 200, 17)
    aw = ints_to_words(vals, L)
    out = np.empty_like(aw)
    lib.host_fe_inv(_ptr(aw), _ptr(out), len(vals),
                    inv_consts(modulus)[L], fc.ptr)
    assert words_to_ints(out) == [pow(v, -1, modulus) if v else 0
                                  for v in vals]


def _high_pairs(p, L, count, seed):
    """Random pairs (a, b) whose CIOS result before the final subtraction
    lies in [p, 2p): (a b + M p) / R >= p, M = -a b / p mod R."""
    R = 1 << (32 * L)
    rng = random.Random(seed)
    pinv = pow(-p, -1, R)
    out = []
    while len(out) < count:
        a, b = rng.randrange(p), rng.randrange(p)
        if (a * b + (a * b * pinv % R) * p) // R >= p:
            out.append((a, b))
    return out


@pytest.mark.parametrize("modulus", [C.BN254_P, C.BLS12_381_R,
                                     C.BLS12_381_P, C.BN254_R],
                         ids=["fq", "bls-fr", "bls-fq", "fr"])
def test_chain_product_and_square(lib, modulus):
    """The carry-chain Montgomery product and squaring (csrc/chain.cuh, the
    C++ mirror of its PTX) against mul_plain and Python integers: every
    pair of the adversarial values, random pairs whose result needs the
    final subtraction, and random pairs."""
    be = _backend(modulus)
    fc = be.consts
    L = fc.num_limbs
    adv = adversarial_values(modulus, L)
    pairs = [(x, y) for x in adv for y in adv]
    pairs += _high_pairs(modulus, L, 64, L)
    pairs += [(x, x) for x, _ in _high_pairs(modulus, L, 8, L + 1)]
    rand = _random_field(modulus, 128, 7)
    pairs += list(zip(rand, rand[::-1]))
    n = len(pairs)
    a = be.from_ints([x for x, _ in pairs])
    b = be.from_ints([y for _, y in pairs])
    aw, bw = _words(a), _words(b)
    out = np.empty_like(aw)
    lib.host_fe_chain(0, _ptr(aw), _ptr(bw), _ptr(out), n, fc.ptr)
    assert np.array_equal(out, _words(cuda_fr.mul_plain(fc, a, b)))
    assert be.to_ints(torch.from_numpy(out.view(np.int32))) == [
        x * y % modulus for x, y in pairs]
    lib.host_fe_chain(1, _ptr(aw), _ptr(aw), _ptr(out), n, fc.ptr)
    assert np.array_equal(out, _words(cuda_fr.mul_plain(fc, a, a)))


def _edge_points(curve, k=16, curve_type="bn254"):
    """Random points, their doubles' inputs, negatives and the identity."""
    pts, _ = random_point_basis(curve_type, k, seed=11, device="cpu")
    f = curve.f
    neg = torch.stack([pts[0], f.neg(pts[1]), pts[2]])
    ident = curve.identity((k,))
    dbl = curve.double(pts)
    p = torch.cat([pts, pts, pts, ident, dbl, ident], dim=-1)
    q = torch.cat([pts.roll(1, -1), pts, neg, pts, pts, ident], dim=-1)
    return p.contiguous(), q.contiguous()


def test_g1_add_double(lib):
    _check_add_double(lib, "bn254")


def test_g1_add_double_bls(lib):
    """K6 and K7 at 12 words, and K9 (the complete mixed add) with q the
    rolled points and with q = p's own points (the doubling case)."""
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    fc = _check_add_double(lib, "bls12_381")
    curve = curve_ops("bls12_381", "cpu")
    p, q = _edge_points(curve, 8, "bls12_381")
    m = p.shape[-1]
    pw = _words(p)
    for qq in (q, p):
        qx = _words(qq[0].contiguous())
        qy = _words(qq[1].contiguous())
        qq_aff = curve.to_affine_ints(qq)
        if any(a is None for a in qq_aff):   # q must be finite: Z = 1
            norm = [a or (1, 1) for a in qq_aff]
            qq = curve.from_affine_ints([a[0] for a in norm],
                                        [a[1] for a in norm])
            qx, qy = _words(qq[0]), _words(qq[1])
        out = np.empty_like(pw)
        lib.host_g1_add_mixed(_ptr(pw), _ptr(qx), _ptr(qy), m, _ptr(out), m,
                              fc.ptr)
        want = cuda_fr.g1_add_mixed_plain(fc, p, qq[0].contiguous(),
                                          qq[1].contiguous())
        assert np.array_equal(out, _words(want))


def _check_add_double(lib, curve_type):
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    curve = curve_ops(curve_type, "cpu")
    fc = curve.f.consts
    p, q = _edge_points(curve, 16 if curve_type == "bn254" else 8,
                        curve_type)
    m = p.shape[-1]
    pw, qw = _words(p), _words(q)
    out = np.empty_like(pw)
    lib.host_g1_add(_ptr(pw), _ptr(qw), _ptr(out), m, fc.ptr)
    assert np.array_equal(out, _words(cuda_fr.g1_add_plain(fc, p, q)))
    lib.host_g1_double(_ptr(pw), _ptr(out), m, fc.ptr)
    assert np.array_equal(out, _words(cuda_fr.g1_double_plain(fc, p)))
    return fc


@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_g1_add_and_mixed_edge_batches(lib, curve_type):
    """K6 and K9 as their kernels run them (the PROD_CHAIN policy, under
    g++) against the plain versions on ``edge_batches``: identity
    operands, P = Q, P = -Q, the mixed add's doubling, q with a column
    period of m and of 1, and coordinates of adversarial field values."""
    fc = fq_backend(curve_type, "cpu").consts
    pts, _ = random_point_basis(curve_type, 8, seed=13, device="cpu")
    cases = edge_batches(curve_type, pts)
    p, q = cases["add"]
    m = p.shape[-1]
    pw, qw = _words(p), _words(q)
    out = np.empty_like(pw)
    lib.host_g1_add(_ptr(pw), _ptr(qw), _ptr(out), m, fc.ptr)
    assert np.array_equal(out, _words(cuda_fr.g1_add_plain(fc, p, q)))
    for acc, qx, qy in cases["mixed"]:
        m, qn = acc.shape[-1], qx.shape[-1]
        aw, xw, yw = _words(acc), _words(qx), _words(qy)
        out = np.empty_like(aw)
        lib.host_g1_add_mixed(_ptr(aw), _ptr(xw), _ptr(yw), qn, _ptr(out),
                              m, fc.ptr)
        want = cuda_fr.g1_add_mixed_plain(fc, acc, qx, qy)
        assert np.array_equal(out, _words(want)), qn


@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_g1_double_edge_batches(lib, curve_type):
    """K7 as its kernel runs it (dbl-2009-l on the PROD_CHAIN squaring and
    product, under g++) against its plain version on the points of
    ``edge_batches``: identities, Jacobian representatives with
    adversarial Z, and adversarial triples."""
    fc = fq_backend(curve_type, "cpu").consts
    pts, _ = random_point_basis(curve_type, 8, seed=19, device="cpu")
    p, q = edge_batches(curve_type, pts)["add"]
    batch = torch.cat([p, q], dim=-1).contiguous()
    m = batch.shape[-1]
    bw = _words(batch)
    out = np.empty_like(bw)
    lib.host_g1_double(_ptr(bw), _ptr(out), m, fc.ptr)
    assert np.array_equal(out, _words(cuda_fr.g1_double_plain(fc, batch)))


def _ladder_sets(curve_type, n):
    """n points of ``random_point_basis`` and the three scalar sets (3, 8,
    n) of ``edge_scalar_sets``."""
    pts, ks = random_point_basis(curve_type, n, seed=23 + n, device="cpu")
    sc = torch.stack([to_tensor(ints_to_words(s), "cpu")
                      for s in edge_scalar_sets(curve_type, ks, n)])
    return pts, sc


def _host_ladder(lib, fc, pts, sc, tree):
    k, S, sp = sc.shape
    n = pts.shape[-1]
    pw, sw = _words(pts), _words(sc)
    out = np.empty((3, fc.num_limbs, k if tree else k * n), dtype=np.uint32)
    assert lib.host_g1_ladder(_ptr(pw), _ptr(sw), S, sp, _ptr(out), n, k,
                              int(tree), fc.ptr) == 0
    return out


@pytest.mark.parametrize("n", [1, 7, 16])
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_g1_ladder(lib, curve_type, n):
    """The ladder kernel's body and halving tree (PROD_CHAIN, under g++)
    against ``g1_ladder_plain`` (the JAX row loop, then
    ``CurveOps.tree_sum``), exact words: k = 1 and 3 sets
    (``edge_scalar_sets``: random; 0, 1, r - 1 and a duplicate; a set
    summing to the identity), one scalar of column period 1 for every
    point, and the per-point form."""
    fc = fq_backend(curve_type, "cpu").consts
    pts, sc = _ladder_sets(curve_type, n)
    want = cuda_fr.g1_ladder_plain(fc, pts, sc, tree=False)
    out = _host_ladder(lib, fc, pts, sc, tree=False)
    assert np.array_equal(out, _words(want.reshape(3, fc.num_limbs, -1)))
    want = cuda_fr.g1_ladder_plain(fc, pts, sc)
    for k in (1, 3):           # the sets are independent: set 0 alone
        assert np.array_equal(_host_ladder(lib, fc, pts, sc[:k], True),
                              _words(want[..., :k]))
    if n >= 2:
        from kzg_snark_tpu_torch.ops.g1 import curve_ops
        curve = curve_ops(curve_type, "cpu")
        assert curve.to_affine_ints(want)[2] is None
    period1 = sc[:1, :, -1:].contiguous()
    for tree in (True, False):
        want = cuda_fr.g1_ladder_plain(fc, pts, period1, tree)
        assert np.array_equal(_host_ladder(lib, fc, pts, period1, tree),
                              _words(want.reshape(3, fc.num_limbs, -1)))


# (log2 n as a function of T, the library's tile bits at 2^16; tile bits,
# or None for the plan's at that n): sizes below, at and above one such
# tile, two-pass plans with each tile the plan chooses (8, 9 and 10 bits)
# and with the largest a pass takes (11, NTT_MAX_TILE_BITS), and tiny
# tiles that give three- to five-pass plans at n <= 2^9.
NTT_PASS_CASES = {
    "2": (lambda T: 1, None), "8": (lambda T: 3, None),
    "32": (lambda T: 5, None), "T/2": (lambda T: T - 1, None),
    "T": (lambda T: T, None), "2T": (lambda T: T + 1, None),
    "2^15": (lambda T: 15, None), "2^5-t2": (lambda T: 5, 2),
    "2^9-t2": (lambda T: 9, 2), "2^8-t3": (lambda T: 8, 3),
    "2^9-t3": (lambda T: 9, 3), "2^9-t8": (lambda T: 9, 8),
    "2^10-t9": (lambda T: 10, 9), "2^11-t10": (lambda T: 11, 10),
    "2^12-t11": (lambda T: 12, 11),
}
PLAN_TILES = (8, 9, 10, 11)     # the tiles of the cases above


@pytest.mark.parametrize("case", list(NTT_PASS_CASES))
def test_ntt_pass(lib, case):
    """Every pass of the plan, under g++ (the kernel's tile load, twiddle
    staging, butterflies on the PROD_CHAIN product and store, block after
    block), against ntt_pass_plain on the pass's input, out of place and in
    place, with the forward and inverse tables."""
    log_n, t = NTT_PASS_CASES[case]
    k = log_n(lib.host_ntt_tile(16))
    _check_ntt_pass(lib, "bn254", 1 << k, t or lib.host_ntt_tile(k))


def test_ntt_tile_choice(lib):
    """The plan's tile by size: at 2^14..2^18, where tiles were measured,
    the fastest there (8, 8, 9, 10, 10 bits); elsewhere the fixed 10-bit
    tile, so one pass up to 2^10, two to 2^20 and three above.  Every
    tile is one that test_ntt_pass covers."""
    measured = {14: 8, 15: 8, 16: 9, 17: 10, 18: 10}
    for k in range(1, 23):
        t = lib.host_ntt_tile(k)
        assert t == measured.get(k, 10) and t in PLAN_TILES, (k, t)
        assert -(-k // t) == (1 if k <= 10 else 2 if k <= 20 else 3), (k, t)


@pytest.mark.parametrize("log_n, t", [(5, None), (9, 3)],
                         ids=["32", "2^9-t3"])
def test_ntt_pass_bls(lib, log_n, t):
    """The pass at BLS12-381 Fr (255 bits, two-adicity 32)."""
    _check_ntt_pass(lib, "bls12_381", 1 << log_n,
                    t or lib.host_ntt_tile(log_n))


def _check_ntt_pass(lib, curve_type, n, t):
    ctx = ntt_context(curve_type, n, "cpu")
    fc = ctx.backend.consts
    x = ctx.backend.from_ints(_random_field(fc.modulus, n, n))
    for tw in (ctx.tw_fwd, ctx.tw_inv):
        tww = _words(tw)
        y = x
        for s0, g in pass_plan(n, t):
            yw = _words(y).copy()
            y = ntt_pass_plain(fc, y, tw, s0, g)
            out = np.empty_like(yw)
            lib.host_ntt_pass(_ptr(yw), _ptr(out), _ptr(tww), n, s0, g, t,
                              fc.ptr)
            assert np.array_equal(out, _words(y)), (s0, g)
            lib.host_ntt_pass(_ptr(yw), _ptr(yw), _ptr(tww), n, s0, g, t,
                              fc.ptr)
            assert np.array_equal(yw, _words(y)), (s0, g)


@pytest.mark.parametrize("log_n", range(4, 21))
def test_staged_transform_launches(lib, monkeypatch, log_n):
    """On a device other than the CPU, staged_transform makes ceil(log2 n
    / t) ntt_pass launches, at most 2, the stages of each following the
    last's, the first out of place and the rest in place.  ntt_pass is
    replaced by a fake that records each call and returns a tensor on the
    meta device, which holds no data; t is the library's tile for n."""
    T = lib.host_ntt_tile(log_n)
    calls = []

    def fake_pass(fc, x, tw, s0, g, t, out=None):
        calls.append((s0, g, t, out is x))
        return torch.empty_like(x) if out is None else out

    monkeypatch.setattr(ntt_stage, "tile_bits",
                        lambda n: lib.host_ntt_tile(n.bit_length() - 1))
    monkeypatch.setattr(ntt_stage, "ntt_pass", fake_pass)
    n = 1 << log_n
    x = torch.empty((8, n), dtype=torch.int32, device="meta")
    tw = torch.empty((8, n // 2), dtype=torch.int32, device="meta")
    out = ntt_stage.staged_transform(fr_backend("bn254", "cpu").consts, x,
                                     tw)
    assert out.device.type == "meta" and out.shape == (8, n)
    assert len(calls) == -(-log_n // T) <= 2
    assert [c[0] for c in calls] == [sum(c[1] for c in calls[:i])
                                     for i in range(len(calls))]
    assert sum(c[1] for c in calls) == log_n
    assert all(c[1] <= T and c[2] == T for c in calls)
    assert [c[3] for c in calls] == [False] + [True] * (len(calls) - 1)


@pytest.mark.parametrize("c, windows", [(8, 32), (3, 5), (3, 46), (1, 3)])
def test_g1_fixed_base_table(lib, c, windows):
    """The table kernel in its order under g++ (the window bases' chain on
    the lanes, a level's products one after another; then each row group's
    windows, the step doubled on the lanes and the adds thread by thread)
    against fixed_base_table_plain: equal Jacobian words at the SRS build's
    c = 8, W = 32, at small shapes, past the launch's 45 row groups (a
    group's second window) and at c = 1 (no level)."""
    _check_table(lib, "bn254", c, windows)


@pytest.mark.parametrize("c, windows", [(8, 32), (3, 5), (3, 46)])
def test_g1_fixed_base_table_bls(lib, c, windows):
    """The table at 12 words, of BLS12-381's generator."""
    _check_table(lib, "bls12_381", c, windows)


def _check_table(lib, curve_type, c, windows):
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    curve = curve_ops(curve_type, "cpu")
    fc = curve.f.consts
    L = fc.num_limbs
    g1 = C.BN254_G1 if curve_type == "bn254" else C.BLS12_381_G1
    base = curve.from_affine_ints([g1[0]], [g1[1]]).contiguous()
    want = fixed_base_table_plain(fc, base, c, windows)
    assert want.shape == (3, L, windows, 1 << c)
    out = np.empty((3, L, windows << c), dtype=np.uint32)
    lib.host_g1_fixed_base_table(_ptr(_words(base)), _ptr(out), windows, c,
                                 fc.ptr)
    assert np.array_equal(out, _words(want).reshape(3, L, -1))


@functools.lru_cache(maxsize=None)
def _basis(n, curve_type="bn254"):
    return random_point_basis(curve_type, n, seed=3, device="cpu")[0]


def _schedule(n, sets, chunk, events, seed, curve_type="bn254"):
    """Points, c, W and the bucket schedule of ``sets`` scalar sets with a
    run of equal scalars (heavy buckets) and half zeros."""
    pts = _basis(n, curve_type)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(sets, 8, n), dtype=np.uint64)
    words[:, 7] &= (1 << 29) - 1
    words[0, :, :n // 2] = words[0, :, :1]
    words[-1, :, 1::2] = 0
    scalars = to_tensor(words.astype(np.uint32), "cpu")
    c = window_bits(n)
    bits = fr_backend(curve_type, "cpu").modulus.bit_length()
    dig = signed_digits(scalars, bits, c)
    return pts, c, dig.shape[1], bucket_schedule(dig, c, chunk, events)


@pytest.mark.parametrize("complete", [False, True])
def test_msm_accumulate(lib, complete):
    _check_accumulate(lib, complete, "bn254")


@pytest.mark.parametrize("complete", [False, True])
def test_msm_accumulate_bls(lib, complete):
    """The accumulate at 12 words (its 16-byte point loads are the
    kernel's own; the entry arithmetic is this body's)."""
    _check_accumulate(lib, complete, "bls12_381")


def _check_accumulate(lib, complete, curve_type):
    pts, _, _, s = _schedule(64, 2, 4, 4, 4, curve_type)
    fc = fq_backend(curve_type, "cpu").consts
    xy = point_table(pts)
    part = msm_accumulate_plain(fc, xy, s.entries, s.chunk_off, complete)
    out = np.empty(tuple(part.shape), dtype=np.uint32)
    xyw, ent, off = _words(xy), _words(s.entries), _words(s.chunk_off)
    lib.host_msm_accumulate(_ptr(xyw), _ptr(ent), _ptr(off), None,
                            part.shape[-1], part.shape[-1], _ptr(out),
                            int(complete), fc.ptr)
    assert np.array_equal(out, _words(part))


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_msm_accumulate_structured(lib, curve_type, complete):
    """The accumulate on [(i + 1) G] with every scalar 1: window 0's bucket
    1 holds every point in index order, so the running sum G + 2G meets
    3G (the complete add's doubling; the incomplete add's identity), and
    the other windows are empty."""
    n = 136
    pts = generator_multiples(curve_type, n, "cpu")
    fc = fq_backend(curve_type, "cpu").consts
    ones = torch.zeros((1, 8, n), dtype=torch.int32)
    ones[0, 0] = 1
    c = 8
    bits = fr_backend(curve_type, "cpu").modulus.bit_length()
    s = bucket_schedule(signed_digits(ones, bits, c), c)
    xy = point_table(pts)
    part = msm_accumulate_plain(fc, xy, s.entries, s.chunk_off, complete)
    out = np.empty(tuple(part.shape), dtype=np.uint32)
    lib.host_msm_accumulate(_ptr(_words(xy)), _ptr(_words(s.entries)),
                            _ptr(_words(s.chunk_off)), None, part.shape[-1],
                            part.shape[-1], _ptr(out), int(complete), fc.ptr)
    assert np.array_equal(out, _words(part))
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    first = curve_ops(curve_type, "cpu").to_affine_ints(part[..., :1])[0]
    want = curve_ops(curve_type, "cpu").to_affine_ints(
        pts[..., 135:136])[0]                     # G + ... + 16 G = 136 G
    assert (first == want) == complete


@pytest.mark.parametrize("n, sets, chunk, events",
                         [(64, 2, 4, 4), (64, 1, 2, 32), (256, 1, 1, 1)],
                         ids=["two-sets", "few-threads", "two-blocks"])
def test_msm_reduce(lib, n, sets, chunk, events):
    """The window-sum launch (pieces of events, block tree) and the Horner
    launch; "two-blocks" has 256 threads a window, two blocks of 128."""
    _check_reduce(lib, n, sets, chunk, events, "bn254")


def test_msm_reduce_bls(lib):
    """The reduction at 12 words, two scalar sets; 255-bit scalars make
    W = ceil(256 / c) windows."""
    _check_reduce(lib, 64, 2, 4, 4, "bls12_381")


def _check_reduce(lib, n, sets, chunk, events, curve_type):
    pts, c, W, s = _schedule(n, sets, chunk, events, 5, curve_type)
    if n == 256:
        assert s.window_threads == 256
    fc = fq_backend(curve_type, "cpu").consts
    part = msm_accumulate_plain(fc, point_table(pts), s.entries, s.chunk_off,
                                True)
    wp = window_sums_plain(fc, part, s.bucket_chunks, sets * W, c,
                           s.window_threads)
    out = np.empty(tuple(wp.shape), dtype=np.uint32)
    pw, bw = _words(part), _words(s.bucket_chunks)
    lib.host_msm_window_sums(_ptr(pw), part.shape[-1], _ptr(bw), sets * W,
                             1 << (c - 1), c, s.window_threads, _ptr(out),
                             fc.ptr)
    assert np.array_equal(out, _words(wp))
    res = horner_plain(fc, wp, sets, W, c)
    got = np.empty(tuple(res.shape), dtype=np.uint32)
    lib.host_msm_horner(_ptr(out), sets, W, wp.shape[-1] // (sets * W), c,
                        _ptr(got), fc.ptr)
    assert np.array_equal(got, _words(res))


FOLD_C, FOLD_W, FOLD_SETS = 8, 32, 4   # c = 8: W = ceil(255 / 8) = 32


@pytest.mark.parametrize("pieces", [1, 3, 4])
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_msm_fold_edge_cases(lib, curve_type, pieces):
    """The fold launch (the window totals' halving tree, then the Horner
    fold on a warp's lanes) at W = 32, c = 8 on the four sets of
    ``fold_edge_partials``: a window total equal to the running
    accumulator (the complete add's doubling), its opposite, empty windows,
    every partial the identity, distinct points; one, three (an odd tree
    level) and four pieces a window.  Word for word against
    ``horner_plain``, and by the host curve: set 0 is
    2^(c (W - 1) + 1) P, sets 1 and 2 the identity, set 3 the sum of
    2^(c w) times its window's partials."""
    from kzg_snark_tpu_torch.ops.g1 import curve_ops, generator
    from kzg_snark_tpu_torch.ops.host import curve as hc
    from kzg_snark_tpu_torch.ops.host.field import base_field

    c, W, sets = FOLD_C, FOLD_W, FOLD_SETS
    k = W * pieces
    pts, ks = random_point_basis(curve_type, k + 1, seed=12, device="cpu")
    curve = curve_ops(curve_type, "cpu")
    fc = curve.f.consts
    wp = fold_edge_partials(curve_type, pts, c, W, pieces)
    want = horner_plain(fc, wp, sets, W, c)
    got = np.empty(tuple(want.shape), dtype=np.uint32)
    lib.host_msm_horner(_ptr(_words(wp)), sets, W, pieces, c, _ptr(got),
                        fc.ptr)
    assert np.array_equal(got, _words(want))
    r = C.BN254_R if curve_type == "bn254" else C.BLS12_381_R
    Fp = base_field(curve_type)
    gx, gy = generator(curve_type)

    def times_g(e):
        a = hc.normalize(hc.multiply((Fp(gx), Fp(gy), Fp(1)), e % r))
        return None if a is None else (int(a[0]), int(a[1]))

    # The partials are 2 P_i (doubled), P_i = k_i G.
    set3 = sum((2 * ks[j]) << (c * (j // pieces)) for j in range(k))
    assert curve.to_affine_ints(want) == [
        times_g(2 * ks[k] << (c * (W - 1) + 1)), None, None, times_g(set3)]


@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_msm_reduce_zero_set_w32(lib, curve_type):
    """Both reduce launches at c = 8 (W = 32 windows) on two sets, one of
    random scalars and one all zero (every window empty)."""
    n = 256
    pts = _basis(n, curve_type)
    rng = np.random.default_rng(13)
    words = rng.integers(0, 1 << 32, size=(2, 8, n), dtype=np.uint64)
    words[:, 7] &= (1 << 29) - 1
    words[1] = 0
    scalars = to_tensor(words.astype(np.uint32), "cpu")
    c = FOLD_C
    bits = fr_backend(curve_type, "cpu").modulus.bit_length()
    dig = signed_digits(scalars, bits, c)
    W = dig.shape[1]
    assert W == FOLD_W
    s = bucket_schedule(dig, c, 4, 4)
    fc = fq_backend(curve_type, "cpu").consts
    part = msm_accumulate_plain(fc, point_table(pts), s.entries, s.chunk_off,
                                True)
    wp = window_sums_plain(fc, part, s.bucket_chunks, 2 * W, c,
                           s.window_threads)
    out = np.empty(tuple(wp.shape), dtype=np.uint32)
    lib.host_msm_window_sums(_ptr(_words(part)), part.shape[-1],
                             _ptr(_words(s.bucket_chunks)), 2 * W,
                             1 << (c - 1), c, s.window_threads, _ptr(out),
                             fc.ptr)
    assert np.array_equal(out, _words(wp))
    res = horner_plain(fc, wp, 2, W, c)
    got = np.empty(tuple(res.shape), dtype=np.uint32)
    lib.host_msm_horner(_ptr(out), 2, W, wp.shape[-1] // (2 * W), c,
                        _ptr(got), fc.ptr)
    assert np.array_equal(got, _words(res))
    assert (res[2, :, 1] == 0).all() and not (res[2, :, 0] == 0).all()


def test_chain_ptx_is_generated():
    """csrc/chain_ptx.cuh is what utils/gen_chain_ptx.py writes."""
    from kzg_snark_tpu_torch.utils import gen_chain_ptx
    with open(gen_chain_ptx.OUT) as fh:
        assert fh.read() == gen_chain_ptx.render()


def _ptx_steps():
    """{(W, step): [(lines, outputs, inputs)]} parsed from chain_ptx.cuh."""
    import re

    from kzg_snark_tpu_torch.utils import gen_chain_ptx
    text = open(gen_chain_ptx.OUT).read()
    steps = {}
    for w, body in re.findall(r"struct ChainPtx<(\d+)> \{(.*?)\n\};", text,
                              re.S):
        for name, fn in re.findall(r"void (\w+)\([^)]*\) \{(.*?)\n  \}",
                                   body, re.S):
            blocks = []
            for asm in re.findall(r"asm volatile\((.*?)\);", fn, re.S):
                lines = [ln.strip() for ln in re.findall(r'"(.*?)\\n\\t"',
                                                         asm)]
                outs, ins = re.split(r"\n\s*: ", asm.split('"}"')[1])[1:3]
                blocks.append((lines, re.findall(r'"(=r|\+r)"\(([^)]*)\)',
                                                 outs),
                               re.findall(r'"r"\((\(.*?\)|[^()]*)\)', ins)))
            steps[int(w), name] = blocks
    return steps


def _run_ptx(blocks, env):
    """Interpret the blocks' PTX (the instructions the generator emits) on
    Python integers; env maps C names ("t", "a", "b"...) to lists or ints."""
    import re
    M = (1 << 32) - 1

    def get(expr):
        m = re.fullmatch(r"\((\w+)\[(\d+)\] << 1\)", expr)
        if m:
            return (env[m[1]][int(m[2])] << 1) & M
        m = re.fullmatch(r"(\w+)\[(\d+)\]", expr)
        return env[m[1]][int(m[2])] if m else env[expr]

    def put(expr, v):
        m = re.fullmatch(r"(\w+)\[(\d+)\]", expr)
        if m:
            env[m[1]][int(m[2])] = v
        else:
            env[expr] = v

    for lines, outs, ins in blocks:
        modes = [m for m, _ in outs] + ["r"] * len(ins)
        ops = [e for _, e in outs] + ins
        regs = {f"%{i}": None if m == "=r" else get(e)
                for i, (m, e) in enumerate(zip(modes, ops))}
        cf, pred = None, {}

        def val(x):
            if x in regs:
                assert regs[x] is not None, f"output read before written"
                return regs[x]
            return int(x, 0)

        for line in lines:
            line = line.strip("{} ").rstrip(";")
            if not line or line.startswith(".reg"):
                continue
            op, args = line.split(None, 1)
            a = [x.strip() for x in args.split(",")]
            parts = op.split(".")
            base, cc = parts[0], ".cc" in op
            if base == "setp":
                pred[a[0]] = val(a[1]) == val(a[2])
                continue
            if base == "selp":
                regs[a[0]] = val(a[1]) if pred[a[3]] else val(a[2])
                continue
            carry_in = base in ("madc", "addc", "subc")
            if carry_in:
                assert cf is not None, f"carry read before set: {line}"
            cin = cf if carry_in else 0
            if base in ("mul", "mad", "madc"):
                prod = val(a[1]) * val(a[2])
                half = prod & M if parts[1] == "lo" else prod >> 32
                s = half + (val(a[3]) if base != "mul" else 0) + cin
            elif base in ("add", "addc"):
                s = val(a[1]) + val(a[2]) + cin
            else:
                s = val(a[1]) - val(a[2]) - cin
            regs[a[0]] = s & M
            if cc:
                cf = int(s > M) if base != "sub" and base != "subc" \
                    else int(s < 0)
            elif carry_in or base in ("mad", "add", "sub"):
                cf = None           # a flag not set by .cc is not kept
        for i, (_, e) in enumerate(outs):
            put(e, regs[f"%{i}"])


@pytest.mark.parametrize("modulus", [C.BN254_P, C.BLS12_381_R,
                                     C.BLS12_381_P],
                         ids=["8-words", "8-words-255-bits", "12-words"])
def test_chain_ptx_interpreted(modulus):
    """The generated PTX steps, interpreted instruction by instruction on
    Python integers (the carry flag lives only inside its asm block), run
    through fe_mul_chain's and fe_sqr_chain's step order, give the
    Montgomery product and square on the adversarial values and random
    ones.  nvcc is checked on the card; this checks the PTX text."""
    fc = FieldConsts(modulus)
    W, p = fc.num_limbs, modulus
    R = 1 << (32 * W)
    steps = _ptx_steps()
    pw = [(p >> (32 * j)) & 0xFFFFFFFF for j in range(W)]
    pinv = -pow(p, -1, 1 << 32) % (1 << 32)
    words = lambda v, n: [(v >> (32 * j)) & 0xFFFFFFFF  # noqa: E731
                          for j in range(n)]
    vals = adversarial_values(p, W)
    pairs = [(x, y) for x in vals for y in vals[::3]]
    pairs += _high_pairs(p, W, 16, 3) + list(zip(
        _random_field(p, 16, 8), _random_field(p, 16, 9)))
    for x, y in pairs:
        # fe_mul_chain's order: the first row in C, then the PTX steps.
        bw = words(y, W)
        ev, od = [0] * W, [0] * W
        for j in range(0, W, 2):
            ev[j], ev[j + 1] = words(words(x, W)[j] * bw[0], 2)
            od[j], od[j + 1] = words(words(x, W)[j + 1] * bw[0], 2)
        env = {"a": words(x, W), "p": pw}

        def reduce(e, o):
            env.update(e=e, o=o, m=e[0] * pinv % (1 << 32))
            _run_ptx(steps[W, "pm_reduce_odd"], env)
            _run_ptx(steps[W, "pm_reduce_even"], env)
            assert env["e"][0] == 0

        reduce(ev, od)
        for i in range(1, W):
            e, o = (od, ev) if i % 2 else (ev, od)
            env.update(e=e, o=o, b=bw[i])
            _run_ptx(steps[W, "pm_shift_odd"], env)
            _run_ptx(steps[W, "pm_even"], env)
            reduce(e, o)
        env.update(e=ev, o=od)
        _run_ptx(steps[W, "pm_merge"], env)
        env["t"] = ev + [0]
        _run_ptx(steps[W, "final_sub"], env)
        got = sum(v << (32 * j) for j, v in enumerate(env["t"][:W]))
        assert got == x * y * pow(R, -1, p) % p, (x, y)
        aw = words(x, W)
        a2 = [(aw[0] << 1) & 0xFFFFFFFF] + [
            ((aw[j] << 1) | (aw[j - 1] >> 31)) & 0xFFFFFFFF
            for j in range(1, W)]
        env = {"ce": [0] * (2 * W), "co": [0] * (2 * W - 1), "k": [0] * W,
               "a": aw, "a2": a2, "p": pw, "pinv": pinv, "kk": 0, "m": 0}
        _run_ptx(steps[W, "sq_products"], env)
        assert sum(v << (32 * j) for j, v in enumerate(env["ce"])) + sum(
            v << (32 * j + 32) for j, v in enumerate(env["co"])) + sum(
            v << (32 * (W + j)) for j, v in enumerate(env["k"])) == x * x
        _run_ptx(steps[W, "sq_redc"], env)
        env["t"] = env["ce"][W:] + [0]
        _run_ptx(steps[W, "final_sub"], env)
        got = sum(v << (32 * j) for j, v in enumerate(env["t"][:W]))
        assert got == x * x * pow(R, -1, p) % p, x


# The range route (one accumulate thread a run of L sorted entries, a
# partial at each bucket end): its offsets, its walk and the window sums
# over its partials, on the CPU at c = 5 (16 buckets a window), where 600
# points load each bucket with about 37 entries.
RANGE_N, RANGE_C = 600, 5


def _range_case(curve_type, seed=8):
    """Points, W and the digits of three sets at c = 5: the first with
    half its scalars equal (a heavy bucket a window, spanning several runs
    of every L below 300), one random, one all zero (every window empty);
    the top window holds a few heavy buckets."""
    n, c = RANGE_N, RANGE_C
    pts = _basis(n, curve_type)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(3, 8, n), dtype=np.uint64)
    words[:, 7] &= (1 << 29) - 1
    words[0, :, :n // 2] = words[0, :, :1]
    words[2] = 0
    bits = fr_backend(curve_type, "cpu").modulus.bit_length()
    dig = signed_digits(to_tensor(words.astype(np.uint32), "cpu"), bits, c)
    return pts, dig.shape[1], dig


@pytest.mark.parametrize("run", [0, 1, 4, 32, 128])
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_msm_bucket_offsets_routes(lib, curve_type, run):
    """``msm_chunks.cuh`` under g++ a bucket at a time, as the offsets
    kernels run it, against the plain offsets and ``bucket_schedule``:
    the chunk route (run 0) and runs of 1, 4, 32 and 128 entries, so a
    bucket spans several runs and a run several buckets (the top window's
    few heavy ones, the empty windows of the all-zero set)."""
    from kzg_snark_tpu_torch.ops import msm_kernel as mk
    _, W, dig = _range_case(curve_type)
    k, c = dig.shape[0], RANGE_C
    plan = mk.schedule_plan(k, RANGE_N, W, c)._replace(run=run)
    flat = dig.reshape(-1).to(torch.int64)
    mag = flat & mk.MAG_MASK
    seg = torch.arange(flat.numel()) // RANGE_N
    keys = torch.sort(torch.where(mag > 0, seg * plan.half + mag - 1,
                                  1 << 30))[0]
    E = int((mag > 0).sum())
    keys = keys.to(torch.int32)
    pay = torch.arange(keys.numel(), dtype=torch.int32) << 1
    base = torch.tensor([0] * plan.segments + [E], dtype=torch.int32)
    hp = np.ascontiguousarray(pay[:E].numpy())
    bco, chunk_off, runs, info = mk.msm_bucket_offsets_plain(keys, pay, base,
                                                             plan)
    hb = np.zeros(plan.buckets + 1, np.int32)
    hc = np.zeros(plan.chunk_capacity, np.int32)
    hr = np.zeros(plan.run_capacity, np.int32)
    hi = np.zeros(3, np.int32)
    kw = np.ascontiguousarray(keys[:E].numpy())
    assert lib.host_msm_bucket_offsets(
        _ptr(kw), E, plan.segments, plan.half, mk.CHUNK, run, _ptr(hb),
        _ptr(hc), _ptr(hr), _ptr(hp), _ptr(hi)) == 0
    C = int(info[0])
    assert np.array_equal(hi, info.numpy()) and int(info[2]) == E
    # The chunk-start bits: on the range route at every chunk's first
    # entry, on the chunk route none.
    assert np.array_equal(hp, pay[:E].numpy())
    assert int((pay[:E] < 0).sum()) == (C if run else 0)
    assert np.array_equal(hb, bco.numpy())
    assert np.array_equal(hc[:C + 1], chunk_off[:C + 1].numpy())
    ref = bucket_schedule(dig, c, run=run)
    assert torch.equal(ref.chunk_off, chunk_off[:C + 1])
    assert torch.equal(ref.bucket_chunks, bco)
    if run:
        R = -(-E // run)
        assert np.array_equal(hr[:R + 1], runs[:R + 1].numpy())
        assert torch.equal(ref.run_chunks, runs[:R + 1])
        # Some bucket spans three runs or more; below L = 37 some run
        # crosses three buckets or more.
        per = bco.diff()
        assert int(per.max()) >= 3
        if run >= 32:
            assert int(runs.diff()[:R].max()) >= 3
    else:
        assert ref.run_chunks is None
        assert int(chunk_off[:C + 1].diff().max()) <= mk.CHUNK


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_msm_accumulate_range_walk(lib, curve_type, complete):
    """The accumulate's run walk under g++ (one thread a run of 32 entries:
    restarts at bucket ends, the prefetch across them) against the plain
    partials of the same chunks, both adds, both limb counts."""
    pts, _, dig = _range_case(curve_type)
    s = bucket_schedule(dig, RANGE_C, run=32)
    fc = fq_backend(curve_type, "cpu").consts
    xy = point_table(pts)
    part = msm_accumulate_plain(fc, xy, s.entries, s.chunk_off, complete)
    out = np.empty(tuple(part.shape), dtype=np.uint32)
    runs = s.run_chunks.numel() - 1
    lib.host_msm_accumulate(_ptr(_words(xy)), _ptr(_words(s.entries)),
                            _ptr(_words(s.chunk_off)),
                            _ptr(_words(s.run_chunks)), runs, part.shape[-1],
                            _ptr(out), int(complete), fc.ptr)
    assert np.array_equal(out, _words(part))


@pytest.mark.parametrize("run", [3, 32])
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_msm_accumulate_range_structured(lib, curve_type, run):
    """[(i + 1) G] with every scalar 1 on the range route with complete
    adds: window 0's bucket 1 holds all 136 points, cut every L entries, so
    each run restarts the bucket from its first point (Z = 1) and the first
    chunk's G + 2G meets 3G; the partials add up to 136 * 137 / 2 G."""
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    n, c = 136, 8
    pts = generator_multiples(curve_type, n, "cpu")
    fc = fq_backend(curve_type, "cpu").consts
    ones = torch.zeros((1, 8, n), dtype=torch.int32)
    ones[0, 0] = 1
    bits = fr_backend(curve_type, "cpu").modulus.bit_length()
    s = bucket_schedule(signed_digits(ones, bits, c), c, run=run)
    assert s.chunk_off.numel() - 1 == -(-n // run)
    xy = point_table(pts)
    part = msm_accumulate_plain(fc, xy, s.entries, s.chunk_off, True)
    out = np.empty(tuple(part.shape), dtype=np.uint32)
    lib.host_msm_accumulate(_ptr(_words(xy)), _ptr(_words(s.entries)),
                            _ptr(_words(s.chunk_off)),
                            _ptr(_words(s.run_chunks)),
                            s.run_chunks.numel() - 1, part.shape[-1],
                            _ptr(out), 1, fc.ptr)
    assert np.array_equal(out, _words(part))
    from kzg_snark_tpu_torch.ops.g1 import generator
    from kzg_snark_tpu_torch.ops.host import curve as hc
    from kzg_snark_tpu_torch.ops.host.field import base_field
    curve = curve_ops(curve_type, "cpu")
    total = part[..., :1]
    for j in range(1, part.shape[-1]):
        total = curve.add(total, part[..., j:j + 1])
    Fp = base_field(curve_type)
    gx, gy = generator(curve_type)
    a = hc.normalize(hc.multiply((Fp(gx), Fp(gy), Fp(1)), n * (n + 1) // 2))
    assert curve.to_affine_ints(total) == [(int(a[0]), int(a[1]))]
    # The first chunk is G + ... + L G = L (L + 1) / 2 G.
    a = hc.normalize(hc.multiply((Fp(gx), Fp(gy), Fp(1)),
                                 run * (run + 1) // 2))
    assert curve.to_affine_ints(part[..., :1]) == [(int(a[0]), int(a[1]))]


@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_msm_reduce_range_partials(lib, curve_type):
    """Both reduce launches under g++ over the range route's partials (L =
    32), whose windows hold fewer partials than the chunk route's; the
    result equals the chunk route's MSM."""
    pts, W, dig = _range_case(curve_type)
    k, c = dig.shape[0], RANGE_C
    fc = fq_backend(curve_type, "cpu").consts
    results = []
    for run in (32, 0):
        s = bucket_schedule(dig, c, run=run)
        part = msm_accumulate_plain(fc, point_table(pts), s.entries,
                                    s.chunk_off, True)
        wp = window_sums_plain(fc, part, s.bucket_chunks, k * W, c,
                               s.window_threads)
        out = np.empty(tuple(wp.shape), dtype=np.uint32)
        lib.host_msm_window_sums(_ptr(_words(part)), part.shape[-1],
                                 _ptr(_words(s.bucket_chunks)), k * W,
                                 1 << (c - 1), c, s.window_threads, _ptr(out),
                                 fc.ptr)
        assert np.array_equal(out, _words(wp))
        res = horner_plain(fc, wp, k, W, c)
        got = np.empty(tuple(res.shape), dtype=np.uint32)
        lib.host_msm_horner(_ptr(out), k, W, wp.shape[-1] // (k * W), c,
                            _ptr(got), fc.ptr)
        assert np.array_equal(got, _words(res))
        results.append(res)
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    curve = curve_ops(curve_type, "cpu")
    aff = [curve.to_affine_ints(r) for r in results]
    assert aff[0] == aff[1] and aff[0][2] is None
