"""The CUDA kernels' thread bodies, built for the CPU with g++, against the
plain PyTorch versions.

``csrc/host_check.cpp`` loops over the thread indices of each launch and
calls the same ``__host__ __device__`` code the kernels run, so this checks
the kernels' arithmetic and indexing on a machine without a card.  Exact
equality: the arithmetic is integer.  The bodies run at both limb counts
the kernels are instantiated at: 8 words (BN254, BLS12-381 Fr) and 12
(BLS12-381 Fq), chosen by the consts block as on the card.
"""

import functools
import random

import numpy as np
import pytest
import torch

from kzg_snark_tpu import constants as C
from kzg_snark_tpu_torch.ops import cuda_fr
from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
from kzg_snark_tpu_torch.ops.fr import fq_backend, fr_backend
from kzg_snark_tpu_torch.ops.limbs import (FieldConsts, ints_to_words,
                                           to_tensor, to_words)
from kzg_snark_tpu_torch.ops.msm_kernel import (bucket_schedule, horner_plain,
                                                msm_accumulate_plain,
                                                point_table, signed_digits,
                                                window_bits,
                                                window_sums_plain)
from kzg_snark_tpu_torch.ops.ntt import ntt_context
from kzg_snark_tpu_torch.ops import ntt_stage
from kzg_snark_tpu_torch.ops.ntt_stage import ntt_pass_plain, pass_plan
from kzg_snark_tpu_torch.ops.srs import fixed_base_table_plain
from kzg_snark_tpu_torch.ops.scan import fr_pow_plain, fr_scan_plain
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
    """The scan's tiling, element indexing, identity and fix-up thread body
    (csrc/scan.cuh) against fr_scan_plain: widths around one and two tiles,
    a total alone, and one column read with step 0.  The sums take zero
    entries; the products none, since a zero would make every later prefix
    zero and hide the tiles after it."""
    _check_scan(lib, fr_backend("bn254", "cpu"), op, reverse)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("op", [0, 1], ids=["mul", "add"])
def test_fr_scan_bls_fq(lib, op, reverse):
    """The scan's thread bodies at 12 words (BLS12-381 Fq)."""
    _check_scan(lib, fq_backend("bls12_381", "cpu"), op, reverse)


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
        lib.host_fr_scan(op, _ptr(aw), ld, 1, n, int(reverse), _ptr(out),
                         _ptr(total), fc.ptr)
        assert np.array_equal(out, _words(want)), n
        assert np.array_equal(total, _words(want_total)), n
        total[:] = 0
        lib.host_fr_scan(op, _ptr(aw), ld, 1, n, int(reverse), None,
                         _ptr(total), fc.ptr)
        assert np.array_equal(total, _words(want_total)), n
    n = tile + 3
    col = aw[:, 3:].copy()              # column 0 of col is column 3 of a
    want, _ = fr_scan_plain(fc, a[:, 3:4].expand(L, n), op, reverse)
    out = np.empty((L, n), dtype=np.uint32)
    lib.host_fr_scan(op, _ptr(col), col.shape[1], 0, n, int(reverse),
                     _ptr(out), None, fc.ptr)
    assert np.array_equal(out, _words(want))


@pytest.mark.parametrize("modulus", MODULI, ids=MODULUS_IDS)
def test_fr_pow(lib, modulus):
    """fr_pow's thread body against fr_pow_plain, under Fr and Fq, with
    e = 0 on a zero entry (one) and inverses of zero (zero)."""
    be = _backend(modulus)
    fc = FieldConsts(modulus)
    for e in (0, 1, 2, 1 << 16, modulus - 2):
        a = be.from_ints(_random_field(modulus, 24, e % 1000))
        aw = _words(a)
        ew = np.ascontiguousarray(_words(to_tensor(
            ints_to_words([e], fc.num_limbs), "cpu"))[:, 0])
        out = np.empty_like(aw)
        lib.host_fr_pow(_ptr(aw), 24, _ptr(ew), e.bit_length(), _ptr(out),
                        fc.ptr)
        assert np.array_equal(out, _words(fr_pow_plain(fc, a, e))), e


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


# (log2 n as a function of the library's tile bits T, tile bits or None
# for T): sizes below, at and above one tile with the library's tile, and
# tiny tiles that give three- to five-pass plans at n <= 2^9.
NTT_PASS_CASES = {
    "2": (lambda T: 1, None), "8": (lambda T: 3, None),
    "32": (lambda T: 5, None), "T/2": (lambda T: T - 1, None),
    "T": (lambda T: T, None), "2T": (lambda T: T + 1, None),
    "2^15": (lambda T: 15, None), "2^5-t2": (lambda T: 5, 2),
    "2^9-t2": (lambda T: 9, 2), "2^8-t3": (lambda T: 8, 3),
    "2^9-t3": (lambda T: 9, 3),
}


@pytest.mark.parametrize("case", list(NTT_PASS_CASES))
def test_ntt_pass(lib, case):
    """Every pass of the plan, under g++ (the kernel's tile load, twiddle
    staging, butterflies and store, block after block), against
    ntt_pass_plain on the pass's input, out of place and in place, with
    the forward and inverse tables."""
    log_n, t = NTT_PASS_CASES[case]
    T = lib.host_ntt_tile()
    _check_ntt_pass(lib, "bn254", 1 << log_n(T), t or T)


@pytest.mark.parametrize("log_n, t", [(5, None), (9, 3)],
                         ids=["32", "2^9-t3"])
def test_ntt_pass_bls(lib, log_n, t):
    """The pass at BLS12-381 Fr (255 bits, two-adicity 32)."""
    _check_ntt_pass(lib, "bls12_381", 1 << log_n, t or lib.host_ntt_tile())


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
    / t) ntt_pass launches, the stages of each following the last's, the
    first out of place and the rest in place.  ntt_pass is replaced by a
    fake that records each call and returns a tensor on the meta device,
    which holds no data; t is the library's NTT_TILE_BITS."""
    T = lib.host_ntt_tile()
    calls = []

    def fake_pass(fc, x, tw, s0, g, t, out=None):
        calls.append((s0, g, t, out is x))
        return torch.empty_like(x) if out is None else out

    monkeypatch.setattr(ntt_stage, "tile_bits", lambda: T)
    monkeypatch.setattr(ntt_stage, "ntt_pass", fake_pass)
    n = 1 << log_n
    x = torch.empty((8, n), dtype=torch.int32, device="meta")
    tw = torch.empty((8, n // 2), dtype=torch.int32, device="meta")
    out = ntt_stage.staged_transform(fr_backend("bn254", "cpu").consts, x,
                                     tw)
    assert out.device.type == "meta" and out.shape == (8, n)
    assert len(calls) == -(-log_n // T)
    assert [c[0] for c in calls] == [sum(c[1] for c in calls[:i])
                                     for i in range(len(calls))]
    assert sum(c[1] for c in calls) == log_n
    assert all(c[1] <= T and c[2] == T for c in calls)
    assert [c[3] for c in calls] == [False] + [True] * (len(calls) - 1)


@pytest.mark.parametrize("c, windows", [(8, 32), (3, 5)])
def test_g1_fixed_base_table(lib, c, windows):
    """The table kernel's chain, identities and levels, in its order under
    g++, against fixed_base_table_plain: equal Jacobian words at the SRS
    build's c = 8, W = 32 and at a small shape."""
    _check_table(lib, "bn254", c, windows)


@pytest.mark.parametrize("c, windows", [(8, 32), (3, 5)])
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
    lib.host_msm_accumulate(_ptr(xyw), _ptr(ent), _ptr(off), part.shape[-1],
                            _ptr(out), int(complete), fc.ptr)
    assert np.array_equal(out, _words(part))


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
