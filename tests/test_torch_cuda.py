"""Kernel wrappers: dispatch rules on any machine, kernels on the card.

Without a card: CPU tensors take the plain versions, and a tensor on any
other device never does (it goes to the kernel path, which checks its
operands and raises).  With a card (tests marked ``cuda``, skipped where
``torch.cuda.is_available()`` is false): every kernel entry point equals
its plain version on small numpy-seeded inputs and counts its launch
(K1, K6, K7, K9, K10, ntt_pass, the SRS table's g1_fixed_base_table, the
bucket route's msm_accumulate and msm_reduce, the chains' fr_scan and
fr_pow, and the small MSM's g1_ladder), at BN254 and at BLS12-381 (Fr in
8 words, Fq in the kernels' 12-word instantiation); and checked mode
(``KZG_TPU_CHECKED``) traps a planted non-canonical kernel output.
The full-size comparison is ``python3 chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from kzg_snark_tpu_torch.ops import cuda_fr
from kzg_snark_tpu_torch.ops.fr import fq_backend, fr_backend
from kzg_snark_tpu_torch.ops import msm_kernel as mk
from kzg_snark_tpu_torch.ops.ntt_stage import (butterfly_plain, fr_butterfly,
                                               ntt_pass)
from kzg_snark_tpu_torch.ops import scan
from kzg_snark_tpu_torch.ops.srs import g1_fixed_base_table
from kzg_snark_tpu_torch.utils.build import LAUNCHES


def words(n, seed, device="cpu", limbs=8):
    """(limbs, n) random words below 2^253 (8 limbs: under both curves' r
    and BN254's p) or 2^380 (12 limbs: under BLS12-381's p)."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(limbs, n),
                                             dtype=np.uint64)
    w[-1] &= (1 << (29 if limbs == 8 else 28)) - 1
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


@pytest.mark.parametrize("fn", [cuda_fr.fr_mul, cuda_fr.fr_add,
                                cuda_fr.fr_sub])
def test_field_wrapper_never_sends_other_devices_to_plain(fn):
    fc = fr_backend("bn254", "cpu").consts
    a = torch.empty((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(fc, a, a)


def test_curve_and_stage_wrappers_reject_other_devices():
    fc = fq_backend("bn254", "cpu").consts
    p = torch.empty((3, 8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fr.g1_add(fc, p, p)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fr.g1_double(fc, p)
    x = torch.empty((8, 8), dtype=torch.int32, device="meta")
    tw = torch.empty((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ntt_pass(fc, x, tw, 0, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        g1_fixed_base_table(fc, p[:, :, :1], 8, 32)
    xy = torch.empty((4, 16), dtype=torch.int32, device="meta")
    e = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mk.msm_accumulate(fc, xy, e, e, False)
    bco = torch.empty((129,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mk.msm_reduce(fc, p, bco, 1, 1, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        mk.reduce_horner(fc, p, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fr.g1_add_mixed(fc, p, x[:, :1], x[:, :1])
    m = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fr_butterfly(fc, x, x, x, m)


def test_ladder_wrapper_rejects_other_devices():
    """g1_ladder sends meta tensors, and a CPU scalar plane beside meta
    points, to the kernel path, which raises."""
    fc = fq_backend("bn254", "cpu").consts
    p = torch.empty((3, 8, 4), dtype=torch.int32, device="meta")
    s = torch.empty((2, 8, 4), dtype=torch.int32, device="meta")
    for tree in (True, False):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_fr.g1_ladder(fc, p, s, tree)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_fr.g1_ladder(fc, p, torch.zeros((1, 8, 1),
                                                 dtype=torch.int32), tree)


def test_scan_and_pow_wrappers_reject_other_devices():
    fc = fr_backend("bn254", "cpu").consts
    a = torch.empty((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        scan.fr_scan(fc, a, scan.MUL)
    with pytest.raises(ValueError, match="CUDA"):
        scan.fr_scan(fc, a[:, :1].expand(8, 9), scan.ADD, want_scan=False)
    with pytest.raises(ValueError, match="CUDA"):
        scan.fr_pow(fc, a, 5)
    with pytest.raises(ValueError, match="exponent"):
        scan.fr_pow(fc, a, 1 << 256)


def test_cpu_path_counts_no_launch():
    LAUNCHES.clear()
    fc = fr_backend("bn254", "cpu").consts
    a = words(16, 1)
    assert torch.equal(cuda_fr.fr_mul(fc, a, a), cuda_fr.mul_plain(fc, a, a))
    assert sum(LAUNCHES.values()) == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_field_kernels_match_plain(cuda):
    fc = fr_backend("bn254", cuda).consts
    a, b = words(1000, 1, cuda), words(1000, 2, cuda)
    for k, p in [(cuda_fr.fr_mul, cuda_fr.mul_plain),
                 (cuda_fr.fr_add, cuda_fr.add_plain),
                 (cuda_fr.fr_sub, cuda_fr.sub_plain)]:
        before = sum(LAUNCHES.values())
        assert torch.equal(k(fc, a, b), p(fc, a, b))
        assert torch.equal(k(fc, a, b[:, :1].contiguous()),
                           p(fc, a, b[:, :1]))
        assert sum(LAUNCHES.values()) == before + 2
    with pytest.raises(TypeError):
        cuda_fr.fr_mul(fc, a.to(torch.int64), b.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_fr.fr_mul(fc, a.t(), b.t())


@pytest.mark.cuda
def test_curve_and_stage_kernels_match_plain(cuda):
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.ops.ntt_stage import (ntt_pass_plain, pass_plan,
                                                   staged_transform,
                                                   tile_bits)
    from kzg_snark_tpu_torch.ops.srs import fixed_base_table_plain

    fq = fq_backend("bn254", cuda).consts
    pts, _ = random_point_basis("bn254", 256, seed=1, device=cuda)
    q = cuda_fr.g1_double(fq, pts.roll(1, -1).contiguous())
    assert torch.equal(cuda_fr.g1_add(fq, pts, q),
                       cuda_fr.g1_add_plain(fq, pts, q))
    assert torch.equal(cuda_fr.g1_double(fq, q),
                       cuda_fr.g1_double_plain(fq, q))
    T = tile_bits()
    for n in (64, 2 << T, 1 << 15):
        ctx = ntt_context("bn254", n, cuda)
        fr = ctx.backend.consts
        x = words(n, 3, cuda)
        for tw in (ctx.tw_fwd, ctx.tw_inv):
            y = x
            for s0, g in pass_plan(n, T):
                before = LAUNCHES["ntt_pass"]
                got = ntt_pass(fr, y, tw, s0, g, T)
                assert LAUNCHES["ntt_pass"] == before + 1
                y = ntt_pass_plain(fr, y, tw, s0, g)
                assert torch.equal(got, y), (n, s0, g)
            assert torch.equal(staged_transform(fr, x, tw), y), n
    base = curve_ops("bn254", cuda).from_affine_ints([1], [2]).contiguous()
    before = LAUNCHES["g1_fixed_base_table"]
    table = g1_fixed_base_table(fq, base, 8, 32)
    assert LAUNCHES["g1_fixed_base_table"] == before + 1
    assert torch.equal(table, fixed_base_table_plain(fq, base, 8, 32))


@pytest.mark.parametrize("skew", ["random", "all-equal", "one-nonzero",
                                  "small"])
@pytest.mark.cuda
def test_bucket_kernels_match_plain(cuda, skew):
    """msm_accumulate (both adds) and msm_reduce (both launches) against
    their plain versions at 2^12 points with k = 2 sets: random scalars
    beside a skewed set; each launch counted once."""
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis

    n = 1 << 12
    fq = fq_backend("bn254", cuda).consts
    pts, _ = random_point_basis("bn254", n, seed=4, device=cuda)
    other = {"random": words(n, 6), "all-equal": words(1, 6).expand(8, n),
             "one-nonzero": torch.zeros((8, n), dtype=torch.int32),
             "small": words(n, 6) & 0x3FF}[skew].clone()
    if skew == "one-nonzero":
        other[:, 99] = words(1, 6)[:, 0]
    sets = torch.stack([words(n, 5), other]).to(cuda)
    c = mk.window_bits(n)
    dig = mk.signed_digits(sets, 254, c)
    W = dig.shape[1]
    s = mk.bucket_schedule(dig, c)
    xy = mk.point_table(pts)
    for complete in (False, True):
        before = LAUNCHES["msm_accumulate"]
        part = mk.msm_accumulate(fq, xy, s.entries, s.chunk_off, complete)
        assert LAUNCHES["msm_accumulate"] == before + 1
        assert torch.equal(part, mk.msm_accumulate_plain(
            fq, xy, s.entries, s.chunk_off, complete))
    before = LAUNCHES["msm_reduce"]
    got = mk.msm_reduce(fq, part, s.bucket_chunks, 2, W, c,
                        s.window_threads)
    assert LAUNCHES["msm_reduce"] == before + 2
    assert torch.equal(got, mk.msm_reduce_plain(
        fq, part, s.bucket_chunks, 2, W, c, s.window_threads))


@pytest.mark.cuda
def test_mixed_add_and_butterfly_kernels_match_plain(cuda):
    """K9 with a per-point, a per-lane and a broadcast q (identity, P = q
    and P = -q lanes included), and K10 with a random mask; each launch is
    counted once."""
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis

    fb = fq_backend("bn254", cuda)
    fq = fb.consts
    pts, _ = random_point_basis("bn254", 256, seed=2, device=cuda)
    acc = cuda_fr.g1_double(fq, pts.roll(1, -1).contiguous())
    acc[2, :, :4] = 0
    acc[:, :, 4:8] = pts[:, :, 4:8]
    acc[0, :, 8:12] = pts[0, :, 8:12]
    acc[1, :, 8:12] = fb.neg(pts[1, :, 8:12].contiguous())
    acc[2, :, 8:12] = pts[2, :, 8:12]
    acc = acc.contiguous()
    for qn in (256, 32, 1):
        qx, qy = pts[0, :, :qn].contiguous(), pts[1, :, :qn].contiguous()
        before = LAUNCHES["g1_add_mixed"]
        assert torch.equal(cuda_fr.g1_add_mixed(fq, acc, qx, qy),
                           cuda_fr.g1_add_mixed_plain(fq, acc, qx, qy))
        assert LAUNCHES["g1_add_mixed"] == before + 1
    with pytest.raises(ValueError):
        cuda_fr.g1_add_mixed(fq, acc, pts[0, :, :3].contiguous(),
                             pts[1, :, :3].contiguous())
    fr = fr_backend("bn254", cuda).consts
    xl, xu, tw = (words(1000, s, cuda) for s in (5, 6, 7))
    mask = torch.from_numpy(np.random.default_rng(8).integers(
        0, 2, 1000).astype(np.int32)).to(cuda)
    before = LAUNCHES["fr_butterfly"]
    assert torch.equal(fr_butterfly(fr, xl, xu, tw, mask),
                       butterfly_plain(fr, xl, xu, tw, mask))
    assert LAUNCHES["fr_butterfly"] == before + 1


@pytest.mark.parametrize("op", [scan.MUL, scan.ADD], ids=["mul", "add"])
@pytest.mark.cuda
def test_scan_kernel_matches_plain(cuda, op):
    """fr_scan at the edge widths (one, two, a tile less one, a tile, a
    tile and one, several tiles), both directions; a total alone; one
    column read with step 0; and the launches (3 a scan, 2 a total).  The
    sums take zero entries; the products none, so that no prefix is forced
    to zero and every tile and the totals pass are checked."""
    fc = fr_backend("bn254", cuda).consts
    tile = scan.tile()
    n_max = 3 * tile + 5
    a = words(n_max, 11, cuda)
    if op == scan.ADD:
        a[:, ::7] = 0
    else:
        assert bool(a.ne(0).any(dim=0).all())
    for n in (1, 2, tile - 1, tile, tile + 1, n_max):
        x = a[:, :n]
        for reverse in (False, True):
            want, want_total = scan.fr_scan_plain(fc, x, op, reverse)
            before = LAUNCHES["fr_scan"]
            got, total = scan.fr_scan(fc, x, op, reverse)
            assert LAUNCHES["fr_scan"] == before + 3
            assert torch.equal(got, want), (n, reverse)
            assert torch.equal(total, want_total), (n, reverse)
            none, total = scan.fr_scan(fc, x, op, reverse, want_scan=False)
            assert none is None and torch.equal(total, want_total)
    rep = a[:, 5:6].expand(8, 1000)
    assert torch.equal(scan.fr_scan(fc, rep, op)[0],
                       scan.fr_scan_plain(fc, rep, op)[0])


@pytest.mark.cuda
def test_pow_kernel_matches_plain(cuda):
    """fr_pow at widths 1 and 300, e = 0, 1, 2, 2^16 and r - 2 under Fr,
    p - 2 under Fq; zero entries included."""
    from kzg_snark_tpu_torch import constants as C
    for modulus, exps in [(C.BN254_R, (0, 1, 2, 1 << 16, C.BN254_R - 2)),
                          (C.BN254_P, (C.BN254_P - 2,))]:
        be = fr_backend("bn254", cuda) if modulus == C.BN254_R \
            else fq_backend("bn254", cuda)
        a = be.to_mont(words(300, 12, cuda))
        a[:, ::9] = 0
        for width in (1, 300):
            x = a[:, :width].contiguous()
            for e in exps:
                want = scan.fr_pow_plain(be.consts, x, e)
                before = LAUNCHES["fr_pow"]
                assert torch.equal(scan.fr_pow(be.consts, x, e), want), \
                    (width, e)
                assert LAUNCHES["fr_pow"] == before + 1


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.cuda
def test_bls_field_and_chain_kernels_match_plain(cuda, field):
    """K1 (fr_mul, fr_add, fr_sub, a broadcast operand too), fr_scan (both
    operations, both directions, widths across tiles) and fr_pow (e = p -
    2, zero entries) at BLS12-381 Fr (8 words) and Fq (12 words)."""
    be = (fr_backend if field == "fr" else fq_backend)("bls12_381", cuda)
    fc = be.consts
    assert fc.num_limbs == (8 if field == "fr" else 12)
    a = words(1000, 21, cuda, fc.num_limbs)
    b = words(1000, 22, cuda, fc.num_limbs)
    for k, p in [(cuda_fr.fr_mul, cuda_fr.mul_plain),
                 (cuda_fr.fr_add, cuda_fr.add_plain),
                 (cuda_fr.fr_sub, cuda_fr.sub_plain)]:
        assert torch.equal(k(fc, a, b), p(fc, a, b))
        assert torch.equal(k(fc, a, b[:, :1].contiguous()),
                           p(fc, a, b[:, :1]))
    tile = scan.tile()
    for op in (scan.MUL, scan.ADD):
        for n in (1, tile + 1, 1000):
            for reverse in (False, True):
                got = scan.fr_scan(fc, a[:, :n], op, reverse)
                want = scan.fr_scan_plain(fc, a[:, :n], op, reverse)
                assert torch.equal(got[0], want[0]), (op, n, reverse)
                assert torch.equal(got[1], want[1]), (op, n, reverse)
    x = a[:, :64].contiguous()
    x[:, ::9] = 0
    before = LAUNCHES["fr_pow"]
    assert torch.equal(scan.fr_pow(fc, x, be.modulus - 2),
                       scan.fr_pow_plain(fc, x, be.modulus - 2))
    assert LAUNCHES["fr_pow"] == before + 1


@pytest.mark.cuda
def test_bls_curve_ntt_and_table_kernels_match_plain(cuda):
    """K6, K7 and K9 at 12 words (identity, P = q and P = -q lanes in
    K9), the SRS table at c = 8, W = 32 of BLS12-381's generator, and
    ntt_pass over BLS12-381 Fr at 2^11 (two passes)."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.ops.ntt_stage import (ntt_pass_plain, pass_plan,
                                                   tile_bits)
    from kzg_snark_tpu_torch.ops.srs import fixed_base_table_plain

    fb = fq_backend("bls12_381", cuda)
    fq = fb.consts
    pts, _ = random_point_basis("bls12_381", 256, seed=3, device=cuda)
    assert pts.shape == (3, 12, 256)
    q = cuda_fr.g1_double(fq, pts.roll(1, -1).contiguous())
    assert torch.equal(cuda_fr.g1_add(fq, pts, q),
                       cuda_fr.g1_add_plain(fq, pts, q))
    assert torch.equal(cuda_fr.g1_double(fq, q),
                       cuda_fr.g1_double_plain(fq, q))
    acc = q.clone()
    acc[2, :, :4] = 0
    acc[:, :, 4:8] = pts[:, :, 4:8]
    acc[1, :, 8:12] = fb.neg(pts[1, :, 8:12].contiguous())
    acc[0, :, 8:12] = pts[0, :, 8:12]
    acc[2, :, 8:12] = pts[2, :, 8:12]
    acc = acc.contiguous()
    for qn in (256, 1):
        qx, qy = pts[0, :, :qn].contiguous(), pts[1, :, :qn].contiguous()
        assert torch.equal(cuda_fr.g1_add_mixed(fq, acc, qx, qy),
                           cuda_fr.g1_add_mixed_plain(fq, acc, qx, qy))
    g1 = C.BLS12_381_G1
    base = curve_ops("bls12_381", cuda).from_affine_ints(
        [g1[0]], [g1[1]]).contiguous()
    assert torch.equal(g1_fixed_base_table(fq, base, 8, 32),
                       fixed_base_table_plain(fq, base, 8, 32))
    T = tile_bits()
    n = 2 << T
    ctx = ntt_context("bls12_381", n, cuda)
    fr = ctx.backend.consts
    y = x = words(n, 23, cuda)
    for s0, g in pass_plan(n, T):
        got = ntt_pass(fr, y, ctx.tw_fwd, s0, g, T)
        y = ntt_pass_plain(fr, y, ctx.tw_fwd, s0, g)
        assert torch.equal(got, y), (s0, g)
    assert not torch.equal(x, y)


@pytest.mark.cuda
def test_bls_bucket_kernels_match_plain(cuda):
    """msm_accumulate (both adds) and msm_reduce at 12 words, 2^12 points,
    k = 2 sets of 255-bit scalars (W = ceil(256 / c) windows)."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis

    n = 1 << 12
    fq = fq_backend("bls12_381", cuda).consts
    pts, _ = random_point_basis("bls12_381", n, seed=4, device=cuda)
    sets = torch.stack([words(n, 24), words(1, 25).expand(8, n)]).to(cuda)
    sets[0, :, :3] = torch.from_numpy(np.array(
        [[(v >> (32 * k)) & 0xFFFFFFFF for v in (0, 1, C.BLS12_381_R - 1)]
         for k in range(8)], dtype=np.uint32).view(np.int32)).to(cuda)
    c = mk.window_bits(n)
    dig = mk.signed_digits(sets, C.BLS12_381_R.bit_length(), c)
    W = dig.shape[1]
    assert W == -(-256 // c)
    s = mk.bucket_schedule(dig, c)
    xy = mk.point_table(pts)
    for complete in (False, True):
        part = mk.msm_accumulate(fq, xy, s.entries, s.chunk_off, complete)
        assert torch.equal(part, mk.msm_accumulate_plain(
            fq, xy, s.entries, s.chunk_off, complete))
    got = mk.msm_reduce(fq, part, s.bucket_chunks, 2, W, c,
                        s.window_threads)
    assert torch.equal(got, mk.msm_reduce_plain(
        fq, part, s.bucket_chunks, 2, W, c, s.window_threads))


@pytest.mark.cuda
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_curve_kernels_match_plain_on_edge_batches(cuda, curve_type):
    """K6 and K9 (the carry-chain product in PTX) against their plain
    versions on ``edge_batches``: identity operands, P = Q, P = -Q, the
    mixed add's doubling, q with column periods m and 1, coordinates near
    p and all-ones words; 8 words at BN254, 12 at BLS12-381."""
    from kzg_snark_tpu_torch.ops.benchpoints import (edge_batches,
                                                     random_point_basis)

    fq = fq_backend(curve_type, cuda).consts
    pts, _ = random_point_basis(curve_type, 64, seed=17, device=cuda)
    cases = edge_batches(curve_type, pts)
    p, q = cases["add"]
    before = LAUNCHES["g1_add"]
    assert torch.equal(cuda_fr.g1_add(fq, p, q),
                       cuda_fr.g1_add_plain(fq, p, q))
    assert LAUNCHES["g1_add"] == before + 1
    for acc, qx, qy in cases["mixed"]:
        before = LAUNCHES["g1_add_mixed"]
        assert torch.equal(cuda_fr.g1_add_mixed(fq, acc, qx, qy),
                           cuda_fr.g1_add_mixed_plain(fq, acc, qx, qy))
        assert LAUNCHES["g1_add_mixed"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_double_kernel_matches_plain_on_edge_batches(cuda, curve_type):
    """K7 (dbl-2009-l on the carry-chain squaring) against its plain
    version on the points of ``edge_batches``."""
    from kzg_snark_tpu_torch.ops.benchpoints import (edge_batches,
                                                     random_point_basis)

    fq = fq_backend(curve_type, cuda).consts
    pts, _ = random_point_basis(curve_type, 64, seed=18, device=cuda)
    p, q = edge_batches(curve_type, pts)["add"]
    batch = torch.cat([p, q], dim=-1).contiguous()
    before = LAUNCHES["g1_double"]
    assert torch.equal(cuda_fr.g1_double(fq, batch),
                       cuda_fr.g1_double_plain(fq, batch))
    assert LAUNCHES["g1_double"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
def test_ladder_kernel_matches_plain(cuda, curve_type):
    """g1_ladder against g1_ladder_plain, exact words, at n = 1, 7, 256
    with k = 3 and 1 sets of ``edge_scalar_sets``; one scalar of column
    period 1 summed and per point; scale_const by r - 1."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops.benchpoints import (edge_scalar_sets,
                                                     random_point_basis)
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor

    fq = fq_backend(curve_type, cuda).consts
    for n in (1, 7, 256):
        pts, ks = random_point_basis(curve_type, n, seed=40 + n, device=cuda)
        sc = torch.stack([to_tensor(ints_to_words(s), cuda)
                          for s in edge_scalar_sets(curve_type, ks, n)])
        before = LAUNCHES["g1_ladder"]
        got = cuda_fr.g1_ladder(fq, pts, sc)
        assert LAUNCHES["g1_ladder"] == before + 1
        assert torch.equal(got, cuda_fr.g1_ladder_plain(fq, pts, sc)), n
        assert torch.equal(cuda_fr.g1_ladder(fq, pts, sc[:1].contiguous()),
                           got[..., :1])
    one = sc[:1, :, :1].contiguous()
    for tree in (True, False):
        assert torch.equal(cuda_fr.g1_ladder(fq, pts, one, tree),
                           cuda_fr.g1_ladder_plain(fq, pts, one, tree))
    r = C.BN254_R if curve_type == "bn254" else C.BLS12_381_R
    few = pts[..., :16].contiguous()
    rm1 = to_tensor(ints_to_words([r - 1]), cuda)[None]
    assert torch.equal(curve_ops(curve_type, cuda).scale_const(few, r - 1),
                       cuda_fr.g1_ladder_plain(fq, few, rm1, False)[:, :, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1 << 11,), (1 << 16,), (3, 1 << 11)],
                         ids=["8x2^11", "8x2^16", "8x3x2^11"])
def test_ntt_launches_and_batches(cuda, shape):
    """An (8, n) transform makes ceil(log2 n / t) ntt_pass launches; an
    (8, ..., n) batch makes them for each row and equals the rows'
    transforms, in both modes."""
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.ops.ntt_stage import tile_bits

    n = shape[-1]
    ctx = ntt_context("bn254", n, cuda)
    rows = int(np.prod(shape[:-1]))
    x = words(rows * n, 5, cuda).reshape((8,) + shape)
    before = LAUNCHES["ntt_pass"]
    y = ctx.ntt(x)
    k = n.bit_length() - 1
    assert LAUNCHES["ntt_pass"] - before == rows * -(-k // tile_bits())
    flat = x.reshape(8, rows, n)
    for r in range(rows):
        assert torch.equal(y.reshape(8, rows, n)[:, r],
                           ctx.ntt(flat[:, r].contiguous()))
    assert torch.equal(ctx.ntt(x, mode="scan"), y)
    assert torch.equal(ctx.intt(y), x)


def test_chain_product_modulus_bound():
    """K6 and K9 take the carry-chain product, whose sums stay in their
    words for 2p + 2^(32 L - 30) < 2^(32 L): every curve modulus passes,
    a 255-bit modulus just under 2^255 is refused before any launch."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops.limbs import FieldConsts

    for p in (C.BN254_R, C.BN254_P, C.BLS12_381_R, C.BLS12_381_P):
        cuda_fr._chain_check("g1_add", FieldConsts(p))
    with pytest.raises(ValueError):
        cuda_fr._chain_check("g1_add", FieldConsts(2 ** 255 - 19))


def _plus_p(fc, t, col):
    """Column ``col`` of an (L, ...) word tensor raised by p: the value a
    missed final subtraction leaves (non-canonical, still L words)."""
    from kzg_snark_tpu_torch.ops.limbs import (ints_to_words, to_tensor,
                                               to_words, words_to_ints)
    L = fc.num_limbs
    v = words_to_ints(to_words(t.reshape(L, -1)[:, col:col + 1]))[0]
    t.reshape(L, -1)[:, col] = to_tensor(
        ints_to_words([v + fc.modulus], L), t.device)[:, 0]
    return t


@pytest.mark.cuda
def test_checked_mode_traps_planted_kernel_outputs(cuda, monkeypatch):
    """Under KZG_TPU_CHECKED, a fr_mul output with p added to one column
    traps at "mul" and a g1_add output with one coordinate set to p at
    "g1.add", on the card; clean outputs pass with the unchecked values."""
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.fr import CheckedFieldBackend
    from kzg_snark_tpu_torch.ops.g1 import curve_ops
    from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor

    plain = fr_backend("bn254", cuda)
    a, b = plain.to_mont(words(1000, 31, cuda)), plain.to_mont(
        words(1000, 32, cuda))
    want = plain.mul(a, b)
    monkeypatch.setenv("KZG_TPU_CHECKED", "1")
    be = fr_backend("bn254", cuda)
    assert isinstance(be, CheckedFieldBackend)
    assert torch.equal(be.mul(a, b), want)
    curve = curve_ops("bn254", cuda)
    pts, _ = random_point_basis("bn254", 256, seed=7, device=cuda)
    clean = curve.add(pts, pts.flip(-1))
    mul, add = cuda_fr.fr_mul, cuda_fr.g1_add
    monkeypatch.setattr(cuda_fr, "fr_mul", lambda fc, x, y: _plus_p(
        fc, mul(fc, x, y), 77))

    def planted_add(fc, p, q):
        out = add(fc, p, q)
        out[0, :, 5] = to_tensor(ints_to_words([fc.modulus], fc.num_limbs),
                                 out.device)[:, 0]
        return out
    monkeypatch.setattr(cuda_fr, "g1_add", planted_add)
    before = LAUNCHES["fr_mul"]
    with pytest.raises(AssertionError,
                       match="^mul: non-canonical output .* at column 77$"):
        be.mul(a, b)
    assert LAUNCHES["fr_mul"] == before + 1
    with pytest.raises(AssertionError,
                       match="^g1.add: non-canonical output .* at column 5$"):
        curve.add(pts, pts.flip(-1))
    assert clean.shape == pts.shape
