"""Kernel wrappers: dispatch rules on any machine, kernels on the card.

Without a card: CPU tensors take the plain versions, and a tensor on any
other device never does (it goes to the kernel path, which checks its
operands and raises).  With a card (tests marked ``cuda``, skipped where
``torch.cuda.is_available()`` is false): every kernel entry point equals
its plain version on small numpy-seeded inputs and counts its launch
(K1, K6, K7, K9, K10, ntt_pass, the SRS table's g1_fixed_base_table, the
bucket route's msm_accumulate and msm_reduce, its schedule's msm_digits,
msm_sort and msm_bucket_offsets, the chains' fr_scan and fr_pow, the
small MSM's g1_ladder, and the grouped MSM's four kernels), at BN254 and at
BLS12-381 (Fr in
8 words, Fq in the kernels' 12-word instantiation); checked mode
(``KZG_TPU_CHECKED``) traps a planted non-canonical kernel output; and one
rank over NCCL (``parallel/``) equals the single-device path; one
full-size blob's cells and proofs by FK20 equal the benchmark's plain
reference.  The full-size comparison is ``python3 chip_smoke.py``.
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
    for n in (64, 1 << 9, 1 << 15, 1 << 17):
        T = tile_bits(n)
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


@pytest.mark.parametrize("field", ["bn254-fr", "bls-fq"])
@pytest.mark.parametrize("op", [scan.MUL, scan.ADD], ids=["mul", "add"])
@pytest.mark.cuda
def test_scan_kernel_matches_plain(cuda, op, field):
    """fr_scan at the edge widths (one, two, a tile less one, a tile, a
    tile and one, several tiles, one look-back window of tiles and one
    element less or more, and into a second window), both directions, at
    8 words (BN254 Fr) and 12 (BLS12-381 Fq); a total alone; one column
    read with step 0; and one launch a call.  The sums take zero entries;
    the products none, so that no prefix is forced to zero and every tile
    is checked."""
    from kzg_snark_tpu_torch.utils.build import cuda_lib

    be = (fr_backend("bn254", cuda) if field == "bn254-fr"
          else fq_backend("bls12_381", cuda))
    fc = be.consts
    L = fc.num_limbs
    tile = scan.tile()
    window = cuda_lib().kzg_scan_window() * tile
    n_max = window + tile + 3
    a = words(n_max, 11, cuda, L)
    if op == scan.ADD:
        a[:, ::7] = 0
    else:
        assert bool(a.ne(0).any(dim=0).all())
    for n in (1, 2, tile - 1, tile, tile + 1, 3 * tile + 5, window - 1,
              window, window + 1, n_max):
        x = a[:, :n]
        for reverse in (False, True):
            want, want_total = scan.fr_scan_plain(fc, x, op, reverse)
            before = LAUNCHES["fr_scan"]
            got, total = scan.fr_scan(fc, x, op, reverse)
            assert LAUNCHES["fr_scan"] == before + 1
            assert torch.equal(got, want), (n, reverse)
            assert torch.equal(total, want_total), (n, reverse)
            none, total = scan.fr_scan(fc, x, op, reverse, want_scan=False)
            assert LAUNCHES["fr_scan"] == before + 2
            assert none is None and torch.equal(total, want_total)
    rep = a[:, 5:6].expand(L, 1000)
    assert torch.equal(scan.fr_scan(fc, rep, op)[0],
                       scan.fr_scan_plain(fc, rep, op)[0])


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
@pytest.mark.cuda
def test_table_kernel_matches_plain(cuda, curve):
    """g1_fixed_base_table, one launch a table, equal word for word to
    fixed_base_table_plain at c = 8 with W = 2, 9 and 32, at W = 46, one
    window more than the launch's 45 row groups (csrc/srs.cuh FBT_UNITS:
    a group's second window), and at c = 3, W = 5."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops import srs
    from kzg_snark_tpu_torch.ops.g1 import curve_ops

    fq = fq_backend(curve, cuda).consts
    g1 = C.BN254_G1 if curve == "bn254" else C.BLS12_381_G1
    base = curve_ops(curve, cuda).from_affine_ints([g1[0]],
                                                   [g1[1]]).contiguous()
    for c, w in ((8, 2), (8, 9), (8, 32), (8, 46), (3, 5)):
        before = LAUNCHES["g1_fixed_base_table"]
        table = g1_fixed_base_table(fq, base, c, w)
        assert LAUNCHES["g1_fixed_base_table"] == before + 1
        assert torch.equal(table, srs.fixed_base_table_plain(fq, base, c, w)
                           ), (c, w)


@pytest.mark.cuda
def test_pow_kernel_matches_plain(cuda):
    """fr_pow at widths 1, 2, 255, 256, 257, T - 1, T + 1 and 3 T + 5 (T =
    scan.tile(), the inversion route's tile), e = 0, 1, 2, 2^16, a random
    254-bit e and r - 2 under Fr, p - 2 under Fq; zero entries every 9
    columns, on both sides of the first tile edge, over the third tile and
    in the ragged last tile.  One launch a call."""
    from kzg_snark_tpu_torch import constants as C
    T = scan.tile()
    n = 3 * T + 5
    e_rand = int(np.random.default_rng(13).integers(0, 1 << 62)) << 192 \
        | 1 << 253 | 12345
    for modulus, exps in [(C.BN254_R, (0, 1, 2, 1 << 16, e_rand,
                                       C.BN254_R - 2)),
                          (C.BN254_P, (C.BN254_P - 2,))]:
        be = fr_backend("bn254", cuda) if modulus == C.BN254_R \
            else fq_backend("bn254", cuda)
        a = be.to_mont(words(n, 12, cuda))
        a[:, ::9] = 0
        a[:, T - 1:T + 1] = 0
        a[:, 2 * T:3 * T] = 0
        a[:, n - 2] = 0
        for e in exps:
            want = scan.fr_pow_plain(be.consts, a, e)
            for width in (1, 2, 255, 256, 257, T - 1, T + 1, n):
                x = a[:, :width].contiguous()
                before = LAUNCHES["fr_pow"]
                assert torch.equal(scan.fr_pow(be.consts, x, e),
                                   want[:, :width]), (width, e)
                assert LAUNCHES["fr_pow"] == before + 1


@pytest.mark.cuda
def test_ntt_pass_matches_plain_at_every_plan_tile(cuda):
    """ntt_pass against ntt_pass_plain for every pass of two-pass plans
    with each tile the plan chooses (8, 9 and 10 bits, at n = 2^(t + 1)),
    forward and inverse tables; the plan keeps every transform up to 2^20
    to two passes."""
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.ops.ntt_stage import (ntt_pass_plain, pass_plan,
                                                   tile_bits)
    tiles = {tile_bits(1 << k) for k in range(1, 21)}
    assert all(-(-k // tile_bits(1 << k)) <= 2 for k in range(1, 21))
    assert tiles == {8, 9, 10}
    for t in sorted(tiles):
        n = 2 << t
        ctx = ntt_context("bn254", n, cuda)
        fr = ctx.backend.consts
        x = words(n, 40 + t, cuda)
        for tw in (ctx.tw_fwd, ctx.tw_inv):
            y = x
            for s0, g in pass_plan(n, t):
                got = ntt_pass(fr, y, tw, s0, g, t)
                y = ntt_pass_plain(fr, y, tw, s0, g)
                assert torch.equal(got, y), (t, s0, g)


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
    n = 1 << 11
    T = tile_bits(n)
    ctx = ntt_context("bls12_381", n, cuda)
    fr = ctx.backend.consts
    y = x = words(n, 23, cuda)
    for s0, g in pass_plan(n, T):
        got = ntt_pass(fr, y, ctx.tw_fwd, s0, g, T)
        y = ntt_pass_plain(fr, y, ctx.tw_fwd, s0, g)
        assert torch.equal(got, y), (s0, g)
    assert not torch.equal(x, y)


def test_schedule_wrappers_reject_other_devices():
    """The schedule's three steps send meta tensors to the kernel path,
    which raises."""
    plan = mk.schedule_plan(2, 4096, 26, 10)
    sets = torch.empty((2, 8, 4096), dtype=torch.int32, device="meta")
    flat = torch.empty((plan.digits,), dtype=torch.int32, device="meta")
    hist = torch.empty((plan.segments, 512, plan.tiles), dtype=torch.int32,
                       device="meta")
    base = torch.empty((plan.segments + 1,), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mk.msm_digits(sets, plan)
    with pytest.raises(ValueError, match="CUDA"):
        mk.msm_sort(flat, flat, hist, plan)
    with pytest.raises(ValueError, match="CUDA"):
        mk.msm_bucket_offsets(flat, flat, base, plan)


# (sets, n, scalar bits, c) of the schedule's card tests: the 2^20 cell's
# c at 2^16 points, and the blob cell's MSMs.
SCHEDULE_SHAPES = {"bn254-c14": (8, 1 << 16, 254, 14),
                   "bls12_381-c10": (9, 4096, 255, 10)}
SCHEDULE_KERNELS = ("msm_digits", "msm_sort", "msm_bucket_offsets")


def skewed_sets(k, n, skew, seed):
    """(k, 8, n) scalar words below 2^253 on the CPU: random, every point
    of a set equal, one nonzero point a set, 10-bit values, or the last
    set all zero."""
    sets = torch.stack([words(n, seed + j) for j in range(k)])
    if skew == "all-equal":
        sets = sets[:, :, :1].expand(k, 8, n).clone()
    elif skew == "one-nonzero":
        one = sets[:, :, n // 3].clone()
        sets.zero_()
        sets[:, :, n // 3] = one
    elif skew == "small":
        sets[:, 1:] = 0
        sets[:, 0] &= 0x3FF
    elif skew == "zero-set":
        sets[-1] = 0
    return sets


@pytest.mark.parametrize("skew", ["random", "all-equal", "one-nonzero",
                                  "small", "zero-set"])
@pytest.mark.parametrize("shape", list(SCHEDULE_SHAPES))
@pytest.mark.cuda
def test_schedule_kernels_match_plain(cuda, shape, skew):
    """msm_digits, msm_sort and msm_bucket_offsets against their plain
    versions step by step (the sorted buffers and the chunk offsets up to
    E and C + 1), each step's launches counted, and msm_schedule against
    bucket_schedule(signed_digits(...)) field by field."""
    k, n, bits, c = SCHEDULE_SHAPES[shape]
    sets = skewed_sets(k, n, skew, 40)
    plan = mk.schedule_plan(k, n, mk.num_windows(bits, c), c)
    before = {name: LAUNCHES[name] for name in SCHEDULE_KERNELS}
    dig = mk.msm_digits(sets.to(cuda), plan)
    want = mk.msm_digits(sets, plan)
    for got_t, want_t in zip(dig, want):
        assert torch.equal(got_t.cpu(), want_t)
    keys, pay, base = mk.msm_sort(*dig, plan)
    wkeys, wpay, wbase = mk.msm_sort(*want, plan)
    E = int(wbase[-1])
    assert torch.equal(base.cpu(), wbase)
    assert torch.equal(keys[:E].cpu(), wkeys[:E])
    assert torch.equal(pay[:E].cpu(), wpay[:E])
    bco, chunk_off, runs, info = mk.msm_bucket_offsets(keys, pay, base,
                                                       plan)
    wbco, wchunk_off, _, winfo = mk.msm_bucket_offsets(wkeys, wpay, wbase,
                                                       plan)
    C = int(winfo[0])
    assert plan.run == 0 and runs.numel() == 1
    assert torch.equal(pay[:E].cpu(), wpay[:E])
    assert torch.equal(info.cpu(), winfo) and torch.equal(bco.cpu(), wbco)
    assert torch.equal(chunk_off[:C + 1].cpu(), wchunk_off[:C + 1])
    assert {name: LAUNCHES[name] - before[name]
            for name in SCHEDULE_KERNELS} == {
        "msm_digits": 1, "msm_sort": 3 * len(plan.passes),
        "msm_bucket_offsets": 4}
    got = mk.msm_schedule(sets.to(cuda), bits, c)
    ref = mk.bucket_schedule(mk.signed_digits(sets.to(cuda), bits, c), c)
    for field in ("entries", "chunk_off", "bucket_chunks"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    assert got.window_threads == ref.window_threads
    assert got.run_chunks is None and ref.run_chunks is None


def smallest_range_shape(bits=254):
    """The fewest points, in steps of 4096, at which one set takes the
    range route (``accumulate_run`` with the real ``ACC_FILL_THREADS``)."""
    n = 4096
    while True:
        c = mk.window_bits(n)
        W = mk.num_windows(bits, c)
        if mk.accumulate_run(1, W, n, c):
            return n, c, W
        n += 4096


@pytest.mark.cuda
def test_range_route_kernels_match_plain(cuda):
    """At the smallest one-set shape where the rule takes the range route:
    msm_bucket_offsets (bucket and chunk offsets, the runs' first chunks,
    info) against its plain version and msm_schedule against
    bucket_schedule(signed_digits) with run_chunks; msm_accumulate over
    the runs (both adds, one launch) against the plain partials; both
    reduce launches against their plain versions; FusedMsm.msm counts one
    call on the range route with its partials."""
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.utils import build

    n, c, W = smallest_range_shape()
    plan = mk.schedule_plan(1, n, W, c)
    assert mk.CHUNK < plan.run <= 64
    sets = skewed_sets(1, n, "random", 80)
    sets[0, :, : n // 8] = sets[0, :, :1]        # heavy buckets over runs
    sc = sets.to(cuda)
    keys, pay, base = mk.msm_sort(*mk.msm_digits(sc, plan), plan)
    wpay = pay.clone()
    got = mk.msm_bucket_offsets(keys, pay, base, plan)
    want = mk.msm_bucket_offsets_plain(keys, wpay, base, plan)
    C, _, E = (int(v) for v in want[3])
    R = -(-E // plan.run)
    assert torch.equal(pay[:E], wpay[:E])
    assert int((pay[:E] < 0).sum()) == C
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    assert torch.equal(got[1][:C + 1], want[1][:C + 1])
    assert torch.equal(got[2][:R + 1], want[2][:R + 1])
    s = mk.msm_schedule(sc, 254, c)
    ref = mk.bucket_schedule(mk.signed_digits(sc, 254, c), c)
    for field in ("entries", "chunk_off", "bucket_chunks", "run_chunks"):
        assert torch.equal(getattr(s, field), getattr(ref, field)), field
    assert s.window_threads == ref.window_threads
    assert s.run_chunks.numel() == R + 1 and C < E // mk.CHUNK
    fq = fq_backend("bn254", cuda).consts
    pts, _ = random_point_basis("bn254", n, seed=4, device=cuda)
    xy = mk.point_table(pts)
    for complete in (False, True):
        before = LAUNCHES["msm_accumulate"]
        part = mk.msm_accumulate(fq, xy, s.entries, s.chunk_off, complete,
                                 s.run_chunks)
        assert LAUNCHES["msm_accumulate"] == before + 1
        assert torch.equal(part, mk.msm_accumulate_plain(
            fq, xy, s.entries, s.chunk_off, complete))
    wparts = mk.reduce_window_sums(fq, part, s.bucket_chunks, W, c,
                                   s.window_threads)
    assert torch.equal(wparts, mk.window_sums_plain(
        fq, part, s.bucket_chunks, W, c, s.window_threads))
    res = mk.reduce_horner(fq, wparts, 1, W, c)
    assert torch.equal(res, mk.horner_plain(fq, wparts, 1, W, c))
    build.reset_launches()
    assert torch.equal(mk.FusedMsm("bn254", cuda).msm(pts, sc, complete=True),
                       res)
    assert build.msm_route_counts() == {"ranges": {"calls": 1,
                                                   "partials": C}}


@pytest.mark.parametrize("curve_type, k", [("bn254", 8), ("bls12_381", 9)])
@pytest.mark.cuda
def test_kernel_schedule_keeps_the_msm_results(cuda, curve_type, k):
    """msm_accumulate's partials over the kernels' schedule and over the
    plain schedule (msm_schedule on the CPU), both adds, and FusedMsm.msm
    against the plain schedule's path (its accumulate and reduce on the
    card): torch.equal, at 4096 points with a skewed set among random
    ones."""
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis

    n = 4096
    fused = mk.FusedMsm(curve_type, cuda)
    fq = fused.curve.f.consts
    pts, _ = random_point_basis(curve_type, n, seed=4, device=cuda)
    xy = mk.point_table(pts)
    sets = skewed_sets(k, n, "random", 60)
    sets[1] = skewed_sets(1, n, "all-equal", 61)[0]
    sets[2, :, ::3] = 0
    bits, c = fused.total_bits, mk.window_bits(n)
    W = mk.num_windows(bits, c)
    got = mk.msm_schedule(sets.to(cuda), bits, c)
    plain = mk.msm_schedule(sets, bits, c)
    plain = mk.BucketSchedule(plain.entries.to(cuda), plain.chunk_off.to(cuda),
                              plain.bucket_chunks.to(cuda),
                              plain.window_threads)
    for complete in (False, True):
        part = mk.msm_accumulate(fq, xy, got.entries, got.chunk_off,
                                 complete)
        want = mk.msm_accumulate(fq, xy, plain.entries, plain.chunk_off,
                                 complete)
        assert torch.equal(part, want)
    want = mk.msm_reduce(fq, want, plain.bucket_chunks, k, W, c,
                         plain.window_threads)
    assert torch.equal(fused.msm(pts, sets.to(cuda), complete=True), want)


@pytest.mark.parametrize("shape", list(SCHEDULE_SHAPES))
@pytest.mark.cuda
def test_schedule_waits_once_on_the_card(cuda, shape):
    """Under torch.cuda.set_sync_debug_mode("warn") a schedule makes one
    wait, the counted msm.tolist."""
    import warnings

    from kzg_snark_tpu_torch.utils import build

    k, n, bits, c = SCHEDULE_SHAPES[shape]
    sets = skewed_sets(k, n, "random", 70).to(cuda)
    mk.msm_schedule(sets, bits, c)
    torch.cuda.synchronize()
    build.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mk.msm_schedule(sets, bits, c)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    waits = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(waits) == 1
    assert build.sync_counts() == {"msm.tolist": 1}


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
def test_bucket_kernels_match_plain_on_edge_cases(cuda, curve_type):
    """The fold launch (the window totals' tree and the Horner fold on a
    warp's lanes) on ``fold_edge_partials`` at W = 32, c = 8 with 1, 3 and
    4 pieces a window: a total equal to the accumulator (the complete
    add's doubling), its opposite, empty windows, all-identity partials,
    four sets.  msm_accumulate (both adds) on [(i + 1) G] with every
    scalar 1, where a running sum meets its next point.  Then
    msm_accumulate and both reduce launches at c = 8 on 2^12 points, one
    set random and one all zero.  Word for word against the plain
    versions, the fold's launch counted."""
    from kzg_snark_tpu_torch import constants as C
    from kzg_snark_tpu_torch.ops.benchpoints import (fold_edge_partials,
                                                      generator_multiples,
                                                      random_point_basis)

    n, c = 1 << 12, 8
    fq = fq_backend(curve_type, cuda).consts
    pts, _ = random_point_basis(curve_type, n, seed=4, device=cuda)
    for pieces in (1, 3, 4):
        wp = fold_edge_partials(curve_type, pts, c, 32, pieces)
        before = LAUNCHES["msm_reduce"]
        got = mk.reduce_horner(fq, wp, 4, 32, c)
        assert LAUNCHES["msm_reduce"] == before + 1
        assert torch.equal(got, mk.horner_plain(fq, wp, 4, 32, c)), pieces
    r = C.BN254_R if curve_type == "bn254" else C.BLS12_381_R
    ones = torch.zeros((1, 8, 136), dtype=torch.int32)
    ones[0, 0] = 1
    s1 = mk.bucket_schedule(mk.signed_digits(ones.to(cuda), r.bit_length(),
                                             c), c)
    xy1 = mk.point_table(generator_multiples(curve_type, 136, cuda))
    for complete in (False, True):
        assert torch.equal(
            mk.msm_accumulate(fq, xy1, s1.entries, s1.chunk_off, complete),
            mk.msm_accumulate_plain(fq, xy1, s1.entries, s1.chunk_off,
                                    complete))
    sets = torch.stack([words(n, 26), torch.zeros((8, n), dtype=torch.int32)
                        ]).to(cuda)
    dig = mk.signed_digits(sets, r.bit_length(), c)
    W = dig.shape[1]
    assert W == 32
    s = mk.bucket_schedule(dig, c)
    xy = mk.point_table(pts)
    for complete in (False, True):
        part = mk.msm_accumulate(fq, xy, s.entries, s.chunk_off, complete)
        assert torch.equal(part, mk.msm_accumulate_plain(
            fq, xy, s.entries, s.chunk_off, complete))
    wparts = mk.reduce_window_sums(fq, part, s.bucket_chunks, 2 * W, c,
                                   s.window_threads)
    assert torch.equal(wparts, mk.window_sums_plain(
        fq, part, s.bucket_chunks, 2 * W, c, s.window_threads))
    got = mk.reduce_horner(fq, wparts, 2, W, c)
    assert torch.equal(got, mk.horner_plain(fq, wparts, 2, W, c))
    assert bool((got[2, :, 1] == 0).all())


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
    assert LAUNCHES["ntt_pass"] - before == rows * -(-k // tile_bits(n))
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


@pytest.mark.cuda
def test_world_one_over_nccl_equals_single_device(cuda):
    """One spawned rank over NCCL: the distributed NTT (2^12) and the
    distributed MSM (4096 points, the bucket route) equal to the
    single-device ones on the same inputs."""
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    from kzg_snark_tpu_torch.ops.limbs import to_tensor, to_words
    from kzg_snark_tpu_torch.ops.msm import msm_context
    from kzg_snark_tpu_torch.ops.ntt import ntt_context
    from kzg_snark_tpu_torch.parallel import dryrun

    n, N = 1 << 12, 4096
    pts, _ = random_point_basis("bn254", N, seed=9, device=cuda)
    words, scalars = dryrun.random_words(n, 3), dryrun.random_words(N, 4)
    cases = [{"op": "ntt", "curve": "bn254", "words": words},
             {"op": "msm", "method": "msm", "curve": "bn254",
              "points": pts.cpu().numpy(), "scalars": scalars}]
    (rank,) = dryrun.launch(dryrun.run_cases, 1, (cases,), backend="nccl",
                            device="cuda")
    ctx = ntt_context("bn254", n, cuda)
    x = ctx.backend.to_mont(to_tensor(words, cuda))
    assert np.array_equal(rank["cases"][0]["natural"], to_words(ctx.ntt(x)))
    assert np.array_equal(rank["cases"][0]["back"].reshape(8, n),
                          to_words(x))
    single = msm_context("bn254", cuda)
    assert rank["cases"][1]["affine"] == single.curve.to_affine_ints(
        single.msm(pts, to_tensor(scalars, cuda)))[0]


# The grouped MSM (ops/msm_grouped.py) and FK20 (ops/fk20.py).
GROUPED_SHAPES = [(3, 4, 5), (8, 3, 64), (2, 8, 128)]


def _grouped_inputs(curve_type, G, k, n, dev):
    """Bases: [(i + 1) G] for the first group (a bucket's running sum meets
    its next point), random points after; scalars random with the first set
    all zero and the second all equal (one bucket a window holds them all,
    in slots of CHUNK)."""
    from kzg_snark_tpu_torch.ops.benchpoints import (generator_multiples,
                                                      random_point_basis)
    pts, _ = random_point_basis(curve_type, G * n, seed=G + n, device=dev)
    pts[..., :n] = generator_multiples(curve_type, n, dev)
    sc = torch.stack([torch.stack([words(n, 100 * g + s) for s in range(k)])
                      for g in range(G)])
    sc[:, 0] = 0
    if k > 1:
        sc[:, 1] = sc[:, 1, :, :1]
    return pts, sc.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("curve_type", ["bn254", "bls12_381"])
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_grouped_kernels_match_plain(cuda, curve_type, shape):
    """Each grouped kernel against its plain version on the same inputs:
    the schedule's entries, offsets and slots, the accumulate (both adds),
    the window sums and the fold word for word; then the whole grouped MSM
    against the plain pipeline."""
    from kzg_snark_tpu_torch.ops import msm_grouped as mg
    from kzg_snark_tpu_torch.ops.msm import msm_context
    G, k, n = shape
    fq = fq_backend(curve_type, cuda).consts
    bits = fr_backend(curve_type, cuda).modulus.bit_length()
    pts, sc = _grouped_inputs(curve_type, G, k, n, cuda)
    plan = mg.grouped_plan(G, k, n, bits)
    before = dict(LAUNCHES)
    entries, offsets, slots = mg.grouped_schedule(sc, plan)
    assert LAUNCHES["msm_grouped_schedule"] == \
        before.get("msm_grouped_schedule", 0) + 1
    want = mg.grouped_schedule_plain(sc.cpu(), plan)
    for got, exp in zip((entries, offsets, slots), want):
        assert torch.equal(got.cpu(), exp)
    xy = mk.point_table(pts)
    for complete in (True, False) if curve_type == "bn254" else (True,):
        part = mg.grouped_accumulate(fq, xy, entries, offsets, slots, plan,
                                     complete)
        assert torch.equal(part.cpu(), mg.grouped_accumulate_plain(
            fq, xy.cpu(), *want, n, plan.cap, complete)), complete
    sums = mg.grouped_window_sums(fq, part, slots, plan)
    assert torch.equal(sums.cpu(), mg.grouped_window_sums_plain(
        fq, part.cpu(), want[2], plan.cap))
    out = mg.grouped_horner(fq, sums, plan)
    assert torch.equal(out.cpu(), mk.horner_plain(
        fq, sums.cpu(), G * k, plan.windows, plan.c))
    ctx = msm_context(curve_type, cuda)
    got = ctx.msm_grouped(pts, sc, complete=True)
    assert torch.equal(got.cpu(), msm_context(curve_type, "cpu").msm_grouped(
        pts.cpu(), sc.cpu(), complete=True))
    assert bool((got[2, :, :, 0] == 0).all())       # the all-zero sets


@pytest.mark.cuda
def test_fk20_full_blob_matches_plain_reference(cuda):
    """One full-size blob (n = 4096, cells of 64) at BLS12-381: its 128
    cells and 128 proofs by FK20 on the card against the benchmark's plain
    reference (the radix-2 extension and each cell's quotient at tau)."""
    from kzg_snark_tpu_torch.models.kzg import KZG
    from kzgbench.generator import make_pool
    from kzgbench.plain import cells as plain
    from kzgbench.plain.curves import CURVES
    from kzgbench.plain.reference import Reference
    from kzgbench.plain.transcript import field_bytes
    n, tau = 4096, 0x1234567890ABCDEF1234567890ABCDEF
    curve = CURVES["bls12_381"]
    kzg = KZG("bls12_381", backend="cuda", device=cuda)
    kzg.setup(n - 1, tau=tau)
    blobs = make_pool(curve.r, n, 1, 1, 2 ** 31 + 3, cuda)[0]
    cells, proofs = kzg.compute_cells_and_kzg_proofs(blobs)
    assert cells.shape == (8, 1, 128, 64)
    raw = field_bytes(cells.cpu().numpy().view(np.uint32).reshape(8, -1))
    want = plain.expected(Reference(curve, n, tau),
                          blobs.cpu().numpy().view(np.uint32))
    assert [raw[i:i + 2048] for i in range(0, len(raw), 2048)] == \
        want["evaluations"]
    assert proofs[0] == want["proofs"]
