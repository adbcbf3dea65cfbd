"""The port's MSM over a prepared point table, and its split into point
ranges, against ``msm`` and the host oracle.

``FusedMsm.prepare_points`` gives the (n, 2 L) table and
``FusedMsm.msm_prepared`` the MSM over it (the JAX pair); ``msm`` is the
two in turn, so on the bucket route (n = 2048, ``random_point_basis`` of
``test_torch_msm``) the prepared MSM gives ``msm``'s Jacobian words and
the oracle's affine points, for k = 1 and k = 3 sets.  With
``MAX_SCHEDULE_ENTRIES`` lowered (it is read at call time) the same MSM is
cut into five contiguous ranges, the last shorter, and the sum of the
ranges' results equals the unsplit run's affine points and the oracle's
with either ``complete`` setting.  ``bucket_schedule`` itself refuses a
shape whose int32 arrays could wrap, naming the limit, and
``prepare_points`` refuses a wrong shape, limb count, dtype or device.
Tolerance: exact.
"""

import functools

import numpy as np
import pytest
import torch

from kzg_snark_tpu_torch.ops import msm_kernel as mk
from kzg_snark_tpu_torch.ops.msm import MsmContext, msm_context

from test_torch_msm import R, basis, host_point

torch.set_num_threads(1)

N = 2048
RANGES = 5                  # the split of (b): four of 410 points, one of 408


def scalar_sets(k):
    """k seeded scalar sets of N: random ones, the first with 0, 1, r - 1
    and a duplicate."""
    rng = np.random.default_rng(2026 + k)
    sets = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(N)]
            for _ in range(k)]
    sets[0][:4] = [0, 1, R - 1, R - 1]
    return sets


def limbs(ctx, sets):
    lim = torch.stack([ctx.scalars_to_limbs(s) for s in sets])
    return lim if len(sets) > 1 else lim[0]


@functools.lru_cache(maxsize=None)
def unsplit(k):
    """(msm_prepared Jacobian, affine, oracle) of k sets over the basis."""
    assert MsmContext.route(N) == "bucket"
    pts, ks = basis(N)
    ctx = msm_context("bn254", "cpu")
    sets = scalar_sets(k)
    out = ctx.fused.msm_prepared(ctx.fused.prepare_points(pts),
                                 limbs(ctx, sets), complete=False)
    oracle = [host_point(sum(a * b for a, b in zip(s, ks))) for s in sets]
    return out, ctx.curve.to_affine_ints(out), oracle


@pytest.mark.parametrize("k", [1, 3])
def test_prepared_equals_msm_and_oracle(k):
    pts, _ = basis(N)
    ctx = msm_context("bn254", "cpu")
    out, affine, oracle = unsplit(k)
    assert out.shape == (3, 8, k)
    table = ctx.fused.prepare_points(pts)
    assert table.shape == (N, 16) and table.dtype == torch.int32
    assert torch.equal(table, mk.point_table(pts))
    want = ctx.fused.msm(pts, limbs(ctx, scalar_sets(k)), complete=False)
    assert torch.equal(out, want)
    assert affine == oracle


def split_limit(k):
    """A limit that cuts N points of k sets into RANGES ranges."""
    c = mk.window_bits(N // RANGES)
    return k * mk.num_windows(254, c) * -(-N // RANGES)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("complete", [False, True])
def test_split_ranges_equal_unsplit_and_oracle(monkeypatch, k, complete):
    pts, _ = basis(N)
    ctx = msm_context("bn254", "cpu")
    _, affine, oracle = unsplit(k)
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", split_limit(k))
    ranges = mk.point_ranges(N, k, 254)
    assert len(ranges) == RANGES >= 4
    assert ranges[0] == (0, 410) and ranges[-1] == (1640, N)
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    calls = []
    bucket = ctx.fused._bucket_msm

    def spy(table, sets, complete):
        calls.append(table.shape[0])
        return bucket(table, sets, complete)
    monkeypatch.setattr(ctx.fused, "_bucket_msm", spy)
    out = ctx.fused.msm_prepared(ctx.fused.prepare_points(pts),
                                 limbs(ctx, scalar_sets(k)), complete)
    assert calls == [b - a for a, b in ranges]
    got = ctx.curve.to_affine_ints(out)
    assert got == affine == oracle


def test_point_ranges_follow_the_limit(monkeypatch):
    """One range up to the limit; past it each range keeps its own bound
    (its own c and W) at or under the limit; refused below one point."""
    n = 1 << 20
    c = mk.window_bits(n)
    bound = mk.schedule_bound(8, n, mk.num_windows(254, c), c)
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", bound)
    assert mk.point_ranges(n, 8, 254) == [(0, n)]
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", bound - 1)
    ranges = mk.point_ranges(n, 8, 254)
    assert len(ranges) == 2 and ranges[-1][1] == n
    for a, b in ranges:
        cr = mk.window_bits(b - a)
        assert mk.schedule_bound(8, b - a, mk.num_windows(254, cr), cr) \
            <= bound - 1
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", 100)
    with pytest.raises(ValueError, match="MAX_SCHEDULE_ENTRIES = 100"):
        mk.point_ranges(16, 1, 254)
    # the real limit: 2^27 points of one set, or 2^24 of eight, split
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", 2 ** 31 - 1)
    assert len(mk.point_ranges(1 << 26, 1, 254)) == 1
    assert len(mk.point_ranges(1 << 27, 1, 254)) == 2
    assert len(mk.point_ranges(1 << 24, 8, 254)) == 2


def test_bucket_schedule_raises_past_the_limit(monkeypatch):
    """A direct call whose k W n exceeds the limit raises, naming E's
    bound, n, k and the limit, before any int32 cast."""
    n, k, c = 64, 2, 9
    digits = torch.ones((k, mk.num_windows(254, c), n), dtype=torch.int32)
    W = digits.shape[1]
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", k * W * n - 1)
    with pytest.raises(ValueError) as err:
        mk.bucket_schedule(digits, c)
    msg = str(err.value)
    assert f"MAX_SCHEDULE_ENTRIES = {k * W * n - 1}" in msg
    assert f"{k} sets x {W} windows x {n} points" in msg
    assert f"E = {k * W * n}" in msg
    # the bucket keys count too: 2^(c-1) buckets a window above n points
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", k * W * n)
    with pytest.raises(ValueError, match="buckets"):
        mk.bucket_schedule(digits, c)
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", k * W * 256)
    sched = mk.bucket_schedule(digits, c)
    assert sched.entries.numel() == k * W * n


def test_prepare_points_rejects_bad_input():
    pts, _ = basis(N)
    fused = msm_context("bn254", "cpu").fused
    with pytest.raises(ValueError, match=r"expected \(3, 8, n\)"):
        fused.prepare_points(pts[:, :6])                  # 6 limbs
    with pytest.raises(ValueError, match=r"expected \(3, 8, n\)"):
        fused.prepare_points(pts[0])                      # (8, n)
    with pytest.raises(ValueError, match="int32"):
        fused.prepare_points(pts.to(torch.int64))
    bls = msm_context("bls12_381", "cpu").fused
    with pytest.raises(ValueError, match=r"expected \(3, 12, n\)"):
        bls.prepare_points(pts)                           # BN254's 8 limbs
    with pytest.raises(ValueError, match="msm_prepared: table"):
        fused.msm_prepared(fused.prepare_points(pts[..., :64]),
                           torch.zeros((8, 65), dtype=torch.int32))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="points on"):
            fused.prepare_points(pts.cuda())
