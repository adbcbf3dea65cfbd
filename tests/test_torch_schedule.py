"""The bucket schedule's plain entry point against the reference, and the
plan its kernels read.

``msm_schedule`` (on CPU tensors: ``msm_digits_plain``, ``msm_sort_plain``
and ``msm_bucket_offsets_plain``, the kernels' steps in plain torch) must
give what ``bucket_schedule(signed_digits(...))`` gives: the same entries,
chunk offsets, bucket chunk offsets and reduce threads, so the accumulate's
partials and the MSM's results cannot change.  Covered: c in {7, 10, 14},
k in {1, 8}, both curves' scalar bit lengths, random, all-equal,
one-nonzero and small scalars and an all-zero set, at n = 5000 (a segment
of five tiles of 1024, the last ragged), and n across tile edges and
tile sizes.  The plan (passes and bins by c, tiles by n, buffer sizes) at
both cells' shapes and at the range split's edge; one counted host wait a
schedule.
"""

import numpy as np
import pytest
import torch

from kzg_snark_tpu_torch.ops import msm_kernel as mk
from kzg_snark_tpu_torch.ops.limbs import to_tensor
from kzg_snark_tpu_torch.ops.msm_kernel import FusedMsm
from kzg_snark_tpu_torch.utils import build

torch.set_num_threads(1)

SKEWS = ["random", "all-equal", "one-nonzero", "small", "zero-set"]


def skewed_scalars(k: int, n: int, bits: int, skew: str, seed: int = 1):
    """(k, 8, n) canonical limbs below 2^(bits - 1): uniform, every point of
    a set equal, one nonzero point a set, 10-bit values, or the last set
    all zero (the only set when k = 1)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(k, 8, n), dtype=np.uint64)
    w[:, 7] &= (1 << (bits - 225)) - 1
    if skew == "all-equal":
        w[:] = w[:, :, :1]
    elif skew == "one-nonzero":
        one = w[:, :, n // 3].copy()
        w[:] = 0
        w[:, :, n // 3] = one
    elif skew == "small":
        w[:, 1:] = 0
        w[:, 0] &= 0x3FF
    elif skew == "zero-set":
        w[-1] = 0
    return to_tensor(w.astype(np.uint32), "cpu")


def assert_same_schedule(got: mk.BucketSchedule, want: mk.BucketSchedule):
    for field in ("entries", "chunk_off", "bucket_chunks"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert got.window_threads == want.window_threads


def reference(scalars, bits, c):
    return mk.bucket_schedule(mk.signed_digits(scalars, bits, c), c)


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("bits", [254, 255], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("c", [7, 10, 14])
def test_plain_schedule_equals_the_reference(c, k, bits, skew):
    scalars = skewed_scalars(k, 5000, bits, skew)
    got = mk.msm_schedule(scalars, bits, c)
    assert_same_schedule(got, reference(scalars, bits, c))
    if skew == "zero-set" and k == 1:
        assert got.entries.numel() == 0 and got.chunk_off.tolist() == [0]


@pytest.mark.parametrize("n", [1, 511, 513, 4096, 4097, 33000])
def test_plain_schedule_across_tile_edges(n):
    scalars = skewed_scalars(3, n, 254, "random", seed=n)
    assert_same_schedule(mk.msm_schedule(scalars, 254, 9),
                         reference(scalars, 254, 9))


def test_plain_steps_hold_their_own_contracts():
    """The steps' outputs: the digits in (set, window, point) order with the
    first pass's tile histograms; the sorted keys ascending (bucket order)
    and base the nonzero digits' scan; each bucket's chunks at most CHUNK
    entries, the chunk offsets rising to E."""
    k, n, c, bits = 2, 5000, 14, 254
    scalars = skewed_scalars(k, n, bits, "random", seed=3)
    plan = mk.schedule_plan(k, n, mk.num_windows(bits, c), c)
    keys, pay, hist = mk.msm_digits(scalars, plan)
    dig = mk.signed_digits(scalars, bits, c).reshape(-1).to(torch.int64)
    mag = dig & mk.MAG_MASK
    seg = torch.arange(plan.digits) // n
    assert torch.equal(keys.to(torch.int64),
                       torch.where(mag > 0, seg * plan.half + mag - 1, -1))
    assert torch.equal(pay.to(torch.int64),
                       (torch.arange(plan.digits) % n) << 1
                       | dig >> mk.SIGN_SHIFT)
    assert (plan.tile, plan.tiles) == (1024, 5)
    assert hist.shape == (plan.segments, 1 << plan.passes[0][1], 5)
    assert int(hist.sum()) == int((mag > 0).sum())
    keys, pay, base = mk.msm_sort(keys, pay, hist, plan)
    nonzero = (mag > 0).reshape(plan.segments, n).sum(1)
    assert base.tolist() == [0] + torch.cumsum(nonzero, 0).tolist()
    E = int(base[-1])
    assert bool((keys[:E].diff() >= 0).all())
    sorted_pay = pay.clone()
    bco, chunk_off, runs, info = mk.msm_bucket_offsets(keys, pay, base, plan)
    assert plan.run == 0 and runs.numel() == plan.run_capacity == 1
    assert torch.equal(pay, sorted_pay)     # no chunk-start bits
    C, busiest, entries = info.tolist()
    assert entries == E and int(bco[-1]) == C
    assert chunk_off.numel() == plan.chunk_capacity
    lengths = chunk_off[:C + 1].diff()
    assert bool((lengths >= 1).all()) and bool((lengths <= mk.CHUNK).all())
    per_window = bco[plan.half::plan.half] - bco[:-1:plan.half]
    assert busiest == int(per_window.max())


@pytest.mark.parametrize("name, sets, n, bits, c, passes, tile", [
    ("kzg2e20 commit", 8, 1 << 20, 254, 14, ((0, 7), (7, 6)), 4096),
    ("kzg2e20 proof", 1, 1 << 20, 254, 14, ((0, 7), (7, 6)), 4096),
    ("blob commit", 9, 4096, 255, 10, ((0, 9),), 512),
    ("plonk 2^11", 1, 1 << 11, 254, 9, ((0, 8),), 512),
    ("plonk 2^16", 1, 1 << 16, 254, 10, ((0, 9),), 4096),
    ("marlin 2^18", 1, 1 << 18, 254, 12, ((0, 6), (6, 5)), 4096),
])
def test_schedule_plan_at_the_paths_shapes(name, sets, n, bits, c, passes,
                                           tile):
    assert mk.window_bits(n) == c
    W = mk.num_windows(bits, c)
    plan = mk.schedule_plan(sets, n, W, c)
    assert (plan.passes, plan.tile) == (passes, tile)
    assert plan.tiles == -(-n // tile) and tile % 256 == 0
    assert plan.digits == sets * W * n
    assert plan.buckets == sets * W << (c - 1)
    assert plan.run == mk.accumulate_run(sets, W, n, c)
    per = (-(-plan.digits // plan.run) if plan.run
           else plan.digits // mk.CHUNK)
    assert plan.chunk_capacity == min(plan.digits,
                                      per + plan.buckets) + 1
    # The digits kernel's tile histograms fit a block's shared memory.
    assert 4 * W << passes[0][1] <= 227 * 1024


def test_schedule_plan_passes_and_bins_by_c():
    got = {c: mk.schedule_plan(1, 2048, mk.num_windows(254, c), c).passes
           for c in range(2, mk.MAX_WINDOW_BITS + 1)}
    for c, passes in got.items():
        assert sum(b for _, b in passes) == c - 1
        assert [s for s, _ in passes] == [0] + list(
            np.cumsum([b for _, b in passes])[:-1])
        assert max(b for _, b in passes) <= mk.MAX_PASS_BITS
        assert passes[0][1] == max(b for _, b in passes)
        assert len(passes) == (1 if c <= mk.MAX_PASS_BITS + 1 else 2)
    assert got[16] == ((0, 8), (8, 7)) and got[11] == ((0, 5), (5, 5))
    with pytest.raises(ValueError, match="window width"):
        mk.schedule_plan(1, 2048, 128, 1)


def test_schedule_plan_at_the_range_split_edge(monkeypatch):
    """At B = MAX_SCHEDULE_ENTRIES the plan is made; one more and it
    raises, as ``bucket_schedule`` does, and every range of
    ``point_ranges`` gets a plan."""
    k, n, bits = 8, 5000, 254
    c = mk.window_bits(n)
    W = mk.num_windows(bits, c)
    edge = mk.schedule_bound(k, n, W, c)
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", edge)
    plan = mk.schedule_plan(k, n, W, c)
    assert plan.digits == edge and plan.chunk_capacity <= edge + 1
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES", edge - 1)
    with pytest.raises(ValueError, match="MAX_SCHEDULE_ENTRIES"):
        mk.schedule_plan(k, n, W, c)
    scalars = skewed_scalars(k, n, bits, "random")
    with pytest.raises(ValueError, match="MAX_SCHEDULE_ENTRIES"):
        mk.msm_schedule(scalars, bits, c)
    ranges = mk.point_ranges(n, k, bits)
    assert len(ranges) == 2
    for a, b in ranges:
        m = b - a
        cm = mk.window_bits(m)
        mk.schedule_plan(k, m, mk.num_windows(bits, cm), cm)


def test_msm_schedule_waits_once_and_the_fused_msm_takes_it():
    scalars = skewed_scalars(2, 3000, 254, "random", seed=9)
    build.reset_launches()
    got = mk.msm_schedule(scalars, 254, 9)
    assert build.sync_counts() == {"msm.tolist": 1}
    assert build.launch_counts() == {}
    fused = FusedMsm("bn254", "cpu")
    k, c, W, sched = fused.schedule(scalars, 3000)
    assert (k, c, W) == (2, mk.window_bits(3000),
                         mk.num_windows(fused.total_bits, c))
    assert_same_schedule(sched, reference(scalars, fused.total_bits, c))
    assert_same_schedule(got, reference(scalars, 254, 9))


# ---------------------------------------------------------------------------
# The accumulate's route (``accumulate_run``): the chunk route's words are
# the parent design's, the range route's runs are the reference's.
# ---------------------------------------------------------------------------


def chunk_route_reference(digits, c):
    """The chunk route as one independent computation: each bucket's run
    of the stably sorted nonzero digits cut every CHUNK entries, reduce
    threads at EVENTS_PER_THREAD events; (entries, chunk_off,
    bucket_chunks, window_threads)."""
    k, W, n = digits.shape
    half = 1 << (c - 1)
    flat = digits.reshape(-1).to(torch.int64)
    mag = flat & mk.MAG_MASK
    sel = torch.nonzero(mag).squeeze(1)
    key = (sel // n) * half + mag[sel] - 1
    order = torch.sort(key, stable=True)[1]
    entries = ((sel % n) << 1 | flat[sel] >> mk.SIGN_SHIFT)[order]
    counts = torch.bincount(key, minlength=k * W * half).tolist()
    offs, bco, pos = [], [0], 0
    for m in counts:
        offs += list(range(pos, pos + m, mk.CHUNK))
        pos += m
        bco.append(len(offs))
    busiest = max(bco[w * half + half] - bco[w * half] for w in range(k * W))
    threads = 1 << ((busiest + half) // mk.EVENTS_PER_THREAD).bit_length() - 1
    return (entries.to(torch.int32), torch.tensor(offs + [pos]).int(),
            torch.tensor(bco).int(), min(threads, mk.MAX_WINDOW_THREADS))


@pytest.mark.parametrize("skew", ["random", "all-equal", "zero-set"])
def test_blob_shape_keeps_the_chunk_routes_words(skew):
    """The blob cells' MSMs (nine sets of 4096 at BLS12-381, c = 10) take
    the chunk route, and its schedule is the parent design's word for word:
    no run chunks, the chunk offsets every CHUNK entries of a bucket."""
    k, n, bits = 9, 4096, 255
    c = mk.window_bits(n)
    W = mk.num_windows(bits, c)
    assert mk.accumulate_run(k, W, n, c) == 0
    assert mk.schedule_plan(k, n, W, c).run == 0
    scalars = skewed_scalars(k, n, bits, skew, seed=21)
    got = mk.msm_schedule(scalars, bits, c)
    entries, chunk_off, bco, threads = chunk_route_reference(
        mk.signed_digits(scalars, bits, c), c)
    assert got.run_chunks is None
    assert torch.equal(got.entries, entries)
    assert torch.equal(got.chunk_off, chunk_off)
    assert torch.equal(got.bucket_chunks, bco)
    assert got.window_threads == threads


def rule_run(sets, n, bits):
    """L by the rule's own arithmetic: the smaller of E / ACC_FILL_THREADS
    and E / B rounded down to a power of two, or 0 where that is not above
    CHUNK or the chunk route writes fewer partials at an even load."""
    c = mk.window_bits(n)
    W = mk.num_windows(bits, c)
    E, B = sets * W * n, sets * W << (c - 1)
    run = 1 << min(E // mk.ACC_FILL_THREADS, E // B).bit_length() - 1
    chunked = B * -(-(-(-E // B)) // mk.CHUNK)
    return run if run > mk.CHUNK and E // run + B < chunked else 0


@pytest.mark.parametrize("name, sets, n, bits, route", [
    ("kzg2e20 commit", 8, 1 << 20, 254, "ranges"),
    ("kzg2e20 proof", 1, (1 << 20) - 1, 254, "ranges"),
    ("blob commit and proof", 9, 4096, 255, "chunks"),
    ("peerdas commit", 9, 4096, 255, "chunks"),
    ("plonk 2^16", 1, 1 << 16, 254, "chunks"),
    ("bls plonk 2^16", 1, 1 << 16, 255, "chunks"),
])
def test_route_choice_from_the_shapes(name, sets, n, bits, route):
    """The route by (k, W, n, c) alone: both 2^20 calls of the 2^20 cell
    take the range route with the rule's L, which writes fewer partials
    than the chunk route; the blob cells' and the provers' 2^16 MSMs keep
    the chunk route."""
    c = mk.window_bits(n)
    W = mk.num_windows(bits, c)
    run = mk.accumulate_run(sets, W, n, c)
    assert ("ranges" if run else "chunks") == route
    assert run == rule_run(sets, n, bits)
    plan = mk.schedule_plan(sets, n, W, c)
    assert plan.run == run
    if run:
        assert run & (run - 1) == 0 and run > mk.CHUNK
        E, B = plan.digits, plan.buckets
        assert E // run >= mk.ACC_FILL_THREADS and run <= E // B
        assert E // run + B < B * -(-(E // B) // mk.CHUNK)
        assert plan.run_capacity == -(-E // run) + 1


def test_route_rule_follows_the_fill_constant(monkeypatch):
    """L halves as ACC_FILL_THREADS doubles, and stops at a bucket's even
    load (128 entries at 8 sets of 2^20, c = 14); at or below CHUNK, or
    where the buckets are too light for fewer partials, the chunk route."""
    k, n, c = 8, 1 << 20, 14
    W = mk.num_windows(254, c)
    E = k * W * n
    for fill, want in [(E // 1024, 128), (E // 128, 128), (E // 64, 64),
                       (E // 32, 32), (E // 16, 0), (E, 0)]:
        monkeypatch.setattr(mk, "ACC_FILL_THREADS", fill)
        assert mk.accumulate_run(k, W, n, c) == want
    monkeypatch.setattr(mk, "ACC_FILL_THREADS", 1)
    # Eight entries a bucket (the blob shape's load): never the range route.
    assert mk.accumulate_run(9, 26, 4096, 10) == 0
    assert mk.accumulate_run(1, 26, 1 << 12, 10) == 0


# Small shapes that take the range route when ACC_FILL_THREADS is lowered:
# c = 4 and 5 make 8 and 16 buckets a window, so 600 points load each with
# about 75 and 37 entries (runs of 64 and 32).
RANGE_FILL = 512


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("k, c", [(1, 5), (3, 5), (3, 4)])
def test_plain_range_schedule_equals_the_reference(monkeypatch, k, c, skew):
    """On the range route msm_schedule's plain steps give the reference's
    entries, chunk offsets, bucket chunk offsets, run chunks and reduce
    threads; every chunk lies in one bucket, every run start and every
    nonempty bucket's start begins a chunk, and the buffers hold C + 1 and
    R + 1."""
    monkeypatch.setattr(mk, "ACC_FILL_THREADS", RANGE_FILL)
    n, bits = 600, 254
    W = mk.num_windows(bits, c)
    plan = mk.schedule_plan(k, n, W, c)
    L = plan.run
    assert L > mk.CHUNK
    scalars = skewed_scalars(k, n, bits, skew, seed=k + c)
    got = mk.msm_schedule(scalars, bits, c)
    ref = reference(scalars, bits, c)
    assert_same_schedule(got, ref)
    assert torch.equal(got.run_chunks, ref.run_chunks)
    E, C = got.entries.numel(), got.chunk_off.numel() - 1
    R = -(-E // L)
    assert got.run_chunks.numel() == R + 1 and int(got.run_chunks[-1]) == C
    assert C + 1 <= plan.chunk_capacity and R + 1 <= plan.run_capacity
    off = got.chunk_off.to(torch.int64)
    assert torch.equal(off[got.run_chunks[:-1].long()],
                       torch.arange(0, E, L))
    assert bool((off.diff() >= 1).all()) if C else E == 0
    # Every chunk in one bucket, every nonempty bucket's start a chunk's.
    dig = mk.signed_digits(scalars, bits, c).reshape(-1).to(torch.int64)
    mag = dig & mk.MAG_MASK
    sel = torch.nonzero(mag).squeeze(1)
    keys = torch.sort((sel // n) * plan.half + mag[sel] - 1)[0]
    bco = got.bucket_chunks.to(torch.int64)
    owner = torch.repeat_interleave(torch.arange(plan.buckets), bco.diff())
    assert torch.equal(keys[off[:-1]], owner)
    assert torch.equal(keys[off[1:] - 1], owner)
    starts = torch.nonzero(torch.cat([torch.ones(min(E, 1), dtype=torch.bool),
                                      keys.diff() != 0])).squeeze(1)
    assert bool(torch.isin(starts, off).all())


def test_fused_msm_counts_its_route(monkeypatch):
    """FusedMsm counts each bucket MSM call on its route with the partials
    its accumulate wrote; reset_launches zeroes the count."""
    pts_n, bits = 2048, 254
    fused = FusedMsm("bn254", "cpu")
    from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
    pts, _ = random_point_basis("bn254", pts_n, seed=5, device="cpu")
    sc = skewed_scalars(2, pts_n, bits, "random", seed=6)
    build.reset_launches()
    fused.schedule(sc, pts_n)                 # a schedule alone counts none
    assert build.msm_route_counts() == {}
    fused.msm(pts, sc)
    _, c, W, sched = fused.schedule(sc, pts_n)
    assert build.msm_route_counts() == {"chunks": {
        "calls": 1, "partials": sched.chunk_off.numel() - 1}}
    monkeypatch.setattr(mk, "window_bits", lambda n: 6)
    monkeypatch.setattr(mk, "ACC_FILL_THREADS", 4096)
    _, c, W, sched = fused.schedule(sc, pts_n)
    assert c == 6 and sched.run_chunks is not None
    fused.msm(pts, sc)
    assert build.msm_route_counts()["ranges"] == {
        "calls": 1, "partials": sched.chunk_off.numel() - 1}
    build.reset_launches()
    assert build.msm_route_counts() == {}
