"""Pippenger MSM of the bucket route (n >= 2048): sorted buckets on the card.

Counterpart of ``kzg_snark_tpu/ops/msm_kernel.py`` ``FusedMsm``, redesigned
for the H100 (``csrc/msm_schedule_kernels.cu``, ``csrc/msm_kernels.cu``,
``csrc/msm.cuh``):

1. ``msm_digits``: one pass from the scalars to signed c-bit window digits
   (c by n, ``window_bits``, a measured table), each written as an int32
   sort key (set, window, mag - 1), -1 for a zero digit, and a payload
   point index << 1 | sign, with the first sort pass's tile histograms;
2. the schedule: ``msm_sort``, stable counting passes by magnitude inside
   each (set, window) segment (``SchedulePlan.passes``: one of c - 1 bits
   up to c = 10, two above), the first dropping the zero digits; then
   ``msm_bucket_offsets``: each bucket's count from its run in the sorted
   keys, its run cut into chunks (below), the chunk offsets written a
   bucket a thread;
3. ``msm_accumulate`` (K8): each thread mixed-adds the points of its chunks
   into a Jacobian accumulator in registers and writes a partial a chunk;
4. ``msm_reduce`` (in place of the K6 / K7 chains): window sums
   sum_m m B_m from the chunk partials (one launch), then the window
   totals (a halving tree) and the Horner fold over windows, one warp a
   scalar set (a second launch).

How the sorted entries become chunks, one partial each, is the route, chosen
from the MSM's shapes alone (``accumulate_run``, ``csrc/msm_chunks.cuh``):

- the chunk route: each bucket's run cut every ``CHUNK`` = 16 entries, one
  accumulate thread a chunk.  A bucket of m entries writes ceil(m / 16)
  partials, which the window sums merge back with complete adds: at 2^20
  points (128-256 entries a bucket) about three quarters of their work.
- the range route: each accumulate thread walks a run of L consecutive
  sorted entries (across bucket and segment bounds), storing its partial
  at each bucket's end and starting the next bucket's from its first
  point; the chunks are the pieces the run and bucket bounds cut, about
  E / L + the nonempty buckets.  ``BucketSchedule.run_chunks`` gives each
  run's first chunk, and each chunk's first entry carries ``CHUNK_START``
  (bit 31), so the walk holds no offsets in its loop.  What bounds L: the
  E / L runs must still fill the card (``ACC_FILL_THREADS``), and past a
  bucket's load a longer run saves few partials; the route is taken only
  where that leaves L above ``CHUNK`` and writes fewer partials than the
  chunk route: the 2^20 MSMs (L = 128) and Marlin's 2^18 commit (L = 32),
  not the blob cells' n = 4096 nor the provers' 2^16.  The window sums
  then launch at most about one wave (``RANGE_WINDOW_THREADS``).

Either way the chunks are in bucket order and each lies in one bucket, so the
window sums read them alike; only the split of a bucket's sum between the
accumulate (a mixed add an entry) and the window sums (a complete add a
partial) moves.  Each MSM call counts its route and partials
(``utils/build.count_msm_route``).

``msm_schedule`` runs 1 and 2; its plan comes from the shapes alone
(``schedule_plan``).  It gives what ``bucket_schedule(signed_digits(...))``,
the plain torch reference of the same steps, gives: the same entries, chunk
offsets, bucket chunk offsets, run chunks and reduce threads.

While a profiler records, ``FusedMsm`` opens a span a step:
``msm.table`` (the point table), ``msm.schedule`` (1 and 2),
``msm.accumulate`` (3) and ``msm.reduce`` (4).  The schedule makes the host
wait for the card once a call, counted (``count_sync("msm.tolist")``): the
chunk total C, the busiest window's chunks and the entry count E, read
together, which the accumulate's grid and the reduce's threads need.

Each kernel has its plain PyTorch version here, with the same task list
and combine order, so the two give the same Jacobian representatives and
the same schedule words.  A wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches its kernel or raises.

``complete=False`` uses the incomplete mixed add in the accumulate, sound
for duplicate-free unstructured bases (SRS powers, ``random_point_basis``);
pass ``complete=True`` for structured bases such as [(i+1) G].  The
default, None, reads ``KZG_TPU_COMPLETE_ADD`` at call time
(``resolve_complete``).  The reduction always uses complete adds.

Points are (3, L, n) over the base field, L = ``fc.num_limbs`` (8 at
BN254, 12 at BLS12-381); scalars (8, n) Fr limbs on both curves.
``FusedMsm.prepare_points`` lays the points out once as the (n, 2 L)
point-major table the accumulate reads, and ``FusedMsm.msm_prepared`` runs
the MSM over such a table (the JAX pair of the same names; ``msm`` is the
two in turn).  The table needs no padding: zero digits are dropped from
the schedule, not routed to a trash bucket.

The schedule's arrays are int32, as the kernels read them.  Each is
bounded by B = k W max(n, 2^(c-1)) for k sets of W windows over n points:
``entries`` holds index << 1 | sign < 2 n <= B (W >= 16), so bit 31 is
free for the range route's ``CHUNK_START``; ``chunk_off`` holds entry
offsets up to E, the nonzero digits, at most k W n; the bucket keys and
``bucket_chunks`` stay below k W 2^(c-1) buckets and C <= E chunks.  ``schedule_plan`` and ``bucket_schedule`` raise ValueError when B
exceeds ``MAX_SCHEDULE_ENTRIES`` (2^31 - 1), so no cast can wrap, and
``msm_prepared`` cuts an MSM into contiguous point ranges whose own B
stays at or under it (``point_ranges``, from the shapes alone): each range
is its own schedule, accumulate and reduce over a row slice of the table,
with point indices local to it, and the range results are summed in order
with the complete add (K6).  The limit is read at call time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import env_complete_add
from ..utils.build import (check, count_launch, count_msm_route, count_sync,
                           cuda_lib)
from ..utils.profiling import span
from . import cuda_fr
from .fr import canonical_device, fr_backend
from .g1 import curve_ops
from .limbs import FieldConsts

MAX_WINDOW_BITS = 16        # digit magnitudes fit the 16 bits below the sign
CHUNK = 16                  # most entries a chunk on the chunk route
# The fewest accumulate threads that still fill an H100: about two waves of
# k_msm_accumulate<false, 8> (132 SMs x 4 blocks of 128).  Measured at the
# 2^20 cell's calls: a mixed add cost the same from 1.2 M runs down to
# about 0.16 M and 20 % more at 82 K (chip_smoke.py --routes).
ACC_FILL_THREADS = 1 << 17
EVENTS_PER_THREAD = 8       # window-sum events a reduce thread, busiest window
# The most window-sum threads of a range-route call: about one wave of
# k_msm_window_sums<8> (132 SMs x 2 blocks of 128).  With a quarter of the
# chunk route's events, more threads only add c-bit tails (measured: 8
# sets at 2^20 took 2.88 ms at 128 threads a window, 4.31 at 1024).
RANGE_WINDOW_THREADS = 1 << 15
MAX_WINDOW_THREADS = 1024
REDUCE_BLOCK = 128          # most threads of a window-sum block
MAX_FOLD_PARTIALS = 256     # most block partials a set of the fold launch
MAG_MASK = 0xFFFF
SIGN_SHIFT = 16
CHUNK_START = -(1 << 31)    # bit 31 of a range-route entry: starts a chunk
MAX_SCHEDULE_ENTRIES = 2 ** 31 - 1  # bound of the schedule's int32 arrays
SORT_TILES = (512, 4096)    # least and most entries a tile of the sort
MAX_PASS_BITS = 9           # key bits a counting pass sorts by: 512 bins


# Window width c by log2 n: the c of least kernel time (accumulate and
# reduce on one H100, chip_smoke.py's msm table; the reduction's cost grows
# with the 2^(c-1) buckets a window, so c stays below log2 n - 3).  Above
# the table, one more bit for each doubling of n.
WINDOW_BITS_BY_LOG_N = {11: 9, 12: 10, 13: 10, 14: 10, 15: 10, 16: 10,
                        17: 12, 18: 12}


def resolve_complete(complete: bool | None) -> bool:
    """An explicit bool wins; None reads KZG_TPU_COMPLETE_ADD now ("1",
    "true" or "on" mean complete), never at construction: the contexts
    are cached (the JAX ``FusedMsm._resolve_complete``)."""
    if complete is not None:
        return complete
    return env_complete_add()


def window_bits(n: int) -> int:
    """Window width c for n points (the bucket route: n >= 2^11)."""
    lg = max(n, 1).bit_length() - 1
    lo, hi = min(WINDOW_BITS_BY_LOG_N), max(WINDOW_BITS_BY_LOG_N)
    if lg > hi:
        return min(WINDOW_BITS_BY_LOG_N[hi] + lg - hi, MAX_WINDOW_BITS)
    return WINDOW_BITS_BY_LOG_N[max(lg, lo)]


def num_windows(bits: int, c: int) -> int:
    """ceil((bits + 1) / c): the top window has a free bit, so with scalars
    below 2^bits its digit plus the carry into it stays at most 2^(c-1)."""
    return -(-(bits + 1) // c)


def signed_digits(scalars: torch.Tensor, total_bits: int, c: int
                  ) -> torch.Tensor:
    """Canonical scalars (..., 8, n) int32 limbs -> signed window digits
    (..., W, n) int32, encoded mag | sign << 16, mag in [0, 2^(c-1)].

    The recoding of the JAX ``signed_digits``: raw digit plus carry at or
    above 2^(c-1) becomes raw + carry - 2^c with a carry into the next
    window (its sign bit set, even where the magnitude is 0); the top
    window takes the last carry.  The carry chain is resolved for all
    windows at once: a window generates a carry if raw >= 2^(c-1) and
    passes one on if raw = 2^(c-1) - 1, so the carry into window w is the
    generate bit of the last window below w that does not pass one on.
    """
    if not 2 <= c <= MAX_WINDOW_BITS:
        raise ValueError(f"window width {c} outside 2..{MAX_WINDOW_BITS}")
    half, full = 1 << (c - 1), 1 << c
    limb, shift, pos, below_top = _window_index(total_bits, c, scalars.device)
    words = cuda_fr._wide(scalars)                          # (..., 8, n)
    nxt = torch.nn.functional.pad(words[..., 1:, :], (0, 0, 0, 1))
    pairs = words | (nxt << 32)           # limb j and j + 1; bit 63 wraps
    raw = (pairs.index_select(-2, limb) >> shift) & (full - 1)
    gen = raw >= half
    last = torch.where(raw == half - 1, -1, pos).cummax(dim=-2).values
    carry_out = gen.gather(-2, last.clamp(min=0)) & (last >= 0)
    v = raw + torch.nn.functional.pad(carry_out[..., :-1, :], (0, 0, 1, 0))
    flip = (v >= half) & below_top
    mag = torch.where(flip, full - v, v)
    return (mag | (flip.to(torch.int64) << SIGN_SHIFT)).to(torch.int32)


_WINDOW_INDEX: dict = {}


def _window_index(total_bits: int, c: int, device):
    """Per window: its low limb, its shift in the limb pair, its position
    (W, 1) and whether it is below the top window."""
    key = (total_bits, c, str(device))
    if key not in _WINDOW_INDEX:
        W = num_windows(total_bits, c)
        bit = torch.arange(W, device=device) * c
        pos = torch.arange(W, device=device).reshape(W, 1)
        _WINDOW_INDEX[key] = (bit >> 5, (bit & 31).reshape(W, 1), pos,
                              pos < W - 1)
    return _WINDOW_INDEX[key]


class BucketSchedule(NamedTuple):
    """The sorted entries of one MSM and their chunks.

    entries:   (E,) int32 point index << 1 | sign, in bucket order; on the
        range route each chunk's first entry | ``CHUNK_START`` (bit 31).
    chunk_off: (C + 1,) int32 entry offsets of the chunks.
    bucket_chunks: (nb + 1,) int32 chunk offsets of the buckets, nb =
        sets * windows * 2^(c-1), bucket key (set * W + w) 2^(c-1) + mag - 1.
    window_threads: reduce threads a window (a power of two).
    run_chunks: on the range route (R + 1,) int32, the first chunk of each
        run of L entries (run r starts at entry r L) and C last; None on
        the chunk route.
    """
    entries: torch.Tensor
    chunk_off: torch.Tensor
    bucket_chunks: torch.Tensor
    window_threads: int
    run_chunks: torch.Tensor | None = None


def schedule_bound(sets: int, n: int, windows: int, c: int) -> int:
    """B = k W max(n, 2^(c-1)): no value of the schedule's int32 arrays
    (entry offsets up to the k W n nonzero digits, bucket keys, point
    index << 1 | sign) reaches it."""
    return sets * windows * max(n, 1 << (c - 1))


def point_ranges(n: int, sets: int, total_bits: int) -> list:
    """Contiguous (start, stop) ranges of n points, as few as keep each
    range's ``schedule_bound`` (its c and W by ``window_bits`` of its own
    length) at or under ``MAX_SCHEDULE_ENTRIES``; equal lengths but the
    last.  From the shapes alone: no sync on the digits."""
    limit = MAX_SCHEDULE_ENTRIES

    def bound(m):
        c = window_bits(m)
        return schedule_bound(sets, m, num_windows(total_bits, c), c)

    parts = max(1, -(-bound(n) // limit))
    while parts <= n:
        size = -(-n // parts)
        last = n - (-(-n // size) - 1) * size
        if bound(size) <= limit and bound(last) <= limit:
            return [(a, min(a + size, n)) for a in range(0, n, size)]
        parts += 1
    raise ValueError(f"MSM of {sets} sets: even one point exceeds "
                     f"MAX_SCHEDULE_ENTRIES = {limit}")


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def _check_bound(k: int, W: int, n: int, c: int, name: str) -> None:
    bound = schedule_bound(k, n, W, c)
    if bound > MAX_SCHEDULE_ENTRIES:
        raise ValueError(
            f"{name}: {k} sets x {W} windows x {n} points give up "
            f"to E = {k * W * n} entries ({k * W << (c - 1)} buckets), bound "
            f"{bound} > MAX_SCHEDULE_ENTRIES = {MAX_SCHEDULE_ENTRIES}: the "
            f"int32 schedule would wrap; split the points into ranges "
            f"(point_ranges)")


def accumulate_run(sets: int, windows: int, n: int, c: int) -> int:
    """The accumulate's route for k = ``sets`` sets of W = ``windows``
    c-bit windows over n points, from the shapes alone: L, the entries a
    run of the range route, or 0 for the chunk route.

    With E = k W n digits (every digit nonzero, the most there can be) and
    B = k W 2^(c-1) buckets: L is the smaller of E / ``ACC_FILL_THREADS``
    (the runs fill the card) and E / B, a bucket's entries at an even load
    (past it the runs' partials are fewer than the buckets', and a longer
    run saves little), rounded down to a power of two.  The range route is
    taken where L > ``CHUNK`` and its partials at an even load, E / L + B,
    are fewer than the chunk route's, B ceil((E / B) / CHUNK).  Measured at
    the 2^20 cell's calls (``chip_smoke.py --routes``): L = 128 for both,
    the least accumulate and window-sum time of L in 32 .. 1024."""
    digits = sets * windows * n
    buckets = sets * windows << (c - 1)
    run = _pow2_floor(min(digits // ACC_FILL_THREADS, digits // buckets))
    if run <= CHUNK:
        return 0
    load = -(-digits // buckets)
    chunked = buckets * -(-load // CHUNK)
    return run if digits // run + min(buckets, digits) < chunked else 0


def _window_threads(busiest: int, half: int, events_per_thread: int) -> int:
    """Reduce threads a window: the busiest window's chunks plus its
    2^(c-1) steps over ``events_per_thread``, a power of two."""
    return min(_pow2_floor((busiest + half) // events_per_thread),
               MAX_WINDOW_THREADS)


def window_threads(busiest: int, half: int, windows: int, run: int) -> int:
    """Reduce threads a window on the route of ``run``: ``EVENTS_PER_THREAD``
    events a thread (``_window_threads``); on the range route (run > 0) at
    most ``RANGE_WINDOW_THREADS`` over the call's windows, a power of
    two."""
    tpw = _window_threads(busiest, half, EVENTS_PER_THREAD)
    if run:
        tpw = min(tpw, _pow2_floor(RANGE_WINDOW_THREADS // windows))
    return tpw


def _chunks_plain(start: torch.Tensor, counts: torch.Tensor, half: int,
                  chunk: int, run: int):
    """Buckets' starts and counts (nb,) int64 -> bco (nb + 1,), each
    chunk's entry offset (C,) and the busiest window's chunks
    (``csrc/msm_chunks.cuh`` in torch; one wait for C and the busiest)."""
    end = start + counts
    if run:
        per = torch.where(counts > 0, 1 + (end - 1) // run - start // run, 0)
    else:
        per = (counts + chunk - 1) // chunk
    bco = torch.cat([per.new_zeros(1), torch.cumsum(per, 0)])
    C, busiest = torch.stack([bco[-1], (bco[half::half]
                                        - bco[:-1:half]).max()]).tolist()
    dev = start.device
    bucket = torch.repeat_interleave(torch.arange(per.numel(), device=dev),
                                     per, output_size=C)
    rank = torch.arange(C, device=dev) - bco[bucket]
    first = start[bucket]
    if run:
        off = torch.where(rank == 0, first, (first // run + rank) * run)
    else:
        off = first + rank * chunk
    return bco, off, busiest


def _run_chunks_plain(off: torch.Tensor, E: int, run: int) -> torch.Tensor:
    """The chunk offsets (C,) -> (ceil(E / run) + 1,): the chunk that
    starts at each run's first entry, then C."""
    starts = torch.arange(0, E, run, device=off.device)
    return torch.cat([torch.searchsorted(off, starts),
                      starts.new_full((1,), off.numel())])


def bucket_schedule(digits: torch.Tensor, c: int, chunk: int = CHUNK,
                    events_per_thread: int | None = None,
                    run: int | None = None) -> BucketSchedule:
    """Digits (k, W, n) -> the schedule of the accumulate and the reduce,
    in plain torch: the reference ``msm_schedule`` is held to, on no path
    of the port (on the card it waits for the host four times: the nonzero
    count, ``bincount``'s min and max, the totals).  The route by the
    shapes (``accumulate_run``) unless ``run`` is given (0: the chunk
    route, whose chunk is ``chunk``); the reduce threads a window follow
    the busiest window, by the route's rule (``window_threads``) or at
    ``events_per_thread`` where given (``_window_threads``).  Raises
    ValueError when
    ``schedule_bound`` exceeds ``MAX_SCHEDULE_ENTRIES``: the int32 arrays
    would wrap (``point_ranges`` splits such an MSM)."""
    k, W, n = digits.shape
    half = 1 << (c - 1)
    _check_bound(k, W, n, c, "bucket_schedule")
    if run is None:
        run = accumulate_run(k, W, n, c)
    flat = digits.reshape(-1)
    sel = torch.nonzero(flat & MAG_MASK).squeeze(1)     # (set, window, i)
    d = flat[sel].to(torch.int64)
    key = ((sel // n) * half + (d & MAG_MASK) - 1).to(torch.int32)
    payload = (((sel % n) << 1) | (d >> SIGN_SHIFT)).to(torch.int32)
    keys, perm = torch.sort(key, stable=True)
    entries = payload[perm]
    counts = torch.bincount(keys, minlength=k * W * half)
    start = torch.cumsum(counts, 0) - counts
    bco, off, busiest = _chunks_plain(start, counts, half, chunk, run)
    E = sel.numel()
    chunk_off = torch.cat([off, start.new_full((1,), E)]).to(torch.int32)
    runs = None
    if run:
        runs = _run_chunks_plain(off, E, run).to(torch.int32)
        entries[off] |= CHUNK_START
    threads = (_window_threads(busiest, half, events_per_thread)
               if events_per_thread else
               window_threads(busiest, half, k * W, run))
    return BucketSchedule(entries, chunk_off, bco.to(torch.int32), threads,
                          runs)


# ---------------------------------------------------------------------------
# The schedule's kernels: digits, counting sort, bucket offsets.
# ---------------------------------------------------------------------------


class SchedulePlan(NamedTuple):
    """The shapes of one schedule's kernels, from the MSM's shapes alone.

    A segment is one (set, window)'s n digits; its sort keys are
    (set W + window) 2^(c-1) + mag - 1, so the c - 1 low bits order a
    segment's buckets.  ``passes``: the stable counting passes over those
    bits, lowest digit first, each (shift, bits), at most
    ``MAX_PASS_BITS`` bits (512 bins) a pass.  ``tile``: entries a tile,
    one block of each kernel, an eighth of n rounded up to a power of two
    within ``SORT_TILES`` (so a small n still spreads over the SMs);
    ``tiles`` a segment.  ``run``: the accumulate's route, L entries a run
    of the range route or 0 for the chunk route (``accumulate_run``).
    """
    sets: int
    windows: int
    n: int
    c: int
    passes: tuple
    tile: int
    tiles: int
    run: int = 0

    @property
    def segments(self) -> int:
        return self.sets * self.windows

    @property
    def half(self) -> int:
        return 1 << (self.c - 1)

    @property
    def buckets(self) -> int:
        return self.segments * self.half

    @property
    def digits(self) -> int:
        """Entries of the key and payload buffers: every digit, zero or
        not."""
        return self.segments * self.n

    @property
    def chunk_capacity(self) -> int:
        """Entries of the chunk offsets' buffer: C + 1 for any digits.
        Every chunk holds an entry; on the chunk route a bucket of m
        entries makes ceil(m / CHUNK) <= m / CHUNK + 1 chunks, on the range
        route the chunks start at a nonempty bucket's start or at one of
        the ceil(E / L) runs' starts."""
        m = self.digits
        per = -(-m // self.run) if self.run else m // CHUNK
        return min(m, per + min(m, self.buckets)) + 1

    @property
    def run_capacity(self) -> int:
        """Entries of the run chunks' buffer on the range route: R + 1 with
        R = ceil(E / L) runs for any digits (1 on the chunk route)."""
        return -(-self.digits // self.run) + 1 if self.run else 1


def schedule_plan(sets: int, n: int, windows: int, c: int) -> SchedulePlan:
    """The plan of k = ``sets`` sets of W = ``windows`` c-bit windows over
    n points: as few passes as keep each at ``MAX_PASS_BITS`` bits or less,
    the low pass taking the odd bit; the tile by n; the route by the shapes
    (``accumulate_run``).  Raises ValueError past ``MAX_SCHEDULE_ENTRIES``
    (``bucket_schedule``'s bound)."""
    if not 2 <= c <= MAX_WINDOW_BITS:
        raise ValueError(f"window width {c} outside 2..{MAX_WINDOW_BITS}")
    _check_bound(sets, windows, n, c, "msm_schedule")
    bits = c - 1
    count = -(-bits // MAX_PASS_BITS)
    passes, shift = [], 0
    for p in range(count):
        b = -(-(bits - shift) // (count - p))
        passes.append((shift, b))
        shift += b
    lo, hi = SORT_TILES
    tile = min(hi, max(lo, (1 << (max(n, 1) - 1).bit_length()) // 8))
    return SchedulePlan(sets, windows, n, c, tuple(passes), tile,
                        -(-n // tile), accumulate_run(sets, windows, n, c))


def msm_digits_plain(scalars: torch.Tensor, plan: SchedulePlan):
    """Plain version of ``msm_digits``: the kernel's serial carry chain,
    window by window over every (set, point) at once."""
    k, _, n = scalars.shape
    W, c, half = plan.windows, plan.c, plan.half
    dev = scalars.device
    words = cuda_fr._wide(scalars)
    point = torch.arange(n, device=dev)
    buf = torch.zeros((k, n), dtype=torch.int64, device=dev)
    carry = torch.zeros_like(buf)
    have = nxt = 0
    keys, pay = [], []
    for w in range(W):
        if have < c:
            if nxt < 8:
                buf |= words[:, nxt] << have
            have, nxt = have + 32, nxt + 1
        v = (buf & ((1 << c) - 1)) + carry
        buf >>= c
        have -= c
        flip = (v >= half) & (w < W - 1)
        mag = torch.where(flip, (1 << c) - v, v)
        carry = flip.to(torch.int64)
        seg = (torch.arange(k, device=dev) * W + w)[:, None]
        keys.append(torch.where(mag > 0, seg * half + mag - 1, -1))
        pay.append(point << 1 | carry)
    keys = torch.stack(keys, 1).reshape(-1)
    pay = torch.stack(pay, 1).reshape(-1).to(torch.int32)
    # The first pass's tile histograms of the nonzero digits.
    B, T = 1 << plan.passes[0][1], plan.tiles
    pos = torch.arange(plan.digits, device=dev)
    idx = ((pos // n * B + (keys & (B - 1))) * T + pos % n // plan.tile)
    hist = torch.bincount(idx[keys >= 0], minlength=plan.segments * B * T)
    return (keys.to(torch.int32), pay,
            hist.reshape(plan.segments, B, T).to(torch.int32))


def msm_digits(scalars: torch.Tensor, plan: SchedulePlan):
    """Step 1: canonical scalars (k, 8, n) -> sort keys and payloads (k W
    n,) int32 in (set, window, point) order, and the first pass's tile
    histograms (k W, 2^bits, tiles)."""
    if cuda_fr._on_cpu(scalars):
        return msm_digits_plain(scalars, plan)
    cuda_fr._require_cuda("msm_digits", scalars)
    if scalars.shape != (plan.sets, 8, plan.n):
        raise ValueError(f"msm_digits: scalars {tuple(scalars.shape)} for "
                         f"{plan.sets} sets of {plan.n} points")
    dev = scalars.device
    keys = torch.empty(plan.digits, dtype=torch.int32, device=dev)
    pay = torch.empty_like(keys)
    bits = plan.passes[0][1]
    hist = torch.empty((plan.segments, 1 << bits, plan.tiles),
                       dtype=torch.int32, device=dev)
    count_launch("msm_digits")
    check(cuda_lib().kzg_msm_digits(
        scalars.data_ptr(), plan.sets, plan.n, plan.windows, plan.c, bits,
        plan.tile, plan.tiles, keys.data_ptr(), pay.data_ptr(),
        hist.data_ptr(), cuda_fr._stream(scalars)), "msm_digits")
    return keys, pay, hist


def msm_sort_plain(keys: torch.Tensor, pay: torch.Tensor,
                   hist: torch.Tensor, plan: SchedulePlan):
    """Plain version of ``msm_sort``: one stable sort of the nonzero
    digits by key, the order the kernels' stable passes reach digit by
    digit; base from the first pass's tile histograms."""
    S, dev = plan.segments, keys.device
    live = keys >= 0
    order = torch.argsort(keys[live], stable=True)
    E = order.numel()
    out_k = torch.full_like(keys, -1)
    out_p = torch.zeros_like(pay)
    out_k[:E], out_p[:E] = keys[live][order], pay[live][order]
    tot = hist.reshape(S, -1).sum(1)
    base = torch.cat([tot.new_zeros(1), torch.cumsum(tot, 0)])
    return out_k, out_p, base.to(torch.int32)


def msm_sort(keys: torch.Tensor, pay: torch.Tensor, hist: torch.Tensor,
             plan: SchedulePlan):
    """Step 2's sort: ``msm_digits``' outputs -> the nonzero digits' keys
    and payloads in bucket order, stable in the point index, in the first
    E entries of buffers of k W n, and base (k W + 1,): the segments'
    starts in them, E last.  On the card the three inputs are its scratch:
    the kernels overwrite them."""
    if cuda_fr._on_cpu(keys, pay, hist):
        return msm_sort_plain(keys, pay, hist, plan)
    cuda_fr._require_cuda("msm_sort", keys, pay, hist)
    S = plan.segments
    if keys.shape != (plan.digits,) or pay.shape != keys.shape \
            or hist.shape != (S, 1 << plan.passes[0][1], plan.tiles):
        raise ValueError(f"msm_sort: keys {tuple(keys.shape)}, payloads "
                         f"{tuple(pay.shape)}, histograms "
                         f"{tuple(hist.shape)}")
    base = torch.empty(S + 1, dtype=torch.int32, device=keys.device)
    tot = torch.empty(S, dtype=torch.int32, device=keys.device)
    buf = (torch.empty_like(keys), torch.empty_like(pay))
    src = (keys, pay)
    lib, stream = cuda_lib(), cuda_fr._stream(keys)
    for p, (shift, bits) in enumerate(plan.passes):
        count_launch("msm_sort", 3)
        check(lib.kzg_msm_sort_pass(
            src[0].data_ptr(), src[1].data_ptr(), hist.data_ptr(),
            tot.data_ptr(), base.data_ptr(), S, plan.n, plan.tile,
            plan.tiles, shift, bits, int(p == 0), buf[0].data_ptr(),
            buf[1].data_ptr(), stream), "msm_sort")
        src, buf = buf, src
    return src[0], src[1], base


def msm_bucket_offsets_plain(keys: torch.Tensor, pay: torch.Tensor,
                             base: torch.Tensor, plan: SchedulePlan):
    """Plain version of ``msm_bucket_offsets``: bucket bounds from the runs
    of the sorted keys, chunks (``_chunks_plain``) scanned a segment and
    across segments; on the range route the chunk starts marked in pay."""
    S, half, dev = plan.segments, plan.half, keys.device
    nb, E = plan.buckets, int(base[-1])
    sk = keys[:E].to(torch.int64)
    p = torch.arange(E, device=dev)
    first = torch.ones(E, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    start = torch.zeros(nb, dtype=torch.int64, device=dev)
    end = torch.zeros_like(start)
    start[sk[first]] = p[first]
    end[sk[last]] = p[last] + 1
    bco, off, busiest = _chunks_plain(start, end - start, half, CHUNK,
                                      plan.run)
    C = off.numel()
    chunk_off = torch.zeros(plan.chunk_capacity, dtype=torch.int64,
                            device=dev)
    chunk_off[:C] = off
    chunk_off[C] = E
    runs = torch.zeros(plan.run_capacity, dtype=torch.int64, device=dev)
    if plan.run:
        got = _run_chunks_plain(off, E, plan.run)
        runs[:got.numel()] = got
        pay[off] |= CHUNK_START
    info = torch.tensor([C, busiest, E], device=dev)
    return (bco.to(torch.int32), chunk_off.to(torch.int32),
            runs.to(torch.int32), info.to(torch.int32))


def msm_bucket_offsets(keys: torch.Tensor, pay: torch.Tensor,
                       base: torch.Tensor, plan: SchedulePlan):
    """Step 2's offsets: ``msm_sort``'s keys, payloads and base ->
    bucket_chunks (k W 2^(c-1) + 1,), the chunk offsets (C + 1 entries of
    ``plan.chunk_capacity``), the run chunks (on the range route
    ceil(E / L) + 1 entries of ``plan.run_capacity``) and info (3,): C,
    the busiest window's chunks and E.  On the range route each chunk's
    first payload gets ``CHUNK_START``, in place."""
    if cuda_fr._on_cpu(keys, pay, base):
        return msm_bucket_offsets_plain(keys, pay, base, plan)
    cuda_fr._require_cuda("msm_bucket_offsets", keys, pay, base)
    S, nb, dev = plan.segments, plan.buckets, keys.device
    if keys.shape != (plan.digits,) or pay.shape != keys.shape \
            or base.shape != (S + 1,):
        raise ValueError(f"msm_bucket_offsets: keys {tuple(keys.shape)}, "
                         f"payloads {tuple(pay.shape)}, base "
                         f"{tuple(base.shape)}")

    def scratch(m):
        return torch.empty(m, dtype=torch.int32, device=dev)
    bounds, tot, cbase, most = scratch(2 * nb), scratch(S), scratch(S + 1), \
        scratch(1)
    bco, chunk_off, info = scratch(nb + 1), scratch(plan.chunk_capacity), \
        scratch(3)
    runs = scratch(plan.run_capacity)
    count_launch("msm_bucket_offsets", 4)
    check(cuda_lib().kzg_msm_bucket_offsets(
        keys.data_ptr(), base.data_ptr(), S, plan.half, plan.digits, CHUNK,
        plan.run, bounds.data_ptr(), tot.data_ptr(), cbase.data_ptr(),
        most.data_ptr(), bco.data_ptr(), chunk_off.data_ptr(),
        runs.data_ptr(), pay.data_ptr(), info.data_ptr(),
        cuda_fr._stream(keys)),
        "msm_bucket_offsets")
    return bco, chunk_off, runs, info


def msm_schedule(scalars: torch.Tensor, total_bits: int, c: int
                 ) -> BucketSchedule:
    """Canonical scalars (k, 8, n) -> the schedule of the accumulate and
    the reduce: ``msm_digits``, ``msm_sort``, ``msm_bucket_offsets``, then
    the host's one wait for C, the busiest window and E.  Equal to
    ``bucket_schedule(signed_digits(scalars, total_bits, c), c)``."""
    k, _, n = scalars.shape
    plan = schedule_plan(k, n, num_windows(total_bits, c), c)
    keys, pay, hist = msm_digits(scalars.contiguous(), plan)
    keys, pay, base = msm_sort(keys, pay, hist, plan)
    bco, chunk_off, runs, info = msm_bucket_offsets(keys, pay, base, plan)
    count_sync("msm.tolist")
    chunks, busiest, entries = info.tolist()
    L = plan.run
    return BucketSchedule(
        pay[:entries], chunk_off[:chunks + 1], bco,
        window_threads(busiest, plan.half, plan.segments, L),
        runs[:-(-entries // L) + 1] if L else None)


def point_table(points: torch.Tensor) -> torch.Tensor:
    """(3, L, n) with Z = 1 -> (n, 2 L) point-major x, y limbs."""
    n = points.shape[-1]
    return points[:2].reshape(2 * points.shape[1], n).t().contiguous()


# ---------------------------------------------------------------------------
# K8: the accumulate.
# ---------------------------------------------------------------------------


def _load_entries(f, xy: torch.Tensor, ent: torch.Tensor):
    """Entries (m,) -> affine planes (L, m), y negated for a negative
    digit (the chunk-start bit dropped)."""
    e = ent.to(torch.int64) & 0x7FFFFFFF
    pt = xy[e >> 1]
    L = xy.shape[1] // 2
    x, y = pt[:, :L].t(), pt[:, L:].t()
    return x, torch.where((e & 1).bool()[None], f.neg(y), y)


def msm_accumulate_plain(fc: FieldConsts, xy: torch.Tensor,
                         entries: torch.Tensor, chunk_off: torch.Tensor,
                         complete: bool) -> torch.Tensor:
    """Plain version of the accumulate, vectorized over chunks: the first
    entry loaded with Z = 1, the rest mixed-added in order.  A chunk's
    partial does not depend on which thread walks it, so it serves both
    routes."""
    f = cuda_fr.PlainField(fc)
    madd = (cuda_fr.add_mixed_formula if complete
            else cuda_fr.add_mixed_fast_formula)
    start = chunk_off[:-1].to(torch.int64)
    length = chunk_off[1:].to(torch.int64) - start
    # Longest chunks first, so the chunks still adding at step j are a
    # prefix; the order is undone at the end.
    length, order = torch.sort(length, descending=True, stable=True)
    start = start[order]
    x, y = _load_entries(f, xy, entries[start])
    acc = torch.stack([x, y, f.one_like(x)])
    for j in range(1, int(length[0]) if length.numel() else 0):
        live = int((length > j).sum())
        x, y = _load_entries(f, xy, entries[start[:live] + j])
        acc[:, :, :live] = madd(f, acc[:, :, :live], x, y)
    out = torch.empty_like(acc)
    out[:, :, order] = acc
    return out


def msm_accumulate(fc: FieldConsts, xy: torch.Tensor, entries: torch.Tensor,
                   chunk_off: torch.Tensor, complete: bool,
                   run_chunks: torch.Tensor | None = None) -> torch.Tensor:
    """K8: xy (n, 2 L) points, sorted entries (E,), chunk offsets (C + 1,)
    -> chunk partials (3, L, C) Jacobian.  One thread a chunk, or, given
    the range route's ``run_chunks`` (R + 1,), one thread a run."""
    if cuda_fr._on_cpu(xy, entries, chunk_off):
        return msm_accumulate_plain(fc, xy, entries, chunk_off, complete)
    cuda_fr._require_cuda("msm_accumulate", xy, entries, chunk_off)
    L = fc.num_limbs
    if xy.dim() != 2 or xy.shape[1] != 2 * L or entries.dim() != 1 \
            or chunk_off.dim() != 1 or chunk_off.numel() < 1 \
            or (run_chunks is not None and (run_chunks.dim() != 1
                                            or run_chunks.numel() < 1)):
        raise ValueError(
            f"msm_accumulate: points {tuple(xy.shape)}, entries "
            f"{tuple(entries.shape)}, chunk offsets {tuple(chunk_off.shape)}"
            f", run chunks {None if run_chunks is None else tuple(run_chunks.shape)}")
    chunks = chunk_off.numel() - 1
    out = torch.empty((3, L, chunks), dtype=torch.int32, device=xy.device)
    if run_chunks is None:
        threads, runs = chunks, None
    else:
        cuda_fr._require_cuda("msm_accumulate", run_chunks)
        threads, runs = run_chunks.numel() - 1, run_chunks.data_ptr()
    if chunks:
        count_launch("msm_accumulate", limbs=L)
        check(cuda_lib().kzg_msm_accumulate(
            xy.data_ptr(), entries.data_ptr(), chunk_off.data_ptr(), runs,
            threads, chunks, out.data_ptr(), int(bool(complete)), fc.ptr,
            cuda_fr._stream(xy)), "msm_accumulate")
    return out


# ---------------------------------------------------------------------------
# The reduction: window sums, then the Horner fold.
# ---------------------------------------------------------------------------


def reduce_shape(window_threads: int) -> tuple[int, int]:
    """(threads a block, blocks a window) of the window-sum launch."""
    block = min(window_threads, REDUCE_BLOCK)
    return block, window_threads // block


def _identity(f, shape, dev) -> torch.Tensor:
    L = f.fc.num_limbs
    one = f.fc.tensors(dev)["one"].reshape((L,) + (1,) * len(shape))
    one = one.expand((L,) + tuple(shape))
    return torch.stack([one, one, torch.zeros_like(one)])


def _double_finite(f, P: torch.Tensor) -> torch.Tensor:
    return torch.where(f.is_zero(P[2])[None, None], P,
                       cuda_fr.double_formula(f, P))


def window_sums_plain(fc: FieldConsts, partials: torch.Tensor,
                      bco: torch.Tensor, windows: int, c: int,
                      window_threads: int) -> torch.Tensor:
    """Plain version of the window-sum launch (``msm_window_piece`` and the
    block tree), every thread of every window a lane -> block partials
    (3, L, windows * blocks a window)."""
    f = cuda_fr.PlainField(fc)
    add = cuda_fr.add_formula
    dev = partials.device
    half, tpw = 1 << (c - 1), window_threads
    b64 = bco.to(torch.int64)
    wi = torch.arange(windows, device=dev).repeat_interleave(tpw)
    g = torch.arange(tpw, device=dev).repeat(windows)
    cb_w = b64[torch.arange(windows, device=dev) * half]
    cb = cb_w[wi]
    E = b64[wi * half + half] - cb + half
    a, b = g * E // tpw, (g + 1) * E // tpw
    count, hi = b - a, E - 1 - a
    steps = (b64[:-1].reshape(windows, half) - cb_w[:, None]
             + torch.arange(half, device=dev))      # step(m) at column m - 1
    m = torch.searchsorted(steps, hi.reshape(windows, tpw), right=True)
    m = torch.where(count > 0, m.reshape(-1), 0)

    def step_pos(m):
        col = wi * half + (m - 1).clamp(min=0)
        return torch.where(m >= 1, steps.reshape(-1)[col], -1)

    L = windows * tpw
    R = _identity(f, (L,), dev)
    Wt = R
    sp = step_pos(m)
    chunks = partials.shape[-1]
    for i in range(int(count.max()) if L else 0):
        active = i < count
        p = hi - i
        st = active & (p == sp)
        if chunks:
            ch = (cb + p - m).clamp(0, chunks - 1)
            Q = torch.where(st[None, None], R, partials[:, :, ch])
        else:
            Q = R
        out = add(f, torch.where(st[None, None], Wt, R), Q)
        Wt = torch.where(st[None, None], out, Wt)
        R = torch.where((active & ~st)[None, None], out, R)
        m = m - st.to(m.dtype)
        sp = step_pos(m)
    acc = _identity(f, (L,), dev)
    for bit in range(c - 1, -1, -1):
        acc = _double_finite(f, acc)
        take = ((m >> bit) & 1).bool()
        acc = torch.where(take[None, None], add(f, acc, R), acc)
    V = add(f, Wt, acc)
    block, _ = reduce_shape(tpw)
    V = V.reshape(3, fc.num_limbs, -1, block)
    while V.shape[-1] > 1:
        s = V.shape[-1] // 2
        V = add(f, V[..., :s], V[..., s:])
    return V[..., 0].contiguous()


def horner_plain(fc: FieldConsts, wparts: torch.Tensor, sets: int,
                 windows: int, c: int) -> torch.Tensor:
    """Plain version of the Horner launch: window totals from the block
    partials (3, L, sets * windows * blocks) by the launch's halving tree
    (with m partials left and h = ceil(m / 2), partial j < m - h takes
    partial j + h), then acc = 2^c acc + S_w from the top window -> (3, L,
    sets)."""
    f = cuda_fr.PlainField(fc)
    S = wparts.reshape(3, fc.num_limbs, sets, windows, -1)
    while S.shape[-1] > 1:
        m = S.shape[-1]
        h = (m + 1) // 2
        S = torch.cat([cuda_fr.add_formula(f, S[..., :m - h], S[..., h:]),
                       S[..., m - h:h]], dim=-1)
    S = S[..., 0]
    acc = _identity(f, (sets,), wparts.device)
    for w in range(windows - 1, -1, -1):
        for _ in range(c):
            acc = _double_finite(f, acc)
        acc = cuda_fr.add_formula(f, acc, S[..., w])
    return acc.contiguous()


def reduce_window_sums(fc: FieldConsts, partials: torch.Tensor,
                       bco: torch.Tensor, windows: int, c: int,
                       window_threads: int) -> torch.Tensor:
    """First launch of ``msm_reduce``: chunk partials (3, L, C) and bucket
    chunk offsets (windows * 2^(c-1) + 1,) -> block partials."""
    if cuda_fr._on_cpu(partials, bco):
        return window_sums_plain(fc, partials, bco, windows, c,
                                 window_threads)
    cuda_fr._require_cuda("msm_reduce", partials, bco)
    half = 1 << (c - 1)
    block, blocks = reduce_shape(window_threads)
    if partials.dim() != 3 or partials.shape[:2] != (3, fc.num_limbs) \
            or bco.shape != (windows * half + 1,) \
            or window_threads & (window_threads - 1) \
            or not 1 <= window_threads <= MAX_WINDOW_THREADS:
        raise ValueError(
            f"msm_reduce: partials {tuple(partials.shape)}, bucket offsets "
            f"{tuple(bco.shape)} for {windows} windows of c = {c}, "
            f"{window_threads} threads a window")
    out = torch.empty((3, fc.num_limbs, windows * blocks),
                      dtype=torch.int32, device=partials.device)
    count_launch("msm_reduce", limbs=fc.num_limbs)
    check(cuda_lib().kzg_msm_window_sums(
        partials.data_ptr(), partials.shape[-1], bco.data_ptr(), windows,
        half, c, window_threads, out.data_ptr(), fc.ptr,
        cuda_fr._stream(partials)), "msm_reduce")
    return out


def reduce_horner(fc: FieldConsts, wparts: torch.Tensor, sets: int,
                  windows: int, c: int) -> torch.Tensor:
    """Second launch of ``msm_reduce``: block partials (3, L, sets * W *
    blocks) -> the MSM results (3, L, sets)."""
    if cuda_fr._on_cpu(wparts):
        return horner_plain(fc, wparts, sets, windows, c)
    cuda_fr._require_cuda("msm_reduce", wparts)
    if wparts.dim() != 3 or wparts.shape[:2] != (3, fc.num_limbs) \
            or wparts.shape[-1] % (sets * windows) or windows > 32 \
            or wparts.shape[-1] // sets > MAX_FOLD_PARTIALS:
        raise ValueError(f"msm_reduce: block partials "
                         f"{tuple(wparts.shape)} for {sets} sets of "
                         f"{windows} windows")
    out = torch.empty((3, fc.num_limbs, sets), dtype=torch.int32,
                      device=wparts.device)
    count_launch("msm_reduce", limbs=fc.num_limbs)
    check(cuda_lib().kzg_msm_horner(
        wparts.data_ptr(), sets, windows,
        wparts.shape[-1] // (sets * windows), c, out.data_ptr(), fc.ptr,
        cuda_fr._stream(wparts)), "msm_reduce")
    return out


def msm_reduce_plain(fc: FieldConsts, partials: torch.Tensor,
                     bco: torch.Tensor, sets: int, windows: int, c: int,
                     window_threads: int) -> torch.Tensor:
    wparts = window_sums_plain(fc, partials, bco, sets * windows, c,
                               window_threads)
    return horner_plain(fc, wparts, sets, windows, c)


def msm_reduce(fc: FieldConsts, partials: torch.Tensor, bco: torch.Tensor,
               sets: int, windows: int, c: int, window_threads: int
               ) -> torch.Tensor:
    """Chunk partials (3, L, C) and bucket chunk offsets -> the MSM results
    (3, L, sets): two launches, window sums then Horner."""
    wparts = reduce_window_sums(fc, partials, bco, sets * windows, c,
                                window_threads)
    return reduce_horner(fc, wparts, sets, windows, c)


class FusedMsm:
    """MSM over one curve's G1 through the sorted-bucket kernels."""

    def __init__(self, curve_type: str = "bn254", device="cuda"):
        device = canonical_device(device)
        self.curve_type = curve_type
        self.device = device
        self.curve = curve_ops(curve_type, device)
        self.scalar_backend = fr_backend(curve_type, device)
        self.total_bits = self.scalar_backend.modulus.bit_length()

    def schedule(self, scalars: torch.Tensor, n: int):
        """(8, n) or (k, 8, n) canonical limbs -> (k, c, W, schedule)."""
        with span("msm.schedule"):
            sets = scalars if scalars.dim() == 3 else scalars[None]
            c = window_bits(n)
            return (sets.shape[0], c, num_windows(self.total_bits, c),
                    msm_schedule(sets, self.total_bits, c))

    def prepare_points(self, points: torch.Tensor) -> torch.Tensor:
        """(3, L, n) with Z = 1 on this context's device -> the (n, 2 L)
        int32 point-major table of ``msm_prepared``; it can be kept for a
        fixed basis."""
        L = self.curve.num_limbs
        if points.dim() != 3 or points.shape[:2] != (3, L) \
                or points.dtype != torch.int32:
            raise ValueError(f"prepare_points: expected (3, {L}, n) int32 "
                             f"points, got {tuple(points.shape)} "
                             f"{points.dtype}")
        if points.device != self.device:
            raise ValueError(f"prepare_points: points on {points.device}, "
                             f"the context on {self.device}")
        with span("msm.table"):
            return point_table(points)

    def msm_prepared(self, table: torch.Tensor, scalars: torch.Tensor,
                     complete: bool | None = None) -> torch.Tensor:
        """sum_i scalars[i] P_i over a ``prepare_points`` table: scalars
        (8, n) -> (3, L, 1), (k, 8, n) -> (3, L, k).  Past
        ``MAX_SCHEDULE_ENTRIES`` the points are cut into ``point_ranges``
        and the ranges' results added in order (K6).  ``complete``: see
        ``resolve_complete``."""
        sets = scalars if scalars.dim() == 3 else scalars[None]
        n = table.shape[0]
        if table.dim() != 2 or table.shape[1] != 2 * self.curve.num_limbs \
                or sets.dim() != 3 or sets.shape[1:] != (8, n):
            raise ValueError(f"msm_prepared: table {tuple(table.shape)}, "
                             f"scalars {tuple(scalars.shape)}")
        complete = resolve_complete(complete)
        out = None
        for a, b in point_ranges(n, sets.shape[0], self.total_bits):
            part = self._bucket_msm(table[a:b], sets[..., a:b], complete)
            out = part if out is None else self.curve.add(out, part)
        return out

    def _bucket_msm(self, table, sets, complete: bool) -> torch.Tensor:
        k, c, W, sched = self.schedule(sets, table.shape[0])
        fc = self.curve.f.consts
        count_msm_route("chunks" if sched.run_chunks is None else "ranges",
                        sched.chunk_off.numel() - 1)
        with span("msm.accumulate"):
            partials = msm_accumulate(fc, table, sched.entries,
                                      sched.chunk_off, complete,
                                      sched.run_chunks)
        with span("msm.reduce"):
            return msm_reduce(fc, partials, sched.bucket_chunks, k, W, c,
                              sched.window_threads)

    def msm(self, points: torch.Tensor, scalars: torch.Tensor,
            complete: bool | None = None) -> torch.Tensor:
        """sum_i scalars[i] points[i] -> (3, L, 1); scalars (k, 8, n)
        give (3, L, k): ``prepare_points``, then ``msm_prepared``."""
        return self.msm_prepared(self.prepare_points(points), scalars,
                                 complete)

    def msm_many(self, points: torch.Tensor, scalars: torch.Tensor,
                 complete: bool | None = None) -> torch.Tensor:
        """K MSMs over one point set: scalars (k, 8, n) -> (3, L, k)."""
        return self.msm(points, scalars, complete)


def fused_msm(curve_type: str = "bn254", device="cuda") -> FusedMsm:
    return FusedMsm(curve_type, device)
