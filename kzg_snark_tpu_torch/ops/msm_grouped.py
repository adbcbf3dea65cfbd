"""The grouped MSM: G groups of n points, each group with its own points and
its own k scalar sets, in one call (``csrc/msm_grouped_kernels.cu``).

FK20's cell proofs (``ops/fk20.py``) are many small MSMs, each over its own
bases: 128 groups of 64 points with one set a blob, then a G1 transform of
128 points a blob.  The shared-base route (``ops/msm_kernel.py``) sizes its
launches from the sorted digits, which the host reads once a call; here
every shape follows from (G, k, n) and the window width c, chosen by the
group's n (``window_bits``), so a call makes four launches and the host
never waits:

1. ``grouped_schedule``: per (group, set, window) segment, its n signed
   digits (the recoding of ``msm_kernel.signed_digits``) in a stable
   counting sort by bucket, at the segment's fixed stride n: entries
   ``(group * n + i) << 1 | sign`` in bucket order with the zero digits
   last, the 2^(c-1) + 1 bucket offsets of the segment, and each bucket's
   first slot: a bucket's run is cut into slots of at most ``CHUNK``
   entries, at most ``GroupedPlan.cap`` a segment;
2. ``grouped_accumulate``: one thread a (segment, slot) mixed-adds its
   entries in order (a slot past the segment's last is the identity), so
   a bucket that equal scalars fill spreads over many threads;
3. ``grouped_window_sums``: one thread a segment, sum_m m B_m by running
   sums from the top bucket down, B_m's slots added in order;
4. ``grouped_horner``: one thread a scalar set, acc = 2^c acc + S_w from
   the top window (``msm_kernel.horner_plain``'s order).

Each kernel has its plain PyTorch version with the same combine order,
which CPU tensors take; CUDA tensors launch the kernel or raise.  While a
profiler records, the call opens ``msm.table``, ``msm.schedule``,
``msm.accumulate`` and ``msm.reduce`` as the shared-base route does.

Points are (3, L, G n) with Z = 1, never the identity (group g's at
[g n, (g + 1) n)); scalars (G, k, 8, n) canonical limbs; the result
(3, L, G, k) Jacobian.  ``complete``: ``msm_kernel.resolve_complete``'s
rule (pass True for points computed on the card, which may repeat).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.build import check, count_launch, cuda_lib
from ..utils.profiling import span
from . import cuda_fr
from .limbs import FieldConsts
from .msm_kernel import (MAG_MASK, SIGN_SHIFT, _identity, _load_entries,
                         horner_plain, num_windows, point_table,
                         resolve_complete, signed_digits)

MAX_POINTS = 1024           # most points a group (a schedule block)
MAX_WINDOWS = 64            # most windows a set of the fold
CHUNK = 8                   # most entries a slot (one accumulate thread)
WINDOW_RANGE = (4, 10)      # c: W <= 64 at 255 bits; 2^(c-1) bins a block

# (squarings, products) of madd-2007-bl and add-2007-bl: the cost model of
# the window width.
_MADD, _ADD = (4, 7), (5, 11)


def window_bits(n: int, total_bits: int = 255) -> int:
    """Window width c for groups of n points: the c of least products in
    the cost model W (n madd + 2^c add) (the digits' adds and the running
    sums' two adds a bucket; the fold's c W doublings hardly depend on c),
    within ``WINDOW_RANGE``.  At 12 words: 4 at n = 64, 5 at n = 128."""
    def cost(c):
        madd = 3 * _MADD[0] + 4 * _MADD[1]          # squaring ~ 3/4 product
        add = 3 * _ADD[0] + 4 * _ADD[1]
        return num_windows(total_bits, c) * (n * madd + (1 << c) * add)
    lo, hi = WINDOW_RANGE
    return min(range(lo, hi + 1), key=cost)


class GroupedPlan(NamedTuple):
    """The shapes of one grouped MSM: G groups of n points, k sets a group,
    W windows of c bits."""
    groups: int
    sets: int
    n: int
    c: int
    windows: int
    bits: int

    @property
    def half(self) -> int:
        return 1 << (self.c - 1)

    @property
    def scalar_sets(self) -> int:
        return self.groups * self.sets

    @property
    def segments(self) -> int:
        return self.scalar_sets * self.windows

    @property
    def cap(self) -> int:
        """Slots a segment may hold: a bucket of m entries takes
        ceil(m / CHUNK) <= m / CHUNK + 1 of them."""
        return self.half + -(-self.n // CHUNK)


def grouped_plan(groups: int, sets: int, n: int, total_bits: int,
                 c: int | None = None) -> GroupedPlan:
    c = window_bits(n, total_bits) if c is None else c
    W = num_windows(total_bits, c)
    if not 1 <= n <= MAX_POINTS or not 2 <= c <= WINDOW_RANGE[1] \
            or W > MAX_WINDOWS or groups * n >= 1 << 30:
        raise ValueError(f"grouped MSM: {groups} groups of {n} points at "
                         f"c = {c} ({W} windows): at most {MAX_POINTS} "
                         f"points a group, c <= {WINDOW_RANGE[1]}, "
                         f"{MAX_WINDOWS} windows")
    return GroupedPlan(groups, sets, n, c, W, total_bits)


# ---------------------------------------------------------------------------
# 1. The schedule.
# ---------------------------------------------------------------------------


def grouped_schedule_plain(scalars: torch.Tensor, plan: GroupedPlan):
    """Plain version of ``k_msm_grouped_schedule``: the digits of every
    segment sorted stably by bucket (the zero digits' bin last), the bucket
    offsets and the buckets' first slots."""
    G, k, n, half = plan.groups, plan.sets, plan.n, plan.half
    dev = scalars.device
    digits = signed_digits(scalars.reshape(G * k, 8, n), plan.bits,
                           plan.c).to(torch.int64)          # (G k, W, n)
    mag = digits & MAG_MASK
    sign = digits >> SIGN_SHIFT
    bins = torch.where(mag > 0, mag - 1, half)
    order = torch.sort(bins, dim=-1, stable=True).indices
    group = (torch.arange(G * k, device=dev) // k)[:, None, None]
    point = torch.arange(n, device=dev)[None, None, :]
    pay = ((group * n + point) << 1) | sign
    entries = torch.gather(pay, -1, order).reshape(-1).to(torch.int32)
    counts = torch.nn.functional.one_hot(bins, half + 1).sum(-2)

    def exclusive(x):
        return torch.cat([torch.zeros_like(x[..., :1]),
                          torch.cumsum(x, -1)[..., :-1]], dim=-1)
    offsets = exclusive(counts)
    slots = exclusive((counts + CHUNK - 1) // CHUNK)
    return (entries, offsets.reshape(-1, half + 1).to(torch.int32),
            slots.reshape(-1, half + 1).to(torch.int32))


def grouped_schedule(scalars: torch.Tensor, plan: GroupedPlan):
    """Scalars (G, k, 8, n) canonical -> entries (G k W n,), bucket offsets
    and first slots (G k W, 2^(c-1) + 1) int32, one launch."""
    if scalars.shape != (plan.groups, plan.sets, 8, plan.n):
        raise ValueError(f"grouped_schedule: scalars {tuple(scalars.shape)} "
                         f"for {plan.groups} groups of {plan.sets} sets of "
                         f"{plan.n} points")
    if cuda_fr._on_cpu(scalars):
        return grouped_schedule_plain(scalars, plan)
    cuda_fr._require_cuda("msm_grouped_schedule", scalars)
    dev = scalars.device
    entries = torch.empty(plan.segments * plan.n, dtype=torch.int32,
                          device=dev)
    offsets = torch.empty((plan.segments, plan.half + 1), dtype=torch.int32,
                          device=dev)
    slots = torch.empty_like(offsets)
    count_launch("msm_grouped_schedule")
    check(cuda_lib().kzg_msm_grouped_schedule(
        scalars.data_ptr(), plan.scalar_sets, plan.sets, plan.n,
        plan.windows, plan.c, CHUNK, entries.data_ptr(), offsets.data_ptr(),
        slots.data_ptr(), cuda_fr._stream(scalars)), "msm_grouped_schedule")
    return entries, offsets, slots


# ---------------------------------------------------------------------------
# 2. The accumulate.
# ---------------------------------------------------------------------------


def _slot_ranges(offsets: torch.Tensor, slots: torch.Tensor, n: int,
                 cap: int):
    """(first entry, entries) of every (segment, slot), 0 entries past a
    segment's last slot, and each slot's bucket."""
    off, first = offsets.to(torch.int64), slots.to(torch.int64)
    S, half = off.shape[0], off.shape[1] - 1
    q = torch.arange(cap, device=off.device).expand(S, cap)
    m = (torch.searchsorted(first[:, :half].contiguous(), q.contiguous(),
                            right=True) - 1).clamp(0, half - 1)
    start = off.gather(1, m) + CHUNK * (q - first.gather(1, m))
    end = off.gather(1, m + 1)
    length = torch.where(q < first[:, half:], (end - start).clamp(0, CHUNK),
                         0)
    seg = torch.arange(S, device=off.device)[:, None]
    return (seg * n + start).reshape(-1), length.reshape(-1)


def grouped_accumulate_plain(fc: FieldConsts, xy: torch.Tensor,
                             entries: torch.Tensor, offsets: torch.Tensor,
                             slots: torch.Tensor, n: int, cap: int,
                             complete: bool) -> torch.Tensor:
    """Plain version of ``k_msm_accumulate_grouped``, vectorized over the
    slots: the first entry loaded with Z = 1, the rest mixed-added in
    order; a slot with no entry is the identity."""
    f = cuda_fr.PlainField(fc)
    madd = (cuda_fr.add_mixed_formula if complete
            else cuda_fr.add_mixed_fast_formula)
    start, length = _slot_ranges(offsets, slots, n, cap)
    B = length.numel()
    length, order = torch.sort(length, descending=True, stable=True)
    start = start[order]
    acc = _identity(f, (B,), xy.device).clone()
    live = int((length > 0).sum())
    if live:
        x, y = _load_entries(f, xy, entries[start[:live]])
        acc[:, :, :live] = torch.stack([x, y, f.one_like(x)])
    for j in range(1, int(length[0]) if B else 0):
        live = int((length > j).sum())
        x, y = _load_entries(f, xy, entries[start[:live] + j])
        acc[:, :, :live] = madd(f, acc[:, :, :live], x, y)
    out = torch.empty_like(acc)
    out[:, :, order] = acc
    return out


def grouped_accumulate(fc: FieldConsts, xy: torch.Tensor,
                       entries: torch.Tensor, offsets: torch.Tensor,
                       slots: torch.Tensor, plan: GroupedPlan,
                       complete: bool) -> torch.Tensor:
    """xy (G n, 2 L) points, the schedule -> slot partials (3, L, G k W
    cap) Jacobian."""
    if cuda_fr._on_cpu(xy, entries, offsets, slots):
        return grouped_accumulate_plain(fc, xy, entries, offsets, slots,
                                        plan.n, plan.cap, complete)
    cuda_fr._require_cuda("msm_accumulate_grouped", xy, entries, offsets,
                          slots)
    L = fc.num_limbs
    count = plan.segments * plan.cap
    if xy.shape != (plan.groups * plan.n, 2 * L) \
            or offsets.shape != (plan.segments, plan.half + 1) \
            or slots.shape != offsets.shape:
        raise ValueError(f"grouped_accumulate: points {tuple(xy.shape)}, "
                         f"offsets {tuple(offsets.shape)}, slots "
                         f"{tuple(slots.shape)}")
    out = torch.empty((3, L, count), dtype=torch.int32, device=xy.device)
    count_launch("msm_accumulate_grouped", limbs=L)
    check(cuda_lib().kzg_msm_accumulate_grouped(
        xy.data_ptr(), entries.data_ptr(), offsets.data_ptr(),
        slots.data_ptr(), plan.n, plan.half, plan.cap, count, CHUNK,
        out.data_ptr(), int(bool(complete)), fc.ptr, cuda_fr._stream(xy)),
        "msm_accumulate_grouped")
    return out


# ---------------------------------------------------------------------------
# 3-4. The reduction: window sums, then the fold.
# ---------------------------------------------------------------------------


def grouped_window_sums_plain(fc: FieldConsts, partials: torch.Tensor,
                              slots: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain version of ``k_msm_window_sums_grouped``: from m = 2^(c-1)
    down, R += each of B_m's slots in order, then Wt += R -> (3, L,
    segments)."""
    f = cuda_fr.PlainField(fc)
    first = slots.to(torch.int64)
    S, half = first.shape[0], first.shape[1] - 1
    P = partials.reshape(3, fc.num_limbs, S, cap)
    seg = torch.arange(S, device=partials.device)
    R = _identity(f, (S,), partials.device)
    Wt = R
    for m in range(half - 1, -1, -1):
        count = first[:, m + 1] - first[:, m]
        for j in range(int(count.max()) if S else 0):
            live = j < count
            q = (first[:, m] + j).clamp(max=cap - 1)
            R = torch.where(live[None, None],
                            cuda_fr.add_formula(f, R, P[:, :, seg, q]), R)
        Wt = cuda_fr.add_formula(f, Wt, R)
    return Wt.contiguous()


def grouped_window_sums(fc: FieldConsts, partials: torch.Tensor,
                        slots: torch.Tensor, plan: GroupedPlan
                        ) -> torch.Tensor:
    if cuda_fr._on_cpu(partials, slots):
        return grouped_window_sums_plain(fc, partials, slots, plan.cap)
    cuda_fr._require_cuda("msm_window_sums_grouped", partials, slots)
    L = fc.num_limbs
    if partials.shape != (3, L, plan.segments * plan.cap) \
            or slots.shape != (plan.segments, plan.half + 1):
        raise ValueError(f"grouped_window_sums: partials "
                         f"{tuple(partials.shape)}, slots "
                         f"{tuple(slots.shape)}")
    out = torch.empty((3, L, plan.segments), dtype=torch.int32,
                      device=partials.device)
    count_launch("msm_window_sums_grouped", limbs=L)
    check(cuda_lib().kzg_msm_window_sums_grouped(
        partials.data_ptr(), slots.data_ptr(), plan.half, plan.cap,
        plan.segments, out.data_ptr(), fc.ptr, cuda_fr._stream(partials)),
        "msm_window_sums_grouped")
    return out


def grouped_horner(fc: FieldConsts, sums: torch.Tensor,
                   plan: GroupedPlan) -> torch.Tensor:
    """Window sums (3, L, G k W) -> the results (3, L, G k)."""
    sets = plan.scalar_sets
    if cuda_fr._on_cpu(sums):
        return horner_plain(fc, sums, sets, plan.windows, plan.c)
    cuda_fr._require_cuda("msm_horner_grouped", sums)
    L = fc.num_limbs
    if sums.shape != (3, L, plan.segments):
        raise ValueError(f"grouped_horner: sums {tuple(sums.shape)}")
    out = torch.empty((3, L, sets), dtype=torch.int32, device=sums.device)
    count_launch("msm_horner_grouped", limbs=L)
    check(cuda_lib().kzg_msm_horner_grouped(
        sums.data_ptr(), sets, plan.windows, plan.c, out.data_ptr(), fc.ptr,
        cuda_fr._stream(sums)), "msm_horner_grouped")
    return out


def msm_grouped_prepared(fc: FieldConsts, xy: torch.Tensor,
                         scalars: torch.Tensor, total_bits: int,
                         complete: bool | None = None,
                         c: int | None = None) -> torch.Tensor:
    """The grouped MSM over a point table xy (G n, 2 L) (``point_table`` of
    the (3, L, G n) points, which a fixed basis keeps): scalars (G, k, 8, n)
    -> (3, L, G, k)."""
    G, k, _, n = scalars.shape
    if xy.shape[0] != G * n:
        raise ValueError(f"msm_grouped: {xy.shape[0]} points for {G} groups "
                         f"of {n}")
    plan = grouped_plan(G, k, n, total_bits, c)
    complete = resolve_complete(complete)
    with span("msm.schedule"):
        entries, offsets, slots = grouped_schedule(scalars.contiguous(), plan)
    with span("msm.accumulate"):
        partials = grouped_accumulate(fc, xy, entries, offsets, slots, plan,
                                      complete)
    with span("msm.reduce"):
        sums = grouped_window_sums(fc, partials, slots, plan)
        out = grouped_horner(fc, sums, plan)
    return out.reshape(3, fc.num_limbs, G, k)


def grouped_table(points: torch.Tensor) -> torch.Tensor:
    """(3, L, G n) with Z = 1 -> the (G n, 2 L) table the accumulate
    reads."""
    with span("msm.table"):
        return point_table(points)
