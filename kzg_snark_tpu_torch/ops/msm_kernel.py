"""Pippenger MSM of the bucket route (n >= 2048): sorted buckets on the card.

Counterpart of ``kzg_snark_tpu/ops/msm_kernel.py`` ``FusedMsm``, redesigned
for the H100 (``csrc/msm_kernels.cu``, ``csrc/msm.cuh``):

1. signed c-bit window digits for all windows at once (``signed_digits``),
   c by n (``window_bits``, a measured table), encoded mag | sign << 16;
2. the schedule (``bucket_schedule``, plain torch glue): zero digits
   dropped, the rest sorted by bucket key (set, window, mag - 1) with a
   stable sort, bucket offsets by ``bincount`` / ``cumsum``, each bucket's
   run cut into chunks of at most ``CHUNK`` entries;
3. ``msm_accumulate`` (K8): one thread a chunk mixed-adds its points into a
   Jacobian accumulator in registers and writes one partial;
4. ``msm_reduce`` (in place of the K6 / K7 chains): window sums
   sum_m m B_m from the chunk partials (one launch), then the Horner fold
   over windows, one thread a scalar set (a second launch).

Each kernel has its plain PyTorch version here, with the same task list
and combine order, so the two give the same Jacobian representatives.  A
wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches its kernel or raises.

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
``entries`` holds index << 1 | sign < 2 n <= B (W >= 16); ``chunk_off``
holds entry offsets up to E, the nonzero digits, at most k W n; the
bucket keys and ``bucket_chunks`` stay below k W 2^(c-1) buckets and C <= E
chunks.  ``bucket_schedule`` raises ValueError when B exceeds
``MAX_SCHEDULE_ENTRIES`` (2^31 - 1), so no cast can wrap, and
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
from ..utils.build import check, count_launch, cuda_lib
from . import cuda_fr
from .fr import canonical_device, fr_backend
from .g1 import curve_ops
from .limbs import FieldConsts

MAX_WINDOW_BITS = 16        # digit magnitudes fit the 16 bits below the sign
CHUNK = 16                  # most entries a chunk (one accumulate thread)
EVENTS_PER_THREAD = 8       # window-sum events a reduce thread, busiest window
MAX_WINDOW_THREADS = 1024
REDUCE_BLOCK = 128          # most threads of a window-sum block
MAG_MASK = 0xFFFF
SIGN_SHIFT = 16
MAX_SCHEDULE_ENTRIES = 2 ** 31 - 1  # bound of the schedule's int32 arrays


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

    entries:   (E,) int32 point index << 1 | sign, in bucket order.
    chunk_off: (C + 1,) int32 entry offsets of the chunks.
    bucket_chunks: (nb + 1,) int32 chunk offsets of the buckets, nb =
        sets * windows * 2^(c-1), bucket key (set * W + w) 2^(c-1) + mag - 1.
    window_threads: reduce threads a window (a power of two).
    """
    entries: torch.Tensor
    chunk_off: torch.Tensor
    bucket_chunks: torch.Tensor
    window_threads: int


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


def bucket_schedule(digits: torch.Tensor, c: int, chunk: int = CHUNK,
                    events_per_thread: int = EVENTS_PER_THREAD
                    ) -> BucketSchedule:
    """Digits (k, W, n) -> the schedule of the accumulate and the reduce.
    The reduce threads a window follow the busiest window: its chunks
    plus its 2^(c-1) steps over ``events_per_thread``.  Raises ValueError
    when ``schedule_bound`` exceeds ``MAX_SCHEDULE_ENTRIES``: the int32
    arrays would wrap (``point_ranges`` splits such an MSM)."""
    k, W, n = digits.shape
    half = 1 << (c - 1)
    bound = schedule_bound(k, n, W, c)
    if bound > MAX_SCHEDULE_ENTRIES:
        raise ValueError(
            f"bucket_schedule: {k} sets x {W} windows x {n} points give up "
            f"to E = {k * W * n} entries ({k * W * half} buckets), bound "
            f"{bound} > MAX_SCHEDULE_ENTRIES = {MAX_SCHEDULE_ENTRIES}: the "
            f"int32 schedule would wrap; split the points into ranges "
            f"(point_ranges)")
    dev = digits.device
    flat = digits.reshape(-1)
    sel = torch.nonzero(flat & MAG_MASK).squeeze(1)     # (set, window, i)
    d = flat[sel].to(torch.int64)
    key = ((sel // n) * half + (d & MAG_MASK) - 1).to(torch.int32)
    payload = (((sel % n) << 1) | (d >> SIGN_SHIFT)).to(torch.int32)
    keys, perm = torch.sort(key, stable=True)
    entries = payload[perm]
    nb = k * W * half
    counts = torch.bincount(keys, minlength=nb)
    per = (counts + chunk - 1) // chunk
    bco = torch.cat([per.new_zeros(1), torch.cumsum(per, 0)])
    per_window = bco[half::half] - bco[:-1:half]
    chunks, busiest = torch.stack([bco[-1], per_window.max()]).tolist()
    bucket = torch.repeat_interleave(
        torch.arange(nb, device=dev), per, output_size=chunks)
    rank = torch.arange(chunks, device=dev) - bco[bucket]
    start = torch.cumsum(counts, 0) - counts
    chunk_off = torch.cat([start[bucket] + rank * chunk,
                           start.new_full((1,), sel.numel())])
    threads = _pow2_floor((busiest + half) // events_per_thread)
    return BucketSchedule(entries, chunk_off.to(torch.int32),
                          bco.to(torch.int32),
                          min(threads, MAX_WINDOW_THREADS))


def point_table(points: torch.Tensor) -> torch.Tensor:
    """(3, L, n) with Z = 1 -> (n, 2 L) point-major x, y limbs."""
    n = points.shape[-1]
    return points[:2].reshape(2 * points.shape[1], n).t().contiguous()


# ---------------------------------------------------------------------------
# K8: the accumulate.
# ---------------------------------------------------------------------------


def _load_entries(f, xy: torch.Tensor, ent: torch.Tensor):
    """Entries (m,) -> affine planes (L, m), y negated for a negative
    digit."""
    e = ent.to(torch.int64)
    pt = xy[e >> 1]
    L = xy.shape[1] // 2
    x, y = pt[:, :L].t(), pt[:, L:].t()
    return x, torch.where((e & 1).bool()[None], f.neg(y), y)


def msm_accumulate_plain(fc: FieldConsts, xy: torch.Tensor,
                         entries: torch.Tensor, chunk_off: torch.Tensor,
                         complete: bool) -> torch.Tensor:
    """Plain version of the accumulate, vectorized over chunks: the first
    entry loaded with Z = 1, the rest mixed-added in order."""
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
                   chunk_off: torch.Tensor, complete: bool) -> torch.Tensor:
    """K8: xy (n, 2 L) points, sorted entries (E,), chunk offsets (C + 1,)
    -> chunk partials (3, L, C) Jacobian."""
    if cuda_fr._on_cpu(xy, entries, chunk_off):
        return msm_accumulate_plain(fc, xy, entries, chunk_off, complete)
    cuda_fr._require_cuda("msm_accumulate", xy, entries, chunk_off)
    L = fc.num_limbs
    if xy.dim() != 2 or xy.shape[1] != 2 * L or entries.dim() != 1 \
            or chunk_off.dim() != 1 or chunk_off.numel() < 1:
        raise ValueError(
            f"msm_accumulate: points {tuple(xy.shape)}, entries "
            f"{tuple(entries.shape)}, chunk offsets {tuple(chunk_off.shape)}")
    chunks = chunk_off.numel() - 1
    out = torch.empty((3, L, chunks), dtype=torch.int32, device=xy.device)
    if chunks:
        count_launch("msm_accumulate", limbs=L)
        check(cuda_lib().kzg_msm_accumulate(
            xy.data_ptr(), entries.data_ptr(), chunk_off.data_ptr(), chunks,
            out.data_ptr(), int(bool(complete)), fc.ptr,
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
    partials (3, L, sets * windows * blocks) in order, then
    acc = 2^c acc + S_w from the top window -> (3, L, sets)."""
    f = cuda_fr.PlainField(fc)
    parts = wparts.reshape(3, fc.num_limbs, sets, windows, -1)
    S = parts[..., 0]
    for j in range(1, parts.shape[-1]):
        S = cuda_fr.add_formula(f, S, parts[..., j])
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
            or wparts.shape[-1] % (sets * windows) or windows > 32:
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
        sets = scalars if scalars.dim() == 3 else scalars[None]
        c = window_bits(n)
        dig = signed_digits(sets, self.total_bits, c)
        return sets.shape[0], c, dig.shape[1], bucket_schedule(dig, c)

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
        partials = msm_accumulate(fc, table, sched.entries, sched.chunk_off,
                                  complete)
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
