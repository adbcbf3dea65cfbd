"""Pippenger MSM through the bucket-pass kernel (the K8 replacement).

Counterpart of ``kzg_snark_tpu/ops/msm_kernel.py`` ``FusedMsm``:

1. signed c-bit window digits (c = 7, magnitudes 1..64 and a sign), as
   ``signed_digits`` computes them (plain torch ops);
2. the bucket pass ``msm_bucket`` (``csrc/msm_kernels.cu``): one thread per
   (window, lane) cell with a private table of 64 buckets; every window
   of every scalar set runs in one launch;
3. the reduction on K6 / K7 (``ops/cuda_fr``): fold the lanes, weight the
   buckets by a suffix ladder, and a Horner fold over windows
   (``_window_sums`` / ``_horner_windows``).

``complete=False`` (the default) uses the incomplete mixed add, sound for
duplicate-free unstructured bases (SRS powers, ``random_point_basis``);
pass ``complete=True`` for structured bases such as [(i+1) G].
"""

from __future__ import annotations

import torch

from ..utils.build import check, count_launch, cuda_lib
from . import cuda_fr
from .fr import canonical_device, fr_backend
from .g1 import CurveOps, curve_ops
from .limbs import NUM_LIMBS, FieldConsts

WINDOW_BITS = 7
NUM_BUCKETS = 1 << (WINDOW_BITS - 1)      # digit magnitudes 1..64
MAX_LANES = 256
MIN_POINTS_PER_LANE = 16


def num_windows(bits: int, c: int = WINDOW_BITS) -> int:
    return -(-bits // c)


def lanes_for(n: int) -> int:
    """Lanes per window: up to 256 (37 x 256 threads fill the H100's 132
    SMs at 2^16 points), at least 16 points per lane at small n."""
    lanes = 1
    while lanes < MAX_LANES and lanes * 2 * MIN_POINTS_PER_LANE <= n:
        lanes *= 2
    return lanes


def signed_digits(scalars: torch.Tensor, total_bits: int,
                  c: int = WINDOW_BITS) -> torch.Tensor:
    """Canonical scalars (8, n) int32 limbs -> signed window digits (W, n)
    int32, encoded mag | sign << 7 with mag in [0, 2^(c-1)] (c <= 7).

    Raw digits are in [0, 2^c - 1]; raw + carry >= 2^(c-1) becomes
    raw + carry - 2^c with a carry into the next window.  The top window
    absorbs the last carry (scalars below 2^total_bits leave it room).
    """
    if c > 7:
        raise ValueError("digit encoding holds magnitudes up to 2^6")
    words = cuda_fr._wide(scalars)                      # (8, n) int64
    W = num_windows(total_bits, c)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(words[0])
    out = []
    for w in range(W):
        bit = c * w
        limb, sh = bit >> 5, bit & 31
        raw = words[limb] >> sh
        if sh + c > 32 and limb + 1 < NUM_LIMBS:
            raw = raw | (words[limb + 1] << (32 - sh))
        v = (raw & (full - 1)) + carry
        flip = v >= half
        mag = torch.where(flip, full - v, v)
        carry = flip.to(torch.int64)
        out.append(mag | (carry << 7))
    return torch.stack(out).to(torch.int32)


# ---------------------------------------------------------------------------
# The bucket pass.
# ---------------------------------------------------------------------------


def msm_bucket_plain(fc: FieldConsts, px: torch.Tensor, py: torch.Tensor,
                     digits: torch.Tensor, lanes: int, complete: bool
                     ) -> torch.Tensor:
    """Plain version of the pass: the same per-cell walk, vectorized over
    the (window, lane) cells.  Returns the (64, 3, 8, W * lanes) table."""
    f = cuda_fr.PlainField(fc)
    madd = (cuda_fr.add_mixed_formula if complete
            else cuda_fr.add_mixed_fast_formula)
    W, npts = digits.shape
    cells = W * lanes
    dev = px.device
    one = fc.tensors(dev)["one"]
    table = torch.zeros((NUM_BUCKETS, 3, NUM_LIMBS, cells),
                        dtype=torch.int32, device=dev)
    table[:, 0] = one
    table[:, 1] = one
    cell_idx = torch.arange(cells, device=dev)
    for s in range(npts // lanes):
        cols = slice(s * lanes, (s + 1) * lanes)
        d = digits[:, cols].reshape(cells)
        mag = d & 0x7F
        neg = (d >> 7) != 0
        qx = px[:, cols][:, None, :].expand(NUM_LIMBS, W, lanes).reshape(
            NUM_LIMBS, cells)
        qy = py[:, cols][:, None, :].expand(NUM_LIMBS, W, lanes).reshape(
            NUM_LIMBS, cells)
        qy = torch.where(neg[None], f.neg(qy), qy)
        bidx = (mag - 1).clamp(min=0).to(torch.int64)
        cur = table[bidx, :, :, cell_idx].permute(1, 2, 0)  # (3, 8, cells)
        new = madd(f, cur, qx, qy)
        new = torch.where((mag > 0)[None, None], new, cur)
        table[bidx, :, :, cell_idx] = new.permute(2, 0, 1)
    return table


def msm_bucket(fc: FieldConsts, px: torch.Tensor, py: torch.Tensor,
               digits: torch.Tensor, lanes: int, complete: bool
               ) -> torch.Tensor:
    """K8: px, py (8, npts) affine Montgomery planes, digits (W, npts)
    int32 -> bucket table (64, 3, 8, W * lanes)."""
    if cuda_fr._on_cpu(px, py, digits):
        return msm_bucket_plain(fc, px, py, digits, lanes, complete)
    cuda_fr._require_cuda("msm_bucket", px, py, digits)
    W, npts = digits.shape
    if px.shape != (NUM_LIMBS, npts) or py.shape != px.shape \
            or npts % lanes:
        raise ValueError(
            f"msm_bucket: points {tuple(px.shape)} / {tuple(py.shape)} do "
            f"not match digits {tuple(digits.shape)} with {lanes} lanes")
    table = torch.empty((NUM_BUCKETS, 3, NUM_LIMBS, W * lanes),
                        dtype=torch.int32, device=px.device)
    count_launch("msm_bucket")
    check(cuda_lib().kzg_msm_bucket(
        px.data_ptr(), py.data_ptr(), npts, digits.data_ptr(),
        table.data_ptr(), W, lanes, NUM_BUCKETS, int(bool(complete)), fc.ptr,
        cuda_fr._stream(px)), "msm_bucket")
    return table


# ---------------------------------------------------------------------------
# Reduction of the bucket tables on K6 / K7.
# ---------------------------------------------------------------------------


def halve_sum_last(curve: CurveOps, pts: torch.Tensor) -> torch.Tensor:
    """Tree sum along the last (power-of-two) axis: (3, 8, ..., n) ->
    (3, 8, ...)."""
    n = pts.shape[-1]
    while n > 1:
        half = n // 2
        pts = curve.add(pts[..., :half], pts[..., half:])
        n = half
    return pts[..., 0]


def suffix_ladder(curve: CurveOps, pts: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the last (power-of-two) axis by a
    Hillis-Steele ladder with identity (all-zero) fill."""
    n = pts.shape[-1]
    shift = 1
    while shift < n:
        fill = torch.zeros_like(pts[..., :shift])
        pts = curve.add(pts, torch.cat([pts[..., shift:], fill], dim=-1))
        shift *= 2
    return pts


def _window_sums(curve: CurveOps, table: torch.Tensor, windows: int,
                 lanes: int) -> torch.Tensor:
    """table (nb, 3, 8, W * lanes) -> per-window sums (3, 8, W).

    Fold the lanes by a halving tree, then sum_b (b + 1) B_b as the sum of
    the inclusive suffix sums S_j = sum_{b >= j} B_b (a ladder, then a
    halving tree over j)."""
    nb = table.shape[0]
    t = table.reshape(nb, 3, NUM_LIMBS, windows, lanes).permute(1, 2, 3, 0, 4)
    s = halve_sum_last(curve, t)                         # (3, 8, W, nb)
    return halve_sum_last(curve, suffix_ladder(curve, s))


def _horner_windows(curve: CurveOps, wins: torch.Tensor, k: int, W: int,
                    c: int = WINDOW_BITS) -> torch.Tensor:
    """Window sums (3, 8, k * W), scalar-major -> totals (3, 8, k):
    acc = 2^c acc + S_w from the top window down, batched over k."""
    act = wins.reshape(3, NUM_LIMBS, k, W)
    acc = curve.identity((k,)).contiguous()
    for w in range(W - 1, -1, -1):
        for _ in range(c):
            acc = curve.double(acc)
        acc = curve.add(acc, act[..., w])
    return acc


class FusedMsm:
    """MSM over one curve's G1 through the bucket-pass kernel."""

    def __init__(self, curve_type: str = "bn254", device="cpu"):
        from .. import constants as C
        device = canonical_device(device)
        self.curve_type = curve_type
        self.device = device
        self.curve = curve_ops(curve_type, device)
        self.scalar_backend = fr_backend(curve_type, device)
        self.total_bits = self.scalar_backend.modulus.bit_length()
        self.c = WINDOW_BITS
        self.windows = num_windows(self.total_bits, self.c)
        self._gen_affine = C.BN254_G1

    def prepare_points(self, points: torch.Tensor, lanes: int):
        """(3, 8, n) Jacobian with Z = 1 -> x and y planes (8, npad), npad
        a multiple of ``lanes``, padded with the generator (a finite point;
        its digits are zero)."""
        n = points.shape[-1]
        npad = -(-n // lanes) * lanes
        px, py = points[0], points[1]
        if npad > n:
            g = self.curve.from_affine_ints([self._gen_affine[0]],
                                            [self._gen_affine[1]])
            px = torch.cat([px, g[0].expand(NUM_LIMBS, npad - n)], dim=1)
            py = torch.cat([py, g[1].expand(NUM_LIMBS, npad - n)], dim=1)
        return px.contiguous(), py.contiguous()

    def digits(self, scalars: torch.Tensor, npad: int) -> torch.Tensor:
        """(8, n) or (k, 8, n) canonical limbs -> (k * W, npad) digits,
        scalar-major, zero on the padding points."""
        sets = scalars if scalars.dim() == 3 else scalars[None]
        enc = torch.cat([signed_digits(s, self.total_bits, self.c)
                         for s in sets])
        n = enc.shape[1]
        if npad > n:
            enc = torch.cat([enc, torch.zeros(
                (enc.shape[0], npad - n), dtype=enc.dtype,
                device=enc.device)], dim=1)
        return enc.contiguous()

    def msm(self, points: torch.Tensor, scalars: torch.Tensor,
            complete: bool = False) -> torch.Tensor:
        """sum_i scalars[i] points[i] -> (3, 8, 1); scalars (k, 8, n)
        give (3, 8, k)."""
        lanes = lanes_for(points.shape[-1])
        px, py = self.prepare_points(points, lanes)
        dig = self.digits(scalars, px.shape[1])
        k = scalars.shape[0] if scalars.dim() == 3 else 1
        W = self.windows
        table = msm_bucket(self.curve.f.consts, px, py, dig, lanes, complete)
        wins = _window_sums(self.curve, table, k * W, lanes)
        return _horner_windows(self.curve, wins, k, W, self.c)

    def msm_many(self, points: torch.Tensor, scalars: torch.Tensor,
                 complete: bool = False) -> torch.Tensor:
        """K MSMs over one point set: scalars (k, 8, n) -> (3, 8, k)."""
        return self.msm(points, scalars, complete)


def fused_msm(curve_type: str = "bn254", device="cpu") -> FusedMsm:
    return FusedMsm(curve_type, device)
