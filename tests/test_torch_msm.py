"""The port's MSM against the JAX package's digit recoding and the host
oracle.

``signed_digits`` must equal the JAX recoding at c = 7 and satisfy
sum d_w 2^(cw) = s at every window width the bucket route uses.  The MSM
(plain versions of the kernels on the CPU) must equal the host sum over
``random_point_basis`` (P_i = k_i G, so the oracle is (sum s_i k_i) G),
with scalars 0, 1, r - 1 and duplicates, on each route the JAX
``MsmContext`` would take: bit-serial (n <= 256: 1, 7, 64, 200; one
``g1_ladder`` call, the words of the row loop on ``CurveOps``), scan
Pippenger on K9 (300, 1024) and the sorted-bucket route (2048, 4096);
all-zero scalars give the identity on every route, and no route calls
``CurveOps.double``.  The bucket route is also held
to the oracle on skewed scalar sets (all zero, all equal, one nonzero,
half zeros), batched sets and both ``complete`` settings, and never calls
``CurveOps.add`` or ``CurveOps.double``.  A structured basis [(i+1) G]
runs with ``complete=True``, and on the bucket route with ``complete=None``
under ``KZG_TPU_COMPLETE_ADD``, read at call time.
"""

import functools

import numpy as np
import pytest
import torch

from kzg_snark_tpu import constants as C
from kzg_snark_tpu.ops.fr import fr_backend as jax_fr_backend
from kzg_snark_tpu.ops.host import curve as hc
from kzg_snark_tpu.ops.host.field import base_field
from kzg_snark_tpu.ops.msm_kernel import signed_digits as jax_signed_digits
from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor
from kzg_snark_tpu_torch.ops.msm import MsmContext, msm_context
from kzg_snark_tpu_torch.ops.benchpoints import normalize_points
from kzg_snark_tpu_torch.ops.g1 import CurveOps
from kzg_snark_tpu_torch.ops.msm_kernel import (num_windows,
                                                resolve_complete,
                                                signed_digits, window_bits)

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)

R = C.BN254_R
Fp = base_field("bn254")
G1 = (Fp(1), Fp(2), Fp(1))


def scalars(n, seed):
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    out[:4] = [0, 1, R - 1, R - 1]          # edge values and a duplicate
    out[4] = out[5]
    return out


def host_point(total):
    a = hc.normalize(hc.multiply(G1, total % R))
    return None if a is None else (int(a[0]), int(a[1]))


def test_signed_digits_match_jax():
    """At c = 7 the port's mag | sign << 16 is the JAX mag | sign << 7."""
    from kzg_snark_tpu.ops.fr import ints_to_limb_array
    s = scalars(64, 1)
    jax_limbs = ints_to_limb_array(s, 16)
    want = np.asarray(jax_signed_digits(jax_fr_backend("bn254"), jax_limbs,
                                        254, pad=False))
    got = signed_digits(to_tensor(ints_to_words(s), "cpu"), 254, 7).numpy()
    got = got.astype(np.int64)
    mapped = (got & 0xFFFF) | ((got >> 16) << 7)
    assert np.array_equal(want.astype(np.int64), mapped)


def test_window_bits_table():
    """The table's widths, one more bit a doubling above it, at most 16;
    every width the bucket route uses is one the digit tests cover."""
    assert [window_bits(1 << lg) for lg in range(11, 25)] == [
        9, 10, 10, 10, 10, 10, 12, 12, 13, 14, 15, 16, 16, 16]
    assert window_bits(3 << 15) == 10
    assert {window_bits(1 << lg) for lg in range(11, 31)} <= set(DIGIT_WIDTHS)


DIGIT_WIDTHS = range(7, 17)     # JAX's c = 7 and every width the route uses


@pytest.mark.parametrize("c", DIGIT_WIDTHS)
def test_signed_digits_identity(c):
    """sum_w d_w 2^(cw) = s, |d_w| <= 2^(c-1), and the top window leaves
    room for the carry (254 - c (W - 1) <= c - 1)."""
    W = num_windows(254, c)
    assert 254 - c * (W - 1) <= c - 1
    s = scalars(40, c) + [0, 1, R - 1, R - 2, 1 << 253]
    d = signed_digits(to_tensor(ints_to_words(s), "cpu"), 254, c).numpy()
    d = d.astype(np.int64)
    assert d.shape == (W, len(s))
    mag, neg = d & 0xFFFF, d >> 16
    assert mag.max() <= 1 << (c - 1) and set(np.unique(neg)) <= {0, 1}
    for j, v in enumerate(s):
        assert sum((-int(mag[w, j]) if neg[w, j] else int(mag[w, j]))
                   << (c * w) for w in range(W)) == v


@functools.lru_cache(maxsize=None)
def basis(n):
    if n == 4096:       # the 2048 basis and its doubles: no second build
        pts, ks = basis(2048)
        curve = msm_context("bn254", "cpu").curve
        dbl = normalize_points(curve.f, curve.double(pts))
        return torch.cat([pts, dbl], dim=-1), ks + [2 * k for k in ks]
    return random_point_basis("bn254", n, seed=n, device="cpu")


@pytest.mark.parametrize("n", [64, 1024])
def test_msm_matches_host_oracle(n):
    pts, ks = basis(n)
    ctx = msm_context("bn254", "cpu")
    s = scalars(n, n + 1)
    got = ctx.curve.to_affine_ints(ctx.msm(pts, ctx.scalars_to_limbs(s)))
    assert got == [host_point(sum(a * b for a, b in zip(s, ks)))]


def refuse(*args, **kwargs):
    raise AssertionError("the MSM called a CurveOps method it must not")


@pytest.mark.parametrize("n, route", [(200, "small"), (300, "scan"),
                                      (2048, "bucket")])
def test_msm_routes_match_host_oracle(monkeypatch, n, route):
    """Every route equals the host oracle and calls ``CurveOps.double``
    zero times (the small route's ladder is one ``g1_ladder`` launch, the
    scan route's Horner fold the bucket route's Horner launch)."""
    assert MsmContext.route(n) == route
    monkeypatch.setattr(CurveOps, "double", refuse)
    pts, ks = basis(n)
    ctx = msm_context("bn254", "cpu")
    s = scalars(n, n + 2)
    got = ctx.curve.to_affine_ints(ctx.msm(pts, ctx.scalars_to_limbs(s)))
    assert got == [host_point(sum(a * b for a, b in zip(s, ks)))]
    zero = ctx.msm(pts, ctx.scalars_to_limbs([0] * n))
    assert ctx.curve.to_affine_ints(zero) == [None]


@pytest.mark.parametrize("n", [1, 7, 64])
def test_small_route_calls_no_curve_add_or_double(monkeypatch, n):
    """The small route is one ``g1_ladder`` call: no ``CurveOps.add`` (the
    halving tree runs in the ladder) and no ``CurveOps.double``; k = 2
    sets against the host oracle."""
    assert MsmContext.route(n) == "small"
    pts, ks = random_point_basis("bn254", n, seed=31, device="cpu")
    ctx = msm_context("bn254", "cpu")
    sets = [scalars(max(n, 6), 40 + n)[:n], [0] * n]
    lim = torch.stack([ctx.scalars_to_limbs(s) for s in sets])
    monkeypatch.setattr(CurveOps, "add", refuse)
    monkeypatch.setattr(CurveOps, "double", refuse)
    out = ctx.msm(pts, lim)
    monkeypatch.undo()
    assert ctx.curve.to_affine_ints(out) == [
        host_point(sum(a * b for a, b in zip(s, ks))) for s in sets]


def test_small_route_matches_row_loop():
    """The small route's Jacobian words equal the bit-serial row loop's:
    all 256 bit rows of one K6 add of width k n and one K7 doubling on
    ``CurveOps``, then ``CurveOps.tree_sum`` (the JAX ``_small_msm_core``,
    which the ladder cuts at the highest set bit)."""
    n = 5
    pts, _ = random_point_basis("bn254", n, seed=32, device="cpu")
    ctx = msm_context("bn254", "cpu")
    curve = ctx.curve
    sets = [scalars(6, 41)[:n], [3, 0, 1, R - 1, 2]]
    lim = torch.stack([ctx.scalars_to_limbs(s) for s in sets])
    words = lim.to(torch.int64) & 0xFFFFFFFF
    acc = curve.identity((2, n)).contiguous()
    base = pts[:, :, None, :]
    for b in range(256):
        bit = (words[:, b // 32] >> (b % 32)) & 1
        taken = curve.add(acc, base)
        acc = torch.where((bit == 1)[None, None], taken, acc)
        base = curve.double(base)
    assert torch.equal(ctx.msm(pts, lim), curve.tree_sum(acc)[..., 0])


def test_msm_many_matches_single():
    n = 64
    pts, ks = random_point_basis("bn254", n, seed=7, device="cpu")
    ctx = msm_context("bn254", "cpu")
    sets = [scalars(n, 10 + j) for j in range(3)]
    sets[2] = [0] * n                       # an all-zero scalar set
    lim = torch.stack([ctx.scalars_to_limbs(s) for s in sets])
    got = ctx.curve.to_affine_ints(ctx.fused.msm_many(pts, lim))
    assert got == [host_point(sum(a * b for a, b in zip(s, ks)))
                   for s in sets]


def test_structured_basis_complete():
    n = 64
    ctx = msm_context("bn254", "cpu")
    aff = [hc.normalize(hc.multiply(G1, i + 1)) for i in range(n)]
    pts = ctx.curve.from_affine_ints([int(a[0]) for a in aff],
                                     [int(a[1]) for a in aff])
    s = scalars(n, 3)
    got = ctx.curve.to_affine_ints(
        ctx.msm(pts, ctx.scalars_to_limbs(s), complete=True))
    assert got == [host_point(sum(a * (i + 1) for i, a in enumerate(s)))]


SKEWED = {
    "random": lambda n, rng: [int.from_bytes(rng.bytes(32), "little") % R
                              for _ in range(n)],
    "all-zero": lambda n, rng: [0] * n,
    "all-equal": lambda n, rng: [R - 3] * n,
    "one-nonzero": lambda n, rng: [0] * 37 + [R - 1] + [0] * (n - 38),
    "half-zero": lambda n, rng: [(i * 7919 + 1) % 4096 if i % 2 else 0
                                 for i in range(n)],
}
BUCKET_CASES = {(2048, False): list(SKEWED), (2048, True): list(SKEWED),
                (4096, False): ["random", "all-equal", "half-zero"]}


@functools.lru_cache(maxsize=None)
def bucket_run(n, complete):
    """One batched bucket-route MSM over all of ``BUCKET_CASES[n,
    complete]`` -> (affine results, scalar sets)."""
    assert MsmContext.route(n) == "bucket"
    pts, _ = basis(n)
    ctx = msm_context("bn254", "cpu")
    rng = np.random.default_rng(n + complete)
    sets = [SKEWED[name](n, rng) for name in BUCKET_CASES[n, complete]]
    lim = torch.stack([ctx.scalars_to_limbs(s) for s in sets])
    out = ctx.msm(pts, lim, complete=complete)
    return ctx.curve.to_affine_ints(out), sets


@pytest.mark.parametrize("n, complete, case", [
    (n, complete, case) for (n, complete), cases in BUCKET_CASES.items()
    for case in cases])
def test_bucket_route_skewed_scalars(n, complete, case):
    got, sets = bucket_run(n, complete)
    j = BUCKET_CASES[n, complete].index(case)
    _, ks = basis(n)
    assert got[j] == host_point(sum(a * b for a, b in zip(sets[j], ks)))


def test_bucket_route_duplicate_points_complete():
    """A basis with each point twice: a bucket holding P, P in one chunk
    needs the complete add's doubling."""
    pts, ks = basis(2048)
    dup = torch.cat([pts[..., :1024], pts[..., :1024]], dim=-1)
    ks = ks[:1024] * 2
    s = [0] * 2048
    s[5] = s[1024 + 5] = 9
    ctx = msm_context("bn254", "cpu")
    got = ctx.curve.to_affine_ints(
        ctx.msm(dup, ctx.scalars_to_limbs(s), complete=True))
    assert got == [host_point(sum(a * b for a, b in zip(s, ks)))]


def test_bucket_route_calls_no_curve_add_or_double(monkeypatch):
    pts, ks = basis(2048)
    ctx = msm_context("bn254", "cpu")
    s = [(i % 5) * 1000003 for i in range(2048)]
    lim = ctx.scalars_to_limbs(s)
    monkeypatch.setattr(CurveOps, "add", refuse)
    monkeypatch.setattr(CurveOps, "double", refuse)
    out = ctx.msm(pts, lim)
    monkeypatch.undo()
    assert ctx.curve.to_affine_ints(out) == [
        host_point(sum(a * b for a, b in zip(s, ks)))]


def test_complete_add_variable_read_at_call_time(monkeypatch):
    """KZG_TPU_COMPLETE_ADD, set after the (cached) context's first call,
    makes msm(complete=None) take the complete add on the bucket route, as
    the JAX FusedMsm._resolve_complete does; an explicit complete=False
    still wins.  On [(i+1) G] with equal scalars the first bucket's
    running sum meets its next point (G + 2G = 3G), so only the complete
    add gives the oracle's sum."""
    n = 2048
    assert MsmContext.route(n) == "bucket"
    pt, xs, ys = G1, [], []
    for _ in range(n):
        a = hc.normalize(pt)
        xs.append(int(a[0]))
        ys.append(int(a[1]))
        pt = hc.add(pt, G1)
    ctx = msm_context("bn254", "cpu")
    pts = ctx.curve.from_affine_ints(xs, ys)
    lim = ctx.scalars_to_limbs([1] * n)
    want = [host_point(n * (n + 1) // 2)]

    def run(complete=None):
        return ctx.curve.to_affine_ints(ctx.msm(pts, lim, complete=complete))

    monkeypatch.delenv("KZG_TPU_COMPLETE_ADD", raising=False)
    assert run() != want              # the incomplete add, as the default
    monkeypatch.setenv("KZG_TPU_COMPLETE_ADD", "1")
    assert msm_context("bn254", "cpu") is ctx
    assert run() == want
    assert run(complete=False) != want
    for value, complete in (("true", True), ("on", True), ("0", False)):
        monkeypatch.setenv("KZG_TPU_COMPLETE_ADD", value)
        assert resolve_complete(None) is complete
        assert resolve_complete(not complete) is (not complete)


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("route", ["chunks", "ranges"])
def test_bucket_route_both_accumulate_routes_match_host_oracle(
        monkeypatch, route, complete):
    """Both routes of the accumulate (``accumulate_run``) equal the host
    oracle on random, all-equal and half-zero sets, and count their call.
    At n = 2048 with c lowered to 6 (64 entries a bucket) a lowered
    ACC_FILL_THREADS gives runs of 64 entries; the default keeps the chunk
    route."""
    from kzg_snark_tpu_torch.ops import msm_kernel as mk
    from kzg_snark_tpu_torch.utils import build
    n = 2048
    monkeypatch.setattr(mk, "window_bits", lambda m: 6)
    if route == "ranges":
        monkeypatch.setattr(mk, "ACC_FILL_THREADS", 3 * 43 * n // 64)
    assert mk.accumulate_run(3, 43, n, 6) == (64 if route == "ranges" else 0)
    pts, ks = basis(n)
    ctx = msm_context("bn254", "cpu")
    rng = np.random.default_rng(17)
    sets = [SKEWED[name](n, rng) for name in ("random", "all-equal",
                                               "half-zero")]
    lim = torch.stack([ctx.scalars_to_limbs(s) for s in sets])
    build.reset_launches()
    got = ctx.curve.to_affine_ints(ctx.msm(pts, lim, complete=complete))
    assert got == [host_point(sum(a * b for a, b in zip(s, ks)))
                   for s in sets]
    assert set(build.msm_route_counts()) == {route}
