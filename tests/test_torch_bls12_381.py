"""The port at BLS12-381 against the JAX package, on the CPU.

BLS12-381's scalar field Fr (255 bits) takes the port's 8-word kernels, its
base field Fq (381 bits) their 12-word instantiation: R = 2^256 and 2^384,
the JAX package's 16 and 24 16-bit limbs, so both hold the same Montgomery
integers.  Inputs are made from a numpy seed and given to both packages;
the port runs the kernels' plain versions (CPU tensors):

* field mul, add and sub, the product and sum scans, the power and the
  batched inverse, at Fr and Fq, against the JAX backends under jax.jit
  (equal limbs), at 257 elements and at 16;
* the NTT at n = 2^6 against the JAX ntt_context (equal limbs);
* curve add, double and the mixed adds at 12 words against the JAX
  package's host curve (equal affine points; the g++ build of the 12-word
  thread bodies is held to the plain versions' representatives in
  tests/test_torch_host_build.py);
* the bucket-route MSM at 2048 points against the host oracle (equal
  affine points): random scalars on an unstructured basis, and the
  structured basis [(i+1) G] with complete=True;
* setup_g1_powers at d = 8 against the JAX host KZG setup, and the "cuda"
  KZG's commit, open, check and batch_check (as tests/test_bls12_381.py);
* utils/convert round trips between (24, n) and (12, n), and an SRS in the
  JAX layout that commits identically;
* the slice as a whole: DeviceProver("bls12_381", device="cpu") on the
  n = 8 circuit of tests/test_bls12_381.py, its index and proof
  byte-identical to the JAX host prover's with normalized commitments,
  accepted by the port's verifier, a tampered copy rejected.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_snark_tpu import constants as C
from kzg_snark_tpu.models.kzg import KZG as JaxKZG
from kzg_snark_tpu.ops import fr as jfr
from kzg_snark_tpu.ops import ntt as jntt
from kzg_snark_tpu.ops.host import curve as jhc
from kzg_snark_tpu.ops.host.field import base_field as jhc_field
from kzg_snark_tpu.ops.host.poly import Poly as JaxPoly
from kzg_snark_tpu.rng import Rng
from kzg_snark_tpu_torch.models.kzg import KZG as PortKZG
from kzg_snark_tpu_torch.ops import cuda_fr
from kzg_snark_tpu_torch.ops import fr as tfr
from kzg_snark_tpu_torch.ops import scan as tscan
from kzg_snark_tpu_torch.ops.g1 import curve_ops
from kzg_snark_tpu_torch.ops.host.poly import Poly
from kzg_snark_tpu_torch.ops.msm import MsmContext, msm_context
from kzg_snark_tpu_torch.ops.ntt import ntt_context
from kzg_snark_tpu_torch.rng import Rng as PortRng
from kzg_snark_tpu_torch.utils.convert import (device_srs_from_jax,
                                               limbs16_to_tensor,
                                               points16_to_tensor,
                                               tensor_to_limbs16, to_plain)

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)

CURVE = "bls12_381"
R, P = C.BLS12_381_R, C.BLS12_381_P
N = 257
SMALL = 16
TAU = 0xB15B15B15


def sample(p, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def same(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), tensor_to_limbs16(port_t))



# ---------------------------------------------------------------------------
# Field: Fr (8 words) and Fq (12 words).
# ---------------------------------------------------------------------------

FIELD_OPS = ("mul", "add", "sub", "prefix_prod", "suffix_sums", "pow",
             "mul_small", "add_small", "sub_small")


def _field_ops(be, a, b, e):
    """The ops held to JAX, on either package's backend: K1 and the two
    scans (fr_scan: the forward product, the reverse sum) at N, the power
    (fr_pow) at SMALL."""
    return {"mul": be.mul(a, b), "add": be.add(a, b), "sub": be.sub(a, b),
            "prefix_prod": be.exclusive_prefix_prod(b),
            "suffix_sums": be.suffix_sums_exclusive(a),
            "pow": be.pow_const(a[:, :SMALL], e)}


@pytest.fixture(scope="module", params=["fr", "fq"])
def field_results(request):
    """(field, JAX results, port results, limb count) of every op of
    FIELD_OPS on N numpy-seeded elements (0, 1 and p - 1 among them); the
    power is e = p - 2, over the first SMALL."""
    name = request.param + "_backend"
    jb = getattr(jfr, name)(CURVE)
    tb = getattr(tfr, name)(CURVE, "cpu")
    p = jb.modulus
    ta = tb.from_ints(sample(p, N, 1))
    tb_ = tb.from_ints(sample(p, N, 2)[::-1])
    assert same(jb.from_ints(tb.to_ints(ta)), ta)
    ja, jbb = tensor_to_limbs16(ta), tensor_to_limbs16(tb_)
    want = jax.jit(lambda a, b: _field_ops(jb, a, b, p - 2))(ja, jbb)
    got = _field_ops(tb, ta, tb_, p - 2)
    for op in ("mul", "add", "sub"):     # K1 at a narrow width as well
        want[op + "_small"] = want[op][:, :SMALL]
        got[op + "_small"] = getattr(tb, op)(ta[:, :SMALL], tb_[:, :SMALL])
    return request.param, want, got, tb.num_limbs


def test_field_limb_counts(field_results):
    field, _, got, limbs = field_results
    assert limbs == {"fr": 8, "fq": 12}[field]
    assert got["mul"].shape == (limbs, N)


@pytest.mark.parametrize("op", FIELD_OPS)
def test_field_op_matches_jax(field_results, op):
    _, want, got, _ = field_results
    assert same(want[op], got[op]), op


def test_scan_totals(field_results):
    """fr_scan's totals: the product's is the last prefix times the last
    element, the sum's the first suffix plus the first element."""
    field, _, got, _ = field_results
    be = getattr(tfr, field + "_backend")(CURVE, "cpu")
    p = be.modulus
    a = be.from_ints(sample(p, N, 1))
    b = be.from_ints(sample(p, N, 2)[::-1])
    _, prod = tscan.fr_scan(be.consts, b, tscan.MUL)
    _, total = tscan.fr_scan(be.consts, a, tscan.ADD, want_scan=False)
    assert torch.equal(prod, be.mul(got["prefix_prod"][:, -1:], b[:, -1:]))
    assert torch.equal(total, be.add(got["suffix_sums"][:, :1], a[:, :1]))
    assert be.to_ints(total) == [sum(sample(p, N, 1)) % p]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_plain_paths_agree(field, monkeypatch):
    """The plain versions' two ways (Python integers for CPU batches of at
    most INT_COLUMNS, the 16- and 32-bit digit arithmetic that CUDA tensors
    and wider batches take) give equal words, the broadcast operand and
    the mixed add / sub pass included."""
    be = getattr(tfr, field + "_backend")(CURVE, "cpu")
    fc = be.consts
    a = be.from_ints(sample(fc.modulus, 64, 3))
    b = be.from_ints(sample(fc.modulus, 64, 4)[::-1])

    def run():
        return [cuda_fr.mul_plain(fc, a, b),
                cuda_fr.mul_plain(fc, a, b[:, 5:6]),
                cuda_fr.add_plain(fc, a, b), cuda_fr.sub_plain(fc, a, b),
                cuda_fr.addsub_plain(fc, a, b, 20)]
    ints = run()
    monkeypatch.setattr(cuda_fr, "INT_COLUMNS", 0)
    for x, y in zip(ints, run()):
        assert torch.equal(x, y)
    assert torch.equal(ints[4], torch.cat([ints[2][:, :20], ints[3][:, 20:]],
                                          dim=1))


# ---------------------------------------------------------------------------
# NTT over Fr at n = 2^6.
# ---------------------------------------------------------------------------


NTT_N = 64
SHIFT = 7                   # the coset shift: BLS12-381 Fr's generator


@pytest.fixture(scope="module")
def ntt_results():
    """(JAX outputs, port context, input) at NTT_N.  The JAX side is the
    JAX package's NttContext (its bit reversal, butterflies and n^-1
    scale) at the deterministic domain root of both packages'
    ntt_context, built and run in one jax.jit; its tables of root powers
    come from host integers, since its own table build compiles each
    doubling step apart (the port's tables are held to the same integers
    here)."""
    from kzg_snark_tpu.ops.host.field import scalar_field

    tctx = ntt_context(CURVE, NTT_N, "cpu")
    root = tctx.root
    assert root == int(scalar_field(CURVE).nth_root_of_unity(NTT_N))
    assert SHIFT == scalar_field(CURVE).generator
    be = tctx.backend
    assert be.to_ints(tctx.tw_fwd) == [pow(root, i, R)
                                       for i in range(NTT_N // 2)]
    assert be.to_ints(tctx.tw_inv) == [pow(root, -i, R)
                                       for i in range(NTT_N // 2)]

    class HostTables(jntt.NttContext):
        def _build_powers(self, w, count):
            return self.backend.from_ints([pow(w, i, R)
                                           for i in range(count)])

    def run(x):
        jctx = object.__new__(HostTables)
        jctx._init(jfr.fr_backend(CURVE), NTT_N, root)
        return {"ntt": jctx.ntt(x, light=True),
                "intt": jctx.intt(x, light=True),
                "coset_ntt": jctx.ntt(jctx.backend.mul(
                    x, jctx.powers(SHIFT)), light=True)}
    tx = be.from_ints(sample(R, NTT_N, 5))
    return jax.jit(run)(jnp.asarray(tensor_to_limbs16(tx))), tctx, tx


@pytest.mark.parametrize("op", ["ntt", "intt", "coset_ntt"])
def test_ntt_matches_jax(ntt_results, op):
    want, tctx, tx = ntt_results
    got = tctx.coset_ntt(tx, SHIFT) if op == "coset_ntt" \
        else getattr(tctx, op)(tx)
    assert same(want[op], got)


def test_ntt_scan_mode_matches_staged(ntt_results):
    want, tctx, tx = ntt_results
    assert same(want["ntt"], tctx.ntt(tx, mode="scan"))
    assert same(want["intt"], tctx.intt(tx, mode="scan"))


# ---------------------------------------------------------------------------
# Curve over Fq at 12 words.
# ---------------------------------------------------------------------------

W = 8


@pytest.fixture(scope="module")
def curve_points():
    """Affine k G for numpy-seeded k on the port (limbs) and on the JAX
    package's host curve, their doubles (Z != 1), the identity and -P."""
    tc = curve_ops(CURVE, "cpu")
    Fp = jhc_field(CURVE)
    G = (Fp(C.BLS12_381_G1[0]), Fp(C.BLS12_381_G1[1]), Fp(1))
    ks = [int(k) for k in np.random.default_rng(8).integers(2, 1 << 40, W)]
    host = [jhc.multiply(G, k) for k in ks]
    aff = [jhc.normalize(pt) for pt in host]
    tp = tc.from_affine_ints([int(a[0]) for a in aff],
                             [int(a[1]) for a in aff])
    assert tp.shape == (3, 12, W)
    td = tc.double(tp)
    ident = jhc.identity(Fp)
    port = {"p": tp, "d": td, "o": tc.identity((W,)).contiguous(),
            "neg": torch.stack([tp[0], tc.f.neg(tp[1]), tp[2]]),
            "roll_d": td.roll(1, -1).contiguous(),
            "roll_p": tp.roll(1, -1).contiguous()}
    dbl = [jhc.double(pt) for pt in host]
    hosts = {"p": host, "d": dbl, "o": [ident] * W,
             "neg": [jhc.neg(pt) for pt in host],
             "roll_d": dbl[-1:] + dbl[:-1], "roll_p": host[-1:] + host[:-1]}
    return tc, port, hosts


def _cat(pts, names):
    return torch.cat([pts[k] for k in names], dim=-1).contiguous()


def _affine(pts):
    out = [jhc.normalize(pt) for pt in pts]
    return [None if a is None else (int(a[0]), int(a[1])) for a in out]


def test_curve_double(curve_points):
    """dbl-2009-l on P (Z = 1), 2P (Z != 1) and the identity."""
    tc, port, host = curve_points
    names = ["p", "d", "o"]
    want = [jhc.double(pt) for k in names for pt in host[k]]
    assert tc.to_affine_ints(tc.double(_cat(port, names))) == _affine(want)


def test_curve_add_cases(curve_points):
    """The complete add (K6): general (Z != 1), P + P, P + (-P), O + P,
    P + O, O + O, lane by lane in one call."""
    tc, port, host = curve_points
    left = ["d", "d", "p", "o", "d", "o"]
    right = ["roll_d", "d", "neg", "d", "o", "o"]
    want = [jhc.add(x, y) for a, b in zip(left, right)
            for x, y in zip(host[a], host[b])]
    got = tc.add(_cat(port, left), _cat(port, right))
    assert tc.to_affine_ints(got) == _affine(want)


def test_curve_mixed_adds(curve_points):
    """The mixed adds with an affine q: the complete one (K9, through
    CurveOps.add_mixed) on a Jacobian P, the identity and P == q (its
    doubling case), and the incomplete one (the bucket accumulate's) on
    the first two."""
    tc, port, host = curve_points
    f = cuda_fr.PlainField(tc.f.consts)
    acc = _cat(port, ["d", "o", "p"])
    q = _cat(port, ["roll_p", "roll_p", "p"])
    want = _affine([jhc.add(x, y) for a, b in [("d", "roll_p"),
                                                ("o", "roll_p"), ("p", "p")]
                    for x, y in zip(host[a], host[b])])
    got = tc.add_mixed(acc, q[0].contiguous(), q[1].contiguous())
    assert tc.to_affine_ints(got) == want
    n = 2 * W
    fast = cuda_fr.add_mixed_fast_formula(f, acc[..., :n], q[0][:, :n],
                                          q[1][:, :n])
    assert tc.to_affine_ints(fast) == want[:n]


# ---------------------------------------------------------------------------
# The bucket-route MSM at 2048 points.
# ---------------------------------------------------------------------------

MSM_N = 2048


def _host_generator():
    from kzg_snark_tpu_torch.ops.host.field import base_field
    Fp = base_field(CURVE)
    return (Fp(C.BLS12_381_G1[0]), Fp(C.BLS12_381_G1[1]), Fp(1))


def _random_basis(n, seed):
    """(points (3, 12, n), multipliers): k_i G for odd random 128-bit k_i
    (as ops/benchpoints.random_point_basis draws them), on the host by
    Jacobian mixed adds of the 2^j G (Python integers; every partial sum
    is below 2^j G, so no add meets its own operand)."""
    from kzg_snark_tpu_torch.ops.host import curve as hc
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(16), "little") | 1 | (1 << 127)
          for _ in range(n)]
    table, pt = [], _host_generator()
    for _ in range(128):
        a = hc.normalize(pt)
        table.append((int(a[0]), int(a[1])))
        pt = hc.double(pt)
    xs, ys = [], []
    for k in ks:
        X, Y, Z = table[0][0], table[0][1], 1
        for j in range(1, 128):
            if not (k >> j) & 1:
                continue
            x2, y2 = table[j]
            z2 = Z * Z % P
            h = (x2 * z2 - X) % P
            r = (y2 * z2 * Z - Y) % P
            hh = h * h % P
            hhh, v = h * hh % P, X * hh % P
            X = (r * r - hhh - 2 * v) % P
            Y, Z = (r * (v - X) - Y * hhh) % P, Z * h % P
        zi = pow(Z, -1, P)
        xs.append(X * zi * zi % P)
        ys.append(Y * zi * zi * zi % P)
    return msm_context(CURVE, "cpu").curve.from_affine_ints(xs, ys), ks


def _progression(n):
    """[(i + 1) G] for i < n, by host adds, and the multipliers."""
    from kzg_snark_tpu_torch.ops.host import curve as hc
    G = _host_generator()
    pt, xs, ys = G, [], []
    for _ in range(n):
        a = hc.normalize(pt)
        xs.append(int(a[0]))
        ys.append(int(a[1]))
        pt = hc.add(pt, G)
    return msm_context(CURVE, "cpu").curve.from_affine_ints(xs, ys), \
        list(range(1, n + 1))


def _oracle(scalars, ks):
    from kzg_snark_tpu_torch.ops.host import curve as hc
    total = sum(s * k for s, k in zip(scalars, ks)) % R
    a = hc.normalize(hc.multiply(_host_generator(), total))
    return None if a is None else (int(a[0]), int(a[1]))


def test_bucket_route_random_scalars():
    """A random-multiplier basis and full-width random scalars, 0, 1 and
    r - 1 among them, on the default (incomplete) add."""
    assert MsmContext.route(MSM_N) == "bucket"
    pts, ks = _random_basis(MSM_N, 11)
    s = sample(R, MSM_N, 12)
    ctx = msm_context(CURVE, "cpu")
    got = ctx.curve.to_affine_ints(ctx.msm(pts, ctx.scalars_to_limbs(s)))
    assert got == [_oracle(s, ks)]


def test_bucket_route_structured_basis_complete():
    """[(i+1) G] with equal scalars: the first bucket's running sums meet
    the points themselves (G + 2G = 3G), which the complete add doubles."""
    pts, ks = _progression(MSM_N)
    s = [R - 1] * MSM_N
    ctx = msm_context(CURVE, "cpu")
    got = ctx.curve.to_affine_ints(
        ctx.msm(pts, ctx.scalars_to_limbs(s), complete=True))
    assert got == [_oracle(s, ks)]


# ---------------------------------------------------------------------------
# SRS, the "cuda" KZG, and the JAX-layout conversions.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kzg_pair():
    """The port's "cuda" KZG and the JAX host KZG, each with its SRS at
    d = 8 and one tau."""
    port = PortKZG(CURVE, backend="cuda", rng=PortRng(4242), device="cpu")
    host = JaxKZG(curve_type=CURVE, rng=Rng(4242))
    host.normalize_commitments = True
    return port, port.setup(8, tau=TAU), host, host.setup(8, tau=TAU)


def test_setup_matches_jax_host(kzg_pair):
    port, (ck_p, rk_p), host, (ck_h, rk_h) = kzg_pair
    assert ck_p.points.shape == (3, 12, 9)
    assert to_plain(rk_p) == to_plain(rk_h)
    for i in range(9):
        assert to_plain(ck_p[i]) == to_plain(host._normalize_point(ck_h[i]))


def test_kzg_commit_open_check(kzg_pair):
    port, (ck, rk), host, (ck_h, _) = kzg_pair
    F = port.Fq
    polys = [Poly(F, [1, 2, 3]), Poly(F, [4, 0, 0, 5])]
    comms = port.commit(ck, polys)
    assert to_plain(comms) == to_plain(host.commit(
        ck_h, [JaxPoly(host.Fq, [1, 2, 3]), JaxPoly(host.Fq, [4, 0, 0, 5])]))
    proof = port.open(ck, polys, 7, 42)
    evals = [p(7) for p in polys]
    assert port.check(rk, comms, 7, evals, proof, 42)
    evals[0] = evals[0] + 1
    assert not port.check(rk, comms, 7, evals, proof, 42)


def test_kzg_batch_check(kzg_pair):
    port, (ck, rk), _, _ = kzg_pair
    F = port.Fq
    lists = [[Poly(F, [1, 1, 2])], [Poly(F, [3, 0, 0, 7])]]
    zs, xis = [F(5), F(9)], [F(2), F(3)]
    comms = [port.commit(ck, ps) for ps in lists]
    evals = [[p(z) for p in ps] for ps, z in zip(lists, zs)]
    proofs = [port.open(ck, ps, z, xi) for ps, z, xi in zip(lists, zs, xis)]
    assert port.batch_check(rk, comms, zs, evals, proofs, xis)
    evals[1][0] = evals[1][0] + 1
    assert not port.batch_check(rk, comms, zs, evals, proofs, xis)


def test_convert_roundtrips():
    """(24, n) 16-bit limbs <-> (12, n) words, and (16, n) <-> (8, n)."""
    rng = np.random.default_rng(21)
    for limbs in (24, 16):
        arr = rng.integers(0, 1 << 16, size=(limbs, 5), dtype=np.uint32)
        t = limbs16_to_tensor(arr, device="cpu")
        assert t.shape == (limbs // 2, 5)
        assert np.array_equal(tensor_to_limbs16(t), arr)
    with pytest.raises(ValueError):
        limbs16_to_tensor(np.zeros((20, 1), dtype=np.uint32), device="cpu")


def test_jax_layout_srs_commits_identically(kzg_pair):
    port, (ck_p, _), host, (ck_h, _) = kzg_pair
    aff = [jhc.normalize(pt) for pt in ck_h]
    jq = jfr.fq_backend(CURVE)
    # The JAX CurveOps.from_affine_ints, its Montgomery step under jit.
    to_mont = jax.jit(jq.to_mont)
    x, y = (to_mont(jnp.asarray(jfr.ints_to_limb_array(
        [int(a[i]) for a in aff], jq.num_limbs))) for i in (0, 1))
    jax_points = jnp.stack([x, y, jnp.broadcast_to(jq.one_mont, x.shape)])
    assert jax_points.shape == (3, 24, 9)
    assert torch.equal(points16_to_tensor(np.asarray(jax_points), "cpu"),
                       ck_p.points)
    ck_j = device_srs_from_jax(CURVE, np.asarray(jax_points), device="cpu")
    coeffs = [int(v) for v in np.random.default_rng(5).integers(
        0, 1 << 62, size=9)]
    assert to_plain(port.commit(ck_j, [coeffs])) == \
        to_plain(host.commit(ck_h, [coeffs]))


# ---------------------------------------------------------------------------
# The slice: PLONK on BLS12-381, n = 8.
# ---------------------------------------------------------------------------

PLONK_N = 8
PLONK_TAU = 777777


@functools.lru_cache(maxsize=None)
def _circuit(package):
    """The n = 8 circuit of tests/test_bls12_381.py over either package's
    Fr: one gate 3 x 4 = 12, zero gates, the identity permutation."""
    if package == "jax":
        from kzg_snark_tpu.ops.host.field import scalar_field
    else:
        from kzg_snark_tpu_torch.ops.host.field import scalar_field
    Fr = scalar_field(CURVE)
    n = PLONK_N
    z = [Fr(0)] * n
    qM = [Fr(1)] + [Fr(0)] * (n - 1)
    qO = [Fr(-1)] + [Fr(0)] * (n - 1)
    w = ([Fr(3)] + [Fr(0)] * (n - 1) + [Fr(4)] + [Fr(0)] * (n - 1)
         + [Fr(12)] + [Fr(0)] * (n - 1))
    return (qM, list(z), list(z), qO, list(z), list(range(3 * n))), w


@pytest.fixture(scope="module")
def plonk_runs():
    """(port keys, port proof, JAX host keys, JAX host proof) under the
    same Rng seeds and tau."""
    from kzg_snark_tpu.models.plonk.indexer import Indexer
    from kzg_snark_tpu.models.plonk.prover import Prover
    from kzg_snark_tpu_torch.models.plonk.device import DeviceProver

    args, w = _circuit("port")
    keys = DeviceProver(CURVE, rng=PortRng(321), device="cpu").preprocess(
        *args, max_degree=PLONK_N + 5, tau=PLONK_TAU)
    proof = DeviceProver(CURVE, rng=PortRng(322), device="cpu").prove(
        keys[0], [], w)
    args_h, w_h = _circuit("jax")
    indexer = Indexer(CURVE, backend="host", rng=Rng(321))
    indexer.kzg.normalize_commitments = True
    keys_h = indexer.preprocess(*args_h, max_degree=PLONK_N + 5,
                                tau=PLONK_TAU)
    prover = Prover(CURVE, backend="host", rng=Rng(322))
    prover.kzg.normalize_commitments = True
    return keys, proof, keys_h, prover.prove(keys_h[0], [], w_h)


def test_plonk_index_matches_jax_host(plonk_runs):
    (ipk, ivk), _, (ipk_h, ivk_h), _ = plonk_runs
    assert ipk["ck"].points.shape[:2] == (3, 12)
    assert int(ipk["subgroups"]["k1"]) == int(ipk_h["subgroups"]["k1"])
    assert int(ipk["subgroups"]["k2"]) == int(ipk_h["subgroups"]["k2"])
    assert to_plain(ivk["commitments"]) == to_plain(ivk_h["commitments"])


@pytest.mark.parametrize("part", ["commitments", "evaluations",
                                  "kzg_proofs"])
def test_plonk_proof_matches_jax_host_bytes(plonk_runs, part):
    _, proof, _, proof_h = plonk_runs
    assert to_plain(proof[part]) == to_plain(proof_h[part])


def test_plonk_proof_verifies_and_tamper_rejected(plonk_runs):
    from kzg_snark_tpu_torch.models.plonk.verifier import Verifier

    (_, ivk), proof, _, _ = plonk_runs
    assert Verifier(CURVE, rng=PortRng(323)).verify(ivk, [], proof)
    tampered = {k: dict(v) for k, v in proof.items()}
    tampered["evaluations"]["a"] = proof["evaluations"]["a"] + 1
    assert not Verifier(CURVE, rng=PortRng(324)).verify(ivk, [], tampered)
