"""The port's ``FieldBackend`` against the JAX package's, op by op.

Inputs are numpy-seeded random field elements plus 0, 1 and p - 1; both
backends get the same values, and results must be equal Montgomery limb
arrays (the two layouts hold the same integers, R = 2^256).  On the CPU the
port runs the K1 plain version; it is also held to the JAX Pallas kernel
``fused_mul`` in interpret mode.
"""

import numpy as np
import pytest
import torch

from kzg_snark_tpu import constants as C
from kzg_snark_tpu.ops import fr as jfr
from kzg_snark_tpu_torch.ops import cuda_fr as tcuda
from kzg_snark_tpu_torch.ops import fr as tfr
from kzg_snark_tpu_torch.ops import scan as tscan
from kzg_snark_tpu_torch.utils.convert import (limbs16_to_tensor,
                                               tensor_to_limbs16)

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)

N = 32


@pytest.fixture(params=["fr", "fq"], scope="module")
def backends(request):
    if request.param == "fr":
        return jfr.fr_backend("bn254"), tfr.fr_backend("bn254", "cpu")
    return jfr.fq_backend("bn254"), tfr.fq_backend("bn254", "cpu")


def sample(p, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def sample_zeros(p, n, seed):
    """sample() with zeros at every fifth position as well."""
    vals = sample(p, n, seed)
    vals[::5] = [0] * len(vals[::5])
    return vals


def same(jax_arr, port_t):
    return np.array_equal(np.asarray(jax_arr), tensor_to_limbs16(port_t))


@pytest.fixture(scope="module")
def data(backends):
    jb, tb = backends
    xs, ys = sample(jb.modulus, N, 1), sample(jb.modulus, N, 2)[::-1]
    return xs, ys, (jb.from_ints(xs), jb.from_ints(ys)), (
        tb.from_ints(xs), tb.from_ints(ys))


def test_from_to_ints(backends, data):
    jb, tb = backends
    xs, _, (ja, _), (ta, _) = data
    assert same(ja, ta)
    assert tb.to_ints(ta) == xs == jb.to_ints(ja)
    raw = tb.from_mont(ta)
    assert same(jb.from_mont(ja), raw)
    assert same(jb.to_mont(np.asarray(tensor_to_limbs16(raw))),
                tb.to_mont(raw))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(backends, data, op):
    jb, tb = backends
    _, _, (ja, jbb), (ta, tbb) = data
    assert same(getattr(jb, op)(ja, jbb), getattr(tb, op)(ta, tbb))
    # scalar broadcast on either side
    assert same(getattr(jb, op)(ja[:, 3:4], jbb),
                getattr(tb, op)(ta[:, 3:4], tbb))


@pytest.mark.parametrize("op", ["neg", "double", "square"])
def test_unary_ops(backends, data, op):
    jb, tb = backends
    _, _, (ja, _), (ta, _) = data
    assert same(getattr(jb, op)(ja), getattr(tb, op)(ta))


def test_select_is_zero(backends, data):
    jb, tb = backends
    _, _, (ja, jbb), (ta, tbb) = data
    cond = np.arange(N) % 3 == 0
    assert same(jb.select(cond, ja, jbb),
                tb.select(torch.from_numpy(cond), ta, tbb))
    assert np.array_equal(np.asarray(jb.is_zero(ja)), tb.is_zero(ta).numpy())


def test_pow_inv(backends, data):
    jb, tb = backends
    _, _, (ja, _), (ta, _) = data
    for e in (0, 1, 5, 2 ** 20 + 3):
        assert same(jb.pow_const(ja, e), tb.pow_const(ta, e)), e
    assert same(jb.inv(ja), tb.inv(ta))


def test_batch_inv_and_scans(backends, data):
    import jax
    jb, tb = backends
    _, _, (ja, _), (ta, _) = data
    jit = {name: jax.jit(getattr(jb, name)) for name in (
        "batch_inv", "exclusive_prefix_prod", "suffix_sums_exclusive",
        "sum_reduce")}
    assert same(jit["batch_inv"](ja), tb.batch_inv(ta))
    assert same(jit["exclusive_prefix_prod"](ja),
                tb.exclusive_prefix_prod(ta))
    assert same(jit["suffix_sums_exclusive"](ja),
                tb.suffix_sums_exclusive(ta))
    assert same(jit["sum_reduce"](ja), tb.sum_reduce(ta))
    odd = slice(0, N - 5)
    assert same(jit["sum_reduce"](ja[:, odd]), tb.sum_reduce(ta[:, odd]))
    assert same(jit["exclusive_prefix_prod"](ja[:, odd]),
                tb.exclusive_prefix_prod(ta[:, odd].contiguous()))


def test_powers_of(backends):
    jb, tb = backends
    for count in (1, 7, 16):
        assert same(jb.powers_of(12345, count), tb.powers_of(12345, count))


def test_convert_roundtrip(data):
    _, _, (ja, _), (ta, _) = data
    back = limbs16_to_tensor(np.asarray(ja), device="cpu")
    assert torch.equal(back, ta)


def test_mul_plain_matches_pallas_fused_mul():
    """K1's plain version against the JAX Pallas kernel in interpret mode
    at 2048 elements (the in-kernel chunk loop of tests/test_pallas.py)."""
    from kzg_snark_tpu.ops import pallas_fr
    from kzg_snark_tpu_torch.ops import cuda_fr

    jb, tb = jfr.fr_backend("bn254"), tfr.fr_backend("bn254", "cpu")
    n = 2048
    xs, ys = sample(jb.modulus, n, 3), sample(jb.modulus, n, 4)
    old = pallas_fr._INTERPRET
    pallas_fr._INTERPRET = True
    try:
        want = pallas_fr.fused_mul(jb, jb.from_ints(xs), jb.from_ints(ys))
    finally:
        pallas_fr._INTERPRET = old
    got = cuda_fr.mul_plain(tb.consts, tb.from_ints(xs), tb.from_ints(ys))
    assert same(want, got)


@pytest.fixture(scope="module")
def jax_fr():
    """The JAX Fr backend and its chains under jit (one compile a shape;
    the flipped inputs reuse it)."""
    import jax
    jb = jfr.fr_backend("bn254")
    names = ("exclusive_prefix_prod", "suffix_sums_exclusive", "sum_reduce",
             "batch_inv", "mul")
    return jb, {name: jax.jit(getattr(jb, name)) for name in names}


@pytest.mark.parametrize("n", [1, 2, 7, 64, 257])
def test_fr_scan_plain_matches_jax(jax_fr, n):
    """Both operations in both directions, scan and total, against the JAX
    chains: forward products = exclusive_prefix_prod, reverse sums =
    suffix_sums_exclusive, the other two the same on the flipped input;
    the sum's total = sum_reduce, the product's = last prefix x last.  The
    sums take an input with zeros; the products also take one with none,
    where no prefix is forced to zero."""
    jb, jit = jax_fr
    tb = tfr.fr_backend("bn254", "cpu")
    with_zeros = sample_zeros(jb.modulus, n, 40 + n)
    no_zeros = [v or 1 for v in sample(jb.modulus, n, 40 + n)]
    flip = lambda x: np.asarray(x)[:, ::-1]                  # noqa: E731
    epp = jit["exclusive_prefix_prod"]
    suf = jit["suffix_sums_exclusive"]
    for op, inputs in ((tscan.MUL, (no_zeros, with_zeros)),
                       (tscan.ADD, (with_zeros,))):
        for vals in inputs:
            t = tb.from_ints(vals)
            j = tensor_to_limbs16(t)
            want = {
                (tscan.MUL, False): (epp(j), jit["mul"](epp(j)[:, -1:],
                                                        j[:, -1:])),
                (tscan.MUL, True): (flip(epp(flip(j))), None),
                (tscan.ADD, True): (suf(j), jit["sum_reduce"](j)),
                (tscan.ADD, False): (flip(suf(flip(j))), None)}
            for reverse in (False, True):
                scan_j, total_j = want[op, reverse]
                got, total = tscan.fr_scan_plain(tb.consts, t, op, reverse)
                assert same(scan_j, got), (op, reverse)
                if total_j is not None:
                    assert same(total_j, total), (op, reverse)
                # the total does not depend on the direction
                assert torch.equal(total, tscan.fr_scan_plain(
                    tb.consts, t, op, not reverse)[1])


@pytest.mark.parametrize("e", [0, 1, 2, 5, C.BN254_R - 2],
                         ids=["0", "1", "2", "5", "r-2"])
def test_fr_pow_plain_matches_jax(e):
    import jax
    jb, tb = jfr.fr_backend("bn254"), tfr.fr_backend("bn254", "cpu")
    t = tb.from_ints(sample_zeros(jb.modulus, 16, 7))
    want = jax.jit(jb.pow_const, static_argnums=1)(tensor_to_limbs16(t), e)
    assert same(want, tscan.fr_pow_plain(tb.consts, t, e))


def test_batch_inv_zero_entries(jax_fr):
    """The rewired batch_inv (masked forward and reverse product scans, one
    power of the total) with zeros at the ends and inside."""
    jb, jit = jax_fr
    tb = tfr.fr_backend("bn254", "cpu")
    vals = sample_zeros(jb.modulus, 11, 9)
    vals[-1] = 0
    t = tb.from_ints(vals)
    got = tb.batch_inv(t)
    assert same(jit["batch_inv"](tensor_to_limbs16(t)), got)
    assert tb.to_ints(got) == [pow(v, -1, jb.modulus) if v else 0
                               for v in vals]


CHAINS = {
    "pow_const": lambda be, a: be.pow_const(a, 5),
    "pow_const_r-2": lambda be, a: be.pow_const(a, C.BN254_R - 2),
    "inv": lambda be, a: be.inv(a),
    "batch_inv": lambda be, a: be.batch_inv(a),
    "exclusive_prefix_prod": lambda be, a: be.exclusive_prefix_prod(a),
    "powers": lambda be, a: be.exclusive_prefix_prod(
        a[:, :1].expand(8, a.shape[1])),
    "sum_reduce": lambda be, a: be.sum_reduce(a),
    "suffix_sums_exclusive": lambda be, a: be.suffix_sums_exclusive(a),
}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_chain_launches_do_not_grow(monkeypatch, chain):
    """On a device other than the CPU a chain makes the same wrapper calls
    (hence launches: one a call, a total alone too) at
    N = 64 and N = 4096, and for a 3-bit and a 254-bit exponent.  The
    wrappers are replaced by fakes that record each call and return
    tensors of the right shape on the meta device, which holds no data."""
    calls = []

    def ewise(name):
        def fake(fc, a, b):
            calls.append(name)
            return torch.empty((8, max(a.shape[1], b.shape[1])),
                               dtype=torch.int32, device=a.device)
        return fake

    def fake_scan(fc, a, op, reverse=False, want_scan=True):
        calls.append(("fr_scan", want_scan))
        out = torch.empty((8, a.shape[1]), dtype=torch.int32,
                          device=a.device)
        return (out if want_scan else None), out[:, :1]

    def fake_pow(fc, a, exponent):
        calls.append("fr_pow")
        return torch.empty_like(a)

    for name in ("fr_mul", "fr_add", "fr_sub"):
        monkeypatch.setattr(tcuda, name, ewise(name))
    monkeypatch.setattr(tscan, "fr_scan", fake_scan)
    monkeypatch.setattr(tscan, "fr_pow", fake_pow)
    be = tfr.FieldBackend(C.BN254_R, "meta")
    counts = []
    for n in (64, 4096):
        calls.clear()
        out = CHAINS[chain](be, torch.empty((8, n), dtype=torch.int32,
                                            device="meta"))
        assert out.device.type == "meta"
        counts.append(list(calls))
    assert counts[0] == counts[1] and counts[0]
    assert len(counts[0]) <= 10
