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

from kzg_snark_tpu.ops import fr as jfr
from kzg_snark_tpu_torch.ops import fr as tfr
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
    jb, tb = backends
    _, _, (ja, _), (ta, _) = data
    assert same(jb.batch_inv(ja), tb.batch_inv(ta))
    assert same(jb.exclusive_prefix_prod(ja), tb.exclusive_prefix_prod(ta))
    assert same(jb.suffix_sums_exclusive(ja), tb.suffix_sums_exclusive(ta))
    assert same(jb.sum_reduce(ja), tb.sum_reduce(ta))
    odd = slice(0, N - 5)
    assert same(jb.sum_reduce(ja[:, odd]), tb.sum_reduce(ta[:, odd]))
    assert same(jb.exclusive_prefix_prod(ja[:, odd]),
                tb.exclusive_prefix_prod(ta[:, odd].contiguous()))


def test_powers_of(backends):
    jb, tb = backends
    for count in (1, 7, 16):
        assert same(jb.powers_of(12345, count), tb.powers_of(12345, count))


def test_convert_roundtrip(data):
    _, _, (ja, _), (ta, _) = data
    back = limbs16_to_tensor(np.asarray(ja))
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
