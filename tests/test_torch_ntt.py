"""The port's NTT against the JAX package's and the host FFT.

ntt and intt must equal the JAX ``NttContext`` limb for limb at n = 2^1 ..
2^10, and coset_ntt / coset_intt at n = 2^2.  The JAX side is called
eagerly; ntt and intt run its compile-light mode (``light=True``, one
loop body per size: the unrolled mode compiles every stage's ops apart and
costs minutes on the CPU), which gives the same integers.  The port's own
staged transform is checked against the host ``ops/host/fft.py`` at 2^11
and 2^12, odd and even log n, and the "scan" mode (K10) against the staged
transform up to 2^11.  K10's plain version is held to the JAX
``fused_butterfly`` and to its own g++-built thread body.  Inputs are
numpy-seeded.
"""

import numpy as np
import pytest
import torch

from kzg_snark_tpu.ops.host.fft import fft_ff
from kzg_snark_tpu.ops.host.field import scalar_field
from kzg_snark_tpu.ops.ntt import ntt_context as jax_ntt_context
from kzg_snark_tpu_torch.ops.ntt import bit_reverse_indices, ntt_context
from kzg_snark_tpu_torch.utils.convert import tensor_to_limbs16

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)

Fr = scalar_field("bn254")
SHIFT = Fr.generator


def values(n, seed):
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "little") % Fr.modulus
           for _ in range(n)]
    out[0] = 0
    if n > 1:
        out[1] = Fr.modulus - 1
    return out


@pytest.mark.parametrize("log_n", range(1, 11))
def test_matches_jax_ntt_context(log_n):
    n = 1 << log_n
    jctx = jax_ntt_context("bn254", n)
    tctx = ntt_context("bn254", n, "cpu")
    assert tctx.root == jctx.root
    xs = values(n, log_n)
    ja, ta = jctx.backend.from_ints(xs), tctx.backend.from_ints(xs)
    for j_out, t_out in [(jctx.ntt(ja, light=True), tctx.ntt(ta)),
                         (jctx.intt(ja, light=True), tctx.intt(ta))]:
        assert np.array_equal(np.asarray(j_out), tensor_to_limbs16(t_out))


def test_coset_matches_jax_ntt_context():
    n = 4
    jctx = jax_ntt_context("bn254", n)
    tctx = ntt_context("bn254", n, "cpu")
    xs = values(n, 99)
    ja, ta = jctx.backend.from_ints(xs), tctx.backend.from_ints(xs)
    for j_out, t_out in [
            (jctx.coset_ntt(ja, SHIFT), tctx.coset_ntt(ta, SHIFT)),
            (jctx.coset_intt(ja, SHIFT), tctx.coset_intt(ta, SHIFT))]:
        assert np.array_equal(np.asarray(j_out), tensor_to_limbs16(t_out))


@pytest.mark.parametrize("log_n", [11, 12])
def test_staged_plan_matches_host_fft(log_n):
    n = 1 << log_n
    ctx = ntt_context("bn254", n, "cpu")
    be = ctx.backend
    xs = values(n, 100 + log_n)
    a = be.from_ints(xs)
    out = be.to_ints(ctx.ntt(a))
    assert out == [int(v) for v in fft_ff([Fr(x) for x in xs],
                                          Fr(ctx.root))]
    assert be.to_ints(ctx.intt(ctx.ntt(a))) == xs


def test_bit_reverse_indices():
    assert bit_reverse_indices(8).tolist() == [0, 4, 2, 6, 1, 5, 3, 7]
    assert bit_reverse_indices(1).tolist() == [0]


def test_butterfly_plain_matches_pallas_fused_butterfly():
    """K10's plain version against the JAX Pallas ``fused_butterfly`` with
    interpret mode set, as ``tests/test_pallas.py`` runs it (256 elements:
    at that size the wrapper serves the call from the XLA combine; running
    the kernel body in interpret mode costs about a minute on the CPU)."""
    import jax.numpy as jnp

    from kzg_snark_tpu.ops import pallas_fr
    from kzg_snark_tpu.ops.fr import fr_backend as jax_fr_backend
    from kzg_snark_tpu_torch.ops.fr import fr_backend
    from kzg_snark_tpu_torch.ops.ntt_stage import butterfly_plain

    n = 256
    xl, xu, tw = values(n, 31), values(n, 32), values(n, 33)
    mask = np.random.default_rng(34).integers(0, 2, n)
    jb, tb = jax_fr_backend("bn254"), fr_backend("bn254", "cpu")
    old = pallas_fr._INTERPRET
    pallas_fr._INTERPRET = True
    try:
        want = pallas_fr.fused_butterfly(
            jb, jb.from_ints(xl), jb.from_ints(xu), jb.from_ints(tw),
            jnp.asarray(mask, dtype=jnp.uint32)[None])
    finally:
        pallas_fr._INTERPRET = old
    got = butterfly_plain(tb.consts, tb.from_ints(xl), tb.from_ints(xu),
                          tb.from_ints(tw),
                          torch.from_numpy(mask.astype(np.int32)))
    assert np.array_equal(np.asarray(want), tensor_to_limbs16(got))
    r = Fr.modulus
    expect = [(a - t * u) % r if m else (a + t * u) % r
              for a, u, t, m in zip(xl, xu, tw, mask)]
    assert tb.to_ints(got) == expect


def test_butterfly_host_build_matches_plain():
    """K10's thread body, built with g++, on the same values."""
    from kzg_snark_tpu_torch.ops.fr import fr_backend
    from kzg_snark_tpu_torch.ops.ntt_stage import butterfly_plain
    from kzg_snark_tpu_torch.utils.build import host_lib

    n = 256
    tb = fr_backend("bn254", "cpu")
    xl, xu, tw = (tb.from_ints(values(n, s)) for s in (41, 42, 43))
    mask = torch.from_numpy(
        np.random.default_rng(44).integers(0, 2, n).astype(np.int32))
    out = torch.empty_like(xl)
    host_lib().host_fr_butterfly(xl.data_ptr(), xu.data_ptr(), tw.data_ptr(),
                                 mask.data_ptr(), out.data_ptr(), n,
                                 tb.consts.ptr)
    assert torch.equal(out, butterfly_plain(tb.consts, xl, xu, tw, mask))


@pytest.mark.parametrize("log_n", [1, 4, 11])
def test_scan_mode_matches_staged(log_n):
    """The scan-mode transform (two rolls and K10 per stage) equals the
    staged plan, forward and inverse."""
    n = 1 << log_n
    ctx = ntt_context("bn254", n, "cpu")
    a = ctx.backend.from_ints(values(n, 200 + log_n))
    assert torch.equal(ctx.ntt(a, mode="scan"), ctx.ntt(a))
    assert torch.equal(ctx.intt(a, mode="scan"), ctx.intt(a))
    with pytest.raises(ValueError):
        ctx.ntt(a, mode="gather")


@pytest.mark.parametrize("shape", [(4, 8), (2, 3, 16)],
                         ids=["8x4x8", "8x2x3x16"])
def test_batched_matches_jax_ntt_context(shape):
    """(8, ..., n) operands: ntt, intt, coset_ntt and coset_intt along the
    last axis equal the JAX ``NttContext`` on the same values in its
    (16, ..., n) layout (batched operands take its unrolled transform),
    built and run in one ``jax.jit``, its root-power tables from host
    integers (its own build compiles each doubling step apart); the staged
    and scan modes agree."""
    import jax
    import jax.numpy as jnp

    from kzg_snark_tpu.ops import ntt as jntt
    from kzg_snark_tpu.ops.fr import fr_backend as jax_fr_backend

    n = shape[-1]
    tctx = ntt_context("bn254", n, "cpu")
    r = Fr.modulus

    class HostTables(jntt.NttContext):
        def _build_powers(self, w, count):
            return self.backend.from_ints([pow(w, i, r)
                                           for i in range(count)])

    jb = jax_fr_backend("bn254")    # made outside the trace: it is cached

    def run(v):
        jctx = object.__new__(HostTables)
        jctx._init(jb, n, tctx.root)
        return (jctx.ntt(v), jctx.intt(v), jctx.coset_ntt(v, SHIFT),
                jctx.coset_intt(v, SHIFT))

    xs = values(int(np.prod(shape)), 300 + n)
    ta = tctx.backend.from_ints(xs).reshape((8,) + shape)
    want = jax.jit(run)(jnp.asarray(tensor_to_limbs16(ta)))
    got = (tctx.ntt(ta), tctx.intt(ta), tctx.coset_ntt(ta, SHIFT),
           tctx.coset_intt(ta, SHIFT))
    for w, g in zip(want, got):
        assert w.shape == (16,) + shape and g.shape == (8,) + shape
        assert np.array_equal(np.asarray(w), tensor_to_limbs16(g))
    assert torch.equal(tctx.ntt(ta, mode="scan"), got[0])
    assert torch.equal(tctx.intt(ta, mode="scan"), got[1])


@pytest.mark.parametrize("shape", [(1 << 11,), (3, 1 << 11), (2, 2, 1 << 4)],
                         ids=["8xn", "8x3xn", "8x2x2x16"])
def test_batched_staged_launches(monkeypatch, shape):
    """On a device other than the CPU, an (8, n) operand makes the plan's
    ceil(log2 n / t) ntt_pass launches, as before, and a batch makes them
    row after row on (8, n) rows.  ntt_pass is replaced by a fake that
    records each call on the meta device (no data); t = 10."""
    from kzg_snark_tpu_torch.ops import ntt_stage
    from kzg_snark_tpu_torch.ops.fr import fr_backend

    calls = []

    def fake_pass(fc, x, tw, s0, g, t, out=None):
        calls.append((tuple(x.shape), s0, g))
        return torch.empty_like(x) if out is None else out

    monkeypatch.setattr(ntt_stage, "tile_bits", lambda n: 10)
    monkeypatch.setattr(ntt_stage, "ntt_pass", fake_pass)
    n = shape[-1]
    x = torch.empty((8,) + shape, dtype=torch.int32, device="meta")
    tw = torch.empty((8, n // 2), dtype=torch.int32, device="meta")
    out = ntt_stage.staged_transform(fr_backend("bn254", "cpu").consts, x,
                                     tw)
    assert out.shape == x.shape
    plan = ntt_stage.pass_plan(n, 10)
    rows = int(np.prod(shape[:-1]))
    assert calls == [((8, n), s0, g) for s0, g in plan] * rows
