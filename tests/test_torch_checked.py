"""Checked mode of the port (``KZG_TPU_CHECKED``) against the JAX package's.

* ``validate_canonical`` gives the JAX ``validate_canonical``'s verdict on
  the same values (seeded canonical values, p, p + 1 and the largest value
  the words hold, at BN254 Fr and BLS12-381 Fq): both accept, or both
  reject at the same column.  A tensor of another dtype or leading axis is
  refused by name (the counterpart of the JAX "limb overflow").
* A clean op mix and a curve chain (double, add, mixed add, ``on_curve``)
  pass over the checked backends and give the unchecked values.
* A Montgomery product that skips its final subtraction traps at the op
  that produced it: at "mul" where the backend's ops call the plain
  ``fr_mul``, and, where the NTT passes call it (their outputs no backend
  op sees), at a PLONK round ("plonk.") of a checked prove at n = 8.  A
  curve add whose output holds p traps at "g1.add".
* An unpatched checked prove is byte-identical to the unchecked one.
* The flag is read at call time: the factories and the contexts cached on
  a backend turn checked once it is set.
"""

import re

import numpy as np
import pytest
import torch

from kzg_snark_tpu.ops.fr import FieldBackend as JaxFieldBackend
from kzg_snark_tpu.ops.fr import ints_to_limb_array
from kzg_snark_tpu.ops.fr import validate_canonical as jax_validate
from kzg_snark_tpu_torch import constants as C
from kzg_snark_tpu_torch.models.plonk.device import (DeviceProver,
                                                     PlonkDeviceCore)
from kzg_snark_tpu_torch.ops import cuda_fr
from kzg_snark_tpu_torch.ops.fr import (CheckedFieldBackend, FieldBackend,
                                        fq_backend, fr_backend,
                                        validate_canonical,
                                        validate_tree_canonical)
from kzg_snark_tpu_torch.ops.g1 import CurveOps
from kzg_snark_tpu_torch.ops.host.field import scalar_field
from kzg_snark_tpu_torch.ops.limbs import (ints_to_words, to_tensor,
                                           to_words, words_to_ints)
from kzg_snark_tpu_torch.ops.msm import msm_context
from kzg_snark_tpu_torch.ops.ntt import ntt_context
from kzg_snark_tpu_torch.ops.polydev import PolyDev
from kzg_snark_tpu_torch.rng import Rng
from kzg_snark_tpu_torch.utils.convert import to_plain

torch.set_num_threads(1)

MODULI = {"bn254_fr": C.BN254_R, "bls12_381_fq": C.BLS12_381_P}
PLONK_N = 8
TAU = 0xABCDEF12345


@pytest.fixture
def flag(monkeypatch):
    monkeypatch.delenv("KZG_TPU_CHECKED", raising=False)
    return monkeypatch


def _column(message: str) -> int:
    return int(re.search(r"at column (\d+)", message).group(1))


def _verdict(fn):
    """None if ``fn`` accepts, else the column it rejects."""
    try:
        fn()
    except AssertionError as e:
        return _column(str(e))
    return None


def _cases(p: int, L: int) -> list:
    rng = np.random.default_rng(17)
    seeded = [int.from_bytes(rng.bytes(4 * L), "little") % p
              for _ in range(6)]
    top = (1 << (32 * L)) - 1
    return [seeded, seeded[:3] + [p] + seeded[3:], [p + 1] + seeded,
            seeded[:5] + [top], [0, p - 1, 1, p - 2], [top, p, p + 1]]


@pytest.mark.parametrize("field", sorted(MODULI))
def test_validate_canonical_matches_jax(field):
    p = MODULI[field]
    port_be = FieldBackend(p, "cpu")
    jax_be = JaxFieldBackend(p)
    L = port_be.num_limbs
    assert jax_be.num_limbs == 2 * L
    for values in _cases(p, L):
        port_x = to_tensor(ints_to_words(values, L), "cpu")
        jax_x = ints_to_limb_array(values, 2 * L)
        got = _verdict(lambda: validate_canonical(port_be, port_x, "t"))
        want = _verdict(lambda: jax_validate(jax_be, jax_x, "t"))
        assert got == want
        # (L, rows, cols) batches flatten as the JAX check does.
        if len(values) % 2 == 0:
            got = _verdict(lambda: validate_canonical(
                port_be, port_x.reshape(L, 2, -1), "t"))
            assert got == want


def test_validate_canonical_refuses_other_layouts():
    be = fr_backend("bn254", "cpu")
    x = be.from_ints([1, 2, 3])
    assert validate_canonical(be, x, "ok") is x
    with pytest.raises(AssertionError, match="bad: expected an int32"):
        validate_canonical(be, x.to(torch.int64), "bad")
    with pytest.raises(AssertionError, match="bad: leading axis 16 != L=8"):
        validate_canonical(be, torch.zeros((16, 3), dtype=torch.int32),
                           "bad")
    with pytest.raises(AssertionError, match="tree: non-canonical output "
                                             f"{be.modulus} >= p at column 0"):
        p_col = to_tensor(ints_to_words([be.modulus]), "cpu")
        validate_tree_canonical(be, {"a": [x, (x, p_col)]}, "tree")
    with pytest.raises(AssertionError, match="tree: expected an int32"):
        validate_tree_canonical(be, [x, 5], "tree")


def _checked(modulus):
    return CheckedFieldBackend(modulus, "cpu")


def test_clean_op_mix_passes_with_unchecked_values():
    rng = np.random.default_rng(3)
    for p in (C.BN254_R, C.BLS12_381_P):
        plain, checked = FieldBackend(p, "cpu"), _checked(p)
        ints = [int.from_bytes(rng.bytes(48), "little") % p
                for _ in range(16)]
        ints[3] = 0
        results = []
        for be in (plain, checked):
            a = be.from_ints(ints)
            b = be.from_ints(ints[::-1])
            results.append([
                be.add(a, b), be.sub(a, b), be.mul(a, b), be.square(a),
                be.neg(a), be.double(a), be.pow_const(a, 5), be.inv(a),
                be.batch_inv(a), be.exclusive_prefix_prod(a),
                be.sum_reduce(a), be.suffix_sums_exclusive(a),
                be.powers_of(7, 9), be.from_mont(a), be.equal(a, b),
                be.equal(a, a)])
        for want, got in zip(*results):
            assert torch.equal(got, want)
        assert checked.to_ints(checked.from_ints(ints)) == ints


def test_checked_curve_chain():
    curve = CurveOps(_checked(C.BN254_P))
    assert curve.checked
    gx, gy = C.BN254_G1
    g = curve.from_affine_ints([gx] * 4, [gy] * 4)
    p2 = curve.double(g)
    p3 = curve.add(p2, g)
    p4 = curve.add_mixed(p3, g[0][:, :1], g[1][:, :1])
    p4_ladder = curve.scale_const(g, 4)
    assert bool(curve.on_curve(p3, 3).all())
    assert bool(curve.on_curve(p4, 3).all())
    assert curve.to_affine_ints(p4) == curve.to_affine_ints(p4_ladder)
    ident = curve.identity((2,))
    assert curve.is_identity(ident).tolist() == [True, True]
    assert not bool(curve.is_identity(p4).any())
    assert bool(curve.on_curve(ident, 3).all())
    off = p3.clone()
    off[1] = curve.f.add(off[1], curve.f.one_mont)      # Y + 1
    assert not bool(curve.on_curve(off, 3).any())


def _lazy_mul(fc, a, b):
    """A Montgomery product that skips its final subtraction: (a b + m p) /
    R, in [0, 2p) for canonical operands (words wrap as a kernel's do)."""
    a, b = torch.broadcast_tensors(a, b)
    L, R, p = fc.num_limbs, fc.R, fc.modulus
    n_prime = (-pow(p, -1, R)) % R
    out = []
    for u, w in zip(words_to_ints(to_words(a.reshape(L, -1))),
                    words_to_ints(to_words(b.reshape(L, -1)))):
        t = u * w
        out.append(((t + (t * n_prime % R) * p) // R) % R)
    return to_tensor(ints_to_words(out, L), a.device).reshape(a.shape)


def test_missed_final_subtraction_traps_at_the_op(monkeypatch):
    p = C.BN254_R
    plain, checked = FieldBackend(p, "cpu"), _checked(p)
    rng = np.random.default_rng(9)
    ints = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(512)]
    a, b = plain.from_ints(ints), plain.from_ints(ints[::-1])
    monkeypatch.setitem(cuda_fr._EWISE_PLAIN, "fr_mul", _lazy_mul)
    silent = plain.mul(a, b)                    # the unchecked backend
    bad = _verdict(lambda: validate_canonical(plain, silent, "mul"))
    assert bad is not None
    with pytest.raises(AssertionError,
                       match=f"^mul: non-canonical output .* >= p at column "
                             f"{bad}$"):
        checked.mul(a, b)


def test_curve_output_holding_p_traps(monkeypatch):
    curve = CurveOps(_checked(C.BN254_P))
    gx, gy = C.BN254_G1
    g = curve.from_affine_ints([gx] * 3, [gy] * 3)
    add = cuda_fr.g1_add

    def planted(fc, p, q):
        out = add(fc, p, q).clone()
        out[1, :, 2] = to_tensor(ints_to_words([fc.modulus], 8), "cpu")[:, 0]
        return out
    monkeypatch.setattr(cuda_fr, "g1_add", planted)
    with pytest.raises(AssertionError, match="^g1.add: non-canonical output "
                                             ".* at column 5$"):
        curve.add(g, g)


def _plonk_circuit():
    Fr = scalar_field("bn254")
    n = PLONK_N
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(n)]
    b = [Fr(i + 3) for i in range(n)]
    return ([one] * n, [zero] * n, [zero] * n, [-one] * n, [zero] * n,
            list(range(3 * n))), a + b + [x * y for x, y in zip(a, b)]


@pytest.fixture(scope="module")
def plonk_keys():
    selectors, w = _plonk_circuit()
    ipk, ivk = DeviceProver("bn254", rng=Rng(77), device="cpu").preprocess(
        *selectors, max_degree=PLONK_N + 5, tau=TAU)
    return ipk, w


def _fresh(ipk):
    """The keys without the device tensors a prove caches in them."""
    return {k: v for k, v in ipk.items() if k != "_device_cache"}


def test_checked_plonk_prove_is_byte_identical(plonk_keys, flag):
    ipk, w = plonk_keys
    want = DeviceProver("bn254", rng=Rng(78), device="cpu").prove(
        _fresh(ipk), [], w)
    flag.setenv("KZG_TPU_CHECKED", "1")
    prover = DeviceProver("bn254", rng=Rng(78), device="cpu")
    got = prover.prove(_fresh(ipk), [], w)
    assert isinstance(PlonkDeviceCore("bn254", PLONK_N, "cpu").be,
                      CheckedFieldBackend)
    assert to_plain(got) == to_plain(want)


def test_checked_plonk_prove_traps_a_bad_ntt_product(plonk_keys, flag,
                                                      monkeypatch):
    ipk, w = plonk_keys
    flag.setenv("KZG_TPU_CHECKED", "1")
    monkeypatch.setattr(cuda_fr, "mul_plain", _lazy_mul)
    with pytest.raises(AssertionError,
                       match=r"^plonk\.\w+: non-canonical output"):
        DeviceProver("bn254", rng=Rng(78), device="cpu").prove(
            _fresh(ipk), [], w)


def test_flag_is_read_at_call_time(flag):
    before = fr_backend("bn254", "cpu")
    assert type(before) is FieldBackend
    assert not msm_context("bn254", "cpu").curve.checked
    flag.setenv("KZG_TPU_CHECKED", "true")
    for be in (fr_backend("bn254", "cpu"), fq_backend("bls12_381", "cpu"),
               ntt_context("bn254", 8, "cpu").backend,
               PolyDev("bn254", "cpu").be,
               msm_context("bn254", "cpu").curve.f,
               msm_context("bn254", "cpu").scalar_backend):
        assert isinstance(be, CheckedFieldBackend)
    assert msm_context("bn254", "cpu").curve.checked
    assert fr_backend("bn254", "cpu").modulus == before.modulus
    flag.setenv("KZG_TPU_CHECKED", "0")
    assert fr_backend("bn254", "cpu") is before
