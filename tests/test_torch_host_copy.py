"""The port's copy of the host layer against the JAX package's original.

The port keeps its own ``constants``, ``rng``, ``transcript``,
``ops/host/*``, ``utils/native`` (with its own copy of the pairing source),
matrix containers, host ``KZG`` and the PLONK and Marlin encoder, indexer,
prover and verifier.  Each copy must give what the original gives on the
same inputs: transcript challenges, Rng draws, the host PLONK proof at
n = 16 and the host Marlin proof at |H| = 16 (compat representatives,
compared as ints since the packages' field classes are distinct), a KZG
check through the copied native pairing, and the closed form of the Marlin
``Encoder.u_H(h, h)`` for every h in H at n = 2^6.
"""

from importlib import import_module

import numpy as np

import kzg_snark_tpu.models.marlin.encoder as jax_marlin_encoder
import kzg_snark_tpu.ops.host.field as jax_field
import kzg_snark_tpu.rng as jax_rng
import kzg_snark_tpu.transcript as jax_transcript
import kzg_snark_tpu_torch.models.marlin.encoder as port_marlin_encoder
import kzg_snark_tpu_torch.ops.host.field as port_field
import kzg_snark_tpu_torch.rng as port_rng
import kzg_snark_tpu_torch.transcript as port_transcript
from kzg_snark_tpu.models.kzg import KZG as JaxKZG
from kzg_snark_tpu_torch.models.kzg import KZG as PortKZG
from kzg_snark_tpu_torch.utils import native as port_native
from kzg_snark_tpu_torch.utils.convert import to_plain
from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

R = port_field.scalar_field("bn254").modulus


def test_transcript_challenges_match():
    values = [int(v) % R for v in
              np.random.default_rng(1).integers(0, 1 << 62, 6)]
    out = []
    for mod in (jax_transcript, port_transcript):
        field_mod = jax_field if mod is jax_transcript else port_field
        Fr = field_mod.scalar_field("bn254")
        Fp = field_mod.base_field("bn254")
        t = mod.Transcript("copy-check", Fr)
        t.append_message("ints", [3, -4, 5])
        t.append_message("elements", [Fr(v) for v in values])
        t.append_message("point", (Fp(values[0]), Fp(values[1]), Fp(1)))
        out.append([int(t.get_challenge(lbl)) for lbl in ("a", "b", "c")])
    assert out[0] == out[1]


def test_rng_draws_match():
    draws = []
    for mod, field_mod in ((jax_rng, jax_field), (port_rng, port_field)):
        Fr = field_mod.scalar_field("bn254")
        rng = mod.Rng(2026)
        child = rng.fork("child")
        draws.append([int(rng.random_element(Fr)) for _ in range(5)]
                     + [rng.random_int(1000) for _ in range(5)]
                     + [int(child.random_element(Fr)) for _ in range(3)])
    assert draws[0] == draws[1]


def _plonk(pkg):
    indexer_mod = import_module(f"{pkg}.models.plonk.indexer")
    prover_mod = import_module(f"{pkg}.models.plonk.prover")
    verifier_mod = import_module(f"{pkg}.models.plonk.verifier")
    field_mod = import_module(f"{pkg}.ops.host.field")
    rng_mod = import_module(f"{pkg}.rng")
    Fr = field_mod.scalar_field("bn254")
    n = 16
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(n)]
    b = [Fr(i + 3) for i in range(n)]
    w = a + b + [x * y for x, y in zip(a, b)]
    ipk, ivk = indexer_mod.Indexer("bn254", rng=rng_mod.Rng(600)).preprocess(
        [one] * n, [zero] * n, [zero] * n, [-one] * n, [zero] * n,
        list(range(3 * n)), max_degree=n + 5, tau=0xABCDEF12345)
    proof = prover_mod.Prover("bn254", rng=rng_mod.Rng(601)).prove(ipk, [], w)
    assert verifier_mod.Verifier("bn254", rng=rng_mod.Rng(602)).verify(
        ivk, [], proof)
    return ivk, proof


def test_host_plonk_proof_matches():
    ivk_j, proof_j = _plonk("kzg_snark_tpu")
    ivk_p, proof_p = _plonk("kzg_snark_tpu_torch")
    assert to_plain(ivk_p["commitments"]) == to_plain(ivk_j["commitments"])
    assert to_plain(proof_p) == to_plain(proof_j)


def _marlin(pkg):
    indexer_mod = import_module(f"{pkg}.models.marlin.indexer")
    prover_mod = import_module(f"{pkg}.models.marlin.prover")
    verifier_mod = import_module(f"{pkg}.models.marlin.verifier")
    field_mod = import_module(f"{pkg}.ops.host.field")
    fixtures = import_module(f"{pkg}.utils.fixtures")
    rng_mod = import_module(f"{pkg}.rng")
    A, B, C, z = synthetic_r1cs(16)
    Fr = field_mod.scalar_field("bn254")

    def matrix(M):
        return fixtures.SparseMatrix(Fr, M.nrows(), M.ncols(),
                                     {k: int(v) for k, v in M.entries.items()})

    z = [Fr(int(v)) for v in z]
    ipk, ivk = indexer_mod.Indexer("bn254", rng=rng_mod.Rng(900)).preprocess(
        matrix(A), matrix(B), matrix(C), 6 * 32, tau=0xFEED5EED)
    proof = prover_mod.Prover("bn254", rng=rng_mod.Rng(901)).prove(
        ipk, z[:5], z[5:])
    assert verifier_mod.Verifier("bn254", rng=rng_mod.Rng(902)).verify(
        ivk, z[:5], proof)
    return ivk, proof


def test_host_marlin_proof_matches():
    ivk_j, proof_j = _marlin("kzg_snark_tpu")
    ivk_p, proof_p = _marlin("kzg_snark_tpu_torch")
    assert to_plain(ivk_p["commitments"]) == to_plain(ivk_j["commitments"])
    assert to_plain(proof_p) == to_plain(proof_j)


def test_kzg_check_through_copied_native_pairing():
    assert port_native.available()
    assert port_native._LIB.endswith("torch_pairing/libbn254.so")
    coeffs = [int(v) for v in np.random.default_rng(3).integers(1, 1 << 60, 5)]
    results = []
    for cls in (JaxKZG, PortKZG):
        kzg = cls("bn254", backend="host")
        ck, rk = kzg.setup(4, tau=0x1234567)
        (comm,) = kzg.commit(ck, [coeffs])
        z, xi = 77, 5
        value = kzg.R(coeffs)(kzg.Fq(z))
        proof = kzg.open(ck, [coeffs], z, xi)
        assert kzg.check(rk, [comm], z, [value], proof, xi)
        assert not kzg.check(rk, [comm], z, [value + 1], proof, xi)
        results.append(to_plain((comm, proof, value)))
    assert results[0] == results[1]
    from kzg_snark_tpu.utils import native as jax_native
    from kzg_snark_tpu_torch import constants as C
    g2 = (tuple(C.BN254_G2_X), tuple(C.BN254_G2_Y))
    assert port_native.pairing_bytes(g2, (1, 2)) == \
        jax_native.pairing_bytes(g2, (1, 2))


def test_u_h_closed_form_matches_original():
    n = 1 << 6
    A, B, C, _ = synthetic_r1cs(n)
    enc_p = port_marlin_encoder.Encoder(port_field.scalar_field("bn254"))
    enc_p.update_state(A, B, C)
    Fj = jax_field.scalar_field("bn254")
    enc_j = jax_marlin_encoder.Encoder(Fj)
    enc_j.update_state(A, B, C)
    assert enc_j.n == enc_p.n == n
    Hj = [Fj(int(h)) for h in enc_p.H]
    want = [int(enc_j.u_H(h, h)) for h in Hj]
    got = [int(enc_p.u_H(h, h)) for h in enc_p.H]
    assert got == want
    a, b = enc_p.H[3], enc_p.H[5]
    assert int(enc_p.u_H(a, b)) == int(enc_j.u_H(Hj[3], Hj[5]))
