"""The port's Marlin device prover on BLS12-381 against the JAX package.

On the synthetic R1CS over BLS12-381's scalar field at the smallest |H|
the five public inputs allow (|H| = 8, nnz(A) = m = 16, max_degree =
6m), ``DeviceProver("bls12_381", device="cpu")`` (plain PyTorch versions
of every kernel: Fr in 8 words of 255 bits, Fq in 12) must index and
prove byte-identically to the JAX package's host ``Indexer`` and
``Prover`` with ``normalize_commitments=True`` under the same Rng seeds
and tau (values compared as ints).  The port's host ``Verifier`` accepts
the proof and rejects a tampered copy.  ``PolyDev.segment_sum_mod`` at
BLS12-381 equals the field sums (its split constant is below r).
"""

import numpy as np
import pytest
import torch

from kzg_snark_tpu.models.marlin.indexer import Indexer as JaxIndexer
from kzg_snark_tpu.models.marlin.prover import Prover as JaxProver
from kzg_snark_tpu.ops.host.field import scalar_field as jax_scalar_field
from kzg_snark_tpu.rng import Rng as JaxRng
from kzg_snark_tpu.utils.fixtures import SparseMatrix as JaxSparseMatrix
from kzg_snark_tpu_torch.models.marlin.device import DeviceProver
from kzg_snark_tpu_torch.models.marlin.verifier import Verifier
from kzg_snark_tpu_torch.ops.polydev import PolyDev
from kzg_snark_tpu_torch.rng import Rng
from kzg_snark_tpu_torch.utils.convert import to_plain
from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

torch.set_num_threads(1)

CURVE = "bls12_381"
H_SIZE = 8
PUBLIC = 5
TAU = 0xFEED5EED


@pytest.fixture(scope="module")
def circuit():
    A, B, C, z = synthetic_r1cs(H_SIZE, curve_type=CURVE)
    return A, B, C, z, 6 * len(A.nonzero_positions())


@pytest.fixture(scope="module")
def port_run(circuit):
    A, B, C, z, max_degree = circuit
    keys = DeviceProver(CURVE, rng=Rng(900), device="cpu").preprocess(
        A, B, C, max_degree, tau=TAU)
    proof = DeviceProver(CURVE, rng=Rng(901), device="cpu").prove(
        keys[0], z[:PUBLIC], z[PUBLIC:])
    return keys, proof


@pytest.fixture(scope="module")
def jax_run(circuit):
    A, B, C, z, max_degree = circuit
    Fr = jax_scalar_field(CURVE)

    def jax_matrix(M):
        return JaxSparseMatrix(Fr, M.nrows(), M.ncols(),
                               {k: int(v) for k, v in M.entries.items()})

    indexer = JaxIndexer(CURVE, backend="host", rng=JaxRng(900))
    indexer.kzg.normalize_commitments = True
    keys = indexer.preprocess(jax_matrix(A), jax_matrix(B), jax_matrix(C),
                              max_degree, tau=TAU)
    prover = JaxProver(CURVE, backend="host", rng=JaxRng(901))
    prover.kzg.normalize_commitments = True
    zj = [Fr(int(v)) for v in z]
    return keys, prover.prove(keys[0], zj[:PUBLIC], zj[PUBLIC:])


def test_index_matches_jax_host(port_run, jax_run):
    (_, ivk_p), _ = port_run
    (_, ivk_j), _ = jax_run
    assert to_plain(ivk_p["commitments"]) == to_plain(ivk_j["commitments"])


def test_proof_matches_jax_host_bytes(port_run, jax_run):
    _, proof_p = port_run
    _, proof_j = jax_run
    for part in ("commitments", "evaluations", "kzg_proofs"):
        assert to_plain(proof_p[part]) == to_plain(proof_j[part]), part


def test_proof_verifies_and_tamper_rejected(port_run, circuit):
    (_, ivk), proof = port_run
    x = circuit[3][:PUBLIC]
    assert Verifier(CURVE, rng=Rng(902)).verify(ivk, x, proof)
    tampered = dict(proof)
    tampered["evaluations"] = dict(proof["evaluations"])
    beta1 = list(proof["evaluations"]["beta1"])
    beta1[0] = beta1[0] + 1
    tampered["evaluations"]["beta1"] = beta1
    assert not Verifier(CURVE, rng=Rng(903)).verify(ivk, x, tampered)


def test_segment_sum_mod_at_bls12_381():
    pd = PolyDev(CURVE, "cpu")
    r = pd.be.modulus
    m, segments = 64, 9
    rng = np.random.default_rng(6)
    values = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(m)]
    values[1:6] = [r - 1] * 5                # large sums into one segment
    ids = rng.integers(0, segments, m)
    ids[1:6] = 3
    got = pd.segment_sum_mod(pd.be.from_ints(values), torch.from_numpy(ids),
                             segments)
    assert pd.be.to_ints(got) == [
        sum(values[i] for i in range(m) if ids[i] == s) % r
        for s in range(segments)]
