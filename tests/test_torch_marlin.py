"""The port's Marlin device prover and ``PolyDev`` against the JAX package.

On the synthetic R1CS of ``tests/test_marlin_device_scale.py`` at
|H| = 16 (nnz(A) = m = 32, 5 public inputs, max_degree = 6m), the port's
``DeviceProver`` (plain PyTorch versions of every kernel on the CPU) must
index and prove byte-identically to the JAX package's host ``Indexer`` and
``Prover`` with ``normalize_commitments=True`` under the same Rng seeds and
tau (values compared as ints: the packages' field classes are distinct).
The port's host ``Verifier`` accepts the proof and rejects a tampered copy.

``PolyDev`` mul, divide_by_vanishing, open_div, eval_at and segment_sum_mod
(repeated segment ids and the dump bin) must equal the JAX ``PolyDev`` run
eagerly on the CPU, on numpy-seeded inputs; exact equality of canonical
ints throughout.
"""

import numpy as np
import pytest
import torch

from kzg_snark_tpu.models.marlin.indexer import Indexer as JaxIndexer
from kzg_snark_tpu.models.marlin.prover import Prover as JaxProver
from kzg_snark_tpu.ops.host.field import scalar_field as jax_scalar_field
from kzg_snark_tpu.ops.polydev import PolyDev as JaxPolyDev
from kzg_snark_tpu.rng import Rng as JaxRng
from kzg_snark_tpu.utils.fixtures import SparseMatrix as JaxSparseMatrix
from kzg_snark_tpu_torch.models.marlin.device import DeviceProver
from kzg_snark_tpu_torch.models.marlin.verifier import Verifier
from kzg_snark_tpu_torch.ops.polydev import PolyDev
from kzg_snark_tpu_torch.rng import Rng
from kzg_snark_tpu_torch.utils.convert import to_plain
from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)

H_SIZE = 16
PUBLIC = 5
TAU = 0xFEED5EED
R = jax_scalar_field("bn254").modulus


@pytest.fixture(scope="module")
def circuit():
    A, B, C, z = synthetic_r1cs(H_SIZE)
    return A, B, C, z, 6 * len(A.nonzero_positions())


@pytest.fixture(scope="module")
def port_run(circuit):
    A, B, C, z, max_degree = circuit
    keys = DeviceProver("bn254", rng=Rng(900), device="cpu").preprocess(
        A, B, C, max_degree, tau=TAU)
    proof = DeviceProver("bn254", rng=Rng(901), device="cpu").prove(
        keys[0], z[:PUBLIC], z[PUBLIC:])
    return keys, proof


@pytest.fixture(scope="module")
def jax_run(circuit):
    A, B, C, z, max_degree = circuit
    Fr = jax_scalar_field("bn254")

    def jax_matrix(M):
        return JaxSparseMatrix(Fr, M.nrows(), M.ncols(),
                               {k: int(v) for k, v in M.entries.items()})

    indexer = JaxIndexer("bn254", backend="host", rng=JaxRng(900))
    indexer.kzg.normalize_commitments = True
    keys = indexer.preprocess(jax_matrix(A), jax_matrix(B), jax_matrix(C),
                              max_degree, tau=TAU)
    prover = JaxProver("bn254", backend="host", rng=JaxRng(901))
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
    assert Verifier("bn254", rng=Rng(902)).verify(ivk, x, proof)
    tampered = dict(proof)
    tampered["evaluations"] = dict(proof["evaluations"])
    beta1 = list(proof["evaluations"]["beta1"])
    beta1[0] = beta1[0] + 1
    tampered["evaluations"]["beta1"] = beta1
    assert not Verifier("bn254", rng=Rng(903)).verify(ivk, x, tampered)


# ---------------------------------------------------------------------------
# PolyDev against the JAX PolyDev.
# ---------------------------------------------------------------------------


def ints(n, seed):
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    out[0] = R - 1
    return out


@pytest.fixture(scope="module")
def polydevs():
    return JaxPolyDev("bn254"), PolyDev("bn254", "cpu")


def both(polydevs, values):
    jpd, tpd = polydevs
    return jpd.be.from_ints(values), tpd.be.from_ints(values)


def same(polydevs, j_arr, t_arr):
    jpd, tpd = polydevs
    return jpd.be.to_ints(j_arr) == tpd.be.to_ints(t_arr)


def test_polydev_mul(polydevs):
    ja, ta = both(polydevs, ints(5, 1))
    jb, tb = both(polydevs, ints(4, 2))
    assert same(polydevs, polydevs[0].mul(ja, jb), polydevs[1].mul(ta, tb))


@pytest.mark.parametrize("m", [10, 16, 37])
def test_polydev_divide_by_vanishing(polydevs, m):
    jp, tp = both(polydevs, ints(m, 3 + m))
    jh, jr = polydevs[0].divide_by_vanishing(jp, 8)
    th, tr = polydevs[1].divide_by_vanishing(tp, 8)
    assert th.shape[1] == jh.shape[1]
    assert same(polydevs, jr, tr)
    if jh.shape[1]:
        assert same(polydevs, jh, th)


def test_polydev_eval_and_open(polydevs):
    jp, tp = both(polydevs, ints(19, 4))
    z = ints(1, 5)[0]
    assert polydevs[0].eval_int(jp, z) == polydevs[1].eval_int(tp, z)
    assert same(polydevs, polydevs[0].eval_at(jp, z),
                polydevs[1].eval_at(tp, z))
    assert same(polydevs, polydevs[0].open_div(jp, z),
                polydevs[1].open_div(tp, z))


def test_polydev_segment_sum_mod(polydevs):
    import jax.numpy as jnp
    m, segments = 64, 9                      # segment 8 is the dump bin
    values = ints(m, 6)
    values[1:6] = [R - 1] * 5                # large sums into one segment
    ids = np.random.default_rng(7).integers(0, segments, m)
    ids[1:6] = 3
    jv, tv = both(polydevs, values)
    want = polydevs[0].segment_sum_mod(jv, jnp.asarray(ids, jnp.int32),
                                       segments)
    got = polydevs[1].segment_sum_mod(tv, torch.from_numpy(ids), segments)
    assert same(polydevs, want, got)
    # and the field sums themselves
    sums = [sum(values[i] for i in range(m) if ids[i] == s) % R
            for s in range(segments)]
    assert polydevs[1].be.to_ints(got) == sums
