"""The port's serialization against the JAX package's, file for file.

On the synthetic circuits (PLONK's mul-gate circuit at n = 8, Marlin's
synthetic R1CS at |H| = 8; the JAX tests of the same module load the
reference's absent pickles), the two packages index with the same Rng
seeds and tau, and:

* their files agree in meaning: the same ``.npz`` arrays under the same
  keys and the same JSON header (SRS and index keys, host lists and a
  ``DeviceSRS``), the same proof JSON;
* a file written by either package loads in the other to the same
  values (compared through ``utils/convert.to_plain``);
* a JAX-written index file loaded by the port as device keys (a
  ``DeviceSRS`` on the CPU) proves with the port's device provers
  byte-identically to the JAX host prover on the original keys;
* the 32-byte rows refuse BLS12-381's 381-bit coordinates by the curve's
  name, for an SRS and for index keys.
"""

import json

import numpy as np
import pytest
import torch

from kzg_snark_tpu.models.marlin.indexer import Indexer as JaxMarlinIndexer
from kzg_snark_tpu.models.marlin.prover import Prover as JaxMarlinProver
from kzg_snark_tpu.models.plonk.indexer import Indexer as JaxPlonkIndexer
from kzg_snark_tpu.models.plonk.prover import Prover as JaxPlonkProver
from kzg_snark_tpu.ops.host import curve as jax_pc
from kzg_snark_tpu.ops.host.field import scalar_field as jax_scalar_field
from kzg_snark_tpu.rng import Rng as JaxRng
from kzg_snark_tpu.utils import serialization as jax_ser
from kzg_snark_tpu.utils.fixtures import SparseMatrix as JaxSparseMatrix
from kzg_snark_tpu_torch.models.kzg import KZG
from kzg_snark_tpu_torch.models.marlin.device import \
    DeviceProver as MarlinDevice
from kzg_snark_tpu_torch.models.marlin.indexer import Indexer as MarlinIndexer
from kzg_snark_tpu_torch.models.plonk.device import DeviceProver as PlonkDevice
from kzg_snark_tpu_torch.models.plonk.indexer import Indexer as PlonkIndexer
from kzg_snark_tpu_torch.ops.host import curve as pc
from kzg_snark_tpu_torch.ops.host.field import scalar_field
from kzg_snark_tpu_torch.ops.srs import DeviceSRS
from kzg_snark_tpu_torch.rng import Rng
from kzg_snark_tpu_torch.utils import serialization as ser
from kzg_snark_tpu_torch.utils.convert import to_plain
from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

torch.set_num_threads(1)

PLONK_N = 8
MARLIN_H = 8
PUBLIC = 5
TAU = 0xABCDEF12345


def _plonk_circuit(Fr):
    n = PLONK_N
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(n)]
    b = [Fr(i + 3) for i in range(n)]
    return ([one] * n, [zero] * n, [zero] * n, [-one] * n, [zero] * n,
            list(range(3 * n))), a + b + [x * y for x, y in zip(a, b)]


def _marlin_circuit(pkg_fr, matrix):
    A, B, C, z = synthetic_r1cs(MARLIN_H)
    mats = [matrix(pkg_fr, M) for M in (A, B, C)]
    return mats, [pkg_fr(int(v)) for v in z], 6 * len(A.nonzero_positions())


def _port_matrix(Fr, M):
    return M


def _jax_matrix(Fr, M):
    return JaxSparseMatrix(Fr, M.nrows(), M.ncols(),
                           {k: int(v) for k, v in M.entries.items()})


@pytest.fixture(scope="module")
def plonk():
    """Both packages' host index keys and proofs, normalized commitments."""
    out = {}
    for pkg, Indexer, Prover, Rng_, Fr in (
            ("jax", JaxPlonkIndexer, JaxPlonkProver, JaxRng,
             jax_scalar_field("bn254")),
            ("port", PlonkIndexer, None, Rng, scalar_field("bn254"))):
        selectors, w = _plonk_circuit(Fr)
        indexer = Indexer("bn254", backend="host", rng=Rng_(600))
        indexer.kzg.normalize_commitments = True
        keys = indexer.preprocess(*selectors, max_degree=PLONK_N + 5,
                                  tau=TAU)
        out[pkg] = {"keys": keys, "w": w, "kzg": indexer.kzg}
    prover = JaxPlonkProver("bn254", backend="host", rng=JaxRng(601))
    prover.kzg.normalize_commitments = True
    out["jax"]["proof"] = prover.prove(out["jax"]["keys"][0], [],
                                       out["jax"]["w"])
    return out


@pytest.fixture(scope="module")
def marlin():
    out = {}
    for pkg, Indexer, Rng_, Fr, matrix in (
            ("jax", JaxMarlinIndexer, JaxRng, jax_scalar_field("bn254"),
             _jax_matrix),
            ("port", MarlinIndexer, Rng, scalar_field("bn254"),
             _port_matrix)):
        mats, z, max_degree = _marlin_circuit(Fr, matrix)
        indexer = Indexer("bn254", backend="host", rng=Rng_(900))
        indexer.kzg.normalize_commitments = True
        out[pkg] = {"keys": indexer.preprocess(*mats, max_degree, tau=TAU),
                    "z": z, "kzg": indexer.kzg}
    prover = JaxMarlinProver("bn254", backend="host", rng=JaxRng(901))
    prover.kzg.normalize_commitments = True
    z = out["jax"]["z"]
    out["jax"]["proof"] = prover.prove(out["jax"]["keys"][0], z[:PUBLIC],
                                       z[PUBLIC:])
    return out


def _npz(path) -> dict:
    """An .npz's arrays, its header parsed."""
    data = np.load(path)
    out = {k: data[k] for k in data.files}
    out["header"] = json.loads(bytes(out["header"]).decode())
    return out


def _same_npz(a, b) -> None:
    a, b = _npz(a), _npz(b)
    assert sorted(a) == sorted(b)
    assert a.pop("header") == b.pop("header")
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def _device_kzg():
    return KZG("bn254", backend="cuda", device="cpu")


def test_srs_files_agree_and_cross_load(plonk, tmp_path):
    jax_kzg, port_kzg = plonk["jax"]["kzg"], plonk["port"]["kzg"]
    ck_j, rk_j = plonk["jax"]["keys"][0]["ck"], plonk["jax"]["keys"][1]["rk"]
    ck_p, rk_p = plonk["port"]["keys"][0]["ck"], plonk["port"]["keys"][1]["rk"]
    f_jax, f_port, f_dev = (str(tmp_path / f"{k}.npz")
                            for k in ("jax", "port", "dev"))
    jax_ser.save_srs(f_jax, jax_kzg, ck_j, rk_j)
    ser.save_srs(f_port, port_kzg, ck_p, rk_p)
    _same_npz(f_jax, f_port)

    host_ck, host_rk = ser.load_srs(f_jax, port_kzg)
    assert isinstance(host_ck, list)
    dev_ck, dev_rk = ser.load_srs(f_jax, _device_kzg())
    assert isinstance(dev_ck, DeviceSRS) and dev_ck.device.type == "cpu"
    want = [tuple(map(int, pc.normalize(pt))) for pt in ck_p]
    assert [(int(x), int(y)) for x, y, _ in host_ck] == want
    assert dev_ck.affine(0) == want[0] and dev_ck.affine(5) == want[5]
    assert to_plain(pc.normalize(host_rk)) == \
        to_plain(pc.normalize(dev_rk)) == to_plain(jax_pc.normalize(rk_j))
    ser.save_srs(f_dev, port_kzg, dev_ck, dev_rk)           # a DeviceSRS
    _same_npz(f_jax, f_dev)
    back_ck, back_rk = jax_ser.load_srs(f_dev, jax_kzg, device=False)
    assert to_plain([jax_pc.normalize(pt) for pt in back_ck]) == \
        to_plain([jax_pc.normalize(pt) for pt in ck_j])
    assert to_plain(jax_pc.normalize(back_rk)) == \
        to_plain(jax_pc.normalize(rk_j))
    with pytest.raises(ValueError, match="bls12_381"):
        ser.load_srs(f_jax, KZG("bls12_381", backend="host"))


def test_proof_files_agree_and_cross_load(plonk, tmp_path):
    proof_j = plonk["jax"]["proof"]
    f_jax, f_port = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_ser.save_proof(f_jax, proof_j)
    loaded = ser.load_proof(f_jax, plonk["port"]["kzg"])
    assert to_plain(loaded) == to_plain(proof_j)
    ser.save_proof(f_port, loaded)
    with open(f_jax) as a, open(f_port) as b:
        assert json.load(a) == json.load(b)
    back = jax_ser.load_proof(f_port, plonk["jax"]["kzg"])
    assert back == proof_j


def test_plonk_index_keys_cross_load_and_prove(plonk, tmp_path):
    f_jax, f_port, f_dev = (str(tmp_path / f"{k}.npz")
                            for k in ("jax", "port", "dev"))
    jax_ser.save_index_keys(f_jax, plonk["jax"]["kzg"], *plonk["jax"]["keys"])
    ser.save_index_keys(f_port, plonk["port"]["kzg"], *plonk["port"]["keys"])
    _same_npz(f_jax, f_port)

    # JAX-written keys as the port's device keys prove like the JAX host.
    ipk, ivk = ser.load_index_keys(f_jax, _device_kzg())
    assert isinstance(ipk["ck"], DeviceSRS)
    proof = PlonkDevice("bn254", rng=Rng(601), device="cpu").prove(
        ipk, [], plonk["port"]["w"])
    assert to_plain(proof) == to_plain(plonk["jax"]["proof"])
    assert to_plain(ivk["commitments"]) == \
        to_plain(plonk["jax"]["keys"][1]["commitments"])
    # The device keys, cache and all, save to the same file.
    assert "_device_cache" in ipk
    ser.save_index_keys(f_dev, plonk["port"]["kzg"], ipk, ivk)
    _same_npz(f_jax, f_dev)
    # Port-written keys load in the JAX package and prove there.
    ipk_j, _ = jax_ser.load_index_keys(f_port, plonk["jax"]["kzg"],
                                       device=False)
    prover = JaxPlonkProver("bn254", backend="host", rng=JaxRng(601))
    prover.kzg.normalize_commitments = True
    proof_j = prover.prove(ipk_j, [], plonk["jax"]["w"])
    assert to_plain(proof_j) == to_plain(plonk["jax"]["proof"])


def test_marlin_index_keys_cross_load_and_prove(marlin, tmp_path):
    f_jax, f_port = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ser.save_index_keys(f_jax, marlin["jax"]["kzg"],
                            *marlin["jax"]["keys"])
    ser.save_index_keys(f_port, marlin["port"]["kzg"],
                        *marlin["port"]["keys"])
    _same_npz(f_jax, f_port)

    ipk, ivk = ser.load_index_keys(f_jax, _device_kzg())
    assert isinstance(ipk["ck"], DeviceSRS)
    z = marlin["port"]["z"]
    proof = MarlinDevice("bn254", rng=Rng(901), device="cpu").prove(
        ipk, z[:PUBLIC], z[PUBLIC:])
    assert to_plain(proof) == to_plain(marlin["jax"]["proof"])
    host_ipk, _ = ser.load_index_keys(f_jax, marlin["port"]["kzg"])
    assert to_plain(host_ipk["A"].entries) == \
        to_plain(marlin["port"]["keys"][0]["A"].entries)
    ipk_j, ivk_j = jax_ser.load_index_keys(f_port, marlin["jax"]["kzg"],
                                           device=False)
    assert to_plain(ivk_j["commitments"]) == \
        to_plain(marlin["jax"]["keys"][1]["commitments"])
    assert to_plain(ipk_j["polynomials"]["row_A"].list()) == \
        to_plain(marlin["jax"]["keys"][0]["polynomials"]["row_A"].list())


@pytest.mark.parametrize("what", ["srs", "index_keys"])
def test_bls12_381_rows_refused_by_name(tmp_path, what):
    kzg = KZG("bls12_381", backend="host", rng=Rng(5))
    ck, rk = kzg.setup(max_degree=2)
    path = str(tmp_path / "bls.npz")
    with pytest.raises(ValueError, match="^bls12_381: 381-bit coordinates"):
        if what == "srs":
            ser.save_srs(path, kzg, ck, rk)
        else:
            ser.save_index_keys(path, kzg, {"ck": ck}, {"rk": rk})
    assert not (tmp_path / "bls.npz").exists()
