"""The port's PLONK device prover, as a whole, against the JAX package.

On the n = 16 synthetic mul-gate circuit, the port's ``DeviceProver``
(plain PyTorch versions of every kernel on the CPU) must index and prove
byte-identically to the JAX package's host ``Indexer`` and ``Prover`` with
``normalize_commitments=True`` under the same Rng seeds and tau, the gate
the JAX ``DeviceProver`` passes (values compared as ints: the packages'
field classes are distinct).  The port's host ``Verifier`` accepts the
proof and rejects a tampered copy.  An SRS in the JAX layout, built with JAX
``CurveOps``, converts through ``utils/convert.py`` and commits identically.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kzg_snark_tpu.models.plonk.device import PlonkDeviceCore as JaxCore
from kzg_snark_tpu.models.plonk.indexer import Indexer
from kzg_snark_tpu.models.plonk.prover import Prover
from kzg_snark_tpu.ops.fr import fr_backend as jax_fr_backend
from kzg_snark_tpu.ops.host.field import scalar_field
from kzg_snark_tpu.rng import Rng
from kzg_snark_tpu_torch.models.kzg import KZG as PortKZG
from kzg_snark_tpu_torch.models.plonk.device import (DeviceProver,
                                                     PlonkDeviceCore)
from kzg_snark_tpu_torch.models.plonk.verifier import Verifier
from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor
from kzg_snark_tpu_torch.rng import Rng as PortRng
from kzg_snark_tpu_torch.utils.convert import device_srs_from_jax, to_plain

# Tiny tensors: one intra-op thread is faster than many, and the test
# workers share the CPU (threads that spin-wait stall them all).
torch.set_num_threads(1)

TAU = 0xABCDEF12345
N = 16


@pytest.fixture(scope="module")
def circuit():
    Fr = scalar_field("bn254")
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(N)]
    b = [Fr(i + 3) for i in range(N)]
    c = [x * y for x, y in zip(a, b)]
    return {"qM": [one] * N, "qZ": [zero] * N, "qO": [-one] * N,
            "perm": list(range(3 * N)), "w": a + b + c}


def _index(indexer, s):
    return indexer.preprocess(s["qM"], s["qZ"], s["qZ"], s["qO"], s["qZ"],
                              s["perm"], max_degree=N + 5, tau=TAU)


@pytest.fixture(scope="module")
def port_run(circuit):
    keys = _index(DeviceProver("bn254", rng=PortRng(600), device="cpu"),
                  circuit)
    proof = DeviceProver("bn254", rng=PortRng(601), device="cpu").prove(
        keys[0], [], circuit["w"])
    return keys, proof


@pytest.fixture(scope="module")
def host_run(circuit):
    indexer = Indexer("bn254", backend="host", rng=Rng(600))
    indexer.kzg.normalize_commitments = True
    keys = _index(indexer, circuit)
    prover = Prover("bn254", backend="host", rng=Rng(601))
    prover.kzg.normalize_commitments = True
    return keys, prover.prove(keys[0], [], circuit["w"])


def test_index_matches_host(port_run, host_run):
    (ipk_p, ivk_p), _ = port_run
    (ipk_h, ivk_h), _ = host_run
    assert int(ipk_p["subgroups"]["k1"]) == int(ipk_h["subgroups"]["k1"])
    assert int(ipk_p["subgroups"]["k2"]) == int(ipk_h["subgroups"]["k2"])
    assert to_plain(ivk_p["commitments"]) == to_plain(ivk_h["commitments"])
    for name, poly in ipk_h["polynomials"].items():
        assert to_plain(ipk_p["polynomials"][name].padded(N)) == \
            to_plain(poly.padded(N)), name


def test_proof_matches_host_bytes(port_run, host_run):
    _, proof_p = port_run
    _, proof_h = host_run
    for part in ("commitments", "evaluations", "kzg_proofs"):
        assert to_plain(proof_p[part]) == to_plain(proof_h[part]), part


def test_proof_verifies_and_tamper_rejected(port_run):
    (_, ivk), proof = port_run
    assert Verifier("bn254", rng=PortRng(78)).verify(ivk, [], proof)
    tampered = {k: dict(v) for k, v in proof.items()}
    tampered["evaluations"]["a"] = proof["evaluations"]["a"] + 1
    assert not Verifier("bn254", rng=PortRng(79)).verify(ivk, [], tampered)


def test_jax_layout_device_cache_converts(port_run):
    """Index arrays in the JAX layout (JAX ``from_ints``, the way the JAX
    prover fills ``ipk["_device_cache"]``) convert to the port's cache."""
    from kzg_snark_tpu.ops.fr import fr_backend as jax_fr_backend
    from kzg_snark_tpu_torch.utils.convert import device_cache_from_jax

    (ipk, _), _ = port_run
    jb = jax_fr_backend("bn254")
    polys, sigma = ipk["polynomials"], ipk["sigma_star"]
    jax_cache = {
        "qM_coeffs": jb.from_ints([int(c) for c in polys["qM"].padded(N)]),
        "sig3_coeffs": jb.from_ints(
            [int(c) for c in polys["S_sigma3"].padded(N)]),
        "sig2_vals": jb.from_ints([int(s) for s in sigma[N:2 * N]]),
    }
    converted = device_cache_from_jax(
        {k: np.asarray(v) for k, v in jax_cache.items()}, device="cpu")
    for key, tensor in converted.items():
        assert np.array_equal(tensor.numpy(),
                              ipk["_device_cache"][key].numpy()), key


def test_srs_matches_host_setup():
    port = PortKZG("bn254", backend="cuda", device="cpu")
    host = Indexer("bn254", backend="host").kzg
    ck_p, rk_p = port.setup(7, tau=TAU)
    ck_h, rk_h = host.setup(7, tau=TAU)
    assert to_plain(rk_p) == to_plain(rk_h)
    for i in range(8):
        assert to_plain(ck_p[i]) == to_plain(host._normalize_point(ck_h[i])), i


def test_jax_layout_srs_commits_identically():
    from kzg_snark_tpu.ops.g1 import curve_ops as jax_curve_ops
    from kzg_snark_tpu.ops.host import curve as hc

    host = Indexer("bn254", backend="host").kzg
    host.normalize_commitments = True
    ck_h, _ = host.setup(7, tau=TAU)
    aff = [hc.normalize(pt) for pt in ck_h]
    jax_points = jax_curve_ops("bn254").from_affine_ints(
        [int(a[0]) for a in aff], [int(a[1]) for a in aff])
    ck_j = device_srs_from_jax("bn254", np.asarray(jax_points),
                               device="cpu")

    port = PortKZG("bn254", backend="cuda", device="cpu")
    ck_p, _ = port.setup(7, tau=TAU)
    assert np.array_equal(ck_j.points.numpy(), ck_p.points.numpy())
    rng = np.random.default_rng(5)
    coeffs = [int(v) for v in rng.integers(0, 1 << 62, size=8)]
    assert to_plain(port.commit(ck_j, [coeffs])) == \
        to_plain(host.commit(ck_h, [coeffs]))


@pytest.mark.parametrize("curve, m", [("bn254", 17), ("bn254", 64),
                                      ("bls12_381", 64)])
def test_open_at_matches_jax(curve, m):
    """``PlonkDeviceCore.open_at`` at an int point equals the JAX method
    (canonical ints, exact) and the port's ``open_dev`` at the same point
    as a device scalar.  The JAX ``PlonkDeviceCore.open_at`` runs on a
    core that holds only its field backend, the one attribute it reads:
    the real core's NTT tables cost 40 s of XLA compiles on the CPU."""
    jax_be = jax_fr_backend(curve)
    jax_core = SimpleNamespace(be=jax_be)
    core = PlonkDeviceCore(curve, N, "cpu")
    r = core.be.modulus
    rng = np.random.default_rng(m)
    ints = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(m)]
    point = int.from_bytes(rng.bytes(32), "little") % r
    want = jax_be.to_ints(JaxCore.open_at(jax_core, jax_be.from_ints(ints),
                                          point))
    coeffs = core.be.from_ints(ints)
    got = core.open_at(coeffs, point)
    assert got.shape == (8, m - 1)
    assert core.be.to_ints(got) == want
    assert torch.equal(core.open_dev(coeffs, core.be.scalar(point)), got)
    # the witness divides exactly: p(X) - p(z) = w(X) (X - z)
    pz = sum(c * pow(point, i, r) for i, c in enumerate(ints)) % r
    w = want + [0]
    assert [(ints[i] - (pz if i == 0 else 0)) % r for i in range(m)] == [
        ((w[i - 1] if i else 0) - point * w[i]) % r for i in range(m)]


def test_open_at_checked_validates_its_output(monkeypatch):
    """Under KZG_TPU_CHECKED the core's open_at output is validated as
    ``plonk.open_at``: a non-canonical witness traps by that name."""
    monkeypatch.setenv("KZG_TPU_CHECKED", "1")
    p = to_tensor(ints_to_words([scalar_field("bn254").modulus]), "cpu")

    def planted(self, coeffs, pows, inv_pows):
        out = coeffs[:, :-1].clone()
        out[:, 2] = p[:, 0]
        return out
    monkeypatch.setattr(PlonkDeviceCore, "_open", planted)
    core = PlonkDeviceCore("bn254", 8, "cpu")
    with pytest.raises(AssertionError, match=r"^plonk\.open_at: "
                                             r"non-canonical output .* "
                                             r"at column 2$"):
        core.open_at(core.be.from_ints(range(1, 6)), 5)
