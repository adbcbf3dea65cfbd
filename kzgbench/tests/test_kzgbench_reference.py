"""The plain reference against an independent witness: the port's host KZG
(pure Python, no kernel) on coefficients that the test interpolates
naively, on both curves."""

import random

import numpy as np
import pytest

from kzg_snark_tpu_torch.models.kzg import KZG
from kzgbench.plain import blob, multi_open
from kzgbench.plain.curves import CURVES, compress, root_of_unity
from kzgbench.plain.reference import Reference, words_to_limbs16
from kzgbench.plain.transcript import (blob_challenge, field_bytes,
                                       multi_open_challenges)

N = 8


def _words(values):
    buf = b"".join(v.to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(len(values), 8).T


def _coeffs(curve, values):
    r, n = curve.r, len(values)
    winv = pow(root_of_unity(curve, n), -1, r)
    ninv = pow(n, -1, r)
    return [sum(v * pow(winv, j * k, r) for k, v in enumerate(values))
            * ninv % r for j in range(n)]


def _affine(kzg, pt):
    pt = kzg._normalize_point(pt)
    return None if not int(pt[2]) else (int(pt[0]), int(pt[1]))


def _host(curve_name, tau):
    kzg = KZG(curve_name, backend="host", normalize_commitments=True)
    ck, _ = kzg.setup(N - 1, tau=tau)
    return kzg, ck


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381"])
def test_blob_answers_match_host_kzg(curve_name):
    curve = CURVES[curve_name]
    rng = random.Random(5)
    tau = rng.randrange(1, curve.r)
    kzg, ck = _host(curve_name, tau)
    blobs = [[rng.randrange(curve.r) for _ in range(N)] for _ in range(2)]
    words = np.stack([_words(v) for v in blobs], axis=1)      # (8, 2, N)
    got = blob.expected(Reference(curve, N, tau), words)
    for i, values in enumerate(blobs):
        coeffs = _coeffs(curve, values)
        C = _affine(kzg, kzg.commit(ck, [coeffs])[0])
        assert got["commitments"][i] == C
        z = blob_challenge(field_bytes(words[:, i, :]), compress(C, curve),
                           N, curve.r)
        y = sum(c * pow(z, j, curve.r) for j, c in enumerate(coeffs)) \
            % curve.r
        assert got["evaluations"][i] == y
        # KZG.open combines xi^(i+1) p_i: with xi = 1 it opens p alone.
        assert got["proofs"][i] == _affine(kzg, kzg.open(ck, [coeffs], z, 1))


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381"])
def test_multi_open_answers_match_host_kzg(curve_name):
    curve = CURVES[curve_name]
    rng = random.Random(9)
    tau = rng.randrange(1, curve.r)
    kzg, ck = _host(curve_name, tau)
    polys = [[rng.randrange(curve.r) for _ in range(N)] for _ in range(3)]
    words = np.stack([_words(v) for v in polys], axis=1)
    got = multi_open.expected(Reference(curve, N, tau), words)
    coeffs = [_coeffs(curve, v) for v in polys]
    Cs = [_affine(kzg, c) for c in kzg.commit(ck, coeffs)]
    assert got["commitments"] == Cs
    z, xi = multi_open_challenges(Cs, N, curve)
    assert got["evaluations"] == [
        sum(c * pow(z, j, curve.r) for j, c in enumerate(cs)) % curve.r
        for cs in coeffs]
    assert got["proofs"] == [_affine(kzg, kzg.open(ck, coeffs, z, xi))]


def test_values_at_domain_points_and_limb_sums():
    curve = CURVES["bls12_381"]
    ref = Reference(curve, N, 77)
    values = [curve.r - 1 - i for i in range(N)]
    v16 = words_to_limbs16(_words(values)[:, None, :])
    w = root_of_unity(curve, N)
    assert ref.evaluate(v16, pow(w, 3, curve.r)) == [values[3]]
    coeffs = _coeffs(curve, values)
    assert ref.at_tau(v16) == [
        sum(c * pow(77, j, curve.r) for j, c in enumerate(coeffs)) % curve.r]


def test_blob_challenge_follows_the_specs():
    r = CURVES["bls12_381"].r
    import hashlib
    data = b"FSBLOBVERIFY_V1_" + (4096).to_bytes(16, "big") + b"\x01" * 7
    want = int.from_bytes(hashlib.sha256(data).digest(), "big") % r
    assert blob_challenge(b"\x01" * 3, b"\x01" * 4, 4096, r) == want
