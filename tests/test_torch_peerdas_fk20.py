"""PeerDAS cells and proofs by FK20 (``ops/fk20.py``,
``KZG.compute_cells_and_kzg_proofs``) on the CPU, through the plain versions
of the kernels.

Cells and proofs are held to the benchmark's plain reference
(``kzgbench/plain/cells.py``: a radix-2 extension and each cell's quotient
at tau by barycentric interpolation) and to the specs' per-cell definition:
the interpolation I_i = f mod (X^l - a_i) matches the cell's values, and
the proof commits to the quotient (f - I_i) / (X^l - a_i), found by long
division (at n = 16 also committed by the port's MSM over the SRS).  A zero
blob's proofs are the identity.
"""

import functools

import numpy as np
import pytest
import torch

from kzg_snark_tpu_torch.models.kzg import KZG
from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor
from kzg_snark_tpu_torch.ops.msm import msm_context
from kzgbench.generator import make_pool
from kzgbench.plain import cells as plain_cells
from kzgbench.plain.curves import CURVES, FixedBase, root_of_unity
from kzgbench.plain.reference import Reference
from kzgbench.plain.transcript import field_bytes

torch.set_num_threads(1)
TAU = 0x5EED_0F_7594_C0FFEE


@functools.lru_cache(maxsize=None)
def _fixed_base(curve: str) -> FixedBase:
    return FixedBase(CURVES[curve])


@functools.lru_cache(maxsize=None)
def _fk20_case(curve: str, n: int, l: int, k: int):
    """One FK20 run of k blobs (the second, if any, all zero) at (n, l) on
    the CPU: (KZG, its SRS, blobs, cells, proofs)."""
    cv = CURVES[curve]
    kzg = KZG(curve, backend="cuda", device="cpu")
    srs, _ = kzg.setup(n - 1, tau=TAU)
    blobs = make_pool(cv.r, n, k, 1, n + l, torch.device("cpu"))[0]
    blobs[:, 1:] = 0
    cells, proofs = kzg.compute_cells_and_kzg_proofs(blobs, cell_width=l)
    return kzg, srs, blobs, cells, proofs


def _values(words: np.ndarray) -> list:
    le = np.ascontiguousarray(np.asarray(words, dtype="<u4").T).tobytes()
    return [int.from_bytes(le[32 * i:32 * i + 32], "little")
            for i in range(len(le) // 32)]


# (curve, n, l, blobs): the last at BN254 alone, and one blob, since its
# set-up table alone is about 1.6 million plain curve operations.
CASES = [("bls12_381", 16, 2, 2), ("bn254", 16, 2, 2),
         ("bls12_381", 64, 4, 1), ("bn254", 64, 4, 1), ("bn254", 256, 8, 1)]


@pytest.mark.parametrize("curve, n, l, k", CASES)
def test_fk20_matches_the_plain_reference_and_the_specs_quotients(curve, n,
                                                                    l, k):
    kzg, srs, blobs, cells, proofs = _fk20_case(curve, n, l, k)
    cv = CURVES[curve]
    r, N, k = cv.r, 2 * n // l, blobs.shape[1]
    assert cells.shape == (8, k, N, l) and len(proofs) == k
    words = cells.numpy().view(np.uint32)
    raw = field_bytes(words.reshape(8, -1))
    want = plain_cells.expected(Reference(cv, n, TAU),
                                blobs.numpy().view(np.uint32), width=l)
    assert [raw[i:i + 32 * l] for i in range(0, len(raw), 32 * l)] == \
        want["evaluations"]
    assert [P for row in proofs for P in row] == want["proofs"]
    assert all(P is None for row in proofs[1:] for P in row)   # zero blobs

    # The specs' definition, cell by cell: I_i = f mod (X^l - a_i) matches
    # the cell's values, and the proof commits to (f - I_i) / (X^l - a_i).
    w = root_of_unity(cv, n)
    coeffs = [c * pow(n, -1, r) % r for c in plain_cells.radix2(
        _values(blobs[:, 0].numpy().view(np.uint32)), pow(w, -1, r), r)]
    w2 = root_of_unity(cv, 2 * n)
    order = plain_cells._bit_reverse(2 * n)
    ctx = msm_context(curve, "cpu")
    for i in range(N):
        pos = order[i * l:(i + 1) * l]
        a = pow(w2, l * pos[0], r)
        rem = list(coeffs)
        quot = [0] * (n - l)
        for e in range(n - 1, l - 1, -1):
            quot[e - l] = rem[e]
            rem[e - l] = (rem[e - l] + a * rem[e]) % r
        interp = rem[:l]
        ys = _values(words[:, 0, i])
        for j, e in enumerate(pos):
            z = pow(w2, e, r)
            assert sum(c * pow(z, d, r) for d, c in enumerate(interp)) % r \
                == ys[j]
        at_tau = sum(c * pow(TAU, d, r) for d, c in enumerate(quot)) % r
        assert proofs[0][i] == _fixed_base(curve).mul(at_tau)
        if i == N - 1 and n == 16:     # the specs' MSM over the SRS
            q = to_tensor(ints_to_words(quot), "cpu")
            P = ctx.msm(srs.points[..., :n - l].contiguous(), q)
            assert ctx.curve.to_affine_ints(P) == [proofs[0][i]]
