"""The port's slow tier: its device paths at sizes tier-1 cannot afford, on
the CPU (plain PyTorch versions of every kernel), each held to the
reference its JAX model in the JAX slow tier uses.

    python -m pytest --runslow -m slow tests/test_torch_scale.py

* PLONK at n = 2^12 (``tests/test_plonk_device_scale.py``): index, prove,
  the host verifier accepts, a tampered evaluation is rejected.
* Marlin at |H| = 2^10, m = 2^11 (``tests/test_marlin_device_scale.py``):
  the same, a tampered ``beta1`` evaluation rejected.
* The staged NTT at 2^11-2^13 (``tests/test_ntt_staged.py:72-112``):
  forward and inverse equal the recursive host FFT, the 2^13 round trip.
* Eight gloo ranks (``tests/test_parallel.py:80-123``): the four-step NTT
  at n = 2^14 equal to the host FFT with its round trip and one
  all_to_all, and ``DistMsmContext.msm`` at N = 4096 against the host
  oracle.
* ``FusedMsm.msm_prepared`` at n = 2048 against the JAX
  ``FusedMsm.msm_prepared`` on its CPU route and the host oracle, unsplit
  and cut into point ranges.

Tolerance: exact throughout.  Every test is ``slow``: tier-1 runs
``-m 'not slow'``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_snark_tpu.ops.fr import ints_to_limb_array
from kzg_snark_tpu.ops.host.fft import fft_ff, ifft_ff
from kzg_snark_tpu.ops.host.field import scalar_field as jax_scalar_field
from kzg_snark_tpu.ops.msm_kernel import fused_msm as jax_fused_msm
from kzg_snark_tpu_torch import constants as C
from kzg_snark_tpu_torch.models.marlin.device import \
    DeviceProver as MarlinProver
from kzg_snark_tpu_torch.models.marlin.verifier import \
    Verifier as MarlinVerifier
from kzg_snark_tpu_torch.models.plonk.device import DeviceProver
from kzg_snark_tpu_torch.models.plonk.verifier import Verifier
from kzg_snark_tpu_torch.ops import msm_kernel as mk
from kzg_snark_tpu_torch.ops.benchpoints import random_point_basis
from kzg_snark_tpu_torch.ops.fr import fr_backend
from kzg_snark_tpu_torch.ops.host.field import scalar_field
from kzg_snark_tpu_torch.ops.limbs import (ints_to_words, to_tensor,
                                           words_to_ints)
from kzg_snark_tpu_torch.ops.msm import msm_context
from kzg_snark_tpu_torch.ops.ntt import ntt_context
from kzg_snark_tpu_torch.parallel import dryrun
from kzg_snark_tpu_torch.rng import Rng
from kzg_snark_tpu_torch.utils.convert import tensor_to_limbs16
from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

torch.set_num_threads(1)

pytestmark = pytest.mark.slow

R = C.BN254_R
JaxFr = jax_scalar_field("bn254")
rng = random.Random(20260820)


def test_plonk_device_prover_n4096_end_to_end():
    n = 1 << 12
    Fr = scalar_field("bn254")
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(n)]
    b = [Fr(i + 3) for i in range(n)]
    w = a + b + [x * y for x, y in zip(a, b)]
    prover = DeviceProver("bn254", rng=Rng(4242), device="cpu")
    ipk, ivk = prover.preprocess([one] * n, [zero] * n, [zero] * n,
                                 [-one] * n, [zero] * n, list(range(3 * n)),
                                 max_degree=n + 5, tau=0xC0FFEE12345)
    proof = prover.prove(ipk, [], w)
    assert Verifier("bn254", rng=Rng(4243)).verify(ivk, [], proof)
    tampered = dict(proof)
    tampered["evaluations"] = dict(proof["evaluations"])
    tampered["evaluations"]["a"] = proof["evaluations"]["a"] + 1
    assert not Verifier("bn254", rng=Rng(4244)).verify(ivk, [], tampered)


def test_marlin_device_prover_at_scale():
    n = 1 << 10
    A, B, Cm, z = synthetic_r1cs(n)
    assert len(A.nonzero_positions()) == 2 * n          # m = 2^11
    az, bz, cz = A.matvec(z), B.matvec(z), Cm.matvec(z)
    assert all((x * y).n == v.n for x, y, v in zip(az, bz, cz))
    m = 2 * n
    x, w = z[:5], z[5:]
    prover = MarlinProver("bn254", rng=Rng(900), device="cpu")
    ipk, ivk = prover.preprocess(A, B, Cm, 6 * m, tau=0xFEED5EED)
    proof = MarlinProver("bn254", rng=Rng(901), device="cpu").prove(ipk, x,
                                                                     w)
    assert MarlinVerifier("bn254", rng=Rng(902)).verify(ivk, x, proof)
    tampered = dict(proof)
    tampered["evaluations"] = dict(proof["evaluations"])
    beta1 = list(proof["evaluations"]["beta1"])
    beta1[0] = beta1[0] + 1
    tampered["evaluations"]["beta1"] = beta1
    assert not MarlinVerifier("bn254", rng=Rng(903)).verify(ivk, x,
                                                            tampered)


def _host_ntt(coeffs, n):
    return [int(v) for v in fft_ff([JaxFr(c) for c in coeffs],
                                   JaxFr.nth_root_of_unity(n))]


@pytest.mark.parametrize("n", [2048, 4096])
def test_staged_ntt_parity(n):
    ctx = ntt_context("bn254", n, "cpu")
    be = ctx.backend
    coeffs = [rng.randrange(R) for _ in range(n)]
    got = be.to_ints(ctx.ntt(be.from_ints(coeffs), mode="staged"))
    assert got == _host_ntt(coeffs, n)


def test_staged_intt_parity_2048():
    n = 2048
    ctx = ntt_context("bn254", n, "cpu")
    be = ctx.backend
    values = [rng.randrange(R) for _ in range(n)]
    want = [int(v) for v in ifft_ff([JaxFr(v) for v in values],
                                    JaxFr.nth_root_of_unity(n))]
    assert be.to_ints(ctx.intt(be.from_ints(values), mode="staged")) == want


def test_staged_roundtrip_8192():
    n = 8192
    ctx = ntt_context("bn254", n, "cpu")
    be = ctx.backend
    coeffs = [rng.randrange(R) for _ in range(n)]
    x = be.from_ints(coeffs)
    y = ctx.ntt(x, mode="staged")
    assert be.to_ints(ctx.intt(y, mode="staged")) == coeffs


D8 = 8


def test_dist_ntt_four_step_16k():
    """n = 2^14 over eight ranks: blocks of n2 / D = 256 in the
    all_to_all."""
    n = 1 << 14
    words = dryrun.random_words(n, 14)
    out = dryrun.launch(dryrun.run_cases, D8,
                        ([{"op": "ntt", "curve": "bn254", "words": words}],),
                        backend="gloo", device="cpu")
    be = fr_backend("bn254", "cpu")
    coeffs = words_to_ints(words)
    want = _host_ntt(coeffs, n)
    x = be.to_mont(to_tensor(words, "cpu"))
    for d, rank in enumerate(out):
        res = rank["cases"][0]
        assert res["index"] == d and not res["small"]
        natural = torch.from_numpy(res["natural"].view(np.int32))
        assert be.to_ints(natural) == want
        back = torch.from_numpy(res["back"].view(np.int32)).reshape(8, -1)
        assert torch.equal(back, x[:, d::D8])
        stats = res["stats"]
        assert stats["collectives_issued"] == {"all_to_all": 1}
        assert stats["bytes_cross_mesh_per_device_per_transform"] > 0


def test_dist_msm_production_path_4096():
    """DistMsmContext.msm at N = 2^12 over eight ranks (512 points a rank:
    the scan route) on a random-multiplier basis."""
    N = 1 << 12
    pts, ks = random_point_basis("bn254", N, seed=414, device="cpu")
    scalars = [rng.randrange(R) for _ in range(N)]
    scalars[0], scalars[1] = 0, R - 1
    case = {"op": "msm", "method": "msm", "curve": "bn254",
            "points": pts.numpy(), "scalars": ints_to_words(scalars)}
    out = dryrun.launch(dryrun.run_cases, D8, ([case],), backend="gloo",
                        device="cpu")
    want = dryrun.host_oracle("bn254", ks, scalars)
    assert want is not None
    for rank in out:
        assert rank["cases"][0]["affine"] == want


def test_msm_prepared_matches_jax(monkeypatch):
    """n = 2048 (the bucket route in both packages): the port's prepared
    MSM, unsplit and cut into five ranges, equals the JAX
    ``msm_prepared`` (its CPU route) and the host oracle."""
    n = 2048
    pts, ks = random_point_basis("bn254", n, seed=3048, device="cpu")
    sc = [rng.randrange(R) for _ in range(n)]
    sc[0], sc[1], sc[2] = 0, 1, R - 1
    sc[3] = sc[4] = sc[5]
    jfm = jax_fused_msm("bn254")
    jpts = jnp.asarray(np.stack([tensor_to_limbs16(pts[i])
                                 for i in range(3)]))
    jout = jfm.msm_prepared(jfm.prepare_points(jpts),
                            jnp.asarray(ints_to_limb_array(sc, 16)))
    want = jfm.curve.to_affine_ints(jout)
    assert want == [dryrun.host_oracle("bn254", ks, sc)]
    ctx = msm_context("bn254", "cpu")
    table = ctx.fused.prepare_points(pts)
    lim = ctx.scalars_to_limbs(sc)
    assert ctx.curve.to_affine_ints(ctx.fused.msm_prepared(table, lim)) \
        == want
    c = mk.window_bits(n // 5)
    monkeypatch.setattr(mk, "MAX_SCHEDULE_ENTRIES",
                        mk.num_windows(254, c) * -(-n // 5))
    assert len(mk.point_ranges(n, 1, 254)) == 5
    assert ctx.curve.to_affine_ints(ctx.fused.msm_prepared(table, lim)) \
        == want
