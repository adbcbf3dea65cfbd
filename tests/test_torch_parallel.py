"""The port's multi-device layer against the JAX package's.

Ranks are spawned processes of the port (``parallel/dryrun.launch``,
``run_cases``) joined by gloo on the CPU, torch on one thread each; the
JAX side runs on the simulated 8-device mesh of ``tests/conftest.py``.
Tolerance: exact, equal words and equal affine points.

* ``DistNttContext`` at D = 4: the four-step at n = 64 and the ``small``
  fallback at n = 8, each rank's slice equal word for word (through
  ``utils/convert``) to the JAX ``DistNttContext`` on ``make_mesh(4)`` in
  both layouts, the round trip, the gathered natural order, twiddle row d
  equal to the JAX table's row d, and the ``collective_stats`` bytes equal
  to JAX's at the port's 8 words (JAX's 16 half-words: half the bytes),
  one all_to_all (all_gather where small) issued.
* ``DistMsmContext.msm`` at D = 2, N = 4096 (2048 a rank: the bucket
  route) on ``random_point_basis`` and its doubles, and ``msm_small`` at
  D = 4, N = 64 on (i + 1) G with 127-bit scalars (the JAX dry run's),
  against the host oracle.
* D = 1 equal to the single-device NTT and MSM; ``make_mesh`` raises
  naming both counts when the group has fewer ranks than asked for; under
  ``KZG_TPU_CHECKED`` the ranks build checked contexts and a planted
  non-canonical transform output traps by name.
"""

import random

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kzg_snark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kzg_snark_tpu.parallel.ntt_dist import DistNttContext as JaxDistNtt
from kzg_snark_tpu_torch import constants as C
from kzg_snark_tpu_torch.ops.benchpoints import (normalize_points,
                                                 random_point_basis)
from kzg_snark_tpu_torch.ops.limbs import (ints_to_words, to_tensor,
                                           to_words, words_to_ints)
from kzg_snark_tpu_torch.ops.fr import CheckedFieldBackend
from kzg_snark_tpu_torch.ops.msm import msm_context
from kzg_snark_tpu_torch.ops.ntt import ntt_context
from kzg_snark_tpu_torch.parallel import dryrun
from kzg_snark_tpu_torch.parallel.mesh import make_mesh
from kzg_snark_tpu_torch.parallel.ntt_dist import DistNttContext
from kzg_snark_tpu_torch.utils.convert import tensor_to_limbs16

torch.set_num_threads(1)

D4 = 4


def as16(words: np.ndarray) -> np.ndarray:
    """The port's uint32 words -> the JAX package's 16-bit limbs."""
    return tensor_to_limbs16(torch.from_numpy(words.view(np.int32)))


def ntt_case(n: int, seed: int) -> dict:
    return {"op": "ntt", "curve": "bn254",
            "words": dryrun.random_words(n, seed)}


def structured_case(n: int) -> tuple[dict, list[int]]:
    """msm_small on (i + 1) G with 127-bit scalars: the case and its
    scalars."""
    aff = dryrun.structured_points("bn254", n)
    curve = msm_context("bn254", "cpu").curve
    pts = curve.from_affine_ints([p[0] for p in aff], [p[1] for p in aff])
    rng = random.Random(n)
    scalars = [rng.randrange(1 << 127) for _ in range(n)]
    return {"op": "msm", "method": "msm_small", "curve": "bn254",
            "points": pts.numpy(), "scalars": ints_to_words(scalars)}, \
        scalars


@pytest.fixture(scope="module")
def four_ranks():
    """One spawn of four ranks: the NTT at n = 64 and n = 8, msm_small at
    N = 64."""
    small_case, small_scalars = structured_case(64)
    cases = [ntt_case(64, 1), ntt_case(8, 2), small_case]
    out = dryrun.launch(dryrun.run_cases, D4, (cases,), backend="gloo",
                        device="cpu")
    return cases, small_scalars, out


@pytest.fixture(scope="module")
def jax_ntt():
    """The JAX DistNttContext on make_mesh(4) at n = 64 and 8, on the same
    inputs: {n: (ctx, y, back, natural)}."""
    mesh = jax_make_mesh(D4)
    out = {}
    for n, seed in ((64, 1), (8, 2)):
        ctx = JaxDistNtt("bn254", n, mesh)
        ints = words_to_ints(dryrun.random_words(n, seed))
        x = ctx.natural_to_cyclic(ctx.backend.from_ints(ints))
        y = ctx.ntt(x)
        out[n] = (ctx, np.asarray(y), np.asarray(ctx.intt(y)),
                  np.asarray(ctx.blocked_to_natural(y)), np.asarray(x))
    return out


@pytest.mark.parametrize("n", [64, 8], ids=["four_step", "small"])
def test_dist_ntt_matches_jax(four_ranks, jax_ntt, n):
    _, _, out = four_ranks
    ctx, y, back, natural, x = jax_ntt[n]
    k = 0 if n == 64 else 1
    assert ctx.small == (n == 8)
    for d, rank in enumerate(out):
        res = rank["cases"][k]
        assert res["index"] == d and res["small"] == ctx.small
        # rank d's slice of the JAX global arrays, both layouts
        assert np.array_equal(as16(res["y"]), y[:, d:d + 1])
        assert np.array_equal(as16(res["back"]), back[:, d:d + 1])
        assert np.array_equal(as16(res["back"]), x[:, d:d + 1])
        assert np.array_equal(as16(res["natural"]), natural)


def test_twiddle_rows_match_jax(four_ranks, jax_ntt):
    _, _, out = four_ranks
    table = np.asarray(jax_ntt[64][0].tw)              # (16, D, n2)
    for d, rank in enumerate(out):
        assert np.array_equal(as16(rank["cases"][0]["tw"]), table[:, d])


@pytest.mark.parametrize("n", [64, 8], ids=["four_step", "small"])
def test_collective_stats_match_jax(four_ranks, jax_ntt, n):
    _, _, out = four_ranks
    want = jax_ntt[n][0].collective_stats()
    for rank in out:
        got = rank["cases"][0 if n == 64 else 1]["stats"]
        assert (got["n"], got["devices"]) == (want["n"], want["devices"])
        # JAX counts 16 half-words an element, the port 8 words
        for key in ("bytes_local_slice_per_device",
                    "bytes_cross_mesh_per_device_per_transform",
                    "single_device_cross_bytes"):
            assert 2 * got[key] == want[key], key
        issued = "all_gather" if n == 8 else "all_to_all"
        assert got["collectives_issued"] == {issued: 1}
        assert want["hlo_collectives"] == {issued.replace("_", "-"): 1}


def test_msm_small_matches_oracle(four_ranks):
    _, scalars, out = four_ranks
    want = dryrun.host_oracle("bn254", range(1, 65), scalars)
    for rank in out:
        res = rank["cases"][2]
        assert res["affine"] == want
        # one ladder step of 16 points a rank: one all_gather of partials
        assert res["stats"]["chunk"] == 64
        assert res["stats"]["bytes_cross_mesh_per_device_per_msm"] == \
            3 * 3 * 8 * 4


def test_dist_msm_bucket_route_matches_oracle():
    """D = 2, N = 4096: each rank's 2048 points take the bucket route."""
    pts, ks = random_point_basis("bn254", 2048, seed=2048, device="cpu")
    curve = msm_context("bn254", "cpu").curve
    dbl = normalize_points(curve.f, curve.double(pts))
    pts, ks = torch.cat([pts, dbl], dim=-1), ks + [2 * k for k in ks]
    words = dryrun.random_words(4096, 7)
    words[:, :3] = ints_to_words([0, 1, C.BN254_R - 1])
    case = {"op": "msm", "method": "msm", "curve": "bn254",
            "points": pts.numpy(), "scalars": words}
    out = dryrun.launch(dryrun.run_cases, 2, ([case],), backend="gloo",
                        device="cpu")
    want = dryrun.host_oracle("bn254", ks, words_to_ints(words))
    for rank in out:
        assert rank["cases"][0]["affine"] == want


def test_single_rank_equals_single_device():
    n, N = 64, 64
    pts, _ = random_point_basis("bn254", N, seed=5, device="cpu")
    words = dryrun.random_words(N, 6)
    cases = [ntt_case(n, 3), {"op": "msm", "method": "msm", "curve": "bn254",
                              "points": pts.numpy(), "scalars": words}]
    (rank,) = dryrun.launch(dryrun.run_cases, 1, (cases,), backend="gloo",
                            device="cpu")
    ctx = ntt_context("bn254", n, "cpu")
    x = ctx.backend.to_mont(to_tensor(cases[0]["words"], "cpu"))
    res = rank["cases"][0]
    assert np.array_equal(res["natural"], to_words(ctx.ntt(x)))
    assert np.array_equal(res["y"].reshape(8, n), to_words(ctx.ntt(x)))
    assert np.array_equal(res["back"].reshape(8, n), to_words(x))
    assert res["stats"]["bytes_cross_mesh_per_device_per_transform"] == 0
    single = msm_context("bn254", "cpu")
    want = single.curve.to_affine_ints(single.msm(pts, to_tensor(words,
                                                                 "cpu")))[0]
    assert rank["cases"][1]["affine"] == want


def test_checked_mode_validates_dist_outputs(tmp_path, monkeypatch):
    """Under KZG_TPU_CHECKED the contexts are checked ones (their cache
    key holds the flag), the ranks see the variable, and a non-canonical
    row transform output traps as ``dist_ntt.ntt``."""
    monkeypatch.setenv("KZG_TPU_CHECKED", "1")
    (rank,) = dryrun.launch(dryrun.run_cases, 1, ([ntt_case(16, 4)],),
                            backend="gloo", device="cpu")
    assert rank["cases"][0]["checked"] == "CheckedFieldBackend"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        ctx = DistNttContext("bn254", 16, make_mesh(1, "cpu"), device="cpu")
        assert isinstance(ctx.backend, CheckedFieldBackend)
        x = ctx.natural_to_cyclic(ctx.backend.from_ints(range(16)))
        ctx.ntt(x)
        rows = ctx.ctx_rows

        class Planted:
            """The row transform with p added to column 3."""
            def ntt(self, v, mode=None):
                out = rows.ntt(v, mode=mode).clone()
                p = to_tensor(ints_to_words([C.BN254_R]), "cpu")
                out.reshape(8, -1)[:, 3] = p[:, 0]
                return out
        ctx.ctx_rows = Planted()
        with pytest.raises(AssertionError,
                           match="^dist_ntt.ntt: non-canonical output .* "
                                 "at column 3$"):
            ctx.ntt(x)
        ctx.ctx_rows = rows
    finally:
        dist.destroy_process_group()


def test_make_mesh_raises_on_too_few_ranks(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            make_mesh(2, "cpu")
        mesh = make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("shard",) and mesh.size() == 1
    finally:
        dist.destroy_process_group()
