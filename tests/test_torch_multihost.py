"""The port's (host, chip) mesh against the JAX package's.

Four spawned ranks of the port (gloo on the CPU, torch on one thread
each) form ``make_mesh2(2, 2)``:

* the four-step NTT at n = 64 over ``axis=("host", "chip")`` (flat rank
  host-major): each rank's slice equal word for word to the JAX
  ``DistNttContext(..., axis=("host", "chip"))`` on the JAX
  ``make_mesh2(2, 2)``, and the round trip;
* ``msm_multihost`` at N = 8192 (2048 points a rank: the bucket route on
  every rank) on ``random_point_basis`` and its multiples by 2, 4 and 8,
  against the host oracle, and at N = 64 on the ladder ("small").

``initialize_multihost()`` joins from torchrun's variables: two ranks
under ``python -m torch.distributed.run --standalone`` run
``multihost_dryrun``'s checks at small sizes.  ``make_mesh2`` names its
axes ("host", "chip") and raises when the group is too small.
Tolerance: exact, equal words and equal affine points.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kzg_snark_tpu.parallel.multihost import make_mesh2 as jax_make_mesh2
from kzg_snark_tpu.parallel.ntt_dist import DistNttContext as JaxDistNtt
from kzg_snark_tpu_torch.ops.benchpoints import (normalize_points,
                                                 random_point_basis)
from kzg_snark_tpu_torch.ops.limbs import ints_to_words, words_to_ints
from kzg_snark_tpu_torch.ops.msm import msm_context
from kzg_snark_tpu_torch.parallel import dryrun
from kzg_snark_tpu_torch.parallel.multihost import make_mesh2
from kzg_snark_tpu_torch.utils.convert import tensor_to_limbs16

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BUCKET = 4 * 2048


def bucket_basis():
    """8192 points: the 2048-point basis times 1, 2, 4 and 8."""
    pts, ks = random_point_basis("bn254", 2048, seed=2048, device="cpu")
    curve = msm_context("bn254", "cpu").curve
    parts, mults = [pts], list(ks)
    for j in (1, 2, 3):
        pts = normalize_points(curve.f, curve.double(pts))
        parts.append(pts)
        mults += [k << j for k in ks]
    return torch.cat(parts, dim=-1), mults


@pytest.fixture(scope="module")
def mesh_ranks():
    pts, ks = bucket_basis()
    words = dryrun.random_words(N_BUCKET, 11)
    aff = dryrun.structured_points("bn254", 64)
    curve = msm_context("bn254", "cpu").curve
    rng = random.Random(12)
    small = [rng.randrange(1 << 127) for _ in range(64)]
    small_pts = curve.from_affine_ints([p[0] for p in aff],
                                       [p[1] for p in aff])
    cases = [
        {"op": "ntt", "curve": "bn254", "hosts": 2,
         "words": dryrun.random_words(64, 10)},
        {"op": "msm", "method": "multihost", "curve": "bn254", "hosts": 2,
         "points": pts.numpy(), "scalars": words},
        {"op": "msm", "method": "multihost", "impl": "small",
         "curve": "bn254", "hosts": 2, "points": small_pts.numpy(),
         "scalars": ints_to_words(small)},
    ]
    out = dryrun.launch(dryrun.run_cases, 4, (cases,), backend="gloo",
                        device="cpu")
    return cases, ks, small, out


def test_two_axis_ntt_matches_jax(mesh_ranks):
    cases, _, _, out = mesh_ranks
    mesh = jax_make_mesh2(num_hosts=2, chips_per_host=2)
    ctx = JaxDistNtt("bn254", 64, mesh, axis=("host", "chip"))
    x = ctx.natural_to_cyclic(ctx.backend.from_ints(
        words_to_ints(cases[0]["words"])))
    y = np.asarray(ctx.ntt(x))
    x = np.asarray(x)
    for d, rank in enumerate(out):
        res = rank["cases"][0]
        assert res["index"] == d and not res["small"]
        for key, want in (("y", y), ("back", x)):
            got = tensor_to_limbs16(torch.from_numpy(
                res[key].view(np.int32)))
            assert np.array_equal(got, want[:, d:d + 1]), key


def test_msm_multihost_bucket_route_matches_oracle(mesh_ranks):
    cases, ks, _, out = mesh_ranks
    want = dryrun.host_oracle("bn254", ks, words_to_ints(cases[1]["scalars"]))
    assert want is not None
    for rank in out:
        assert rank["cases"][1]["affine"] == want


def test_msm_multihost_small_matches_oracle(mesh_ranks):
    _, _, scalars, out = mesh_ranks
    want = dryrun.host_oracle("bn254", range(1, 65), scalars)
    for rank in out:
        assert rank["cases"][2]["affine"] == want


def test_initialize_multihost_from_torchrun_variables():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "kzg_snark_tpu_torch.parallel.multihost_dryrun", "--device", "cpu",
         "--backend", "gloo", "--log2n", "4", "--log2msm", "3",
         "--log2small", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for check in ("msm_multihost: N = 8 over (host=1, chip=2) (fused)",
                  "msm_multihost: N = 8 over (host=1, chip=2) (small)",
                  "ntt2: bn254 n = 2^4 over 2 ranks (four-step)"):
        assert check in proc.stdout, proc.stdout


def test_make_mesh2_axes_and_size_check(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh2(1, 1, "cpu")
        assert mesh.mesh_dim_names == ("host", "chip")
        assert tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="requested 2 x 1 devices, "
                                             "have 1"):
            make_mesh2(2, 1, "cpu")
    finally:
        dist.destroy_process_group()
