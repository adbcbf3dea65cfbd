"""Dry run of the (host, chip) mesh.

Counterpart of ``kzg_snark_tpu/parallel/multihost_dryrun.py``: on a
``make_mesh2(hosts, ranks / hosts)`` mesh, ``msm_multihost`` (the
hierarchical combine) against the host oracle, on the fused route at 2^M
points of ``random_point_basis`` and on the ladder at 2^S points of
(i + 1) G, and the four-step NTT at 2^K over ``axis=("host", "chip")``
(flat rank host-major) equal to the single-device transform, with its
round trip.  ``dryrun --hosts H`` runs these checks on spawned ranks;
under torchrun, one process a rank, this module is the worker::

    torchrun --nnodes H --nproc-per-node C \\
        -m kzg_snark_tpu_torch.parallel.multihost_dryrun --log2n 12 \\
        --log2msm 13 [--log2small 10] [--device cpu] [--backend gloo]

which joins through ``initialize_multihost()`` (torchrun's variables) and
takes the hosts from ``LOCAL_WORLD_SIZE``.
"""

from __future__ import annotations

import argparse
import random
import sys

import torch
import torch.distributed as dist

from ..ops.limbs import ints_to_words, to_tensor, words_to_ints
from ..ops.msm import msm_context
from .dryrun import (basis, check_ntt, host_oracle, log, measure, ms,
                     random_words, structured_points)
from .multihost import (CHIP_AXIS, HOST_AXIS, initialize_multihost,
                        make_mesh2, msm_multihost)

def multihost_checks(out: dict, dev, hosts: int, log2n: int, log2msm: int,
                     log2small: int) -> None:
    """The (host, chip) checks on every rank of the group."""
    chips = dist.get_world_size() // hosts
    mesh = make_mesh2(hosts, chips, dev.type)
    shape = f"(host={hosts}, chip={chips})"

    N = 1 << log2msm
    pts, ks = basis("bn254", N, dev)
    words = random_words(N, 2000 + N)
    sc = to_tensor(words, dev)
    res, rec = measure(dev, lambda: msm_multihost(mesh, pts, sc, "bn254",
                                                  "fused", dev))
    curve = msm_context("bn254", dev).curve
    if curve.to_affine_ints(res)[0] != host_oracle("bn254", ks,
                                                   words_to_ints(words)):
        raise AssertionError(f"msm_multihost: N = {N} over {shape} "
                             f"differs from the host oracle")
    out["msm_multihost"] = {"N": N, "mesh": [hosts, chips], "msm": rec}
    log(f"msm_multihost: N = {N} over {shape} (fused) equal to the host "
        f"oracle OK; rank 0 device / wall {ms(rec)}")

    n_small = 1 << log2small
    aff = structured_points("bn254", n_small)
    spts = curve.from_affine_ints([p[0] for p in aff], [p[1] for p in aff])
    rng = random.Random(99)
    scalars = [rng.randrange(1 << 127) for _ in range(n_small)]
    ssc = to_tensor(ints_to_words(scalars), dev)
    res, rec = measure(dev, lambda: msm_multihost(mesh, spts, ssc, "bn254",
                                                  "small", dev))
    if curve.to_affine_ints(res)[0] != host_oracle(
            "bn254", range(1, n_small + 1), scalars):
        raise AssertionError(f"msm_multihost small: over {shape} differs "
                             f"from the host oracle")
    out["msm_multihost_small"] = {"N": n_small, "mesh": [hosts, chips],
                                  "msm": rec}
    log(f"msm_multihost: N = {n_small} over {shape} (small) equal to "
        f"the host oracle OK; rank 0 device / wall {ms(rec)}")

    check_ntt(out, "ntt2", mesh, "bn254", 1 << log2n, dev,
              axis=(HOST_AXIS, CHIP_AXIS))


def worker(argv=None) -> int:
    """One rank under torchrun (see the module docstring)."""
    import os
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=12)
    ap.add_argument("--log2msm", type=int, default=13)
    ap.add_argument("--log2small", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    a = ap.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(backend=a.backend, device_type=a.device)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if a.device == "cuda" else torch.device("cpu")
        hosts = dist.get_world_size() // int(os.environ["LOCAL_WORLD_SIZE"])
        multihost_checks({}, dev, hosts, a.log2n, a.log2msm, a.log2small)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    from kzg_snark_tpu_torch.parallel import multihost_dryrun
    sys.exit(multihost_dryrun.worker())
