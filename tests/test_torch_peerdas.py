"""The grouped MSM (``ops/msm_grouped.py``) on the CPU, through the plain
versions of its kernels, and the shape of a PeerDAS batch by FK20
(``ops/fk20.py``, ``KZG.compute_cells_and_kzg_proofs``).

The grouped MSM is held to the exact sums on a basis of known discrete
logs (P_i = k_i G, so sum_i s_i P_i = (sum_i s_i k_i) G) and, for one to
three groups, to a loop of per-group shared-base MSMs (``MsmContext.msm``);
with an all-zero set, a set of equal scalars, and complete adds on
repeated bases.  A batch's launches and host waits in FK20 do not depend
on the number of blobs: with the kernels replaced by a recording library,
k = 1 and k = 3 make the same calls.  FK20's values are held to the
references in ``test_torch_peerdas_fk20.py``.
"""

import functools
import random

import pytest
import torch

from kzg_snark_tpu_torch.models.kzg import KZG
from kzg_snark_tpu_torch.ops import (cuda_fr, fk20, msm_grouped, ntt_stage,
                                     scan)
from kzg_snark_tpu_torch.ops.benchpoints import (generator_multiples,
                                                  random_point_basis)
from kzg_snark_tpu_torch.ops.limbs import ints_to_words, to_tensor
from kzg_snark_tpu_torch.ops.msm import msm_context
from kzg_snark_tpu_torch.utils import build
from kzgbench.generator import make_pool
from kzgbench.plain.curves import CURVES, FixedBase

torch.set_num_threads(1)
TAU = 0x5EED_0F_7594_C0FFEE


@functools.lru_cache(maxsize=None)
def _fixed_base(curve: str) -> FixedBase:
    return FixedBase(CURVES[curve])


def _scalars(ints: list) -> torch.Tensor:
    """ints[g][s][i] -> (G, k, 8, n) canonical limbs."""
    G, k, n = len(ints), len(ints[0]), len(ints[0][0])
    flat = [x for g in ints for s in g for x in s]
    words = to_tensor(ints_to_words(flat), "cpu")
    return words.reshape(8, G, k, n).permute(1, 2, 0, 3).contiguous()


def _oracle(curve: str, ks: list, ints: list) -> list:
    """(sum_i s_i k_i) G for every (group, set), in the result's order."""
    r = CURVES[curve].r
    n = len(ints[0][0])
    return [_fixed_base(curve).mul(sum(
        s * kk for s, kk in zip(row, ks[g * n:(g + 1) * n])) % r)
        for g, sets in enumerate(ints) for row in sets]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("n", [2, 5, 64])
@pytest.mark.parametrize("G", [1, 3, 16])
def test_grouped_msm_matches_per_group_msms(G, n, k):
    curve = "bn254"
    ctx = msm_context(curve, "cpu")
    r = ctx.scalar_backend.modulus
    pts, ks = random_point_basis(curve, G * n, seed=G * 100 + n, device="cpu")
    rng = random.Random(G * 1000 + n * 10 + k)
    ints = [[[rng.randrange(r) for _ in range(n)] for _ in range(k)]
            for _ in range(G)]
    ints[0][0] = [0] * n                        # an all-zero set
    if k > 1:
        ints[-1][1] = [ints[-1][1][0]] * n      # equal scalars
    sc = _scalars(ints)
    out = ctx.msm_grouped(pts, sc)
    assert out.shape == (3, ctx.curve.num_limbs, G, k)
    got = ctx.curve.to_affine_ints(out)
    assert got == _oracle(curve, ks, ints)
    assert got[0] is None
    if G <= 3:
        for g in range(G):
            ref = ctx.msm(pts[..., g * n:(g + 1) * n].contiguous(), sc[g])
            assert ctx.curve.to_affine_ints(ref) == got[g * k:(g + 1) * k]


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_grouped_msm_complete_adds_on_repeated_bases(curve):
    """Each group [G, 2G, 3G, 4G] twice: with every scalar 1 a bucket's
    running sum meets its next point (G + 2G = 3G) and the point itself
    again; the complete adds give the exact sums."""
    ctx = msm_context(curve, "cpu")
    r = ctx.scalar_backend.modulus
    base = generator_multiples(curve, 4, "cpu")
    pts = torch.cat([base, base, base, base], dim=-1)        # G = 2, n = 8
    ks = [1, 2, 3, 4] * 4
    rng = random.Random(7)
    ints = [[[1] * 8, [rng.randrange(r) for _ in range(8)]] for _ in range(2)]
    got = ctx.curve.to_affine_ints(ctx.msm_grouped(pts, _scalars(ints),
                                                   complete=True))
    assert got == _oracle(curve, ks, ints)


class _Recorder:
    """A stand-in for the kernel library: every entry point returns 0 and
    is logged by name."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@functools.lru_cache(maxsize=None)
def _small_case():
    """FK20 at n = 16, cells of 2, two blobs on the CPU: (KZG, blobs,
    cells)."""
    kzg = KZG("bls12_381", backend="cuda", device="cpu")
    kzg.setup(15, tau=TAU)
    blobs = make_pool(CURVES["bls12_381"].r, 16, 2, 1, 18,
                      torch.device("cpu"))[0]
    cells, _ = kzg.compute_cells_and_kzg_proofs(blobs, cell_width=2)
    return kzg, blobs, cells


def test_compute_cells_is_the_extension_alone():
    kzg, blobs, cells = _small_case()
    assert torch.equal(kzg.compute_cells(blobs, cell_width=2), cells)


def _recorded_batch(monkeypatch, kzg, blobs, l):
    """FK20 on ``blobs`` with every kernel recorded, not run: (kernel
    entry points called, launches counted, waits counted).  The twiddle
    tables of the batch's transforms are built first, by the plain path
    (a context is built once and kept)."""
    core = kzg.cells_core(blobs.shape[-1], l)
    k, n = blobs.shape[1], blobs.shape[-1]
    for rows in (torch.zeros((8, k, 2 * n), dtype=torch.int32),
                 torch.zeros((8, k * l, core.cells), dtype=torch.int32)):
        fk20.ntt_rows(core.be, "bls12_381", rows)    # the twiddle tables
    lib = _Recorder()
    for mod in (cuda_fr, scan, ntt_stage, msm_grouped):
        monkeypatch.setattr(mod, "cuda_lib", lambda: lib)
    for mod in (cuda_fr, scan):
        monkeypatch.setattr(mod, "_on_cpu", lambda *t: False)
        monkeypatch.setattr(mod, "_require_cuda", lambda *a: None)
        monkeypatch.setattr(mod, "_stream", lambda t: 0)
    monkeypatch.setattr(ntt_stage, "tile_bits", lambda n: 10)
    coeffs = torch.zeros(blobs.shape, dtype=torch.int32)
    build.reset_launches()
    kzg.compute_cells_and_kzg_proofs(blobs, cell_width=l, coeffs=coeffs)
    out = (list(lib.calls), build.launch_counts(), build.sync_counts())
    monkeypatch.undo()
    assert core is kzg.cells_core(blobs.shape[-1], l)
    return out


def test_fk20_launches_and_waits_do_not_grow_with_the_blobs(monkeypatch):
    kzg, blobs, _ = _small_case()
    one = _recorded_batch(monkeypatch, kzg, blobs[:, :1], 2)
    three = _recorded_batch(monkeypatch, kzg, torch.cat(
        [blobs, blobs[:, :1]], dim=1), 2)
    assert one == three
    calls, launches, syncs = one
    assert calls.count("kzg_msm_grouped_schedule") == 2
    assert launches["msm_accumulate_grouped"] == 2
    assert syncs == {"g1.to_affine_ints": 1, "limbs.to_words": 2}
