"""The port's ``FrameworkConfig`` against the JAX package's.

The shared knobs (``KZG_TPU_NTT_MODE``, ``KZG_TPU_CHECKED``,
``KZG_TPU_COMPLETE_ADD``) keep the JAX spellings and values: for each
environment below both packages' ``from_env`` read the same values, and
``apply`` writes what ``from_env`` reads back, overwriting stale values.
Every knob is read at call time: the NTT mode (``mode=None``) and the
complete-add switch of a context made before the variable changed follow
the variable, and the XLA-only NTT modes raise instead of becoming another
mode.  ``mesh_devices`` has no variable (``from_env`` leaves it None, as
the JAX one does), and ``make_mesh`` gives the one-axis mesh over an
initialized one-rank gloo group.
"""

import numpy as np
import pytest
import torch

from kzg_snark_tpu.config import FrameworkConfig as JaxConfig
from kzg_snark_tpu_torch import config as config_mod
from kzg_snark_tpu_torch.config import FrameworkConfig
from kzg_snark_tpu_torch.ops import ntt as ntt_mod
from kzg_snark_tpu_torch.ops.msm_kernel import resolve_complete
from kzg_snark_tpu_torch.ops.ntt import ntt_context

torch.set_num_threads(1)

SHARED = (config_mod.NTT_MODE_VAR, config_mod.CHECKED_VAR,
          config_mod.COMPLETE_ADD_VAR)

ENVIRONMENTS = [
    {},
    {"KZG_TPU_NTT_MODE": "scan", "KZG_TPU_CHECKED": "1",
     "KZG_TPU_COMPLETE_ADD": "true"},
    {"KZG_TPU_NTT_MODE": "staged", "KZG_TPU_CHECKED": "on",
     "KZG_TPU_COMPLETE_ADD": "0"},
    {"KZG_TPU_NTT_MODE": "auto", "KZG_TPU_CHECKED": "yes",
     "KZG_TPU_COMPLETE_ADD": "on"},
]


@pytest.fixture
def clean_env(monkeypatch):
    """Every shared variable unset for the test, restored after it."""
    for var in SHARED:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", ENVIRONMENTS)
def test_shared_knobs_read_like_jax(clean_env, env):
    for var, value in env.items():
        clean_env.setenv(var, value)
    port, jax_cfg = FrameworkConfig.from_env(), JaxConfig.from_env()
    assert (port.ntt_mode, port.checked, port.complete_add) == \
        (jax_cfg.ntt_mode, jax_cfg.checked, jax_cfg.complete_add)


def test_apply_and_from_env_roundtrip(clean_env):
    import os
    cfg = FrameworkConfig(ntt_mode="scan", checked=True, complete_add=True)
    cfg.apply()
    back = FrameworkConfig.from_env()
    assert (back.ntt_mode, back.checked, back.complete_add) == \
        ("scan", True, True)
    assert os.environ["KZG_TPU_CHECKED"] == "1"
    # The JAX package reads what the port applied.
    assert JaxConfig.from_env().ntt_mode == "scan"
    assert JaxConfig.from_env().checked and JaxConfig.from_env().complete_add
    # Defaults overwrite stale values: the config object is the truth.
    FrameworkConfig().apply()
    back = FrameworkConfig.from_env()
    assert (back.ntt_mode, back.checked, back.complete_add) == \
        ("auto", False, False)


def test_defaults_run_on_the_card_and_as_dict():
    cfg = FrameworkConfig(rng_seed=11)
    assert (cfg.backend, cfg.device) == ("cuda", "cuda")
    d = cfg.as_dict()
    assert d["rng_seed"] == 11 and d["curve"] == "bn254"
    assert set(d) == {"curve", "backend", "device", "rng_seed", "ntt_mode",
                      "checked", "complete_add", "mesh_devices"}
    assert d["mesh_devices"] is None
    assert FrameworkConfig(mesh_devices=4).as_dict()["mesh_devices"] == 4


def test_from_env_leaves_mesh_devices(clean_env):
    # No variable: the JAX package's from_env leaves it None too.
    assert FrameworkConfig.from_env().mesh_devices is None
    assert JaxConfig.from_env().mesh_devices is None
    FrameworkConfig(mesh_devices=2, checked=True).apply()
    assert FrameworkConfig.from_env().mesh_devices is None


def test_make_mesh_over_one_rank(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = FrameworkConfig(device="cpu").make_mesh()
        assert (mesh.device_type, mesh.mesh_dim_names, mesh.size()) == \
            ("cpu", ("shard",), 1)
        assert FrameworkConfig(device="cpu", mesh_devices=1).make_mesh() \
            .size() == 1
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            FrameworkConfig(device="cpu", mesh_devices=2).make_mesh()
    finally:
        dist.destroy_process_group()


def test_make_kzg_host_and_cpu_device():
    kzg = FrameworkConfig(backend="host", rng_seed=11).make_kzg()
    assert (kzg.curve_type, kzg.backend) == ("bn254", "host")
    cfg = FrameworkConfig(curve="bls12_381", device="cpu", rng_seed=3)
    kzg = cfg.make_kzg()
    assert (kzg.curve_type, kzg.backend, kzg.device) == \
        ("bls12_381", "cuda", "cpu")
    # The rng is the seed's: two makes draw the same values.
    Fr = kzg.Fq
    assert cfg.make_rng().random_element(Fr) == \
        cfg.make_rng().random_element(Fr)


def _counting(monkeypatch):
    """Count staged transforms and K10 launches of ops/ntt.py."""
    counts = {"staged": 0, "butterfly": 0}
    staged, butterfly = ntt_mod.staged_transform, ntt_mod.fr_butterfly

    def count_staged(*args):
        counts["staged"] += 1
        return staged(*args)

    def count_butterfly(*args):
        counts["butterfly"] += 1
        return butterfly(*args)
    monkeypatch.setattr(ntt_mod, "staged_transform", count_staged)
    monkeypatch.setattr(ntt_mod, "fr_butterfly", count_butterfly)
    return counts


def test_ntt_mode_read_at_call_time(clean_env):
    ctx = ntt_context("bn254", 16, "cpu")
    be = ctx.backend
    rng = np.random.default_rng(4)
    x = be.from_ints([int(v) for v in rng.integers(0, 1 << 62, 16)])
    counts = _counting(clean_env)
    want = ctx.ntt(x, mode="staged")
    assert counts == {"staged": 1, "butterfly": 0}
    for env, staged, butterfly in (("auto", 2, 0), ("staged", 3, 0),
                                   ("scan", 3, 4)):
        clean_env.setenv("KZG_TPU_NTT_MODE", env)
        assert torch.equal(ctx.ntt(x), want)
        assert counts == {"staged": staged, "butterfly": butterfly}
    clean_env.setenv("KZG_TPU_NTT_MODE", "scan")
    assert torch.equal(ctx.intt(ctx.ntt(x)), x)


@pytest.mark.parametrize("mode", ["unrolled", "gather", "bogus"])
def test_xla_only_ntt_modes_raise(clean_env, mode):
    ctx = ntt_context("bn254", 8, "cpu")
    x = ctx.backend.from_ints(range(8))
    clean_env.setenv("KZG_TPU_NTT_MODE", mode)
    with pytest.raises(ValueError, match=f"^KZG_TPU_NTT_MODE='{mode}': the "
                       "port's NTT modes are \\['auto', 'scan', 'staged'\\]"):
        ctx.ntt(x)
    with pytest.raises(ValueError, match=f"^mode '{mode}': the port's NTT "
                       "modes are \\['auto', 'scan', 'staged'\\]"):
        ctx.intt(x, mode=mode)


@pytest.mark.parametrize("mode", ["auto", "staged", "scan"])
def test_explicit_ntt_mode_means_the_env_mode(clean_env, mode):
    ctx = ntt_context("bn254", 16, "cpu")
    x = ctx.backend.from_ints(range(16))
    counts = _counting(clean_env)
    clean_env.setenv("KZG_TPU_NTT_MODE", mode)
    from_env = ctx.ntt(x)
    by_env = dict(counts)
    clean_env.setenv("KZG_TPU_NTT_MODE", "unrolled")     # ignored: explicit
    assert torch.equal(ctx.ntt(x, mode=mode), from_env)
    assert {k: 2 * v for k, v in by_env.items()} == counts


def test_complete_add_read_at_call_time(clean_env):
    assert resolve_complete(None) is False
    clean_env.setenv("KZG_TPU_COMPLETE_ADD", "on")
    assert resolve_complete(None) is True
    assert resolve_complete(False) is False
