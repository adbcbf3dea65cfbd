"""One configuration object for the port: the counterpart of the JAX
package's ``kzg_snark_tpu/config.py``.

:class:`FrameworkConfig` holds every knob the port reads.  The environment
variables stay the override mechanism, with the JAX package's spellings and
values, so a user's environment means the same thing to both packages::

    from kzg_snark_tpu_torch.config import FrameworkConfig

    cfg = FrameworkConfig(curve="bn254", backend="cuda", ntt_mode="staged",
                          checked=True, rng_seed=7)
    cfg.apply()                      # exports the env knobs in one place
    kzg = cfg.make_kzg()

``FrameworkConfig.from_env()`` round-trips: it reads the variables that
``apply()`` writes.

Knob map (field -> env var -> consumer):

=============  =====================  ==================================
field          env var                read by
=============  =====================  ==================================
ntt_mode       KZG_TPU_NTT_MODE       ops/ntt.NttContext (mode=None)
checked        KZG_TPU_CHECKED        ops/fr.fr_backend / fq_backend (the
                                      checked backend), the contexts
                                      cached on a backend, the PLONK rounds
complete_add   KZG_TPU_COMPLETE_ADD   ops/msm_kernel.resolve_complete
=============  =====================  ==================================

Each consumer reads its variable at call time, never at construction:
the backends and contexts are cached, and the checked flag is part of
their cache keys.  ``curve``, ``backend``, ``device``, ``rng_seed`` and
``mesh_devices`` have no variable: they parameterize :meth:`make_kzg`,
:meth:`make_rng` and :meth:`make_mesh` (the one-axis mesh of
``parallel/mesh.py`` over the first ``mesh_devices`` ranks of the
initialized process group, all of them when None, on ``device``'s type).

The JAX-only knobs have no counterpart here: ``pallas`` (every field op is
a CUDA kernel on the card), ``cache_dir`` and ``cache_force`` (the kernels'
build cache ``.build/torch_kernels/`` plays the part of the XLA cache),
``runslow`` (the port has no conftest of its own) and the two bench knobs
(the port has no bench).
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass

TRUE = ("1", "true", "on")

NTT_MODE_VAR = "KZG_TPU_NTT_MODE"
CHECKED_VAR = "KZG_TPU_CHECKED"
COMPLETE_ADD_VAR = "KZG_TPU_COMPLETE_ADD"


def env_ntt_mode() -> str:
    """KZG_TPU_NTT_MODE as set now ("auto" when unset)."""
    return os.environ.get(NTT_MODE_VAR, "auto")


def checked_enabled() -> bool:
    """KZG_TPU_CHECKED is on now ("1", "true" or "on"); the JAX package's
    ``ops/fr.checked_enabled``, which ``ops/fr`` re-exports."""
    return os.environ.get(CHECKED_VAR, "0") in TRUE


def env_complete_add() -> bool:
    """KZG_TPU_COMPLETE_ADD is on now ("1", "true" or "on")."""
    return os.environ.get(COMPLETE_ADD_VAR, "0") in TRUE


@dataclass
class FrameworkConfig:
    # protocol-level
    curve: str = "bn254"              # "bn254" | "bls12_381"
    backend: str = "cuda"             # "host" (compat) | "cuda" (kernels)
    device: str = "cuda"              # where the "cuda" backend computes
    rng_seed: int | None = None

    # kernel knobs
    ntt_mode: str = "auto"            # "auto" | "staged" | "scan"
    checked: bool = False             # validate every kernel output
    complete_add: bool = False        # complete (doubling-safe) MSM adds

    # distribution
    mesh_devices: int | None = None   # 1-axis mesh size (None = all ranks)

    @classmethod
    def from_env(cls) -> "FrameworkConfig":
        return cls(ntt_mode=env_ntt_mode(), checked=checked_enabled(),
                   complete_add=env_complete_add())

    def apply(self) -> "FrameworkConfig":
        """Export the knobs to the variables every consumer reads.  Fields
        left at their defaults still overwrite stale values: apply() makes
        the config object the truth."""
        os.environ[NTT_MODE_VAR] = self.ntt_mode
        os.environ[CHECKED_VAR] = "1" if self.checked else "0"
        os.environ[COMPLETE_ADD_VAR] = "1" if self.complete_add else "0"
        return self

    def make_rng(self):
        from .rng import Rng
        return Rng(self.rng_seed) if self.rng_seed is not None else Rng()

    def make_kzg(self, **kwargs):
        """KZG instance with this config's curve, backend, device and rng."""
        from .models.kzg import KZG
        kwargs.setdefault("rng", self.make_rng())
        return KZG(self.curve, backend=self.backend, device=self.device,
                   **kwargs)

    def make_mesh(self):
        """The one-axis ("shard",) mesh over ``mesh_devices`` ranks of the
        initialized process group, on ``device``'s type."""
        import torch
        from .parallel.mesh import make_mesh
        return make_mesh(self.mesh_devices, torch.device(self.device).type)

    def as_dict(self) -> dict:
        return asdict(self)
