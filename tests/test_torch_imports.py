"""The port runs without JAX and without the JAX package.

A fresh interpreter in which ``import jax`` and ``import kzg_snark_tpu``
both fail imports every module of ``kzg_snark_tpu_torch``, proves the
n = 16 PLONK circuit and the |H| = 16 Marlin circuit on the CPU, and the
port's own host verifiers accept both proofs.  The card's machine has no
JAX, and the port keeps its own host layer, so this is the check that it
needs neither.  A source scan forbids both imports in the port and in
``chip_smoke.py``.  A second interpreter, with the same two imports
blocked, imports the modules of the port's single-device surface by name
(config, fixtures, serialization, profiling, the entry point), makes a
host KZG through ``FrameworkConfig``, round-trips its SRS through a file
and runs the entry point's KZG demo on the host backend.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None              # any import of jax now raises
sys.modules["kzg_snark_tpu"] = None    # and any import of the JAX package
import torch
torch.set_num_threads(1)
import kzg_snark_tpu_torch
for mod in pkgutil.walk_packages(kzg_snark_tpu_torch.__path__,
                                 "kzg_snark_tpu_torch."):
    importlib.import_module(mod.name)

from kzg_snark_tpu_torch.models.marlin.device import DeviceProver as Marlin
from kzg_snark_tpu_torch.models.marlin.verifier import Verifier as MVerifier
from kzg_snark_tpu_torch.models.plonk.device import DeviceProver as Plonk
from kzg_snark_tpu_torch.models.plonk.verifier import Verifier as PVerifier
from kzg_snark_tpu_torch.ops.host.field import scalar_field
from kzg_snark_tpu_torch.rng import Rng
from kzg_snark_tpu_torch.utils.fixtures import synthetic_r1cs

Fr = scalar_field("bn254")
n = 16
one, zero = Fr(1), Fr(0)
a = [Fr(i + 2) for i in range(n)]
b = [Fr(i + 3) for i in range(n)]
w = a + b + [x * y for x, y in zip(a, b)]
prover = Plonk("bn254", rng=Rng(77), device="cpu")
ipk, ivk = prover.preprocess([one] * n, [zero] * n, [zero] * n, [-one] * n,
                             [zero] * n, list(range(3 * n)),
                             max_degree=n + 5, tau=0xABCDEF12345)
proof = prover.prove(ipk, [], w)
assert PVerifier("bn254", rng=Rng(78)).verify(ivk, [], proof)
print("PLONK PROVED WITHOUT JAX")

A, B, C, z = synthetic_r1cs(16)
keys = Marlin("bn254", rng=Rng(900), device="cpu").preprocess(
    A, B, C, 6 * 32, tau=0xFEED5EED)
proof = Marlin("bn254", rng=Rng(901), device="cpu").prove(keys[0], z[:5],
                                                           z[5:])
assert MVerifier("bn254", rng=Rng(902)).verify(keys[1], z[:5], proof)
assert sys.modules["jax"] is None and sys.modules["kzg_snark_tpu"] is None
print("MARLIN PROVED WITHOUT JAX")
"""


def test_port_proves_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PLONK PROVED WITHOUT JAX" in proc.stdout
    assert "MARLIN PROVED WITHOUT JAX" in proc.stdout


SURFACE = r"""
import sys, tempfile, os
sys.modules["jax"] = None
sys.modules["kzg_snark_tpu"] = None
import torch
torch.set_num_threads(1)
from kzg_snark_tpu_torch import __main__ as entry
from kzg_snark_tpu_torch.config import FrameworkConfig
from kzg_snark_tpu_torch.ops.fr import CheckedFieldBackend, validate_canonical
from kzg_snark_tpu_torch.utils import fixtures, profiling, serialization

kzg = FrameworkConfig(backend="host", rng_seed=11).make_kzg()
ck, rk = kzg.setup(4, tau=99)
path = os.path.join(tempfile.mkdtemp(), "srs.npz")
serialization.save_srs(path, kzg, ck, rk)
ck2, _ = serialization.load_srs(path, kzg)
assert [p[:2] for p in ck2][0] == tuple(ck[0][:2])
with profiling.PhaseTimer().phase("kzg"):
    assert entry.main(["--demo", "kzg", "--backend", "host",
                       "--seed", "3"]) == 0
assert sys.modules["jax"] is None and sys.modules["kzg_snark_tpu"] is None
print("SURFACE WITHOUT JAX")
"""


def test_surface_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SURFACE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SURFACE WITHOUT JAX" in proc.stdout
    assert "KZG verification: PASS" in proc.stdout


def test_no_jax_import_in_port_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|kzg_snark_tpu(\.|\s|$))")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "kzg_snark_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if pattern.match(line):
                    offenders.append(f"{path}:{i}")
    assert offenders == []
