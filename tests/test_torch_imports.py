"""The port runs without JAX.

A fresh interpreter in which ``import jax`` fails imports every module of
``kzg_snark_tpu_torch`` and proves the n = 16 synthetic circuit on the CPU;
the host verifier accepts the proof.  The card's machine has no JAX, so
this is the check that the port needs none.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
import kzg_snark_tpu_torch
for mod in pkgutil.walk_packages(kzg_snark_tpu_torch.__path__,
                                 "kzg_snark_tpu_torch."):
    importlib.import_module(mod.name)

from kzg_snark_tpu.models.plonk.verifier import Verifier
from kzg_snark_tpu.ops.host.field import scalar_field
from kzg_snark_tpu.rng import Rng
from kzg_snark_tpu_torch.models.plonk.device import DeviceProver

Fr = scalar_field("bn254")
n = 16
one, zero = Fr(1), Fr(0)
a = [Fr(i + 2) for i in range(n)]
b = [Fr(i + 3) for i in range(n)]
w = a + b + [x * y for x, y in zip(a, b)]
prover = DeviceProver("bn254", rng=Rng(77), device="cpu")
ipk, ivk = prover.preprocess([one] * n, [zero] * n, [zero] * n, [-one] * n,
                             [zero] * n, list(range(3 * n)),
                             max_degree=n + 5, tau=0xABCDEF12345)
proof = prover.prove(ipk, [], w)
assert Verifier("bn254", rng=Rng(78)).verify(ivk, [], proof)
assert sys.modules["jax"] is None
print("PROVED WITHOUT JAX")
"""


def test_port_proves_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", PROGRAM], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PROVED WITHOUT JAX" in proc.stdout


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b")
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
