"""Import isolation, each in a fresh process: the harness loads neither
``jax`` nor the JAX package (whole top-level names), and the reference loads
nothing of the program either."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _loaded(stmt: str) -> list:
    code = (f"import sys, json\n{stmt}\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    tops = _loaded("import kzgbench.run, kzgbench.harness, kzgbench.control,"
                   " kzgbench.protocols.blob, kzgbench.protocols.multi_open")
    assert "kzg_snark_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "kzg_snark_tpu"} & set(tops)


def test_reference_loads_no_program():
    tops = _loaded("import kzgbench.plain.reference, kzgbench.plain.blob, "
                   "kzgbench.plain.multi_open, kzgbench.roofline, "
                   "kzgbench.trace")
    assert not {"jax", "jaxlib", "flax", "kzg_snark_tpu",
                "kzg_snark_tpu_torch"} & set(tops)
