"""KZG, Marlin and PLONK demos of the port:

    python -m kzg_snark_tpu_torch [--demo kzg|marlin|plonk|all] [--seed N]
        [--backend host|cuda] [--device cuda|cpu] [--timing]
        [--fixtures DIR | --synthetic LOG2N]

The counterpart of the JAX package's ``main.py``: the three demos back to
back, each isolated (a failed demo prints ``<name> demo failed: ...``), exit
code 0 only if every selected demo printed PASS.  ``--backend cuda`` (the
default) proves on the card with the port's kernels (``--device cpu`` runs
their plain versions, for tests); ``host`` is the exact host path.  Proofs
are verified on the host either way.

Circuits: ``--fixtures DIR`` (no default) holds the reference's pickles
``R1CS_INSTANCE.pkl`` and ``PLONK_ARITHMETIZATION_INSTANCE.pkl``;
``--synthetic LOG2N`` takes the synthetic circuits at 2^LOG2N instead:
Marlin on ``utils/fixtures.synthetic_r1cs``, PLONK on the mul-gate circuit
of the benchmarks (a_i = i + 2, b_i = i + 3, c_i = a_i b_i, identity
permutation).  With neither, the Marlin and PLONK demos fail by name.

Objects are built through ``FrameworkConfig.from_env()``, so the
environment's knobs hold (``KZG_TPU_CHECKED=1`` runs checked).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from .config import FrameworkConfig

PUBLIC_INPUTS = 5       # public inputs of the Marlin and PLONK instances


def _rng(cfg: FrameworkConfig, offset: int):
    return dataclasses.replace(cfg, rng_seed=cfg.rng_seed + offset).make_rng()


def _fixture(args, name: str) -> str:
    """The path of the fixture pickle ``name`` in ``--fixtures``."""
    if args.fixtures is None:
        raise FileNotFoundError(f"{name}: pass --fixtures DIR or "
                                "--synthetic LOG2N")
    return os.path.join(args.fixtures, name)


def _mul_gate_circuit(Fr, n: int):
    """The benchmarks' PLONK circuit at n gates: qM = 1, qO = -1, the rest
    0; no public inputs."""
    one, zero = Fr(1), Fr(0)
    a = [Fr(i + 2) for i in range(n)]
    b = [Fr(i + 3) for i in range(n)]
    c = [x * y for x, y in zip(a, b)]
    return ([one] * n, [zero] * n, [zero] * n, [-one] * n, [zero] * n,
            list(range(3 * n)), [], a + b + c)


def demo_kzg(cfg: FrameworkConfig, args) -> bool:
    """KZG commit, open and check on two small polynomials."""
    print("=== KZG Polynomial Commitment Demo ===")
    from .ops.host.poly import Poly

    kzg = cfg.make_kzg()
    ck, rk = kzg.setup(max_degree=10)
    F = kzg.Fq
    polys = [Poly(F, [1, 2, 3]), Poly(F, [4, 0, 0, 5])]  # 1+2X+3X^2, 4+5X^3
    commitments = kzg.commit(ck, polys)
    z, xi = 7, 42
    proof = kzg.open(ck, polys, z, xi)
    evals = [p(z) for p in polys]
    result = kzg.check(rk, commitments, z, evals, proof, xi)
    print(f"KZG verification: {'PASS' if result else 'FAIL'}\n")
    return result


def demo_marlin(cfg: FrameworkConfig, args) -> bool:
    """Marlin end to end on the R1CS fixture or the synthetic R1CS."""
    print("=== Marlin SNARK Demo ===")
    from .models.marlin.verifier import Verifier
    from .utils.fixtures import load_r1cs, synthetic_r1cs

    if args.synthetic is None:
        inst = load_r1cs(_fixture(args, "R1CS_INSTANCE.pkl"), cfg.curve)
        A, B, C, z = inst.A, inst.B, inst.C, inst.z
        max_degree = 200
    else:
        A, B, C, z = synthetic_r1cs(1 << args.synthetic,
                                    curve_type=cfg.curve)
        max_degree = 6 * len(A.nonzero_positions())
    x, w = z[:PUBLIC_INPUTS], z[PUBLIC_INPUTS:]
    if cfg.backend == "cuda":
        from .models.marlin.device import DeviceProver
        ipk, ivk = DeviceProver(cfg.curve, rng=_rng(cfg, 0),
                                device=cfg.device).preprocess(A, B, C,
                                                              max_degree)
        proof = DeviceProver(cfg.curve, rng=_rng(cfg, 1),
                             device=cfg.device).prove(ipk, x, w)
    else:
        from .models.marlin.indexer import Indexer
        from .models.marlin.prover import Prover
        ipk, ivk = Indexer(cfg.curve, backend="host",
                           rng=_rng(cfg, 0)).preprocess(A, B, C, max_degree)
        proof = Prover(cfg.curve, backend="host",
                       rng=_rng(cfg, 1)).prove(ipk, x, w)
    result = Verifier(cfg.curve, rng=_rng(cfg, 2)).verify(ivk, x, proof)
    print(f"Marlin verification: {'PASS' if result else 'FAIL'}\n")
    return result


def demo_plonk(cfg: FrameworkConfig, args) -> bool:
    """PLONK end to end on the arithmetization fixture or the synthetic
    mul-gate circuit."""
    print("=== PLONK SNARK Demo ===")
    from .models.plonk.verifier import Verifier
    from .ops.host.field import scalar_field
    from .utils.fixtures import load_plonk

    if args.synthetic is None:
        inst = load_plonk(_fixture(args,
                                   "PLONK_ARITHMETIZATION_INSTANCE.pkl"),
                          cfg.curve)
        selectors = (inst.qM, inst.qL, inst.qR, inst.qO, inst.qC, inst.perm)
        x, w = inst.w[:PUBLIC_INPUTS], inst.w[PUBLIC_INPUTS:]
    else:
        *selectors, x, w = _mul_gate_circuit(scalar_field(cfg.curve),
                                             1 << args.synthetic)
    n = len(selectors[0])
    if cfg.backend == "cuda":
        from .models.plonk.device import DeviceProver
        ipk, ivk = DeviceProver(cfg.curve, rng=_rng(cfg, 0),
                                device=cfg.device).preprocess(
            *selectors, max_degree=n + 5)
        proof = DeviceProver(cfg.curve, rng=_rng(cfg, 1),
                             device=cfg.device).prove(ipk, x, w)
    else:
        from .models.plonk.indexer import Indexer
        from .models.plonk.prover import Prover
        ipk, ivk = Indexer(cfg.curve, backend="host",
                           rng=_rng(cfg, 0)).preprocess(*selectors,
                                                        max_degree=n + 5)
        proof = Prover(cfg.curve, backend="host",
                       rng=_rng(cfg, 1)).prove(ipk, x, w)
    result = Verifier(cfg.curve, rng=_rng(cfg, 2)).verify(ivk, x, proof)
    print(f"PLONK verification: {'PASS' if result else 'FAIL'}\n")
    return result


DEMOS = {"kzg": demo_kzg, "marlin": demo_marlin, "plonk": demo_plonk}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kzg_snark_tpu_torch",
        description="KZG, Marlin and PLONK demos of the PyTorch + CUDA port")
    parser.add_argument("--backend", choices=["host", "cuda"], default="cuda",
                        help="cuda = the port's kernels (default); host = "
                             "the exact host path")
    parser.add_argument("--device", default="cuda",
                        help="where the cuda backend computes (default "
                             "cuda; cpu runs the kernels' plain versions)")
    parser.add_argument("--seed", type=int, default=None,
                        help="deterministic randomness seed (default: the "
                             "clock)")
    parser.add_argument("--demo", choices=[*DEMOS, "all"], default="all")
    parser.add_argument("--timing", action="store_true",
                        help="print the per-demo wall-time report")
    parser.add_argument("--fixtures", metavar="DIR",
                        help="directory of the reference's fixture pickles")
    parser.add_argument("--synthetic", type=int, metavar="LOG2N",
                        help="prove the synthetic circuits at 2^LOG2N "
                             "instead of the fixtures")
    args = parser.parse_args(argv)
    seed = args.seed if args.seed is not None else int(time.time())
    cfg = dataclasses.replace(FrameworkConfig.from_env(),
                              backend=args.backend, device=args.device,
                              rng_seed=seed)

    print("Running KZG-SNARK demonstrations...\n")
    from .utils.profiling import PhaseTimer
    timer = PhaseTimer()
    results = {}
    selected = list(DEMOS) if args.demo == "all" else [args.demo]
    for name in selected:
        try:
            with timer.phase(name):
                results[name] = DEMOS[name](cfg, args)
        except Exception as e:  # isolate each demo, as main.py does
            print(f"{name} demo failed: {type(e).__name__}: {e}\n")
            results[name] = False

    if args.timing:
        print("Timing report:")
        print(timer.dump())
    print("Demo complete!")
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
