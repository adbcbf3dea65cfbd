"""The benchmark's command: one run of one cell, one JSON line.

    python3 -m kzgbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the chips the cell asks
for.  It builds nothing outside the checkout: the port's kernels go to
``.build/`` there and the trace of a ``--trace 1`` run to
``.kzgbench/trace/``.  Standard error ends with each number compared beside
its limit; the last line of standard output is the result.  It exits 2,
printing no result, without enough CUDA devices, and 3 if ``jax``, ``flax``
or the JAX package was loaded by the time the window closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Torch's own kernel caches, should anything use them, inside the checkout
# (the port builds its kernels into .build/ there).
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".build", sub)

import torch  # noqa: E402

T_TORCH = time.perf_counter()

from kzgbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kzgbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, _, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kzgbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_ask = time.perf_counter()
    torch.cuda.set_device(device)
    marks = {"python and torch": T_TORCH - T0,
             "the harness's imports and the cell's files": t_ask - T_TORCH,
             "the card's start": time.perf_counter() - t_ask}
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device, T0, marks=marks)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"kzgbench: the process loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    line = dict(result["line"])
    line["checks"] = result["checks"]
    for note in result["notes"]:
        print(f"kzgbench: {note}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
