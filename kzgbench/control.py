"""The control and the planted faults: runs that must come out not correct.

    python3 -m kzgbench.control --workload <name> --seeds <s> [<s> ...] \
        --seconds <s> [--plants control,stale_state,half_batch,answer]

Each plant breaks the timed path underneath the harness after the warm-up,
and the run's check must then read ``correct`` false:

* ``control``: the program with the MSM's scalars cut to 248 bits (the
  top window dropped), the shortcut nearest to "a lower precision" that
  exact field arithmetic has: it breaks the guarantee that a commitment
  binds every bit of every coefficient;
* ``stale_state``: the iNTT returns its input unchanged (a step that
  returns its state unchanged);
* ``half_batch``: each k-set MSM computes the first half of its sets and
  returns their results for the other half too;
* ``answer``: the first evaluation of every batch altered by one where it
  is produced.

A cell on one chip has no exchange between chips to leave out.  The
benchmark's own runs never run these.  Prints one JSON line a run.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from kzgbench import harness  # noqa: E402

TOP_MASK = 0x00FFFFFF       # the top limb's low 24 bits: scalars below 2^248


def _patch(obj, name: str, fn):
    """Set ``obj.name = fn`` on the instance; return the undo."""
    had = name in obj.__dict__
    old = obj.__dict__.get(name)

    def undo():
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)
    setattr(obj, name, fn)
    return undo


def control(cell):
    orig = cell.ctx.msm

    def msm(points, scalars, complete=None):
        cut = scalars.clone()
        cut[..., 7, :] &= TOP_MASK
        return orig(points, cut, complete)
    return _patch(cell.ctx, "msm", msm)


def stale_state(cell):
    return _patch(cell.ntt, "intt", lambda evals, mode=None: evals)


def half_batch(cell):
    orig = cell.ctx.msm

    def msm(points, scalars, complete=None):
        if scalars.dim() != 3 or scalars.shape[0] < 2:
            return orig(points, scalars, complete)
        k = scalars.shape[0]
        head = orig(points, scalars[:(k + 1) // 2], complete)
        return torch.cat([head, head[..., :k // 2]], dim=-1)
    return _patch(cell.ctx, "msm", msm)


def answer(cell):
    orig = cell.core.eval_dev
    calls = [0]

    def eval_dev(coeffs, z):
        y = orig(coeffs, z)
        calls[0] += 1
        if calls[0] % cell.batch == 1 or cell.batch == 1:
            y = cell.be.add(y, cell.be.one_mont)
        return y
    return _patch(cell.core, "eval_dev", eval_dev)


PLANTS = {"control": control, "stale_state": stale_state,
          "half_batch": half_batch, "answer": answer}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kzgbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plants", default=",".join(PLANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kzgbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    failures = 0
    for seed in args.seeds:
        for name in args.plants.split(","):
            res = harness.run(args.workload, seed, args.seconds, False,
                              device, time.perf_counter(),
                              plant=PLANTS[name])
            line = res["line"]
            failures += line["correct"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "plant": name, "correct": line["correct"],
                              "attempted": line["attempted"],
                              "checks": res["checks"]}), flush=True)
    print(f"kzgbench.control: {failures} planted runs read correct",
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
