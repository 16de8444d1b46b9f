"""The readings the output check's limits are set from, on the card.

    python3 -m odebench.calibrate --workload <cell> --seeds 12 [--control 3]
                                  [--seconds 3] [--first-seed N]

For each of ``--seeds`` seeds, one run of the cell with a short window at
the cell's own load (``run.run_cell``, untraced): the port's numbers (the
lower readings). Then, for ``--control`` seeds, the control in the port's
place on the same calls the check judges (the first ``check_calls``
calls of the pool): the reference in TF32 (the upper readings). One
process, so set-up is paid once for the port's build and CUDA start.
Prints one line per reading and a JSON summary last. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import manifest
from .run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load()
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    port, control = {}, {}
    for seed in seeds:
        cell = manifest.cell(bench, args.workload)
        line, _ = run_cell(cell, seed, args.seconds, False, "cuda")
        port[seed] = {k: v["value"] for k, v in line["checks"].items()}
        print(f"[calibrate] {args.workload} port seed {seed}: {port[seed]}, "
              f"calls {line['attempted'] // cell.mix['batch']}", flush=True)
    for seed in seeds[:args.control]:
        cell = manifest.cell(bench, args.workload)
        conf = cell.config
        system = manifest.module("systems", conf["system"]).build(
            conf, cell.mix, seed, "cuda")
        system.stepper = None
        kept = [(i, None) for i in range(cell.mix["check_calls"])]
        ref = manifest.module("references", conf["reference"])
        control[seed] = ref.check_numbers(system, kept, control=True)
        print(f"[calibrate] {args.workload} control seed {seed}: "
              f"{control[seed]}", flush=True)
    print(json.dumps({"workload": args.workload, "port": port,
                      "control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
