"""Readings of a cell's compared numbers over many seeds, in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seconds 2 \\
        --seeds 11,12,13 --variants sound,tf32,answer_altered

Runs the cell as ``run.py`` does (set-up, a window of ``--seconds``, the
comparison) once a seed and variant, on the card, and prints one JSON line
a run and then, for each variant, every number's largest and smallest
reading. ``sound`` is the program as it stands; ``tf32`` is the control
(the program with TF32 switched on, the precision below the float32 the
configurations state); the other variants are the faults the cell's
driver can plant. The sound runs go first: a control's setting stays on
in the process. These are the readings the limits in
``workloads/<cell>.json`` were set from (PERF.md gives them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="sound")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run._environment()
    import torch

    from benchmark.lib.manifest import Cell, manifest

    cell = Cell(args.workload, manifest())
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    variants = args.variants.split(",")
    if "tf32" in variants:  # the control last: its setting stays on
        variants = [v for v in variants if v != "tf32"] + ["tf32"]
    spread = {}
    for variant in variants:
        for seed in seeds:
            r = run.run_cell(cell, seed, args.seconds, False, device,
                             variant=variant)
            nums = {k: c["value"] for k, c in r["checks"].items()}
            print(json.dumps({"variant": variant, "seed": seed,
                              "correct": r["correct"], "numbers": nums,
                              "metrics": r["metrics"],
                              "memory_peak_bytes":
                                  r["device"]["memory_peak_bytes"]}),
                  flush=True)
            for k, v in nums.items():
                lo, hi = spread.get((variant, k), (v, v))
                spread[(variant, k)] = (min(lo, v), max(hi, v))
    for (variant, k), (lo, hi) in sorted(spread.items()):
        print(json.dumps({"summary": variant, "number": k, "min": lo,
                          "max": hi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
