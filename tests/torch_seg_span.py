"""The ``segmentation`` span of ``run_jpg_png`` at the serving config, on
the card, for one or more trees of the port.

    python tests/torch_seg_span.py [--tree DIR ...] [--requests N]

Each ``--tree`` is a directory holding an ``eitx_torch`` package (the
repository root by default; another commit unpacked with ``git
archive <commit> eitx_torch``). Every tree runs in its own process, in
the order given, so parent, change, change, parent compares two trees on
one card. A tree's process builds the serving ``Pipeline`` (trained
``tissue_n_512``, bfloat16, per-class conf, 4 flip views) and sends
``--requests`` ``run_jpg_png`` requests of the 512² slice of
``tests/data/torch_smoke_512.npz``; the first is a warm-up. Prints one
JSON line a tree (the span of each warm request in ms, their median and
minimum, the card's name and power limit) and one with the medians.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(tree: str, requests: int) -> dict:
    """Runs in the tree's own process (``--one``)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from eitx_torch.core.config import ModelConfig, PipelineConfig
    from eitx_torch.core.timing import Timer
    from eitx_torch.pipeline import Pipeline

    image = np.load(os.path.join(ROOT, "tests", "data",
                                 "torch_smoke_512.npz"))["image"]
    spans = []
    with tempfile.TemporaryDirectory() as results:
        pipe = Pipeline(PipelineConfig(
            model=ModelConfig(axial_weights_512=os.path.join(
                ROOT, "weights", "tissue_n_512.msgpack")),
            results_dir=results), device="cuda")
        for _ in range(requests):
            timer = Timer()
            pipe.run_jpg_png(image, timer=timer)
            torch.cuda.synchronize()
            spans.append(timer.as_dict()["segmentation"] * 1e3)
    warm = sorted(spans[1:])
    import eitx_torch

    return dict(tree=os.path.abspath(tree), package=eitx_torch.__file__,
                segmentation_ms=spans[1:], median_ms=warm[len(warm) // 2],
                min_ms=warm[0], card=subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True).stdout.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a directory holding eitx_torch (repeatable)")
    ap.add_argument("--requests", type=int, default=11)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.one, args.requests)), flush=True)
        return 0
    medians = []
    for tree in args.tree or [ROOT]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, "--requests", str(args.requests)],
                           capture_output=True, text=True, cwd=ROOT)
        if r.returncode:
            sys.stderr.write(r.stdout + r.stderr)
            return r.returncode
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        medians.append((tree, json.loads(line)["median_ms"]))
    print(json.dumps({"median_ms": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
