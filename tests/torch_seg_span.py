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
``tests/data/torch_smoke_512.npz``; the first is a warm-up. It also
labels the slice with the serving segmenter in bfloat16 and in float32.
Prints one JSON line a tree (the span of each warm request in ms, their
median and minimum, the sha256 of each request's ``.dat`` and of both
label maps, the bfloat16 labels' agreement with the fixture's
``labels_bf16``, the card's name and power limit) and one with the
medians: two trees that serve alike print the same digests.
"""

import argparse
import hashlib
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
    from eitx_torch.models.yolo.infer import TissueSegmenter
    from eitx_torch.pipeline import Pipeline

    def sha(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    fixture = np.load(os.path.join(ROOT, "tests", "data",
                                   "torch_smoke_512.npz"))
    image = fixture["image"]
    weights = os.path.join(ROOT, "weights", "tissue_n_512.msgpack")
    spans, dats = [], []
    with tempfile.TemporaryDirectory() as results:
        pipe = Pipeline(PipelineConfig(
            model=ModelConfig(axial_weights_512=weights),
            results_dir=results), device="cuda")
        for _ in range(requests):
            timer = Timer()
            answer = pipe.run_jpg_png(image, timer=timer)
            torch.cuda.synchronize()
            spans.append(timer.as_dict()["segmentation"] * 1e3)
            with open(answer["saved_file_name"], "rb") as fh:
                dats.append(sha(fh.read()))
    m = ModelConfig()
    labels = {dtype: TissueSegmenter(
        512, weights=weights, conf=m.axial_conf_per_class,
        max_det=m.max_detections, tta_fill=m.axial_tta_fill, dtype=dtype,
        device="cuda").predict_labels(image)[0]
        for dtype in ("bfloat16", "float32")}
    warm = sorted(spans[1:])
    import eitx_torch

    return dict(tree=os.path.abspath(tree), package=eitx_torch.__file__,
                segmentation_ms=spans[1:], median_ms=warm[len(warm) // 2],
                min_ms=warm[0], dat_sha256=sorted(set(dats)),
                labels_sha256={k: sha(np.ascontiguousarray(v).tobytes())
                               for k, v in labels.items()},
                bf16_agreement=float((labels["bfloat16"]
                                      == fixture["labels_bf16"]).mean()),
                card=subprocess.run(
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
