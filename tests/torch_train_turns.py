"""The train phase's step time on the card for one or more trees of the
port, in turns.

    python tests/torch_train_turns.py [--tree DIR ...] [--windows N]

Each ``--tree`` is a directory holding an ``eitx_torch`` package (the
repository root by default; another commit unpacked with ``git archive
<commit> eitx_torch``). Every tree runs in its own process, in the order
given, so parent, change, change, parent compares two trees on one card.
A tree's process does what chip_smoke.py's train phase times: the
YOLOv11-n segmenter at train_tissue's 512 defaults on a store of 32
phantoms labelled on the card, ``Trainer(cfg, seed=0)``,
``device_batches(store, 8, seed=0)``, 3 warm-up steps, then ``--windows``
windows of 20 steps through ``fit`` (ms a step between two CUDA events),
then 5 steps under torch.profiler (wall, device busy time, idle share,
the 20 device kernels with the most time);
the rib detector at 640 (batch 4), 2 warm-up steps and 10 timed. It also
times building each trainer (host wall, the initial parameters included)
and the untrained YOLOv11-s segmenter. Prints one JSON line a tree (with
the card's name and power limit) and one with the medians.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(tree: str, windows: int, device: str = "cuda") -> dict:
    """Runs in the tree's own process (``--one``)."""
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    import eitx_torch
    from eitx_torch.models.yolo.infer import TissueSegmenter
    from eitx_torch.train import TrainConfig, Trainer
    from eitx_torch.train.data import device_batches
    from eitx_torch.train.phantoms import phantom_batch, rib_batch
    from eitx_torch.train.trainer import fit

    dev = torch.device(device)

    def built(make):
        t0 = time.perf_counter()
        out = make()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    store = phantom_batch(cs.TRAIN_SEG_STORE, cs.TRAIN_SEG["imgsz"],
                          cs.TRAIN_SEG["max_instances"],
                          np.random.default_rng(0),
                          mask_res=cs.TRAIN_MASK_RES, store_u8=True,
                          device=dev)
    trainer, trainer_s = built(lambda: Trainer(
        TrainConfig(**cs.TRAIN_SEG), seed=0, device=dev))
    stream = device_batches(store, cs.TRAIN_SEG_BATCH, seed=0, device=dev)
    for _ in range(3):
        trainer.train_step(next(stream))
    torch.cuda.synchronize()
    step_ms = [cs._timed_steps(lambda: fit(trainer, stream, 20,
                                           log_every=0), 20)[0]
               for _ in range(windows)]
    prof = cs.profiled_request(lambda: [
        trainer.train_step(next(stream), device_metrics=True)
        for _ in range(5)], top=20)
    ribs = rib_batch(cs.TRAIN_RIBS_STORE, cs.TRAIN_RIBS["imgsz"],
                     cs.TRAIN_RIBS["max_instances"], np.random.default_rng(0))
    rtrainer, rtrainer_s = built(lambda: Trainer(
        TrainConfig(**cs.TRAIN_RIBS), seed=0, device=dev))
    rstream = device_batches(ribs, cs.TRAIN_RIBS_BATCH, seed=0, device=dev)
    for _ in range(2):
        rtrainer.train_step(next(rstream))
    torch.cuda.synchronize()
    rstep_ms = cs._timed_steps(lambda: fit(rtrainer, rstream, 10,
                                           log_every=0), 10)[0]
    _, seg_s = built(lambda: TissueSegmenter(512, max_det=64,
                                             dtype="bfloat16", device=dev))
    return dict(tree=os.path.abspath(tree), package=eitx_torch.__file__,
                step_ms=step_ms, step_ms_median=float(np.median(step_ms)),
                profile_5_steps={k: prof[k] for k in (
                    "wall_ms", "device_busy_ms", "idle_share",
                    "top_kernels_ms")},
                ribs_step_ms=rstep_ms, trainer_build_s=trainer_s,
                ribs_trainer_build_s=rtrainer_s, segmenter_s_build_s=seg_s,
                card=cs.gpu_name_and_limit())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a directory holding eitx_torch (repeatable)")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.one, args.windows, args.device)),
              flush=True)
        return 0
    medians = {}
    for tree in args.tree or [ROOT]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, "--windows", str(args.windows)],
                           capture_output=True, text=True, cwd=ROOT)
        if r.returncode:
            sys.stderr.write(r.stdout + r.stderr)
            return r.returncode
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        medians.setdefault(os.path.abspath(tree), []).append(
            json.loads(line)["step_ms_median"])
    print(json.dumps({"step_ms_medians": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
