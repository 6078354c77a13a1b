"""chip_smoke.py's card-vs-CPU training step over several seeds, on the card.

    python tests/torch_card_vs_cpu.py [--seeds 1 2 3 ...]

The train phase holds one ``train_step`` on the card to the same step on
the CPU (TF32 off) and reads the same step with TF32 on as a control
(``chip_smoke.step_card_vs_cpu``), for one seed and one batch. This tool
reads that comparison for each seed given: ``Trainer(cfg, seed)`` at
train_tissue's 512 defaults (the train phase's ``TRAIN_SEG``) on two images
of the seed-th batch of the train phase's stream (a store of 32 phantoms
labelled on the card, ``device_batches(store, 8, seed=0)``). Prints one
JSON line a seed, then one with the largest readings beside chip_smoke.py's
bounds and the card's name and power limit.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",  # 1 and up
                    default=[1, 2, 3, 4, 5, 6, 7, 8])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from eitx_torch.train import TrainConfig
    from eitx_torch.train.data import device_batches
    from eitx_torch.train.phantoms import phantom_batch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = TrainConfig(**cs.TRAIN_SEG)
    store = phantom_batch(cs.TRAIN_SEG_STORE, cs.TRAIN_SEG["imgsz"],
                          cs.TRAIN_SEG["max_instances"],
                          np.random.default_rng(0),
                          mask_res=cs.TRAIN_MASK_RES, store_u8=True,
                          device=dev)
    stream = device_batches(store, cs.TRAIN_SEG_BATCH, seed=0, device=dev)
    batches = [next(stream) for _ in range(max(args.seeds))]
    worst = {"loss_rel": 0.0, "batch_stats_of_scale": 0.0,
             "tf32_loss_rel_least": float("inf"),
             "tf32_batch_stats_of_scale_least": float("inf")}
    for seed in args.seeds:
        r = cs.step_card_vs_cpu(
            cfg, {k: v[:2] for k, v in batches[seed - 1].items()}, seed, dev)
        print(json.dumps(dict(seed=seed, batch=seed, **r)), flush=True)
        tf32 = r["tf32_control"]
        worst["loss_rel"] = max(worst["loss_rel"], max(r["loss_rel"].values()))
        worst["batch_stats_of_scale"] = max(worst["batch_stats_of_scale"],
                                            r["batch_stats_of_scale"])
        worst["tf32_loss_rel_least"] = min(worst["tf32_loss_rel_least"],
                                           max(tf32["loss_rel"].values()))
        worst["tf32_batch_stats_of_scale_least"] = min(
            worst["tf32_batch_stats_of_scale_least"],
            tf32["batch_stats_of_scale"])
    print(json.dumps(dict(
        seeds=args.seeds, **worst,
        loss_rtol_bound=cs.CARD_VS_CPU_LOSS_RTOL,
        stats_bound=cs.TRAIN_STATS_OF_SCALE, card=cs.gpu_name_and_limit())),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
