"""Per-class serving-confidence sweep: the round-4 recall lever.

Port of eitx/scripts/eval_conf_sweep.py; the segmenter, the window and the
pseudo-labels run on ``device`` (``--device``, the card unless the caller
asks for the CPU).

Round 3 pinned the remaining OOD failures as recall-shaped: muscles lose
whole groups to background (only ~4% to confusion), and at one eval pose
a missing lung sits just under the global 0.3 threshold (conf 0.2
recovers lung 0.454 -> 0.927). Four training-side levers (wp2, mosaic
x3, cls-w) all closed as axis-trading negatives — so this sweep attacks
the thresholds directly at serving time, per class, with the checkpoint
unchanged (ModelConfig.axial_conf_per_class; reference conf semantics:
ai_tools.py:129-158, preserved by the scalar default).

For each candidate setting it scores, against the serving scalar-0.3
baseline:
  - OOD fixture crisp (3 seeds), posed (6 transforms), pv1.5 blur
  - phantom clean + anatomy distributions (giveback guard: a lowered
    threshold must not flood phantoms with false positives)

Usage: python -m eitx_torch.scripts.eval_conf_sweep [--sizes 256,512]
           [--settings "0.3,0.2,0.2,0.3;0.3,0.3,0.2,0.3"] [--report f]
           [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

_CLASS_NAMES = ("bone", "muscles", "lung", "fat")


def sweep_one(size: int, weights: str, conf, seeds: int = 3,
              transforms: int = 6, pv_sigma: float = 1.5,
              max_det: int = 64, nms_iou: float = 0.45,
              tta_fill: bool = False, device="cuda") -> dict:
    from ..models.yolo.infer import TissueSegmenter
    from .eval_ood_fixture import evaluate_ood, fixture_transform
    from .train_tissue import evaluate_checkpoint

    seg = TissueSegmenter(imgsz=size, weights=weights, variant="n",
                          max_det=max_det, iou=nms_iou, conf=conf,
                          tta_fill=tta_fill, device=device)
    crisp = [evaluate_ood(size, seed=5 + k, seg=seg) for k in range(seeds)]
    posed = [evaluate_ood(size, seed=5 + k, seg=seg,
                          transform=fixture_transform(k))
             for k in range(transforms)]
    pv = [evaluate_ood(size, seed=5 + k, pv_sigma=pv_sigma, seg=seg)
          for k in range(seeds)]
    macros = [r["macro_iou"] for r in posed]

    def _mean_per_class(runs):
        return {n: round(float(np.mean(
            [r["per_class_iou"][n] for r in runs])), 4)
            for n in _CLASS_NAMES}

    out = {
        "conf": conf if isinstance(conf, float) else list(conf),
        "max_det": max_det,
        "nms_iou": nms_iou,
        "tta_fill": tta_fill,
        "crisp_macro_iou": round(
            float(np.mean([r["macro_iou"] for r in crisp])), 4),
        "crisp_per_class_iou": _mean_per_class(crisp),
        "posed_macro_mean": round(float(np.mean(macros)), 4),
        "posed_macro_min": round(float(np.min(macros)), 4),
        "posed_per_class_iou": _mean_per_class(posed),
        "posed_per_class_min": {
            n: round(float(np.min([r["per_class_iou"][n] for r in posed])),
                     4)
            for n in _CLASS_NAMES
        },
        "pv15_macro_iou": round(
            float(np.mean([r["macro_iou"] for r in pv])), 4),
        # phantom giveback guard (clean seed, NOT any training stream)
        "phantom_clean_macro_iou": evaluate_checkpoint(
            weights, size, "n", n_eval=32, seed=424242, conf=conf,
            nms_iou=nms_iou, tta_fill=tta_fill, device=device,
        )["macro_iou"],
        "phantom_anatomy_macro_iou": evaluate_checkpoint(
            weights, size, "n", n_eval=32, seed=424242, anatomy=True,
            conf=conf, max_det=max_det if max_det != 64 else None,
            nms_iou=nms_iou, tta_fill=tta_fill, device=device,
        )["macro_iou"],
    }
    return out


def main(argv=None):
    from ..core.weights import find_checkpoint

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", default="256,512")
    p.add_argument("--settings",
                   default="0.3,0.3,0.2,0.3;0.3,0.2,0.2,0.3;"
                           "0.3,0.15,0.15,0.3")
    p.add_argument("--baseline", action="store_true",
                   help="also score the scalar-0.3 baseline through the "
                        "same protocol (same seeds) for the comparison "
                        "table")
    p.add_argument("--max-det", type=int, default=64,
                   help="NMS detection budget (proposal-vs-budget probe)")
    p.add_argument("--nms-iou", type=float, default=0.45)
    p.add_argument("--tta-fill", action="store_true",
                   help="hflip TTA with background-fill-only merge")
    p.add_argument("--tta-views", type=int, default=0,
                   help="explicit TTA view count (2 = +hflip, 3 = "
                        "+vflip); overrides --tta-fill")
    p.add_argument("--report", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    tta = args.tta_views or args.tta_fill
    out = {}
    for size in (int(s) for s in args.sizes.split(",")):
        w = find_checkpoint("tissue", size)
        if w is None:
            continue
        runs = []
        if args.baseline:
            runs.append(sweep_one(size, w, 0.3, max_det=args.max_det,
                                  nms_iou=args.nms_iou, tta_fill=tta,
                                  device=args.device))
        for setting in args.settings.split(";"):
            conf = tuple(float(c) for c in setting.split(","))
            runs.append(sweep_one(size, w, conf, max_det=args.max_det,
                                  nms_iou=args.nms_iou, tta_fill=tta,
                                  device=args.device))
        out[str(size)] = {
            "checkpoint": os.path.basename(w),
            "runs": runs,
        }
        print(json.dumps({str(size): out[str(size)]}), flush=True)
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
