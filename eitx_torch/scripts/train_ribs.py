"""Train the rib detector on synthetic frontal-view phantoms.

Port of eitx/scripts/train_ribs.py, with the same flags and outputs:
detect-only training (TrainConfig(segment=False)) on frontal rib
phantoms, the ``.train`` file, an EMA deployment checkpoint in the JAX
package's msgpack format (loadable by either package's
RibsDetector(weights=...)), and a held-out report: rib recall/precision
at IoU 0.5 plus an end-to-end slice-selection check through
select_axial_slice_number (the reference's between-ribs-6-and-7 rule,
utils.py:166-269). Everything runs on ``--device``: the card unless the
caller asks for the CPU.

Usage:
    python -m eitx_torch.scripts.train_ribs --steps 800 --batch 4 \
        --out weights/ribs_n_640.msgpack [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.clip(area_a[:, None] + area_b[None] - inter, 1e-9, None)


def evaluate_checkpoint(
    ckpt_path: str, imgsz: int, variant: str, n_eval: int = 16,
    seed: int = 991, hard: bool = False, n_negatives: int = 0,
    device="cuda",
) -> dict:
    """Held-out detection + end-to-end slice-selection evaluation.

    ``hard=True`` evaluates on the widened distribution (variable rib
    count/spacing/tilt, low contrast, dropped ribs — a distribution the
    model was NOT trained on, so the metric can fail). ``n_negatives``
    adds no-rib images where every detection counts as a false positive.
    The slice-selection check is scored as a pixel-error histogram of the
    predicted between-ribs-6-and-7 row vs the row computed from ground-
    truth boxes through the SAME reference rule (utils.py:260-264).
    """
    from ..models.yolo.infer import RibsDetector
    from ..select import select_axial_slice_number
    from ..train.phantoms import frontal_rib_phantom

    det = RibsDetector(weights=ckpt_path, imgsz=imgsz, variant=variant,
                       max_det=32, device=device)
    rng = np.random.default_rng(seed)
    tp = fp = fn = 0
    neg_fp = 0
    slice_errors = []
    slice_failures = 0  # GT selectable but prediction was not (or off)
    slice_cases = 0
    for i in range(n_eval + n_negatives):
        negative = i >= n_eval
        img, gt = frontal_rib_phantom(
            rng, imgsz, n_pairs=0 if negative else None, hard=hard
        )
        d = det.predict(img)
        pred = d.boxes[d.valid]
        if negative:
            neg_fp += pred.shape[0]
            continue
        if pred.shape[0] and gt.shape[0]:
            iou = _box_iou(pred, gt)
            matched_gt = set()
            for k in np.argsort(-d.scores[d.valid]):
                # best-IoU UNMATCHED ground truth (argmax over all GTs
                # would count a prediction as FP when its top overlap is
                # already taken even though another GT clears 0.5)
                order = np.argsort(-iou[k])
                j = next((int(j) for j in order if j not in matched_gt),
                         None)
                if j is not None and iou[k, j] >= 0.5:
                    matched_gt.add(j)
                    tp += 1
                else:
                    fp += 1
            fn += gt.shape[0] - len(matched_gt)
        else:
            fp += pred.shape[0]
            fn += gt.shape[0]
        # end-to-end: predicted selection row vs the row the reference
        # rule yields on the ground-truth boxes
        try:
            gt_sel = select_axial_slice_number(gt, 0, image_width=imgsz)
        except Exception:
            continue  # fewer than 7 right-side GT ribs: no defined target
        slice_cases += 1
        try:
            pred_sel = select_axial_slice_number(pred, 0, image_width=imgsz)
            slice_errors.append(abs(pred_sel[-1] - gt_sel[-1]))
        except Exception:
            slice_failures += 1
    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    errs = np.asarray(slice_errors, np.float64)
    hist_edges = [0, 2, 5, 10, 20, 50, np.inf]
    hist = {
        (f"<={hist_edges[k + 1]:g}px"
         if np.isfinite(hist_edges[k + 1]) else
         f">{hist_edges[k]:g}px"): int(
            ((errs > hist_edges[k]) & (errs <= hist_edges[k + 1])).sum()
            + (k == 0) * (errs == 0).sum()
        )
        for k in range(len(hist_edges) - 1)
    }
    out = {
        "distribution": "hard" if hard else "train-like",
        "rib_recall@0.5": round(recall, 4),
        "rib_precision@0.5": round(precision, 4),
        "slice_cases": slice_cases,
        "slice_selection_failures": slice_failures,
        "slice_error_median_px": (
            round(float(np.median(errs)), 1) if errs.size else None
        ),
        "slice_error_max_px": (
            round(float(errs.max()), 1) if errs.size else None
        ),
        "slice_error_hist_px": hist,
    }
    if n_negatives:
        out["negatives"] = n_negatives
        out["negative_false_positives"] = int(neg_fp)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="train rib detector in-repo")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--variant", default="n")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--n-train", type=int, default=192)
    p.add_argument("--out", default="weights/ribs_n_640.msgpack")
    p.add_argument("--eval-n", type=int, default=16)
    p.add_argument("--report", default=None)
    p.add_argument("--hard-frac", type=float, default=0.0,
                   help="fraction of training phantoms drawn from the "
                        "widened (hard) distribution")
    p.add_argument("--device", default="cuda",
                   help="where the network trains and is evaluated (cpu "
                        "only when asked)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("eitx_torch.train_ribs")

    from ..core.device import resolve_device
    from ..models.yolo.checkpoint import (
        torch_to_flax_tree,
        write_msgpack_checkpoint,
    )
    from ..train.checkpoint import save_checkpoint
    from ..train.phantoms import rib_batch
    from ..train.data import device_batches
    from ..train.trainer import TrainConfig, Trainer, fit

    device = resolve_device(args.device)
    t0 = time.time()
    log.info("pregenerating %d frontal phantoms...", args.n_train)
    rng = np.random.default_rng(0)
    data = rib_batch(args.n_train, args.imgsz, 24, rng,
                     hard_frac=args.hard_frac)
    log.info("data ready in %.1fs", time.time() - t0)

    cfg = TrainConfig(
        imgsz=args.imgsz, nc=1, variant=args.variant, lr=args.lr,
        total_steps=args.steps, warmup_steps=min(100, args.steps // 10),
        max_instances=24, segment=False,
    )
    trainer = Trainer(cfg, device=device)
    val = rib_batch(args.batch, args.imgsz, 24, np.random.default_rng(555))
    metrics, ema_params = fit(
        trainer,
        device_batches(data, args.batch, device=device),
        steps=args.steps,
        checkpoint_path=args.out + ".train",
        checkpoint_every=max(200, args.steps // 4),
        val_batch=val,
    )
    save_checkpoint(args.out + ".train", trainer.state)
    payload = {
        "params": torch_to_flax_tree(ema_params)[0],
        "batch_stats": torch_to_flax_tree(trainer.state.batch_stats)[1],
        "meta": {
            "variant": args.variant, "imgsz": args.imgsz, "nc": 1,
            "steps": args.steps, "final_loss": float(metrics["loss"]),
            "hard_frac": args.hard_frac,
        },
    }
    write_msgpack_checkpoint(args.out, payload)
    log.info("saved %s (train wall %.1fs)", args.out, time.time() - t0)

    report = evaluate_checkpoint(
        args.out, args.imgsz, args.variant, n_eval=args.eval_n,
        device=device,
    )
    report["hard_distribution_eval"] = evaluate_checkpoint(
        args.out, args.imgsz, args.variant, n_eval=max(32, args.eval_n),
        hard=True, n_negatives=8, device=device,
    )
    report["final_train_metrics"] = {
        k: round(v, 4) for k, v in metrics.items()
    }
    report["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
