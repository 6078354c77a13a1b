"""Pixel-level segmentation evaluation (copy of eitx/eval/metrics.py).

Parity with the reference evaluator (scripts/accuracy_calculate.py):
YOLO polygon ground truth rasterized to a (H, W) mask of class_id + 1
(0 background), per-class accuracy / precision / recall / F1 / IoU, and
dataset aggregation. Counting runs as one vectorized confusion pass
instead of per-class Python loops; the per-class numbers match the
reference's definitions exactly (accuracy computed over all pixels for
that class-vs-rest split)."""

from __future__ import annotations

import os
from typing import Dict, Iterable, Tuple

import numpy as np

from ..geometry.polygon import rasterize_polygons

CLASS_NAMES = {0: "bone", 1: "muscles", 2: "lung", 3: "adipose"}


def mask_from_yolo_labels(
    label_path: str, img_width: int, img_height: int
) -> np.ndarray:
    """YOLO polygon label file -> (H, W) uint8 mask of class_id + 1."""
    if not os.path.exists(label_path):
        return np.zeros((img_height, img_width), dtype=np.uint8)
    polys = []
    with open(label_path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            cid = int(parts[0])
            coords = np.array(list(map(float, parts[1:])))
            if coords.size < 6:
                continue
            pts = coords.reshape(-1, 2) * np.array([img_width, img_height])
            polys.append((cid + 1, np.round(pts)))
    lab = rasterize_polygons(polys, (img_height, img_width), background=0)
    return lab.astype(np.uint8)


def confusion_counts(
    gt: np.ndarray, pred: np.ndarray, n_classes: int = 4
) -> Dict[int, Dict[str, int]]:
    """Per-class TP/FP/FN/TN with masks valued class_id + 1."""
    out = {}
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    total = gt.size
    for cid in range(n_classes):
        v = cid + 1
        g = gt == v
        p = pred == v
        tp = int(np.sum(g & p))
        fp = int(np.sum(~g & p))
        fn = int(np.sum(g & ~p))
        out[cid] = {"tp": tp, "fp": fp, "fn": fn, "tn": total - tp - fp - fn}
    return out


def pixel_metrics(counts: Dict[str, int]) -> Dict[str, float]:
    tp, fp, fn, tn = (counts[k] for k in ("tp", "fp", "fn", "tn"))
    total = tp + fp + fn + tn
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else 0.0
    )
    iou = tp / (tp + fp + fn) if tp + fp + fn else 0.0
    accuracy = (tp + tn) / total if total else 0.0
    return {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "iou": iou,
    }


def evaluate_dataset(
    pairs: Iterable[Tuple[np.ndarray, np.ndarray]], n_classes: int = 4
) -> Dict[int, Dict[str, float]]:
    """Aggregate (gt_mask, pred_mask) pairs into per-class metrics."""
    agg: Dict[int, Dict[str, int]] = {
        c: {"tp": 0, "fp": 0, "fn": 0, "tn": 0} for c in range(n_classes)
    }
    for gt, pred in pairs:
        counts = confusion_counts(gt, pred, n_classes)
        for c in range(n_classes):
            for k in agg[c]:
                agg[c][k] += counts[c][k]
    return {c: pixel_metrics(agg[c]) for c in range(n_classes)}


def mean_mask_iou(a: np.ndarray, b: np.ndarray, n_classes: int = 4) -> float:
    """Mean per-class IoU between two class_id+1 masks — the BASELINE.json
    parity metric (tissue-mask IoU vs reference outputs)."""
    counts = confusion_counts(a, b, n_classes)
    ious = [pixel_metrics(counts[c])["iou"] for c in range(n_classes)
            if counts[c]["tp"] + counts[c]["fp"] + counts[c]["fn"] > 0]
    return float(np.mean(ious)) if ious else 1.0


def print_results(results: Dict[int, Dict[str, float]]) -> str:
    lines = ["class      acc    prec   recall f1     iou"]
    for cid, m in sorted(results.items()):
        name = CLASS_NAMES.get(cid, str(cid))
        lines.append(
            f"{name:<10} {m['accuracy']:.4f} {m['precision']:.4f} "
            f"{m['recall']:.4f} {m['f1']:.4f} {m['iou']:.4f}"
        )
    text = "\n".join(lines)
    print(text)
    return text
