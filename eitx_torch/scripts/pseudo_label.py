"""HU-threshold pseudo-labelling of CT slices for training sets.

Port of eitx/scripts/pseudo_label.py (``_ranges_array`` :37,
``_tissue_label_kernel`` :51, ``pseudo_label_slice`` :77,
``pseudo_label_stack`` :94, ``labels_to_yolo_lines`` :102): tissue masks
from the reference's fixed HU ranges (create_femm_dataset.py:757-762 —
air [-1100,-200], bone [70,800], muscle [1,50], fat [-150,-1]), per-tissue
morphology (close for muscle, open for lung and bone, hole-fill for
bone/muscle/lung), first-writer-wins composition into a label image, then
polygon extraction into YOLO segmentation label lines. The labelling runs
on ``device`` as torch ops on (..., H, W), so a stack is one call.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..contours.formats import to_yolo_label
from ..contours.simplify import approx_poly_dp
from ..contours.trace import arc_length, find_external_contours
from ..core.device import to_device
from ..image.cc import fill_holes
from ..image.morphology import binary_close, binary_open

# (hu_min, hu_max) per tissue, reference create_femm_dataset.py:757-762.
HU_RANGES: Dict[str, Tuple[float, float]] = {
    "bone": (70.0, 800.0),
    "muscles": (1.0, 50.0),
    "lung": (-1100.0, -200.0),  # "air" range in the reference
    "fat": (-150.0, -1.0),
}
_CLASS_IDS = {"bone": 0, "muscles": 1, "lung": 2, "fat": 3}


def _ranges_array(hu_scale: float = 1.0, device="cuda") -> torch.Tensor:
    """(4, 2) float32 [lo, hi] rows in bone/muscles/lung/fat order, every
    bound scaled by ``hu_scale`` (the pseudo-labeler-independence probe:
    an eval ranking that survives the thresholds moving +-10% is not an
    artifact of the labeler's exact cut points)."""
    return to_device(np.asarray(
        [[lo * hu_scale, hi * hu_scale]
         for lo, hi in (HU_RANGES["bone"], HU_RANGES["muscles"],
                        HU_RANGES["lung"], HU_RANGES["fat"])],
        np.float32,
    ), device)


def _tissue_label_kernel(hu: torch.Tensor, body: torch.Tensor,
                         ranges: torch.Tensor) -> torch.Tensor:
    """(..., H, W) float32 HU + body mask -> (..., H, W) int32 labels
    (-1 background)."""
    inside = body > 0

    def in_range(row):
        return (hu >= ranges[row, 0]) & (hu <= ranges[row, 1]) & inside

    dev = hu.device
    bone = fill_holes(binary_open(in_range(0), 3, device=dev), device=dev)
    muscles = fill_holes(binary_close(in_range(1), 5, device=dev), device=dev)
    lung = fill_holes(binary_open(in_range(2), 5, device=dev), device=dev)
    fat = in_range(3)
    lab = torch.full(hu.shape, -1, dtype=torch.int32, device=dev)
    # first-writer-wins in the reference's hu_ranges order (air, bone,
    # muscle, fat — create_femm_dataset.py:757-766), so the lung/air mask
    # claims its pixels before the muscle hole-fill swallows them
    for mask, cid in ((lung, _CLASS_IDS["lung"]), (bone, _CLASS_IDS["bone"]),
                      (muscles, _CLASS_IDS["muscles"]),
                      (fat, _CLASS_IDS["fat"])):
        lab = torch.where(mask & (lab < 0), cid, lab)
    return lab


def pseudo_label_slice(hu, body_mask, hu_scale: float = 1.0,
                       device="cuda") -> np.ndarray:
    """(H, W) HU + body mask -> (H, W) int32 labels, computed on
    ``device``."""
    hu_t = to_device(np.asarray(hu, np.float32), device)
    body = to_device(body_mask, device)
    ranges = _ranges_array(hu_scale, hu_t.device)
    return _tissue_label_kernel(hu_t, body, ranges).cpu().numpy()


def pseudo_label_stack(hu_stack, body_masks, device="cuda") -> np.ndarray:
    """Batched variant: (B, H, W) in one call."""
    hu_t = to_device(np.asarray(hu_stack, np.float32), device)
    body = to_device(body_masks, device)
    return _tissue_label_kernel(hu_t, body,
                                _ranges_array(1.0, hu_t.device)).cpu().numpy()


def labels_to_yolo_lines(
    labels: np.ndarray, min_points: int = 3, epsilon_frac: float = 0.001
) -> List[str]:
    """Label image -> YOLO segmentation label lines (normalized coords)."""
    h, w = labels.shape
    lines = []
    for name, cid in _CLASS_IDS.items():
        mask = (labels == cid).astype(np.uint8)
        if not mask.any():
            continue
        for cnt in find_external_contours(mask, min_pixels=8):
            if cnt.shape[0] < min_points:
                continue
            eps = epsilon_frac * arc_length(cnt)
            approx = approx_poly_dp(cnt.astype(float), eps)
            if approx.shape[0] >= min_points:
                lines.append(to_yolo_label(cid, approx, (h, w)))
    return lines
