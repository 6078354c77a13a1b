"""Label-image <-> BGR canvas conversion.

Internally the pipeline works on an (H, W) int label image (-1 background,
0=bone 1=muscles 2=lung 3=fat 4=skin) instead of the reference's stack of
BGR canvases; colors only appear at visualization / interchange edges. The
BGR color keys are the reference's (utils.py:467-473, 781-787):
bone=white, muscles=red, lung=cyan, fat=yellow, skin/air=orange.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# index = class id; BGR.
LABEL_COLORS_BGR = np.array(
    [
        (255, 255, 255),  # 0 bone
        (0, 0, 255),  # 1 muscles
        (255, 255, 0),  # 2 lung
        (0, 255, 255),  # 3 fat
        (0, 150, 255),  # 4 skin
    ],
    dtype=np.uint8,
)

CLASS_KEYS = ("bone", "muscles", "lung", "adipose")  # reference dict keys


def labels_to_bgr(labels: np.ndarray) -> np.ndarray:
    """(H, W) labels -> (H, W, 3) uint8 BGR (background black)."""
    lab = np.asarray(labels)
    out = np.zeros((*lab.shape, 3), dtype=np.uint8)
    for cid in range(LABEL_COLORS_BGR.shape[0]):
        out[lab == cid] = LABEL_COLORS_BGR[cid]
    return out


def bgr_to_labels(bgr: np.ndarray, tolerance: int = 0) -> np.ndarray:
    """(H, W, 3) BGR canvas -> (H, W) labels (-1 where no class color)."""
    img = np.asarray(bgr, dtype=np.int16)
    lab = np.full(img.shape[:2], -1, dtype=np.int32)
    for cid in range(LABEL_COLORS_BGR.shape[0]):
        hit = (np.abs(img - LABEL_COLORS_BGR[cid].astype(np.int16)) <= tolerance).all(
            axis=2
        )
        lab[hit] = cid
    return lab


def class_canvases(labels: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-class BGR canvases, keyed like create_segmentations_masks
    (utils.py:481-486: bone / muscles / lung / adipose)."""
    lab = np.asarray(labels)
    out = {}
    for cid, key in enumerate(CLASS_KEYS):
        canvas = np.zeros((*lab.shape, 3), dtype=np.uint8)
        canvas[lab == cid] = LABEL_COLORS_BGR[cid]
        out[key] = canvas
    return out


def overlay_with_transparency(
    base_image: np.ndarray, color_mask: np.ndarray, alpha: float = 0.8
) -> np.ndarray:
    """Saturating overlay base + alpha*mask (utils.py:846-873 semantics:
    cv2.addWeighted with beta=alpha, gamma=0)."""
    base = np.asarray(base_image)
    if base.ndim == 2:
        base = np.stack([base] * 3, axis=-1)
    if base.dtype != np.uint8:
        lo, hi = base.min(), base.max()
        base = ((base - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    mask = np.asarray(color_mask, dtype=np.float32)
    out = np.clip(base.astype(np.float32) + alpha * mask, 0, 255)
    return out.astype(np.uint8)
