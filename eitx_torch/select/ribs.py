"""Rib-based axial slice selection.

Parity with search_number_axial_slice (utils.py:166-269): from frontal-view
rib detections, keep boxes whose left edge lies right of the image midline
(the patient's left side), sort by top y, and take the midpoint of the 6th
and 7th boxes' y1 as the slice between ribs 6 and 7. Returns
[y_rib6, y_rib7, slice_index + custom_offset].
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.errors import SliceSelectionError


def select_axial_slice_number(
    boxes_xyxy: np.ndarray,
    custom_offset: int = 0,
    image_width: int = 512,
) -> List[int]:
    boxes = np.asarray(boxes_xyxy, dtype=np.float64).reshape(-1, 4)
    midpoint = image_width / 2
    right = boxes[boxes[:, 0] > midpoint]
    if right.shape[0] < 7:
        raise SliceSelectionError(
            f"need at least 7 right-side rib boxes, got {right.shape[0]}"
        )
    order = np.argsort(right[:, 1], kind="stable")
    ys = right[order, 1]
    slice_idx = int(abs(ys[5] + ys[6]) / 2)
    return [int(ys[5]), int(ys[6]), slice_idx + int(custom_offset)]
