"""Stage-grid visualization and rib annotation (PIL-based).

Parity targets: draw_annotate (utils.py:316-392 — blue rib boxes, green
slice line, numbered left ribs) and create_segmentation_masks_full_image
(utils.py:876-986 — labeled N x 3 grid of every available stage image).
All images follow the pipeline's BGR channel convention; build_answer does
the final BGR->RGB swap.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw


def _to_bgr3(img: np.ndarray) -> np.ndarray:
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype != np.uint8:
        lo, hi = float(arr.min()), float(arr.max())
        arr = ((arr - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    return arr


def annotate_ribs(
    front_slice: np.ndarray,
    boxes_xyxy: np.ndarray,
    valid: Optional[np.ndarray],
    slice_numbers: Sequence[int],
) -> np.ndarray:
    """Frontal slice + rib boxes (blue), slice-level line (green), and
    1..N numbering of the left ribs (right of midline, top to bottom)."""
    img = _to_bgr3(front_slice)
    boxes = np.asarray(boxes_xyxy, dtype=np.float64).reshape(-1, 4)
    if valid is not None:
        boxes = boxes[np.asarray(valid, bool)]
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    # colors below are BGR tuples written into a BGR ndarray
    for x1, y1, x2, y2 in boxes:
        draw.rectangle([x1, y1, x2, y2], outline=(255, 0, 0), width=2)  # blue
    if len(slice_numbers):
        y = int(slice_numbers[-1])
        draw.line([(0, y), (img.shape[1], y)], fill=(0, 255, 0), width=1)
    mid_x = img.shape[1] // 2
    left = boxes[(boxes[:, 0] + boxes[:, 2]) / 2 > mid_x]
    left = left[np.argsort(left[:, 1])]
    for i, (x1, y1, x2, y2) in enumerate(left, start=1):
        draw.text((int(x2) + 5, int(y2) - 10), str(i), fill=(0, 0, 255))
    return np.asarray(pil)


def _label_image(img: np.ndarray, label: str) -> np.ndarray:
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    w, h = pil.size
    tw = draw.textlength(label)
    draw.text(((w - tw) // 2, h - 20), label, fill=(255, 255, 255))
    return np.asarray(pil)


def stage_grid(
    class_canvases: Optional[Dict[str, np.ndarray]] = None,
    color_output: Optional[np.ndarray] = None,
    ribs_annotated: Optional[np.ndarray] = None,
    axial_slice: Optional[np.ndarray] = None,
    combined_view: Optional[np.ndarray] = None,
    mesh_image: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Labeled grid, max 3 columns, stage order matching the reference."""
    entries: List[Tuple[str, np.ndarray]] = []
    if ribs_annotated is not None and np.any(ribs_annotated):
        entries.append(("1. Ribs Annotated", ribs_annotated))
    if axial_slice is not None and np.any(axial_slice):
        entries.append(("2. Axial Slice", axial_slice))
    if combined_view is not None and np.any(combined_view):
        entries.append(("3. Combined View", combined_view))
    if color_output is not None and np.any(color_output):
        entries.append(("4. Color Masks", color_output))
    if class_canvases:
        for idx, (key, image) in enumerate(class_canvases.items(), start=5):
            if image is not None and np.any(image):
                entries.append((f"{idx}. {key}", image))
    if mesh_image is not None and np.any(mesh_image):
        entries.append(("Mesh Visualization", mesh_image))
    if not entries:
        return np.zeros((100, 100, 3), dtype=np.uint8)

    imgs = [_to_bgr3(im) for _, im in entries]
    max_h = max(im.shape[0] for im in imgs)
    max_w = max(im.shape[1] for im in imgs)
    sized = []
    for (label, _), im in zip(entries, imgs):
        if im.shape[:2] != (max_h, max_w):
            im = np.asarray(
                Image.fromarray(im).resize((max_w, max_h), Image.BILINEAR)
            )
        sized.append(_label_image(im, label))
    n = len(sized)
    cols = min(3, n)
    rows = -(-n // cols)
    grid = np.zeros((max_h * rows, max_w * cols, 3), dtype=np.uint8)
    for i, im in enumerate(sized):
        r, c = divmod(i, cols)
        grid[r * max_h : (r + 1) * max_h, c * max_w : (c + 1) * max_w] = im
    return grid
