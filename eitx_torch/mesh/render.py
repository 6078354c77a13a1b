"""Classed-mesh rasterization (OpenCV render replacement).

Parity with get_image (femm_generator.py:299-366): a (1000, 1000, 3) uint8
canvas, elements filled per class colour with 1-px black outlines,
coordinates scaled to fit with a margin. The reference's colour list only
covers classes 0-3 and crashes on class 4; a 5th colour (orange, matching
the skin colour used elsewhere) is appended here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image, ImageDraw

# BGR, indexed by class id (reference list + skin colour extension).
CLASS_COLORS = [
    (255, 255, 255),  # 0 bone
    (0, 0, 255),  # 1 muscles
    (255, 255, 0),  # 2 lung
    (0, 255, 255),  # 3 fat
    (0, 150, 255),  # 4 skin
]


def render_mesh(
    nodes: np.ndarray,
    tris: np.ndarray,
    elem_class: np.ndarray,
    image_size: Tuple[int, int] = (1000, 1000),
    margin: int = 10,
) -> np.ndarray:
    """Returns an (H, W, 3) uint8 BGR image of the classed mesh."""
    nodes = np.asarray(nodes, dtype=np.float64)
    tris = np.asarray(tris, dtype=np.int64)
    width, height = image_size
    min_x, min_y = nodes.min(axis=0)
    max_x, max_y = nodes.max(axis=0)
    span_x = max(max_x - min_x, 1e-9)
    span_y = max(max_y - min_y, 1e-9)

    px = (nodes[:, 0] - min_x) / span_x * (width - 2 * margin) + margin
    py = (max_y - nodes[:, 1]) / span_y * (height - 2 * margin) + margin
    pix = np.stack([px, py], axis=1)

    img = Image.new("RGB", (width, height), (0, 0, 0))
    draw = ImageDraw.Draw(img)
    for t, cid in zip(tris, np.asarray(elem_class)):
        pts = [tuple(pix[i]) for i in t]
        color = CLASS_COLORS[int(cid) % len(CLASS_COLORS)]
        draw.polygon(pts, fill=color, outline=(0, 0, 0))
    return np.asarray(img, dtype=np.uint8)
