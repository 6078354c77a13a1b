"""Polygon string formats used across the pipeline.

Interchange contracts preserved from the reference:
  - "class x1 y1 x2 y2 ..." polygon lines
    (utils.py:1268-1270, femm_generator.py:380-382)
  - the coordinate list handed to create_mesh: [spacing_x, spacing_y,
    polygon lines..., optional class-4 body line] (utils.py:1271-1275)
  - YOLO segmentation label lines with image-normalized coordinates
    (scripts/create_femm_dataset.py:253-274)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def format_polygon_line(class_id, poly: np.ndarray, as_int: bool = True) -> str:
    pts = np.asarray(poly)
    if as_int:
        coords = " ".join(f"{int(round(x))} {int(round(y))}" for x, y in pts)
    else:
        coords = " ".join(f"{x} {y}" for x, y in pts)
    return f"{class_id} {coords}"


def parse_polygon_line(line: str) -> Tuple[int, np.ndarray]:
    parts = line.strip().split()
    class_id = int(float(parts[0]))
    coords = np.array(list(map(float, parts[1:])), dtype=np.float64)
    if coords.size % 2 != 0:
        raise ValueError(f"odd coordinate count in polygon line: {line[:60]}")
    return class_id, coords.reshape(-1, 2)


def parse_polygon_lines(lines: Sequence[str]) -> List[Tuple[int, np.ndarray]]:
    out = []
    for line in lines:
        if line and line.strip():
            out.append(parse_polygon_line(line))
    return out


def build_coordinate_list(
    polygons: Sequence[str],
    pixel_spacing: Sequence[float],
    body_polygon: Optional[str] = None,
) -> List[str]:
    """[spacing_x, spacing_y, polygons..., body?] — the exact list shape
    create_list_crd_from_color_output returns (utils.py:1271-1275)."""
    result = list(polygons)
    if body_polygon:
        result.append(body_polygon)
    result.insert(0, str(pixel_spacing[1]))
    result.insert(0, str(pixel_spacing[0]))
    return result


def split_coordinate_list(crd_list: Sequence[str]):
    """Inverse of build_coordinate_list: (pixel_spacing, polygon lines)."""
    spacing = (float(crd_list[0]), float(crd_list[1]))
    return spacing, list(crd_list[2:])


def to_yolo_label(class_id: int, poly: np.ndarray, shape: Tuple[int, int]) -> str:
    """YOLO segmentation label: class then x/W y/H pairs."""
    h, w = shape
    pts = np.asarray(poly, dtype=np.float64)
    coords = " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in pts)
    return f"{class_id} {coords}"


def from_yolo_label(line: str, shape: Tuple[int, int]) -> Tuple[int, np.ndarray]:
    class_id, pts = parse_polygon_line(line)
    h, w = shape
    return class_id, pts * np.array([w, h])
