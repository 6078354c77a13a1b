"""Polygon simplification (cv2.approxPolyDP replacement).

The reference simplifies every traced contour with
``approxPolyDP(cnt, 0.001 * arcLength(cnt, True), True)``
(utils.py:1255-1256). This is Douglas-Peucker with an absolute epsilon; for
closed curves we anchor the recursion at the two mutually farthest points.
"""

from __future__ import annotations

import numpy as np


def _dp_open(pts: np.ndarray, eps: float) -> np.ndarray:
    """Iterative Douglas-Peucker on an open polyline (keeps endpoints)."""
    n = pts.shape[0]
    if n <= 2:
        return pts
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i + 1:
            continue
        seg = pts[i + 1 : j]
        a, b = pts[i], pts[j]
        ab = b - a
        L = np.hypot(*ab)
        if L < 1e-12:
            d = np.linalg.norm(seg - a, axis=1)
        else:
            d = np.abs(ab[0] * (a[1] - seg[:, 1]) - ab[1] * (a[0] - seg[:, 0])) / L
        k = int(np.argmax(d))
        if d[k] > eps:
            m = i + 1 + k
            keep[m] = True
            stack.append((i, m))
            stack.append((m, j))
    return pts[keep]


def approx_poly_dp(
    contour: np.ndarray, epsilon: float, closed: bool = True
) -> np.ndarray:
    """Douglas-Peucker simplification; returns (M, 2) vertices.

    For closed contours the polyline is split at the two farthest-apart
    vertices so no artificial endpoint bias is introduced.
    """
    pts = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    n = pts.shape[0]
    if n <= 3:
        return pts.copy()
    if not closed:
        return _dp_open(pts, epsilon)
    # anchor at the point farthest from vertex 0, then the point farthest
    # from that (diameter approximation, O(n))
    d0 = np.linalg.norm(pts - pts[0], axis=1)
    i = int(np.argmax(d0))
    d1 = np.linalg.norm(pts - pts[i], axis=1)
    j = int(np.argmax(d1))
    lo, hi = (i, j) if i < j else (j, i)
    rolled = np.roll(pts, -lo, axis=0)
    split = hi - lo
    first = _dp_open(rolled[: split + 1], epsilon)
    second = _dp_open(np.vstack([rolled[split:], rolled[:1]]), epsilon)
    out = np.vstack([first[:-1], second[:-1]])
    return out
