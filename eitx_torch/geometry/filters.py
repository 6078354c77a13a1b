"""Contour numeric filters (FEMM model-preparation path).

Copy of eitx/geometry/filters.py (host numpy only).

Behavioural parity with the reference's femm_tools/filters.py (the healthiest
tested module in the reference; its tests/test_filters.py exercises these
semantics). Names are ASCII throughout — the reference's
``сut_min_area_close_points`` (Cyrillic 'с', filters.py:157) is exposed here
as ``cut_min_area_close_points``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def calc_lin_coef(point1, point2) -> Tuple[float, float]:
    """(k, b) of y = k*x + b through two points; vertical lines unsupported."""
    x1, y1 = point1
    x2, y2 = point2
    if x1 == x2:
        raise ValueError("vertical lines not supported")
    k = -(y2 - y1) / (x1 - x2)
    b = -(x2 * y1 - x1 * y2) / (x1 - x2)
    return (k, b)


def calc_dist(point1, point2, typ: str = "dist") -> float:
    """Distance between two points: 'dist' (euclidean) or 'max_coord_dif'."""
    if typ == "max_coord_dif":
        return float(np.max(np.abs(np.asarray(point1) - np.asarray(point2))))
    if typ == "dist":
        x1, y1 = point1
        x2, y2 = point2
        return math.hypot(x1 - x2, y1 - y2)
    raise ValueError(f"Unknown distance calculation method {typ}")


def check_point_in_line(filtered_data: np.ndarray, point, accuracy: float) -> bool:
    """True if ``point`` lies (within ``accuracy``) on the line through the
    last two accepted points."""
    x, y = point
    x1, _ = filtered_data[-2]
    x2, _ = filtered_data[-1]
    if x1 == x2:
        return x == x1
    k, b = calc_lin_coef(filtered_data[-1, :], filtered_data[-2, :])
    return calc_dist((x, k * x + b), (x, y)) <= accuracy


def poly_area(x, y) -> float:
    """Shoelace polygon area."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def filter_inline_points(data: np.ndarray, accuracy: float = 1e-9) -> np.ndarray:
    """Delete runs of collinear points and short appendixes.

    A point collinear (within accuracy) with the previous two replaces the
    last accepted point; points that loop back onto recent points (appendix
    spikes) are cut.
    """
    data = np.asarray(data, dtype=np.float64)
    out = data[:2].copy()
    for i in range(2, data.shape[0]):
        x, y = data[i]
        if check_point_in_line(out, (x, y), accuracy):
            out[-1, :] = [x, y]
        else:
            out = np.append(out, data[i : i + 1], axis=0)
        if out.shape[0] >= 3 and calc_dist(out[-1], out[-3]) <= accuracy:
            out = np.delete(out, (-1, -2), axis=0)
        if out.shape[0] >= 2 and calc_dist(out[-1], out[-2]) <= accuracy:
            out = np.delete(out, (-1,), axis=0)
    if out.shape[0] > 1 and check_point_in_line(out, tuple(out[0]), accuracy):
        out = np.delete(out, (-1,), axis=0)
    return out


def cut_min_area_close_points(
    data: np.ndarray, min_area: float, accuracy: float
) -> np.ndarray:
    """Cut sub-loops: when two near-coincident points split the polygon into
    two loops, delete whichever loop has area below ``min_area``; empty the
    polygon when both do."""
    data = np.asarray(data, dtype=np.float64)
    i = 0
    while i < data.shape[0]:
        d = np.linalg.norm(data - data[i], axis=1)
        idx = np.where(d <= accuracy)[0]
        if idx.size > 1:
            after = list(range(idx[0], idx[-1]))
            before = [j for j in range(data.shape[0]) if j not in after]
            a_after = poly_area(data[after, 0], data[after, 1]) if after else 0.0
            a_before = poly_area(data[before, 0], data[before, 1]) if before else 0.0
            if a_after <= min_area and a_before > min_area:
                data = np.delete(data, after, axis=0)
                i = 0
                continue
            if a_after > min_area and a_before <= min_area:
                data = np.delete(data, before, axis=0)
                i = 0
                continue
            if a_after <= min_area and a_before <= min_area:
                return np.empty([0, 2])
        i += 1
    return data


def filter_degr_polyfit(
    data: np.ndarray, min_deg: float, n_points: int
) -> np.ndarray:
    """Truncate the contour where the local slope (fitted over groups of
    ``n_points``) changes by more than ``min_deg`` degrees."""
    data = np.asarray(data, dtype=np.float64)
    out = data[:n_points].copy()
    for i in range(
        n_points, math.ceil(data.shape[0] / n_points) * n_points + 1, n_points
    ):
        if i > data.shape[0]:
            i = data.shape[0] - 1
        nxt = data[i - n_points : i]
        if nxt.shape[0] < 2:
            break
        k_new = np.polyfit(nxt[:, 0], nxt[:, 1], 1)[0]
        dx = nxt[-1, 0] - nxt[0, 0]
        deg_new = math.degrees(math.atan2(k_new * dx, dx))
        ref = out[-n_points:]
        k_old = np.polyfit(ref[:, 0], ref[:, 1], 1)[0]
        dx = out[-1, 0] - out[-n_points, 0]
        deg_old = math.degrees(math.atan2(k_old * dx, dx))
        if abs(deg_new - deg_old) <= min_deg:
            out = np.append(out, nxt, axis=0)
        else:
            break
    return out


def interpolate_surface_step(
    d: np.ndarray, por: int, dx: float, borderc: float, thin_n: int
) -> np.ndarray:
    """Resample upper/lower polygon halves with a degree-``por`` polynomial
    at step ``dx``, thinning the middle region (outside the +-borderc band)
    to every ``thin_n``-th point."""
    assert borderc < 1, "thin out coefficient must be less than 1"
    d = np.asarray(d, dtype=np.float64)
    out = np.empty([0, 2])
    i1 = int(np.where(d[:, 0] == np.min(d[:, 0]))[0][0]) + 1
    i2 = int(np.where(d[:, 0] == np.max(d[:, 0]))[0][0]) + 1
    idx1 = list(range(i1, i2))
    halves = [idx1, [i for i in range(d.shape[0]) if i not in idx1]]
    maxx, minx = d[:, 0].max(), d[:, 0].min()
    largestx = max(maxx, abs(minx))
    n_keep = int((largestx - largestx * borderc) / dx)
    for i, half in enumerate(halves):
        pts = d[half, :]
        coeffs = np.polyfit(pts[:, 0], pts[:, 1], por)
        f = np.poly1d(coeffs)
        x = np.arange(maxx, minx, -dx) if i else np.arange(minx, maxx, dx)
        n2 = x.shape[0] - n_keep
        newidx = np.r_[0:n_keep, n_keep:n2:thin_n, n2 : x.shape[0]]
        x = x[newidx]
        out = np.append(out, np.stack([x, f(x)], axis=1), axis=0)
    return out


def interpolate_big_vert_breaks_lin(data: np.ndarray, n_max: int) -> np.ndarray:
    """Bisect gaps larger than 4x the median neighbour distance, up to
    ``n_max`` insertions (linear interpolation)."""
    out = np.asarray(data, dtype=np.float64).copy()
    for _ in range(n_max):
        closed = np.vstack((out, out[:1]))
        dist = np.linalg.norm(np.diff(closed, axis=0), axis=1)
        threshold = np.median(dist) * 4
        idxs = np.where(dist > threshold)[0]
        if idxs.size == 0:
            break
        i = int(idxs[0])
        p1 = out[i]
        p2 = out[(i + 1) % out.shape[0]]
        mid = (p1 + p2) / 2.0
        if i + 1 != out.shape[0]:
            out = np.insert(out, i + 1, mid[None, :], axis=0)
        else:
            out = np.append(out, mid[None, :], axis=0)
    return out


def interpolate_big_vert_breaks_poly(
    data: np.ndarray, por: int, n: int
) -> np.ndarray:
    """Insert points near the leftmost/rightmost extremes using a local
    x(y) polynomial fit of degree ``por`` over 2*``n`` neighbours."""
    data = np.asarray(data, dtype=np.float64)
    out = data.copy()
    i1 = int(np.where(data[:, 0] == np.min(data[:, 0]))[0][0]) + 1
    i2 = int(np.where(data[:, 0] == np.max(data[:, 0]))[0][0])
    for i in (i1, i2):
        idx = [a % data.shape[0] for a in range(i - n, i + n)]
        coeffs = np.polyfit(data[idx, 1], data[idx, 0], por)
        f = np.poly1d(coeffs)
        y = data[idx, 1].copy()
        gaps = np.abs(np.diff(y))
        if gaps.size == 0:
            continue
        threshold = float(np.mean(gaps))
        j = 0
        while j < len(y) - 1:
            dy = y[j + 1] - y[j]
            if abs(dy) > threshold:
                nwp = y[j] + abs(dy) / 2 if y[j + 1] > y[j] else y[j] - abs(dy) / 2
                y = np.insert(y, j + 1, nwp)
            else:
                j += 1
        x = f(y)
        for j in range(len(x)):
            if y[j] not in out[:, 1]:
                prev = np.where(out[:, 1] == y[j - 1])[0]
                if prev.size:
                    out = np.insert(
                        out, prev[0] + 1, np.array([[x[j], y[j]]]), axis=0
                    )
    return out
