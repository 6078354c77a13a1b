"""Synthetic thorax meshes made from the seed, with numpy and scipy only.

The layout is the repository bench's thorax (``bench.py``
``build_thorax_mesh``, ported as ``eitx_torch/scripts/profile_setup.py``
``thorax_mesh``): nested ellipses for skin, fat, muscle, two lungs and the
heart, each radius jittered by up to ``jitter`` from the seed. The mesh is
made here rather than by the port's mesher, so the FEM cells measure the
simulation alone: points at spacing ``lc`` on every ellipse (each moved
along it by a random share of the spacing) and on a triangular lattice
inside the body (kept ``margin * lc`` from every ellipse), a Delaunay
triangulation (the body ellipse is convex, so every
triangle lies inside it), and each element classed by its centroid: the
last ellipse of the list that holds it.

Returns the ``{"NODES", "TRIANGLES", "CLASS"}`` dict that
``prepare_mesh_info`` reads.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.spatial import Delaunay


def _ellipse_points(cx, cy, rx, ry, lc, shake, rng):
    """Points at arc spacing ~``lc`` around an ellipse, counter-clockwise,
    each moved along the curve by up to ``shake`` of the spacing: equal
    spacing would leave exact ties in the electrode placement (nearest
    node to an angle or to an arc length), which rounding then decides."""
    th = np.linspace(0.0, 2.0 * math.pi, 4096, endpoint=False)
    x, y = cx + rx * np.cos(th), cy + ry * np.sin(th)
    seg = np.hypot(np.diff(x, append=x[0]), np.diff(y, append=y[0]))
    arc = np.concatenate([[0.0], np.cumsum(seg)[:-1]])
    n = max(8, int(round(seg.sum() / lc)))
    pos = (np.arange(n) + rng.uniform(-shake, shake, n)) * seg.sum() / n
    at = np.interp(pos % seg.sum(), arc, th)
    return np.stack([cx + rx * np.cos(at), cy + ry * np.sin(at)], 1)


def _level(p, e):
    """(F, distance estimate) of points p to ellipse e = (cx, cy, rx, ry):
    F < 1 inside; the distance is |F - 1| / |grad F| (first order)."""
    cx, cy, rx, ry = e
    dx, dy = p[:, 0] - cx, p[:, 1] - cy
    f = (dx / rx) ** 2 + (dy / ry) ** 2
    g = np.hypot(2 * dx / rx ** 2, 2 * dy / ry ** 2)
    return f, np.abs(f - 1.0) / np.maximum(g, 1e-12)


def jittered_ellipses(geometry: dict, jitter: float, rng) -> list:
    """[(class, cx, cy, rx, ry)], each radius scaled by U(1 - jitter,
    1 + jitter), drawn in the list's order."""
    out = []
    for cls, cx, cy, rx, ry in geometry["ellipses"]:
        jx, jy = 1.0 + rng.uniform(-jitter, jitter, size=2)
        out.append((int(cls), float(cx), float(cy), rx * jx, ry * jy))
    return out


def thorax_mesh(geometry: dict, jitter: float, rng) -> dict:
    """One subject's mesh from ``geometry`` (the configuration's
    ``ellipses`` [class, cx, cy, rx, ry] with the body first, ``lc``, the
    interior ``lattice`` spacing as a share of ``lc``, ``margin`` and
    ``shake``) jittered from ``rng``."""
    lc, margin = float(geometry["lc"]), float(geometry["margin"])
    shake = float(geometry["shake"])
    ells = jittered_ellipses(geometry, jitter, rng)
    body = ells[0][1:]
    shapes = [e[1:] for e in ells]

    pts = [_ellipse_points(*body, lc, shake, rng)]
    for e in shapes[1:]:
        p = _ellipse_points(*e, lc, shake, rng)
        f, d = _level(p, body)
        pts.append(p[(f < 1.0) & (d > margin * lc)])
    # triangular lattice over the body's box
    cx, cy, rx, ry = body
    step = lc * float(geometry["lattice"])
    h = step * math.sqrt(3.0) / 2.0
    ys = np.arange(cy - ry, cy + ry + h, h)
    grid = []
    for k, yv in enumerate(ys):
        xs = np.arange(cx - rx + (step / 2.0) * (k % 2), cx + rx + step,
                       step)
        grid.append(np.stack([xs, np.full_like(xs, yv)], 1))
    grid = np.concatenate(grid)
    keep = _level(grid, body)[0] < 1.0
    for e in shapes:
        keep &= _level(grid, e)[1] > margin * lc
    pts.append(grid[keep])
    nodes = np.concatenate(pts)

    tris = Delaunay(nodes).simplices.astype(np.int64)
    a, b, c = nodes[tris[:, 0]], nodes[tris[:, 1]], nodes[tris[:, 2]]
    area2 = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    flip = area2 < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    cent = nodes[tris].mean(axis=1)
    cls = np.full(tris.shape[0], ells[0][0], np.int64)
    for e in ells[1:]:
        cls[_level(cent, e[1:])[0] < 1.0] = e[0]
    return {"NODES": nodes, "TRIANGLES": tris, "CLASS": cls}


def subject_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of subject ``index`` of the pool made from ``seed``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), index]))


def subject_pool(geometry: dict, jitter: float, size: int, seed: int) -> list:
    """``size`` subjects' meshes from ``seed``."""
    return [thorax_mesh(geometry, jitter, subject_rng(seed, i))
            for i in range(size)]
