"""Unstructured triangulation of a closed polygon.

Primary path: the in-repo C++ mesher (eitx_torch/native/mesher.cpp —
boundary resampling + hex interior lattice + Bowyer-Watson Delaunay),
built with g++ into eitx_torch/_build/ at first use and loaded through
ctypes. Fallback: the same point-generation policy in numpy with scipy's
Delaunay.

Replaces the Gmsh kernel the reference calls at femm_generator.py:445-478.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .._build import build_shared
from ..core.errors import MeshingError

logger = logging.getLogger("eitx_torch.mesh")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "native", "mesher.cpp")
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_LOAD_LOCK = threading.Lock()


def _load_native() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _LOAD_LOCK:  # concurrent first callers wait for one build
        if _LIB is not None or _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        try:
            so = build_shared(
                os.path.abspath(_SRC), "libeitxmesher",
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"], timeout=120,
            )
        except (OSError, subprocess.SubprocessError) as e:  # pragma: no cover
            logger.warning("native mesher build failed (%s); using fallback", e)
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.eitx_triangulate.restype = ctypes.c_int
            lib.eitx_triangulate.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            _LIB = lib
        except OSError as e:  # pragma: no cover
            logger.warning("native mesher load failed (%s); using fallback", e)
        return _LIB


def _triangulate_native(poly: np.ndarray, lc: float):
    lib = _load_native()
    if lib is None:
        return None
    poly64 = np.ascontiguousarray(poly, dtype=np.float64)
    n_poly = poly64.shape[0]
    # generous capacity estimate
    from ..geometry.polygon import polygon_area

    est = int(polygon_area(poly64) / (0.4 * lc * lc)) + 4 * n_poly + 1024
    nodes = np.empty((est, 2), dtype=np.float64)
    tris = np.empty((2 * est, 3), dtype=np.int32)
    nn = ctypes.c_int(0)
    nt = ctypes.c_int(0)
    rc = lib.eitx_triangulate(
        poly64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_poly,
        float(lc),
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        est,
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        2 * est,
        ctypes.byref(nn),
        ctypes.byref(nt),
    )
    if rc != 0:
        raise MeshingError(f"native triangulation failed (code {rc})")
    return nodes[: nn.value].copy(), tris[: nt.value].astype(np.int64)


def _generate_points(poly: np.ndarray, lc: float):
    """Boundary resample + interior hex lattice (mirrors the C++ policy)."""
    from ..geometry.polygon import points_in_polygon

    ring = np.asarray(poly, dtype=np.float64)
    if np.allclose(ring[0], ring[-1]):
        ring = ring[:-1]
    if ring.shape[0] < 3:
        raise MeshingError("polygon has fewer than 3 distinct points")
    bnd = []
    m = ring.shape[0]
    for i in range(m):
        a, b = ring[i], ring[(i + 1) % m]
        L = float(np.linalg.norm(b - a))
        k = max(1, int(np.floor(L / lc + 0.5)))
        for j in range(k):
            q = a + (j / k) * (b - a)
            if not bnd or np.linalg.norm(q - bnd[-1]) > 0.25 * lc:
                bnd.append(q)
    bnd = np.array(bnd)
    if bnd.shape[0] >= 2 and np.linalg.norm(bnd[0] - bnd[-1]) < 0.25 * lc:
        bnd = bnd[:-1]

    minx, miny = ring.min(axis=0)
    maxx, maxy = ring.max(axis=0)
    rowh = lc * np.sqrt(3) / 2
    ys = np.arange(miny + 0.5 * rowh, maxy, rowh)
    grid = []
    for r, y in enumerate(ys):
        x0 = minx + (0.75 * lc if r % 2 else 0.25 * lc)
        xs = np.arange(x0, maxx, lc)
        grid.append(np.stack([xs, np.full_like(xs, y)], axis=1))
    grid = np.concatenate(grid) if grid else np.empty((0, 2))
    if grid.shape[0]:
        inside = points_in_polygon(grid, ring)
        grid = grid[inside]
        # distance to boundary: min over segments
        a = ring
        b = np.roll(ring, -1, axis=0)
        v = b - a  # (m,2)
        L2 = np.maximum((v**2).sum(1), 1e-30)
        w = grid[:, None, :] - a[None, :, :]  # (g, m, 2)
        t = np.clip((w * v[None]).sum(-1) / L2[None], 0, 1)
        proj = a[None] + t[..., None] * v[None]
        dmin = np.sqrt(((grid[:, None, :] - proj) ** 2).sum(-1)).min(axis=1)
        grid = grid[dmin >= 0.62 * lc]
    return ring, np.concatenate([bnd, grid], axis=0)


def _triangulate_fallback(poly: np.ndarray, lc: float):
    from scipy.spatial import Delaunay

    from ..geometry.polygon import points_in_polygon

    ring, pts = _generate_points(poly, lc)
    tris = Delaunay(pts).simplices.astype(np.int64)
    p = pts[tris]
    cent = p.mean(axis=1)
    area2 = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 2, 0] - p[:, 0, 0]
    ) * (p[:, 1, 1] - p[:, 0, 1])
    keep = (np.abs(area2) > 1e-9 * lc * lc) & points_in_polygon(cent, ring)
    tris = tris[keep]
    # enforce CCW
    p = pts[tris]
    area2 = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 2, 0] - p[:, 0, 0]
    ) * (p[:, 1, 1] - p[:, 0, 1])
    flip = area2 < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return pts, tris


def triangulate_polygon(
    poly: np.ndarray, lc: float = 7.0, prefer_native: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulate the interior of a closed polygon.

    Returns (nodes (N,2) float64, tris (M,3) int64, CCW winding). Unused
    nodes may remain; callers compact if needed.
    """
    poly = np.asarray(poly, dtype=np.float64)
    if prefer_native:
        try:
            out = _triangulate_native(poly, lc)
            if out is not None:
                return out
        except MeshingError:
            raise
        except Exception as e:  # pragma: no cover
            logger.warning("native mesher error (%s); using fallback", e)
    return _triangulate_fallback(poly, lc)
