"""External contour extraction from binary masks.

Replaces cv2.findContours(RETR_EXTERNAL) (used ~15x in the reference, e.g.
utils.py:572,1173,1246). Connected components + Moore-neighbour boundary
tracing (Jacob's stopping criterion), yielding 8-connected boundary pixels
in (x, y) order like OpenCV's CHAIN_APPROX_NONE.

Two implementations with identical outputs: the native C++ tracer
(eitx_torch/native/contours.cpp, built with g++ into eitx_torch/_build/
at first use — the default; ~50x faster per 512^2 mask, which matters
because every request traces body + 4 class masks on the host) and the
pure-Python/scipy path (used when no C++ compiler is available).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np
from scipy import ndimage

from .._build import build_shared

logger = logging.getLogger("eitx_torch.contours")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "native", "contours.cpp")
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_LOAD_LOCK = threading.Lock()


def _load_native() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _LOAD_LOCK:  # concurrent first callers wait for one build
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        try:
            so = build_shared(
                os.path.abspath(_SRC), "libeitxcontours",
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"], timeout=120,
            )
        except (OSError, subprocess.SubprocessError) as e:  # pragma: no cover
            logger.warning("native contours build failed (%s); fallback", e)
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.eitx_trace_external_contours.restype = ctypes.c_int
            lib.eitx_trace_external_contours.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ]
            _LIB = lib
        except OSError as e:  # pragma: no cover
            logger.warning("native contours load failed (%s); fallback", e)
        return _LIB


def _find_external_contours_native(
    mask: np.ndarray, min_pixels: int
) -> Optional[List[np.ndarray]]:
    lib = _load_native()
    if lib is None:
        return None
    m = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    h, w = m.shape
    max_contours = 16384
    starts = np.empty((max_contours + 1,), np.int64)
    # realistic boundaries are O(h + w) points; retry with the worst-case
    # capacity only if the small buffer overflows
    for cap_pts in (max(16384, 16 * (h + w)), 4 * h * w + 1024):
        out = np.empty((cap_pts, 2), np.int64)
        n = lib.eitx_trace_external_contours(
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            int(min_pixels),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap_pts,
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            max_contours,
        )
        if n >= 0:
            return [out[starts[i]:starts[i + 1]].copy() for i in range(n)]
    return None  # capacity exceeded twice: fall back

# Moore neighbourhood in clockwise order starting from W (dx, dy).
_MOORE = np.array(
    [(-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1)],
    dtype=np.int64,
)


def _trace_boundary(mask: np.ndarray, start_yx) -> np.ndarray:
    """Moore-neighbour boundary trace of the component containing start
    (start must be its topmost-then-leftmost pixel). Returns (N, 2) [x, y].

    Termination: the walk state (pixel, backtrack direction) after a move
    repeats the state after the very first move — robust for 1-pixel-wide
    appendages where the start pixel is revisited mid-trace.
    """
    h, w = mask.shape
    sy, sx = start_yx
    start = (int(sx), int(sy))
    boundary = [start]
    b = 0  # backtrack direction index (virtually entered start from the W)
    cur = start
    state0 = None
    while True:
        found = None
        for k in range(1, 9):  # scan clockwise starting after the backtrack
            d = (b + k) % 8
            nx = cur[0] + int(_MOORE[d][0])
            ny = cur[1] + int(_MOORE[d][1])
            if 0 <= nx < w and 0 <= ny < h and mask[ny, nx]:
                found = (d, (nx, ny))
                break
        if found is None:
            break  # isolated pixel
        d, nxt = found
        nb = (d + 4) % 8
        if state0 is None:
            state0 = (nxt, nb)
        elif (nxt, nb) == state0:
            break  # loop closed: same pixel entered the same way
        cur, b = nxt, nb
        boundary.append(cur)
        if len(boundary) > 4 * (h * w):
            raise RuntimeError("contour trace runaway")
    if len(boundary) > 1 and boundary[-1] == boundary[0]:
        boundary.pop()
    return np.array(boundary, dtype=np.int64)


def find_external_contours(
    mask: np.ndarray, min_pixels: int = 1
) -> List[np.ndarray]:
    """Outer boundary of every 8-connected component of ``mask`` > 0.

    Returns a list of (N, 2) integer [x, y] contours ordered by component
    label (top-to-bottom discovery order, like OpenCV). Components smaller
    than ``min_pixels`` are skipped.
    """
    native = _find_external_contours_native(mask, min_pixels)
    if native is not None:
        return native
    m = np.asarray(mask) > 0
    structure = np.ones((3, 3), dtype=np.int64)
    labels, n = ndimage.label(m, structure=structure)
    contours = []
    if n == 0:
        return contours
    slices = ndimage.find_objects(labels)
    for i, sl in enumerate(slices, start=1):
        if sl is None:
            continue
        comp = labels[sl] == i
        if comp.sum() < min_pixels:
            continue
        ys, xs = np.nonzero(comp)
        k = np.lexsort((xs, ys))[0]  # topmost, then leftmost
        start = (ys[k], xs[k])
        local = _trace_boundary(comp, start)
        local[:, 0] += sl[1].start
        local[:, 1] += sl[0].start
        contours.append(local)
    return contours


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    c = np.asarray(contour, dtype=np.float64)
    if c.shape[0] < 2:
        return 0.0
    seg = np.linalg.norm(np.diff(c, axis=0), axis=1).sum()
    if closed:
        seg += float(np.linalg.norm(c[0] - c[-1]))
    return float(seg)
