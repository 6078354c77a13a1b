"""Batched even-odd point-in-polygon containment: CUDA kernel + plain version.

``points_in_polys`` is the triangle classifier's containment test. For
CUDA tensors it launches the hand-written kernel in
``eitx_torch/csrc/pip.cu`` (the port of the TPU kernel
``eitx/mesh/pallas_pip.py:points_in_polys_pallas``); for CPU tensors it
runs ``points_in_polys_ref``, the plain PyTorch version of the same
arithmetic. There is no fallback between the two: a CUDA tensor launches
the kernel or raises.

One call is a prologue and a main kernel (see the note in ``pip.cu``): the
prologue writes the list of live edges (``y2 != y1``; every other edge
straddles no point) and the main kernel walks that list. ``live_edges``
runs the prologue alone, ``live_edges_ref`` is its plain version.

The kernel is built with ``nvcc`` for ``sm_90a`` into
``eitx_torch/_build/`` at its first launch (and again whenever the source
or the flags change), and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from .._build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "csrc", "pip.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_LIB: Optional[ctypes.CDLL] = None
_LIB_PATH: Optional[str] = None

# launches of the CUDA kernel (prologue and main kernel, one call) since
# the count was last set to 0; concurrent requests count under _COUNT_LOCK
pip_launches = 0
# launches of the prologue alone, through ``live_edges``
live_edges_launches = 0
_COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def load_kernel() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _LIB, _LIB_PATH
    with _LOAD_LOCK:  # concurrent first callers wait for one build
        if _LIB is None:
            so = build_shared(os.path.abspath(_SRC), "libeitxpip",
                              [_nvcc(), *NVCC_FLAGS])
            lib = ctypes.CDLL(so)
            ptr, int_ = ctypes.c_void_p, ctypes.c_int
            lib.eitx_pip.restype = int_
            # pts, polys, out, 3 x scratch, Q, C, P, stream
            lib.eitx_pip.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, int_, int_, int_, ptr]
            lib.eitx_pip_edges.restype = int_
            lib.eitx_pip_edges.argtypes = [  # polys, 3 x scratch, C, P, stream
                ptr, ptr, ptr, ptr, int_, int_, ptr]
            _LIB, _LIB_PATH = lib, so
    return _LIB


def kernel_build_log() -> str:
    """What nvcc printed when the loaded library was built: with
    ``-Xptxas -v``, each kernel's registers, shared memory and spills.
    Empty when the library was found already built by an older tree."""
    load_kernel()
    try:
        with open(f"{_LIB_PATH}.log") as fh:
            return fh.read()
    except FileNotFoundError:
        return ""


def points_in_polys_ref(
    points: torch.Tensor, polys: torch.Tensor, chunk_elems: int = 1 << 24
) -> torch.Tensor:
    """Plain PyTorch version: (Q, 2) points x (C, P, 2) polys -> (Q, C) bool.

    Reproduces ``eitx.mesh.classify._points_in_polys`` op for op, chunked
    over Q so that at most ``chunk_elems`` (point, contour, edge) tests
    exist at once instead of the whole (Q, C, P) tensor.
    """
    q = points.shape[0]
    c, p, _ = polys.shape
    x1 = polys[:, :, 0]
    y1 = polys[:, :, 1]
    x2 = torch.roll(x1, -1, dims=1)
    y2 = torch.roll(y1, -1, dims=1)
    d = y2 - y1
    dy = torch.where(d == 0, torch.full_like(d, 1e-30), d)
    dx = x2 - x1
    step = max(1, chunk_elems // max(c * p, 1))
    out = torch.empty((q, c), dtype=torch.bool, device=points.device)
    for s in range(0, q, step):
        x = points[s:s + step, 0, None, None]
        y = points[s:s + step, 1, None, None]
        crosses = ((y1 > y) != (y2 > y)) & (x < dx * (y - y1) / dy + x1)
        out[s:s + step] = crosses.sum(dim=2) % 2 == 1
    return out


def live_edges_ref(polys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's prologue.

    (C, P, 2) polys -> ``records`` (E, 4) float32, one row
    ``(y1, y2, x1, x2 - x1)`` per edge with ``y2 != y1``, polygon after
    polygon in vertex order; ``offsets`` (C + 1,) int32, polygon ``c`` owning
    rows ``offsets[c]:offsets[c + 1]``. An edge with ``y1 == y2`` straddles
    no point, so the parity of every point against the records equals its
    parity against the polygon.
    """
    x1 = polys[:, :, 0]
    y1 = polys[:, :, 1]
    x2 = torch.roll(x1, -1, dims=1)
    y2 = torch.roll(y1, -1, dims=1)
    live = y2 != y1
    records = torch.stack([y1, y2, x1, x2 - x1], dim=-1)[live]
    offsets = torch.zeros(polys.shape[0] + 1, dtype=torch.int32,
                          device=polys.device)
    offsets[1:] = torch.cumsum(live.sum(dim=1), dim=0)
    return records, offsets


def _check_polys(polys: torch.Tensor) -> None:
    if polys.dtype != torch.float32:
        raise TypeError(f"polys must be float32, got {polys.dtype}")
    if polys.ndim != 3 or polys.shape[2] != 2 or polys.shape[1] < 1:
        raise ValueError(f"polys must be (C, P, 2), got {tuple(polys.shape)}")


def _check(points: torch.Tensor, polys: torch.Tensor) -> None:
    if points.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {points.dtype}")
    _check_polys(polys)
    if points.ndim != 2 or points.shape[1] != 2:
        raise ValueError(f"points must be (Q, 2), got {tuple(points.shape)}")
    if points.device != polys.device:
        raise ValueError(
            f"points on {points.device}, polys on {polys.device}")


def _check_kernel_input(name: str, t: torch.Tensor) -> None:
    # the kernels read (x, y) pairs as 8-byte loads
    if not t.is_contiguous() or t.data_ptr() % 8:
        raise ValueError(
            f"the kernel takes contiguous, 8-byte aligned tensors: {name}")


def _scratch(c: int, p: int, device: torch.device):
    """The prologue's outputs and its scratch: records (C * P, 4), offsets
    (C + 1,), counts (C,). The kernels index edges with 32-bit integers."""
    if c * p >= 2 ** 31:
        raise ValueError(f"at most 2^31 - 1 edges per launch, got {c * p}")
    return (torch.empty((c * p, 4), dtype=torch.float32, device=device),
            torch.empty(c + 1, dtype=torch.int32, device=device),
            torch.empty(c, dtype=torch.int32, device=device))


def live_edges_padded(polys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's prologue alone, for CUDA tensors, without waiting for
    the device: ``records`` comes back (C * P, 4) with its first
    ``offsets[-1]`` rows written, a polygon's records in the kernel's own
    order; ``offsets`` as ``live_edges_ref`` gives them."""
    global live_edges_launches
    _check_polys(polys)
    if polys.device.type != "cuda":
        raise ValueError(f"the prologue runs on CUDA tensors, got {polys.device}")
    _check_kernel_input("polys", polys)
    c, p, _ = polys.shape
    records, offsets, counts = _scratch(c, p, polys.device)
    if c == 0:
        return records, offsets.zero_()
    lib = load_kernel()
    with torch.cuda.device(polys.device):
        stream = torch.cuda.current_stream(polys.device).cuda_stream
        rc = lib.eitx_pip_edges(
            polys.data_ptr(), records.data_ptr(), offsets.data_ptr(),
            counts.data_ptr(), c, p, stream,
        )
    if rc != 0:
        raise RuntimeError(f"eitx_pip_edges launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        live_edges_launches += 1
    return records, offsets


def live_edges(polys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``live_edges_ref`` through the kernel's prologue for CUDA tensors
    (it waits for the device to learn the number of records): the same
    offsets and, per polygon, the same records in the kernel's own order.
    CPU tensors go through ``live_edges_ref``."""
    if polys.device.type == "cpu":
        _check_polys(polys)
        return live_edges_ref(polys)
    records, offsets = live_edges_padded(polys)
    return records[:int(offsets[-1].item())], offsets


def points_in_polys(points: torch.Tensor, polys: torch.Tensor) -> torch.Tensor:
    """(Q, 2) float32 points x (C, P, 2) float32 closed polygons -> (Q, C)
    bool even-odd containment. CUDA tensors go through the kernel, CPU
    tensors through ``points_in_polys_ref``."""
    global pip_launches
    _check(points, polys)
    if points.device.type == "cpu":
        return points_in_polys_ref(points, polys)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_kernel_input("points", points)
    _check_kernel_input("polys", polys)
    q = points.shape[0]
    c, p, _ = polys.shape
    if q >= 2 ** 31:
        raise ValueError(f"at most 2^31 - 1 points per launch, got {q}")
    out = torch.empty((q, c), dtype=torch.uint8, device=points.device)
    if q == 0 or c == 0:
        return out.view(torch.bool)
    records, offsets, counts = _scratch(c, p, points.device)
    lib = load_kernel()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.eitx_pip(
            points.data_ptr(), polys.data_ptr(), out.data_ptr(),
            records.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
            q, c, p, stream,
        )
    if rc != 0:
        raise RuntimeError(f"eitx_pip launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        pip_launches += 1
    return out.view(torch.bool)
