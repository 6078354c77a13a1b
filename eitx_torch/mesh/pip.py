"""Batched even-odd point-in-polygon containment: CUDA kernel + plain version.

``points_in_polys`` is the triangle classifier's containment test. For
CUDA tensors it launches the hand-written kernel in
``eitx_torch/csrc/pip.cu`` (the port of the TPU kernel
``eitx/mesh/pallas_pip.py:points_in_polys_pallas``); for CPU tensors it
runs ``points_in_polys_ref``, the plain PyTorch version of the same
arithmetic. There is no fallback between the two: a CUDA tensor launches
the kernel or raises.

The kernel is built with ``nvcc`` for ``sm_90a`` into
``eitx_torch/_build/`` at its first launch (and again whenever the source
or the flags change), and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from .._build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "csrc", "pip.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_LIB: Optional[ctypes.CDLL] = None

# launches of the CUDA kernel since the count was last set to 0
pip_launches = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def load_kernel() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _LIB
    if _LIB is None:
        so = build_shared(os.path.abspath(_SRC), "libeitxpip",
                          [_nvcc(), *NVCC_FLAGS])
        lib = ctypes.CDLL(so)
        lib.eitx_pip.restype = ctypes.c_int
        lib.eitx_pip.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        _LIB = lib
    return _LIB


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


def _check(points: torch.Tensor, polys: torch.Tensor) -> None:
    if points.dtype != torch.float32 or polys.dtype != torch.float32:
        raise TypeError(
            f"points_in_polys takes float32, got {points.dtype}, {polys.dtype}")
    if points.ndim != 2 or points.shape[1] != 2:
        raise ValueError(f"points must be (Q, 2), got {tuple(points.shape)}")
    if polys.ndim != 3 or polys.shape[2] != 2 or polys.shape[1] < 1:
        raise ValueError(f"polys must be (C, P, 2), got {tuple(polys.shape)}")
    if points.device != polys.device:
        raise ValueError(
            f"points on {points.device}, polys on {polys.device}")


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
    if not (points.is_contiguous() and polys.is_contiguous()):
        raise ValueError("points_in_polys takes contiguous tensors")
    q = points.shape[0]
    c, p, _ = polys.shape
    if c > 65535:
        raise ValueError(f"at most 65535 polygons per launch, got {c}")
    out = torch.empty((q, c), dtype=torch.uint8, device=points.device)
    if q == 0 or c == 0:
        return out.view(torch.bool)
    lib = load_kernel()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.eitx_pip(
            points.data_ptr(), polys.data_ptr(), out.data_ptr(),
            q, c, p, stream,
        )
    if rc != 0:
        raise RuntimeError(f"eitx_pip launch failed: CUDA error {rc}")
    pip_launches += 1
    return out.view(torch.bool)
