"""Frozen copy of eitx_torch/models/yolo/resize.py as of commit 82a40b4, copied
unchanged but for this note.

Bilinear resize with half-pixel centres as ``jax.image.resize(...,
"bilinear")`` computes it: a product with one weight matrix per axis, the
triangle widened by the shrink factor when an axis shrinks
(antialiasing). Used by the letterbox, the mask composition and the
trainer's proto upsample."""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import rounding


def triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of a bilinear resize of one axis with
    half-pixel centres, the triangle widened by the shrink factor when
    the axis shrinks (antialiasing) and each row normalized: the matrix
    ``jax.image.resize(..., "bilinear")`` builds, in its float32 steps.
    The sample positions ``(i + 0.5) * inv_scale - 0.5`` are rounded once,
    as the fused multiply-add of the compiled reference rounds them
    (two roundings move a weight by 1.5e-5 on a 512-pixel axis)."""
    f32 = np.float32
    inv_scale = f32(n_in / n_out)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out, dtype=np.float64) + 0.5)
              * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :])
    w = np.maximum(f32(0.0), f32(1.0) - x / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    return w.astype(f32)


@functools.lru_cache(maxsize=64)
def axis_weights(n_in: int, n_out: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """``triangle_weights`` on ``device``, uploaded once per shape: an
    upload from pageable host memory waits for the work queued before it,
    so one per call would stall every training step."""
    return torch.from_numpy(triangle_weights(n_in, n_out)).to(device, dtype)


def resize_bilinear(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(..., H, W) -> (..., nh, nw). ``F.interpolate`` computes the same
    function but rounds its sample positions another way when it
    antialiases, which shows as 1e-5 on a shrunk 700-pixel axis; the
    letterbox has to agree with the reference more closely than that.
    In bfloat16 the reference rounds the weights, resizes the rows and
    rounds, then the columns and rounds again."""
    h, w = x.shape[-2:]
    wh = axis_weights(h, nh, x.device, x.dtype)
    ww = axis_weights(w, nw, x.device, x.dtype)
    if x.dtype == torch.float32:
        return torch.einsum("ph,...hw,qw->...pq", wh, x, ww)
    x = rounding.einsum("ph,...hw->...pw", wh, x)
    return rounding.einsum("qw,...pw->...pq", ww, x)
