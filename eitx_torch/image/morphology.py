"""Binary morphology via pooling (OpenCV morphologyEx parity).

Port of eitx/image/morphology.py:19-54: the reference's ``reduce_window``
becomes a max-pool. The reference uses 3x3/5x5 rectangular kernels
throughout (utils.py:562,569,813; scripts). Erosion = min-pool, dilation =
max-pool, open = erode-then-dilate, close = dilate-then-erode. Works on
(..., H, W) boolean or {0,1} arrays. Pixels outside the image take no part
in either pool: dilation never grows from the border and erosion does not
eat into a mask that touches it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.device import to_device


def window_max(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(..., H, W) float max over a (kh, kw) window centred on each pixel;
    pixels outside the image are ignored."""
    h, w = x.shape[-2:]
    return F.max_pool2d(
        x.reshape(-1, 1, h, w), (kh, kw), stride=1,
        padding=(kh // 2, kw // 2),
    ).reshape(x.shape)


def window_or(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(..., H, W) bool: any pixel set in the (kh, kw) window."""
    return window_max(x.to(torch.float32), kh, kw) > 0


def _window_and(x: torch.Tensor, k: int) -> torch.Tensor:
    return window_max(-x.to(torch.float32), k, k) == -1


def _mask(mask, device) -> torch.Tensor:
    return to_device(mask, device).to(torch.bool)


def binary_dilate(mask, k: int = 3, device="cuda") -> torch.Tensor:
    return window_or(_mask(mask, device), k, k)


def binary_erode(mask, k: int = 3, device="cuda") -> torch.Tensor:
    return _window_and(_mask(mask, device), k)


def binary_open(mask, k: int = 5, device="cuda") -> torch.Tensor:
    return window_or(_window_and(_mask(mask, device), k), k, k)


def binary_close(mask, k: int = 5, device="cuda") -> torch.Tensor:
    return _window_and(window_or(_mask(mask, device), k, k), k)
