"""Hounsfield-unit transform and CT windowing on the device.

Port of eitx/image/hu.py (``hu_transform`` :17, ``window_normalize`` :25).
Both take (..., H, W): a numpy array goes to ``device`` first (unsigned
16-bit pixels widened on the host, torch has no arithmetic on them), a
tensor is used where it lives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import to_device


def hu_transform(pixels, rescale_slope=1.0, rescale_intercept=0.0,
                 device="cuda") -> torch.Tensor:
    """HU = slope * stored_pixel + intercept (DICOM tags 0028,1052/1053),
    float32."""
    x = to_device(pixels, device).to(torch.float32)
    return x * float(rescale_slope) + float(rescale_intercept)


def window_normalize(volume, window_level=40.0, window_width=400.0,
                     rotate_180: bool = True, device="cuda") -> torch.Tensor:
    """CT window -> uint8 (classic_norm parity).

    Clips HU to [level - width//2, level + width//2], scales to [0, 255],
    truncates to uint8, then rotates the image plane 180 degrees (the
    reference's cv2.ROTATE_180 step). Works on (..., H, W).
    """
    # the bounds in float32, the floor division of a float kept, as the
    # reference's traced scalars compute them
    level, width = np.float32(window_level), np.float32(window_width)
    hu_min = float(level - width // np.float32(2))
    hu_max = float(level + width // np.float32(2))
    v = to_device(volume, device).to(torch.float32).clamp(hu_min, hu_max)
    # the span as a tensor on the device: CUDA divides by a host scalar
    # through its reciprocal, and whole-numbered HU then truncate one grey
    # level low wherever the exact quotient is an integer
    span = torch.tensor(np.float32(hu_max) - np.float32(hu_min),
                        dtype=torch.float32, device=v.device)
    v = ((v - hu_min) / span * 255.0).to(torch.uint8)
    if rotate_180:
        v = v.flip(-2, -1)
    return v
