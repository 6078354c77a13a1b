"""Min-max normalization to uint8 (cv2.normalize NORM_MINMAX parity,
used for the frontal slice at ai_tools.py:101).

Port of eitx/image/normalize.py:10-16.
"""

from __future__ import annotations

import torch

from ..core.device import to_device


def minmax_normalize_u8(img, device="cuda") -> torch.Tensor:
    x = to_device(img, device).to(torch.float32)
    lo, hi = x.min(), x.max()
    span = torch.where(hi - lo == 0, torch.ones_like(hi), hi - lo)
    # torch.round rounds half to even, as jnp.round does
    return torch.round((x - lo) / span * 255.0).to(torch.uint8)
