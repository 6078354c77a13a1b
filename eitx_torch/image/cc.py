"""Connected-component labelling on the device.

Port of ``label_components`` (eitx/image/cc.py:50-84): one 3x3
label-propagation step followed by two pointer-jumping steps per
iteration, so convergence takes O(log diameter) iterations rather than
O(diameter). The reference's ``lax.while_loop`` becomes a Python loop
that checks for convergence every few steps (``core.fixpoint``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.fixpoint import fixpoint

def window_max(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(H, W) float max over a (kh, kw) window centred on each pixel;
    pixels outside the image are ignored."""
    return F.max_pool2d(
        x[None, None], (kh, kw), stride=1, padding=(kh // 2, kw // 2)
    )[0, 0]


def _neighbor_max(
    lab: torch.Tensor, mask: torch.Tensor, connectivity: int = 8
) -> torch.Tensor:
    """Neighbourhood max of labels over foreground (8- or 4-connected).

    Labels are flat pixel indices below 2^24, exact in float32, so the
    window max runs as a float max-pool."""
    f = lab.to(torch.float32)
    if connectivity == 8:
        m = window_max(f, 3, 3)
    else:  # 4-connected: plus-shaped neighbourhood via two 1-D windows
        m = torch.maximum(window_max(f, 1, 3), window_max(f, 3, 1))
    return torch.where(mask, m.to(torch.int32), torch.full_like(lab, -1))


def label_components(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """(H, W) bool -> (H, W) int32 labels (-1 background).

    Labels are root flat-indices: two pixels share a component iff their
    labels match. 8-connectivity by default (cv2.findContours semantics);
    ``connectivity=4`` matches scipy.ndimage.label's default.
    """
    mask = mask.to(torch.bool)
    h, w = mask.shape
    if h * w >= 1 << 24:
        raise ValueError(f"image of {h}x{w} pixels is too large to label")
    flat_ids = torch.arange(h * w, dtype=torch.int32,
                            device=mask.device).reshape(h, w)
    lab = torch.where(mask, flat_ids, torch.full_like(flat_ids, -1))

    def jump(lab):
        # label <- label of my label's pixel (pointer doubling)
        flat = lab.reshape(-1)
        j = flat[torch.clamp(flat, min=0).to(torch.int64)]
        j = torch.where(flat >= 0, j, torch.full_like(j, -1))
        return torch.maximum(flat, j).reshape(h, w)

    def step(lab):
        return jump(jump(_neighbor_max(lab, mask, connectivity)))

    return fixpoint(step, lab)
