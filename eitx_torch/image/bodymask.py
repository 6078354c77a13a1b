"""Body mask extraction on the device.

Port of eitx/image/bodymask.py:26-57. Reference behaviour
(get_axial_slice_body_mask, utils.py:526-585): threshold HU in
(-500, 1000) -> 5x5 morphological open -> keep the largest connected
component -> fill it solid -> 0/255 uint8 mask. The DICOM variant's flipud
quirk is a flag (the NIfTI variant skips it, utils.py:588-618).
"""

from __future__ import annotations

import torch

from ..core.device import to_device
from .cc import fill_holes_batch, largest_component_batch
from .morphology import binary_open


def body_mask_from_hu(
    hu_img,
    hu_min: float = -500.0,
    hu_max: float = 1000.0,
    open_kernel: int = 5,
    flipud: bool = False,
    device="cuda",
) -> torch.Tensor:
    """(H, W) HU image -> (H, W) uint8 {0, 255} body mask."""
    hu = to_device(hu_img, device).to(torch.float32)
    return body_mask_from_hu_batch(hu[None], hu_min, hu_max, open_kernel,
                                   flipud)[0]


def body_mask_from_hu_batch(
    hu_stack,
    hu_min: float = -500.0,
    hu_max: float = 1000.0,
    open_kernel: int = 5,
    flipud: bool = False,
    device="cuda",
) -> torch.Tensor:
    """(B, H, W) HU stack -> (B, H, W) uint8 {0, 255} masks, each equal to
    ``body_mask_from_hu`` of its image; the fixpoint loops run once over
    the whole stack."""
    hu = to_device(hu_stack, device).to(torch.float32)
    if flipud:
        hu = hu.flip(-2)
    m = (hu > hu_min) & (hu < hu_max)
    m = binary_open(m, open_kernel)
    m = largest_component_batch(m)
    m = fill_holes_batch(m)
    return m.to(torch.uint8) * 255
