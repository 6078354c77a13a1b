from .hu import hu_transform, window_normalize
from .normalize import minmax_normalize_u8
from .morphology import binary_close, binary_dilate, binary_erode, binary_open
from .cc import (
    fill_holes,
    fill_holes_batch,
    label_components,
    label_components_batch,
    largest_component,
    largest_component_batch,
)
from .bodymask import body_mask_from_hu, body_mask_from_hu_batch
from .orientation import axial_stack_to_frontal

__all__ = [
    "hu_transform",
    "window_normalize",
    "minmax_normalize_u8",
    "binary_close",
    "binary_dilate",
    "binary_erode",
    "binary_open",
    "fill_holes",
    "fill_holes_batch",
    "label_components",
    "label_components_batch",
    "largest_component",
    "largest_component_batch",
    "body_mask_from_hu",
    "body_mask_from_hu_batch",
    "axial_stack_to_frontal",
]
