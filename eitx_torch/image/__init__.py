from .hu import hu_transform, window_normalize
from .normalize import minmax_normalize_u8
from .morphology import binary_close, binary_dilate, binary_erode, binary_open
from .cc import fill_holes, label_components, largest_component
from .bodymask import body_mask_from_hu
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
    "label_components",
    "largest_component",
    "body_mask_from_hu",
    "axial_stack_to_frontal",
]
