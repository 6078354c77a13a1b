from .cleanup import cleanup_labels
from .colorize import (
    bgr_to_labels,
    class_canvases,
    labels_to_bgr,
    overlay_with_transparency,
)

__all__ = [
    "cleanup_labels",
    "bgr_to_labels",
    "class_canvases",
    "labels_to_bgr",
    "overlay_with_transparency",
]
