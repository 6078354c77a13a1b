from .harness import PixelLevelEvaluator
from .metrics import (
    confusion_counts,
    evaluate_dataset,
    mask_from_yolo_labels,
    pixel_metrics,
    print_results,
)

__all__ = [
    "PixelLevelEvaluator",
    "confusion_counts",
    "evaluate_dataset",
    "mask_from_yolo_labels",
    "pixel_metrics",
    "print_results",
]
