from .answer import build_answer
from .modes import Pipeline, body_polygon, labels_to_polygons

__all__ = ["Pipeline", "body_polygon", "build_answer", "labels_to_polygons"]
