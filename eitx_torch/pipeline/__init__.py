from .answer import build_answer
from .batch import generate_batch, load_manifest
from .modes import Pipeline, body_polygon, labels_to_polygons

__all__ = ["Pipeline", "body_polygon", "build_answer", "generate_batch",
           "labels_to_polygons", "load_manifest"]
