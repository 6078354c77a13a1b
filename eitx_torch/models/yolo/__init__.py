from .checkpoint import flax_to_torch_state, read_msgpack_checkpoint
from .infer import TissueSegmenter, YoloRunner, letterbox_params
from .model import YoloV11, yolov11_spec
from .post import (
    Detections,
    compose_label_image,
    decode_detections,
    nms_batched,
    postprocess_segment_labels,
)

__all__ = [
    "flax_to_torch_state",
    "read_msgpack_checkpoint",
    "TissueSegmenter",
    "YoloRunner",
    "letterbox_params",
    "YoloV11",
    "yolov11_spec",
    "Detections",
    "compose_label_image",
    "decode_detections",
    "nms_batched",
    "postprocess_segment_labels",
]
