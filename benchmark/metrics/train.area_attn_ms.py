"""Device milliseconds a training step in YOLO12's area attention forward
(``models/yolo/blocks.py`` ``AAttn``, 16 calls a step at scale l),
between the CUDA events of the program's span ``eitx.train.area_attn``,
over the calls of ``eitx.train.step``. None where the program has no
such span (a YOLOv11 cell, or a program without YOLO12)."""

from eitx_torch.core import timing

SPAN = "eitx.train.area_attn"


def read(ctx):
    recorded = getattr(timing, "recorded", None)
    if recorded is None or not ctx["steps"]:
        return None
    spans, _ = recorded()
    steps = spans.get("eitx.train.step", {}).get("calls")
    s = spans.get(SPAN)
    if not steps or not s or not s["calls"] or s["device_s"] is None:
        return None
    return s["device_s"] / steps * 1e3
