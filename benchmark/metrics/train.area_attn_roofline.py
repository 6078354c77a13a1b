"""Percent of its roofline that YOLO12's area attention forward reaches:
the least time its work needs a step (the larger of its FLOPs over the
float32 peak and its bytes over the HBM bandwidth, ``lib/area_attn.py``
from the configuration's shapes) times the traced steps, over the device
time of the program's span ``eitx.train.area_attn`` (CUDA events around
each ``AAttn.forward``). None where the program has no such span."""

from eitx_torch.core import timing


def read(ctx):
    recorded = getattr(timing, "recorded", None)
    layer, peaks = ctx["layer"], ctx["peaks"]
    if recorded is None or not peaks or not ctx["steps"] or \
            not layer.get("area_attn_flops"):
        return None
    s = recorded()[0].get("eitx.train.area_attn")
    if not s or not s["device_s"]:
        return None
    least = max(layer["area_attn_flops"] / peaks[1],
                layer["area_attn_bytes"] / peaks[2])
    return 100.0 * least * ctx["steps"] / s["device_s"]
