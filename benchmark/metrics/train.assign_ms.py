"""Device milliseconds a training step in the task-aligned assigner
(``train/trainer.py`` ``_assign_tal``, inside the loss), between the CUDA
events of the program's span ``eitx.train.assign``, over the calls of
``eitx.train.step``."""

from eitx_torch.core import timing

PHASES = ("eitx.train.assign",)


def read(ctx):
    recorded = getattr(timing, "recorded", None)
    if recorded is None or not ctx["steps"]:
        return None
    spans, _ = recorded()
    steps = spans.get("eitx.train.step", {}).get("calls")
    got = [spans.get(p) for p in PHASES]
    if not steps or not all(s and s["calls"] for s in got) or \
            any(s["device_s"] is None for s in got):
        return None
    return sum(s["device_s"] for s in got) / steps * 1e3
