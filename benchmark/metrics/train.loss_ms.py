"""Device milliseconds a training step in TAL and the four losses
(``train/trainer.py`` ``Trainer._loss_from_outputs``), between the CUDA events
of the program's span ``eitx.train.loss``, over the calls of
``eitx.train.step``."""

from eitx_torch.core import timing

PHASES = ("eitx.train.loss",)


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
