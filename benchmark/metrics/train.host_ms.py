"""Host milliseconds a training step in all the host does for it: the
program's spans ``eitx.train.batch`` (``train/data.py`` ``device_batches``'
draw), ``eitx.train.step`` (``train/trainer.py`` ``Trainer.train_step``) and
``eitx.train.ema`` (``EMA.update``), over the calls of ``eitx.train.step``.
Near the window's time a step, the host sets the pace."""

from eitx_torch.core import timing

PHASES = ("eitx.train.batch", "eitx.train.step", "eitx.train.ema")


def read(ctx):
    recorded = getattr(timing, "recorded", None)
    if recorded is None or not ctx["steps"]:
        return None
    spans, _ = recorded()
    steps = spans.get("eitx.train.step", {}).get("calls")
    got = [spans.get(p) for p in PHASES]
    if not steps or not all(s and s["calls"] for s in got) or \
            any(s["host_s"] is None for s in got):
        return None
    return sum(s["host_s"] for s in got) / steps * 1e3
