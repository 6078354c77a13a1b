"""Host milliseconds a subject in the voltages' copy to the host at the
end of both simulate functions (``fem/forward.py``), which waits for the
card's queued work: the program's span ``eitx.fem.readback`` over
``eitx.fem.subjects``."""

from eitx_torch.core import timing


def read(ctx):
    recorded = getattr(timing, "recorded", None)
    if recorded is None or not ctx["steps"] or \
            not ctx["layer"].get("subjects"):
        return None
    spans, counters = recorded()
    s = spans.get("eitx.fem.readback")
    n = counters.get("eitx.fem.subjects")
    if not s or not s["calls"] or not n or s["host_s"] is None:
        return None
    return s["host_s"] / n * 1e3
