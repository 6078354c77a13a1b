"""Host milliseconds a subject in the low-rank setup before its
factorisation (``fem/spectral.py`` ``_build_stack``: stacking, lung indices,
the selector ``S`` and the right-hand sides built in numpy, their uploads):
the program's span ``eitx.fem.setup.select`` over ``eitx.fem.subjects``."""

from eitx_torch.core import timing


def read(ctx):
    recorded = getattr(timing, "recorded", None)
    if recorded is None or not ctx["steps"] or \
            not ctx["layer"].get("subjects"):
        return None
    spans, counters = recorded()
    s = spans.get("eitx.fem.setup.select")
    n = counters.get("eitx.fem.subjects")
    if not s or not s["calls"] or not n or s["host_s"] is None:
        return None
    return s["host_s"] / n * 1e3
