"""Device milliseconds a subject in the low-rank factorisation
(``fem/spectral.py`` ``_lowrank_core``: Cholesky, triangular solves, the
lung block's ``eigh``), between the CUDA events of the program's span
``eitx.fem.setup.factor``, over ``eitx.fem.subjects``."""

from eitx_torch.core import timing


def read(ctx):
    recorded = getattr(timing, "recorded", None)
    if recorded is None or not ctx["steps"] or \
            not ctx["layer"].get("subjects"):
        return None
    spans, counters = recorded()
    s = spans.get("eitx.fem.setup.factor")
    n = counters.get("eitx.fem.subjects")
    if not s or not s["calls"] or not n or s["device_s"] is None:
        return None
    return s["device_s"] / n * 1e3
