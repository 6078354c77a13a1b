"""Megabytes a subject that the FEM call uploads from host arrays to the
card (``fem/assembly.py`` ``upload``: the mesh, the lung selector ``S``, the
right-hand sides, indices and masks): the program's counter
``eitx.fem.upload_bytes`` over ``eitx.fem.subjects``, in 1e6 bytes."""

from eitx_torch.core import timing


def read(ctx):
    recorded = getattr(timing, "recorded", None)
    if recorded is None or not ctx["steps"] or \
            not ctx["layer"].get("subjects"):
        return None
    _, counters = recorded()
    n = counters.get("eitx.fem.subjects")
    if not n or not counters.get("eitx.fem.upload_bytes"):
        return None
    return counters["eitx.fem.upload_bytes"] / n / 1e6
