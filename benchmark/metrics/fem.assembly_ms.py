"""Milliseconds a subject in ``fem/assembly.py``: ``ClassStiffness.build``
between two CUDA events."""


def read(ctx):
    n = ctx["layer"].get("subjects", 0)
    if not n or not ctx["spans"].count("bench.fem.assembly"):
        return None
    return ctx["spans"].seconds("bench.fem.assembly") / n * 1e3
