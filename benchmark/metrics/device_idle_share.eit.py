"""Percent of the traced window in which no kernel or copy ran on the
card: 1 - (union of the device intervals) / (the window), FEM cells."""


def read(ctx):
    busy = ctx["trace"].busy_us() / 1e6
    if busy <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx["window_s"])
