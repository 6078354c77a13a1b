"""Milliseconds a subject in ``fem/spectral.py``'s setup:
``LowRankSpectralSolver.build_batch`` (or ``build``) between two CUDA
events, over the subjects it factored."""


def read(ctx):
    n = ctx["layer"].get("subjects", 0)
    if not n or not ctx["spans"].count("bench.fem.setup"):
        return None
    return ctx["spans"].seconds("bench.fem.setup") / n * 1e3
