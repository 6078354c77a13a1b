"""Percent of the card's float32 peak that the traced steps' network work
is: one step's FLOPs (convolutions, their backward, matrix products;
``lib/flops.py`` ``TrainFlops`` over the first warm step) times the
steps, over the window's seconds, over 66.9 TFLOP/s (TF32 is off)."""


def read(ctx):
    flops, peaks = ctx["layer"].get("step_flops", 0.0), ctx["peaks"]
    if not peaks or flops <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * flops * ctx["steps"] / ctx["window_s"] / peaks[1]
