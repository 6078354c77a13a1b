"""Percent of the card's float32 peak that the traced window's FEM work
is: the FLOPs of the setup and solve of every subject it simulated (by
each subject's own node count and lung rank), over the window's seconds,
over 66.9 TFLOP/s (TF32 is off on the FEM path)."""


def read(ctx):
    layer, peaks = ctx["layer"], ctx["peaks"]
    flops = layer.get("setup_flops", 0.0) + layer.get("solve_flops", 0.0)
    if not peaks or flops <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * flops / ctx["window_s"] / peaks[1]
