"""Percent of the roofline the spectral setup's kernels reach: the least
time its inputs need (the larger of the setup's FLOPs over the float32
peak and its bytes, each input read once and each output written once,
over the HBM bandwidth; both by each subject's own node count and lung
rank), over the device time of the kernels launched inside the
``build_batch`` / ``build`` range. FLOPs bound it at these sizes."""


def read(ctx):
    us = ctx["trace"].range_device_us.get("bench.fem.setup", 0.0)
    layer, peaks = ctx["layer"], ctx["peaks"]
    if us <= 0 or not peaks or not layer.get("setup_flops"):
        return None
    least = max(layer["setup_flops"] / peaks[1],
                layer["setup_bytes"] / peaks[2])
    return 100.0 * least / (us / 1e6)
