"""Milliseconds a step of the convolutions' gradient kernels: the device
time of the kernels whose names hold ``wgrad`` or ``dgrad`` (cuDNN's
weight and input gradient engines, the depthwise
``wgrad2d_grouped_direct_kernel`` among them), over the traced steps."""

import re

GRAD = re.compile(r"wgrad|dgrad")


def read(ctx):
    us = ctx["trace"].kernel_us(lambda name: bool(GRAD.search(name)))
    if us <= 0 or not ctx["steps"]:
        return None
    return us / ctx["steps"] / 1e3
