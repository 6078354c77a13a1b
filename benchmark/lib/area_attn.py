"""Operations and bytes of YOLO12's area attention, from its shapes.

One ``AAttn`` forward on a (B, d, H, W) map with ``h`` heads in ``a``
areas (N = H W tokens, n = N / a a stripe) computes:

- ``qkv``: a 1x1 convolution d -> 3d, 2 B N d 3d, and its BatchNorm;
- the scores, a (n x hd)(hd x n) product per stripe and head, 2 B N n d,
  their scale (one product each) and the softmax over the keys (the
  largest, a difference, an exponential, a sum and a quotient: five
  operations a score), B a h n^2 scores;
- the values' weighted sum, 2 B N n d;
- the position perceiver ``pe``, a depthwise 7x7, 2 B N d 49, and its
  BatchNorm; the sum of the two, B N d;
- ``proj``: a 1x1 convolution d -> d, 2 B N d^2, and its BatchNorm.

A BatchNorm in training is six operations an element: the square, the
two sums of the batch's moments, the difference, the product and the
bias. The bytes are the least the block must move: its input read once,
its parameters (the three kernels, the three BatchNorms' scales and
biases) read once, its output written once, in float32. At the cell's
sizes the FLOPs bound it by three orders of magnitude.
"""

from __future__ import annotations

import math

BN_OPS = 6
SOFTMAX_OPS = 5
KERNEL = 7  # the position perceiver's side


def aattn_forward(batch: int, dim: int, height: int, width: int, heads: int,
                  area: int, itemsize: int = 4):
    """(FLOPs, bytes) of one AAttn forward."""
    tokens = height * width
    stripe = tokens // area
    per_token = (2 * 3 * dim * dim          # qkv
                 + 2 * stripe * dim         # scores
                 + 2 * stripe * dim         # weighted values
                 + 2 * KERNEL * KERNEL * dim  # position perceiver
                 + dim                      # attention + perceiver
                 + 2 * dim * dim            # proj
                 + BN_OPS * (3 * dim + dim + dim))
    scores = batch * area * heads * stripe * stripe
    flops = batch * tokens * per_token + scores * (1 + SOFTMAX_OPS)
    params = 3 * dim * dim + KERNEL * KERNEL * dim + dim * dim \
        + 2 * (3 * dim + dim + dim)
    nbytes = itemsize * (2 * batch * tokens * dim + params)
    return float(flops), float(nbytes)


def network_area_attn(config: dict, batch: int, imgsz: int):
    """(FLOPs, bytes) of every AAttn forward of one step of the
    configuration's YOLO12 network: the two ABlocks of each of the
    ``round(4 depth)`` stages of layers 6 (P4, ``areas[0]``) and 8 (P5,
    ``areas[1]``), each at width c2 / 2 with heads of ``head_dim``."""
    net = config["network"]
    stages = max(round(4 * net["depth"]), 1)
    flops = nbytes = 0.0
    for c, stride, area in ((512, 16, net["areas"][0]),
                            (1024, 32, net["areas"][1])):
        c2 = int(math.ceil(min(c, net["max_channels"]) * net["width"] / 8)
                 * 8)
        dim = c2 // 2
        side = imgsz // stride
        f, b = aattn_forward(batch, dim, side, side, dim // net["head_dim"],
                             area)
        flops += 2 * stages * f
        nbytes += 2 * stages * b
    return flops, nbytes
