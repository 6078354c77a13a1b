"""Operations and bytes the measured work needs, from its shapes.

``lowrank_setup_flops`` and ``lowrank_solve_flops`` are
``bench_torch.py``'s (lines 265-287) with one correction: they take a
subject's own node count ``n`` and lung rank ``m`` (its lung nodes, the
grounded node left out), not the padded node count and the rank bucket.
The roofline counts the work these inputs need, so a change that cuts
padding gains share and never loses it.

``TrainFlops`` counts a network step's convolutions and matrix products
as ``torch.utils.flop_counter.FlopCounterMode`` does (its
``conv_flop_count``, ``conv_backward_flop`` and ``mm_flop`` formulas,
torch 2.x ``torch/utils/flop_counter.py``), frozen here so that a torch
release that counts otherwise cannot move the metric.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def lowrank_setup_flops(n: int, m: int, n_exc: int) -> float:
    """FLOPs of one subject's low-rank spectral setup.

    Convention (the work of the algorithm, whatever implements it): a
    Cholesky of an a x a matrix a^3/3; a triangular solve of an a x a
    factor against k right-hand sides a^2 k; a product (a x k)(k x c)
    2akc; a symmetric eigendecomposition with its vectors 9a^3. Per
    subject: chol(K_base) n^3/3; L \\ [S, B] n^2 (m + n_exc); G = P^T P
    2nm^2; chol(G) m^3/3; C^T (Kl_s C) 4m^3; eigh 9m^3; C^-T Z m^3;
    Q = P Y 2nm^2; L^-T [Q, C0] n^2 (m + n_exc); Q^T C0 2nm n_exc."""
    return float(n ** 3 / 3 + 2 * n ** 2 * (m + n_exc) + 4 * n * m ** 2
                 + m ** 3 / 3 + 4 * m ** 3 + 9 * m ** 3 + m ** 3
                 + 2 * n * m * n_exc)


def lowrank_setup_bytes(n: int, m: int, n_exc: int, n_el: int,
                        itemsize: int = 4) -> float:
    """Bytes the setup must move: its inputs read once (K_base n x n, the
    lung block m x m, the injection block n x n_exc) and its outputs
    written once (s2 m, u0 n_el x n_exc, yq m x n_exc, zq n_el x m)."""
    return float(itemsize * (n * n + m * m + n * n_exc
                             + m + n_el * n_exc + m * n_exc + n_el * m))


def lowrank_solve_flops(t: int, m: int, n_readings: int) -> float:
    """FLOPs of one subject's solve: the (t, m) x (m, n_readings) product
    (the rest is elementwise)."""
    return float(2 * t * m * n_readings)


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> float:
    """``conv_flop_count``: 2 x batch x spatial points x filter x channels
    (the output's points, or the input's for a transposed convolution)."""
    conv_shape = (x_shape if transposed else out_shape)[2:]
    return float(x_shape[0] * math.prod(conv_shape) * math.prod(w_shape[2:])
                 * w_shape[0] * w_shape[1] * 2)


def _t(shape):
    return [shape[1], shape[0]] + list(shape[2:])


def _conv_backward_flops(grad_out, x, w, transposed, output_mask) -> float:
    """``conv_backward_flop``: the input's gradient as the transposed
    convolution, the weight's as a convolution of the input (or of the
    output's gradient, when transposed)."""
    total = 0.0
    if output_mask[0]:
        total += _conv_flops(grad_out, w, x, not transposed)
    if output_mask[1]:
        total += (_conv_flops(_t(grad_out), _t(x), _t(w), False) if transposed
                  else _conv_flops(_t(x), _t(grad_out), _t(w), False))
    return total


class TrainFlops(TorchDispatchMode):
    """While open, ``self.flops`` adds the FLOPs of every convolution, its
    backward, and every matrix product that runs."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        aten = torch.ops.aten
        if packet in (aten.convolution, aten._convolution,
                      aten.cudnn_convolution):
            transposed = packet is not aten.cudnn_convolution and bool(
                args[6])
            self.flops += _conv_flops(list(args[0].shape),
                                      list(args[1].shape),
                                      list(out.shape), transposed)
        elif packet is aten.convolution_backward:
            self.flops += _conv_backward_flops(
                list(args[0].shape), list(args[1].shape),
                list(args[2].shape), bool(args[7]), args[10])
        elif packet in (aten.mm, aten.addmm):
            a, b = (args[0], args[1]) if packet is aten.mm else (args[1],
                                                                  args[2])
            self.flops += 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        elif packet in (aten.bmm, aten.baddbmm):
            a, b = (args[0], args[1]) if packet is aten.bmm else (args[1],
                                                                  args[2])
            self.flops += 2.0 * a.shape[0] * a.shape[1] * a.shape[2] \
                * b.shape[2]
        return out
