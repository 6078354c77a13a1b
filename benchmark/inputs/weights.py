"""Initial network parameters, drawn on the card from the seed.

One normal draw for all the kernels at once, cut at two standard
deviations and scaled to lecun-normal over each kernel's fan-in
(everything but its first axis), as flax's ``lecun_normal`` initialises
the network the port mirrors; BatchNorm scales and running variances are
one, every other vector zero. The same tensors go to the program and to
the reference.
"""

from __future__ import annotations

import math

import torch

_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) cut at +-2


def initial_state(params: dict, stats: dict, seed: int,
                  device: torch.device):
    """(params, batch statistics) of the shapes of ``params`` and
    ``stats`` (name -> tensor), drawn from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2654435761 + 97) % (1 << 63))
    kernels = [n for n, t in params.items() if t.dim() >= 2]
    total = sum(params[n].numel() for n in kernels)
    draw = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for n, t in params.items():
        if t.dim() >= 2:
            fan_in = math.prod(t.shape[1:])
            out[n] = (draw[at:at + t.numel()].view(t.shape)
                      / (math.sqrt(fan_in) * _TRUNC_STD))
            at += t.numel()
        else:
            out[n] = torch.full(t.shape, float(n.endswith("weight")),
                                device=device)
    bstats = {n: torch.full(t.shape, float(n.endswith("running_var")),
                            dtype=t.dtype, device=device)
              for n, t in stats.items()}
    return out, bstats
