"""Iterate a tensor step to its fixpoint: the counterpart of the
reference's ``lax.while_loop(lambda s: s.changed, ...)`` loops."""

from __future__ import annotations

from typing import Callable

import torch

# steps between two convergence checks; each check waits for the device
CHECK_EVERY = 8


def fixpoint(step: Callable[[torch.Tensor], torch.Tensor],
             x: torch.Tensor) -> torch.Tensor:
    """Iterate ``step`` from ``x`` until it no longer changes ``x``.

    Every sequence ``step`` generates must end constant (true of the
    monotone label and flood steps, and of the triangular NMS recursion).
    Then ``step^k(x) == x`` makes the tail periodic and so constant: the
    result is the fixpoint the reference's check-after-every-step loop
    returns.
    """
    while True:
        prev = x
        for _ in range(CHECK_EVERY):
            x = step(x)
        if torch.equal(x, prev):
            return x
