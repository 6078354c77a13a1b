"""Frozen copy of eitx_torch/models/yolo/rounding.py as of commit 82a40b4,
copied unchanged but for this note.

bfloat16 arithmetic rounded where the JAX package's compiled programs
round it.

The JAX package runs its serving segmenter in bfloat16 (every variable and
activation). XLA computes each bfloat16 operation in float32 and rounds the
result, except where its compiled program keeps a float32 value that the
source only converts: a row sum over ``exp`` reads the float32 ``exp``, a
product accumulates in float32 over its whole contraction. A torch op on
bfloat16 also computes in float32 and rounds once, so writing each function
as the same sequence of elementary ops reproduces the reference where the
fused op (``F.silu``, ``torch.sigmoid``, ``torch.softmax``) rounds once for
the whole function and disagrees on a third of the elements.

On float32 every function here is the plain torch one.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


@functools.lru_cache(maxsize=None)
def constant(value: float, dtype: torch.dtype) -> float:
    """A Python number as jax holds it against a ``dtype`` operand (a
    weakly typed constant): rounded to ``dtype``."""
    return float(torch.tensor(value, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each operation rounded (XLA's logistic)."""
    if x.dtype != BF16:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax's ``nn.silu``: ``x * sigmoid(x)``, each operation rounded."""
    if x.dtype != BF16:
        return F.silu(x)
    return x * sigmoid(x)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax's ``nn.softmax`` as compiled: ``x - max`` rounds, ``exp``
    reaches the row sum in float32 and the sum rounds, the numerator is
    the rounded ``exp``, the quotient rounds."""
    if x.dtype != BF16:
        return torch.softmax(x, dim)
    e = torch.exp((x - x.amax(dim, keepdim=True)).float())
    return e.to(BF16) / e.sum(dim, keepdim=True).to(BF16)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """A bfloat16 product accumulated in float32 and rounded once, on
    every device (a bfloat16 matmul may reduce in bfloat16 on the card)."""
    dtype = operands[0].dtype
    if dtype != BF16:
        return torch.einsum(eq, *operands)
    return torch.einsum(eq, *(t.float() for t in operands)).to(dtype)
