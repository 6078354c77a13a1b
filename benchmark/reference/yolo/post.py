"""``_dfl`` of eitx_torch/models/yolo/post.py (lines 44-51) as of commit
82a40b4: the distribution-focal decode the trainer's box loss uses."""

from __future__ import annotations

import torch

from . import rounding


def _dfl(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution-focal decode: (..., 4*reg_max) -> (..., 4) expected
    distances in stride units."""
    shape = box_logits.shape[:-1]
    p = rounding.softmax(box_logits.reshape(*shape, 4, reg_max), dim=-1)
    # the products and their sum stay float32 until the sum rounds
    bins = torch.arange(reg_max, dtype=torch.float32, device=p.device)
    return (p.float() * bins).sum(-1).to(p.dtype)
