"""Frozen copy of eitx_torch/train/losses.py as of commit 82a40b4, copied
unchanged but for this note.

Detection / segmentation losses (YOLO-style).

Port of eitx/train/losses.py (``ciou``, ``dfl_loss``, ``bce`` /
``optax_sigmoid_bce``). Bounds are taken with ``torch.maximum`` /
``torch.minimum`` against tensors, never ``torch.clamp``: JAX's
``maximum``, ``minimum`` and ``clip`` split the gradient between the two
operands where they tie, and so do torch's ``maximum`` and ``minimum``,
while ``clamp`` passes all of it through.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0)``: maximum against zero, the gradient split on a
    tie."""
    return torch.maximum(x, torch.zeros_like(x))


def ciou(box1: torch.Tensor, box2: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Complete-IoU between xyxy boxes (..., 4); returns (...,)."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = _max0(x2 - x1) * _max0(y2 - y1)
    w1 = _max0(box1[..., 2] - box1[..., 0])
    h1 = _max0(box1[..., 3] - box1[..., 1])
    w2 = _max0(box2[..., 2] - box2[..., 0])
    h2 = _max0(box2[..., 3] - box2[..., 1])
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    # enclosing box diagonal
    cw = (torch.maximum(box1[..., 2], box2[..., 2])
          - torch.minimum(box1[..., 0], box2[..., 0]))
    chh = (torch.maximum(box1[..., 3], box2[..., 3])
           - torch.minimum(box1[..., 1], box2[..., 1]))
    c2 = cw**2 + chh**2 + eps
    cx1 = (box1[..., 0] + box1[..., 2]) / 2
    cy1 = (box1[..., 1] + box1[..., 3]) / 2
    cx2 = (box2[..., 0] + box2[..., 2]) / 2
    cy2 = (box2[..., 1] + box2[..., 3]) / 2
    rho2 = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2
    v = (4 / math.pi**2) * (
        torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))
    ) ** 2
    alpha = v / (v - iou + 1 + eps)
    return iou - rho2 / c2 - alpha.detach() * v


def dfl_loss(box_logits: torch.Tensor, target_dist: torch.Tensor,
             reg_max: int) -> torch.Tensor:
    """Distribution focal loss: CE against the two bins bracketing the
    target distance. box_logits (..., 4, reg_max), target (..., 4)."""
    t = target_dist.clamp(0, reg_max - 1 - 1e-3)  # a target: no gradient
    tl = torch.floor(t).to(torch.int64)
    tr = tl + 1
    wl = tr.to(box_logits.dtype) - t
    wr = 1.0 - wl
    logp = F.log_softmax(box_logits, dim=-1)
    ll = torch.gather(logp, -1, tl[..., None])[..., 0]
    lr = torch.gather(logp, -1, tr[..., None])[..., 0]
    return -(wl * ll + wr * lr).mean(-1)


def optax_sigmoid_bce(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    return -labels * log_p - (1.0 - labels) * log_not_p


def bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return optax_sigmoid_bce(logits, targets)
