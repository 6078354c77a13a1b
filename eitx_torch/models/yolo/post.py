"""Detection decoding, fixed-size NMS and label-image composition.

Port of eitx/models/yolo/post.py (``_dfl``, ``decode_detections``,
``_iou_matrix``, ``nms_fixed`` (here ``nms_batched``, over a batch),
``compose_label_image``, ``postprocess_segment_labels``). The network's
maps arrive in NCHW.

Ties follow the reference:
  - ``jax.lax.top_k`` keeps the lower index first among equal scores; here
    a stable descending sort does the same (``torch.topk`` on CUDA does
    not promise it).
  - ``jnp.argsort`` is stable, so composition paints lowest score first
    and, among equal scores, the later slot wins.
  - a per-class conf lookup clamps the class index, as a JAX gather does.
Greedy NMS keeps candidate i iff no earlier kept candidate of its class
overlaps it above the IoU threshold. That recursion has one solution; it
is found here by iterating the whole keep vector to its fixpoint
(``core.fixpoint``) instead of the reference's per-candidate loop.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ...core.fixpoint import fixpoint


class Detections(NamedTuple):
    """Fixed-size detections: slots beyond ``valid`` are padding."""

    boxes: torch.Tensor  # (..., K, 4) xyxy in input pixels
    scores: torch.Tensor  # (..., K)
    classes: torch.Tensor  # (..., K) int32
    coefs: torch.Tensor  # (..., K, nm) mask coefficients
    valid: torch.Tensor  # (..., K) bool


def _dfl(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution-focal decode: (..., 4*reg_max) -> (..., 4) expected
    distances in stride units."""
    shape = box_logits.shape[:-1]
    p = torch.softmax(box_logits.reshape(*shape, 4, reg_max), dim=-1)
    bins = torch.arange(reg_max, dtype=p.dtype, device=p.device)
    return (p * bins).sum(-1)


def decode_detections(
    outputs: Dict, reg_max: int = 16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw per-level NCHW maps -> flat anchors.

    Returns (boxes (B, A, 4) xyxy px, scores (B, A), classes (B, A),
    coefs (B, A, nm)), in float32 whatever the compute dtype."""
    mask_levels = outputs.get("mask_coefs")
    all_boxes, all_scores, all_classes, all_coefs = [], [], [], []
    for i, (box_map, cls_map) in enumerate(outputs["levels"]):
        box_map = box_map.permute(0, 2, 3, 1)  # (B, H, W, 4*reg_max)
        cls_map = cls_map.permute(0, 2, 3, 1)
        B, H, W, _ = box_map.shape
        stride = outputs["strides"][i]
        d = _dfl(box_map, reg_max)  # (B, H, W, 4) l,t,r,b
        xs = (torch.arange(W, dtype=d.dtype, device=d.device) + 0.5)[None, None, :]
        ys = (torch.arange(H, dtype=d.dtype, device=d.device) + 0.5)[None, :, None]
        x1 = (xs - d[..., 0]) * stride
        y1 = (ys - d[..., 1]) * stride
        x2 = (xs + d[..., 2]) * stride
        y2 = (ys + d[..., 3]) * stride
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1).reshape(B, H * W, 4))
        probs = torch.sigmoid(cls_map).reshape(B, H * W, -1)
        all_scores.append(probs.amax(-1))
        all_classes.append(probs.argmax(-1).to(torch.int32))
        if mask_levels is not None:
            m = mask_levels[i].permute(0, 2, 3, 1)
            all_coefs.append(m.reshape(B, H * W, m.shape[-1]))
    boxes = torch.cat(all_boxes, dim=1).float()
    scores = torch.cat(all_scores, dim=1).float()
    classes = torch.cat(all_classes, dim=1)
    if all_coefs:
        coefs = torch.cat(all_coefs, dim=1).float()
    else:
        coefs = torch.zeros((*scores.shape, 1), dtype=torch.float32,
                            device=scores.device)
    return boxes, scores, classes, coefs


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) -> (..., K, K) pairwise IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, A, ...) gathered at idx (B, K) along axis 1."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def nms_batched(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    coefs: torch.Tensor,
    conf=0.3,
    iou_thresh: float = 0.45,
    max_det: int = 64,
) -> Detections:
    """Greedy per-class NMS over the top-K candidates of each image.

    boxes (B, A, 4), scores (B, A), classes (B, A), coefs (B, A, nm).
    K = 4 * max_det candidates enter; exactly max_det slots come out per
    image with a validity mask. ``conf`` is a scalar or a per-class tuple.
    """
    k_in = min(4 * max_det, scores.shape[1])
    if isinstance(conf, (tuple, list)):
        thr = torch.as_tensor(conf, dtype=scores.dtype, device=scores.device)
        thr = thr[classes.long().clamp(0, len(conf) - 1)]
    else:
        thr = torch.full_like(scores, conf)
    scores = torch.where(scores >= thr, scores, torch.zeros_like(scores))
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k_in], idx[:, :k_in]
    top_boxes = _take(boxes, idx)
    top_classes = _take(classes, idx)
    top_coefs = _take(coefs, idx)
    same_class = top_classes[:, :, None] == top_classes[:, None, :]
    earlier = torch.ones((k_in, k_in), dtype=torch.bool,
                         device=scores.device).tril(diagonal=-1)
    # suppress[b, i, j]: an earlier candidate j, if kept, removes i
    suppress = (_iou_matrix(top_boxes) > iou_thresh) & same_class & earlier
    alive = top_scores > 0

    def step(keep):
        return alive & ~(suppress & keep[:, None, :]).any(dim=-1)

    keep = fixpoint(step, alive)
    # compact the kept boxes into the first max_det slots, rank preserved
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    order = order[:, :max_det]
    valid = torch.gather(keep, 1, order)
    vf = valid.to(torch.float32)
    return Detections(
        boxes=_take(top_boxes, order) * vf[..., None],
        scores=torch.gather(top_scores, 1, order) * vf,
        classes=torch.where(valid, torch.gather(top_classes, 1, order),
                            torch.full_like(order, -1).to(torch.int32)),
        coefs=_take(top_coefs, order) * vf[..., None],
        valid=valid,
    )


def compose_label_image(
    proto: torch.Tensor,
    det: Detections,
    input_hw: Tuple[int, int],
    out_hw: Tuple[int, int],
) -> torch.Tensor:
    """Instance masks -> one (H, W) int32 label image, -1 background.

    proto (nm, Hp, Wp) of one image; det holds that image's slots. Soft
    masks are bilinearly upsampled to ``out_hw`` before the box crop and
    the 0.5 threshold when ``out_hw`` differs from the proto grid (the
    quality path). ``input_hw`` is the network-input resolution the boxes
    live in. Instances paint in ascending score order, so the best one
    wins an overlap.
    """
    _, hp, wp = proto.shape
    in_h, in_w = input_hw
    h, w = out_hw
    m = torch.sigmoid(torch.einsum("kn,nhw->khw", det.coefs.to(proto.dtype),
                                   proto))
    if (h, w) != (hp, wp):
        # for upsampling, half-pixel bilinear with edge clamping is what
        # jax.image.resize(..., "bilinear") computes
        m = F.interpolate(m[None], size=(h, w), mode="bilinear",
                          align_corners=False)[0]
    sx, sy = w / in_w, h / in_h
    bx = det.boxes * torch.tensor([sx, sy, sx, sy], dtype=proto.dtype,
                                  device=proto.device)
    xs = torch.arange(w, dtype=proto.dtype, device=proto.device)[None, None, :]
    ys = torch.arange(h, dtype=proto.dtype, device=proto.device)[None, :, None]
    inside = (
        (xs >= bx[:, 0][:, None, None])
        & (xs < bx[:, 2][:, None, None])
        & (ys >= bx[:, 1][:, None, None])
        & (ys < bx[:, 3][:, None, None])
    )
    hit = (m > 0.5) & inside & det.valid[:, None, None]  # (K, h, w)
    order = torch.argsort(det.scores, stable=True)  # ascending: best last
    k = order.shape[0]
    # the last painted slot covering each pixel wins: rank + 1, 0 = none
    rank = torch.arange(1, k + 1, dtype=torch.int32, device=proto.device)
    last = (hit[order].to(torch.int32) * rank[:, None, None]).amax(dim=0)
    cls = det.classes[order].to(torch.int32)
    return torch.where(last > 0, cls[(last - 1).clamp(min=0).long()],
                       torch.full_like(last, -1))


def postprocess_segment_labels(
    outputs: Dict,
    input_hw: Tuple[int, int],
    conf=0.3,
    iou_thresh: float = 0.45,
    max_det: int = 64,
    reg_max: int = 16,
    out_hw: Tuple[int, int] = None,
) -> Tuple[Detections, torch.Tensor]:
    """Batch detect + composed (B, H, W) int32 label images."""
    boxes, scores, classes, coefs = decode_detections(outputs, reg_max)
    det = nms_batched(boxes, scores, classes, coefs, conf, iou_thresh,
                      max_det)
    proto = outputs["proto"]
    out = out_hw or input_hw
    labels = torch.stack([
        compose_label_image(proto[b], Detections(*(t[b] for t in det)),
                            input_hw, out)
        for b in range(proto.shape[0])
    ])
    return det, labels
