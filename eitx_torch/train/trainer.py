"""Trainer for the YOLOv11 segmenter and the rib detector.

Port of eitx/train/trainer.py: ``TrainConfig``, ``TrainState``,
``_anchors_for`` (:82), the center assigner ``_assign`` (:96), the
task-aligned assigner ``_assign_tal`` (:116), ``_pairwise_iou`` (:150),
``Trainer`` (the loss :207-386, the step :388-401, ``eval_loss`` :403,
``train_step`` :418), ``EMA`` (:439) and ``fit`` (:472). The loss is the
reference's: CIoU + DFL box losses, BCE classification against TAL's soft
targets, per-anchor mask BCE against ``sigmoid(coef @ proto)`` cropped to
the target box; the optimizer is optax's ``chain(clip_by_global_norm(10),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, total), weight_decay))``
written out with ``torch._foreach_*`` ops.

Where the port has to take care to compute what the reference computes:
  - Initial parameters. ``Trainer(cfg, seed)`` starts from flax's
    ``init(PRNGKey(seed))`` parameters, drawn on the host
    (``models/yolo/init.py``), the same bits on every device.
  - Layout. Batches arrive NHWC (images (B, S, S, 3), as the stores hold
    them) and are permuted once at the step's entry; the network is NCHW,
    so the proto is (B, nm, Hp, Wp) and the mask product is
    ``einsum("bkn,bnhw->bkhw")``. ``jax.vmap`` over images becomes
    batched tensor ops.
  - BatchNorm trains as flax's does (``blocks.BatchNorm2d``).
  - The schedule is read at the optimizer count before the increment, so
    with warmup the first step has lr 0; clipping scales by max/norm only
    above the bound, with no epsilon; AdamW decays every parameter,
    BatchNorm's included, and adds ``eps`` outside the square root.
  - Ties. ``jax.lax.top_k`` keeps the lower index among equal values: a
    stable descending sort does the same. JAX's maximum/minimum/clip split
    a gradient at a tie, as ``torch.maximum``/``minimum`` do (losses.py).
  - The proto is upsampled to the mask resolution by the port's resize,
    which builds ``jax.image.resize``'s weights (models/yolo/infer.py).
  - The step runs in float32 with TF32 off (switched off once, when
    ``eitx_torch`` is imported).

On a (data, model) mesh (``Trainer(cfg, mesh=...)``, one process a rank)
one step computes what one step on one device computes on the global
batch, as eitx's step under ``pjit`` does: every rank is given the global
batch and takes its block over ``data``; BatchNorm's batch statistics are
all-reduced over ``data``; the parameters are FSDP2 shards over ``model``
(replicated over ``data``), whose gradients FSDP2 averages over every rank
(the ``model`` ranks of one ``data`` block hold equal gradients, so the
mean over all ranks is the mean over ``data``); the clipping norm sums
the local shards' squares over ``model``; AdamW and the EMA update the
local shards. ``state`` hands out whole tensors, and its setter places
whole tensors into the shards.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.timing import span
from ..models.yolo.blocks import BatchNorm2d
from ..models.yolo.init import flax_init_model
from ..models.yolo.resize import resize_bilinear
from ..models.yolo.model import yolov11_spec
from ..models.yolo.post import _dfl
from .losses import ciou, dfl_loss, optax_sigmoid_bce

log = logging.getLogger("eitx_torch.train")

_CLIP_NORM = 10.0
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class TrainConfig:
    imgsz: int = 256
    nc: int = 4
    variant: str = "s"
    lr: float = 1e-3
    weight_decay: float = 5e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    max_instances: int = 8
    box_w: float = 7.5
    cls_w: float = 0.5
    dfl_w: float = 1.5
    mask_w: float = 2.5
    center_radius: float = 2.5  # cells
    reg_max: int = 16
    # 'tal' = task-aligned assignment (ultralytics' assigner: align =
    # cls_score^alpha * IoU^beta, top-k per target); 'center' = the simpler
    # center-radius fallback.
    assigner: str = "tal"
    segment: bool = True  # False trains a detect-only head (rib model)
    tal_topk: int = 10
    tal_alpha: float = 1.0
    tal_beta: float = 6.0
    # mask loss over only the top-K positive anchors (0 = all anchors);
    # the target resolution is taken from batch["masks"] and the proto is
    # bilinearly upsampled to it when they differ
    mask_topk: int = 0
    # proto mask-grid stride (YoloSpec.proto_stride): 2 trains the
    # high-resolution proto head
    proto_stride: int = 4
    # per-class mask-loss weights (len-nc tuple); None = uniform
    mask_class_w: Optional[tuple] = None


@dataclass
class OptState:
    """optax's adamw state: first and second moments keyed by parameter
    name, and the step count (optax keeps it twice, in
    ``ScaleByAdamState`` and ``ScaleByScheduleState``; they move
    together)."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


@dataclass
class TrainState:
    """Parameters and BatchNorm statistics keyed by the network's state
    names, the optimizer state and the step. ``Trainer.state`` hands out
    the live tensors; assigning a ``TrainState`` to it copies the values
    in."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: OptState
    step: int = 0


def lr_schedule(cfg: TrainConfig):
    """count -> learning rate: ``optax.warmup_cosine_decay_schedule(0,
    lr, warmup, total)`` in its float32 steps. Read at the count before
    the step's increment."""
    f32 = np.float32
    lr, warm = cfg.lr, int(cfg.warmup_steps)
    decay = int(cfg.total_steps) - warm
    if decay <= 0:
        raise ValueError(
            f"the cosine decay needs total_steps > warmup_steps, got "
            f"{cfg.total_steps} and {cfg.warmup_steps}")

    def at(count: int) -> float:
        count = int(count)
        if count < warm:
            c = min(max(count, 0), warm)
            frac = f32(1.0) - f32(c) / f32(warm)
            return float(f32(0.0 - lr) * frac + f32(lr))
        c = min(f32(count - warm), f32(decay))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(f32(lr) * cosine)

    return at


def _anchors_for(imgsz: int, strides=(8, 16, 32), device="cpu"):
    pts, strd = [], []
    for s in strides:
        n = imgsz // s
        xs = (np.arange(n) + 0.5) * s
        gx, gy = np.meshgrid(xs, xs)
        pts.append(np.stack([gx.ravel(), gy.ravel()], 1))
        strd.append(np.full((n * n,), s, np.float32))
    dev = resolve_device(device)
    return (torch.as_tensor(np.concatenate(pts), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.concatenate(strd), dtype=torch.float32,
                            device=dev))


def _box_parts(boxes):
    """(..., I, 4) -> four (..., 1, I) coordinates, against anchors."""
    b = boxes[..., None, :, :]
    return b[..., 0], b[..., 1], b[..., 2], b[..., 3]


def _assign(anchors, strides, boxes, valid, center_radius):
    """Center-based assignment: anchor positive for the smallest target box
    containing it whose center is within center_radius cells.

    anchors (A, 2), boxes (..., I, 4), valid (..., I) -> (..., A) int64
    target index or -1."""
    ax, ay = anchors[:, 0][:, None], anchors[:, 1][:, None]
    x1, y1, x2, y2 = _box_parts(boxes)
    inside = (ax >= x1) & (ax <= x2) & (ay >= y1) & (ay <= y2)  # (..., A, I)
    bcx, bcy = (x1 + x2) / 2, (y1 + y2) / 2
    r = center_radius * strides[:, None]
    near = ((ax - bcx).abs() <= r) & ((ay - bcy).abs() <= r)
    ok = inside & near & (valid[..., None, :] > 0)
    area = (x2 - x1) * (y2 - y1)
    area = torch.maximum(area, torch.full_like(area, 1e-6))
    cost = torch.where(ok, area, math.inf)
    best = cost.argmin(-1)  # the first minimum, as jnp.argmin
    has = torch.isfinite(cost.amin(-1))
    return torch.where(has, best, -1)


def _pairwise_iou(a, b):
    """(..., A, 4) x (..., I, 4) xyxy -> (..., A, I) IoU."""
    ax1, ay1, ax2, ay2 = (a[..., k:k + 1] for k in range(4))
    bx1, by1, bx2, by2 = _box_parts(b)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    iw = torch.maximum(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), zero)
    ih = torch.maximum(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), zero)
    inter = iw * ih
    area_a = torch.maximum(ax2 - ax1, zero) * torch.maximum(ay2 - ay1, zero)
    area_b = torch.maximum(bx2 - bx1, zero) * torch.maximum(by2 - by1, zero)
    den = area_a + area_b - inter
    return inter / torch.maximum(den, torch.full_like(den, 1e-9))


def _assign_tal(anchors, pred_boxes, cls_logits, boxes, classes, valid,
                topk: int, alpha: float, beta: float):
    """Task-aligned assignment (the ultralytics TAL assigner).

    align(a, i) = score_a[class_i]^alpha * IoU(pred_a, gt_i)^beta for
    anchors whose center lies inside gt_i; each target keeps its top-k
    anchors by align; an anchor claimed by several targets goes to the one
    with the highest align (the lower index on a tie, as jnp.argmax).
    pred_boxes (..., A, 4), cls_logits (..., A, nc), boxes (..., I, 4),
    classes (..., I), valid (..., I) -> ((..., A) int64 target index or
    -1, (..., A, I) align)."""
    with span("eitx.train.assign", anchors.device):
        ax, ay = anchors[:, 0][:, None], anchors[:, 1][:, None]
        x1, y1, x2, y2 = _box_parts(boxes)
        # inside: (..., A, I)
        inside = (ax >= x1) & (ax <= x2) & (ay >= y1) & (ay <= y2)
        ok = inside & (valid[..., None, :] > 0)
        iou_ai = _pairwise_iou(pred_boxes, boxes)
        score = torch.sigmoid(cls_logits)
        cls_idx = classes.to(torch.int64)[..., None, :].expand(ok.shape)
        score_ai = torch.gather(score, -1, cls_idx)
        iou0 = torch.maximum(iou_ai, torch.zeros_like(iou_ai))
        align = torch.where(ok, (score_ai ** alpha) * (iou0 ** beta), 0.0)
        # per-target top-k candidate threshold
        k = min(topk, align.shape[-2])
        kth = torch.sort(align, dim=-2).values[..., -k, :]  # (..., I)
        kth = torch.maximum(kth, torch.full_like(kth, 1e-12))
        cand = ok & (align >= kth[..., None, :]) & (align > 0)
        align_c = torch.where(cand, align, -1.0)
        best = align_c.argmax(-1)
        has = align_c.amax(-1) > 0
        return torch.where(has, best, -1), align


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        group=None) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the tensors as they are when their
    global norm is below ``max_norm``, else ``(g / norm) * max_norm`` (no
    epsilon), chosen on the device without waiting for it. With ``group``
    the tensors are shards and the norm is the whole tensors': the local
    squares are summed over ``group`` first."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if group is not None:
        # sqrt(fl(n * n)) == n: a group of one keeps the local norm's bits
        sq = g_norm * g_norm
        dist.all_reduce(sq, group=group)
        g_norm = torch.sqrt(sq)
    keep = (g_norm < max_norm).to(g_norm.dtype)
    clipped = torch._foreach_div(grads, g_norm)
    torch._foreach_mul_(clipped, max_norm)
    torch._foreach_mul_(clipped, 1.0 - keep)
    out = torch._foreach_mul(grads, keep)  # exactly g, or zeros
    torch._foreach_add_(out, clipped)
    return out


def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """Indices sorting the last axis descending, the lower index first
    among equal values (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (B, N, ...) gathered along axis 1 by idx (B, K) -> (B, K, ...)."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


def _bn_buffers(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _check_mesh(mesh, device: torch.device) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh: a DeviceMesh (eitx_torch.parallel."
                        f"make_device_mesh), got {type(mesh).__name__}")
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a trainer on "
                         f"{device}: no fallback between the two")
    if mesh.mesh_dim_names != ("data", "model"):
        raise ValueError(f"Trainer(mesh=...) takes a (data, model) mesh, "
                         f"got axes {mesh.mesh_dim_names}")


class Trainer:
    """One YOLOv11 network, its optimizer state and the train step, on
    ``device`` (the card unless the caller asks for the CPU), or, with
    ``mesh`` (a (data, model) ``DeviceMesh``), this rank's part of the
    data- and FSDP-parallel step; every rank of the mesh builds its
    Trainer with the same arguments and calls each method together."""

    def __init__(self, cfg: TrainConfig = TrainConfig(), mesh=None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        spec = yolov11_spec(cfg.variant, nc=cfg.nc, segment=cfg.segment,
                            proto_stride=cfg.proto_stride)
        # eitx's initial parameters for the seed, drawn on the host
        self.model = flax_init_model(spec, seed).to(self.device).train()
        self._data_group = self._model_group = None
        if mesh is not None:
            from ..parallel.shard import shard_params_fsdp

            _check_mesh(mesh, self.device)
            self._data_group = mesh.get_group("data")
            self._model_group = mesh.get_group("model")
            for m in self.model.modules():
                if isinstance(m, BatchNorm2d):
                    m.sync_group = self._data_group
            shard_params_fsdp(self.model, mesh)
        self._names = [n for n, _ in self.model.named_parameters()]
        self._params = [p for _, p in self.model.named_parameters()]
        self._stats = _bn_buffers(self.model)
        self.opt_state = self.init_opt_state()
        self.step = 0
        self.lr_at = lr_schedule(cfg)
        self.anchors, self.strides = _anchors_for(cfg.imgsz,
                                                  device=self.device)
        # constants of the step, uploaded once (an upload inside the step
        # would wait for the work queued before it)
        self._inv255 = torch.tensor(np.float32(1) / np.float32(255),
                                    device=self.device)
        self._consts: Dict[Any, torch.Tensor] = {}

    def _const(self, values) -> torch.Tensor:
        """float32 ``values`` on the device, uploaded at first use."""
        key = tuple(np.atleast_1d(values).tolist()) + (np.ndim(values),)
        if key not in self._consts:
            self._consts[key] = torch.tensor(values, dtype=torch.float32,
                                             device=self.device)
        return self._consts[key]

    # ------------------------------------------------------------------
    def local_params(self) -> Dict[str, torch.Tensor]:
        """The parameters this rank holds and updates, by name: the live
        tensors on one device, this rank's shards on a mesh."""
        if self.mesh is None:
            return dict(zip(self._names, self._params))
        return {n: p.to_local() for n, p in zip(self._names, self._params)}

    def full_params(self, local: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Shards laid out as ``local_params()`` -> whole tensors, on every
        rank of the mesh (a collective); on one device, ``local``."""
        if self.mesh is None:
            return local
        from torch.distributed.tensor import DTensor

        out = {}
        for n, p in zip(self._names, self._params):
            out[n] = DTensor.from_local(
                local[n].detach(), p.device_mesh, p.placements,
                run_check=False, shape=p.shape,
                stride=p.stride()).full_tensor()
        return out

    def _to_local(self, full: Dict[str, torch.Tensor], what: str
                  ) -> Dict[str, torch.Tensor]:
        """Whole tensors (any device) -> this rank's shards, new tensors
        laid out as ``local_params()``."""
        if set(full) != set(self._names):
            raise ValueError(
                f"{what} names differ: missing "
                f"{sorted(set(self._names) - set(full))[:4]}, extra "
                f"{sorted(set(full) - set(self._names))[:4]}")
        if self.mesh is None:
            return {n: torch.as_tensor(full[n]).to(p.device, p.dtype,
                                                   copy=True)
                    for n, p in zip(self._names, self._params)}
        from torch.distributed.tensor import distribute_tensor

        out = {}
        for n, p in zip(self._names, self._params):
            t = torch.as_tensor(full[n]).to(self.device, p.dtype)
            out[n] = distribute_tensor(t, p.device_mesh, p.placements,
                                       src_data_rank=None).to_local().clone()
        return out

    def init_opt_state(self) -> OptState:
        """A fresh optimizer state (zero moments, count 0) for the
        parameters this rank holds."""
        local = self.local_params()
        return OptState(mu={n: torch.zeros_like(p) for n, p in local.items()},
                        nu={n: torch.zeros_like(p) for n, p in local.items()},
                        count=0)

    @property
    def state(self) -> TrainState:
        """On one device the live tensors; on a mesh whole copies, on
        every rank (a collective)."""
        st = self.opt_state
        return TrainState(
            params=self.full_params(self.local_params()),
            batch_stats=dict(self._stats),
            opt_state=OptState(mu=self.full_params(st.mu),
                               nu=self.full_params(st.nu), count=st.count),
            step=self.step)

    @state.setter
    def state(self, new: TrainState) -> None:
        if set(self._stats) != set(new.batch_stats):
            raise ValueError(
                f"batch_stats names differ: missing "
                f"{sorted(set(self._stats) - set(new.batch_stats))[:4]}, "
                f"extra {sorted(set(new.batch_stats) - set(self._stats))[:4]}")
        params = self._to_local(new.params, "params")
        with torch.no_grad():
            for n, t in self.local_params().items():
                t.copy_(params[n])
            for n, t in self._stats.items():
                t.copy_(torch.as_tensor(new.batch_stats[n]).to(t.device,
                                                               t.dtype))
        self.opt_state = OptState(
            mu=self._to_local(new.opt_state.mu, "first moments"),
            nu=self._to_local(new.opt_state.nu, "second moments"),
            count=int(new.opt_state.count))
        self.step = int(new.step)

    # ------------------------------------------------------------------
    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on the device; on a mesh, this rank's block of it
        over ``data``."""
        if self.mesh is not None:
            from ..parallel.shard import shard_batch

            batch = {k: shard_batch(v, self.mesh) for k, v in batch.items()}
        b = {k: torch.as_tensor(np.asarray(v) if not isinstance(
                 v, torch.Tensor) else v).to(self.device)
             for k, v in batch.items()}
        b["valid"] = b["valid"].to(torch.float32)
        return b

    def _mean_over_data(self, metrics: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Each rank's batch means -> the global batch's (equal blocks):
        their mean over ``data``, in one all-reduce."""
        if self.mesh is None:
            return metrics
        keys = list(metrics)
        v = torch.stack([metrics[k] for k in keys])
        dist.all_reduce(v, group=self._data_group)
        v = v / self._const(float(self.mesh["data"].size()))
        return dict(zip(keys, v.unbind(0)))

    def _loss(self, batch: Dict[str, torch.Tensor]):
        """(loss, metrics) of one batch through the network in training
        mode (batch statistics; the running statistics move)."""
        images = batch["images"]
        if images.dtype == torch.uint8:
            # x / 255 as eitx's compiled step computes it: XLA rewrites a
            # division by a constant as a product with its float32
            # reciprocal (a true division differs on half the grey levels)
            images = images.to(torch.float32) * self._inv255
        with span("eitx.train.forward", self.device):
            out = self.model(images.permute(0, 3, 1, 2))
        return self._loss_from_outputs(out, batch)

    def _loss_from_outputs(self, out: Dict, batch: Dict[str, torch.Tensor]):
        """(loss, metrics) of the network's raw NCHW outputs ``out``
        against the batch's targets."""
        with span("eitx.train.loss", self.device):
            cfg = self.cfg
            masks = batch["masks"]
            if masks.dtype == torch.uint8:
                masks = masks.to(torch.float32) * self._inv255
            B = masks.shape[0]
            reg_max = cfg.reg_max

            def flat(m):  # (B, C, H, W) -> (B, H * W, C), the anchors' order
                return m.permute(0, 2, 3, 1).reshape(B, -1, m.shape[1])

            box_logits = torch.cat([flat(bm) for bm, _ in out["levels"]], 1)
            cls_logits = torch.cat([flat(cm) for _, cm in out["levels"]], 1)
            anchors, strides = self.anchors, self.strides
            boxes = batch["boxes"]
            classes = batch["classes"].to(torch.int64)
            valid = batch["valid"]

            # decode predicted boxes first (TAL scores them)
            d = _dfl(box_logits, reg_max) * strides[:, None]  # (B, A, 4) px
            pb = torch.stack([anchors[:, 0] - d[..., 0],
                              anchors[:, 1] - d[..., 1],
                              anchors[:, 0] + d[..., 2],
                              anchors[:, 1] + d[..., 3]], -1)
            if cfg.assigner == "tal":
                pb_sg = pb.detach()
                assigned, align = _assign_tal(
                    anchors, pb_sg, cls_logits.detach(), boxes, classes, valid,
                    cfg.tal_topk, cfg.tal_alpha, cfg.tal_beta)
            else:
                assigned = _assign(anchors, strides, boxes, valid,
                                   cfg.center_radius)
                align = None
            pos = assigned >= 0
            tgt = assigned.clamp_min(0)
            tboxes = _take(boxes, tgt)  # (B, A, 4)
            tcls = torch.gather(classes, 1, tgt)
            n_pos = pos.sum(1).clamp_min(1)

            if align is None:
                soft = pos.to(cls_logits.dtype)  # hard 1.0 targets
            else:
                # ultralytics normalization: per-target align scaled so its
                # best anchor's target equals the target's best IoU
                iou_ai = _pairwise_iou(pb_sg, boxes)
                max_align = align.amax(1)  # (B, I)
                iou0 = torch.maximum(iou_ai, torch.zeros_like(iou_ai))
                max_iou = iou0.amax(1)
                scale = max_iou / torch.maximum(
                    max_align, torch.full_like(max_align, 1e-9))
                norm = align * scale[:, None, :]
                soft = torch.gather(norm, 2, tgt[..., None])[..., 0] * pos

            # classification BCE over all anchors (soft targets under TAL)
            onehot = F.one_hot(tcls, cfg.nc).to(soft.dtype) * soft[..., None]
            soft_sum = soft.sum(1)
            l_cls = optax_sigmoid_bce(cls_logits, onehot).sum((1, 2)) \
                / torch.maximum(soft_sum, torch.ones_like(soft_sum))

            # box: CIoU on positives, weighted by the soft target score
            w_box = torch.where(pos, torch.maximum(soft, torch.full_like(
                soft, 1e-3)), 0.0)
            w_sum = w_box.sum(1)
            l_box = ((1.0 - ciou(pb, tboxes)) * w_box).sum(1) \
                / torch.maximum(w_sum, torch.full_like(w_sum, 1e-3))

            # dfl against target distances in stride units
            tdist = torch.stack([anchors[:, 0] - tboxes[..., 0],
                                 anchors[:, 1] - tboxes[..., 1],
                                 tboxes[..., 2] - anchors[:, 0],
                                 tboxes[..., 3] - anchors[:, 1]], -1) \
                / strides[:, None]
            l_dfl = (dfl_loss(box_logits.reshape(B, -1, 4, reg_max), tdist,
                              reg_max) * pos).sum(1) / n_pos

            if cfg.segment:
                l_mask = self._mask_loss(out, masks, classes, pos, soft, tgt,
                                         tboxes, n_pos)
            else:
                l_mask = torch.zeros(B, dtype=l_cls.dtype, device=l_cls.device)
            mask_w = cfg.mask_w if cfg.segment else 0.0
            loss = (cfg.cls_w * l_cls.mean() + cfg.box_w * l_box.mean()
                    + cfg.dfl_w * l_dfl.mean() + mask_w * l_mask.mean())
            metrics = {"loss": loss, "cls": l_cls.mean(), "box": l_box.mean(),
                       "dfl": l_dfl.mean(), "mask": l_mask.mean()}
            return loss, {k: v.detach() for k, v in metrics.items()}

    def _mask_loss(self, out, masks, classes, pos, soft, tgt, tboxes, n_pos):
        """Per-anchor mask supervision (ultralytics v8SegmentationLoss
        semantics): every positive anchor's own coefficients must
        reproduce its target's mask, BCE cropped to the target box and
        normalized by box area."""
        cfg = self.cfg
        B = masks.shape[0]
        coefs = torch.cat([m.permute(0, 2, 3, 1).reshape(B, -1, m.shape[1])
                           for m in out["mask_coefs"]], 1)
        proto = out["proto"]  # (B, nm, Hp, Wp)
        T = masks.shape[-1]  # mask supervision resolution
        if T != proto.shape[-1]:
            # bilinear commutes with the linear coef combination, so
            # upsampling the proto once == upsampling every composed mask
            proto = resize_bilinear(proto, T, T)
        if cfg.mask_topk > 0:
            K = min(cfg.mask_topk, coefs.shape[1])
            # keep the K best positives (soft = TAL quality)
            sel = _desc_order(torch.where(pos, soft, -1.0))[:, :K]
            co_s, tgt_s = _take(coefs, sel), torch.gather(tgt, 1, sel)
            pos_s, tb_s = torch.gather(pos, 1, sel), _take(tboxes, sel)
        else:
            co_s, tgt_s, pos_s, tb_s = coefs, tgt, pos, tboxes
        pm = torch.einsum("bkn,bnhw->bkhw", co_s, proto)  # (B, K, T, T)
        tm = _take(masks, tgt_s)  # (B, K, T, T)
        bxp = tb_s / self._const(cfg.imgsz / T)  # boxes in mask-grid coords
        grid = torch.arange(T, dtype=pm.dtype, device=pm.device) + 0.5
        xs_g, ys_g = grid[None, None, None, :], grid[None, None, :, None]
        inside = ((xs_g >= bxp[..., 0, None, None])
                  & (xs_g < bxp[..., 2, None, None])
                  & (ys_g >= bxp[..., 1, None, None])
                  & (ys_g < bxp[..., 3, None, None]))
        bce = optax_sigmoid_bce(pm, tm) * inside
        barea = (bxp[..., 2] - bxp[..., 0]) * (bxp[..., 3] - bxp[..., 1])
        barea = torch.maximum(barea, torch.ones_like(barea))
        lm = (bce.sum((2, 3)) / barea) * pos_s
        if cfg.mask_class_w is not None:
            w = self._const(cfg.mask_class_w)
            lm = lm * w[torch.gather(classes, 1, tgt_s)]
        return lm.sum(1) / n_pos

    # ------------------------------------------------------------------
    def _apply_updates(self) -> None:
        """optax ``chain(clip_by_global_norm(10), adamw(schedule,
        weight_decay))`` on the gradients, then ``apply_updates``: fused
        ``_foreach`` launches, and no wait for the device (the schedule
        and the bias corrections depend on the count alone)."""
        with span("eitx.train.update", self.device):
            params = list(self.local_params().values())
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self._params]
            if self.mesh is not None:
                grads = [g.to_local() for g in grads]
            grads = clip_by_global_norm(grads, _CLIP_NORM, self._model_group)
            st = self.opt_state
            mu = [st.mu[n] for n in self._names]
            nu = [st.nu[n] for n in self._names]
            lr = self.lr_at(st.count)
            st.count += 1
            f32 = np.float32
            bc1 = float(f32(1.0) - f32(_ADAM_B1) ** f32(st.count))
            bc2 = float(f32(1.0) - f32(_ADAM_B2) ** f32(st.count))
            torch._foreach_mul_(mu, _ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - _ADAM_B1)
            torch._foreach_mul_(nu, _ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - _ADAM_B2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, _ADAM_EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(upd, params, alpha=self.cfg.weight_decay)
            torch._foreach_mul_(upd, -lr)
            with torch.no_grad():
                torch._foreach_add_(params, upd)

    def train_step(self, batch, device_metrics: bool = False) -> Dict:
        """One optimizer step. With ``device_metrics`` the metric dict
        holds device tensors (no wait for the device); the loop converts
        only when logging."""
        with span("eitx.train.step", self.device):
            b = self._device_batch(batch)
            for p in self._params:
                p.grad = None
            loss, metrics = self._loss(b)
            with span("eitx.train.backward", self.device):
                loss.backward()
            self._apply_updates()
            self.step += 1
            metrics = self._mean_over_data(metrics)
            if device_metrics:
                return metrics
            return {k: float(v) for k, v in metrics.items()}

    def eval_loss(self, batch) -> Dict[str, float]:
        """Loss metrics on a batch WITHOUT an optimizer update (validation):
        the network in training mode, as the reference's, with its running
        statistics put back afterwards."""
        b = self._device_batch(batch)
        saved = [t.clone() for t in self._stats.values()]
        try:
            with torch.no_grad():
                _, metrics = self._loss(b)
        finally:
            torch._foreach_copy_(list(self._stats.values()), saved)
        return {k: float(v) for k, v in self._mean_over_data(metrics).items()}


class EMA:
    """Exponential moving average of parameters (deployment weights).

    Decay ramps in (ultralytics-style ``decay * (1 - exp(-step/tau))``):
    with a fixed 0.999 decay over S steps the random init keeps an
    0.999^S weight in the average. The ramp forgets the init quickly while
    still converging to the configured decay. One update is two fused
    ``_foreach`` launches, not one per tensor (~200 per step)."""

    def __init__(self, params: Dict[str, torch.Tensor], decay: float = 0.999,
                 tau: float = 500.0):
        self.decay = decay
        self.tau = tau
        self.step = 0
        self.params = {n: p.detach().clone() for n, p in params.items()}

    def update(self, params: Dict[str, torch.Tensor]):
        ema = list(self.params.values())
        with span("eitx.train.ema", ema[0].device):
            self.step += 1
            d = np.float32(self.decay * (1.0 - float(np.exp(-self.step
                                                             / self.tau))))
            with torch.no_grad():
                torch._foreach_mul_(ema, float(d))
                torch._foreach_add_(
                    ema, [params[n].detach() for n in self.params],
                    alpha=float(np.float32(1.0) - d))
            return self.params


def _save(trainer: Trainer, path: str) -> None:
    """Write the trainer's checkpoint. On a mesh every rank gathers the
    whole state (a collective), the mesh's first rank alone writes it
    (several writers of one file race), and every rank of the mesh waits
    until the file is complete."""
    from .checkpoint import save_checkpoint

    state = trainer.state
    mesh = trainer.mesh
    if mesh is None:
        save_checkpoint(path, state)
        return
    if not any(mesh.get_coordinate()):
        save_checkpoint(path, state)
    # a barrier over each axis in turn: the first holds the ranks (i, 0)
    # until the write is done, the next holds (i, j) until (i, 0) passed
    for dim in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(dim))


def fit(
    trainer: Trainer,
    data_iter,
    steps: int,
    ema_decay: float = 0.999,
    log_every: int = 50,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 500,
    val_batch: Optional[Dict[str, np.ndarray]] = None,
    val_every: int = 200,
):
    """Minimal training loop: steps batches from ``data_iter`` with EMA,
    periodic checkpointing, and (when ``val_batch`` is given) a held-out
    validation loss logged every ``val_every`` steps. Returns
    (final metrics, EMA params). On a mesh every rank runs ``fit``
    together: the EMA averages each rank's shards, rank 0 alone writes
    the checkpoint, and every rank gets the whole EMA parameters."""
    ema = EMA(trainer.local_params(), ema_decay)
    metrics: Dict[str, Any] = {}
    for step in range(steps):
        batch = next(data_iter)
        metrics = trainer.train_step(batch, device_metrics=True)
        ema.update(trainer.local_params())
        if log_every and step % log_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            log.info("step %d: %s", step,
                     {k: round(v, 4) for k, v in metrics.items()})
        if val_batch is not None and (step + 1) % val_every == 0:
            vm = trainer.eval_loss(val_batch)
            metrics["val_loss"] = vm["loss"]
            log.info("step %d VAL: %s", step,
                     {k: round(v, 4) for k, v in vm.items()})
        if checkpoint_path and (step + 1) % checkpoint_every == 0:
            _save(trainer, checkpoint_path)
    if checkpoint_path:
        _save(trainer, checkpoint_path)
    metrics = {k: float(v) for k, v in metrics.items()}
    return metrics, trainer.full_params(ema.params)
