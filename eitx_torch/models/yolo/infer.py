"""Rib detector and tissue segmenter: letterbox + network + decode + NMS
(+ instance masks or label composition).

Port of eitx/models/yolo/infer.py (``letterbox_params``, ``_prep_batch``,
``YoloRunner``, ``RibsDetector``, ``TissueSegmenter``). Preprocessing
(cast, /255, channel replication, letterbox), flip test-time augmentation,
the network, NMS and mask composition run on ``device``. On the
segment-labels path uint8 frames go in and int8 label images come back,
then the host un-letterboxes; ``detect`` and ``segment`` return numpy
detections in the coordinates of the original image.

Arithmetic type. With ``dtype="bfloat16"`` the two paths compute
differently in the JAX package, and the port follows each:
  - ``segment_labels`` casts its input to bfloat16 inside the program and
    runs the network in bfloat16 (eitx/models/yolo/infer.py:193). XLA
    computes each bfloat16 operation in float32 and rounds it, and keeps
    float32 only where its compiled program does (a row sum reads the
    float32 ``exp``, a product accumulates in float32). The port takes
    the same operations in the same order: BatchNorm as flax's five
    rounded operations (``blocks.BatchNorm2d``), SiLU and the sigmoids as
    ``x * (1 / (1 + exp(-x)))`` rounded at each step, the softmaxes of the
    attention and of the box decode as XLA fuses them, products in
    float32 rounded once, biases added after the convolution rounds, and
    the mask resize row by row then column by column
    (``rounding.py``, ``blocks.py``, ``post.py``, ``resize.py``). On the
    CPU every one of those equals eitx's to the bit. One operation does
    not: XLA:CPU sums a convolution in float32 strictly in order over
    (kh, kw, cin), while oneDNN here and cuDNN on the card block the sum,
    and torch has no convolution that sums in XLA's order. A few elements
    of a layer round to the neighbouring bfloat16, the difference
    travels, and the labels of the serving request on the 256 phantom
    differ on 21 of 65,536 pixels (tests/test_torch_yolo_bf16.py holds
    them at an agreement of 0.9995).
  - ``detect`` and ``segment`` feed the float32 canvas of ``_prep_batch``
    to variables that were cast to bfloat16. No module of the flax model
    sets a ``dtype``, so every layer promotes float32 x bfloat16 to
    float32: the raw heads come out float32 (checked on the JAX package:
    ``model.apply(bf16 variables, f32 canvas)`` returns float32 maps).
    That path is *bfloat16-rounded weights and batch statistics, float32
    arithmetic*, with one exception: flax's BatchNorm forms its multiplier
    ``rsqrt(var + eps) * scale`` from the bfloat16 statistics alone, so
    each of those three operations rounds to bfloat16 before the
    multiplier meets the float32 activations. A torch module in bfloat16
    refuses a float32 input, so the port keeps a float32 copy of the
    network whose weights went through bfloat16 and whose BatchNorm
    multipliers are folded the same way (``_bf16_rounded_f32_copy``), and
    runs it with TF32 off.
"""

from __future__ import annotations

import copy
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import resolve_device, to_device
from ...core.errors import ModelError
from .checkpoint import flax_to_torch_state, load_state, read_msgpack_checkpoint
from .init import flax_init_model
from .model import YoloV11, yolov11_spec
from .resize import resize_bilinear
from .post import (
    Detections,
    postprocess_detect,
    postprocess_segment,
    postprocess_segment_labels,
)


def letterbox_params(h: int, w: int, imgsz: int) -> Tuple[float, int, int]:
    """scale, pad_x, pad_y to fit (h, w) into (imgsz, imgsz)."""
    scale = min(imgsz / h, imgsz / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_y = (imgsz - nh) // 2
    pad_x = (imgsz - nw) // 2
    return scale, pad_x, pad_y


def _letterbox(x_u8: torch.Tensor, imgsz: int,
               dtype: torch.dtype) -> torch.Tensor:
    """uint8 (B, H, W) or (B, H, W, 3) on the device -> (B, 3, imgsz,
    imgsz) in ``dtype``: /255, grey to three channels, resized to fit and
    centred on a canvas of 114/255."""
    b, h, w = x_u8.shape[:3]
    scale, pad_x, pad_y = letterbox_params(h, w, imgsz)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = x_u8.to(dtype) / 255.0
    if x.ndim == 3:
        x = x[..., None].expand(b, h, w, 3)
    x = x.permute(0, 3, 1, 2)  # NCHW
    if (nh, nw) != (h, w):
        x = resize_bilinear(x, nh, nw)
    if (nh, nw) != (imgsz, imgsz):
        canvas = torch.full((b, 3, imgsz, imgsz), 114.0 / 255.0,
                            dtype=dtype, device=x.device)
        canvas[:, :, pad_y:pad_y + nh, pad_x:pad_x + nw] = x
        x = canvas
    return x.contiguous()


def _prep_batch(images: np.ndarray, imgsz: int,
                device="cuda") -> Tuple[torch.Tensor, float, int, int]:
    """uint8 (B, H, W) or (B, H, W, 3) -> letterboxed float32
    (B, 3, imgsz, imgsz) on ``device``, with scale, pad_x, pad_y."""
    arr = np.asarray(images)
    canvas = _letterbox(to_device(arr, device), imgsz, torch.float32)
    return (canvas, *letterbox_params(arr.shape[1], arr.shape[2], imgsz))


def _bf16_rounded_f32_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A float32 copy of a bfloat16 network that computes what flax
    computes when bfloat16 variables meet a float32 input: float32
    convolutions on the rounded weights, and per BatchNorm
    ``(x - mean) * mul + bias`` with ``mul = rsqrt(var + eps) * scale``
    formed in bfloat16 (see the module docstring)."""
    def bf16(x):  # one bfloat16 rounding, the value kept in float32
        return x.to(torch.bfloat16).to(torch.float32)

    rounded = copy.deepcopy(model).to(torch.float32)
    for bn in rounded.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            # each step in float32 and rounded by hand: torch's own
            # bfloat16 rsqrt is not the correctly rounded one
            inv = bf16(1.0 / torch.sqrt(bf16(bn.running_var + bn.eps)))
            with torch.no_grad():
                bn.weight.copy_(bf16(inv * bn.weight))
                bn.running_var.fill_(1.0)
            # the folded multiplier stands alone: 1 + eps is 1 in float32
            # (torch refuses an eps of 0)
            bn.eps = 1e-30
    return rounded.eval()


class YoloRunner:
    """Shared machinery: build the network, load its weights, run it."""

    def __init__(
        self,
        nc: int,
        imgsz: int,
        segment: bool,
        weights: Optional[str] = None,
        variant: str = "s",
        proto_stride: int = 4,
        conf=0.3,
        iou: float = 0.45,
        max_det: int = 64,
        seed: int = 0,
        dtype: str = "float32",
        tta_fill=False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        state = None
        if weights and not weights.endswith(".pt"):
            # an eitx checkpoint records its own architecture: adopt its
            # size variant and proto stride, refuse a class-count mismatch
            meta, params, batch_stats = read_msgpack_checkpoint(weights)
            if meta.get("variant"):
                variant = str(meta["variant"])
            if meta.get("proto_stride"):
                proto_stride = int(meta["proto_stride"])
            if meta.get("nc") and int(meta["nc"]) != nc:
                raise ModelError(
                    f"checkpoint {weights} was trained with nc="
                    f"{meta['nc']}, runner expects nc={nc}"
                )
            state = flax_to_torch_state(params, batch_stats)
        self.spec = yolov11_spec(
            variant, nc=nc, segment=segment, proto_stride=proto_stride
        )
        self.imgsz = imgsz
        if isinstance(conf, (tuple, list)) and len(conf) < nc:
            raise ModelError(
                f"per-class conf has {len(conf)} entries, model has "
                f"{nc} classes"
            )
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        # flip test-time augmentation with background-fill-only merge:
        # False/True = 1/2 views (straight / +hflip), 3 adds vflip, 4 adds
        # rot180; the straight view's labels always win
        self.tta_views = (2 if tta_fill is True
                          else max(1, int(tta_fill or 1)))
        self.compute_dtype = (torch.bfloat16 if dtype == "bfloat16"
                              else torch.float32)
        if not weights:
            # eitx's untrained network: flax's initial parameters for the
            # seed (eitx/models/yolo/infer.py:132-135)
            model = flax_init_model(self.spec, seed)
        else:
            model = YoloV11(self.spec)
            if weights.endswith(".pt"):
                # an ultralytics archive: the ultralytics names are this
                # package's module names
                from .convert import convert_ultralytics_checkpoint

                state = convert_ultralytics_checkpoint(weights, model)
            load_state(model, state)
        # bf16 inference casts weights AND batch statistics
        self.model = model.eval().to(device=self.device,
                                     dtype=self.compute_dtype)
        self._f32_model: Optional[torch.nn.Module] = None

    def _float32_network(self) -> torch.nn.Module:
        """The network ``detect`` and ``segment`` run: float32 arithmetic
        whatever ``dtype`` (see the module docstring)."""
        if self.compute_dtype == torch.float32:
            return self.model
        if self._f32_model is None:
            self._f32_model = _bf16_rounded_f32_copy(self.model)
        return self._f32_model

    def _segment_labels_device(self, x_u8: torch.Tensor,
                               full: bool) -> torch.Tensor:
        """uint8 (B, H, W[, 3]) on the device -> int8 label canvases
        (B, imgsz/q, imgsz/q), q = 1 on the quality path else 4."""
        imgsz, views = self.imgsz, self.tta_views
        b = x_u8.shape[0]
        x = _letterbox(x_u8, imgsz, self.compute_dtype)
        if views > 1:
            # flipping the letterboxed canvas is its own exact inverse on
            # the label canvas, so the merge needs no letterbox bookkeeping
            vs = [x, x.flip(3)]
            if views > 2:
                vs.append(x.flip(2))
            if views > 3:
                vs.append(x.flip(2, 3))
            x = torch.cat(vs, dim=0)
        out = self.model(x)
        q = 1 if full else 4
        _, labels = postprocess_segment_labels(
            out, (imgsz, imgsz), self.conf, self.iou, self.max_det,
            out_hw=(imgsz // q, imgsz // q),
        )
        if views > 1:
            lab = labels[:b]
            lab = torch.where(lab < 0, labels[b:2 * b].flip(2), lab)
            if views > 2:
                lab = torch.where(lab < 0, labels[2 * b:3 * b].flip(1), lab)
            if views > 3:
                lab = torch.where(lab < 0, labels[3 * b:4 * b].flip(1, 2), lab)
            labels = lab
        return labels.to(torch.int8)

    @torch.inference_mode()
    def segment_labels(
        self, images: np.ndarray, chunk: int = 16, compose_full: bool = False
    ) -> np.ndarray:
        """uint8 (B, H, W[, 3]) -> (B, H, W) int32 label images.

        Batches larger than ``chunk`` run in ``chunk``-sized pieces (the
        ragged tail padded by repeating the last image). ``compose_full``
        selects the quality path: soft masks are bilinearly upsampled to
        network resolution before thresholding."""
        arr = np.asarray(images)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        b, h, w = arr.shape[0], arr.shape[1], arr.shape[2]
        if b > chunk:
            pad = (-b) % chunk
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
        out = np.empty((b, h, w), np.int32)
        for k in range(0, arr.shape[0], chunk):
            x = torch.from_numpy(np.ascontiguousarray(arr[k:k + chunk]))
            coarse = self._segment_labels_device(
                x.to(self.device), compose_full).cpu().numpy()
            n = min(coarse.shape[0], b - k)
            self._upsample_labels_into(
                out[k:k + n], coarse[:n], q=1 if compose_full else 4)
        return out

    def _upsample_labels_into(
        self, out: np.ndarray, coarse: np.ndarray, q: int = 4
    ):
        """Un-letterbox + nearest-upsample labels at stride ``q`` directly
        into ``out`` (B, h, w)."""
        n, h, w = out.shape
        scale, pad_x, pad_y = letterbox_params(h, w, self.imgsz)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        coarse = coarse[:, pad_y // q: (pad_y + nh) // q,
                        pad_x // q: (pad_x + nw) // q]
        ch, cw = coarse.shape[1], coarse.shape[2]
        if h == ch * q and w == cw * q:
            view = out.reshape(n, ch, q, cw, q)
            view[:] = coarse[:, :, None, :, None]
            return
        yy = np.minimum((np.arange(h) * ch // h), ch - 1)
        xx = np.minimum((np.arange(w) * cw // w), cw - 1)
        out[:] = coarse[:, yy][:, :, xx]

    def _detections_to_image(self, det: Detections, scale: float,
                             pad_x: int, pad_y: int) -> Detections:
        """Device detections in canvas pixels -> numpy detections in the
        original image's pixels; invalid slots are zeroed."""
        valid = det.valid.cpu().numpy()
        boxes = (
            det.boxes.cpu().numpy() - np.array([pad_x, pad_y, pad_x, pad_y])
        ) / scale
        return Detections(
            boxes=boxes * valid[..., None],
            scores=det.scores.cpu().numpy(),
            classes=det.classes.cpu().numpy(),
            coefs=det.coefs.cpu().numpy(),
            valid=valid,
        )

    @torch.inference_mode()
    def detect(self, images: np.ndarray) -> Detections:
        """uint8 (B, H, W[, 3]) -> Detections in ORIGINAL image coords."""
        x, scale, pad_x, pad_y = _prep_batch(images, self.imgsz, self.device)
        det = postprocess_detect(self._float32_network()(x), self.conf,
                                 self.iou, self.max_det)
        return self._detections_to_image(det, scale, pad_x, pad_y)

    @torch.inference_mode()
    def segment(self, images: np.ndarray):
        """uint8 (B, H, W[, 3]) -> (Detections, masks (B, K, H, W) bool),
        both mapped back to the original resolution."""
        arr = np.asarray(images)
        h, w = arr.shape[1], arr.shape[2]
        x, scale, pad_x, pad_y = _prep_batch(arr, self.imgsz, self.device)
        det, masks = postprocess_segment(
            self._float32_network()(x), (self.imgsz, self.imgsz),
            self.conf, self.iou, self.max_det)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        m = masks[:, :, pad_y:pad_y + nh, pad_x:pad_x + nw]
        if (nh, nw) != (h, w):
            # jax.image.resize(..., "nearest") samples at pixel centres
            m = F.interpolate(m.to(torch.float32), size=(h, w),
                              mode="nearest-exact") > 0
        return (self._detections_to_image(det, scale, pad_x, pad_y),
                m.cpu().numpy())


class RibsDetector(YoloRunner):
    """Single-class rib detector, imgsz 640 conf 0.3 (ai_tools.py:107-127)."""

    def __init__(self, weights: Optional[str] = None, **kw):
        kw.setdefault("nc", 1)
        kw.setdefault("imgsz", 640)
        kw.setdefault("conf", 0.3)
        super().__init__(segment=False, weights=weights, **kw)

    def predict(self, front_slice: np.ndarray) -> Detections:
        det = self.detect(np.asarray(front_slice)[None])
        return Detections(*(t[0] for t in det))


class TissueSegmenter(YoloRunner):
    """4-class tissue segmenter at 256 or 512 (ai_tools.py:129-158)."""

    def __init__(self, imgsz: int = 512, weights: Optional[str] = None, **kw):
        kw.setdefault("nc", 4)
        kw.setdefault("conf", 0.3)
        super().__init__(imgsz=imgsz, segment=True, weights=weights, **kw)

    def predict_labels(self, axial_slice: np.ndarray):
        """(H, W[, 3]) uint8 -> ((H, W) int32 label image, seg_time_s).

        Instances paint lowest-score-first so the highest-confidence
        instance wins overlaps; the quality composition (full-resolution
        soft-mask upsample before threshold) is used per request."""
        t0 = time.time()
        labels = self.segment_labels(
            np.asarray(axial_slice)[None], compose_full=True
        )[0]
        return labels, round(time.time() - t0, 3)
