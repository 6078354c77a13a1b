"""Tissue segmenter: letterbox + network + decode + NMS + label composition.

Port of the segment-labels path of eitx/models/yolo/infer.py
(``letterbox_params``, ``YoloRunner``, ``TissueSegmenter``). Preprocessing
(cast, /255, channel replication, letterbox), flip test-time augmentation,
the network, NMS and mask composition run on ``device``; uint8 frames go
in and int8 label images come back, then the host un-letterboxes.

The rib detector (``RibsDetector``) and the detect/segment outputs that
only it and the training code use are not ported yet (ROADMAP, queue 1:
rib detector and series modes).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import full_f32, resolve_device
from ...core.errors import ModelError
from .checkpoint import flax_to_torch_state, load_state, read_msgpack_checkpoint
from .model import YoloV11, yolov11_spec
from .post import postprocess_segment_labels


def letterbox_params(h: int, w: int, imgsz: int) -> Tuple[float, int, int]:
    """scale, pad_x, pad_y to fit (h, w) into (imgsz, imgsz)."""
    scale = min(imgsz / h, imgsz / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_y = (imgsz - nh) // 2
    pad_x = (imgsz - nw) // 2
    return scale, pad_x, pad_y


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
        if weights:
            if weights.endswith(".pt"):
                raise ModelError(
                    f"{weights}: ultralytics .pt checkpoints are not read by "
                    "the port (ROADMAP, queue 1: training, eval, scripts)"
                )
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
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = YoloV11(self.spec)
        if state is not None:
            load_state(model, state)
        # bf16 inference casts weights AND batch statistics
        self.model = model.eval().to(device=self.device,
                                     dtype=self.compute_dtype)

    def _segment_labels_device(self, x_u8: torch.Tensor, rgb: bool,
                               full: bool) -> torch.Tensor:
        """uint8 (B, H, W[, 3]) on the device -> int8 label canvases
        (B, imgsz/q, imgsz/q), q = 1 on the quality path else 4."""
        imgsz, cdtype, views = self.imgsz, self.compute_dtype, self.tta_views
        b, h, w = x_u8.shape[:3]
        scale, pad_x, pad_y = letterbox_params(h, w, imgsz)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        x = x_u8.to(cdtype) / 255.0
        if not rgb:
            x = x[..., None].expand(b, h, w, 3)
        x = x.permute(0, 3, 1, 2)  # NCHW
        if (nh, nw) != (h, w):
            # jax.image.resize antialiases when it shrinks; so does this
            x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                              align_corners=False, antialias=True)
        if (nh, nw) != (imgsz, imgsz):
            canvas = torch.full((b, 3, imgsz, imgsz), 114.0 / 255.0,
                                dtype=cdtype, device=x.device)
            canvas[:, :, pad_y:pad_y + nh, pad_x:pad_x + nw] = x
            x = canvas
        if views > 1:
            # flipping the letterboxed canvas is its own exact inverse on
            # the label canvas, so the merge needs no letterbox bookkeeping
            vs = [x, x.flip(3)]
            if views > 2:
                vs.append(x.flip(2))
            if views > 3:
                vs.append(x.flip(2, 3))
            x = torch.cat(vs, dim=0)
        out = self.model(x.contiguous())
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
        rgb = arr.ndim == 4
        b, h, w = arr.shape[0], arr.shape[1], arr.shape[2]
        if b > chunk:
            pad = (-b) % chunk
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
        out = np.empty((b, h, w), np.int32)
        # float32 runs keep convolutions and products out of TF32
        precision = (full_f32() if self.compute_dtype == torch.float32
                     else contextlib.nullcontext())
        with precision:
            for k in range(0, arr.shape[0], chunk):
                x = torch.from_numpy(np.ascontiguousarray(arr[k:k + chunk]))
                coarse = self._segment_labels_device(
                    x.to(self.device), rgb, compose_full).cpu().numpy()
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
