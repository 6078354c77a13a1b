"""The frozen training step of ``reference/yolo/trainer.py`` on the plain
YOLO12 network of ``model.py``: the same loss (TAL, box, DFL, class and
mask terms), clip + AdamW and EMA (re-exported here); only the network
differs.

``TrainConfig`` adds ``arch`` (the program's field; "yolo12" only here).
``Trainer`` runs on one device (no mesh) and builds the network without
initial values: the caller loads them through ``Trainer.state``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ..yolo import trainer as base
from ..yolo.device import resolve_device
from ..yolo.trainer import EMA, OptState, TrainState  # noqa: F401
from .model import YoloV12


@dataclass(frozen=True)
class TrainConfig(base.TrainConfig):
    arch: str = "yolo12"


class Trainer(base.Trainer):
    """``reference/yolo``'s Trainer with ``YoloV12`` as its network."""

    def __init__(self, cfg: TrainConfig = TrainConfig(), mesh=None,
                 seed: int = 0, device="cuda"):
        if mesh is not None:
            raise ValueError("the reference YOLO12 trainer runs on one "
                             "device")
        if cfg.arch != "yolo12":
            raise ValueError(f"arch {cfg.arch!r}: this reference trains "
                             "YOLO12 only")
        self.cfg = cfg
        self.mesh = None
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = YoloV12(cfg.variant, cfg.nc, cfg.segment,
                                 cfg.proto_stride).train()
        self._data_group = self._model_group = None
        self._names = [n for n, _ in self.model.named_parameters()]
        self._params = [p for _, p in self.model.named_parameters()]
        self._stats = base._bn_buffers(self.model)
        self.opt_state = self.init_opt_state()
        self.step = 0
        self.lr_at = base.lr_schedule(cfg)
        self.anchors, self.strides = base._anchors_for(cfg.imgsz,
                                                       device=self.device)
        self._inv255 = torch.tensor(np.float32(1) / np.float32(255),
                                    device=self.device)
        self._consts: Dict[Any, torch.Tensor] = {}
