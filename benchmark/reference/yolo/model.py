"""Frozen copy of eitx_torch/models/yolo/model.py as of commit 82a40b4, copied
unchanged but for this note.

YOLOv11 detect/segment network as ``nn.Module``s (NCHW).

Port of eitx/models/yolo/model.py: backbone (Conv x2, C3k2, Conv, C3k2,
Conv, C3k2, Conv, C3k2, SPPF, C2PSA), PAN head with two upsample and two
downsample fusions, and a decoupled Detect/Segment head with DFL box
regression (reg_max=16). Layer ``model.N`` matches the JAX package's
``model_N`` and the ultralytics state dict's ``model.N``.

The segment head's proto branch has the JAX package's ``proto_stride=2``
extension: a second ConvTranspose2d upsample (``proto.upsample2``) and
conv (``proto.cv2b``) after the ultralytics Proto trunk, which the
serving checkpoints use.

Outputs are raw per-level maps in NCHW; decoding and NMS live in post.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from .blocks import C2PSA, C3k2, Conv, Conv2d, ConvTranspose2d, SPPF


@dataclass(frozen=True)
class YoloSpec:
    nc: int = 4  # classes
    reg_max: int = 16
    nm: int = 32  # mask coefficients (segment)
    npr: int = 256  # proto channels base
    # proto mask-grid stride: 4 = ultralytics Proto; 2 adds a second
    # upsample stage (JAX-package extension, recorded in checkpoint meta)
    proto_stride: int = 4
    width: float = 0.50
    depth: float = 0.50
    max_channels: int = 1024
    segment: bool = True

    def ch(self, c: int) -> int:
        return int(min(c, self.max_channels) * self.width)

    def rep(self, n: int) -> int:
        return max(1, round(n * self.depth))


def yolov11_spec(
    variant: str = "s", nc: int = 4, segment: bool = True,
    proto_stride: int = 4,
) -> YoloSpec:
    scales = {
        # depth, width, max_channels (ultralytics yolo11.yaml scales)
        "n": (0.50, 0.25, 1024),
        "s": (0.50, 0.50, 1024),
        "m": (0.50, 1.00, 512),
        "l": (1.00, 1.00, 512),
        "x": (1.00, 1.50, 512),
    }
    d, w, mc = scales[variant]
    if proto_stride not in (2, 4):
        raise ValueError(f"proto_stride must be 2 or 4, got {proto_stride}")
    return YoloSpec(
        nc=nc, width=w, depth=d, max_channels=mc, segment=segment,
        proto_stride=proto_stride,
    )


class Proto(nn.Module):
    """Mask prototypes on the P3 feature."""

    def __init__(self, c1: int, c_: int, nm: int, proto_stride: int):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        c_out = c_
        if proto_stride == 2:
            # second upsample stage: half the channels at 4x the pixels
            c_out = max(c_ // 2, nm)
            self.upsample2 = ConvTranspose2d(c_, c_out, 2, 2, 0, bias=True)
            self.cv2b = Conv(c_out, c_out, 3)
        self.cv3 = Conv(c_out, nm)
        self.proto_stride = proto_stride

    def forward(self, x):
        p = self.cv2(self.upsample(self.cv1(x)))
        if self.proto_stride == 2:
            p = self.cv2b(self.upsample2(p))
        return self.cv3(p)


class Segment(nn.Module):
    """v11 decoupled Detect (+ Segment) head: per-level box / class /
    (mask-coefficient) branches and the proto."""

    def __init__(self, spec: YoloSpec, ch: Tuple[int, ...]):
        super().__init__()
        s = spec
        c2 = max(16, ch[0] // 4, s.reg_max * 4)
        c3 = max(ch[0], min(s.nc, 100))
        self.segment = s.segment
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                          Conv2d(c2, 4 * s.reg_max, 1))
            for x in ch
        )
        # cls branch: (DWConv + 1x1) x2 + 1x1 (v11 decoupled-lite head)
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
                nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
                Conv2d(c3, s.nc, 1),
            )
            for x in ch
        )
        if s.segment:
            c4 = max(ch[0] // 4, s.nm)
            self.cv4 = nn.ModuleList(
                nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                              Conv2d(c4, s.nm, 1))
                for x in ch
            )
            self.proto = Proto(ch[0], int(s.npr * s.width), s.nm,
                               s.proto_stride)

    def forward(self, feats: Sequence[torch.Tensor]):
        levels = [(b(f), c(f)) for b, c, f in zip(self.cv2, self.cv3, feats)]
        if not self.segment:
            return levels, None, None
        coefs = [m(f) for m, f in zip(self.cv4, feats)]
        return levels, coefs, self.proto(feats[0])


class YoloV11(nn.Module):
    """Full network; returns a dict with per-level raw outputs (NCHW)."""

    def __init__(self, spec: YoloSpec = YoloSpec()):
        super().__init__()
        self.spec = s = spec
        ch = s.ch
        n = s.rep(2)
        up = nn.Upsample(scale_factor=2, mode="nearest")
        self.model = nn.ModuleList([
            Conv(3, ch(64), 3, 2),                        # 0  P1
            Conv(ch(64), ch(128), 3, 2),                  # 1  P2
            C3k2(ch(128), ch(256), n, False, e=0.25),     # 2
            Conv(ch(256), ch(256), 3, 2),                 # 3  P3
            C3k2(ch(256), ch(512), n, False, e=0.25),     # 4
            Conv(ch(512), ch(512), 3, 2),                 # 5  P4
            C3k2(ch(512), ch(512), n, True),              # 6
            Conv(ch(512), ch(1024), 3, 2),                # 7  P5
            C3k2(ch(1024), ch(1024), n, True),            # 8
            SPPF(ch(1024), ch(1024), 5),                  # 9
            C2PSA(ch(1024), ch(1024), n),                 # 10
            up,                                           # 11
            nn.Identity(),                                # 12 (concat)
            C3k2(ch(1024) + ch(512), ch(512), n, False),  # 13
            up,                                           # 14
            nn.Identity(),                                # 15 (concat)
            C3k2(ch(512) + ch(512), ch(256), n, False),   # 16 P3 out
            Conv(ch(256), ch(256), 3, 2),                 # 17
            nn.Identity(),                                # 18 (concat)
            C3k2(ch(256) + ch(512), ch(512), n, False),   # 19 P4 out
            Conv(ch(512), ch(512), 3, 2),                 # 20
            nn.Identity(),                                # 21 (concat)
            C3k2(ch(512) + ch(1024), ch(1024), n, True),  # 22 P5 out
            Segment(s, (ch(256), ch(512), ch(1024))),     # 23
        ])

    def forward(self, x: torch.Tensor) -> Dict:
        m = self.model
        y4 = m[4](m[3](m[2](m[1](m[0](x)))))
        y6 = m[6](m[5](y4))
        y10 = m[10](m[9](m[8](m[7](y6))))
        y13 = m[13](torch.cat([m[11](y10), y6], 1))
        y16 = m[16](torch.cat([m[14](y13), y4], 1))
        y19 = m[19](torch.cat([m[17](y16), y13], 1))
        y22 = m[22](torch.cat([m[20](y19), y10], 1))
        levels, coefs, proto = m[23]((y16, y19, y22))
        out = {"levels": levels, "strides": (8, 16, 32)}
        if self.spec.segment:
            out["mask_coefs"] = coefs
            out["proto"] = proto
        return out
