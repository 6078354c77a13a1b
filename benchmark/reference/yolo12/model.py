"""YOLO12 detect/segment network, written plainly: every layer is
``F.conv2d``, ``F.batch_norm`` in training mode, ``F.silu``,
``F.conv_transpose2d``, ``F.interpolate``, and attention as ``torch.matmul``
and ``torch.softmax``. Modules only hold the parameters, under
ultralytics' state-dict names (``model.6.m.0.0.attn.qkv.conv.weight``,
``model.6.gamma``), so the program's state loads by name.

The graph is ``yolo12-seg.yaml``'s (layers 0-21) with ``parse_model``'s
scale rules: repeats ``max(round(n * depth), 1)`` for n > 1; channels
``make_divisible(min(c, max_channels) * width, 8)``; C3k2 takes C3k blocks
at m, l and x; A2C2f has a layer-scaled residual (``gamma``) and MLP
ratio 1.2 at l and x, 2.0 and none below. The head is YOLOv11's decoupled
Segment (box 3x3-3x3-1x1 to 4 x 16 DFL bins; class DW3x3-1x1-DW3x3-1x1-1x1;
mask coefficients 3x3-3x3-1x1; proto 3x3, 2x2 transposed, 3x3, 1x1).

Departures from the published description, each deliberate:

- ``nc`` and the input size are the caller's (the benchmark's tissue task:
  nc 4 at 512 px).
- BatchNorm keeps eitx's ``eps`` 1e-3 and moves its running statistics
  with momentum 0.03 (flax's 0.97 kept): ultralytics' BatchNorm2d has
  eps 1e-3 and momentum 0.03 too. ``F.batch_norm`` updates the running
  variance with the unbiased batch variance; the program follows flax
  (biased). The train step's outputs use the batch's own statistics, so
  this moves only the running statistics, which no comparison reads.
- The segment head may have a second proto stage (``proto_stride`` 2:
  a 2x2 transposed convolution to ``max(c_ / 2, nm)`` channels and a
  3x3), eitx's extension of ultralytics' Proto.
- Area attention takes its areas as ``area`` stripes of whole rows by a
  loop over them, so a map whose height ``area`` does not divide is
  refused (ultralytics' reshape would split rows there).
- The position perceiver is a depthwise 7x7 as the paper and ultralytics'
  module code write it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03

# depth, width, max_channels (yolo12-seg.yaml)
SCALES = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}


class Conv(nn.Module):
    """Convolution without bias, BatchNorm on the batch's statistics,
    SiLU (none with ``act=False``); padding k // 2."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, bias=False, groups=g)
        self.bn = nn.BatchNorm2d(c2)
        self.k, self.s, self.g, self.act = k, s, g, act

    def forward(self, x):
        y = F.conv2d(x, self.conv.weight, None, self.s, self.k // 2, 1,
                     self.g)
        y = F.batch_norm(y, self.bn.running_mean, self.bn.running_var,
                         self.bn.weight, self.bn.bias, True, BN_MOMENTUM,
                         BN_EPS)
        return F.silu(y) if self.act else y


class Pointwise(nn.Module):
    """A 1x1 convolution with a bias (the head's last layers)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c2, c1, 1, 1))
        self.bias = nn.Parameter(torch.empty(c2))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias)


class UpConv(nn.Module):
    """A 2x2 transposed convolution of stride 2 with a bias."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c1, c2, 2, 2))
        self.bias = nn.Parameter(torch.empty(c2))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, e: float):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 3)
        self.cv2 = Conv(c_, c2, 3)
        self.add = c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """Two 1x1 branches, one through two 3x3 bottlenecks (hidden width
    1.0), fused by a 1x1."""

    def __init__(self, c1: int, c2: int, n: int = 2):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv(c1, c_)
        self.cv3 = Conv(2 * c_, c2)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, 1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k2(nn.Module):
    """ultralytics' C3k2: a 1x1 to two halves of ``c2 * e``, ``n`` blocks
    on the second (C3k, or a plain bottleneck of hidden width 0.5), every
    piece fused by a 1x1."""

    def __init__(self, c1: int, c2: int, n: int, c3k: bool, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * c)
        self.cv2 = Conv((2 + n) * c, c2)
        self.m = nn.ModuleList(C3k(c, c) if c3k else Bottleneck(c, c, 0.5)
                               for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


class AAttn(nn.Module):
    """Area attention: ``heads`` heads of ``dim / heads`` channels, within
    each of ``area`` stripes of H / area rows; qkv channels per head as
    [q, k, v]; out = proj(attention + pe(v)), pe a depthwise 7x7."""

    def __init__(self, dim: int, heads: int, area: int):
        super().__init__()
        self.heads, self.area = heads, area
        self.qkv = Conv(dim, 3 * dim, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        if H % self.area:
            raise ValueError(f"{H} rows do not split into {self.area} "
                             "stripes")
        h, hd = self.heads, C // self.heads
        rows = H // self.area
        qkv = self.qkv(x)
        outs, values = [], []
        for s in range(self.area):
            stripe = qkv[:, :, s * rows:(s + 1) * rows, :]
            per_head = stripe.reshape(B, h, 3 * hd, rows * W)
            q = per_head[:, :, :hd]
            k = per_head[:, :, hd:2 * hd]
            v = per_head[:, :, 2 * hd:]
            scores = torch.matmul(q.transpose(2, 3), k) / math.sqrt(hd)
            weights = torch.softmax(scores, dim=-1)  # over the keys
            o = torch.matmul(v, weights.transpose(2, 3))
            outs.append(o.reshape(B, C, rows, W))
            values.append(v.reshape(B, C, rows, W))
        o, v = torch.cat(outs, 2), torch.cat(values, 2)
        return self.proj(o + self.pe(v))


class ABlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, area: int):
        super().__init__()
        self.attn = AAttn(dim, heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, hidden),
                                 Conv(hidden, dim, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """A 1x1 to ``c2 / 2``, ``n`` stages (two ABlocks with ``a2``, else a
    C3k), all fused by a 1x1; with ``a2`` and ``residual``,
    ``x + gamma * out``."""

    def __init__(self, c1: int, c2: int, n: int, a2: bool, area: int,
                 residual: bool, mlp_ratio: float):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_)
        self.cv2 = Conv((1 + n) * c_, c2)
        self.gamma = nn.Parameter(torch.empty(c2)) if a2 and residual \
            else None
        self.m = nn.ModuleList(
            nn.Sequential(ABlock(c_, c_ // 32, mlp_ratio, area),
                          ABlock(c_, c_ // 32, mlp_ratio, area))
            if a2 else C3k(c_, c_) for _ in range(n))

    def forward(self, x):
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        out = self.cv2(torch.cat(ys, 1))
        if self.gamma is None:
            return out
        return x + self.gamma.view(1, -1, 1, 1) * out


class Proto(nn.Module):
    def __init__(self, c1: int, c_: int, nm: int, proto_stride: int):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = UpConv(c_, c_)
        self.cv2 = Conv(c_, c_, 3)
        c_out = c_
        if proto_stride == 2:
            c_out = max(c_ // 2, nm)
            self.upsample2 = UpConv(c_, c_out)
            self.cv2b = Conv(c_out, c_out, 3)
        self.cv3 = Conv(c_out, nm)
        self.proto_stride = proto_stride

    def forward(self, x):
        p = self.cv2(self.upsample(self.cv1(x)))
        if self.proto_stride == 2:
            p = self.cv2b(self.upsample2(p))
        return self.cv3(p)


class Segment(nn.Module):
    def __init__(self, nc: int, ch: Sequence[int], segment: bool,
                 npr: int, proto_stride: int, reg_max: int = 16,
                 nm: int = 32):
        super().__init__()
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.segment = segment
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                          Pointwise(c2, 4 * reg_max)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3)),
                          nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3)),
                          Pointwise(c3, nc)) for x in ch)
        if segment:
            c4 = max(ch[0] // 4, nm)
            self.cv4 = nn.ModuleList(
                nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                              Pointwise(c4, nm)) for x in ch)
            self.proto = Proto(ch[0], npr, nm, proto_stride)

    def forward(self, feats: List[torch.Tensor]):
        levels = [(b(f), c(f)) for b, c, f in zip(self.cv2, self.cv3, feats)]
        if not self.segment:
            return levels, None, None
        coefs = [m(f) for m, f in zip(self.cv4, feats)]
        return levels, coefs, self.proto(feats[0])


class YoloV12(nn.Module):
    """yolo12-seg.yaml at scale ``variant``; returns ``{"levels",
    "strides"}`` and, segmenting, ``"mask_coefs"`` and ``"proto"``."""

    def __init__(self, variant: str = "l", nc: int = 4, segment: bool = True,
                 proto_stride: int = 4):
        super().__init__()
        depth, width, max_ch = SCALES[variant]

        def ch(c):
            return int(math.ceil(min(c, max_ch) * width / 8) * 8)

        def rep(n):
            return max(round(n * depth), 1) if n > 1 else n

        c3k = variant in ("m", "l", "x")
        big = variant in ("l", "x")
        mlp = 1.2 if big else 2.0
        self.segment = segment
        self.model = nn.ModuleList([
            Conv(3, ch(64), 3, 2),
            Conv(ch(64), ch(128), 3, 2, g=2),
            C3k2(ch(128), ch(256), rep(2), c3k, e=0.25),
            Conv(ch(256), ch(256), 3, 2, g=4),
            C3k2(ch(256), ch(512), rep(2), c3k, e=0.25),
            Conv(ch(512), ch(512), 3, 2),
            A2C2f(ch(512), ch(512), rep(4), True, 4, big, mlp),
            Conv(ch(512), ch(1024), 3, 2),
            A2C2f(ch(1024), ch(1024), rep(4), True, 1, big, mlp),
            nn.Identity(), nn.Identity(),  # upsample, concat
            A2C2f(ch(1024) + ch(512), ch(512), rep(2), False, 1, big, mlp),
            nn.Identity(), nn.Identity(),  # upsample, concat
            A2C2f(ch(512) + ch(512), ch(256), rep(2), False, 1, big, mlp),
            Conv(ch(256), ch(256), 3, 2),
            nn.Identity(),  # concat
            A2C2f(ch(256) + ch(512), ch(512), rep(2), False, 1, big, mlp),
            Conv(ch(512), ch(512), 3, 2),
            nn.Identity(),  # concat
            C3k2(ch(512) + ch(1024), ch(1024), rep(2), True),
            Segment(nc, (ch(256), ch(512), ch(1024)), segment,
                    int(256 * width), proto_stride),
        ])

    def forward(self, x: torch.Tensor) -> Dict:
        m = self.model

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        p3 = m[4](m[3](m[2](m[1](m[0](x)))))
        p4 = m[6](m[5](p3))
        p5 = m[8](m[7](p4))
        h11 = m[11](torch.cat([up(p5), p4], 1))
        h14 = m[14](torch.cat([up(h11), p3], 1))
        h17 = m[17](torch.cat([m[15](h14), h11], 1))
        h20 = m[20](torch.cat([m[18](h17), p5], 1))
        levels, coefs, proto = m[21]([h14, h17, h20])
        out = {"levels": levels, "strides": (8, 16, 32)}
        if self.segment:
            out["mask_coefs"] = coefs
            out["proto"] = proto
        return out
