"""YOLOv11 and YOLO12 building blocks as ``nn.Module``s (NCHW).

Port of eitx/models/yolo/blocks.py, plus YOLO12's area attention
(``AAttn``, ``ABlock``, ``A2C2f``; arXiv:2502.12524 and ultralytics'
``nn/modules/block.py``), which eitx does not have. Module names follow
the ultralytics state dict (``conv``/``bn``, ``cv1``/``cv2``/``cv3``,
``m``, ``ffn``, ``attn``/``mlp``, ``qkv``/``proj``/``pe``, ``gamma``), so
the checkpoint mapping in checkpoint.py is the inverse of the JAX
package's ``convert._flax_path``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.timing import count, span
from . import rounding


def autopad(k: int, d: int = 1) -> int:
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-3) whose training mode is flax's
    ``BatchNorm(momentum=0.97, epsilon=1e-3)`` (eitx/models/yolo/
    blocks.py:48-52): the batch statistics are ``mean(x)`` and
    ``max(mean(x^2) - mean(x)^2, 0)`` (flax's fast variance), the output
    is ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, and the running
    statistics move by ``0.97 * running + 0.03 * batch`` with the *biased*
    batch variance. torch's own update has momentum 0.1 and the unbiased
    variance. Inference (eval mode) in float32 is ``nn.BatchNorm2d``'s;
    in bfloat16 it is flax's, operation by operation (``_eval_bf16``)."""

    flax_momentum = 0.97
    # train by torch's fused batch norm (``_fused_train``) when no
    # ``sync_group`` is set; YOLO12, which has no eitx network to match
    # bit for bit, sets it
    fused = False
    # the process group of the ranks that hold the other images of the
    # batch (the mesh's data axis; ``Trainer(mesh=...)`` sets it): the
    # batch statistics are then the global batch's, as under eitx's
    # sharding, where XLA all-reduces them
    sync_group = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3)

    def forward(self, x):
        if not self.training:
            if x.dtype == torch.bfloat16:
                return self._eval_bf16(x)
            return super().forward(x)
        if self.sync_group is None and self.fused:
            return self._fused_train(x)
        if self.sync_group is None:
            mean = x.mean((0, 2, 3))
            var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0.0)
        else:
            mean, var = self._global_moments(x)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]

    def _fused_train(self, x):
        """The training output above in exact arithmetic, by one fused
        ``native_batch_norm`` (the batch's mean and biased variance by
        Welford's pass, not flax's ``mean(x^2) - mean(x)^2``) and one
        autograd node in place of about seventy operations, forward and
        backward; the running statistics move by flax's rule on the biased variance,
        recovered from the inverse standard deviation."""
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = (invstd.pow(-2) - self.eps).clamp_min_(0.0)
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y

    def _eval_bf16(self, x):
        """flax's ``BatchNorm`` on bfloat16 statistics and input: each
        operation is computed in float32 and rounded to bfloat16,
        ``mul = rsqrt(var + eps) * scale``, ``y = (x - mean) * mul + bias``.
        Every op below is one torch bfloat16 op, which rounds once, except
        the rsqrt: torch's bfloat16 ``rsqrt`` is not the rounded float32
        one, so it is taken in float32 and rounded."""
        var = self.running_var + rounding.constant(self.eps, x.dtype)
        mul = torch.rsqrt(var.float()).to(x.dtype) * self.weight
        y = (x - self.running_mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]

    def _global_moments(self, x):
        """Mean and flax's fast variance over every rank's images. The
        ranks hold equal blocks of the batch (``parallel.shard_batch``),
        so the global mean of x and of x^2 is the mean of the ranks'
        means: one all-reduce over ``sync_group`` that carries the
        gradient back to every rank. A group of one computes exactly what
        the single-device path computes."""
        from torch.distributed import get_world_size
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        m = all_reduce(torch.cat([x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))]),
                       group=self.sync_group)
        m = m / float(get_world_size(self.sync_group))
        mean = m[:c]
        return mean, torch.clamp_min(m[c:] - mean * mean, 0.0)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d``; in bfloat16 the bias is added to the rounded
    convolution and rounds again, as flax's ``nn.Conv`` adds it (a fused
    bias rounds once)."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) \
            + self.bias[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no output size, no output padding); in
    bfloat16 its bias is added as ``Conv2d``'s is."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return F.conv_transpose2d(x, self.weight, None, self.stride,
                                  self.padding, 0, self.groups,
                                  self.dilation) + self.bias[:, None, None]


class SiLU(nn.Module):
    """``nn.SiLU``, rounded as jax's ``nn.silu`` on bfloat16
    (``rounding.silu``)."""

    def forward(self, x):
        return rounding.silu(x)


class Conv(nn.Module):
    """Conv2d + BatchNorm (eps 1e-3) + SiLU (ultralytics Conv)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 d: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, d), dilation=d,
                              groups=g, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = SiLU() if act else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """CSP bottleneck with 3 convs, kxk bottlenecks (ultralytics C3k)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, k: int = 3):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(
            Bottleneck(c_, c_, shortcut, g, k=(k, k), e=1.0) for _ in range(n)
        ))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k2(nn.Module):
    """C2f whose inner blocks are C3k (c3k=True) or Bottleneck.

    ``bottleneck_e`` is the plain Bottleneck's hidden width: eitx's (and
    so the port's YOLOv11's) 1.0, C2f's; ultralytics' C3k2 builds it at
    Bottleneck's default 0.5, which YOLO12 uses."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, g: int = 1, shortcut: bool = True,
                 bottleneck_e: float = 1.0):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k
            else Bottleneck(self.c, self.c, shortcut, g, k=(3, 3),
                            e=bottleneck_e)
            for _ in range(n)
        )

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x):
        y = [self.cv1(x)]
        y.extend(self.m(y[-1]) for _ in range(3))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """PSA attention: 1x1 qkv conv, per-head attention over H*W, depthwise
    positional conv on v (ultralytics Attention)."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        h = dim + self.key_dim * num_heads * 2
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        q, k, v = self.qkv(x).view(
            B, self.num_heads, self.key_dim * 2 + self.head_dim, N
        ).split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = rounding.einsum("bhcn,bhcm->bhnm", q, k) * rounding.constant(
            self.scale, q.dtype)
        attn = rounding.softmax(attn, dim=-1)
        x = rounding.einsum("bhcm,bhnm->bhcn", v, attn)
        x = x.view(B, C, H, W) + self.pe(v.reshape(B, C, H, W))
        return self.proj(x)


class PSABlock(nn.Module):
    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(
            PSABlock(self.c, attn_ratio=0.5, num_heads=max(1, self.c // 64))
            for _ in range(n)
        ))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class AAttn(nn.Module):
    """YOLO12's area attention: multi-head self-attention within each of
    ``area`` stripes of H / area whole rows (over the whole map at area
    1), and a depthwise 7x7 "position perceiver" on the values added to
    the output before the projection.

    ``qkv`` is a 1x1 Conv to 3 * dim channels laid out per head (head j:
    q, k, v of ``head_dim`` each from channel 3 * head_dim * j, as
    ultralytics lays them out); tokens are taken row-major, so the
    stripes are contiguous runs of H * W / area tokens. Plain matrix
    products and softmax: deterministic on the card, as the train step
    must be."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.area = area
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Conv(dim, 3 * dim, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, g=dim, act=False)

    def forward(self, x):
        with span("eitx.train.area_attn", x.device):
            B, C, H, W = x.shape
            a, h, hd = self.area, self.num_heads, self.head_dim
            if (H * W) % a:
                raise ValueError(f"a {H}x{W} map does not split into {a} "
                                 "areas of whole tokens")
            n = H * W // a
            count("eitx.train.attn_scores", B * a * h * n * n)
            # (B, 3C, N) -> (B, a, h, 3 hd, n): channel 3 hd j + t, token
            # s n + m of stripe s
            qkv = self.qkv(x).view(B, h, 3 * hd, a, n).permute(0, 3, 1, 2, 4)
            q, k, v = qkv.split(hd, dim=3)
            attn = (q.transpose(-2, -1) @ k) * (hd ** -0.5)
            o = v @ attn.softmax(dim=-1).transpose(-2, -1)
            # (B, a, h, hd, n) -> (B, C, H, W): channel hd j + i
            o = o.permute(0, 2, 3, 1, 4).reshape(B, C, H, W)
            v = v.permute(0, 2, 3, 1, 4).reshape(B, C, H, W)
            return self.proj(o + self.pe(v))


class ABlock(nn.Module):
    """Area attention and a 1x1 MLP (hidden ``int(dim * mlp_ratio)``),
    each added to its input."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2,
                 area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, hidden, 1),
                                 Conv(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """YOLO12's residual ELAN block: a 1x1 Conv to ``c_ = c2 * e``, ``n``
    stages (two ABlocks of ``c_ / 32`` heads each with ``a2``, else a
    C3k), every stage's output concatenated and fused by a 1x1 Conv. With
    ``a2`` and ``residual`` (scales l and x) the output is scaled per
    channel by ``gamma`` (layer scale) and added to the input."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True,
                 area: int = 1, residual: bool = False,
                 mlp_ratio: float = 2.0, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        if c_ % 32:
            raise ValueError(f"A2C2f's hidden width {c_} is not a multiple "
                             "of 32 (heads of 32)")
        self.a2 = a2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.gamma = (nn.Parameter(torch.full((c2,), 0.01))
                      if a2 and residual else None)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area)
                            for _ in range(2)))
            if a2 else C3k(c_, c_, 2)
            for _ in range(n)
        )

    def _forward(self, x):
        y = [self.cv1(x)]
        y.extend(m(y[-1]) for m in self.m)
        y = self.cv2(torch.cat(y, 1))
        if self.gamma is None:
            return y
        return x + self.gamma[:, None, None] * y

    def forward(self, x):
        if not self.a2:
            return self._forward(x)
        with span("eitx.train.a2c2f", x.device):
            return self._forward(x)
