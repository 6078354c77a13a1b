"""A training store of segmentation phantoms, drawn on the card from the seed.

The format is the one ``eitx_torch/scripts/train_tissue.py`` stores
(``phantom_batch(..., store_u8=True)``): uint8 images (N, S, S, 3), uint8
soft instance masks (N, I, R, R), xyxy boxes in pixels (N, I, 4), int32
classes and a bool ``valid`` (N, I). A sample is a body ellipse with 6-12
elliptic instances of the four tissue classes (bone, muscle, lung, fat),
each painted in its class's shade, rotated, and given a soft mask edge.
The step's shapes, and so its work, do not depend on what is drawn.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SHADES = (230.0, 140.0, 30.0, 90.0)  # bone, muscle, lung, fat
CHUNK = 32  # samples drawn at once


def _ellipse_level(x, y, cx, cy, rx, ry, th):
    """(B, H, W) level of rotated ellipses: < 1 inside."""
    c, s = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    dx, dy = x[None] - cx[:, None, None], y[None] - cy[:, None, None]
    u, v = c * dx + s * dy, -s * dx + c * dy
    return (u / rx[:, None, None]) ** 2 + (v / ry[:, None, None]) ** 2


def phantom_store(n: int, size: int, instances: int, mask_res: int,
                  k_range, seed: int, device: torch.device) -> dict:
    """``n`` samples as numpy arrays (the form ``device_batches`` uploads)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = {"images": [], "masks": [], "boxes": [], "classes": [],
           "valid": []}
    pix = torch.arange(size, device=device, dtype=torch.float32) + 0.5
    py, px = torch.meshgrid(pix, pix, indexing="ij")
    mpix = (torch.arange(mask_res, device=device, dtype=torch.float32)
            + 0.5) * (size / mask_res)
    my, mx = torch.meshgrid(mpix, mpix, indexing="ij")
    for start in range(0, n, CHUNK):
        b = min(CHUNK, n - start)

        def u(*shape, lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand(shape, generator=g,
                                               device=device)

        half = size / 2
        bcx, bcy = u(b, lo=half - 20, hi=half + 20), u(b, lo=half - 20,
                                                       hi=half + 20)
        brx, bry = u(b, lo=0.36 * size, hi=0.46 * size), u(
            b, lo=0.26 * size, hi=0.36 * size)
        bth = u(b, lo=-0.2, hi=0.2)
        img = torch.where(_ellipse_level(px, py, bcx, bcy, brx, bry, bth) < 1,
                          120.0, 8.0)
        k = torch.randint(k_range[0], k_range[1] + 1, (b,), generator=g,
                          device=device)
        cls = torch.randint(0, 4, (b, instances), generator=g, device=device)
        valid = torch.arange(instances, device=device)[None] < k[:, None]
        ang = u(b, instances, lo=0.0, hi=2 * math.pi)
        rad = u(b, instances, lo=0.0, hi=0.55)
        cx = bcx[:, None] + rad * brx[:, None] * torch.cos(ang)
        cy = bcy[:, None] + rad * bry[:, None] * torch.sin(ang)
        rx, ry = u(b, instances, lo=14.0, hi=70.0), u(b, instances, lo=14.0,
                                                       hi=70.0)
        th = u(b, instances, lo=0.0, hi=math.pi)
        masks = torch.zeros((b, instances, mask_res, mask_res),
                            device=device)
        shades = torch.tensor(SHADES, device=device)[cls]
        for j in range(instances):
            f = _ellipse_level(px, py, cx[:, j], cy[:, j], rx[:, j],
                               ry[:, j], th[:, j])
            paint = (f < 1) & valid[:, j, None, None]
            img = torch.where(paint, shades[:, j, None, None], img)
            fm = _ellipse_level(mx, my, cx[:, j], cy[:, j], rx[:, j],
                                ry[:, j], th[:, j])
            # a soft edge over the outer tenth of the radius
            masks[:, j] = ((1.0 - fm) * 5.0).clamp(0.0, 1.0) * valid[
                :, j, None, None]
        img = (img + 6.0 * torch.randn(img.shape, generator=g,
                                       device=device)).clamp(0, 255)
        # the rotated ellipse's box: half-widths sqrt(rx^2 c^2 + ry^2 s^2)
        hx = torch.sqrt((rx * torch.cos(th)) ** 2 + (ry * torch.sin(th)) ** 2)
        hy = torch.sqrt((rx * torch.sin(th)) ** 2 + (ry * torch.cos(th)) ** 2)
        boxes = torch.stack([cx - hx, cy - hy, cx + hx, cy + hy], -1).clamp(
            0.0, float(size)) * valid[..., None]
        out["images"].append(img.round().to(torch.uint8)[..., None]
                             .expand(-1, -1, -1, 3))
        out["masks"].append((masks * 255.0).round().to(torch.uint8))
        out["boxes"].append(boxes)
        out["classes"].append((cls * valid).to(torch.int32))
        out["valid"].append(valid)
    return {k: np.ascontiguousarray(torch.cat(v).cpu().numpy())
            for k, v in out.items()}
