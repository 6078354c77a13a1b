"""Synthetic CT-like training batches and the device-resident batch stream.

Port of eitx/train/data.py. ``synthetic_ct_batch`` (:17-64) is numpy and
gives the reference's arrays for the same seed: ellipse phantoms with
per-instance boxes and masks in the YOLO segmentation target format, the
in-repo analogue of the reference's HU-threshold pseudo-labelled training
sets (scripts/create_femm_dataset hu_ranges at :757-762).

``device_batches`` (:67-254) uploads the sample store to the device once
and draws each batch there: a gather, flips and the quadrant mosaic. Its
random numbers are eitx's: the same threefry key chain and the same
``randint`` / ``uniform`` draws (``core.prng``), so a seed gives eitx's
batches element for element. The draws are computed on the host a block
of steps at a time and uploaded in one copy a block; the gathers stay on
the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import prng
from ..core.device import resolve_device
from ..core.timing import span

# steps whose draws one host pass computes and one upload carries
_DRAW_BLOCK = 64


def synthetic_ct_batch(
    batch: int = 2,
    imgsz: int = 256,
    max_instances: int = 8,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Returns dict(images (B,S,S,3) f32[0,1], boxes (B,I,4) xyxy px,
    classes (B,I) int32, masks (B,I,S/4,S/4) f32, valid (B,I) bool)."""
    rng = np.random.default_rng(seed)
    s = imgsz
    ms = imgsz // 4
    images = np.zeros((batch, s, s, 3), np.float32)
    boxes = np.zeros((batch, max_instances, 4), np.float32)
    classes = np.zeros((batch, max_instances), np.int32)
    masks = np.zeros((batch, max_instances, ms, ms), np.float32)
    valid = np.zeros((batch, max_instances), bool)
    yy, xx = np.mgrid[0:s, 0:s]
    for b in range(batch):
        # body
        img = rng.normal(0.05, 0.02, (s, s)).astype(np.float32)
        cx, cy = s / 2 + rng.uniform(-10, 10), s / 2 + rng.uniform(-10, 10)
        rx, ry = s * 0.4, s * 0.3
        body = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1
        img[body] = 0.45 + rng.normal(0, 0.02, body.sum())
        n_inst = rng.integers(2, max_instances // 2 + 1)
        for i in range(n_inst):
            cls = int(rng.integers(0, 4))
            icx = cx + rng.uniform(-rx * 0.5, rx * 0.5)
            icy = cy + rng.uniform(-ry * 0.5, ry * 0.5)
            irx = rng.uniform(s * 0.04, s * 0.12)
            iry = rng.uniform(s * 0.04, s * 0.12)
            blob = ((xx - icx) / irx) ** 2 + ((yy - icy) / iry) ** 2 < 1
            shade = {0: 0.95, 1: 0.55, 2: 0.15, 3: 0.35}[cls]
            img[blob] = shade + rng.normal(0, 0.02, blob.sum())
            boxes[b, i] = [icx - irx, icy - iry, icx + irx, icy + iry]
            classes[b, i] = cls
            # instance mask at proto resolution
            mby = blob[::4, ::4]
            masks[b, i] = mby.astype(np.float32)
            valid[b, i] = True
        images[b] = np.repeat(np.clip(img, 0, 1)[..., None], 3, axis=-1)
    return {
        "images": images,
        "boxes": boxes,
        "classes": classes,
        "masks": masks,
        "valid": valid,
    }



def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """Indices of ``x`` sorted descending along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices


def _stream_draws(key: np.ndarray, steps: int, batch: int, n: int,
                  i_store: int, augment: bool, flip_h_prob: float,
                  flip_v_prob: float, mosaic_prob: float):
    """The random numbers of ``steps`` steps of eitx's ``device_batches``
    (eitx/train/data.py:207-254, :149, :176) from the stream's ``key``:
    ``key, sub = split(key)`` a step, ``sub`` split in 6 with a mosaic and
    in 3 without. Returns the next key and an int32 (steps, W) block, each
    row one step's draws back to back: the sample indices (batch), the
    flip and mosaic selections (3 * batch, 0 / 1), the mosaic's sample
    indices (4 * batch) and its selection scores (batch * 4 * i_store,
    float32 bits)."""
    subs = np.empty((steps, 2), np.uint32)
    for i in range(steps):
        key, subs[i] = prng.split(key)
    ks = prng.split(subs, 6 if mosaic_prob else 3)
    cols = [prng.randint(ks[:, 0], (batch,), 0, n)]
    flags = np.zeros((steps, 3, batch), np.int32)
    if augment:
        flags[:, 0] = prng.uniform(ks[:, 1], (batch,)) < np.float32(flip_h_prob)
        flags[:, 1] = prng.uniform(ks[:, 2], (batch,)) < np.float32(flip_v_prob)
    if mosaic_prob:
        flags[:, 2] = prng.uniform(ks[:, 3], (batch,)) < np.float32(mosaic_prob)
    cols.append(flags.reshape(steps, -1))
    if mosaic_prob:
        cols.append(prng.randint(ks[:, 4], (batch, 4), 0, n).reshape(steps, -1))
        cols.append(prng.uniform(ks[:, 5], (batch, 4 * i_store))
                    .reshape(steps, -1).view(np.int32))
    return key, np.ascontiguousarray(np.concatenate(cols, axis=1))


def _named_draws(rows, batch: int) -> dict:
    """The draws of one or more rows of ``_stream_draws`` ((..., W), numpy
    or torch) by name: ``idx`` (..., batch); ``flip_h``, ``flip_v`` and
    ``mosaic`` (..., batch) bool; with the mosaic, ``idx4`` (..., batch, 4)
    and ``score`` (..., batch, 4 * i_store) float32."""
    lead = tuple(rows.shape[:-1])
    flags = rows[..., batch:4 * batch].reshape(lead + (3, batch)) != 0
    out = {"idx": rows[..., :batch], "flip_h": flags[..., 0, :],
           "flip_v": flags[..., 1, :], "mosaic": flags[..., 2, :]}
    if rows.shape[-1] > 4 * batch:
        f32 = np.float32 if isinstance(rows, np.ndarray) else torch.float32
        out["idx4"] = rows[..., 4 * batch:8 * batch].reshape(
            lead + (batch, 4))
        out["score"] = rows[..., 8 * batch:].view(f32).reshape(
            lead + (batch, -1))
    return out


def device_batches(
    data: Dict[str, np.ndarray],
    batch: int,
    seed: int = 0,
    augment: bool = True,
    flip_h_prob: float = 0.5,
    flip_v_prob: float = 0.25,
    mosaic_prob: float = 0.0,
    mosaic_budget: int = 0,
    device="cuda",
):
    """Device-resident minibatch stream.

    Uploads the pregenerated sample store to ``device`` once and draws
    every training batch there: a gather of ``batch`` samples (uniform,
    with replacement), optionally replaced by quadrant mosaics, then flip
    augmentation. Yields dicts of device tensors with the store's keys and
    dtypes (images u8 (B, S, S, 3), masks u8, boxes f32, classes i32,
    valid bool); a ``masks`` key is optional (detection-only stores). The
    flip mirror coordinate is the store's own image size. Resumed runs
    pass a ``seed`` derived from the restored step, so a continuation
    draws a fresh stream.

    ``mosaic_prob`` > 0 replaces that fraction of samples with a quadrant
    mosaic (fixed centre): four store samples downscaled 2x into the four
    quadrants of one canvas, boxes scaled and offset, masks moved to the
    matching quadrant of the mask canvas. The target budget of a mosaic is
    ``mosaic_budget`` (0 = the store's); candidates beyond it are dropped
    by random selection among the valid instances (valid first, then a
    uniform score), as the reference does. With ``mosaic_prob=0`` the
    stream draws exactly what it draws without the option.

    The random numbers are eitx's for the same seed (``_stream_draws``),
    computed on the host ``_DRAW_BLOCK`` steps at a time; a block goes up
    in one pinned, non-blocking copy, so no step waits for the device.
    """
    dev = resolve_device(device)
    keys = [k for k in ("images", "boxes", "classes", "masks", "valid")
            if k in data]
    store = {k: torch.from_numpy(np.ascontiguousarray(data[k])).to(dev)
             for k in keys}
    n = int(store["images"].shape[0])
    size = float(data["images"].shape[1])
    i_store = int(store["boxes"].shape[1])
    i_out = max(int(mosaic_budget) or i_store, i_store)
    s2 = data["images"].shape[1] // 2
    # the mosaic's quadrant offsets (x, y, x, y), uploaded once
    offsets = torch.tensor([[0.0, 0.0], [s2, 0.0], [0.0, s2], [s2, s2]],
                           dtype=torch.float32, device=dev).repeat(1, 2)

    def upload(block: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(block)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    def pad_targets(b):
        """Pad target axes from the store budget to i_out (mosaic runs
        widen the budget; plain samples pad with invalid slots)."""
        if i_out == i_store:
            return b
        pad = i_out - i_store
        out = dict(b)
        out["boxes"] = torch.nn.functional.pad(b["boxes"], (0, 0, 0, pad))
        out["classes"] = torch.nn.functional.pad(b["classes"], (0, pad))
        out["valid"] = torch.nn.functional.pad(b["valid"], (0, pad))
        if "masks" in b:
            out["masks"] = torch.nn.functional.pad(
                b["masks"], (0, 0, 0, 0, 0, pad))
        return out

    def mosaic(idx4, score):
        """(batch,) quadrant mosaics with random-selection budget."""
        g = {k: v.index_select(0, idx4) for k, v in store.items()}
        img = g["images"]  # (4B, S, S, C) -> 2x2 mean downscale
        c = img.shape[-1]
        small = img.reshape(batch * 4, s2, 2, s2, 2, c).to(
            torch.float32).mean((2, 4)).reshape(batch, 4, s2, s2, c)
        canvas = torch.cat([torch.cat([small[:, 0], small[:, 1]], dim=2),
                            torch.cat([small[:, 2], small[:, 3]], dim=2)],
                           dim=1)
        if not img.dtype.is_floating_point:
            canvas = torch.round(canvas)
        canvas = canvas.to(img.dtype)
        # boxes: scale 0.5 + per-quadrant offset; invalid slots stay 0
        box = g["boxes"].reshape(batch, 4, i_store, 4) * 0.5
        box = box + offsets[None, :, None, :]
        val = g["valid"].reshape(batch, 4, i_store)
        box = (box * val[..., None]).reshape(batch, 4 * i_store, 4)
        cls = g["classes"].reshape(batch, 4 * i_store)
        val = val.reshape(batch, 4 * i_store)
        # random budget selection among valid candidates
        score = torch.where(val, score + 1.0, score)  # valid first
        keep = _desc_order(score)[:, :i_out]

        def take(a):
            idx = keep.reshape(keep.shape + (1,) * (a.dim() - 2))
            return torch.gather(a, 1, idx.expand(-1, -1, *a.shape[2:]))

        out = {"images": canvas, "boxes": take(box),
               "classes": torch.gather(cls, 1, keep),
               "valid": torch.gather(val, 1, keep)}
        if "masks" in g:
            msk = g["masks"]  # (4B, I, r, r)
            r = msk.shape[-1]
            r2 = r // 2
            m = msk.reshape(batch * 4 * i_store, r2, 2, r2, 2).to(
                torch.float32).mean((2, 4)).reshape(batch, 4, i_store, r2, r2)
            quad = torch.zeros((batch, 4, i_store, r, r), dtype=torch.float32,
                               device=dev)
            quad[:, 0, :, :r2, :r2] = m[:, 0]
            quad[:, 1, :, :r2, r2:] = m[:, 1]
            quad[:, 2, :, r2:, :r2] = m[:, 2]
            quad[:, 3, :, r2:, r2:] = m[:, 3]
            quad = quad.reshape(batch, 4 * i_store, r, r)
            if not msk.dtype.is_floating_point:
                quad = torch.round(quad)
            out["masks"] = take(quad.to(msk.dtype))
        return out

    def per_sample(sel, ndim):
        return sel.reshape((batch,) + (1,) * (ndim - 1))

    @torch.no_grad()
    def draw(row: torch.Tensor):
        """One batch from one step's row of draws (``_stream_draws``)."""
        d = _named_draws(row, batch)
        sel_h, sel_v = d["flip_h"], d["flip_v"]
        b = pad_targets({k: v.index_select(0, d["idx"])
                         for k, v in store.items()})
        if mosaic_prob:
            mos = mosaic(d["idx4"].reshape(-1), d["score"])
            b = {k: torch.where(per_sample(d["mosaic"], v.dim()), mos[k], v)
                 for k, v in b.items()}
        if not augment:
            return b
        img, box = b["images"], b["boxes"]
        val = b["valid"][..., None]
        img = torch.where(per_sample(sel_h, 4), img.flip(2), img)
        box_h = torch.stack([size - box[..., 2], box[..., 1],
                             size - box[..., 0], box[..., 3]], -1)
        box = torch.where(per_sample(sel_h, 3), box_h, box)
        img = torch.where(per_sample(sel_v, 4), img.flip(1), img)
        box_v = torch.stack([box[..., 0], size - box[..., 3],
                             box[..., 2], size - box[..., 1]], -1)
        box = torch.where(per_sample(sel_v, 3), box_v, box)
        box = torch.where(val, box, 0.0)
        out = {**b, "images": img, "boxes": box}
        if "masks" in b:
            msk = b["masks"]
            msk = torch.where(per_sample(sel_h, 4), msk.flip(3), msk)
            msk = torch.where(per_sample(sel_v, 4), msk.flip(2), msk)
            out["masks"] = msk
        return out

    key, rows = prng.key(seed), []
    while True:
        with span("eitx.train.batch"):
            if not rows:
                key, block = _stream_draws(key, _DRAW_BLOCK, batch, n,
                                           i_store, augment, flip_h_prob,
                                           flip_v_prob, mosaic_prob)
                rows = list(upload(block))
            out = draw(rows.pop(0))
        yield out
