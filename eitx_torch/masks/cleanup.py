"""Mask cleanup on the device.

Port of eitx/masks/cleanup.py (``_external_mask`` :43, ``_relabel_small``
:92, ``cleanup_labels`` :171), which replaces the reference's Python
component loops:
  - clear_color_output (utils.py:691-755): paint unlabeled pixels inside
    the body muscle-red, then relabel connected non-muscle components
    smaller than 5 px to the majority neighbour class (muscle when no
    neighbours).
  - highlight_small_masks (utils.py:758-843): per class, recolor tiny
    regions to the most common neighbouring class.

Everything runs as tensor ops over the (H, W) label image: connected
components via the pointer-jumping labeler, per-component statistics via
integer scatter-adds into flat (H*W, C) tables (integer sums do not
depend on the order of the atomics), neighbour votes via 3x3 windows.
Each ``lax.while_loop`` of the reference is a loop with a convergence
check (``core.fixpoint``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.fixpoint import fixpoint
from ..image.cc import background_from_border, border_mask, label_components
from ..image.morphology import window_or

N_CLASSES = 5
MUSCLE = 1


def _window_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 sum (8-neighbourhood + self) of a 0/1 int array, zero-padded.
    Sums of at most 9 ones are exact in float32."""
    s = F.avg_pool2d(
        x.to(torch.float32)[None, None], 3, stride=1, padding=1,
        count_include_pad=True, divisor_override=1,
    )[0, 0]
    return s.to(torch.int32)


def _external_mask(fg: torch.Tensor) -> torch.Tensor:
    """Pixels of components reachable from the image border — i.e. the
    components cv2.findContours(RETR_EXTERNAL) would return.

    A component nested inside a HOLE of another component is invisible to
    RETR_EXTERNAL. Background floods 4-connected from the border (duality
    with 8-connected foreground), then external components are those
    8-adjacent to the reached background."""
    reach = background_from_border(fg)
    # seed: foreground 8-adjacent to reached background (or on the border)
    touch = window_or(reach | border_mask(fg), 3, 3) & fg

    # propagate the seed through whole components (8-connected)
    def grow8(x):
        return window_or(x, 3, 3) & fg

    return fixpoint(grow8, touch)


def _relabel_small(
    labels, fg, exclude_classes, min_size, fallback=MUSCLE,
    self_votes: bool = False, connectivity: int = 8,
    rect_quirk: bool = False, rect_cap: int = 64,
):
    """Relabel components of ``fg`` smaller than min_size to the majority
    3x3-neighbourhood class, excluding ``exclude_classes`` from the vote;
    fall back to ``fallback`` when no votes.

    ``self_votes=True`` reproduces the reference's clear_color_output
    vote (utils.py:726-750): every pixel of the small component counts
    its 8 neighbours of ANY non-excluded class, including its own
    component, so only isolated 1-px specks fall back.
    """
    h, w = labels.shape
    dev = labels.device
    comp = label_components(fg, connectivity=connectivity)
    flat_comp = comp.reshape(-1)
    safe = torch.clamp(flat_comp, min=0).to(torch.int64)
    ones = (flat_comp >= 0).to(torch.int32)
    sizes = torch.zeros((h * w,), dtype=torch.int32, device=dev).index_add_(
        0, safe, ones)
    small = fg & (sizes[safe].reshape(h, w) < min_size)
    if rect_quirk:
        # cv2 CHAIN_APPROX_SIMPLE stores only run endpoints, so a filled
        # RECTANGLE has a <=4-point contour and the reference's
        # len(cnt) <= 5 rule fires on it at any size (utils.py:806-808);
        # reproduced for bbox-filling components up to ``rect_cap`` px
        yy = torch.arange(h, dtype=torch.int32, device=dev).repeat_interleave(w)
        xx = torch.arange(w, dtype=torch.int32, device=dev).repeat(h)
        big = 1 << 30
        real = flat_comp >= 0
        off = torch.where(real, 0, big).to(torch.int32)

        def reduce(init, src, how):
            t = torch.full((h * w,), init, dtype=torch.int32, device=dev)
            return t.scatter_reduce_(0, safe, src, reduce=how,
                                     include_self=True)

        ymin = reduce(big, yy + off, "amin")
        xmin = reduce(big, xx + off, "amin")
        ymax = reduce(-1, torch.where(real, yy, -1).to(torch.int32), "amax")
        xmax = reduce(-1, torch.where(real, xx, -1).to(torch.int32), "amax")
        bbox = (ymax - ymin + 1) * (xmax - xmin + 1)
        rect = (bbox == sizes) & (sizes <= rect_cap)
        small = small | (fg & rect[safe].reshape(h, w))

    # per-pixel neighbour votes per class
    votes = []
    for c in range(N_CLASSES):
        if c in exclude_classes:
            votes.append(torch.zeros((h, w), dtype=torch.int32, device=dev))
        else:
            src_mask = (labels == c) if self_votes else (
                (labels == c) & ~small
            )
            src = src_mask.to(torch.int32)
            counts = _window_count(src)
            if self_votes:
                # the reference scans the 8 NEIGHBOURS of each pixel —
                # the 3x3 window includes the centre, so subtract it
                counts = counts - src
            votes.append(counts)
    votes = torch.stack(votes, dim=-1).reshape(-1, N_CLASSES)

    # aggregate votes per component
    comp_votes = torch.zeros((h * w, N_CLASSES), dtype=torch.int32,
                             device=dev)
    comp_votes.index_add_(
        0, safe,
        torch.where(small.reshape(-1, 1), votes, torch.zeros_like(votes)),
    )
    best = comp_votes.argmax(dim=1)  # first of ties, as jnp.argmax
    has_votes = comp_votes.max(dim=1).values > 0
    choice = torch.where(has_votes, best, torch.full_like(best, fallback))
    new = choice.to(labels.dtype)[safe].reshape(h, w)
    return torch.where(small, new, labels)


def cleanup_labels(
    labels,
    body_mask,
    min_component: int = 5,
    tiny_area: int = 5,
    device="cuda",
) -> torch.Tensor:
    """Full cleanup pass on an (H, W) label image; returns an int32
    tensor on ``device``.

    body_mask may be None (jpg_png mode skips the fill step, mirroring
    utils.py:1005 where clear_color_output is bypassed without a body
    mask).
    """
    dev = resolve_device(device)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int32,
                             device=dev)

    if body_mask is not None:
        in_body = torch.as_tensor(np.asarray(body_mask), device=dev) > 0
        # 1. unlabeled inside the body -> muscle
        labels = torch.where((labels < 0) & in_body,
                             torch.full_like(labels, MUSCLE), labels)
        # 2. small non-muscle components -> majority neighbour, with the
        # reference's exact vote (self-votes included, 4-connected
        # components like scipy.ndimage.label)
        fg = (labels >= 0) & (labels != MUSCLE)
        labels = _relabel_small(
            labels, fg, exclude_classes=(MUSCLE,), min_size=min_component,
            self_votes=True, connectivity=4,
        )

    # 3. per-class tiny regions -> most common neighbour class, for bone,
    # muscles and fat (the reference's highlight_small_masks keys; lung
    # is deliberately not cleaned)
    out = labels
    for c in (0, 1, 3):
        # RETR_EXTERNAL quirk: only components visible to the reference's
        # external-contour scan are candidates
        fg = (out == c) & _external_mask(out == c)
        # the reference keeps the original class when no valid neighbours
        out = _relabel_small(
            out, fg, exclude_classes=(c,), min_size=tiny_area + 1,
            fallback=c, rect_quirk=True,
        )
    return out
