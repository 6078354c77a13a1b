"""Connected components, largest component and hole fill on the device.

Port of eitx/image/cc.py (``label_components`` :50, ``largest_component``
:87, ``fill_holes`` :100). Labelling is one 3x3 label-propagation step
followed by two pointer-jumping steps per iteration, so it converges in
O(log diameter) iterations; the hole fill is a background flood from the
border that grows one 4-connected ring per step, O(diameter) steps. Each
``lax.while_loop`` of the reference becomes a Python loop that checks for
convergence every few steps (``core.fixpoint``). The ``*_batch`` forms
(the reference's ``jax.vmap``s, cc.py:136-138) run the same loop over a
leading batch axis with one convergence test for the whole batch: a
converged image is a fixpoint of the step, so further steps leave it as
it is.
"""

from __future__ import annotations

import torch

from ..core.device import to_device
from ..core.fixpoint import fixpoint
from .morphology import window_max, window_or


def _neighbor_max(
    lab: torch.Tensor, mask: torch.Tensor, connectivity: int = 8
) -> torch.Tensor:
    """Neighbourhood max of labels over foreground (8- or 4-connected).

    Labels are flat pixel indices below 2^24, exact in float32, so the
    window max runs as a float max-pool."""
    f = lab.to(torch.float32)
    if connectivity == 8:
        m = window_max(f, 3, 3)
    else:  # 4-connected: plus-shaped neighbourhood via two 1-D windows
        m = torch.maximum(window_max(f, 1, 3), window_max(f, 3, 1))
    return torch.where(mask, m.to(torch.int32), torch.full_like(lab, -1))


def _label(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int32 labels of each image; one
    fixpoint over the whole batch."""
    b, h, w = mask.shape
    if h * w >= 1 << 24:
        raise ValueError(f"image of {h}x{w} pixels is too large to label")
    flat_ids = torch.arange(h * w, dtype=torch.int32,
                            device=mask.device).reshape(1, h, w)
    lab = torch.where(mask, flat_ids, torch.full_like(flat_ids, -1))

    def jump(lab):
        # label <- label of my label's pixel (pointer doubling)
        flat = lab.reshape(b, h * w)
        j = torch.gather(flat, 1, torch.clamp(flat, min=0).to(torch.int64))
        j = torch.where(flat >= 0, j, torch.full_like(j, -1))
        return torch.maximum(flat, j).reshape(b, h, w)

    def step(lab):
        return jump(jump(_neighbor_max(lab, mask, connectivity)))

    return fixpoint(step, lab)


def _largest(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> the largest 8-connected component of each image."""
    b, h, w = mask.shape
    lab = _label(mask, 8)
    flat = lab.reshape(b, h * w)
    # one flat histogram over the batch, image k at offset k*h*w; integer
    # sums: the same in whatever order the device adds them
    offset = torch.arange(b, device=mask.device)[:, None] * (h * w)
    sizes = torch.zeros((b * h * w,), dtype=torch.int32,
                        device=mask.device).index_add_(
        0, (flat.clamp(min=0).to(torch.int64) + offset).reshape(-1),
        (flat >= 0).to(torch.int32).reshape(-1)).reshape(b, h * w)
    roots = torch.arange(h * w, dtype=torch.int32, device=mask.device)
    best = torch.where(sizes == sizes.max(dim=1, keepdim=True).values, roots,
                       torch.full_like(roots, h * w)).min(dim=1).values
    return lab == best[:, None, None]


def _batch(images, device) -> torch.Tensor:
    """(B, H, W) boolean masks on ``device``."""
    mask = to_device(images, device).to(torch.bool)
    if mask.dim() != 3:
        raise ValueError(f"expected (B, H, W) masks, got {tuple(mask.shape)}")
    return mask


def label_components(mask, connectivity: int = 8,
                     device="cuda") -> torch.Tensor:
    """(H, W) bool -> (H, W) int32 labels (-1 background).

    Labels are root flat-indices: two pixels share a component iff their
    labels match. 8-connectivity by default (cv2.findContours semantics);
    ``connectivity=4`` matches scipy.ndimage.label's default.
    """
    mask = to_device(mask, device).to(torch.bool)
    return _label(mask[None], connectivity)[0]


def label_components_batch(masks, connectivity: int = 8,
                           device="cuda") -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int32 labels, each image labelled as
    ``label_components`` labels it (``jax.vmap`` of it in the reference)."""
    return _label(_batch(masks, device), connectivity)


def largest_component(mask, device="cuda") -> torch.Tensor:
    """Keep only the largest 8-connected component of a boolean mask.

    Among components of equal size the one with the least root index
    stays, which is what the reference's ``jnp.argmax`` (first maximum)
    picks; ``torch.argmax`` promises no order among ties on CUDA, so the
    pick is written out. An empty mask gives an empty mask."""
    mask = to_device(mask, device).to(torch.bool)
    return _largest(mask[None])[0]


def largest_component_batch(masks, device="cuda") -> torch.Tensor:
    """(B, H, W) bool -> each image's largest component, as
    ``largest_component`` picks it."""
    return _largest(_batch(masks, device))


def border_mask(like: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool, True on the outermost rows and columns."""
    border = torch.zeros_like(like, dtype=torch.bool)
    border[..., 0, :] = True
    border[..., -1, :] = True
    border[..., :, 0] = True
    border[..., :, -1] = True
    return border


def background_from_border(fg: torch.Tensor) -> torch.Tensor:
    """Background pixels reachable from the image border, for (..., H, W)
    masks (one fixpoint over all of them).

    A 4-connected flood: the foreground is 8-connected, so by duality its
    holes are 4-connected background regions; an 8-connected grow would
    escape through diagonal gaps the outer boundary closes
    (cv2.drawContours-fill golden, tests/test_cv2_golden.py)."""
    bg = ~fg

    def grow4(x):
        return (window_or(x, 1, 3) | window_or(x, 3, 1)) & bg

    return fixpoint(grow4, bg & border_mask(fg))


def fill_holes(mask, device="cuda") -> torch.Tensor:
    """Fill interior holes: anything not reachable from the border through
    background becomes foreground (drawContours(..., FILLED) parity for
    the outer contour)."""
    mask = to_device(mask, device).to(torch.bool)
    return mask | ~background_from_border(mask)


def fill_holes_batch(masks, device="cuda") -> torch.Tensor:
    """(B, H, W) bool -> each image with its holes filled."""
    mask = _batch(masks, device)
    return mask | ~background_from_border(mask)
