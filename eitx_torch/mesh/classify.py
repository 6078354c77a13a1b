"""Device-side triangle -> tissue classification.

Port of eitx/mesh/classify.py. The whole classification is a handful of
tensor operations on the device:

  - contours are padded to a (C, P, 2) tensor (repeating the last vertex —
    zero-length edges contribute nothing to a crossing test),
  - each triangle is sampled at its centroid plus a fixed barycentric
    pattern (S points),
  - an (M*S, C) even-odd containment matrix comes from
    ``mesh.pip.points_in_polys`` (the hand-written CUDA kernel for CUDA
    tensors, its plain PyTorch version for CPU tensors), giving
    per-contour coverage fractions,

and the reference's decision rule is applied branch-free:
  1. smallest-area contour containing the centroid, else
  2. smallest-area contour covering > 0.5 of the triangle, else
  3. contour with the largest (non-zero) coverage, else
  4. the outer-contour class.
Contours whose class equals the outer class are excluded (reference :169).
skin_width == -1 marks triangles touching the outer boundary as class 4
(reference :153-160).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .pip import points_in_polys


def _barycentric_samples(n: int) -> np.ndarray:
    """Fixed low-discrepancy barycentric sample pattern, centroid first."""
    base = [
        (1 / 3, 1 / 3, 1 / 3),
        (0.6, 0.2, 0.2),
        (0.2, 0.6, 0.2),
        (0.2, 0.2, 0.6),
        (0.5, 0.4, 0.1),
        (0.1, 0.5, 0.4),
        (0.4, 0.1, 0.5),
        (0.45, 0.45, 0.1),
        (0.1, 0.45, 0.45),
        (0.45, 0.1, 0.45),
        (0.8, 0.1, 0.1),
        (0.1, 0.8, 0.1),
        (0.1, 0.1, 0.8),
    ]
    reps = -(-n // len(base))
    return np.array((base * reps)[:n], dtype=np.float64)


def pad_contours(
    contours: Sequence[Tuple[int, np.ndarray]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(class_ids (C,), polys (C, P, 2), areas (C,)) padded by repeating the
    final vertex; classes sorted by area ascending (reference sorts
    contours by area so smaller regions win ties, femm_generator.py:60)."""
    from ..geometry.polygon import polygon_area

    if not contours:
        return (
            np.zeros((0,), np.int32),
            np.zeros((0, 4, 2), np.float64),
            np.zeros((0,), np.float64),
        )
    areas = np.array([polygon_area(p) for _, p in contours])
    order = np.argsort(areas, kind="stable")
    max_p = max(p.shape[0] for _, p in contours)
    C = len(contours)
    polys = np.zeros((C, max_p, 2), dtype=np.float64)
    cids = np.zeros((C,), dtype=np.int32)
    for k, idx in enumerate(order):
        cid, p = contours[idx]
        polys[k, : p.shape[0]] = p
        polys[k, p.shape[0] :] = p[-1]
        cids[k] = cid
    return cids, polys, areas[order]


def _sample_points(verts: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """(M, 3, 2) vertices x (S, 3) barycentric weights -> (M, S, 2),
    summed in vertex order 0, 1, 2."""
    w = bary[None, :, :, None]  # (1, S, 3, 1)
    v = verts[:, None, :, :]  # (M, 1, 3, 2)
    return (w[:, :, 0] * v[:, :, 0] + w[:, :, 1] * v[:, :, 1]) + (
        w[:, :, 2] * v[:, :, 2])


def _min_dist_to_ring(points: torch.Tensor, ring: torch.Tensor) -> torch.Tensor:
    """(Q, 2) points -> min distance to the ring's segments."""
    a = ring
    b = torch.roll(ring, -1, dims=0)
    v = b - a
    L2 = torch.clamp((v**2).sum(-1), min=1e-30)
    w = points[:, None, :] - a[None]
    t = torch.clamp((w * v[None]).sum(-1) / L2[None], 0.0, 1.0)
    proj = a[None] + t[..., None] * v[None]
    return torch.sqrt(((points[:, None, :] - proj) ** 2).sum(-1)).min(dim=1).values


def _classify_kernel(verts, bary, polys, cids, outer_class: int):
    """Sample -> containment -> decision rule.

    verts (M, 3, 2), bary (S, 3), polys (C, P, 2), cids (C,) int32.
    Returns (M,) int32 class ids.
    """
    M = verts.shape[0]
    samples = _sample_points(verts, bary)  # (M, S, 2)
    S = samples.shape[1]
    inside = points_in_polys(samples.reshape(-1, 2).contiguous(), polys)
    inside = inside.reshape(M, S, -1)  # (M, S, C)
    frac = inside.to(torch.float32).mean(dim=1)
    centroid_in = inside[:, 0, :]  # first sample is the centroid

    C = frac.shape[1]
    idxs = torch.arange(C, device=verts.device)
    big = C + 1
    bigs = torch.full_like(idxs, big)
    # rule 1: smallest-area contour containing the centroid
    first_cent = torch.where(centroid_in, idxs, bigs).min(dim=1).values
    # rule 2: smallest-area contour covering > 0.5
    first_half = torch.where(frac > 0.5, idxs, bigs).min(dim=1).values
    # rule 3: max coverage (if any); argmax takes the first of ties
    best_frac = frac.argmax(dim=1)
    has_any = frac.max(dim=1).values > 0
    choice = torch.where(
        first_cent < big,
        first_cent,
        torch.where(
            first_half < big,
            first_half,
            torch.where(has_any, best_frac, torch.full_like(best_frac, big)),
        ),
    )
    # choice == big clamps to a valid index here and is then discarded,
    # as the reference's clipped gather does
    return torch.where(
        choice < big,
        cids[torch.clamp(choice, 0, C - 1)],
        torch.full_like(choice, outer_class).to(cids.dtype),
    )


def _boundary_touch_kernel(verts, ring, eps: float):
    """(M, 3, 2) vertices -> (M,) bool: any vertex within eps of the ring."""
    M = verts.shape[0]
    d = _min_dist_to_ring(verts.reshape(-1, 2), ring).reshape(M, 3)
    return (d < eps).any(dim=1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_up_pow2(x: int, base: int) -> int:
    """Smallest base * 2^k >= x — geometric shape buckets, kept from the
    reference so the kernel sees the same padded shapes."""
    out = base
    while out < x:
        out *= 2
    return out


def classify_triangles(
    nodes: np.ndarray,
    tris: np.ndarray,
    contours: List[Tuple[int, np.ndarray]],
    outer_class: int,
    outer_poly: np.ndarray,
    skin_width: float = 1.0,
    n_samples: int = 8,
    boundary_eps: float = 1e-6,
    bucket_tris: int = 2048,
    bucket_contours: int = 4,
    bucket_points: int = 64,
    device="cuda",
) -> np.ndarray:
    """Per-element class ids (M,) int32.

    Triangle count, contour count and contour point count are padded up
    to the reference's buckets. Padding triangles are discarded; padding
    contours are degenerate and placed far outside the scene.
    """
    dev = resolve_device(device)
    nodes_np = np.asarray(nodes, dtype=np.float64)
    tris_np = np.asarray(tris)
    M = int(tris_np.shape[0])
    M_pad = _round_up(max(M, 1), bucket_tris)
    if M_pad > M:
        tris_np = np.vstack([tris_np, np.tile(tris_np[:1], (M_pad - M, 1))])
    nodes_t = torch.as_tensor(nodes_np, dtype=torch.float32, device=dev)
    verts = nodes_t[torch.as_tensor(tris_np, dtype=torch.int64, device=dev)]

    inner = [(cid, p) for cid, p in contours if int(cid) != int(outer_class)]
    if not inner:
        cls = np.full((M,), outer_class, dtype=np.int32)
    else:
        cids, polys, _ = pad_contours(inner)
        C, P = polys.shape[0], polys.shape[1]
        C_pad = _round_up_pow2(C, bucket_contours)
        P_pad = _round_up_pow2(P, bucket_points)
        if P_pad > P:
            polys = np.concatenate(
                [polys, np.repeat(polys[:, -1:], P_pad - P, axis=1)], axis=1
            )
        if C_pad > C:
            far = np.full((C_pad - C, P_pad, 2), -1e7)
            polys = np.concatenate([polys, far], axis=0)
            cids = np.concatenate(
                [cids, np.full((C_pad - C,), outer_class, np.int32)]
            )
        bary = torch.as_tensor(
            _barycentric_samples(n_samples), dtype=torch.float32, device=dev)
        cls_t = _classify_kernel(
            verts,
            bary,
            torch.as_tensor(polys, dtype=torch.float32, device=dev),
            torch.as_tensor(cids, dtype=torch.int32, device=dev),
            int(outer_class),
        )
        cls = cls_t.cpu().numpy().astype(np.int32)[:M]

    if skin_width == -1 and outer_poly is not None and len(outer_poly) >= 3:
        ring = np.asarray(outer_poly, dtype=np.float64)
        R = ring.shape[0]
        R_pad = _round_up_pow2(R, bucket_points)
        if R_pad > R:
            ring = np.vstack([ring, np.tile(ring[-1:], (R_pad - R, 1))])
        touching = _boundary_touch_kernel(
            verts,
            torch.as_tensor(ring, dtype=torch.float32, device=dev),
            float(np.float32(max(boundary_eps, 1e-3))),
        ).cpu().numpy()[:M]
        cls = np.where(touching, np.int32(4), cls)
    return cls
