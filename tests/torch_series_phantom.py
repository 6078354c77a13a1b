"""Seeded CT phantoms for the port's series modes, numpy only.

Shared by ``chip_smoke.py``, ``tests/data/make_torch_series_fixture.py``
and the CPU parity tests, none of which may depend on the JAX package for
their inputs. Not collected by pytest.

``frontal_rib_phantom`` is a numpy copy of the default (not ``hard``)
branch of ``eitx.train.phantoms.frontal_rib_phantom``: the frontal view the
rib detector was trained on. ``thorax_hu`` is the plain branch of
``thorax_phantom_hu``: an axial thorax in Hounsfield units.

``series_volume`` builds a volume that serves both: every axial slice is a
thorax the tail can segment and mesh, and the middle frontal plane
(``vol[s, H // 2, :]``, one pixel row of every axial slice) is the rib
picture. That row is written as ``4 * g - 400`` HU, inside the body window
(-500, 1000): inside the body it stays body, outside it is one pixel thin
and the 5x5 opening of the body mask removes it. Written below -500 it
would cut the body in two.
"""

from __future__ import annotations

import io
import zipfile
from typing import Tuple

import numpy as np

HU = {"air": -1000.0, "lung": -780.0, "fat": -90.0, "muscle": 35.0,
      "bone": 350.0}


def _ellipse(xx, yy, cx, cy, rx, ry, rot=0.0):
    ca, sa = np.cos(rot), np.sin(rot)
    xr = (xx - cx) * ca + (yy - cy) * sa
    yr = -(xx - cx) * sa + (yy - cy) * ca
    return (xr / rx) ** 2 + (yr / ry) ** 2 < 1.0


def frontal_rib_phantom(rng: np.random.Generator, s: int = 640,
                        n_pairs: int = None) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic frontal (coronal) CT view with rib bands: a torso band, a
    bright spine column, darker lung fields and N rib pairs as tilted
    bright bands. Returns (image (s, s) uint8, boxes (2*N, 4) xyxy)."""
    if n_pairs is None:
        n_pairs = int(rng.integers(8, 11))
    img = rng.normal(18, 6.0, (s, s)).astype(np.float32)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    cx = s / 2 + rng.uniform(-s * 0.03, s * 0.03)
    half_w = s * rng.uniform(0.30, 0.38)
    torso = np.abs(xx - cx) < half_w
    img[torso] += 50 + rng.normal(0, 4, int(torso.sum()))
    for side in (-1, 1):  # lung fields either side of the spine
        lung = (np.abs(xx - (cx + side * half_w * 0.52)) < half_w * 0.42) & (
            yy > s * 0.12) & (yy < s * 0.75)
        img[lung] -= 28
    spine = np.abs(xx - cx) < s * rng.uniform(0.025, 0.04)
    img[spine] += 70
    boxes = []
    cy = s * rng.uniform(0.10, 0.16)
    pitch = s * rng.uniform(0.055, 0.075)
    for k in range(n_pairs):
        if k:
            cy += pitch
        if cy > s * 0.9:
            break
        for side in (-1, 1):
            bx = cx + side * half_w * rng.uniform(0.45, 0.62)
            tilt = side * rng.uniform(0.12, 0.3)
            rx = half_w * rng.uniform(0.30, 0.42)
            ry = s * rng.uniform(0.008, 0.014)
            band = _ellipse(xx, yy, bx, cy, rx, ry, tilt)
            img[band] += 85.0
            ys, xs = np.nonzero(band)
            if ys.size < 8:
                continue
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    img = np.clip(img, 0, 255)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-6) * 255.0
    return img.astype(np.uint8), np.asarray(boxes, np.float32).reshape(-1, 4)


def thorax_hu(rng: np.random.Generator, s: int = 256,
              breath: float = 1.0) -> np.ndarray:
    """Noise-free axial thorax in HU, (s, s) float32: fat ring, muscle,
    two lungs scaled by ``breath``, spine, sternum and a few ribs."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    cx = s / 2 + rng.uniform(-s * 0.02, s * 0.02)
    cy = s / 2 + rng.uniform(-s * 0.02, s * 0.02)
    rx, ry = s * rng.uniform(0.36, 0.40), s * rng.uniform(0.27, 0.30)
    hu = np.full((s, s), HU["air"], np.float32)
    body = _ellipse(xx, yy, cx, cy, rx, ry)
    hu[body] = HU["fat"]
    muscle = _ellipse(xx, yy, cx, cy, rx * 0.91, ry * 0.90)
    hu[muscle] = HU["muscle"]
    for side in (-1, 1):
        lung = _ellipse(xx, yy, cx + side * rx * 0.41, cy,
                        rx * 0.28 * breath, ry * 0.54 * breath, side * 0.1)
        hu[lung & muscle] = HU["lung"]
    hu[_ellipse(xx, yy, cx, cy + ry * 0.62, s * 0.045, s * 0.04) & body] = \
        HU["bone"]
    hu[_ellipse(xx, yy, cx, cy - ry * 0.78, s * 0.028, s * 0.016) & body] = \
        HU["bone"]
    for ang in rng.uniform(0, 2 * np.pi, 4):
        rib = _ellipse(xx, yy, cx + rx * 0.93 * np.cos(ang),
                       cy + ry * 0.93 * np.sin(ang), s * 0.015, s * 0.01, ang)
        hu[rib & body] = HU["bone"]
    return hu


def series_volume(seed: int, n_slices: int, size: int) -> np.ndarray:
    """(n_slices, size, size) int16 stored pixels (HU + 1024) of a thorax
    series whose middle frontal plane is a rib phantom.

    The rib picture is drawn at ``size`` x ``size`` and its first
    ``n_slices`` rows are used, so ``n_slices <= size``. Four axial
    templates with lungs of different sizes follow one another along the
    axis; every slice gets its own noise (sigma 12 HU)."""
    if n_slices > size:
        raise ValueError("series_volume draws at most `size` slices")
    rng = np.random.default_rng(seed)
    front, _ = frontal_rib_phantom(rng, size)
    shape_seed = int(rng.integers(1 << 30))
    templates = [thorax_hu(np.random.default_rng(shape_seed), size, breath)
                 for breath in (0.85, 0.95, 1.05, 0.95)]
    vol = np.empty((n_slices, size, size), np.int16)
    for lo in range(0, n_slices, 32):
        hi = min(lo + 32, n_slices)
        noise = rng.standard_normal((hi - lo, size, size), dtype=np.float32)
        base = np.stack([templates[s * 4 // n_slices] for s in range(lo, hi)])
        vol[lo:hi] = np.rint(base + 12.0 * noise + 1024.0).astype(np.int16)
    vol[:, size // 2, :] = 4 * front[:n_slices].astype(np.int16) - 400 + 1024
    return vol


def series_zip(vol: np.ndarray, write_dicom, custom_offset: int = None,
               series_uid: str = "1.2.826.0.1.3680043.2.77") -> io.BytesIO:
    """The volume as an in-memory zip of one DICOM file per slice (stored,
    not deflated), written with the given ``write_dicom``; optionally with
    a ``custom_input.txt`` that holds ``custom_offset``."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for i, px in enumerate(vol):
            zf.writestr(f"series/slice_{i:04d}.dcm",
                        write_dicom(px, series_uid=series_uid,
                                    instance_number=i + 1))
        if custom_offset is not None:
            zf.writestr("custom_input.txt", str(custom_offset))
    buf.seek(0)
    return buf
