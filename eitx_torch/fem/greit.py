"""GREIT reconstruction: a trained linear imaging matrix on the device.

Port of eitx/fem/greit.py: the Graz consensus Reconstruction algorithm
for EIT (Adler et al., "GREIT: a unified approach to 2D linear EIT
reconstruction of lung images", Physiol. Meas. 30 (2009) S35-S55).

GREIT *trains* a linear reconstruction matrix R offline so that R y_k
matches a desired blurred image x_k for a battery of simulated point
targets y_k; online, imaging is a single product:

    images (T, P, P)  =  reshape( dv (T, n_meas)  @  R^T )

  - Training measurements Y come from the adjoint Jacobian
    (inverse._difference_jacobian) with columns rescaled to equal-AREA
    targets.
  - Desired images are compact quadratic bumps max(0, 1 - (d/r)^2)
    rasterized on the pixel grid.
  - The train solve is one measurement-space Cholesky (208^2 for the
    16-electrode adjacent protocol).

The Jacobian, the rasterization, the containment mask and the solve run on
``device`` with TF32 off (the reference runs them at "highest"). The
pixel centres are formed on the host in float32 exactly as the reference
forms them, so the containment mask (an exact sign test) matches it.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..core.device import resolve_device
from .assembly import element_geometry
from .inverse import (
    _check_factored,
    _difference_jacobian,
    _factor,
    monitoring_linearization,
)
from .solver import _index, _values


def _fma_f32(a, b, c) -> np.float32:
    """float32 fused multiply-add a * b + c: the exact value, rounded once
    to the nearest float32 (ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))  # within one float32 step of exact
    best = near
    for g in (np.nextafter(near, np.float32(np.inf)),
              np.nextafter(near, np.float32(-np.inf))):
        d, d_best = (abs(Fraction(float(x)) - exact) for x in (g, best))
        if d < d_best or (d == d_best and not g.view(np.int32) & 1):
            best = g
    return best


def _pixel_centres(lo: float, hi: float, npx: int) -> np.ndarray:
    """(npx,) float32 pixel centres with a half-pixel inset, bit for bit as
    the reference forms them on the CPU: ``jnp.linspace(lo, hi, npx + 1)
    [:-1] + (hi - lo) / (2 * npx)`` with x64 off. The offset is computed in
    float64 and rounded once; linspace forms ``lo * (1 - s) + hi * s``,
    ``s = i / npx``, in float32, and XLA:CPU contracts that sum into one
    fused multiply-add of the product ``(hi / npx) * i`` -- except for
    ``i = 1`` in a loop it unrolls (npx <= 32), where that product is
    exact and the other one is fused. Reproduced for power-of-two ``npx``
    (GREIT's 32 among them); other sizes may differ from the reference in
    the last bit."""
    f32 = np.float32
    lo32, hi32 = f32(lo), f32(hi)
    line = []
    for i in range(npx):
        s = f32(i) / f32(npx)
        if i == 1 and npx <= 32:
            line.append(_fma_f32(lo32, f32(1.0) - s, hi32 * s))
        else:
            line.append(_fma_f32(hi32, s, lo32 * (f32(1.0) - s)))
    return np.array(line, f32) + f32((hi - lo) / (2 * npx))


def _pixel_grid(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(P^2, 2) pixel centres, row-major over (y, x)."""
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")  # (npx, npx)
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def _pixels_inside(nodes, tris, xs, ys, npx: int) -> torch.Tensor:
    """(npx, npx) bool: pixel centers covered by at least one element.

    Barycentric sign test against every element — (P^2, M, 3) ops."""
    p = nodes[tris]  # (M, 3, 2)
    q = _pixel_grid(xs, ys)  # (P^2, 2)
    a, b, c = p[:, 0], p[:, 1], p[:, 2]  # (M, 2)

    def cross(o, d, pt):  # sign of (d-o) x (pt-o): (P^2, M)
        return (d[:, 0] - o[:, 0]) * (pt[:, None, 1] - o[None, :, 1]) - (
            d[:, 1] - o[:, 1]
        ) * (pt[:, None, 0] - o[None, :, 0])

    s1, s2, s3 = cross(a, b, q), cross(b, c, q), cross(c, a, q)
    inside = ((s1 >= 0) & (s2 >= 0) & (s3 >= 0)) | (
        (s1 <= 0) & (s2 <= 0) & (s3 <= 0)
    )
    # degenerate (zero-area) padding elements have all-zero sign tests
    # and would otherwise claim every pixel
    _, area = element_geometry(nodes, tris)
    inside = inside & (area > 0)[None, :]
    return inside.any(dim=1).reshape(npx, npx)


def _equal_area_median(area: torch.Tensor, m_real=None) -> torch.Tensor:
    """Median of the first ``m_real`` (default: all) values of the
    descending sort of ``area``: the real elements, ahead of the zero-area
    padding. For an even count it averages the two middle values, as
    ``jnp.median`` does; ``torch.median`` returns the lower one."""
    m = area.shape[0] if m_real is None else min(int(m_real), area.shape[0])
    srt = torch.sort(area, descending=True).values
    return 0.5 * (srt[(m - 1) // 2] + srt[m // 2])


def _train_matrix(jac, cent, area, xs, ys, r_img, lam: float,
                  npx: int, m_real=None) -> torch.Tensor:
    """R (P^2, n_meas) from the target battery (one element = one target).

    ``m_real``: number of real (non-padding) elements — the equal-area
    median must ignore the zero-area padding tail or it collapses to 0.
    Padding columns are inert downstream: zero Jacobian -> zero Y -> zero
    W columns -> no contribution to R. ``r_img`` is the bump radius as a
    float32 scalar: its square is formed in float32, as in the reference.
    """
    del npx  # the grid's size is that of xs and ys
    # equal-area targets: rescale each Jacobian column from "this
    # element's area" to the median target area
    a0 = _equal_area_median(area, m_real)
    Y = jac * (a0 / area.clamp(min=1e-12))[None, :]  # (n_meas, M)
    # desired images: compact quadratic bump at each target centroid
    pix = _pixel_grid(xs, ys)  # (P^2, 2)
    d2 = ((pix[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    r2 = float(np.float32(r_img) * np.float32(r_img))
    X = torch.clamp(1.0 - d2 / r2, min=0.0)  # (P^2, M)
    L, info = _factor(Y, lam)
    _check_factored(info, "GREIT train solve")
    W = torch.cholesky_solve(Y, L)  # (n_meas, M)
    return X @ W.T  # (P^2, n_meas)


def _apply(R, mask, dv) -> torch.Tensor:
    flat = dv.reshape(-1, R.shape[1])
    img = flat @ R.T  # (T, P^2)
    npx = mask.shape[0]
    return img.reshape(*dv.shape[:-1], npx, npx) * mask


@dataclass
class GreitImager:
    """Trained GREIT matrix: per-frame reconstruction is one matvec."""

    R: torch.Tensor  # (npx*npx, n_meas_total), on the device it serves
    mask: np.ndarray  # (npx, npx) bool, pixels inside the meshed domain
    extent: tuple  # (xmin, xmax, ymin, ymax) of the pixel grid
    npx: int

    def reconstruct(self, dv) -> np.ndarray:
        """dv (..., n_meas_total) -> images (..., npx, npx); pixels
        outside the domain are zeroed. Positive values = conductivity
        INCREASE vs the reference frame (same sign as DifferenceImager)."""
        dev = self.R.device
        mask = torch.as_tensor(self.mask, device=dev).to(self.R.dtype)
        return _apply(self.R, mask,
                      _values(dv, torch.float32, dev)).cpu().numpy()

    def save(self, path: str) -> None:
        """Persist the trained matrix (npz, the reference's layout: a file
        written by either package loads in the other)."""
        np.savez(
            path, R=self.R.cpu().numpy(), mask=self.mask,
            extent=np.asarray(self.extent, np.float64),
            npx=np.int64(self.npx),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "GreitImager":
        dev = resolve_device(device)
        with np.load(path) as z:
            return cls(
                R=torch.as_tensor(z["R"], device=dev),
                mask=z["mask"].astype(bool),
                extent=tuple(float(v) for v in z["extent"]),
                npx=int(z["npx"]),
            )

    @classmethod
    def build(
        cls,
        nodes: np.ndarray,
        tris: np.ndarray,
        sigma_ref: np.ndarray,
        el_pos,
        ex_mat,
        meas_mat,
        npx: int = 32,
        blur: float = 0.12,
        lam: float = 0.05,
        ref_node: int = 0,
        pad_nodes_to: int = 1024,
        pad_elems_to: int = 8192,
        device="cuda",
    ) -> "GreitImager":
        """Train R around ``sigma_ref`` on this mesh, on ``device``.

        Args:
          npx: pixel-grid resolution (GREIT's canonical 32).
          blur: desired-image radius as a fraction of the domain's larger
            side (controls the trained point-spread width).
          lam: relative Tikhonov weight of the measurement-space solve
            (scaled by mean diag(Y Y^T), dimensionless); larger = smoother
            images and better noise rejection (GREIT's noise-figure knob).
          pad_nodes_to / pad_elems_to: the node and element counts are
            rounded up to these multiples (defaults match
            SimulationConfig), as the reference pads them; padding nodes
            are isolated, padding elements are zero-area triangles on
            node 0.
        """
        dev = resolve_device(device)
        nodes = np.asarray(nodes, np.float64)
        tris = np.asarray(tris, np.int64)
        sigma_ref = np.asarray(sigma_ref, np.float64)
        # real bbox before padding (padding nodes sit at the origin)
        xmin, ymin = nodes.min(0)
        xmax, ymax = nodes.max(0)
        n_real = nodes.shape[0]
        m_real = tris.shape[0]

        def _up(x, m):
            return ((x + m - 1) // m) * m

        n_pad = _up(n_real, max(pad_nodes_to, 1))
        m_pad = _up(tris.shape[0], max(pad_elems_to, 1))
        if n_pad > n_real:
            nodes = np.vstack([nodes, np.zeros((n_pad - n_real, 2))])
        if m_pad > tris.shape[0]:
            extra = m_pad - tris.shape[0]
            # degenerate zero-area elements on node 0: zero stiffness,
            # zero Jacobian column, zero-area (hence zero-weight) target
            tris = np.vstack([tris, np.zeros((extra, 3), np.int64)])
            sigma_ref = np.concatenate(
                [sigma_ref, np.zeros((extra,), np.float64)]
            )
        f32 = torch.float32
        nodes_t = _values(nodes, f32, dev)
        tris_t = _index(tris, dev)
        jac = _difference_jacobian(
            nodes_t, tris_t, _values(sigma_ref, f32, dev),
            _index(el_pos, dev), _index(ex_mat, dev), _index(meas_mat, dev),
            n_pad, ref_node, n_real=n_real,
        )
        _, area = element_geometry(nodes_t, tris_t)
        cent = nodes_t[tris_t].mean(dim=1)  # (M, 2)
        xs = torch.from_numpy(_pixel_centres(xmin, xmax, npx)).to(dev)
        ys = torch.from_numpy(_pixel_centres(ymin, ymax, npx)).to(dev)
        r_img = np.float32(blur * max(xmax - xmin, ymax - ymin))
        R = _train_matrix(jac, cent, area, xs, ys, r_img, lam, npx, m_real)
        mask = _pixels_inside(nodes_t, tris_t, xs, ys, npx).cpu().numpy()
        return cls(R=R, mask=mask, extent=(float(xmin), float(xmax),
                                           float(ymin), float(ymax)),
                   npx=npx)


def figures_of_merit(img: np.ndarray, imager: GreitImager,
                     target_xy) -> dict:
    """GREIT figures of merit for ONE reconstructed image of a small
    target (Adler et al. 2009, §Figures of merit), computed on the
    quarter-amplitude pixel set q = {img >= 0.25 max(img)}:

      ar  — amplitude response: sum of image values over q
      pe  — position error: |target center - centroid(q)|, in mesh units
      res — resolution: sqrt(area(q) / area(domain))
      sd  — shape deformation: fraction of q outside the equal-area
            circle centered on q's centroid
      rng — ringing: opposite-sign image mass just outside that circle,
            relative to the in-circle mass

    Host-side numpy analysis (32x32 images — not a device workload).
    """
    img = np.asarray(img, np.float64)
    mask = np.asarray(imager.mask)
    npx = imager.npx
    xmin, xmax, ymin, ymax = imager.extent
    px = xmin + (np.arange(npx) + 0.5) * (xmax - xmin) / npx
    py = ymin + (np.arange(npx) + 0.5) * (ymax - ymin) / npx
    gx, gy = np.meshgrid(px, py)
    pix_area = (xmax - xmin) / npx * (ymax - ymin) / npx

    peak = img.max()
    q = (img >= 0.25 * peak) & mask
    w = img * q
    tot = max(w.sum(), 1e-12)
    cx = (gx * w).sum() / tot
    cy = (gy * w).sum() / tot
    a_q = q.sum() * pix_area
    a_dom = mask.sum() * pix_area
    r_eq = np.sqrt(a_q / np.pi)  # equal-area circle radius
    d = np.hypot(gx - cx, gy - cy)
    inside_c = (d <= r_eq) & mask
    # ringing ring: just outside the equal-area circle (out to 2x radius)
    ring = (d > r_eq) & (d <= 2.0 * r_eq) & mask
    pos_mass = max(img[inside_c].clip(0).sum(), 1e-12)
    return {
        "ar": float(w.sum()),
        "pe": float(np.hypot(cx - target_xy[0], cy - target_xy[1])),
        "res": float(np.sqrt(a_q / a_dom)),
        "sd": float((q & ~inside_c).sum() / max(q.sum(), 1)),
        "rng": float((-img[ring]).clip(0).sum() / pos_mass),
    }


def greit_monitoring(
    mesh_data,
    v_frames: np.ndarray,
    classes=None,
    cfg=None,
    npx: int = 32,
    blur: float = 0.12,
    lam: float = 0.05,
    ref_frame: int = 0,
    device="cuda",
):
    """GREIT-image a whole monitoring produced by the forward pipeline.

    Mirrors inverse.reconstruct_monitoring but returns pixel-grid images:
      (images (T, npx, npx) numpy, imager)
    """
    info, sigma_ref, el, proto = monitoring_linearization(
        mesh_data, classes, cfg
    )
    imager = GreitImager.build(
        info.node, info.element, sigma_ref, el, proto.ex_mat, proto.meas_mat,
        npx=npx, blur=blur, lam=lam, device=device,
    )
    v = _values(v_frames, torch.float32, imager.R.device)
    dv = v - v[ref_frame][None]
    return imager.reconstruct(dv), imager
