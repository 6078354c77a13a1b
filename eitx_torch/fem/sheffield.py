"""Sheffield-protocol FEMM-path measurement: electrode line integrals.

Port of eitx/fem/sheffield.py; the averaging matrix is built on the host
(a copy of the reference's), the solves run on the device with the frames
as the batch dimension.

The reference's legacy solver measures each electrode voltage as a contour
LINE INTEGRAL of the potential along the flat electrode segment
(femm.co_lineintegral(3) = average voltage over contour,
synthetic_datasets_generator.py:125-142), then takes neighbour differences
with per-projection wraparound (abs_to_diff, :144-162). Current drive per
projection idx is GND at electrode idx and INJ at (idx+1) % N
(calculate_EIT_projection_femm, :164-184).

Here the line integral becomes a precomputed averaging matrix W
(n_elec, n_nodes): each row holds arc-length-weighted P1 interpolation
weights for sample points along the electrode footprint, so measuring all
electrodes for all projections is one product. The same weights
distribute the injected current along the electrode (uniform current
density — the flat-electrode approximation FEMM's conductor constraint
converges to for thin electrodes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .admittance import _admittance_solve
from .protocol import abs_to_diff
from .solver import _index, _values

__all__ = [
    "abs_to_diff",
    "electrode_averaging_matrix",
    "sheffield_ex_mat",
    "sheffield_solve_admittance",
    "sheffield_monitoring",
]


def _point_in_tri_weights(p: np.ndarray, tri_xy: np.ndarray):
    """Barycentric weights of point p in triangle tri_xy (3, 2)."""
    a, b, c = tri_xy
    det = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])
    if abs(det) < 1e-30:
        return None
    l1 = ((b[0] - p[0]) * (c[1] - p[1]) - (c[0] - p[0]) * (b[1] - p[1])) / det
    l2 = ((c[0] - p[0]) * (a[1] - p[1]) - (a[0] - p[0]) * (c[1] - p[1])) / det
    l3 = 1.0 - l1 - l2
    return np.array([l1, l2, l3])


def electrode_averaging_matrix(
    nodes: np.ndarray,
    tris: np.ndarray,
    elecs: np.ndarray,
    samples: int = 9,
    tol: float = 1e-6,
) -> np.ndarray:
    """(n_elec, n_nodes) arc-average interpolation weights.

    For each electrode, ``samples`` points along the segment between its
    two edge points (elecs[i, 0] and elecs[i, 1]) are located in the mesh
    and their P1 shape-function weights are averaged (trapezoid rule along
    the arc = uniform weights for a straight segment). Rows sum to 1.

    Host-side precompute (runs once per mesh); the solve-time measurement
    is then W @ u.
    """
    nodes = np.asarray(nodes, np.float64)
    tris = np.asarray(tris, np.int64)
    n_elec = elecs.shape[0]
    W = np.zeros((n_elec, nodes.shape[0]))
    tri_xy = nodes[tris]  # (M, 3, 2)
    mins = tri_xy.min(axis=1)
    maxs = tri_xy.max(axis=1)
    for i in range(n_elec):
        p0, p1 = np.asarray(elecs[i, 0]), np.asarray(elecs[i, 1])
        ts = np.linspace(0.0, 1.0, samples)
        pts = p0[None] + ts[:, None] * (p1 - p0)[None]
        for p in pts:
            cand = np.where(
                (mins[:, 0] <= p[0] + tol) & (p[0] - tol <= maxs[:, 0])
                & (mins[:, 1] <= p[1] + tol) & (p[1] - tol <= maxs[:, 1])
            )[0]
            best_t, best_w, best_pen = -1, None, np.inf
            for t in cand:
                w = _point_in_tri_weights(p, tri_xy[t])
                if w is None:
                    continue
                pen = -min(w.min(), 0.0)  # how far outside the triangle
                if pen < best_pen:
                    best_pen, best_t, best_w = pen, t, w
                    if pen == 0.0:
                        break
            if best_t < 0:
                # point off the mesh hull: snap to the nearest node
                best_t = 0
                j = int(np.argmin(np.linalg.norm(nodes - p, axis=1)))
                W[i, j] += 1.0
                continue
            w = np.clip(best_w, 0.0, None)
            w = w / w.sum()
            W[i, tris[best_t]] += w
        W[i] /= W[i].sum()
    return W


def sheffield_ex_mat(n_elec: int) -> np.ndarray:
    """(n_proj, 2) [inj, gnd] pairs: projection idx drives (idx+1, idx)
    (calculate_EIT_projection_femm:164-184)."""
    idx = np.arange(n_elec)
    return np.stack([(idx + 1) % n_elec, idx], axis=1)


def sheffield_solve_admittance(
    nodes,
    tris,
    sigma_e,
    eps_r_e,
    freq_hz,
    W,
    current,
    n_nodes: int,
    ref_node: int = 0,
    device="cuda",
) -> torch.Tensor:
    """One float32 frame of the FEMM path: all projections, line-integral
    measure.

    Args:
      W: (n_elec, n_nodes) electrode averaging matrix; also used
        (transposed, scaled by ``current``) to spread the injected current
        along the electrode footprint.
    Returns:
      (n_proj, n_elec) ABSOLUTE electrode voltages (real part), one row per
      projection — feed through abs_to_diff for the reference's dataset
      rows.
    """
    dev, f32 = resolve_device(device), torch.float32
    return _sheffield_frames(
        nodes, tris, _values(sigma_e, f32, dev)[None],
        _values(eps_r_e, f32, dev)[None], freq_hz, _values(W, f32, dev),
        current, n_nodes, ref_node)[0]


def _sheffield_frames(nodes, tris, sigma_e, eps_r_e, freq_hz, W, current,
                      n_nodes, ref_node):
    """sigma_e, eps_r_e (T, M) -> (T, n_proj, n_elec) absolute voltages."""
    dev, dt = sigma_e.device, sigma_e.dtype
    T = sigma_e.shape[0]
    ex = _index(sheffield_ex_mat(W.shape[0]), dev)
    # B[:, p] = I * (w_inj - w_gnd): uniform current density along the
    # electrode arc
    B = _values(current, dt, dev) * (W[ex[:, 0]] - W[ex[:, 1]]).T
    u_re, _ = _admittance_solve(
        _values(nodes, dt, dev), _index(tris, dev), sigma_e, eps_r_e,
        _values(freq_hz, dt, dev).expand(T), B.expand(T, -1, -1),
        n_nodes, ref_node)
    return (W @ u_re).mT  # (T, n_proj, n_elec)


def sheffield_monitoring(
    nodes: np.ndarray,
    tris: np.ndarray,
    sigma_frames: np.ndarray,
    eps_frames: np.ndarray,
    freq_hz: float,
    elecs: np.ndarray,
    current: float = 0.005,
    samples: int = 9,
    device="cuda",
) -> np.ndarray:
    """FEMM-path monitoring: T frames -> (T, n_proj, n_elec) voltage
    DIFFERENCES (abs_to_diff applied per projection row), the layout the
    reference's simulate_EIT_femm fills into V (:260-284) — the T frames
    solve as one batch on ``device``.
    """
    dev = resolve_device(device)
    nodes = np.asarray(nodes)
    tris = np.asarray(tris, np.int64)
    # drop orphan nodes: their all-zero stiffness rows would make the
    # system singular (the pyeit path does the same via compact_mesh_nodes)
    used = np.unique(tris)
    if used.size != nodes.shape[0]:
        remap = np.full(nodes.shape[0], -1, np.int64)
        remap[used] = np.arange(used.size)
        nodes = nodes[used]
        tris = remap[tris]
    f32 = torch.float32
    W = _values(electrode_averaging_matrix(nodes, tris, elecs, samples=samples),
                f32, dev)
    v_abs = _sheffield_frames(
        nodes, tris, _values(sigma_frames, f32, dev),
        _values(eps_frames, f32, dev), freq_hz, W, current, nodes.shape[0], 0)
    return abs_to_diff(v_abs.cpu().numpy(), elecs.shape[0])
