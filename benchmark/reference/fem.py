"""Plain float64 reference of one subject's EIT monitoring, numpy and scipy.

The same semantics as the measured simulation, worked out again from the
configuration and the mesh: tissue conductivities at the drive frequency
from the configuration's material data (Gabriel's Cole-Cole model for
muscle and fat sampled on the configuration's grid, the tables for lung,
skin and bone, log-frequency interpolation), the breathing schedule (a
sine spirometry scaled by 1.5 and mapped linearly onto the lung's deflated
and inflated conductivities), the unused nodes dropped, 16 point electrodes
equally spaced by arc length along the boundary from the node nearest the
starting angle, P1 stiffness assembly, node 0 grounded, and one sparse LU
solve a frame with the adjacent drive and the ``std`` measurement pattern.
Nothing is padded or low-ranked: every frame solves its own system.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import splu

EPS0 = 8.8541878128e-12


def _table_value(rows, freq: float, sentinel: float) -> float:
    """Log-frequency linear interpolation of [[f, value], ...] rows,
    skipping the sentinel."""
    d = np.asarray(rows, np.float64)
    d = d[d[:, 1] != sentinel]
    return float(np.interp(np.log10(freq), np.log10(d[:, 0]), d[:, 1]))


def _cole_cole_sigma(p: dict, freqs: np.ndarray) -> np.ndarray:
    w = 2.0 * np.pi * freqs
    eps = np.full(freqs.shape, p["eps_inf"], np.complex128)
    for d_eps, tau, alpha in p["terms"]:
        eps = eps + d_eps / (1.0 + (1j * w * tau) ** (1.0 - alpha))
    eps = eps + p["sigma_i"] / (1j * w * EPS0)
    return -w * EPS0 * eps.imag


def conductivities(materials: dict, freq: float) -> dict:
    """{tissue: S/m} at ``freq``, and the lung's inflated value as
    ``lung_inflated``."""
    g = materials["grid"]
    n = int(round(math.log10(g["f_max"] / g["f_min"])
                  * g["points_per_decade"])) + 1
    freqs = np.logspace(math.log10(g["f_min"]), math.log10(g["f_max"]), n)
    sentinel = materials["unknown_sentinel"]
    out = {}
    for name, p in materials["cole_cole"].items():
        out[name] = _table_value(
            np.stack([freqs, _cole_cole_sigma(p, freqs)], 1), freq, sentinel)
    tf = materials["table_freqs"]
    for name, rows in materials["tables"].items():
        out[name] = _table_value(np.stack([tf, rows], 1), freq, sentinel)
    return out


def lung_schedule(sim: dict, cond: dict) -> np.ndarray:
    """(n_points,) lung conductivity over one breathing cycle."""
    t = np.linspace(0.0, 60.0 / sim["n_spir"], sim["n_points"])
    x = 0.5 * np.sin(2.0 * math.pi * (sim["n_spir"] / 60.0) * t
                     + math.radians(270)) + 0.5
    sp_ = x * sim["volume_scale"]
    amp = (cond["lung"] - cond["lung_inflated"]) / (sp_.max() - sp_.min())
    return (-x + sp_.max()) * amp + cond["lung_inflated"]


def _boundary_loop(tris: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """The boundary's nodes in counter-clockwise order (one loop)."""
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    key = np.sort(e, axis=1)
    uniq, counts = np.unique(key, axis=0, return_counts=True)
    edges = uniq[counts == 1]
    nbr = {}
    for a, b in edges:
        nbr.setdefault(int(a), []).append(int(b))
        nbr.setdefault(int(b), []).append(int(a))
    if any(len(v) != 2 for v in nbr.values()):
        raise ValueError("the reference walks one manifold boundary only")
    start = int(edges[0, 0])
    loop, prev, cur = [start], None, start
    while True:
        a, b = nbr[cur]
        nxt = b if a == prev else a
        if nxt == start:
            break
        loop.append(nxt)
        prev, cur = cur, nxt
    if len(loop) != len(nbr):
        raise ValueError("more than one boundary loop")
    loop = np.asarray(loop)
    x, y = nodes[loop, 0], nodes[loop, 1]
    if np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)) < 0:
        loop = loop[::-1]
    return loop


def electrodes(nodes, tris, n_el: int, start_deg: float) -> np.ndarray:
    """Electrode nodes: equal arc-length spacing from the boundary node
    whose angle about the boundary's centroid is nearest ``start_deg``."""
    loop = _boundary_loop(tris, nodes)
    p = nodes[loop]
    c = p.mean(axis=0)
    ang = np.arctan2(p[:, 1] - c[1], p[:, 0] - c[0])
    gap = np.abs(np.angle(np.exp(1j * (ang - math.radians(start_deg)))))
    loop = np.roll(loop, -int(np.argmin(gap)))
    p = nodes[loop]
    seg = np.linalg.norm(np.diff(np.vstack([p, p[:1]]), axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    per = seg.sum()
    out = [int(loop[np.argmin(np.abs(arc - (k * per / n_el) % per))])
           for k in range(n_el)]
    if len(set(out)) != n_el:
        raise ValueError("electrodes collide")
    return np.asarray(out)


def adjacent_protocol(n_el: int):
    """(excitations [(a, b)], measurements [[(n, m), ...] per excitation]):
    drive a -> a + 1, read u[m + 1] - u[m] on pairs away from a and b."""
    ex = [(a, (a + 1) % n_el) for a in range(n_el)]
    meas = []
    for a, b in ex:
        rows = []
        for m in range(n_el):
            n = (m + 1) % n_el
            if {m, n}.isdisjoint({a, b}):
                rows.append((n, m))
        meas.append(rows)
    return ex, meas


def _class_matrices(nodes, tris, cls, n_classes):
    """Sparse P1 stiffness of each class at unit conductivity."""
    p = nodes[tris]
    x, y = p[..., 0], p[..., 1]
    b = np.roll(y, -1, 1) - np.roll(y, 1, 1)
    c = np.roll(x, 1, 1) - np.roll(x, -1, 1)
    area = 0.5 * np.abs((x * b).sum(1))
    ke = (b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]) / (
        4.0 * area[:, None, None])
    n = nodes.shape[0]
    ii = np.repeat(tris, 3, axis=1).ravel()
    jj = np.tile(tris, (1, 3)).ravel()
    out = []
    for k in range(n_classes):
        w = (cls == k).astype(np.float64)[:, None, None] * ke
        out.append(sp.csc_matrix((w.ravel(), (ii, jj)), shape=(n, n)))
    return out


def simulate(mesh: dict, sim: dict, materials: dict, class_names: dict,
             frames=None):
    """(len(frames), n_exc * n_meas) voltages of ``mesh`` in float64 at
    the breathing cycle's ``frames`` (all ``n_points`` by default)."""
    tris = np.asarray(mesh["TRIANGLES"], np.int64)
    used, inv = np.unique(tris, return_inverse=True)
    nodes = np.asarray(mesh["NODES"], np.float64)[used]
    tris = inv.reshape(tris.shape)
    cls = np.asarray(mesh["CLASS"], np.int64)
    cond = conductivities(materials, sim["frequency_hz"])
    lung = lung_schedule(sim, cond)
    if frames is not None:
        lung = lung[np.asarray(frames)]
    ids = {name: int(k) for k, name in class_names.items()}
    mats = _class_matrices(nodes, tris, cls, len(ids))
    fixed = sum(cond[name] * mats[k] for name, k in ids.items()
                if name != "lung")
    k_lung = mats[ids["lung"]]
    el = electrodes(nodes, tris, sim["n_electrodes"],
                    sim["starting_angle_deg"])
    ex, meas = adjacent_protocol(sim["n_electrodes"])
    n = nodes.shape[0]
    rhs = np.zeros((n, len(ex)))
    for j, (a, b) in enumerate(ex):
        rhs[el[a], j] += 1.0
        rhs[el[b], j] -= 1.0
    keep = np.arange(1, n)  # node 0 grounded
    nn = np.array([[el[q] for q, _ in rows] for rows in meas])
    mm = np.array([[el[q] for _, q in rows] for rows in meas])
    cols = np.arange(len(ex))[:, None]
    out = np.empty((lung.shape[0], nn.size))
    fixed = fixed.tocsc()[keep][:, keep]
    k_lung = k_lung.tocsc()[keep][:, keep]
    for t, a in enumerate(lung):
        u = np.zeros((n, len(ex)))
        lu = splu((fixed + a * k_lung).tocsc(), permc_spec="MMD_AT_PLUS_A",
                  options={"SymmetricMode": True})
        u[1:] = lu.solve(rhs[1:])
        out[t] = (u[nn, cols] - u[mm, cols]).ravel()
    return out
