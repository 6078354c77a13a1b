"""Independent scipy-sparse reference solver (copy of eitx/fem/oracle.py).

The golden-value oracle of the port's solvers: the reference relied on
pyeit, itself a scipy-sparse P1 FEM, and this reproduces that numerical
method in float64 on the host. ``chip_smoke.py`` holds the card's solves
against it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def assemble_sparse(nodes: np.ndarray, tris: np.ndarray, cond: np.ndarray):
    nodes = np.asarray(nodes, dtype=np.float64)
    tris = np.asarray(tris, dtype=np.int64)
    p = nodes[tris]
    x, y = p[..., 0], p[..., 1]
    roll1 = [1, 2, 0]
    roll2 = [2, 0, 1]
    b = y[:, roll1] - y[:, roll2]
    c = x[:, roll2] - x[:, roll1]
    area = 0.5 * np.abs(
        x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2]
    )
    ke = (b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]) / (
        4.0 * area[:, None, None]
    )
    vals = (cond[:, None, None] * ke).ravel()
    ii = np.repeat(tris, 3, axis=1).ravel()
    jj = np.tile(tris, (1, 3)).ravel()
    n = nodes.shape[0]
    return sp.csr_matrix((vals, (ii, jj)), shape=(n, n))


def forward_solve_oracle(
    nodes, tris, cond, el_pos, ex_mat, meas_mat, ref_node: int = 0
) -> np.ndarray:
    """Float64 sparse forward solve; returns (n_exc, n_meas)."""
    K = assemble_sparse(nodes, tris, np.asarray(cond, dtype=np.float64)).tolil()
    K[ref_node, :] = 0.0
    K[:, ref_node] = 0.0
    K[ref_node, ref_node] = 1.0
    K = K.tocsc()
    lu = spla.splu(K)
    n = nodes.shape[0]
    el_pos = np.asarray(el_pos)
    out = np.empty((ex_mat.shape[0], meas_mat.shape[1]), dtype=np.float64)
    for e, (a, b) in enumerate(np.asarray(ex_mat)):
        rhs = np.zeros(n)
        rhs[el_pos[a]] = 1.0
        rhs[el_pos[b]] = -1.0
        rhs[ref_node] = 0.0
        u = lu.solve(rhs)
        uel = u[el_pos]
        out[e] = uel[meas_mat[e, :, 0]] - uel[meas_mat[e, :, 1]]
    return out


def monitoring_oracle(nodes, tris, cond_frames, el_pos, ex_mat, meas_mat):
    """Per-frame loop over forward_solve_oracle (T, n_exc, n_meas)."""
    return np.stack(
        [
            forward_solve_oracle(nodes, tris, c, el_pos, ex_mat, meas_mat)
            for c in cond_frames
        ]
    )
