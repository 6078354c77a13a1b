"""Injection and measurement operators shared by the forward solvers.

Port of ``_rhs_matrix`` / ``_measure`` (eitx/fem/solver.py:26-47). The
batched-Cholesky and CG solvers of that module are not ported yet
(ROADMAP, queue 1: "other solver families").
"""

from __future__ import annotations

import numpy as np
import torch


def _rhs_matrix(el_pos, ex_mat, n_nodes: int, dtype, device) -> torch.Tensor:
    """(N, n_exc) current injection vectors: +1 at node el_pos[a], -1 at
    el_pos[b] (pyeit natural-boundary convention). Built on the host: it
    is tiny, and building it there keeps it free of device atomics."""
    el_pos = np.asarray(el_pos)
    ex_mat = np.asarray(ex_mat)
    n_exc = ex_mat.shape[0]
    B = np.zeros((n_nodes, n_exc), dtype=np.float64)
    cols = np.arange(n_exc)
    np.add.at(B, (el_pos[ex_mat[:, 0]], cols), 1.0)
    np.add.at(B, (el_pos[ex_mat[:, 1]], cols), -1.0)
    return torch.as_tensor(B, dtype=dtype, device=device)


def _measure(u_el: torch.Tensor, meas_mat: torch.Tensor) -> torch.Tensor:
    """u_el (E, n_exc) electrode potentials -> (n_exc, n_meas) differences
    v = u[n] - u[m] for meas_mat (n_exc, n_meas, 2)=[n, m]."""
    u = u_el.T  # (n_exc, E)
    vn = torch.gather(u, 1, meas_mat[:, :, 0])
    vm = torch.gather(u, 1, meas_mat[:, :, 1])
    return vn - vm
