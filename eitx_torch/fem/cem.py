"""Complete electrode model (CEM) forward solver.

Port of eitx/fem/cem.py. The CEM models finite-width electrodes with
contact impedance z (Somersalo, Cheney & Isaacson 1992). Augmented
symmetric system over (node potentials u, electrode potentials U):

    [ K + B   W ] [u]   [0]
    [ W^T     D ] [U] = [I]

  B_ij = sum_e (1/z_e) int_{Gamma_e} phi_i phi_j ds   (edge mass matrices)
  W_ie = -(1/z_e)      int_{Gamma_e} phi_i ds
  D_ee = |Gamma_e| / z_e
  I_e  = injected current per electrode (sum zero)

The tissue part K keeps its per-class linearity and B/W/D do not depend
on conductivity, so breathing monitoring stays a one-parameter pencil:
the batched Cholesky and the low-rank spectral machinery run on the
augmented matrices (electrode rows ride along as extra "nodes").
Grounding: the last electrode's potential is fixed by row substitution.
The boundary blocks are built on the host in float64 and uploaded once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .assembly import ClassStiffness
from .electrodes import _orient_ccw, boundary_loop
from .solver import _index, _measure, _values
from .spectral import LowRankSpectralSolver


@dataclass
class CEMSystem:
    """Augmented per-class stiffness for the CEM.

    k_class: (C, N+E, N+E) tissue matrices (zero in electrode rows)
    fixed:   (N+E, N+E) conductivity-independent part (B, W, D, grounding)
    n_nodes: N (real FEM nodes); n_el: E
    """

    k_class: torch.Tensor
    fixed: torch.Tensor
    n_nodes: int
    n_el: int

    @property
    def dim(self) -> int:
        return self.n_nodes + self.n_el


def electrode_arcs(
    nodes: np.ndarray,
    tris: np.ndarray,
    n_electrodes: int = 16,
    coverage: float = 0.5,
    starting_angle: float = np.pi,
):
    """Boundary edges covered by each electrode.

    Electrodes are arcs of length coverage * spacing, centred at equal
    arc-length intervals starting near ``starting_angle``. Returns a list
    of (edge node pairs (k, 2) int, edge lengths (k,)) per electrode.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    loop = _orient_ccw(nodes, boundary_loop(tris, nodes))
    pts = nodes[loop]
    centroid = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - centroid[1], pts[:, 0] - centroid[0])
    start_i = int(np.argmin(np.abs(np.angle(np.exp(1j * (ang - starting_angle))))))
    loop = np.roll(loop, -start_i)
    pts = nodes[loop]
    m = len(loop)
    seg_len = np.linalg.norm(pts[(np.arange(m) + 1) % m] - pts, axis=1)
    # arc-length position of each edge midpoint
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    perim = cum[-1]
    mid = (cum[:-1] + cum[1:]) / 2.0
    spacing = perim / n_electrodes
    half_w = 0.5 * coverage * spacing
    arcs = []
    for e in range(n_electrodes):
        center = e * spacing
        d = np.abs((mid - center + perim / 2) % perim - perim / 2)
        sel = np.where(d <= half_w)[0]
        if sel.size == 0:
            sel = np.array([int(np.argmin(d))])
        pairs = np.stack([loop[sel], loop[(sel + 1) % m]], axis=1)
        arcs.append((pairs, seg_len[sel]))
    return arcs


def _cem_fixed(n: int, arcs, z_contact: float) -> np.ndarray:
    """The (N+E, N+E) float64 boundary blocks, last electrode grounded."""
    E = len(arcs)
    dim = n + E
    fixed = np.zeros((dim, dim), dtype=np.float64)
    for e, (pairs, lens) in enumerate(arcs):
        inv_z = 1.0 / z_contact
        for (a, b), L in zip(pairs, lens):
            # edge mass L/6 [[2,1],[1,2]]
            fixed[a, a] += inv_z * L / 3.0
            fixed[b, b] += inv_z * L / 3.0
            fixed[a, b] += inv_z * L / 6.0
            fixed[b, a] += inv_z * L / 6.0
            # coupling -1/z int phi ds = -L/(2z)
            fixed[a, n + e] -= inv_z * L / 2.0
            fixed[n + e, a] -= inv_z * L / 2.0
            fixed[b, n + e] -= inv_z * L / 2.0
            fixed[n + e, b] -= inv_z * L / 2.0
        fixed[n + e, n + e] += inv_z * float(lens.sum())
    # ground the joint constant nullspace through the LAST electrode's
    # potential (U_{E-1} = 0): the resulting matrix is SPD.
    gnd = dim - 1
    fixed[gnd, :] = 0.0
    fixed[:, gnd] = 0.0
    fixed[gnd, gnd] = 1.0
    return fixed


def build_cem_system(
    cs: ClassStiffness,
    nodes: np.ndarray,
    tris: np.ndarray,
    n_electrodes: int = 16,
    z_contact: float = 1e-2,
    coverage: float = 0.5,
    starting_angle: float = np.pi,
    dtype=torch.float32,
) -> CEMSystem:
    """Augment per-class stiffness with CEM boundary blocks, on ``cs``'s
    device.

    ``cs`` must be built WITHOUT node padding (pad_nodes_to=1) and WITHOUT
    the interior reference-node grounding (ground_ref=False) — the CEM
    fixes the gauge through the last electrode's potential instead, and
    pinning an interior node too would over-constrain the system.
    """
    n = int(cs.n_real_nodes)
    if cs.n_nodes != n:
        raise ValueError("build ClassStiffness with pad_nodes_to=1 for CEM")
    arcs = electrode_arcs(nodes, tris, n_electrodes, coverage, starting_angle)
    fixed = _cem_fixed(n, arcs, z_contact)
    return CEMSystem(
        k_class=F.pad(cs.k_class.to(dtype), (0, n_electrodes, 0, n_electrodes)),
        fixed=torch.as_tensor(fixed, dtype=dtype, device=cs.k_class.device),
        n_nodes=n,
        n_el=n_electrodes,
    )


def _currents(ex_mat, n_el: int, current: float) -> np.ndarray:
    """(n_exc, E): +current into electrode a, -current out of b."""
    ex = np.asarray(ex_mat)
    currents = np.zeros((ex.shape[0], n_el), dtype=np.float64)
    for i, (a, b) in enumerate(ex):
        currents[i, a] = current
        currents[i, b] = -current
    return currents


def forward_solve_cem(
    system: CEMSystem,
    sigma,
    ex_mat: np.ndarray,
    meas_mat: np.ndarray,
    current: float = 1.0,
) -> torch.Tensor:
    """Batched CEM forward solve.

    sigma (T, C) per-class conductivities; ex_mat rows [a, b] drive
    +current into electrode a and -current out of b. Returns
    (T, n_exc, n_meas) electrode-voltage differences.
    """
    dev, dt = system.k_class.device, system.k_class.dtype
    n, dim = system.n_nodes, system.dim
    B = torch.zeros((dim, np.asarray(ex_mat).shape[0]), dtype=dt, device=dev)
    B[n:, :] = _values(_currents(ex_mat, system.n_el, current).T, dt, dev)
    B[dim - 1, :] = 0.0  # grounded electrode row
    K = torch.tensordot(_values(sigma, dt, dev), system.k_class,
                        dims=([1], [0])) + system.fixed[None]
    L = torch.linalg.cholesky(K)
    U = torch.cholesky_solve(B.expand(K.shape[0], -1, -1), L)
    U = U + torch.cholesky_solve(B - K @ U, L)
    return _measure(U[:, n:, :], _index(meas_mat, dev))


def spectral_cem_solver(
    system: CEMSystem,
    sigma_base: np.ndarray,
    lung_class: int,
    ex_mat: np.ndarray,
    meas_mat: np.ndarray,
    alpha0: float,
    current: float = 1.0,
    rank_bucket: int = 256,
):
    """Low-rank spectral factorization of the CEM system: the lung block
    keeps its small node support inside the augmented matrix, so the
    lung-subspace Woodbury setup applies unchanged."""
    dim, n = system.dim, system.n_nodes
    rhs = np.zeros((dim, np.asarray(ex_mat).shape[0]), dtype=np.float64)
    rhs[n:, :] = _currents(ex_mat, system.n_el, current).T
    rhs[dim - 1, :] = 0.0  # grounded electrode row
    return LowRankSpectralSolver.build_general(
        system.k_class,
        system.fixed,
        sigma_base,
        lung_class,
        _values(rhs, system.k_class.dtype, system.k_class.device),
        np.arange(n, dim),
        meas_mat,
        alpha0,
        rank_bucket=rank_bucket,
    )
