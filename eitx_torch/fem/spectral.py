"""Low-rank (lung-subspace) spectral monitoring solver.

Port of ``LowRankSpectralSolver`` (eitx/fem/spectral.py:234-581). The
setup is one N x N Cholesky, two multi-RHS triangular solves, one r x r
Cholesky and one r x r ``eigh``; each breathing frame is one row of a
(T, r) x (r, n_exc * n_meas) product. These run as ``torch.linalg``
library calls, as the JAX package leaves them to XLA. All of it runs in
full float32: the reference pins ``"highest"`` matmul precision
(spectral.py:484), so TF32 is switched off around the setup and the solve
(``core.device.full_f32``).

Compare voltages, never eigenvectors: the sign and order of an ``eigh``
basis differ between libraries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import full_f32
from .assembly import ClassStiffness
from .solver import _measure, _rhs_matrix


@dataclass
class LowRankSpectralSolver:
    """Monitoring solver factoring the pencil on the LUNG SUBSPACE only.

    Breathing perturbs K on lung-element nodes alone, so with S selecting
    the r lung nodes (padded to the rank bucket) and K_base = L L^T,

        K(a)^-1 = L^-T (I - Q diag(f(a)) Q^T) L^-1,
        f(a) = (a-a0) s2 / (1 + (a-a0) s2),

    where Q diag(s2) Q^T is the eigendecomposition of the lung block in
    L's frame (see ``_lowrank_core``). A frame costs one (E*n_exc, r)
    product against f(a).
    """

    s2: torch.Tensor  # (r,) eigenvalues of the lung block (0 in dead slots)
    u0: torch.Tensor  # (E, n_exc) baseline electrode potentials at alpha0
    yq: torch.Tensor  # (r, n_exc)
    zq: torch.Tensor  # (E, r)
    alpha0: float
    meas_mat: torch.Tensor

    @classmethod
    def build(
        cls,
        cs: ClassStiffness,
        sigma_base: np.ndarray,
        lung_class: int,
        el_pos,
        ex_mat,
        meas_mat,
        alpha0: float,
        rank_bucket: int = 256,
    ) -> "LowRankSpectralSolver":
        dev, dt = cs.k_class.device, cs.k_class.dtype
        idx, mask = _lung_subspace_indices(cs, lung_class, rank_bucket)
        with full_f32():
            s2, u0, yq, zq = _lowrank_setup(
                cs.k_class,
                cs.diag_fix,
                cs.ref_node,
                torch.as_tensor(np.asarray(sigma_base), dtype=dt, device=dev),
                lung_class,
                idx,
                mask,
                np.asarray(el_pos),
                np.asarray(ex_mat),
                float(np.float32(alpha0)),
            )
        return cls(
            s2=s2, u0=u0, yq=yq, zq=zq, alpha0=float(alpha0),
            meas_mat=torch.as_tensor(
                np.asarray(meas_mat), dtype=torch.int64, device=dev),
        )

    def solve(self, lung_alphas) -> torch.Tensor:
        """(T,) lung conductivities -> (T, n_exc, n_meas) voltages."""
        a = torch.as_tensor(
            np.asarray(lung_alphas), dtype=self.s2.dtype,
            device=self.s2.device,
        )
        with full_f32():
            return _lowrank_solve(
                self.s2, self.u0, self.yq, self.zq, a,
                float(np.float32(self.alpha0)), self.meas_mat,
            )


def _lung_subspace_indices(
    cs: ClassStiffness, lung_class: int, rank_bucket: int
):
    """Host-side lung-node index extraction, padded to the rank bucket.

    Padding slots point at node 0 with a zero mask (their contributions
    vanish). The grounded reference node is excluded, like its zeroed row
    in k_class[lung] excluded it from the diagonal test.
    """
    sel = cs.elem_class_host == lung_class
    nodes = np.unique(cs.tris_host[sel])
    if cs.grounded:
        nodes = nodes[nodes != cs.ref_node]
    diag = np.zeros((cs.n_nodes,), np.float64)
    diag[nodes.astype(np.int64)] = 1.0
    return _indices_from_diag(diag, cs.n_nodes, rank_bucket)


def _indices_from_diag(diag: np.ndarray, n: int, rank_bucket: int):
    lung_nodes = np.flatnonzero(diag > 0)
    m = lung_nodes.shape[0]
    r = max(_round_up_int(m, rank_bucket), rank_bucket)
    r = min(r, n)
    if m > r:  # lung covers (almost) the whole mesh: keep full size
        r = n
    idx = np.zeros((r,), np.int64)
    idx[: min(m, r)] = lung_nodes[: min(m, r)]
    mask = np.zeros((r,), np.float64)
    mask[: min(m, r)] = 1.0
    return idx, mask


def _round_up_int(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _lowrank_core(K_base, Kl, idx, mask, S, Brhs, readout_rows):
    """Woodbury factorization given the assembled K_base, the lung pencil
    block Kl and the one-hot lung selector S. Returns (s2, u0, yq, zq).

        A := L^-1 Kl L^-T = P Kl_s P^T,   P = L^-1 S,
        G := P^T P = C C^T (small Cholesky),
        C^T Kl_s C = Z diag(mu) Z^T      <- the single eigh,
        Q := P C^-T Z  =>  A = Q diag(mu) Q^T,  Q^T Q = I.

    Dead (padding) slots: zero P columns, unit G diagonal, mu = 0 ->
    f(a) = 0, inert.
    """
    r = idx.shape[0]
    # lung-subspace block, padded slots masked out
    Kl_s = Kl[idx][:, idx] * (mask[:, None] * mask[None, :])
    L = torch.linalg.cholesky(K_base)
    C_all = torch.linalg.solve_triangular(
        L, torch.cat([S, Brhs], dim=1), upper=False
    )  # (N, r + n_exc)
    P, C0 = C_all[:, :r], C_all[:, r:]
    G = P.T @ P + torch.diag(1.0 - mask)
    G = 0.5 * (G + G.T)
    C = torch.linalg.cholesky(G)  # r x r
    Bt = C.T @ (Kl_s @ C)
    Bt = 0.5 * (Bt + Bt.T)
    s2, Z = torch.linalg.eigh(Bt)  # the single r x r eigh
    eps = torch.clamp(s2.max(), min=0.0) * 1e-7
    live = s2 > eps
    s2 = torch.where(live, s2, torch.zeros_like(s2))
    Y = torch.linalg.solve_triangular(
        C.T, torch.where(live[None, :], Z, torch.zeros_like(Z)), upper=True
    )  # C^-T Z, dead columns zeroed
    Q = P @ Y  # (N, r): orthonormal live columns of A's eigenbasis
    W_all = torch.linalg.solve_triangular(
        L.T, torch.cat([Q, C0], dim=1), upper=True
    )[readout_rows]  # (E, r + n_exc)
    zq, u0 = W_all[:, :r], W_all[:, r:]
    yq = Q.T @ C0  # (r, n_exc)
    return s2, u0, yq, zq


def _lowrank_setup(
    k_class, diag_fix, ref_node, sigma_base, lung_class, idx, mask,
    el_pos, ex_mat, alpha0,
):
    n = k_class.shape[-1]
    dev, dt = k_class.device, k_class.dtype
    sig = sigma_base.clone()
    sig[lung_class] = alpha0
    K_base = torch.tensordot(sig, k_class, dims=([0], [0])) + torch.diag(
        diag_fix)
    Brhs = _rhs_matrix(el_pos, ex_mat, n, dt, dev)
    Brhs[ref_node, :] = 0.0
    r = idx.shape[0]
    S = np.zeros((n, r), np.float64)
    S[idx, np.arange(r)] = mask
    return _lowrank_core(
        K_base,
        k_class[lung_class],
        torch.as_tensor(idx, device=dev),
        torch.as_tensor(mask, dtype=dt, device=dev),
        torch.as_tensor(S, dtype=dt, device=dev),
        Brhs,
        torch.as_tensor(el_pos, dtype=torch.int64, device=dev),
    )


def _lowrank_solve(s2, u0, yq, zq, alphas, alpha0, meas_mat):
    c = alphas - alpha0  # (T,)
    cs2 = c[:, None] * s2[None, :]
    f = cs2 / (1.0 + cs2)  # (T, r)
    # measurement-folded operator: the whole monitoring is one
    # (T, r) x (r, n_exc*n_meas) product plus the baseline measurement
    n_idx = meas_mat[:, :, 0]  # (n_exc, n_meas)
    m_idx = meas_mat[:, :, 1]
    H = (zq[n_idx] - zq[m_idx]) * yq.T[:, None, :]  # (n_exc, n_meas, r)
    v0 = _measure(u0, meas_mat)  # (n_exc, n_meas)
    flat = f @ H.reshape(-1, H.shape[-1]).T  # (T, n_exc*n_meas)
    return v0[None] - flat.reshape(alphas.shape[0], *n_idx.shape)
