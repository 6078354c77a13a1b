"""Spectral (rank-structured) EIT monitoring solvers.

Port of eitx/fem/spectral.py. Breathing only modulates the lung
conductivity, so every frame's system matrix is a one-parameter pencil

    K(a) = K_base + (a - a0) * K_lung ,

factored once per subject; each breathing frame is then one row of a
(T, r) x (r, n_exc * n_meas) product. ``SpectralEITSolver`` diagonalizes
the whole N-pencil (one N x N ``eigh``); ``LowRankSpectralSolver`` only
its lung subspace (one r x r ``eigh``).

The setups are written once, for a stack of subjects: every stage is one
``torch.linalg`` call over the stack's leading dimension (Cholesky,
triangular solves, ``eigh``), and a single subject is a stack of one.
They run as cuSOLVER / cuBLAS library calls, as the JAX package leaves
them to XLA, in full float32: the reference pins ``"highest"`` matmul
precision (spectral.py:152,484), and the port runs no float32 path in
TF32 (switched off once, when ``eitx_torch`` is imported).

Compare voltages, never eigenvectors: the sign and order of an ``eigh``
basis differ between libraries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.timing import span
from .assembly import ClassStiffness
from .solver import _index, _measure, _rhs_matrix, _values


def _rows(W: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """W (B, N, k), rows (B, E) -> (B, E, k): each subject's own rows."""
    return W[torch.arange(W.shape[0], device=W.device)[:, None], rows]


def _base_matrices(k_stack, extra, sigma_base, lung_class, alpha0s):
    """K_base of each subject: sum_c sig_c K_c + ``extra`` with the lung
    class at that subject's alpha0. k_stack (B, C, N, N), extra (B, N, N),
    alpha0s (B,). Summed class by class, elementwise: the same arithmetic
    for a subject whatever the stack's size (a batched product's kernel
    depends on it)."""
    sig = sigma_base[None].repeat(k_stack.shape[0], 1)
    sig[:, lung_class] = alpha0s
    K = extra
    for c in range(k_stack.shape[1]):
        K = K + sig[:, c, None, None] * k_stack[:, c]
    return K


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factors of a stack (B, N, N). On the card torch factors a
    stack of more than one with cuSOLVER's batched routine and a stack of
    one with its single-matrix routine; they round differently (5e-6 of
    scale on a 3072^2 stiffness matrix, which moves an lc-7 thorax's
    voltages by up to 6e-3 of scale). So a stack of one is factored as two
    copies, and a subject gives the same voltages alone and in a group."""
    if A.is_cuda and A.shape[0] == 1:
        return torch.linalg.cholesky(A.repeat(2, 1, 1))[:1]
    return torch.linalg.cholesky(A)


def _f32_rounded(alpha0: float) -> float:
    """``jnp.float32(alpha0)``: the reference rounds the setup's alpha0
    through float32 whatever the solver's dtype (spectral.py:63,282)."""
    return float(np.float32(alpha0))


@dataclass
class SpectralEITSolver:
    """Full-pencil spectral solver: K_base = L L^T,
    L^-1 K_lung L^-T = Q diag(lam) Q^T, and

        K(a)^-1 b = L^-T Q diag(1 / (1 + (a - a0) lam)) Q^T L^-1 b .
    """

    lam: torch.Tensor  # (N,) eigenvalues of the pencil
    y0: torch.Tensor  # (N, n_exc) transformed injection block
    z: torch.Tensor  # (E, N) electrode readout rows
    alpha0: float
    meas_mat: torch.Tensor

    @classmethod
    def build(
        cls, cs: ClassStiffness, sigma_base, lung_class: int, el_pos, ex_mat,
        meas_mat, alpha0: float,
    ) -> "SpectralEITSolver":
        return cls._build_stack([cs], sigma_base, lung_class, [el_pos], ex_mat,
                                meas_mat, [_f32_rounded(alpha0)], [alpha0])[0]

    @classmethod
    def build_general(
        cls,
        k_class: torch.Tensor,  # (C, D, D) pencil matrices
        fixed: torch.Tensor,  # (D, D) conductivity-independent part
        sigma_base,
        lung_class: int,
        rhs: torch.Tensor,  # (D, n_exc) injection block
        readout_rows,  # (E,) rows whose potentials are measured
        meas_mat,
        alpha0: float,
    ) -> "SpectralEITSolver":
        """Spectral factorization for any SPD pencil K(a) = K_base + dK*a,
        such as the complete electrode model's augmented system."""
        dev, dt = k_class.device, k_class.dtype
        K_base = _base_matrices(
            k_class[None], fixed[None], _values(sigma_base, dt, dev),
            lung_class, torch.tensor([alpha0], dtype=dt, device=dev))
        lam, y0, z = _spectral_core(
            K_base, k_class[lung_class][None], _values(rhs, dt, dev)[None],
            _index(readout_rows, dev)[None])
        return cls(lam=lam[0], y0=y0[0], z=z[0], alpha0=float(alpha0),
                   meas_mat=_index(meas_mat, dev))

    @classmethod
    def build_batch(
        cls, cs_list, sigma_base, lung_class: int, el_pos_list, ex_mat,
        meas_mat, alpha0s,
    ):
        """Factor MANY same-bucket subjects' pencils at once: one call per
        stage over the stack. Returns a list of solvers."""
        return cls._build_stack(cs_list, sigma_base, lung_class, el_pos_list,
                                ex_mat, meas_mat, alpha0s, alpha0s)

    @classmethod
    def _build_stack(cls, cs_list, sigma_base, lung_class, el_pos_list,
                     ex_mat, meas_mat, setup_alpha0s, alpha0s):
        """Solvers of a stack: the setup runs at ``setup_alpha0s``, each
        solver keeps its entry of ``alpha0s``."""
        k_stack, d_stack, ref, el_stack = _stack_subjects(cs_list, el_pos_list)
        dev, dt = k_stack.device, k_stack.dtype
        n = k_stack.shape[-1]
        K_base = _base_matrices(
            k_stack, torch.diag_embed(d_stack), _values(sigma_base, dt, dev),
            lung_class, _values(setup_alpha0s, dt, dev))
        rhs = torch.stack([
            _rhs_matrix(e, ex_mat, n, dt, dev) for e in el_pos_list])
        rhs[:, ref, :] = 0.0
        lam, y0, z = _spectral_core(K_base, k_stack[:, lung_class], rhs,
                                    el_stack)
        meas = _index(meas_mat, dev)
        return [cls(lam=lam[b], y0=y0[b], z=z[b], alpha0=float(alpha0s[b]),
                    meas_mat=meas) for b in range(len(cs_list))]

    def solve(self, lung_alphas) -> torch.Tensor:
        """(T,) lung conductivities -> (T, n_exc, n_meas) voltages."""
        dt, dev = self.lam.dtype, self.lam.device
        alphas = _values(lung_alphas, dt, dev)
        denom = 1.0 + (alphas[:, None] - torch.tensor(
            self.alpha0, dtype=dt, device=dev)) * self.lam[None, :]
        # electrode readout and measurement differences folded into one
        # frame-independent operator: the monitoring is ONE product
        n_idx = self.meas_mat[:, :, 0]
        m_idx = self.meas_mat[:, :, 1]
        H = (self.z[n_idx] - self.z[m_idx]) * self.y0.T[:, None, :]
        flat = (1.0 / denom) @ H.reshape(-1, H.shape[-1]).T
        return flat.reshape(alphas.shape[0], *n_idx.shape)


def _stack_subjects(cs_list, el_pos_list):
    """Stacked class matrices, diagonal fixes and electrode nodes of
    same-bucket subjects, and their shared reference node."""
    ref_nodes = {cs.ref_node for cs in cs_list}
    if len(ref_nodes) != 1:
        raise ValueError("batched subjects must share ref_node")
    k_stack = torch.stack([cs.k_class for cs in cs_list])  # (B, C, N, N)
    d_stack = torch.stack([cs.diag_fix for cs in cs_list])  # (B, N)
    el_stack = _index(np.stack([np.asarray(e) for e in el_pos_list]),
                      k_stack.device)
    return k_stack, d_stack, ref_nodes.pop(), el_stack


def _spectral_core(K_base, Kl, rhs, readout_rows):
    """Full-pencil factorization of a stack: K_base, Kl (B, N, N), rhs
    (B, N, n_exc), readout_rows (B, E) -> lam (B, N), y0 (B, N, n_exc),
    z (B, E, N)."""
    L = _cholesky(K_base)
    X = torch.linalg.solve_triangular(L, Kl, upper=False)
    Bm = torch.linalg.solve_triangular(L, X.mT, upper=False).mT
    Bm = 0.5 * (Bm + Bm.mT)
    lam, Q = torch.linalg.eigh(Bm)
    y0 = Q.mT @ torch.linalg.solve_triangular(L, rhs, upper=False)
    # Z = (L^-T Q)[el_pos]: solve L^T W = Q, take the electrode rows
    W = torch.linalg.solve_triangular(L.mT, Q, upper=True)
    return lam, y0, _rows(W, readout_rows)


# ---------------------------------------------------------------------------
# Low-rank (lung-subspace) spectral solver
# ---------------------------------------------------------------------------


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
        cls, cs: ClassStiffness, sigma_base, lung_class: int, el_pos, ex_mat,
        meas_mat, alpha0: float, rank_bucket: int = 256,
    ) -> "LowRankSpectralSolver":
        return cls._build_stack([cs], sigma_base, lung_class, [el_pos], ex_mat,
                                meas_mat, [_f32_rounded(alpha0)], [alpha0],
                                rank_bucket)[0]

    @classmethod
    def build_general(
        cls,
        k_class: torch.Tensor,  # (C, D, D) pencil matrices
        fixed: torch.Tensor,  # (D, D) conductivity-independent part
        sigma_base,
        lung_class: int,
        rhs: torch.Tensor,  # (D, n_exc) injection block (pre-grounded)
        readout_rows,  # (E,) rows whose potentials are measured
        meas_mat,
        alpha0: float,
        rank_bucket: int = 256,
    ) -> "LowRankSpectralSolver":
        """Low-rank factorization for any SPD pencil K(a) = K_base + dK*a
        whose varying part has small support — the CEM's augmented system
        keeps the lung-block structure (electrode rows live in
        ``fixed``)."""
        dev, dt = k_class.device, k_class.dtype
        diag = torch.diagonal(k_class[lung_class]).cpu().numpy()
        idx, mask = _indices_from_diag(diag, k_class.shape[-1], rank_bucket)
        K_base = _base_matrices(
            k_class[None], fixed[None], _values(sigma_base, dt, dev),
            lung_class, torch.tensor([alpha0], dtype=dt, device=dev))
        s2, u0, yq, zq = _lowrank_core(
            K_base, k_class[lung_class][None], _index(idx, dev)[None],
            _values(mask, dt, dev)[None],
            _values(_selector(idx, mask, k_class.shape[-1]), dt, dev)[None],
            _values(rhs, dt, dev)[None], _index(readout_rows, dev)[None])
        return cls(s2=s2[0], u0=u0[0], yq=yq[0], zq=zq[0],
                   alpha0=float(alpha0), meas_mat=_index(meas_mat, dev))

    @classmethod
    def build_batch(
        cls, cs_list, sigma_base, lung_class: int, el_pos_list, ex_mat,
        meas_mat, alpha0s, rank_bucket: int = 256,
    ):
        """Factor many same-bucket subjects' lung pencils at once: one call
        per stage over the stack, each subject's lung indices padded to the
        group's largest rank with index 0 and mask 0. Returns a list of
        solvers."""
        return cls._build_stack(cs_list, sigma_base, lung_class, el_pos_list,
                                ex_mat, meas_mat, alpha0s, alpha0s,
                                rank_bucket)

    @classmethod
    def _build_stack(cls, cs_list, sigma_base, lung_class, el_pos_list,
                     ex_mat, meas_mat, setup_alpha0s, alpha0s, rank_bucket):
        """Solvers of a stack: the setup runs at ``setup_alpha0s``, each
        solver keeps its entry of ``alpha0s``."""
        with span("eitx.fem.setup.select"):
            k_stack, d_stack, ref, el_stack = _stack_subjects(cs_list,
                                                              el_pos_list)
            dev, dt = k_stack.device, k_stack.dtype
            n = k_stack.shape[-1]
            pairs = [_lung_subspace_indices(cs, lung_class, rank_bucket)
                     for cs in cs_list]
            r = max(p[0].shape[0] for p in pairs)
            idxs = np.stack([np.pad(p[0], (0, r - p[0].shape[0]))
                             for p in pairs])
            masks = np.stack([np.pad(p[1], (0, r - p[1].shape[0]))
                              for p in pairs])
            sel = np.stack([_selector(i, m, n) for i, m in zip(idxs, masks)])
            K_base = _base_matrices(
                k_stack, torch.diag_embed(d_stack),
                _values(sigma_base, dt, dev), lung_class,
                _values(setup_alpha0s, dt, dev))
            rhs = torch.stack([
                _rhs_matrix(e, ex_mat, n, dt, dev) for e in el_pos_list])
            rhs[:, ref, :] = 0.0
            idx_t, mask_t = _index(idxs, dev), _values(masks, dt, dev)
            sel_t = _values(sel, dt, dev)
        with span("eitx.fem.setup.factor", dev):
            s2, u0, yq, zq = _lowrank_core(
                K_base, k_stack[:, lung_class], idx_t, mask_t, sel_t, rhs,
                el_stack)
        meas = _index(meas_mat, dev)
        return [cls(s2=s2[b], u0=u0[b], yq=yq[b], zq=zq[b],
                    alpha0=float(alpha0s[b]), meas_mat=meas)
                for b in range(len(cs_list))]

    def solve(self, lung_alphas) -> torch.Tensor:
        """(T,) lung conductivities -> (T, n_exc, n_meas) voltages."""
        return lowrank_solve_batch([self], lung_alphas)[0]


def lowrank_solve_batch(solvers, lung_alphas):
    """Solve many same-bucket subjects' monitorings at once: the factored
    operators stack (same shapes by construction from ``build_batch``) and
    one batched product serves the group. Returns a list of
    (T, n_exc, n_meas)."""
    if not solvers:
        return []
    # same-bucket precondition, enforced on shapes (an elementwise compare
    # would wait for the device): the group shares one measurement
    # operator, and stacking would silently use solvers[0]'s otherwise
    m0 = solvers[0].meas_mat
    for s in solvers[1:]:
        if s.meas_mat.shape != m0.shape:
            raise ValueError(
                "lowrank_solve_batch requires same-bucket solvers "
                f"(meas_mat {tuple(s.meas_mat.shape)} != {tuple(m0.shape)})"
            )
    with span("eitx.fem.solve", m0.device):
        s2 = torch.stack([s.s2 for s in solvers])
        dt, dev = s2.dtype, s2.device
        out = _lowrank_solve(
            s2,
            torch.stack([s.u0 for s in solvers]),
            torch.stack([s.yq for s in solvers]),
            torch.stack([s.zq for s in solvers]),
            _values(lung_alphas, dt, dev),
            torch.tensor([s.alpha0 for s in solvers], dtype=dt, device=dev),
            m0,
        )
        return list(out.unbind(0))


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


def _selector(idx: np.ndarray, mask: np.ndarray, n: int) -> np.ndarray:
    """(n, r) one-hot lung-node selector S, dead slots zero."""
    r = idx.shape[0]
    S = np.zeros((n, r), np.float64)
    S[idx, np.arange(r)] = mask
    return S


def _round_up_int(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _lowrank_core(K_base, Kl, idx, mask, S, Brhs, readout_rows):
    """Woodbury factorization of a stack of subjects given the assembled
    K_base and lung pencil block Kl (B, N, N), lung indices idx and mask
    (B, r), the one-hot selector S (B, N, r), the injection block Brhs
    (B, N, n_exc) and the readout rows (B, E). Returns (s2, u0, yq, zq).

        A := L^-1 Kl L^-T = P Kl_s P^T,   P = L^-1 S,
        G := P^T P = C C^T (small Cholesky),
        C^T Kl_s C = Z diag(mu) Z^T      <- the single eigh,
        Q := P C^-T Z  =>  A = Q diag(mu) Q^T,  Q^T Q = I.

    Dead (padding) slots: zero P columns, unit G diagonal, mu = 0 ->
    f(a) = 0, inert.
    """
    r = idx.shape[-1]
    # lung-subspace block (a batched gather), padded slots masked out
    bi = torch.arange(Kl.shape[0], device=Kl.device)[:, None, None]
    Kl_s = Kl[bi, idx[:, :, None], idx[:, None, :]] * (
        mask[:, :, None] * mask[:, None, :])
    L = _cholesky(K_base)
    C_all = torch.linalg.solve_triangular(
        L, torch.cat([S, Brhs], dim=-1), upper=False
    )  # (B, N, r + n_exc)
    P, C0 = C_all[..., :r], C_all[..., r:]
    G = P.mT @ P + torch.diag_embed(1.0 - mask)
    G = 0.5 * (G + G.mT)
    C = _cholesky(G)  # r x r
    Bt = C.mT @ (Kl_s @ C)
    Bt = 0.5 * (Bt + Bt.mT)
    s2, Z = torch.linalg.eigh(Bt)  # the single r x r eigh
    eps = torch.clamp(s2.amax(dim=-1, keepdim=True), min=0.0) * 1e-7
    live = s2 > eps
    s2 = torch.where(live, s2, torch.zeros_like(s2))
    Y = torch.linalg.solve_triangular(
        C.mT, torch.where(live[:, None, :], Z, torch.zeros_like(Z)), upper=True
    )  # C^-T Z, dead columns zeroed
    Q = P @ Y  # (B, N, r): orthonormal live columns of A's eigenbasis
    W_all = _rows(torch.linalg.solve_triangular(
        L.mT, torch.cat([Q, C0], dim=-1), upper=True
    ), readout_rows)  # (B, E, r + n_exc)
    zq, u0 = W_all[..., :r], W_all[..., r:]
    yq = Q.mT @ C0  # (B, r, n_exc)
    return s2, u0, yq, zq


def _lowrank_solve(s2, u0, yq, zq, alphas, alpha0s, meas_mat):
    """Stacked operators (B, ...) and shared alphas (T,) -> (B, T, n_exc,
    n_meas)."""
    c = alphas[None, :] - alpha0s[:, None]  # (B, T)
    cs2 = c[:, :, None] * s2[:, None, :]
    f = cs2 / (1.0 + cs2)  # (B, T, r)
    # measurement-folded operator: the whole monitoring is one
    # (T, r) x (r, n_exc*n_meas) product per subject plus the baseline
    n_idx = meas_mat[:, :, 0]  # (n_exc, n_meas)
    m_idx = meas_mat[:, :, 1]
    H = (zq[:, n_idx] - zq[:, m_idx]) * yq.mT[:, :, None, :]  # (B, x, m, r)
    v0 = _measure(u0, meas_mat)  # (B, n_exc, n_meas)
    flat = f @ H.reshape(H.shape[0], -1, H.shape[-1]).mT  # (B, T, x*m)
    return v0[:, None] - flat.reshape(*f.shape[:2], *n_idx.shape)
