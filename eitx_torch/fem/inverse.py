"""Inverse EIT: difference imaging and absolute Gauss-Newton on the device.

Port of eitx/fem/inverse.py. The linearized difference-imaging solver
(pyeit's 'jac' solver / EIDORS one-step Gauss-Newton):

  J[(i, mn), e] = -u_i|_e^T ke_e (u_m - u_n)|_e     (adjoint sensitivity)

with ke the unit-conductivity P1 element matrices, for every excitation x
measurement pair as one einsum over elements. Reconstruction solves in
measurement space (n_meas_total x n_meas_total, 208^2 for the
16-electrode adjacent protocol):

  dsigma = J^T (J J^T + lambda * mean(diag(J J^T)) I)^{-1} dv

so a whole breathing monitoring (T frames) is one triangular solve and
one product after one factorization. Everything is dense linear algebra
on ``device`` (cuSOLVER Cholesky, batched products, gathers) with TF32
off: the reference runs these products at "highest" precision.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import ClassMap, SimulationConfig
from ..core.device import resolve_device
from ..core.errors import SimulationError
from ..physio.materials import get_materials, tissue_conductivities
from .assembly import assemble_stiffness, element_geometry
from .electrodes import place_electrodes_equal_spacing
from .forward import compact_mesh_nodes, prepare_mesh_info
from .protocol import create_protocol
from .solver import _index, _measure, _values


def _ground(K: torch.Tensor, ref_node: int) -> torch.Tensor:
    """Zero the reference node's row and column, unit diagonal there.
    Fills only: assigning a number to one element of a CUDA tensor copies
    it from the host and waits for the device."""
    K[ref_node, :] = 0.0
    K[:, ref_node] = 0.0
    K[ref_node, ref_node].fill_(1.0)
    return K


def _electrode_rhs(el_pos: torch.Tensor, n_nodes: int, ref_node: int,
                   dtype) -> torch.Tensor:
    """(N, n_el): a unit current at each electrode node, against the
    grounded reference node. ``el_pos`` are distinct, so one assignment
    per electrode is the reference's ``.add``."""
    n_el = el_pos.shape[0]
    B = torch.zeros((n_nodes, n_el), dtype=dtype, device=el_pos.device)
    B[el_pos, torch.arange(n_el, device=el_pos.device)] = 1.0
    B[ref_node, :] = 0.0
    return B


def _sensitivity(ke, tris, U_el, ex_mat, meas_mat) -> torch.Tensor:
    """(n_exc * n_meas, M) adjoint Jacobian from the single-electrode
    fields ``U_el`` (N, n_el): measurement adjoints are differences of
    those fields, and so are the excitation fields."""
    u_exc = U_el[:, ex_mat[:, 0]] - U_el[:, ex_mat[:, 1]]  # (N, n_exc)
    v_exc = u_exc[tris]  # (M, 3, n_exc) per-element vertex potentials
    v_el = U_el[tris]  # (M, 3, n_el)
    z = torch.einsum("mij,mje->mie", ke, v_el)  # adjoint side per element
    S = torch.einsum("mix,mie->xem", v_exc, z)  # (n_exc, n_el, M)
    m = S.shape[-1]
    Sn = torch.gather(S, 1, meas_mat[:, :, 0, None].expand(-1, -1, m))
    Sm = torch.gather(S, 1, meas_mat[:, :, 1, None].expand(-1, -1, m))
    return -(Sn - Sm).reshape(-1, m)


def _difference_jacobian(
    nodes, tris, sigma_e, el_pos, ex_mat, meas_mat, n_nodes: int,
    ref_node: int = 0, n_real=None,
) -> torch.Tensor:
    """(n_exc * n_meas, M) sensitivity of measured differences to
    per-element conductivity, via the adjoint fields.

    Tensors in, on one device; the arithmetic follows the dtype of
    ``nodes`` and ``sigma_e`` (float32 in the imagers, float64 for a
    reference run). ``n_real`` < n_nodes (an int or a 0-d tensor) marks the
    tail [n_real:] as padding nodes: their isolated rows get a unit
    diagonal so K stays SPD.
    """
    K = _ground(assemble_stiffness(nodes, tris, sigma_e, n_nodes),
                ref_node)
    if n_real is None:
        n_real = n_nodes
    pad = (torch.arange(n_nodes, device=K.device) >= n_real).to(K.dtype)
    pad[ref_node] = 0.0
    K = K + torch.diag(pad)
    B_el = _electrode_rhs(el_pos, n_nodes, ref_node, K.dtype)
    U_el = torch.cholesky_solve(B_el, torch.linalg.cholesky(K))
    ke, _ = element_geometry(nodes, tris)  # unit conductivity
    return _sensitivity(ke, tris, U_el, ex_mat, meas_mat)


def _factor(jac: torch.Tensor, lam: float):
    """Lower Cholesky factor of J J^T + lam * mean(diag(J J^T)) I and
    cuSOLVER's info (0: factored), without waiting for the device."""
    G = jac @ jac.T
    reg = lam * torch.diagonal(G).mean()
    G = G + reg * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return torch.linalg.cholesky_ex(G)


def _reconstruct(jac: torch.Tensor, chol: torch.Tensor,
                 dv: torch.Tensor) -> torch.Tensor:
    flat = dv.reshape(-1, jac.shape[0])  # (T, n_meas_total)
    w = torch.cholesky_solve(flat.T, chol)  # (n_meas_total, T)
    ds = (jac.T @ w).T  # (T, M)
    return ds.reshape(*dv.shape[:-1], jac.shape[1])


def _check_factored(info: torch.Tensor, what: str) -> None:
    if bool((info != 0).any()):
        raise SimulationError(f"{what}: Cholesky factorization failed "
                              f"(info {info.tolist()})")


@dataclass
class DifferenceImager:
    """Precomputed Jacobian + regularized measurement-space factor.

    ``chol`` is the LOWER Cholesky factor of (J J^T + lam diag); the
    reference keeps ``cho_factor``'s upper one. ``torch.cholesky_solve``
    with the lower factor is the same solve.
    """

    jac: torch.Tensor  # (n_meas_total, M)
    chol: torch.Tensor  # lower factor of (J J^T + lam diag)
    tris: np.ndarray
    nodes: np.ndarray

    def reconstruct(self, dv) -> torch.Tensor:
        """dv (..., n_meas_total) voltage differences -> (..., M) dsigma,
        on the imager's device."""
        return _reconstruct(self.jac, self.chol,
                            _values(dv, self.jac.dtype, self.jac.device))

    @classmethod
    def build(
        cls,
        nodes: np.ndarray,
        tris: np.ndarray,
        sigma_ref: np.ndarray,
        el_pos,
        ex_mat,
        meas_mat,
        lam: float = 1e-3,
        ref_node: int = 0,
        device="cuda",
    ) -> "DifferenceImager":
        """Factor the linearized inverse around ``sigma_ref`` in float32.

        lam is the relative Tikhonov weight (scaled by the mean diagonal
        of J J^T, so it is dimensionless).
        """
        dev = resolve_device(device)
        f32 = torch.float32
        jac = _difference_jacobian(
            _values(nodes, f32, dev), _index(tris, dev),
            _values(sigma_ref, f32, dev), _index(el_pos, dev),
            _index(ex_mat, dev), _index(meas_mat, dev),
            nodes.shape[0], ref_node,
        )
        chol, info = _factor(jac, lam)
        _check_factored(info, "DifferenceImager.build")
        return cls(jac=jac, chol=chol, tris=np.asarray(tris),
                   nodes=np.asarray(nodes))


def monitoring_linearization(mesh_data, classes=None, cfg=None):
    """Shared prep for linear imaging of a pipeline mesh: returns
    (info, sigma_ref, el_pos, protocol) — the compacted mesh, the
    tissue-table reference conductivities, equally-spaced electrodes, and
    the measurement protocol, all from the same config defaults the
    forward simulation used."""
    classes = classes or ClassMap()
    cfg = cfg or SimulationConfig()
    info = compact_mesh_nodes(prepare_mesh_info(mesh_data, classes))
    mats = get_materials()
    base = tissue_conductivities(mats, cfg.frequency_hz, classes.id_to_name())
    sigma_ref = np.array(
        [base[classes.id_to_name()[int(c)]] for c in info.cond], np.float64
    )
    el = place_electrodes_equal_spacing(
        info.node, info.element, cfg.n_electrodes,
        starting_angle=math.radians(cfg.starting_angle_deg),
    )
    proto = create_protocol(
        cfg.n_electrodes, cfg.dist_exc, cfg.step_meas, cfg.parser_meas
    )
    return info, sigma_ref, el, proto


def reconstruct_monitoring(
    mesh_data,
    v_frames: np.ndarray,
    classes=None,
    cfg=None,
    lam: float = 1e-3,
    ref_frame: int = 0,
    device="cuda",
):
    """Reconstruct per-element conductivity CHANGES for a whole monitoring.

    Args:
      mesh_data: NODES/TRIANGLES/CLASS dict (the forward pipeline's mesh).
      v_frames: (T, n_exc * n_meas) voltage rows (e.g. a .dat file's
        unique frames).
      ref_frame: index of the reference (baseline) frame.
      device: where the imager is built and the frames reconstruct.
    Returns:
      (dsigma (T, M) numpy, imager) — images of the breathing-induced
      conductivity change per element.
    """
    info, sigma_ref, el, proto = monitoring_linearization(
        mesh_data, classes, cfg
    )
    imager = DifferenceImager.build(
        info.node, info.element, sigma_ref, el, proto.ex_mat, proto.meas_mat,
        lam=lam, device=device,
    )
    v = _values(v_frames, torch.float32, imager.jac.device)
    dv = v - v[ref_frame][None]
    return imager.reconstruct(dv).cpu().numpy(), imager


# ---------------------------------------------------------------------------
# Absolute (static) imaging: regularized Gauss-Newton
# ---------------------------------------------------------------------------


def _voltages(U_el, el_pos, ex_mat, meas_mat) -> torch.Tensor:
    """Electrode fields (N, n_el) -> (n_exc * n_meas,) voltages."""
    u_exc = U_el[:, ex_mat[:, 0]] - U_el[:, ex_mat[:, 1]]
    return _measure(u_exc[el_pos], meas_mat).reshape(-1)


def _electrode_fields(nodes, tris, sigma, B_el, ref_node):
    """(U_el (N, n_el), cuSOLVER info) at per-element conductivity
    ``sigma``; no wait for the device."""
    K = _ground(assemble_stiffness(nodes, tris, sigma, nodes.shape[0]),
                ref_node)
    L, info = torch.linalg.cholesky_ex(K)
    return torch.cholesky_solve(B_el, L), info


def _fields_jacobian_residual(
    nodes, tris, ke, sigma, B_el, el_pos, ex_mat, meas_mat, v_meas,
    ref_node: int = 0,
):
    """One linearization point: (residual v_meas - v(sigma), J, info).
    The Cholesky factor is shared between the forward voltages and the
    adjoint Jacobian (each Gauss-Newton iteration is ONE factorization)."""
    U_el, info = _electrode_fields(nodes, tris, sigma, B_el, ref_node)
    r = v_meas - _voltages(U_el, el_pos, ex_mat, meas_mat)
    return r, _sensitivity(ke, tris, U_el, ex_mat, meas_mat), info


def _gauss_newton(nodes, tris, ke, sigma, B_el, el_pos, ex_mat, meas_mat,
                  v_meas, lam, sigma_min, sigma_max, ref_node, n_iter):
    """The reference's ``lax.scan`` as a loop of ``n_iter`` steps that
    never waits for the device: the squared residuals and the
    factorizations' infos stay device tensors.

    Returns (sigma (M,), squared residual per iteration (n_iter,),
    infos (2 * n_iter,))."""
    res, infos = [], []
    for _ in range(n_iter):
        r, J, info_k = _fields_jacobian_residual(
            nodes, tris, ke, sigma, B_el, el_pos, ex_mat, meas_mat,
            v_meas, ref_node,
        )
        L, info_g = _factor(J, lam)
        w = torch.cholesky_solve(r[:, None], L)[:, 0]
        sigma = torch.clamp(sigma + J.T @ w, sigma_min, sigma_max)
        res.append(torch.dot(r, r))
        infos += [info_k, info_g]
    return sigma, torch.stack(res), torch.stack(infos)


def gauss_newton_absolute(
    nodes: np.ndarray,
    tris: np.ndarray,
    v_meas: np.ndarray,
    el_pos,
    ex_mat,
    meas_mat,
    n_iter: int = 8,
    lam: float = 1e-2,
    sigma_bounds=(1e-4, 10.0),
    ref_node: int = 0,
    device="cuda",
):
    """Absolute (static) conductivity imaging by regularized Gauss-Newton.

    An iterative absolute reconstruction, every step on ``device`` in
    float32: one Cholesky factorization shared by the forward residual and
    the adjoint Jacobian, a measurement-space (n_meas_total^2, 208^2)
    regularized solve, and a clipped update. The inputs go to the device
    before the loop, the loop never waits for the device, and the result
    comes back after it in one read.

    Starts from the best-fitting homogeneous conductivity (voltages of the
    point-electrode model scale as 1/sigma, so the optimal homogeneous fit
    has a closed form).

    Returns (sigma (M,) per-element conductivities,
             residual_norms (n_iter,) squared residual per iteration),
    numpy. Raises ``SimulationError`` if a factorization failed.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    nodes_t, tris_t = _values(nodes, f32, dev), _index(tris, dev)
    el, exm, mm = (_index(a, dev) for a in (el_pos, ex_mat, meas_mat))
    vm = _values(v_meas, f32, dev).reshape(-1)
    M = tris.shape[0]
    ke, _ = element_geometry(nodes_t, tris_t)
    B_el = _electrode_rhs(el, nodes.shape[0], ref_node, f32)
    U1, info1 = _electrode_fields(nodes_t, tris_t, ke.new_ones(M), B_el,
                                  ref_node)
    v1 = _voltages(U1, el, exm, mm)
    # v(s*1) = v1 / s  =>  s* = <v1, v1> / <v_meas, v1>
    s0 = torch.dot(v1, v1) / torch.dot(vm, v1).clamp(min=1e-12)
    sigma0 = s0.clamp(*sigma_bounds).expand(M).clone()
    sigma, res, infos = _gauss_newton(
        nodes_t, tris_t, ke, sigma0, B_el, el, exm, mm, vm, lam,
        sigma_bounds[0], sigma_bounds[1], ref_node, n_iter,
    )
    # the call's one wait for the device: sigma, residuals and infos at once
    out = torch.cat([sigma, res, torch.cat([info1[None], infos]).to(f32)])
    out = out.cpu().numpy()
    _check_factored(torch.from_numpy(out[M + n_iter:]),
                    "gauss_newton_absolute")
    return out[:M].copy(), out[M:M + n_iter].copy()
