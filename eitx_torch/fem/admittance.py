"""Complex-admittance forward solver (FEMM current-flow physics).

Port of eitx/fem/admittance.py. Each tissue carries conductivity AND
permittivity at the working frequency, so the element coefficient is the
complex admittivity  y = sigma + j*omega*eps0*eps_r. The complex system
(Kr + j*Ki) u = b solves, as in the JAX package, as the equivalent real
block system

    [ Kr  -Ki ] [ur]   [br]
    [ Ki   Kr ] [ui] = [0 ]

with a real LU (``torch.linalg.solve``, cuSOLVER's ``getrf`` / ``getrs``
on the card). Its pivots differ from XLA's, so voltages agree within a
bound, not bit for bit. Frequencies or frames are the batch dimension.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import ClassMap, SimulationConfig
from ..core.device import resolve_device
from ..physio.materials import get_materials, interp_at_freq
from .assembly import assemble_class_stiffness
from .electrodes import place_electrodes_equal_spacing
from .forward import compact_mesh_nodes, prepare_mesh_info
from .protocol import create_protocol
from .solver import _index, _measure, _rhs_matrix, _values

EPS0 = 8.8541878128e-12


def _admittance_solve(nodes, tris, sigma_e, eps_r_e, freq_hz, B,
                      n_nodes: int, ref_node: int):
    """Real and imaginary potentials of a stack of problems: sigma_e,
    eps_r_e (F, M), freq_hz (F,), injection B (F, N, k) -> two (F, N, k)."""
    omega = 2.0 * math.pi * freq_hz
    Kr = assemble_class_stiffness(nodes, tris, sigma_e.T, n_nodes)
    Ki = assemble_class_stiffness(
        nodes, tris, (omega[:, None] * EPS0 * eps_r_e).T, n_nodes)
    for K, diag in ((Kr, 1.0), (Ki, 0.0)):
        K[:, ref_node, :] = 0.0
        K[:, :, ref_node] = 0.0
        K[:, ref_node, ref_node] = diag
    B = B.clone()
    B[:, ref_node, :] = 0.0
    big = torch.cat([torch.cat([Kr, -Ki], dim=-1),
                     torch.cat([Ki, Kr], dim=-1)], dim=-2)
    U = torch.linalg.solve(big, torch.cat([B, torch.zeros_like(B)], dim=-2))
    return U[:, :n_nodes], U[:, n_nodes:]


def forward_solve_admittance(
    nodes, tris, sigma_e, eps_r_e, freq_hz, el_pos, ex_mat, meas_mat,
    n_nodes: int, ref_node: int = 0, device="cuda",
) -> torch.Tensor:
    """Complex64 voltages (n_exc, n_meas) for per-element sigma and eps_r."""
    dev, dtype = resolve_device(device), torch.float32
    return _admittance_voltages(
        nodes, tris, _values(sigma_e, dtype, dev)[None],
        _values(eps_r_e, dtype, dev)[None], _values([freq_hz], dtype, dev),
        el_pos, ex_mat, meas_mat, n_nodes, ref_node)[0]


def _admittance_voltages(nodes, tris, sigma_e, eps_r_e, freq_hz, el_pos,
                         ex_mat, meas_mat, n_nodes, ref_node):
    """(F, n_exc, n_meas) complex voltages of F stacked problems."""
    dev, dt = sigma_e.device, sigma_e.dtype
    B = _rhs_matrix(el_pos, ex_mat, n_nodes, dt, dev)
    ur, ui = _admittance_solve(
        _values(nodes, dt, dev), _index(tris, dev), sigma_e, eps_r_e,
        freq_hz, B.expand(sigma_e.shape[0], -1, -1), n_nodes, ref_node)
    el = _index(el_pos, dev)
    meas = _index(meas_mat, dev)
    return torch.complex(_measure(ur[:, el, :], meas),
                         _measure(ui[:, el, :], meas))


def simulate_eit_spectroscopy(
    mesh_data,
    freqs,
    classes=None,
    cfg=None,
    materials_location=None,
    device="cuda",
):
    """Multi-frequency EIT sweep: complex voltages at every frequency.

    Solves the complex admittance problem y = sigma(f) + j*omega*eps0*
    eps_r(f) for a whole frequency grid at once, the frequencies as the
    batch dimension on ``device``. Returns (F, n_exc, n_meas) complex64.
    """
    dev = resolve_device(device)
    classes = classes or ClassMap()
    cfg = cfg or SimulationConfig()
    info = compact_mesh_nodes(prepare_mesh_info(mesh_data, classes))
    mats = get_materials(materials_location)
    id_to_name = classes.id_to_name()
    freqs = np.asarray(freqs, np.float64)
    F = freqs.shape[0]
    M = info.element.shape[0]
    sig = np.zeros((F, M), np.float32)
    eps = np.zeros((F, M), np.float32)
    for cid, name in id_to_name.items():
        sel = info.cond == cid
        if not sel.any():
            continue
        for k, f in enumerate(freqs):
            sig[k, sel] = interp_at_freq(mats[name]["cond"], float(f))
            eps[k, sel] = interp_at_freq(mats[name]["perm"], float(f))
    el = place_electrodes_equal_spacing(
        info.node, info.element, cfg.n_electrodes,
        starting_angle=np.pi * cfg.starting_angle_deg / 180.0,
    )
    proto = create_protocol(
        cfg.n_electrodes, cfg.dist_exc, cfg.step_meas, cfg.parser_meas
    )
    f32 = torch.float32
    v = _admittance_voltages(
        info.node, info.element, _values(sig, f32, dev), _values(eps, f32, dev),
        _values(freqs, f32, dev), el, proto.ex_mat, proto.meas_mat,
        info.node.shape[0], 0)
    return v.cpu().numpy()
