"""High-level EIT monitoring simulation.

Port of eitx/fem/forward.py: ``prepare_mesh_info``, ``compact_mesh_nodes``,
``build_sigma_frames``, ``write_dat`` and the point-electrode, spectral,
float32 branch of ``simulate_eit_monitoring``. The other branches (CEM
electrodes, the batched-Cholesky / CG / full-spectral solvers, float64,
many subjects at once) are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.config import ClassMap, SimulationConfig
from ..core.device import resolve_device
from ..core.errors import SimulationError
from ..physio.materials import get_materials, tissue_conductivities
from ..physio.spirometry import conductivity_schedule, recorded_schedule
from .assembly import ClassStiffness
from .electrodes import place_electrodes_equal_spacing
from .protocol import Protocol, create_protocol
from .spectral import LowRankSpectralSolver


def _breathing_schedule(
    cfg: SimulationConfig, materials, compat_reference_interp: bool
):
    """Lung-conductivity schedule from the configured breathing source."""
    if cfg.spirometry_source == "recorded":
        return recorded_schedule(
            cfg.n_points,
            cfg.frequency_hz,
            materials,
            csv_path=cfg.ventilation_csv,
            compat_reference_interp=compat_reference_interp,
        )
    return conductivity_schedule(
        cfg.n_spir,
        cfg.n_points,
        cfg.frequency_hz,
        materials,
        compat_reference_interp=compat_reference_interp,
    )


@dataclass
class MeshInfo:
    """Parity structure for the reference's meshinfo dict."""

    element: np.ndarray  # (M, 3) int
    node: np.ndarray  # (N, 2) float
    cond: np.ndarray  # (M,) class ids (reference seeds cond with class ids)
    classes_gr: Dict[str, list]  # class name -> element indices


def prepare_mesh_info(
    mesh_data: Dict, classes: ClassMap = ClassMap()
) -> MeshInfo:
    """FEMM-generator mesh dict -> MeshInfo (reference :125-153)."""
    element = np.asarray(mesh_data["TRIANGLES"], dtype=np.int64)
    node = np.asarray(mesh_data["NODES"], dtype=np.float64)
    class_ids = np.asarray(mesh_data["CLASS"], dtype=np.int64)
    id_to_name = classes.id_to_name()
    classes_gr: Dict[str, list] = {name: [] for name in id_to_name.values()}
    for i, cid in enumerate(class_ids):
        name = id_to_name.get(int(cid))
        if name is None:
            raise SimulationError(f"element {i} has unknown class id {cid}")
        classes_gr[name].append(i)
    return MeshInfo(
        element=element, node=node, cond=class_ids.copy(), classes_gr=classes_gr
    )


def compact_mesh_nodes(mesh: MeshInfo) -> MeshInfo:
    """Drop nodes unused by any element, reindexing elements
    (reference check_mesh_nodes, model_generator.py:93-116 — O(n^2) loop
    there; vectorized with np.unique here)."""
    used, inverse = np.unique(mesh.element.ravel(), return_inverse=True)
    if used.shape[0] == mesh.node.shape[0]:
        return mesh
    return MeshInfo(
        element=inverse.reshape(mesh.element.shape),
        node=mesh.node[used],
        cond=mesh.cond,
        classes_gr=mesh.classes_gr,
    )


def build_sigma_frames(
    cond_schedule: np.ndarray,
    base_cond: Dict[str, float],
    classes: ClassMap,
) -> np.ndarray:
    """(T, C) per-class conductivities: every class fixed at its material
    value, lung following the breathing schedule."""
    id_to_name = classes.id_to_name()
    n_classes = classes.n_tissues
    base = np.zeros((n_classes,), dtype=np.float64)
    for cid, name in id_to_name.items():
        base[cid] = base_cond[name]
    T = cond_schedule.shape[0]
    sigma = np.tile(base, (T, 1))
    lung_col = [cid for cid, name in id_to_name.items() if name == "lung"][0]
    sigma[:, lung_col] = cond_schedule[:, 1]
    return sigma


def write_dat(filename: str, v: np.ndarray, n_repeats: int) -> None:
    """Write the .dat voltage dataset: one flattened frame per row, the full
    breathing cycle repeated ``n_repeats`` (= N_spir*N_minutes) times —
    format parity with the reference writer
    (synthetic_datasets_generator.py:336-341 / numpy.savetxt)."""
    v = np.asarray(v, dtype=np.float64)
    flat = v.reshape(v.shape[0], -1)
    with open(filename, "w") as fh:
        for _ in range(n_repeats):
            for row in flat:
                fh.write(" ".join(format(x, ".18e") for x in row) + "\n")


def _check_supported(cfg: SimulationConfig) -> None:
    """Refuse the configurations this slice of the port does not run."""
    if cfg.electrode_model != "point":
        raise NotImplementedError(
            f"electrode_model={cfg.electrode_model!r} is not ported yet "
            "(ROADMAP, queue 1: other solver families, CEM)"
        )
    if cfg.solver != "spectral":
        raise NotImplementedError(
            f"solver={cfg.solver!r} is not ported yet "
            "(ROADMAP, queue 1: other solver families)"
        )
    if cfg.precision != "f32":
        raise NotImplementedError(
            f"precision={cfg.precision!r} is not ported yet "
            "(ROADMAP, queue 1: other solver families, float64 route)"
        )


def simulate_eit_monitoring(
    mesh_data: Dict,
    cfg: SimulationConfig = SimulationConfig(),
    classes: ClassMap = ClassMap(),
    materials_location: Optional[str] = None,
    save_to_file: bool = False,
    filename: Optional[str] = None,
    compat_reference_interp: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, float]:
    """Simulate EIT monitoring with time-varying lung conductivity.

    Returns (voltages (T, n_exc * n_meas), generation_time_s). The
    stiffness assembly and the low-rank spectral solve run on ``device``;
    all T = n_points frames solve as one product.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    t0 = time.time()
    mesh = compact_mesh_nodes(prepare_mesh_info(mesh_data, classes))
    materials = get_materials(materials_location)
    _, condspir = _breathing_schedule(cfg, materials, compat_reference_interp)
    base_cond = tissue_conductivities(
        materials,
        cfg.frequency_hz,
        classes.id_to_name(),
        compat_reference_interp,
    )
    sigma = build_sigma_frames(condspir, base_cond, classes)

    el_pos = place_electrodes_equal_spacing(
        mesh.node,
        mesh.element,
        n_electrodes=cfg.n_electrodes,
        starting_angle=math.radians(cfg.starting_angle_deg),
    )
    proto: Protocol = create_protocol(
        cfg.n_electrodes, cfg.dist_exc, cfg.step_meas, cfg.parser_meas
    )
    cs = ClassStiffness.build(
        mesh.node,
        mesh.element,
        mesh.cond,
        n_classes=classes.n_tissues,
        pad_nodes_to=cfg.pad_nodes_to,
        pad_elems_to=cfg.pad_elems_to,
        device=dev,
    )
    lung_col = classes.name_to_id()["lung"]
    alphas = sigma[:, lung_col]
    solver = LowRankSpectralSolver.build(
        cs,
        sigma[0],
        lung_class=lung_col,
        el_pos=el_pos,
        ex_mat=proto.ex_mat,
        meas_mat=proto.meas_mat,
        alpha0=float(alphas.mean()),
        rank_bucket=cfg.spectral_rank_bucket,
    )
    v = solver.solve(alphas).cpu().numpy().reshape(cfg.n_points, -1)
    if save_to_file and filename is not None:
        write_dat(filename, v, n_repeats=cfg.n_spir * cfg.n_minutes)
    return v, time.time() - t0
