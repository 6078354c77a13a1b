"""High-level EIT monitoring simulation.

Port of eitx/fem/forward.py: one subject through every solver family
(``simulate_eit_monitoring``), or many subjects with one batched spectral
setup per node bucket (``simulate_eit_monitoring_subjects``). The device
work runs on ``device``; all T = n_points frames of a subject solve at
once.

``precision="f64"`` computes in float64 here. The JAX package never
enables x64, so its "f64" arrays are float32; the float64 route is held
to the float64 oracle (``fem/oracle.py``) instead.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import ClassMap, SimulationConfig
from ..core.device import resolve_device
from ..core.errors import SimulationError
from ..core.timing import count, span
from ..physio.materials import get_materials, tissue_conductivities
from ..physio.spirometry import conductivity_schedule, recorded_schedule
from .assembly import ClassStiffness
from .cem import build_cem_system, forward_solve_cem, spectral_cem_solver
from .electrodes import place_electrodes_equal_spacing
from .protocol import Protocol, create_protocol
from .solver import forward_solve_batched, forward_solve_cg
from .spectral import (
    LowRankSpectralSolver,
    SpectralEITSolver,
    lowrank_solve_batch,
)


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
    with span("eitx.fem.mesh_info"):
        element = np.asarray(mesh_data["TRIANGLES"], dtype=np.int64)
        node = np.asarray(mesh_data["NODES"], dtype=np.float64)
        class_ids = np.asarray(mesh_data["CLASS"], dtype=np.int64)
        id_to_name = classes.id_to_name()
        classes_gr: Dict[str, list] = {
            name: [] for name in id_to_name.values()}
        for i, cid in enumerate(class_ids):
            name = id_to_name.get(int(cid))
            if name is None:
                raise SimulationError(
                    f"element {i} has unknown class id {cid}")
            classes_gr[name].append(i)
        return MeshInfo(element=element, node=node, cond=class_ids.copy(),
                        classes_gr=classes_gr)


def load_mesh_txt(fpath: str, classes: ClassMap = ClassMap()) -> MeshInfo:
    """Load the FEMM-format text mesh ("# NODES" / "# TRIANGLES" sections,
    1-based node ids; reference load_mesh, model_generator.py:58-90)."""
    nodes, tris, cls = [], [], []
    key = ""
    with open(fpath) as fh:
        for line in fh:
            if not line.strip():
                continue
            s = line.strip().split(" ")
            if "#" in line:
                key = line.strip()[2:]
            elif key == "NODES":
                nodes.append([float(s[1]), float(s[2])])
            elif key == "TRIANGLES":
                tris.append([int(s[i]) - 1 for i in range(3)])
                cls.append(int(float(s[-1])))
    return prepare_mesh_info(
        {"NODES": nodes, "TRIANGLES": tris, "CLASS": cls}, classes
    )


def compact_mesh_nodes(mesh: MeshInfo) -> MeshInfo:
    """Drop nodes unused by any element, reindexing elements
    (reference check_mesh_nodes, model_generator.py:93-116 — O(n^2) loop
    there; vectorized with np.unique here)."""
    with span("eitx.fem.mesh_info"):
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


def _dtype(cfg: SimulationConfig) -> torch.dtype:
    return torch.float64 if cfg.precision == "f64" else torch.float32


def _schedule(cfg, classes, materials_location, compat_reference_interp):
    """(T, C) per-class conductivities, the lung column and the protocol."""
    with span("eitx.fem.schedule"):
        materials = get_materials(materials_location)
        _, condspir = _breathing_schedule(cfg, materials,
                                          compat_reference_interp)
        base_cond = tissue_conductivities(
            materials,
            cfg.frequency_hz,
            classes.id_to_name(),
            compat_reference_interp,
        )
        sigma = build_sigma_frames(condspir, base_cond, classes)
        proto: Protocol = create_protocol(
            cfg.n_electrodes, cfg.dist_exc, cfg.step_meas, cfg.parser_meas
        )
        return sigma, classes.name_to_id()["lung"], proto


def _electrodes(cfg: SimulationConfig, mesh: MeshInfo) -> np.ndarray:
    with span("eitx.fem.electrodes"):
        return place_electrodes_equal_spacing(
            mesh.node,
            mesh.element,
            n_electrodes=cfg.n_electrodes,
            starting_angle=math.radians(cfg.starting_angle_deg),
        )


def simulate_eit_monitoring_subjects(
    mesh_datas,
    cfg: SimulationConfig = SimulationConfig(),
    classes: ClassMap = ClassMap(),
    materials_location: Optional[str] = None,
    compat_reference_interp: bool = False,
    device="cuda",
):
    """Monitoring for MANY subjects with batched spectral setup.

    Subjects whose padded stiffness shapes coincide (ClassStiffness's
    pad_nodes_to buckets) share one setup: each stage of the factorization
    is one library call over the group's stack, and one batched product
    solves the group's frames (low-rank solver).

    Returns a list of (voltages (T, n_exc*n_meas), per_subject_seconds).
    """
    dev = resolve_device(device)
    t_start = time.time()
    sigma, lung_col, proto = _schedule(cfg, classes, materials_location,
                                       compat_reference_interp)
    alphas = sigma[:, lung_col]
    alpha0 = float(alphas.mean())

    els, css = [], []
    for mesh_data in mesh_datas:
        info = compact_mesh_nodes(prepare_mesh_info(mesh_data, classes))
        els.append(_electrodes(cfg, info))
        css.append(
            ClassStiffness.build(
                info.node, info.element, info.cond,
                n_classes=classes.n_tissues, dtype=_dtype(cfg),
                pad_nodes_to=cfg.pad_nodes_to, pad_elems_to=cfg.pad_elems_to,
                device=dev,
            )
        )
    # group same-bucket subjects for one batched setup each
    groups: Dict[tuple, list] = {}
    for i, cs in enumerate(css):
        groups.setdefault(tuple(cs.k_class.shape), []).append(i)
    results = [None] * len(css)
    for idxs in groups.values():
        args = ([css[i] for i in idxs], sigma[0], lung_col,
                [els[i] for i in idxs], proto.ex_mat, proto.meas_mat,
                [alpha0] * len(idxs))
        if cfg.solver == "spectral_full":
            voltages = [s.solve(alphas) for s in SpectralEITSolver.build_batch(
                *args)]
        else:
            voltages = lowrank_solve_batch(LowRankSpectralSolver.build_batch(
                *args, rank_bucket=cfg.spectral_rank_bucket), alphas)
        for i, v in zip(idxs, voltages):
            with span("eitx.fem.readback"):
                results[i] = v.cpu().numpy().reshape(cfg.n_points, -1)
    count("eitx.fem.subjects", len(results))
    per_subject = (time.time() - t_start) / max(len(css), 1)
    return [(v, per_subject) for v in results]


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

    Returns (voltages (T, n_exc * n_meas), generation_time_s). Assembly
    and solve run on ``device`` with the solver, electrode model and
    precision of ``cfg``; all T = n_points frames solve at once.
    """
    dev = resolve_device(device)
    t0 = time.time()
    mesh = compact_mesh_nodes(prepare_mesh_info(mesh_data, classes))
    sigma, lung_col, proto = _schedule(cfg, classes, materials_location,
                                       compat_reference_interp)
    alphas = sigma[:, lung_col]
    el_pos = _electrodes(cfg, mesh)
    dtype = _dtype(cfg)
    if cfg.electrode_model == "cem":
        cs_raw = ClassStiffness.build(
            mesh.node,
            mesh.element,
            mesh.cond,
            n_classes=classes.n_tissues,
            dtype=dtype,
            ground_ref=False,
            device=dev,
        )
        system = build_cem_system(
            cs_raw,
            mesh.node,
            mesh.element,
            n_electrodes=cfg.n_electrodes,
            z_contact=cfg.z_contact,
            coverage=cfg.electrode_coverage,
            starting_angle=math.radians(cfg.starting_angle_deg),
            dtype=dtype,
        )
        if cfg.solver in ("spectral", "spectral_full"):
            # both spectral flavours route through the low-rank CEM
            # factorization (the augmented system has no full-pencil
            # variant); 'spectral_full' differs only on the point-
            # electrode path
            v = spectral_cem_solver(
                system, sigma[0], lung_col, proto.ex_mat, proto.meas_mat,
                alpha0=float(alphas.mean()),
                rank_bucket=cfg.spectral_rank_bucket,
            ).solve(alphas)
        else:
            v = forward_solve_cem(system, sigma, proto.ex_mat, proto.meas_mat)
    else:
        cs = ClassStiffness.build(
            mesh.node,
            mesh.element,
            mesh.cond,
            n_classes=classes.n_tissues,
            dtype=dtype,
            pad_nodes_to=cfg.pad_nodes_to,
            pad_elems_to=cfg.pad_elems_to,
            device=dev,
        )
        if cfg.solver == "spectral_full":
            v = SpectralEITSolver.build(
                cs, sigma[0], lung_col, el_pos, proto.ex_mat, proto.meas_mat,
                alpha0=float(alphas.mean()),
            ).solve(alphas)
        elif cfg.solver == "spectral":
            v = LowRankSpectralSolver.build(
                cs, sigma[0], lung_col, el_pos, proto.ex_mat, proto.meas_mat,
                alpha0=float(alphas.mean()),
                rank_bucket=cfg.spectral_rank_bucket,
            ).solve(alphas)
        elif cfg.solver == "cg":
            v = forward_solve_cg(cs, sigma, el_pos, proto.ex_mat,
                                 proto.meas_mat)
        else:
            v = forward_solve_batched(cs, sigma, el_pos, proto.ex_mat,
                                      proto.meas_mat)
    with span("eitx.fem.readback"):
        v = v.cpu().numpy().reshape(cfg.n_points, -1)
    count("eitx.fem.subjects", 1)
    if save_to_file and filename is not None:
        write_dat(filename, v, n_repeats=cfg.n_spir * cfg.n_minutes)
    return v, time.time() - t0
