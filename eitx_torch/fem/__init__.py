from .assembly import ClassStiffness, assemble_stiffness, element_geometry
from .electrodes import boundary_loop, place_electrodes_equal_spacing
from .protocol import Protocol, abs_to_diff, create_protocol
from .solver import forward_solve, forward_solve_batched, forward_solve_cg
from .spectral import (
    LowRankSpectralSolver,
    SpectralEITSolver,
    lowrank_solve_batch,
)
from .admittance import forward_solve_admittance, simulate_eit_spectroscopy
from .sheffield import (
    electrode_averaging_matrix,
    sheffield_ex_mat,
    sheffield_monitoring,
    sheffield_solve_admittance,
)
from .forward import (
    MeshInfo,
    build_sigma_frames,
    compact_mesh_nodes,
    load_mesh_txt,
    prepare_mesh_info,
    simulate_eit_monitoring,
    simulate_eit_monitoring_subjects,
    write_dat,
)
from .greit import GreitImager, greit_monitoring
from .inverse import (
    DifferenceImager,
    gauss_newton_absolute,
    reconstruct_monitoring,
)

__all__ = [
    "ClassStiffness",
    "assemble_stiffness",
    "element_geometry",
    "boundary_loop",
    "place_electrodes_equal_spacing",
    "Protocol",
    "abs_to_diff",
    "create_protocol",
    "forward_solve",
    "forward_solve_batched",
    "forward_solve_cg",
    "SpectralEITSolver",
    "LowRankSpectralSolver",
    "lowrank_solve_batch",
    "forward_solve_admittance",
    "simulate_eit_spectroscopy",
    "electrode_averaging_matrix",
    "sheffield_ex_mat",
    "sheffield_monitoring",
    "sheffield_solve_admittance",
    "DifferenceImager",
    "GreitImager",
    "greit_monitoring",
    "gauss_newton_absolute",
    "reconstruct_monitoring",
    "MeshInfo",
    "build_sigma_frames",
    "compact_mesh_nodes",
    "load_mesh_txt",
    "prepare_mesh_info",
    "simulate_eit_monitoring",
    "simulate_eit_monitoring_subjects",
    "write_dat",
]
