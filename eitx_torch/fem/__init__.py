from .assembly import ClassStiffness, element_geometry
from .electrodes import boundary_loop, place_electrodes_equal_spacing
from .protocol import Protocol, create_protocol
from .spectral import LowRankSpectralSolver
from .forward import (
    MeshInfo,
    build_sigma_frames,
    compact_mesh_nodes,
    prepare_mesh_info,
    simulate_eit_monitoring,
    write_dat,
)

__all__ = [
    "ClassStiffness",
    "element_geometry",
    "boundary_loop",
    "place_electrodes_equal_spacing",
    "Protocol",
    "create_protocol",
    "LowRankSpectralSolver",
    "MeshInfo",
    "build_sigma_frames",
    "compact_mesh_nodes",
    "prepare_mesh_info",
    "simulate_eit_monitoring",
    "write_dat",
]
