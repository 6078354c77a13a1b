from .materials import (
    cole_cole,
    generate_material_tables,
    get_materials,
    interp_at_freq,
    tissue_conductivities,
)
from .spirometry import (
    conductivity_schedule,
    fft_filter,
    load_ventilation_csv,
    make_spirometry,
    spirometry_to_conductivity,
    synthetic_ventilation,
)

__all__ = [
    "cole_cole",
    "generate_material_tables",
    "get_materials",
    "interp_at_freq",
    "tissue_conductivities",
    "conductivity_schedule",
    "fft_filter",
    "load_ventilation_csv",
    "make_spirometry",
    "spirometry_to_conductivity",
    "synthetic_ventilation",
]
