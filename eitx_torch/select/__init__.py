from .ribs import select_axial_slice_number

__all__ = ["select_axial_slice_number"]
