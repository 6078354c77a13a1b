from .trace import arc_length, find_external_contours
from .simplify import approx_poly_dp
from .formats import (
    build_coordinate_list,
    format_polygon_line,
    parse_polygon_line,
    parse_polygon_lines,
    to_yolo_label,
)

__all__ = [
    "arc_length",
    "find_external_contours",
    "approx_poly_dp",
    "build_coordinate_list",
    "format_polygon_line",
    "parse_polygon_line",
    "parse_polygon_lines",
    "to_yolo_label",
]
