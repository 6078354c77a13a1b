from .polygon import (
    ensure_closed,
    merge_collinear,
    offset_polygon,
    point_line_distance,
    points_in_polygon,
    polygon_area,
    polygon_centroid,
    rasterize_polygons,
)

__all__ = [
    "ensure_closed",
    "merge_collinear",
    "offset_polygon",
    "point_line_distance",
    "points_in_polygon",
    "polygon_area",
    "polygon_centroid",
    "rasterize_polygons",
]
