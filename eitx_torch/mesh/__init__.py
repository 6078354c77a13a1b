from .api import add_skin, create_mesh, find_outer_contour
from .classify import classify_triangles
from .export import export_mesh, write_mesh_txt
from .pip import points_in_polys, points_in_polys_ref
from .render import render_mesh
from .triangulate import triangulate_polygon

__all__ = [
    "add_skin",
    "create_mesh",
    "find_outer_contour",
    "classify_triangles",
    "export_mesh",
    "write_mesh_txt",
    "points_in_polys",
    "points_in_polys_ref",
    "render_mesh",
    "triangulate_polygon",
]
