"""create_mesh — the library entry point matching the reference's contract.

Port of eitx/mesh/api.py. Parameter-for-parameter parity with
femm_generator.create_mesh (femm_generator.py:369-491): polygon strings
in, (render image, mesh dict) out. Triangulation runs on the host (the
in-repo C++ mesher); triangle classification runs on ``device``.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..contours.formats import parse_polygon_line
from ..contours.trace import find_external_contours
from ..core.errors import MeshingError
from ..geometry.polygon import (
    ensure_closed,
    merge_collinear,
    offset_polygon,
    polygon_area,
    union_outer_contour_raster,
)
from .classify import classify_triangles
from .export import export_mesh, write_mesh_txt
from .render import render_mesh
from .triangulate import triangulate_polygon

logger = logging.getLogger("eitx_torch.mesh")


def find_outer_contour(
    polygons: List[str], distance_threshold: float = 1.3
) -> Optional[int]:
    """Index of the outer contour line.

    A class-4 line wins outright (the live pipeline always appends the body
    contour as class 4, reference femm_generator.py:587-590). Otherwise the
    union of all polygons is rasterized, its outer boundary traced, and that
    contour appended as a new class-4 line (replaces Shapely unary_union,
    reference :592-625).
    """
    for idx, line in enumerate(polygons):
        if line and line[0] == "4":
            return idx

    polys = []
    for line in polygons:
        try:
            parts = list(map(float, line.strip().split(" ")))
        except ValueError:
            continue
        coords = merge_collinear(parts[1:], distance_threshold)
        if len(coords) < 6 or len(coords) % 2 != 0:
            continue
        pts = np.array(coords, dtype=np.float64).reshape(-1, 2)
        if polygon_area(pts) > 0:
            polys.append(pts)
    if not polys:
        return None
    all_pts = np.concatenate(polys)
    pad = 4
    w = int(np.ceil(all_pts[:, 0].max())) + pad
    h = int(np.ceil(all_pts[:, 1].max())) + pad
    mask = union_outer_contour_raster(polys, (h, w))
    contours = find_external_contours(mask)
    if not contours:
        return None
    outer = max(contours, key=lambda c: polygon_area(c.astype(float)))
    outer = ensure_closed(outer.astype(np.float64))
    parts = ["4"] + [f"{x} {y}" for x, y in outer]
    polygons.append(" ".join(parts))
    return len(polygons) - 1


def add_skin(
    outer_segment: int, polygons: List[str], skin_width: float
) -> Tuple[int, List[str]]:
    """Offset the outer contour outward by ``skin_width`` and append it as a
    new class-4 line (reference :714-745, Shapely buffer there)."""
    parts = polygons[outer_segment].split()
    coords = np.array(list(map(float, parts[1:]))).reshape(-1, 2)
    new_pts = offset_polygon(coords, skin_width)
    new_line = "4 " + " ".join(f"{x:.6f} {y:.6f}" for x, y in new_pts)
    polygons.append(new_line)
    return len(polygons) - 1, polygons


def create_mesh(
    pixel_spacing: Sequence,
    polygons: List[str],
    lc: float = 7,
    distance_threshold: float = 1.3,
    skin_width: float = 1,
    is_show_inner_contours: bool = False,
    show_meshing_result_method: str = "opencv",
    number_of_showed_class: int = -1,
    is_saving_to_file: bool = False,
    export_filename: Optional[str] = None,
    classify_samples: int = 8,
    classify_bucket_contours: int = 4,
    classify_bucket_points: int = 64,
    device="cuda",
):
    """Triangulate the outer contour and classify elements by tissue.

    Args match the reference contract (examples/README.md:216-231):
      pixel_spacing: [sx, sy] px->mm ratios (recorded, not applied — the
        reference meshes in pixel coordinates too)
      polygons: '<class> x1 y1 ...' lines
      lc: target element size; distance_threshold: collinear merge
      skin_width: >0 offset ring (class 4), 0 none, -1 boundary elements
      show_meshing_result_method: 'opencv' renders an image; 'no' skips
        ('gmsh' GUI mode is not supported — renders instead)
      device: where the triangle classification runs ("cuda" or "cpu")
    Returns (image or None, mesh dict {'NODES','TRIANGLES','CLASS'}).
    """
    del pixel_spacing, number_of_showed_class  # recorded in contract only
    polygons = [p for p in polygons if p and p.strip()]
    outer_segment = find_outer_contour(polygons, distance_threshold)
    if outer_segment is None:
        raise MeshingError("no valid outer contour found")
    if skin_width > 0:
        outer_segment, polygons = add_skin(outer_segment, polygons, skin_width)

    # Contours participating in classification: every line except the outer
    # one, dropping degenerate (<4 point) contours (reference :49-56).
    contours: List[Tuple[int, np.ndarray]] = []
    for k, line in enumerate(polygons):
        if k == outer_segment:
            continue
        cid, pts = parse_polygon_line(line)
        if pts.shape[0] >= 4:
            contours.append((cid, pts))

    outer_cid, outer_pts = parse_polygon_line(polygons[outer_segment])
    merged = merge_collinear(
        outer_pts.ravel().tolist(), distance_threshold
    )
    outer_geo = np.array(merged, dtype=np.float64).reshape(-1, 2)

    nodes, tris = triangulate_polygon(outer_geo, lc)
    if tris.shape[0] == 0:
        raise MeshingError("triangulation produced no elements")
    elem_class = classify_triangles(
        nodes,
        tris,
        contours,
        outer_class=int(outer_cid),
        outer_poly=outer_geo,
        skin_width=skin_width,
        n_samples=classify_samples,
        bucket_contours=classify_bucket_contours,
        bucket_points=classify_bucket_points,
        device=device,
    )

    img = None
    if show_meshing_result_method in ("opencv", "gmsh"):
        img = render_mesh(nodes, tris, elem_class)
    mesh_data = export_mesh(nodes, tris, elem_class)
    if is_saving_to_file and export_filename:
        write_mesh_txt(export_filename, mesh_data)
    return img, mesh_data
