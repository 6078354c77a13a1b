"""Mesh export structures and FEMM-format text interchange.

Output contracts preserved from the reference:
  - the mesh dict {'NODES': [[x,y]...], 'TRIANGLES': [[i,j,k]...] 0-based,
    'CLASS': [c...]} (export_mesh_for_femm, femm_generator.py:187-265)
  - the "# NODES / # TRIANGLES" text format with 1-based indices and the
    class id as the 4th triangle column (femm_generator.py:253-264).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def export_mesh(
    nodes: np.ndarray, tris: np.ndarray, elem_class: np.ndarray
) -> Dict:
    """Compact unused nodes and build the interchange dict.

    The reference's version scans class lists per element
    (femm_generator.py:236-239, hot loop #5); here classes are already a
    per-element array and compaction is one np.unique.
    """
    tris = np.asarray(tris, dtype=np.int64)
    nodes = np.asarray(nodes, dtype=np.float64)
    used, inverse = np.unique(tris.ravel(), return_inverse=True)
    new_tris = inverse.reshape(tris.shape)
    new_nodes = nodes[used]
    return {
        "NODES": [[float(x), float(y)] for x, y in new_nodes],
        "TRIANGLES": [[int(a), int(b), int(c)] for a, b, c in new_tris],
        "CLASS": [int(c) for c in np.asarray(elem_class)],
    }


def write_mesh_txt(filename: str, mesh_data: Dict) -> None:
    """FEMM-format text file (1-based node ids, 12-decimal coordinates)."""
    with open(filename, "w") as f:
        f.write("# NODES\n")
        for i, (x, y) in enumerate(mesh_data["NODES"], start=1):
            f.write(f"{i} {x:.12f} {y:.12f}\n")
        f.write("\n# TRIANGLES\n")
        for (a, b, c), cid in zip(mesh_data["TRIANGLES"], mesh_data["CLASS"]):
            f.write(f"{a + 1} {b + 1} {c + 1} {cid}\n")


def read_mesh_txt(filename: str) -> Dict:
    """Inverse of write_mesh_txt."""
    nodes, tris, cls = [], [], []
    key = ""
    with open(filename) as fh:
        for line in fh:
            if not line.strip():
                continue
            s = line.strip().split(" ")
            if "#" in line:
                key = line.strip()[2:]
            elif key == "NODES":
                nodes.append([float(s[1]), float(s[2])])
            elif key == "TRIANGLES":
                tris.append([int(s[0]) - 1, int(s[1]) - 1, int(s[2]) - 1])
                cls.append(int(float(s[-1])))
    return {"NODES": nodes, "TRIANGLES": tris, "CLASS": cls}
