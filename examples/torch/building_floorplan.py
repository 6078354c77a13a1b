"""Mesh a building floorplan: outer wall + rooms as labelled regions.

The port's counterpart of examples/building_floorplan.py; the
classification runs on ``device`` (the card unless the caller passes
``device="cpu"``).

Run:  python examples/torch/building_floorplan.py [cuda|cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from eitx_torch.io.images import to_png_bytes  # noqa: E402
from eitx_torch.mesh import create_mesh  # noqa: E402


def rect(cid, x0, y0, x1, y1):
    pts = [(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)]
    return f"{cid} " + " ".join(f"{x} {y}" for x, y in pts)


def main(device="cuda"):
    polygons = [
        rect(4, 0, 0, 400, 300),        # outer wall (class 4)
        rect(0, 20, 20, 180, 140),      # room A
        rect(1, 200, 20, 380, 140),     # room B
        rect(2, 20, 160, 180, 280),     # room C
        rect(3, 200, 160, 380, 280),    # room D
    ]
    img, mesh = create_mesh(["1", "1"], polygons, lc=10, skin_width=0,
                            device=device)
    print(f"floorplan: {len(mesh['TRIANGLES'])} elements, "
          f"classes {sorted(set(mesh['CLASS']))}")
    with open("floorplan_mesh.png", "wb") as fh:
        fh.write(to_png_bytes(img))
    return mesh


if __name__ == "__main__":
    main(*sys.argv[1:2])
