"""Mechanical section: gear outline with hub and bolt holes as regions.

The port's counterpart of examples/gear_section.py; the classification
runs on ``device`` (the card unless the caller passes ``device="cpu"``).

Run:  python examples/torch/gear_section.py [cuda|cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from eitx_torch.io.images import to_png_bytes  # noqa: E402
from eitx_torch.mesh import create_mesh  # noqa: E402


def gear_outline(cx, cy, r, teeth=12, depth=0.15, n_per_tooth=10):
    th = np.linspace(0, 2 * np.pi, teeth * n_per_tooth, endpoint=False)
    rr = r * (1 + depth * (np.cos(teeth * th) > 0).astype(float) * 0.5)
    return np.stack([cx + rr * np.cos(th), cy + rr * np.sin(th)], 1)


def circle(cid, cx, cy, r, n=32):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)
    return f"{cid} " + " ".join(f"{x:.2f} {y:.2f}" for x, y in pts)


def main(device="cuda"):
    outline = gear_outline(250, 250, 180)
    polygons = ["4 " + " ".join(f"{x:.2f} {y:.2f}" for x, y in outline)]
    polygons.append(circle(0, 250, 250, 55))  # hub
    for k in range(6):  # bolt circle
        a = 2 * np.pi * k / 6
        polygons.append(circle(2, 250 + 110 * np.cos(a),
                               250 + 110 * np.sin(a), 16))
    img, mesh = create_mesh(["1", "1"], polygons, lc=8, skin_width=0,
                            device=device)
    print(f"gear: {len(mesh['TRIANGLES'])} elements, "
          f"classes {sorted(set(mesh['CLASS']))}")
    with open("gear_mesh.png", "wb") as fh:
        fh.write(to_png_bytes(img))
    return mesh


if __name__ == "__main__":
    main(*sys.argv[1:2])
