"""Generative-art panel: spiral blobs inside a rounded frame.

The port's counterpart of examples/spiral_art.py; the classification runs
on ``device`` (the card unless the caller passes ``device="cpu"``).

Run:  python examples/torch/spiral_art.py [cuda|cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from eitx_torch.io.images import to_png_bytes  # noqa: E402
from eitx_torch.mesh import create_mesh  # noqa: E402


def blob(cid, cx, cy, r, n=36, wobble=0.25, seed=0):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rr = r * (1 + wobble * np.sin(3 * th + rng.uniform(0, 6)))
    pts = np.stack([cx + rr * np.cos(th), cy + rr * np.sin(th)], 1)
    return f"{cid} " + " ".join(f"{x:.2f} {y:.2f}" for x, y in pts)


def main(device="cuda"):
    th = np.linspace(0, 2 * np.pi, 72, endpoint=False)
    frame = np.stack([250 + 230 * np.cos(th), 250 + 230 * np.sin(th)], 1)
    polygons = ["4 " + " ".join(f"{x:.1f} {y:.1f}" for x, y in frame)]
    t = np.linspace(0, 4 * np.pi, 14)
    for i, a in enumerate(t):
        r = 30 + 45 * a / (4 * np.pi)
        cx = 250 + r * 3.2 * np.cos(a) / 3.2
        cy = 250 + r * 3.2 * np.sin(a) / 3.2
        polygons.append(blob(i % 4, cx, cy, 18 + 2 * (i % 3), seed=i))
    img, mesh = create_mesh(["1", "1"], polygons, lc=9, skin_width=0,
                            device=device)
    print(f"spiral: {len(mesh['TRIANGLES'])} elements")
    with open("spiral_mesh.png", "wb") as fh:
        fh.write(to_png_bytes(img))
    return mesh


if __name__ == "__main__":
    main(*sys.argv[1:2])
