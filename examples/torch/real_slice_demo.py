"""EIT dataset from the reference's embedded patient-derived slice, on the
port.

The port's counterpart of examples/real_slice_demo.py: the polygon set of
tests/data/real_slice_polygons.txt -> triangulation -> tissue
classification -> electrode placement -> spectral forward solve over a
breathing cycle -> .dat dataset, and a render of the classified mesh.
Everything runs on ``device`` (the card unless the caller passes
``device="cpu"``).

Usage:  python examples/torch/real_slice_demo.py [out_dir] [lc] [cuda|cpu]
"""

from __future__ import annotations

import collections
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)


def load_fixture_polygons() -> list:
    path = os.path.join(ROOT, "tests", "data", "real_slice_polygons.txt")
    with open(path) as fh:
        return [
            ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")
        ]


def main(out_dir: str = ".", lc: float = 10.0, n_points: int = 20,
         device="cuda"):
    from PIL import Image

    from eitx_torch.core.config import SimulationConfig
    from eitx_torch.fem.forward import simulate_eit_monitoring
    from eitx_torch.mesh.api import create_mesh
    from eitx_torch.mesh.render import render_mesh

    polygons = load_fixture_polygons()
    t0 = time.time()
    _, mesh = create_mesh(
        ["1", "1"], polygons, lc, 1.3, 1, True,
        show_meshing_result_method="no", device=device,
    )
    cls = np.asarray(mesh["CLASS"])
    hist = dict(sorted(collections.Counter(cls.tolist()).items()))
    print(
        f"mesh: {len(mesh['NODES'])} nodes, {len(mesh['TRIANGLES'])} "
        f"elements in {time.time() - t0:.1f}s; class histogram {hist}"
    )

    img = render_mesh(
        np.asarray(mesh["NODES"]), np.asarray(mesh["TRIANGLES"]), cls
    )
    png = os.path.join(out_dir, "real_slice_mesh.png")
    Image.fromarray(img).save(png)
    print("mesh render ->", png)

    cfg = SimulationConfig(n_points=n_points, n_spir=1, n_minutes=1)
    dat = os.path.join(out_dir, "real_slice_dataset.dat")
    t0 = time.time()
    v, _ = simulate_eit_monitoring(
        mesh, cfg, save_to_file=True, filename=dat, device=device
    )
    v = np.asarray(v)
    print(
        f"EIT dataset: {v.shape[0]} frames x {v.shape[1]} measurements "
        f"in {time.time() - t0:.1f}s -> {dat}"
    )
    print(
        "breathing modulation std (mean over channels): "
        f"{float(v.std(axis=0).mean()):.5f}"
    )
    print("REAL_SLICE_DEMO_OK")
    return v, mesh


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "."
    lc = float(sys.argv[2]) if len(sys.argv) > 2 else 10.0
    main(out, lc, device=sys.argv[3] if len(sys.argv) > 3 else "cuda")
