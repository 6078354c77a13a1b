"""End-to-end EIT dataset generation from polygon contours, on the port.

The port's counterpart of examples/eit_monitoring.py: tissue-classified
mesh -> batched forward solves over a breathing cycle -> voltage dataset
-> difference images and GREIT pixel images -> three subjects through the
batched setup. Everything runs on ``device`` (the card unless the caller
passes ``device="cpu"``).

Run:  python examples/torch/eit_monitoring.py [out_dir] [cuda|cpu]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from eitx_torch.core.config import SimulationConfig  # noqa: E402
from eitx_torch.fem import (  # noqa: E402
    greit_monitoring,
    reconstruct_monitoring,
    simulate_eit_monitoring,
    simulate_eit_monitoring_subjects,
)
from eitx_torch.io.images import to_png_bytes  # noqa: E402
from eitx_torch.mesh import create_mesh  # noqa: E402


def ellipse(cid, cx, cy, rx, ry, n=60, phase=0.0):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False) + phase
    pts = np.stack([cx + rx * np.cos(th), cy + ry * np.sin(th)], 1)
    return f"{cid} " + " ".join(f"{x:.1f} {y:.1f}" for x, y in pts)


def thorax_polygons(jitter=0.0):
    """A thorax-like tissue layout: class ids 0=bone 1=muscles 2=lung
    3=fat 4=body/skin (core ClassMap convention)."""
    j = jitter
    return [
        ellipse(4, 256, 256, 200 + j, 150 - j, 90),
        ellipse(3, 256, 256, 192 + j, 142 - j, 70),
        ellipse(1, 256, 256, 170 + j, 125, 70),
        ellipse(2, 175 - j, 250, 55, 75 + j, 40),
        ellipse(2, 337 + j, 250, 55, 75 + j, 40),
        ellipse(0, 256, 330, 22, 18, 24),
    ]


def main(out_dir=".", lc=7.0, n_points=100, device="cuda"):
    # 1. polygons -> classified triangle mesh (lc controls element size)
    t0 = time.time()
    _, mesh = create_mesh(
        ["0.75", "0.75"], thorax_polygons(), lc=lc, skin_width=1,
        show_meshing_result_method="no", device=device,
    )
    print(f"mesh: {len(mesh['TRIANGLES'])} elements "
          f"({time.time() - t0:.1f}s)")

    # 2. one breathing minute, n_points frames per inspiration, 16
    #    electrodes, adjacent Sheffield protocol
    cfg = SimulationConfig(n_points=n_points)
    v, dt = simulate_eit_monitoring(
        mesh, cfg, save_to_file=True, filename=f"{out_dir}/monitoring.dat",
        device=device,
    )
    print(f"voltages: {v.shape} in {dt:.2f}s "
          f"(breathing modulation std {v.std(axis=0).mean():.2e})")

    # 3. difference imaging: the lung conductivity change between
    #    expiration and inspiration frames, per element
    dsigma, _ = reconstruct_monitoring(mesh, v, cfg=cfg, device=device)
    print(f"reconstruction: {dsigma.shape} element-space difference images")

    # 3b. GREIT: one matrix, then a product per frame; the monitoring is
    #     saved as a grayscale image strip
    imgs, _ = greit_monitoring(mesh, v, cfg=cfg, device=device)
    strip = np.concatenate(list(imgs[:: max(1, len(imgs) // 8)][:8]), axis=1)
    lim = max(float(np.abs(strip).max()), 1e-12)
    strip8 = ((strip / lim) * 127.5 + 127.5).astype(np.uint8)
    with open(f"{out_dir}/greit_strip.png", "wb") as fh:
        fh.write(to_png_bytes(np.repeat(strip8[..., None], 3, axis=-1)))
    print(f"GREIT: {imgs.shape} pixel-space images -> greit_strip.png")

    # 4. many subjects through the same API; subjects of one node bucket
    #    share one batched low-rank spectral setup
    subjects = [
        create_mesh(["0.75", "0.75"], thorax_polygons(jitter=g), lc=lc,
                    skin_width=1, show_meshing_result_method="no",
                    device=device)[1]
        for g in (0.0, 4.0, 8.0)
    ]
    t0 = time.time()
    results = simulate_eit_monitoring_subjects(subjects, cfg, device=device)
    per = (time.time() - t0) / len(results)
    print(f"{len(results)} subjects in {time.time() - t0:.2f}s "
          f"({per:.2f}s/subject incl. setup)")
    return v, dsigma


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".",
         device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
