"""Generate the muscle/fat dielectric CSV tables into eitx_torch/data.

Port of eitx/scripts/gen_materials.py. The reference ships muscles_c/fat_c
(conductivity) and *_p (permittivity) CSVs; these are generated from the
Gabriel Cole-Cole parametric model (eitx_torch.physio.materials), so the
shipped files are reproducible data, not copies. numpy only (no device):
the same bytes as eitx's. Run: python -m eitx_torch.scripts.gen_materials
"""

from __future__ import annotations

import os

from ..physio.materials import generate_material_tables

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


def main(out_dir: str = DATA_DIR) -> list:
    os.makedirs(out_dir, exist_ok=True)
    mats = generate_material_tables(points_per_decade=20)
    written = []
    for mat in ("muscles", "fat"):
        for param, letter in (("cond", "c"), ("perm", "p")):
            path = os.path.join(out_dir, f"{mat}_{letter}.csv")
            with open(path, "w") as fh:
                for f, v in mats[mat][param]:
                    fh.write(f"{f:.10g},{v:.10g}\n")
            written.append(path)
    return written


if __name__ == "__main__":
    for p in main():
        print(p)
