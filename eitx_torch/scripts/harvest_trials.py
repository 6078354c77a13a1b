"""Harvest the reference's embedded patient-derived trial geometries.

Port of eitx/scripts/harvest_trials.py. The reference ships SIX full
segmented-slice polygon datasets as its mesh-trials fixtures
(`mesh_service_trials.py:10-322`, `test_list1..6`). This script lifts
lists 2-6 into `tests/data/geometries/trial{2..6}.txt` (list 1 is
`tests/data/real_slice_polygons.txt`), so the OOD eval can score every
real-derived anatomy. The committed files came from eitx's run; this one
writes the same bytes from the same source file.

Class-ID reconciliation (the reference's documented inconsistency): the
segmentation side uses 0=bone 1=muscles 2=lung 3=adipose, femm_tools
{0:bone, 1:muscles, 2:fat, 3:lung}.
- test_list1: seg mapping.
- test_list2..5: femm mapping (the 85k-px body polygon is class 2, the
  two ~20k-px lungs class 3): harvesting SWAPS 2<->3.
- test_list6: seg mapping plus a class-4 body/skin contour, kept as-is.

Lists 2-5 are four processing variants of ONE anatomy: 3 distinct
anatomies across 6 geometry files.

Usage (the reference's checkout must be at hand; numpy only, no device):
    python -m eitx_torch.scripts.harvest_trials [SOURCE] [--out DIR]
SOURCE defaults to the reference's file inside its checkout,
``kt_service/ai_tools/mesh_tools/mesh_service_trials.py``, relative to the
working directory.
"""

from __future__ import annotations

import argparse
import ast
import os

import numpy as np

SOURCE = "kt_service/ai_tools/mesh_tools/mesh_service_trials.py"
_OUT = os.path.join(
    os.path.dirname(__file__), "..", "..", "tests", "data", "geometries"
)
# femm_tools class ids -> canonical segmentation ids (2<->3 swap)
_FEMM_TO_SEG = {0: 0, 1: 1, 2: 3, 3: 2, 4: 4}
# test_list indices that use the femm mapping (2..5)
_FEMM_MAPPED = {2, 3, 4, 5}


def _extract_lists(path: str = SOURCE):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    lists = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.startswith("test_list")
        ):
            lists[int(node.targets[0].id[len("test_list"):])] = [
                ast.literal_eval(e) for e in node.value.elts
            ]
    return lists


def main(source: str = SOURCE, out_dir: str = _OUT) -> list:
    """Write trial{n}.txt for every test_list n > 1 of ``source``; the
    header names ``source`` as the file read. Returns the paths."""
    lists = _extract_lists(source)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for n in sorted(lists):
        if n == 1:
            continue  # already tests/data/real_slice_polygons.txt
        out = os.path.join(out_dir, f"trial{n}.txt")
        with open(out, "w") as fh:
            fh.write(
                "# Patient-derived segmented-slice polygons, harvested from\n"
                "# the reference's embedded mesh-trials fixtures:\n"
                f"# mesh_service_trials.py test_list{n} "
                f"({source}:10-322).\n"
                "# Classes remapped to the canonical segmentation ids\n"
                "# 0=bone 1=muscles 2=lung 3=fat 4=body "
                f"({'femm-mapping source: 2<->3 swapped' if n in _FEMM_MAPPED else 'already seg-mapped'}).\n"
                "# One polygon per line: '<class> x1 y1 x2 y2 ...'.\n"
            )
            for s in lists[n]:
                parts = s.split()
                cid = int(float(parts[0]))
                xy = np.asarray(parts[1:], float)
                cid = _FEMM_TO_SEG[cid] if n in _FEMM_MAPPED else cid
                fh.write(
                    f"{cid} " + " ".join(f"{v:g}" for v in xy) + "\n"
                )
        print("wrote", out, len(lists[n]), "polygons")
        written.append(out)
    return written


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="harvest the trial geometries")
    p.add_argument("source", nargs="?", default=SOURCE)
    p.add_argument("--out", default=_OUT)
    args = p.parse_args()
    main(args.source, args.out)
