"""Mesh + triangle classification: the port against eitx and the
real-slice goldens (tests/test_realfixture.py)."""

import collections
import os

import numpy as np
import pytest

from eitx.mesh import create_mesh as eitx_create_mesh
from eitx.mesh.classify import classify_triangles as eitx_classify
from eitx_torch.mesh import create_mesh
from eitx_torch.mesh.classify import classify_triangles
from torch_bounds import bounded

DATA = os.path.join(os.path.dirname(__file__), "data")

GOLD_NODES = 2107
GOLD_TRIS = 4041
GOLD_HIST = {0: 243, 1: 563, 2: 1669, 3: 1565, 4: 1}


def _real_polygons():
    with open(os.path.join(DATA, "real_slice_polygons.txt")) as fh:
        return [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]


def _ellipse(cid, cx, cy, rx, ry, n=80):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([cx + rx * np.cos(th), cy + ry * np.sin(th)], 1)
    return f"{cid} " + " ".join(f"{x:.1f} {y:.1f}" for x, y in pts)


def thorax_polygons():
    """The synthetic thorax of bench.py:build_thorax_mesh (copied, so the
    tests do not import the benchmark)."""
    return [
        _ellipse(4, 256, 256, 200, 150, 90),
        _ellipse(3, 256, 256, 192, 142, 70),
        _ellipse(1, 256, 256, 170, 125, 70),
        _ellipse(2, 175, 250, 55, 75, 40),
        _ellipse(2, 337, 250, 55, 75, 40),
        _ellipse(0, 256, 330, 22, 18, 24),
    ]


def test_real_slice_mesh_goldens_exact():
    _, mesh = create_mesh(
        ["1", "1"], _real_polygons(), 10, 1.3, 1, True,
        show_meshing_result_method="no", device="cpu",
    )
    assert np.asarray(mesh["NODES"]).shape == (GOLD_NODES, 2)
    assert np.asarray(mesh["TRIANGLES"]).shape == (GOLD_TRIS, 3)
    hist = dict(sorted(collections.Counter(
        np.asarray(mesh["CLASS"]).tolist()).items()))
    assert hist == GOLD_HIST


@pytest.mark.parametrize("lc", [7.0, 12.0])
def test_thorax_classes_identical_to_eitx(lc, record_property):
    _, ref = eitx_create_mesh(
        ["0.75", "0.75"], thorax_polygons(), lc=lc,
        show_meshing_result_method="no",
    )
    _, got = create_mesh(
        ["0.75", "0.75"], thorax_polygons(), lc=lc,
        show_meshing_result_method="no", device="cpu",
    )
    assert np.array_equal(got["NODES"], ref["NODES"])
    assert np.array_equal(got["TRIANGLES"], ref["TRIANGLES"])
    got_cls, ref_cls = np.asarray(got["CLASS"]), np.asarray(ref["CLASS"])
    assert got_cls.shape == ref_cls.shape
    record_property("elements", got_cls.size)
    bounded(record_property, "class_mismatches",
            (got_cls != ref_cls).sum(), "<=", 0)


def test_boundary_touch_rule_identical_to_eitx():
    """skin_width == -1 marks boundary triangles class 4
    (classify.py:_boundary_touch_kernel)."""
    _, mesh = eitx_create_mesh(
        ["0.75", "0.75"], thorax_polygons(), lc=12.0,
        show_meshing_result_method="no",
    )
    nodes = np.asarray(mesh["NODES"])
    tris = np.asarray(mesh["TRIANGLES"])
    polys = thorax_polygons()
    contours = []
    for line in polys[1:]:
        vals = np.array(line.split()[1:], float).reshape(-1, 2)
        contours.append((int(line.split()[0]), vals))
    outer = np.array(polys[0].split()[1:], float).reshape(-1, 2)
    kw = dict(outer_class=4, outer_poly=outer, skin_width=-1)
    ref = eitx_classify(nodes, tris, contours, **kw)
    got = classify_triangles(nodes, tris, contours, device="cpu", **kw)
    assert (got == 4).sum() > 0
    assert np.array_equal(got, ref)
