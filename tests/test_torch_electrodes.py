"""The port's boundary loop and electrode placement
(``eitx_torch/fem/electrodes.py``) held to eitx's, array for array and
error for error: jittered thorax subjects (the benchmark's pool and the
port's mesher), a disk, an annulus whose hole is ignored, two triangles
that share one vertex, and the patient-derived slice with its pinch node.
The errors keep their words: a disconnected triangulation, an empty one,
and a pinch in strict manifold mode."""

import functools
import json
import math
import os

import numpy as np
import pytest

from eitx.fem import electrodes as ref
from eitx_torch.fem import electrodes as port
from meshfix import disk_mesh

DATA = os.path.join(os.path.dirname(__file__), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (seed, index) of the benchmark's thorax pool; one seed past 32 bits
POOL = [(0, 0), (0, 1), (2147483659, 0), (2147483659, 5)]


def _pool_subject(seed, index):
    from benchmark.inputs.thorax import subject_pool

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "thorax-lc7-e16.json")) as fh:
        geometry = json.load(fh)["geometry"]
    m = subject_pool(geometry, 0.03, index + 1, seed)[index]
    return m["NODES"], m["TRIANGLES"]


def _pool_subject_int32():
    nodes, tris = _pool_subject(1, 3)
    return nodes, tris.astype(np.int32)


def _annulus():
    """The disk with every element inside radius 0.4 taken out: the
    nodes there stay, unused, and the hole is a second boundary loop."""
    nodes, tris = disk_mesh(48, 6)
    r = np.linalg.norm(nodes[tris].mean(axis=1), axis=1)
    return nodes, tris[r > 0.4]


def _bowtie():
    """Two triangles that share node 2 and nothing else: connected, with
    a pinch of four boundary neighbours."""
    nodes = np.array([[0.0, 0.0], [2.0, 0.0], [1.0, 1.0], [0.0, 2.0],
                      [2.0, 2.0]])
    return nodes, np.array([[0, 1, 2], [2, 4, 3]], np.int64)


def _real_slice():
    from eitx_torch.mesh import create_mesh

    with open(os.path.join(DATA, "real_slice_polygons.txt")) as fh:
        polygons = [ln.strip() for ln in fh
                    if ln.strip() and not ln.startswith("#")]
    _, mesh = create_mesh(["1", "1"], polygons, 10, 1.3, 1, True,
                          show_meshing_result_method="no", device="cpu")
    return mesh["NODES"], mesh["TRIANGLES"]


def _mesher_thorax():
    from eitx_torch.scripts.profile_setup import thorax_mesh

    m = thorax_mesh(lc=7.0, jitter=0.03, seed=1, device="cpu")
    return m["NODES"], m["TRIANGLES"]


MESHES = {
    **{f"thorax-pool-{s}-{i}": functools.partial(_pool_subject, s, i)
       for s, i in POOL},
    "thorax-pool-int32": _pool_subject_int32,
    "thorax-mesher": _mesher_thorax,
    "disk": lambda: disk_mesh(48, 6),
    "annulus": _annulus,
    "bowtie": _bowtie,
    "real-slice": _real_slice,
}


@functools.lru_cache(maxsize=None)
def _mesh(name):
    nodes, tris = MESHES[name]()
    return np.asarray(nodes, np.float64), np.asarray(tris)


def _outcome(fn, *args, **kwargs):
    """The array ``fn`` returns, or the name and words of what it raises
    (the two packages' MeshingError are different classes)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return (type(e).__name__, str(e))


def _assert_same(got, want):
    if isinstance(want, tuple) or isinstance(got, tuple):
        assert got == want
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(MESHES))
def test_outer_loop_matches_eitx(name):
    nodes, tris = _mesh(name)
    want = ref.boundary_loop(tris, nodes)
    got = port.boundary_loop(tris, nodes)
    _assert_same(got, want)
    assert got.shape[0] >= 3


@pytest.mark.parametrize("name", list(MESHES))
def test_strict_loop_matches_eitx(name):
    nodes, tris = _mesh(name)
    _assert_same(_outcome(port.boundary_loop, tris),
                 _outcome(ref.boundary_loop, tris))


@pytest.mark.parametrize("n_electrodes,offset", [(16, 0.0), (8, 0.5)])
@pytest.mark.parametrize("name", list(MESHES))
def test_electrodes_match_eitx(name, n_electrodes, offset):
    nodes, tris = _mesh(name)
    args = (nodes, tris, n_electrodes, math.pi, offset)
    _assert_same(_outcome(port.place_electrodes_equal_spacing, *args),
                 _outcome(ref.place_electrodes_equal_spacing, *args))


def test_annulus_returns_the_outer_loop():
    nodes, tris = _mesh("annulus")
    loop = port.boundary_loop(tris, nodes)
    np.testing.assert_allclose(np.linalg.norm(nodes[loop], axis=1), 1.0)
    assert loop.shape[0] == np.unique(loop).shape[0] == 48


def test_pinch_is_visited_once_per_pass():
    nodes, tris = _mesh("bowtie")
    loop = port.boundary_loop(tris, nodes)
    assert sorted(loop.tolist()) == [0, 1, 2, 2, 3, 4]


@pytest.mark.parametrize("mod", [ref, port], ids=["eitx", "port"])
def test_two_fragments_are_refused(mod):
    nodes, tris = disk_mesh(24, 3)
    far = nodes + np.array([5.0, 0.0])
    both_nodes = np.concatenate([nodes, far])
    both_tris = np.concatenate([tris, tris + nodes.shape[0]])
    with pytest.raises(mod.MeshingError,
                       match="mesh has 2 disconnected components"):
        mod.boundary_loop(both_tris, both_nodes)
    with pytest.raises(mod.MeshingError, match="disconnected"):
        mod.place_electrodes_equal_spacing(both_nodes, both_tris, 16)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("with_nodes", [True, False])
@pytest.mark.parametrize("mod", [ref, port], ids=["eitx", "port"])
def test_empty_mesh_has_no_boundary(mod, with_nodes, dtype):
    tris = np.zeros((0, 3), dtype)
    nodes = np.zeros((0, 2)) if with_nodes else None
    with pytest.raises(mod.MeshingError, match="mesh has no boundary edges"):
        mod.boundary_loop(tris, nodes)


@pytest.mark.parametrize("with_nodes", [True, False])
@pytest.mark.parametrize("tris", [[], np.zeros(0, np.int64),
                                  np.zeros((0, 3), np.int32)],
                         ids=["list", "flat", "rows"])
def test_empty_input_fails_as_eitx(tris, with_nodes):
    """An empty or flat triangle array fails with eitx's exception and
    words (a flat one is an IndexError, as the batch manifest records)."""
    nodes = np.zeros((0, 2)) if with_nodes else None
    _assert_same(_outcome(port.boundary_loop, tris, nodes),
                 _outcome(ref.boundary_loop, tris, nodes))


@pytest.mark.parametrize("name", ["bowtie", "real-slice"])
@pytest.mark.parametrize("mod", [ref, port], ids=["eitx", "port"])
def test_strict_mode_refuses_a_pinch(mod, name):
    _, tris = _mesh(name)
    with pytest.raises(mod.MeshingError, match="non-manifold boundary"):
        mod.boundary_loop(tris)
