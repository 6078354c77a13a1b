"""The harness's thorax meshes: one padding bucket, every class, and the
reference's electrodes where the program puts them."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark.drivers.fem import subject_sizes
from benchmark.inputs.thorax import subject_pool
from benchmark.lib.manifest import Cell, manifest
from benchmark.reference import fem as ref

CELL = Cell("factory-thorax-lc7-b8", manifest())
GEOMETRY = CELL.config["geometry"]
SEEDS = (0, 2147483659, 4100000001)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_pool_falls_in_one_bucket_with_every_class(seed):
    sim = CELL.config["simulation"]
    pool = subject_pool(GEOMETRY, CELL.traffic["jitter"], 32, seed)
    buckets = set()
    for mesh in pool:
        n, e, m = subject_sizes(mesh, 2)
        buckets.add((-(-n // sim["pad_nodes_to"]),
                     -(-e // sim["pad_elems_to"]),
                     -(-m // sim["spectral_rank_bucket"])))
        assert set(np.unique(mesh["CLASS"])) == {0, 1, 2, 3, 4}
        assert len(np.unique(mesh["TRIANGLES"])) == len(mesh["NODES"])
    assert buckets == {(3, 1, 3)}  # 3,072 nodes, 8,192 elements, rank 768


def test_the_same_seed_gives_the_same_pool():
    a = subject_pool(GEOMETRY, 0.03, 2, 77)
    b = subject_pool(GEOMETRY, 0.03, 2, 77)
    for x, y in zip(a, b):
        assert np.array_equal(x["NODES"], y["NODES"])
        assert np.array_equal(x["TRIANGLES"], y["TRIANGLES"])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_places_the_programs_electrodes(seed):
    from eitx_torch.fem.electrodes import place_electrodes_equal_spacing

    for mesh in subject_pool(GEOMETRY, 0.03, 8, seed):
        a = place_electrodes_equal_spacing(mesh["NODES"], mesh["TRIANGLES"],
                                           16, math.radians(180.0))
        b = ref.electrodes(mesh["NODES"], mesh["TRIANGLES"], 16, 180.0)
        assert np.array_equal(a, b)


def test_the_reference_conductivities_are_the_programs():
    from eitx_torch.core.config import ClassMap
    from eitx_torch.physio.materials import (get_materials,
                                             tissue_conductivities)
    from eitx_torch.physio.spirometry import conductivity_schedule

    cfg = CELL.config
    got = ref.conductivities(cfg["materials"], 5e4)
    mats = get_materials()
    want = tissue_conductivities(mats, 5e4, ClassMap().id_to_name())
    for name, value in want.items():
        assert got[name] == pytest.approx(value, rel=1e-12)
    sim = dict(cfg["simulation"], **cfg["reference_only"])
    _, cond = conductivity_schedule(sim["n_spir"], sim["n_points"], 5e4, mats)
    assert np.allclose(ref.lung_schedule(sim, got), cond[:, 1], rtol=1e-12)
