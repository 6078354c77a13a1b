"""Point-in-polygon: the port's plain version and wrapper against eitx.
The CUDA kernel itself is tested on the card in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eitx.mesh.classify import _points_in_polys
from eitx.mesh.pallas_pip import points_in_polys_pallas
from eitx_torch.mesh import pip
from torch_bounds import bounded


def _square_and_triangle():
    sq = np.array([[10, 10], [90, 10], [90, 90], [10, 90]], float)
    tri = np.array([[120, 20], [180, 20], [150, 80]], float)
    polys = np.zeros((2, 8, 2))
    polys[0, :4] = sq
    polys[0, 4:] = sq[-1]
    polys[1, :3] = tri
    polys[1, 3:] = tri[-1]
    return polys


KNOWN_PTS = np.array([[5.0, 5.0], [15.0, 5.0], [-1.0, 3.0], [9.9, 9.9]])
KNOWN_SQ = np.array([[[0, 0], [10, 0], [10, 10], [0, 10]]], float)


@pytest.mark.parametrize("reference", ["pallas_interpret", "jnp"])
def test_plain_version_matches_eitx_on_random_points(reference, record_property):
    rng = np.random.default_rng(0)
    polys = _square_and_triangle()
    pts = rng.uniform(0, 200, (3000, 2))
    pj, qj = jnp.asarray(pts, jnp.float32), jnp.asarray(polys, jnp.float32)
    if reference == "jnp":
        ref = np.asarray(_points_in_polys(pj, qj))
    else:
        ref = np.asarray(points_in_polys_pallas(pj, qj, interpret=True))
    got = pip.points_in_polys_ref(
        torch.as_tensor(pts, dtype=torch.float32),
        torch.as_tensor(polys, dtype=torch.float32),
    ).numpy()
    assert got.shape == ref.shape
    record_property("differing", int((got != ref).sum()))
    # the reference's own bar: edge-grazing points may differ
    bounded(record_property, "agreement", (got == ref).mean(), ">=", 0.999)


def test_plain_version_known_points_exact():
    got = pip.points_in_polys_ref(
        torch.as_tensor(KNOWN_PTS, dtype=torch.float32),
        torch.as_tensor(KNOWN_SQ, dtype=torch.float32),
    )[:, 0]
    assert got.tolist() == [True, False, False, True]


def test_plain_version_chunking_is_invisible():
    rng = np.random.default_rng(3)
    polys = torch.as_tensor(_square_and_triangle(), dtype=torch.float32)
    pts = torch.as_tensor(rng.uniform(0, 200, (777, 2)), dtype=torch.float32)
    whole = pip.points_in_polys_ref(pts, polys)
    pieces = pip.points_in_polys_ref(pts, polys, chunk_elems=5 * 16)
    assert torch.equal(whole, pieces)


def test_wrapper_sends_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(1)
    polys = torch.as_tensor(_square_and_triangle(), dtype=torch.float32)
    pts = torch.as_tensor(rng.uniform(0, 200, (500, 2)), dtype=torch.float32)
    before = pip.pip_launches
    got = pip.points_in_polys(pts, polys)
    assert pip.pip_launches == before  # no kernel launch for CPU tensors
    assert torch.equal(got, pip.points_in_polys_ref(pts, polys))


@pytest.mark.parametrize("bad", ["dtype", "points_shape", "polys_shape",
                                 "mixed_devices", "other_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    pts = torch.zeros((4, 2), dtype=torch.float32)
    polys = torch.zeros((1, 4, 2), dtype=torch.float32)
    if bad == "dtype":
        pts = pts.double()
    elif bad == "points_shape":
        pts = torch.zeros((4, 3), dtype=torch.float32)
    elif bad == "polys_shape":
        polys = torch.zeros((4, 2), dtype=torch.float32)
    elif bad == "mixed_devices":
        polys = polys.to("meta")
    else:  # neither the CPU nor a CUDA device
        pts, polys = pts.to("meta"), polys.to("meta")
    with pytest.raises((TypeError, ValueError)):
        pip.points_in_polys(pts, polys)
