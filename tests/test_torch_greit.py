"""GREIT of the port against eitx on the CPU: the pixel grid and the
containment mask (equal), the trained matrix and monitoring images
(bounded), the figures of merit, the equal-area median and the .npz files
of both packages. Each comparison records its measured error beside its
bound (tests/torch_bounds.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import Delaunay

import eitx.fem.greit as eitx_greit
import eitx_torch.fem.greit as port_greit
from eitx.core.config import SimulationConfig as EitxSimulationConfig
from eitx.fem import create_protocol, place_electrodes_equal_spacing
from eitx.fem.oracle import forward_solve_oracle
from eitx_torch.core.config import SimulationConfig
from eitx_torch.fem import (
    GreitImager,
    greit_monitoring,
    simulate_eit_monitoring,
)
from meshfix import disk_mesh, disk_mesh_with_classes
from torch_bounds import bounded

CPU = "cpu"
PROTO = create_protocol(16, 1, 1, "std")


def _rel_to_max(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _meshes():
    """The disks of tests/test_inverse.py (unit and scaled by 100, moved),
    seeded Delaunay meshes of random scale and a lattice whose diagonals
    pass through pixel centres."""
    rng = np.random.default_rng(3)
    out = [disk_mesh(40, 5), disk_mesh(48, 7)]
    nodes, tris = disk_mesh(48, 6)
    out.append((nodes * 100.0 + np.array([3.3, -7.1]), tris))
    for _ in range(3):
        pts = rng.uniform(-1, 1, (80, 2)) * rng.uniform(1, 300)
        out.append((pts, Delaunay(pts).simplices.astype(np.int64)))
    lattice = np.stack(np.meshgrid(np.arange(9.0), np.arange(9.0)),
                       -1).reshape(-1, 2) * 4.0
    out.append((lattice, Delaunay(lattice).simplices.astype(np.int64)))
    return out


MESHES = _meshes()


@pytest.mark.parametrize("k", range(len(MESHES)))
@pytest.mark.parametrize("npx", [32, 64])
def test_pixel_grid_and_mask_equal_eitx(k, npx):
    nodes, tris = MESHES[k]
    (xmin, ymin), (xmax, ymax) = nodes.min(0), nodes.max(0)
    grid = []
    for lo, hi in ((xmin, xmax), (ymin, ymax)):
        want = np.asarray(jnp.linspace(lo, hi, npx + 1)[:-1]
                          + (hi - lo) / (2 * npx))
        got = port_greit._pixel_centres(lo, hi, npx)
        assert got.dtype == np.float32
        assert np.array_equal(got, want)
        grid.append(got)
    xs, ys = grid
    want = np.asarray(eitx_greit._pixels_inside(
        jnp.asarray(nodes, jnp.float32), jnp.asarray(tris, jnp.int32),
        jnp.asarray(xs), jnp.asarray(ys), npx))
    got = port_greit._pixels_inside(
        torch.tensor(nodes, dtype=torch.float32), torch.tensor(tris),
        torch.from_numpy(xs), torch.from_numpy(ys), npx).numpy()
    assert want.any() and np.array_equal(got, want)


@pytest.mark.parametrize("m_real", [None, 6, 7])
def test_equal_area_median_is_jnp_median(m_real):
    """With padding the median is of the real prefix; for an even count the
    two middle values are averaged (torch.median would take the lower)."""
    area = np.array([3.0, 0.5, 2.0, 9.0, 4.0, 1.0, 7.0, 0.0, 0.0, 0.0],
                    np.float32)
    real = area if m_real is None else np.sort(area)[::-1][:m_real]
    got = port_greit._equal_area_median(torch.from_numpy(area), m_real)
    assert float(got) == float(jnp.median(jnp.asarray(real)))
    if m_real == 6:
        assert float(got) == 3.5  # (4 + 3) / 2, not the lower 3


def test_train_matrix_median_matches_eitx(record_property):
    """_train_matrix of both packages on the same seeded inputs with an
    even count of real elements ahead of zero-area padding."""
    rng = np.random.default_rng(2)
    m, m_real, npx = 40, 30, 8
    jac = rng.standard_normal((12, m)).astype(np.float32)
    jac[:, m_real:] = 0.0
    area = np.concatenate([rng.uniform(0.5, 2.0, m_real),
                           np.zeros(m - m_real)]).astype(np.float32)
    cent = rng.uniform(-1, 1, (m, 2)).astype(np.float32)
    xs = port_greit._pixel_centres(-1.0, 1.0, npx)
    want = np.asarray(eitx_greit._train_matrix(
        jnp.asarray(jac), jnp.asarray(cent), jnp.asarray(area),
        jnp.asarray(xs), jnp.asarray(xs), jnp.float32(0.3), jnp.float32(0.05),
        npx, m_real))
    got = port_greit._train_matrix(
        torch.from_numpy(jac), torch.from_numpy(cent), torch.from_numpy(area),
        torch.from_numpy(xs), torch.from_numpy(xs), np.float32(0.3), 0.05,
        npx, m_real).numpy()
    # measured 4.6e-7 of scale: the same solve in another LAPACK
    bounded(record_property, "rel_to_max", _rel_to_max(got, want), "<=",
            5e-6)


@pytest.fixture(scope="module")
def imagers():
    """One disk imager of each package at GREIT's defaults (npx 32, pads
    1024 / 8192), and the voltages of a +50 % inclusion."""
    nodes, tris = disk_mesh(40, 5)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    sigma0 = np.full(tris.shape[0], 0.3)
    cent = nodes[tris].mean(axis=1)
    target = np.array([0.35, 0.2])
    sigma1 = sigma0.copy()
    sigma1[np.linalg.norm(cent - target, axis=1) < 0.25] = 0.45
    v0, v1 = (forward_solve_oracle(nodes, tris, s, el, PROTO.ex_mat,
                                   PROTO.meas_mat).ravel()
              for s in (sigma0, sigma1))
    args = (nodes, tris, sigma0, el, PROTO.ex_mat, PROTO.meas_mat)
    ref = eitx_greit.GreitImager.build(*args)
    port = GreitImager.build(*args, device=CPU)
    return ref, port, v1 - v0, target


def test_greit_build_matches_eitx(imagers, record_property):
    ref, port, dv, _ = imagers
    assert port.npx == ref.npx == 32 and port.extent == ref.extent
    assert np.array_equal(port.mask, ref.mask)
    assert port.R.device.type == CPU and port.R.shape == (1024, 208)
    # measured 3.3e-5 of scale: the float32 Jacobians (tests/
    # test_torch_inverse.py) through the 208^2 train solve; the inclusion's
    # image 2.1e-6
    bounded(record_property, "R rel_to_max",
            _rel_to_max(port.R.numpy(), np.asarray(ref.R)), "<=", 3e-4)
    got, want = port.reconstruct(dv), ref.reconstruct(dv)
    assert got.shape == (32, 32) and (got[~port.mask] == 0).all()
    bounded(record_property, "image rel_to_max", _rel_to_max(got, want),
            "<=", 3e-5)


def test_figures_of_merit_equal_eitx(imagers):
    ref, port, dv, target = imagers
    img = ref.reconstruct(dv)
    want = eitx_greit.figures_of_merit(img, ref, target)
    assert port_greit.figures_of_merit(img, port, target) == want
    assert want["pe"] < 0.22 and want["ar"] > 0


def test_npz_files_load_across_packages(imagers, tmp_path):
    ref, port, _, _ = imagers
    ref.save(str(tmp_path / "eitx.npz"))
    port.save(str(tmp_path / "port.npz"))
    got = GreitImager.load(str(tmp_path / "eitx.npz"), device=CPU)
    assert np.array_equal(got.R.numpy(), np.asarray(ref.R))
    assert got.R.dtype == torch.float32
    back = eitx_greit.GreitImager.load(str(tmp_path / "port.npz"))
    assert np.array_equal(np.asarray(back.R), port.R.numpy())
    for a, b in ((got, ref), (back, port)):
        assert np.array_equal(a.mask, b.mask)
        assert a.extent == b.extent and a.npx == b.npx
    with np.load(str(tmp_path / "port.npz")) as z:
        assert sorted(z.files) == ["R", "extent", "mask", "npx"]
    dv = np.random.default_rng(1).standard_normal((3, 208)).astype(np.float32)
    # a round trip through the file images as the imager it was saved from
    again = GreitImager.load(str(tmp_path / "port.npz"), device=CPU)
    assert np.array_equal(again.reconstruct(dv), port.reconstruct(dv))


def test_greit_monitoring_matches_eitx(record_property):
    nodes, tris, cls = disk_mesh_with_classes(48, 6)
    mesh = {"NODES": nodes * 100.0, "TRIANGLES": tris, "CLASS": cls}
    kw = dict(n_points=8, pad_nodes_to=256, pad_elems_to=512)
    v, _ = simulate_eit_monitoring(mesh, SimulationConfig(**kw), device=CPU)
    want, ref = eitx_greit.greit_monitoring(mesh, v,
                                            cfg=EitxSimulationConfig(**kw))
    got, imager = greit_monitoring(mesh, v, cfg=SimulationConfig(**kw),
                                   device=CPU)
    assert got.shape == (8, 32, 32) and np.isfinite(got).all()
    assert np.array_equal(imager.mask, ref.mask)
    # measured 1.9e-5 of scale
    bounded(record_property, "images rel_to_max",
            _rel_to_max(got, np.asarray(want)), "<=", 2e-4)
    # the lung pixels modulate more than the rest (tests/test_inverse.py)
    cent = (nodes * 100.0)[tris].mean(axis=1)
    xmin, xmax, ymin, ymax = imager.extent
    ix = np.clip(((cent[:, 0] - xmin) / (xmax - xmin) * 32).astype(int), 0,
                 31)
    iy = np.clip(((cent[:, 1] - ymin) / (ymax - ymin) * 32).astype(int), 0,
                 31)
    lungpix = np.zeros((32, 32), bool)
    lungpix[iy[cls == 2], ix[cls == 2]] = True
    var = got.var(axis=0)
    assert var[lungpix].mean() > var[imager.mask & ~lungpix].mean()
