"""Inverse imaging of the port against eitx on the CPU: the adjoint
Jacobian (unpadded and with a padded node tail), difference imaging,
monitoring reconstruction and absolute Gauss-Newton. Same seeded inputs
through both packages; each comparison records its measured error beside
its bound (tests/torch_bounds.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eitx_torch.fem.inverse as port_inverse
from eitx.core.config import SimulationConfig as EitxSimulationConfig
from eitx.fem import create_protocol, place_electrodes_equal_spacing
from eitx.fem.inverse import DifferenceImager as EitxDifferenceImager
from eitx.fem.inverse import _difference_jacobian as eitx_jacobian
from eitx.fem.inverse import gauss_newton_absolute as eitx_gauss_newton
from eitx.fem.inverse import reconstruct_monitoring as eitx_monitoring
from eitx.fem.oracle import forward_solve_oracle
from eitx_torch.core.config import SimulationConfig
from eitx_torch.fem import (
    DifferenceImager,
    gauss_newton_absolute,
    reconstruct_monitoring,
    simulate_eit_monitoring,
)
from meshfix import disk_mesh, disk_mesh_with_classes
from torch_bounds import bounded

CPU = "cpu"
PROTO = create_protocol(16, 1, 1, "std")
BLOB_CENTRE = np.array([0.35, 0.2])

# Float32 Jacobians of the two packages differ by 4.3e-6 of scale on the
# 40-node-ring disk (measured), about as far as each is from the float64
# Jacobian (port 3.7e-6, eitx 2.4e-6): the stiffness sums run in another
# order and MKL's Cholesky is not jaxlib's LAPACK's. Adjacent measurement
# pairs subtract nearly equal sensitivities, so the error sits on entries
# near zero: a per-entry rtol 2e-4 / atol 1e-7 of scale
# (tests/test_spectral.py:81, right for voltages) is exceeded 8.5 times
# between the packages. The bound is float32's own error with a margin.
JAC_BOUND = 2e-5


def _rel_to_max(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _allclose_err(got, ref, rtol, atol) -> float:
    """The largest |got - ref| / (atol + rtol |ref|): <= 1 is allclose."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float((np.abs(got - ref) / (atol + rtol * np.abs(ref))).max())


@pytest.fixture(scope="module")
def disk():
    nodes, tris = disk_mesh(40, 5)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    rng = np.random.default_rng(0)
    sigma = 0.3 + 0.05 * rng.random(tris.shape[0])
    return nodes, tris, el, sigma


def _port_jacobian(nodes, tris, sigma, el, n_nodes, n_real, dtype):
    return port_inverse._difference_jacobian(
        torch.tensor(nodes, dtype=dtype), torch.tensor(tris),
        torch.tensor(sigma, dtype=dtype), torch.tensor(el),
        torch.tensor(PROTO.ex_mat), torch.tensor(PROTO.meas_mat),
        n_nodes, 0, n_real=n_real).numpy()


@pytest.mark.parametrize("tail", ["unpadded", "padded_int",
                                  "padded_tensor"])
def test_difference_jacobian_matches_eitx(disk, tail, record_property):
    nodes, tris, el, sigma = disk
    n_real = nodes.shape[0]
    if tail == "unpadded":
        n_nodes, port_real, eitx_real = n_real, None, None
    else:
        n_nodes = 256  # the padded tail: isolated nodes at the origin
        nodes = np.vstack([nodes, np.zeros((n_nodes - n_real, 2))])
        port_real = (n_real if tail == "padded_int"
                     else torch.tensor(n_real))
        eitx_real = jnp.asarray(n_real)
    want = np.asarray(eitx_jacobian(
        jnp.asarray(nodes, jnp.float32), jnp.asarray(tris, jnp.int32),
        jnp.asarray(sigma, jnp.float32), jnp.asarray(el),
        jnp.asarray(PROTO.ex_mat), jnp.asarray(PROTO.meas_mat), n_nodes, 0,
        n_real=eitx_real))
    got = _port_jacobian(nodes, tris, sigma, el, n_nodes, port_real,
                         torch.float32)
    f64 = _port_jacobian(nodes, tris, sigma, el, n_nodes, port_real,
                         torch.float64)
    assert got.shape == want.shape == (208, tris.shape[0])
    record_property("allclose_err at rtol 2e-4, atol 1e-7 of scale",
                    _allclose_err(got, want, 2e-4,
                                  1e-7 * np.abs(want).max()))
    bounded(record_property, "rel_to_max vs eitx", _rel_to_max(got, want),
            "<=", JAC_BOUND)
    # the bound is float32's own distance from float64, in both packages
    bounded(record_property, "eitx rel_to_max vs float64",
            _rel_to_max(want, f64), "<=", JAC_BOUND)
    bounded(record_property, "port rel_to_max vs float64",
            _rel_to_max(got, f64), "<=", JAC_BOUND)


def _blob_voltages(nodes, tris, el):
    """Oracle voltages of a homogeneous disk and of a +50 % inclusion."""
    sigma0 = np.full(tris.shape[0], 0.3)
    cent = nodes[tris].mean(axis=1)
    sigma1 = sigma0.copy()
    sigma1[np.linalg.norm(cent - BLOB_CENTRE, axis=1) < 0.25] = 0.45
    v0, v1 = (forward_solve_oracle(nodes, tris, s, el, PROTO.ex_mat,
                                   PROTO.meas_mat).ravel()
              for s in (sigma0, sigma1))
    return sigma0, sigma1, v0, v1


def test_difference_imager_matches_eitx(disk, record_property):
    nodes, tris, el, _ = disk
    sigma0, sigma1, v0, v1 = _blob_voltages(nodes, tris, el)
    rng = np.random.default_rng(1)
    dv = np.stack([v1 - v0, 1e-3 * rng.standard_normal(v0.shape)])
    ref = EitxDifferenceImager.build(nodes, tris, sigma0, el, PROTO.ex_mat,
                                     PROTO.meas_mat)
    want = np.asarray(ref.reconstruct(jnp.asarray(dv, jnp.float32)))
    imager = DifferenceImager.build(nodes, tris, sigma0, el, PROTO.ex_mat,
                                    PROTO.meas_mat, device=CPU)
    got = imager.reconstruct(dv)
    assert isinstance(got, torch.Tensor) and got.shape == (2, tris.shape[0])
    got = got.numpy()
    # the measurement-space solve of J J^T amplifies the Jacobians'
    # float32 differences, most for a change no conductivity explains:
    # measured 2.6e-5 (the inclusion) and 7.8e-4 (noise) of scale
    for k, (what, bound) in enumerate([("inclusion", 2.5e-4),
                                       ("noise", 5e-3)]):
        bounded(record_property, f"{what} rel_to_max",
                _rel_to_max(got[k], want[k]), "<=", bound)
    # and the port's image localizes the inclusion as eitx's test asks
    true_ds = sigma1 - sigma0
    assert np.corrcoef(got[0], true_ds)[0, 1] > 0.4


@pytest.fixture(scope="module")
def monitoring():
    nodes, tris, cls = disk_mesh_with_classes(48, 6)
    mesh = {"NODES": nodes * 100.0, "TRIANGLES": tris, "CLASS": cls}
    kw = dict(n_points=8, pad_nodes_to=256, pad_elems_to=512)
    v, _ = simulate_eit_monitoring(mesh, SimulationConfig(**kw), device=CPU)
    want, _ = eitx_monitoring(mesh, v, cfg=EitxSimulationConfig(**kw))
    got, imager = reconstruct_monitoring(mesh, v, cfg=SimulationConfig(**kw),
                                         device=CPU)
    return cls, np.asarray(want), got, imager


def test_reconstruct_monitoring_matches_eitx(monitoring, record_property):
    cls, want, got, imager = monitoring
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert imager.jac.device.type == CPU and np.isfinite(got).all()
    assert not np.abs(got[0]).any()  # the reference frame images nothing
    # measured 3.3e-5 of scale (float32 Jacobians, as above)
    bounded(record_property, "rel_to_max", _rel_to_max(got, want), "<=",
            3e-4)
    var = got.var(axis=0)
    lung = cls == 2
    assert var[lung].mean() > var[~lung].mean()


@pytest.fixture(scope="module")
def absolute():
    nodes, tris = disk_mesh(48, 7)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    cent = nodes[tris].mean(1)
    sigma_true = np.full((tris.shape[0],), 0.5)
    blob = np.linalg.norm(cent - BLOB_CENTRE, axis=1) < 0.25
    sigma_true[blob] = 1.5
    v = forward_solve_oracle(nodes, tris, sigma_true, el, PROTO.ex_mat,
                             PROTO.meas_mat)
    args = (nodes, tris, v, el, PROTO.ex_mat, PROTO.meas_mat)
    want = eitx_gauss_newton(*args, n_iter=6, lam=1e-2)
    got = gauss_newton_absolute(*args, n_iter=6, lam=1e-2, device=CPU)
    return blob, want, got, args


def test_gauss_newton_matches_eitx(absolute, record_property):
    blob, (want_sigma, want_res), (sigma, res), _ = absolute
    assert isinstance(sigma, np.ndarray) and sigma.shape == want_sigma.shape
    assert res.shape == (6,)
    # float32 rounding compounds over six linearizations: measured 1.2e-5
    # of scale (sigma) and 1.1e-4 relative (the squared residuals; the
    # last is 1e-3 of the first)
    bounded(record_property, "sigma rel_to_max",
            _rel_to_max(sigma, want_sigma), "<=", 1e-4)
    bounded(record_property, "residual max rel",
            (np.abs(res - want_res) / want_res).max(), "<=", 1e-3)
    # the reference test's own checks, on the port's result
    assert res[-1] < 0.2 * res[0]
    assert sigma[blob].mean() > 1.25 * sigma[~blob].mean()


_HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
               "__int__", "__index__")


def test_gauss_newton_loop_reads_nothing_back(absolute, monkeypatch):
    """The loop leaves every value on the device: no host read of a tensor
    while it runs (the card-only test counts the device waits)."""
    *_, args = absolute
    reads = []
    loop = port_inverse._gauss_newton

    def watched(*a, **kw):
        with pytest.MonkeyPatch.context() as reads_spied:
            for name in _HOST_READS:
                inner = getattr(torch.Tensor, name)

                def spy(self, *x, _inner=inner, _name=name, **y):
                    reads.append(_name)
                    return _inner(self, *x, **y)

                reads_spied.setattr(torch.Tensor, name, spy)
            return loop(*a, **kw)

    monkeypatch.setattr(port_inverse, "_gauss_newton", watched)
    sigma, res = port_inverse.gauss_newton_absolute(*args, n_iter=3,
                                                    device=CPU)
    assert reads == []
    assert np.isfinite(sigma).all() and res.shape == (3,)
