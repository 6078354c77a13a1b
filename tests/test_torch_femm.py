"""The FEMM path of the port against eitx on the CPU: the complex-
admittance solver, the frequency sweep, the Sheffield line-integral
measurement, and the host-only copies (contour filters, FEMM model
preparation, ``.fec`` text) compared exactly."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eitx.fem.femm_model as eitx_femm
import eitx.geometry.filters as eitx_filters
from eitx.fem import simulate_eit_spectroscopy as eitx_spectroscopy
from eitx.fem.admittance import forward_solve_admittance as eitx_admittance
from eitx.fem.sheffield import electrode_averaging_matrix as eitx_avg_matrix
from eitx.fem.sheffield import sheffield_monitoring as eitx_sheffield
from eitx.fem.sheffield import sheffield_solve_admittance as eitx_sheffield_one
import eitx_torch.fem.femm_model as femm
import eitx_torch.geometry.filters as filters
from eitx_torch.fem import (
    create_protocol,
    electrode_averaging_matrix,
    forward_solve,
    forward_solve_admittance,
    place_electrodes_equal_spacing,
    sheffield_ex_mat,
    sheffield_monitoring,
    sheffield_solve_admittance,
    simulate_eit_spectroscopy,
)
from meshfix import disk_mesh, disk_mesh_with_classes
from torch_bounds import bounded

CPU = "cpu"
PROTO = create_protocol(16, 1, 1, "std")


def _rel_to_max(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _eitx_admittance(nodes, tris, sigma, eps, el):
    return np.asarray(eitx_admittance(
        jnp.asarray(nodes, jnp.float32), jnp.asarray(tris, jnp.int32),
        jnp.asarray(sigma, jnp.float32), jnp.asarray(eps, jnp.float32),
        jnp.float32(5e4), jnp.asarray(el), jnp.asarray(PROTO.ex_mat),
        jnp.asarray(PROTO.meas_mat), nodes.shape[0]))


def test_admittance_reduces_to_real_solver(record_property):
    """tests/test_femm_compat.py:107-123 on the port."""
    nodes, tris = disk_mesh(40, 5)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    sigma = np.full(tris.shape[0], 0.3)
    eps = np.zeros(tris.shape[0])
    v_c = forward_solve_admittance(nodes, tris, sigma, eps, 5e4, el,
                                   PROTO.ex_mat, PROTO.meas_mat,
                                   nodes.shape[0], device=CPU).numpy()
    v_r = forward_solve(nodes, tris, sigma, el, PROTO.ex_mat, PROTO.meas_mat,
                        nodes.shape[0], device=CPU).numpy()
    assert v_c.dtype == np.complex64 and v_c.shape == (16, 13)
    bounded(record_property, "imag max", np.abs(v_c.imag).max(), "<", 1e-5)
    bounded(record_property, "real vs real solver rel to max",
            _rel_to_max(v_c.real, v_r), "<", 1e-3)
    # against eitx: two LUs of the same block system with other pivots,
    # at the reference's own bound for this comparison
    bounded(record_property, "vs eitx rel to max",
            _rel_to_max(v_c, _eitx_admittance(nodes, tris, sigma, eps, el)),
            "<", 1e-3)


def test_admittance_with_permittivity_matches_eitx(record_property):
    nodes, tris = disk_mesh(40, 5)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    rng = np.random.default_rng(6)
    sigma = rng.uniform(0.05, 0.5, tris.shape[0])
    eps = rng.uniform(1e3, 3e4, tris.shape[0])
    got = forward_solve_admittance(nodes, tris, sigma, eps, 5e4, el,
                                   PROTO.ex_mat, PROTO.meas_mat,
                                   nodes.shape[0], device=CPU).numpy()
    ref = _eitx_admittance(nodes, tris, sigma, eps, el)
    assert np.abs(got.imag).max() > 1e-4 * np.abs(got.real).max()
    bounded(record_property, "real rel to max", _rel_to_max(got.real, ref.real),
            "<", 1e-3)
    bounded(record_property, "imag rel to max", _rel_to_max(got.imag, ref.imag),
            "<", 1e-3)


def test_eit_spectroscopy_matches_eitx(record_property):
    """tests/test_femm_compat.py:267-283's sweep, held to eitx's."""
    nodes, tris, cls = disk_mesh_with_classes(40, 5)
    mesh = {"NODES": nodes * 100.0, "TRIANGLES": tris, "CLASS": cls}
    freqs = [1e4, 5e4, 2e5, 1e6]
    v = simulate_eit_spectroscopy(mesh, freqs, device=CPU)
    ref = eitx_spectroscopy(mesh, freqs)
    assert v.shape == ref.shape == (4, 16, 13) and v.dtype == ref.dtype
    assert np.isfinite(v.real).all() and np.isfinite(v.imag).all()
    assert np.abs(np.abs(v[0]) - np.abs(v[2])).max() > 0
    assert np.abs(v.imag).max() > 0
    for k in range(4):
        bounded(record_property, f"f{k} real rel to max",
                _rel_to_max(v[k].real, ref[k].real), "<", 1e-3)
        bounded(record_property, f"f{k} imag rel to max",
                _rel_to_max(v[k].imag, ref[k].imag), "<", 1e-3)


def _flat_electrodes(nodes, el, half=0.04):
    th = np.arctan2(nodes[el][:, 1], nodes[el][:, 0])
    tang = np.stack([-np.sin(th), np.cos(th)], 1) * half
    return np.stack([np.stack([nodes[e] - t, nodes[e] + t, nodes[e]])
                     for e, t in zip(el, tang)])


def test_electrode_averaging_matrix_equals_eitx():
    nodes, tris = disk_mesh(48, 6)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    for elecs, samples in ((_flat_electrodes(nodes, el), 9),
                           (_flat_electrodes(nodes, el, 1e-9), 3)):
        W = electrode_averaging_matrix(nodes, tris, elecs, samples=samples)
        assert np.array_equal(W, eitx_avg_matrix(nodes, tris, elecs,
                                                 samples=samples))
    assert np.array_equal(sheffield_ex_mat(16)[:2], [[1, 0], [2, 1]])


def test_sheffield_solve_and_monitoring_match_eitx(record_property):
    nodes, tris, cls = disk_mesh_with_classes(48, 6)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    elecs = _flat_electrodes(nodes, el)
    W = electrode_averaging_matrix(nodes, tris, elecs)
    sigma = np.full(tris.shape[0], 0.3)
    eps = np.full(tris.shape[0], 1e4)
    got = sheffield_solve_admittance(nodes, tris, sigma, eps, 5e4, W, 0.005,
                                     nodes.shape[0], device=CPU).numpy()
    ref = np.asarray(eitx_sheffield_one(
        jnp.asarray(nodes, jnp.float32), jnp.asarray(tris, jnp.int32),
        jnp.asarray(sigma, jnp.float32), jnp.asarray(eps, jnp.float32),
        jnp.float32(5e4), jnp.asarray(W, jnp.float32), jnp.float32(0.005),
        nodes.shape[0]))
    assert got.shape == ref.shape == (16, 16)
    bounded(record_property, "one frame rel to max", _rel_to_max(got, ref),
            "<", 1e-3)
    # tests/test_femm_compat.py:207-228, over 8 frames
    T = 8
    sig = np.full((T, tris.shape[0]), 0.3)
    for t in range(T):
        sig[t, cls == 2] = 0.10 + 0.02 * t  # breathing lungs
    eps_t = np.zeros_like(sig)
    v = sheffield_monitoring(nodes, tris, sig, eps_t, 5e4, elecs, device=CPU)
    assert v.shape == (T, 16, 16) and np.isfinite(v).all()
    assert np.abs(v[T - 1] - v[0]).max() > 1e-8
    assert np.allclose(v.sum(axis=-1), 0.0, atol=1e-5)
    ref_t = eitx_sheffield(nodes, tris, sig, eps_t, 5e4, elecs)
    bounded(record_property, "monitoring rel to max", _rel_to_max(v, ref_t),
            "<", 1e-3)


def _circle(r=100.0, n=120, cx=0.0, cy=0.0):
    th = np.pi - np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1)


SETTINGS = dict(Nelec=16, Relec=5, accuracy=0.5, min_area=100, polydeg=5,
                skinthick=2, I=0.005, Freq=50000, thin_coeff=2)
MATS = {"muscles": {"cond": 0.35, "perm": 1e4},
        "lung": {"cond": 0.15, "perm": 2e4},
        "skin": {"cond": 0.0002, "perm": 1e3}}


def _prepared(mod):
    borders = {"muscles": [_circle(100.0, 200)],
               "lung": [_circle(25.0, 60, cx=-30)]}
    return mod.prepare_data(borders, mod.Settings(**SETTINGS))


def test_femm_model_and_fec_bytes_equal_eitx(tmp_path):
    """The inputs of tests/test_femm_compat.py:231-264: the same prepared
    contours and electrodes, and the same .fec and JSON bytes."""
    bordersf, elecs = _prepared(femm)
    ref_b, ref_e = _prepared(eitx_femm)
    assert np.array_equal(elecs, ref_e)
    assert bordersf.keys() == ref_b.keys()
    for tissue in bordersf:
        for a, b in zip(bordersf[tissue]["coords"], ref_b[tissue]["coords"]):
            assert np.array_equal(a, b)
    settings = femm.Settings(**SETTINGS)
    paths = femm.save_model("prob", bordersf, elecs, settings, MATS,
                            n_projections=16, dirpath=str(tmp_path / "port"))
    ref_paths = eitx_femm.save_model(
        "prob", ref_b, ref_e, eitx_femm.Settings(**SETTINGS), MATS,
        n_projections=16, dirpath=str(tmp_path / "eitx"))
    for p, q in zip(paths, ref_paths):
        assert open(p, "rb").read() == open(q, "rb").read()
    doc = femm.load_fec(paths[3])
    assert doc["conductors"]["INJ"]["Electrode"] == 4
    np.testing.assert_allclose(doc["electrodes"], elecs, rtol=1e-12)
    out, ref_out = tmp_path / "port.json", tmp_path / "eitx.json"
    femm.export_femm_model(str(out), bordersf, elecs, settings, MATS)
    eitx_femm.export_femm_model(str(ref_out), ref_b, ref_e,
                                eitx_femm.Settings(**SETTINGS), MATS)
    assert out.read_bytes() == ref_out.read_bytes()
    assert json.loads(out.read_text())["problem"]["n_electrodes"] == 16


def test_femm_helpers_equal_eitx(tmp_path):
    c = _circle(100.0, 200, cx=30, cy=-20)
    assert np.array_equal(femm.add_skin_radial(c, 5.0),
                          eitx_femm.add_skin_radial(c, 5.0))
    for n in (16, 8):
        assert np.array_equal(femm.get_electrodes_coords(c, n, 10.0),
                              eitx_femm.get_electrodes_coords(c, n, 10.0))
    el = femm.get_electrodes_coords(c, 16, 10.0)
    assert np.array_equal(femm.insert_electrodes_to_polygon(c, el),
                          eitx_femm.insert_electrodes_to_polygon(c, el))
    path = tmp_path / "yolo.txt"
    path.write_text("0 0.1 0.1 0.2 0.1 0.2 0.2\n2 0.5 0.5 0.6 0.5 0.6 0.6 "
                    "0.5 0.6\n1 0.3 0.3 0.4 0.3 0.35 0.4\n")
    got = femm.load_yolo(str(path), femm.CLASSES_LIST)
    ref = eitx_femm.load_yolo(str(path), eitx_femm.CLASSES_LIST)
    assert got.keys() == ref.keys()
    for k in got:
        assert all(np.array_equal(a, b) for a, b in zip(got[k], ref[k]))


def _wavy(n=300, seed=0):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = 100 + 8 * np.sin(5 * th) + rng.normal(0, 0.5, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th)], 1)
    pts[n // 8:n // 8 + 4] = pts[n // 8]  # repeated points
    pts[n // 3:n // 3 + 10, 1] = pts[n // 3, 1]  # a level run
    return pts


@pytest.mark.parametrize("name,args", [
    ("calc_lin_coef", ([0.0, 1.0], [2.0, 5.0])),
    ("calc_dist", ([0.0, 1.0], [3.0, 5.0])),
    ("poly_area", (_wavy()[:, 0], _wavy()[:, 1])),
    ("check_point_in_line", (_wavy()[:3], (101.0, 2.0), 1e-3)),
    ("filter_inline_points", (_wavy(),)),
    ("filter_inline_points", (_wavy(), 1e-3)),
    ("cut_min_area_close_points", (_wavy(), 1.0, 2.0)),
    ("filter_degr_polyfit", (_wavy(), 20.0, 5)),
    ("interpolate_surface_step", (_circle(100.0, 200), 5, 2.0, 0.5, 2)),
    ("interpolate_big_vert_breaks_lin", (_wavy(60)[::3], 3)),
    ("interpolate_big_vert_breaks_poly", (_wavy(), 3, 6)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_filters_equal_eitx(name, args):
    got = getattr(filters, name)(*args)
    ref = getattr(eitx_filters, name)(*args)
    assert np.array_equal(np.asarray(got), np.asarray(ref), equal_nan=True)


def test_spectroscopy_and_sheffield_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    nodes, tris, cls = disk_mesh_with_classes(24, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_eit_spectroscopy(
            {"NODES": nodes, "TRIANGLES": tris, "CLASS": cls}, [5e4])
