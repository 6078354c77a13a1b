"""FEM forward solve: the port against eitx, the float64 oracle, and
itself (determinism)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eitx.core.config import ClassMap
from eitx.core.config import SimulationConfig as EitxSimulationConfig
from eitx.fem import ClassStiffness as EitxClassStiffness
from eitx.fem import simulate_eit_monitoring as eitx_simulate
from eitx.fem.forward import write_dat as eitx_write_dat
from eitx.fem.oracle import monitoring_oracle
from eitx.fem.spectral import LowRankSpectralSolver as EitxLowRank
from eitx_torch.core.config import SimulationConfig
from eitx_torch.fem import (
    ClassStiffness,
    LowRankSpectralSolver,
    create_protocol,
    place_electrodes_equal_spacing,
    simulate_eit_monitoring,
    write_dat,
)
from eitx_torch.fem.forward import (
    _breathing_schedule,
    build_sigma_frames,
    compact_mesh_nodes,
    prepare_mesh_info,
)
from eitx_torch.mesh import create_mesh
from eitx_torch.physio.materials import get_materials, tissue_conductivities
from meshfix import disk_mesh_with_classes
from test_torch_mesh import _real_polygons, thorax_polygons
from torch_bounds import bounded

GOLD_ROW0 = np.array(
    [3.27767618, 0.16383494, 0.15325824, 0.12928992, 0.03966795, 0.02340173]
)
GOLD_ROW5 = np.array(
    [0.07548676, 0.08194821, 0.05308934, 0.31663108, 1.00702802, 3.41541427]
)
GOLD_SUM = 1194.555605
GOLD_ABSMAX = 8.415208


@pytest.fixture(scope="module")
def thorax_mesh():
    _, mesh = create_mesh(["0.75", "0.75"], thorax_polygons(), lc=7.0,
                          show_meshing_result_method="no", device="cpu")
    return mesh


@pytest.fixture(scope="module")
def small_thorax_mesh():
    """The thorax at lc 12 (~800 nodes): for checks that need a mesh but
    not the lc-7 size."""
    _, mesh = create_mesh(["0.75", "0.75"], thorax_polygons(), lc=12.0,
                          show_meshing_result_method="no", device="cpu")
    return mesh


def _oracle_bound(record_property, v, ref):
    """The spectral-vs-oracle bound of test_realfixture.py:136-137."""
    rel = np.abs(v - ref) / (np.abs(ref) + 1e-9)
    bounded(record_property, "max_rel", rel.max(), "<", 2e-2)
    bounded(record_property, "mean_rel", rel.mean(), "<", 2e-3)


def test_class_stiffness_matches_eitx():
    nodes, tris, cls = disk_mesh_with_classes(40, 5)
    ref = EitxClassStiffness.build(nodes, tris, cls, n_classes=5,
                                   pad_nodes_to=256, pad_elems_to=512)
    got = ClassStiffness.build(nodes, tris, cls, n_classes=5,
                               pad_nodes_to=256, pad_elems_to=512,
                               device="cpu")
    k_ref = np.asarray(ref.k_class)
    assert got.k_class.shape == k_ref.shape
    # float32 sums of at most ~8 element contributions per entry
    assert np.allclose(got.k_class.numpy(), k_ref, rtol=1e-5, atol=1e-6)
    assert np.array_equal(got.diag_fix.numpy(), np.asarray(ref.diag_fix))


def test_lowrank_solver_matches_eitx_on_disk(record_property):
    """Same mesh, same factorization: the reference's own batched-vs-
    single tolerance (tests/test_spectral.py:81)."""
    nodes, tris, cls = disk_mesh_with_classes(48, 6)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    p = create_protocol(16, 1, 1, "std")
    base = np.array([0.006, 0.35, 0.15, 0.017, 0.4])
    alphas = np.linspace(0.06, 0.18, 9)
    a0 = float(alphas.mean())
    cs_ref = EitxClassStiffness.build(nodes, tris, cls, n_classes=5,
                                      dtype=jnp.float32)
    ref = np.asarray(EitxLowRank.build(
        cs_ref, base, 2, el, p.ex_mat, p.meas_mat, a0, rank_bucket=64
    ).solve(alphas))
    cs = ClassStiffness.build(nodes, tris, cls, n_classes=5, device="cpu")
    got = LowRankSpectralSolver.build(
        cs, base, 2, el, p.ex_mat, p.meas_mat, a0, rank_bucket=64
    ).solve(alphas).numpy()
    record_property("max_abs", float(np.abs(got - ref).max()))
    record_property("max_rel", float(
        (np.abs(got - ref) / (np.abs(ref) + 1e-9)).max()))
    assert np.allclose(got, ref, rtol=2e-4, atol=1e-7), np.abs(got - ref).max()


def test_simulation_matches_eitx_on_thorax(thorax_mesh, record_property):
    """Bound: the oracle's (rel max 2e-2, mean 2e-3), not rtol 2e-4. At
    lc 7 the grounded stiffness matrix has ~2300 nodes padded to 3072; a
    float32 Cholesky of it puts eitx (XLA) and the port (LAPACK) each
    ~1.2e-3 (max relative) from the float64 solve of the same algorithm,
    in different directions, so their difference is of that order too
    (the test records the measured max and mean)."""
    cfg = SimulationConfig(n_points=8, n_spir=1)
    ref, _ = eitx_simulate(thorax_mesh, EitxSimulationConfig(n_points=8, n_spir=1))
    got, _ = simulate_eit_monitoring(thorax_mesh, cfg, device="cpu")
    assert got.shape == ref.shape == (8, 208)
    _oracle_bound(record_property, got, ref)


def test_real_slice_port_chain_vs_float64_oracle(record_property):
    """Real-slice polygons -> port mesh -> port solve, against the float64
    oracle and its pinned rows (test_realfixture.py:92-141)."""
    _, mesh = create_mesh(["1", "1"], _real_polygons(), 10, 1.3, 1, True,
                          show_meshing_result_method="no", device="cpu")
    cfg = SimulationConfig(n_points=8, n_spir=1, n_minutes=1)
    v, _ = simulate_eit_monitoring(mesh, cfg, device="cpu")
    assert v.shape == (8, 208) and np.isfinite(v).all()

    classes = ClassMap()
    info = compact_mesh_nodes(prepare_mesh_info(mesh, classes))
    materials = get_materials(None)
    _, condspir = _breathing_schedule(cfg, materials, False)
    base = tissue_conductivities(
        materials, cfg.frequency_hz, classes.id_to_name(), False)
    sigma = build_sigma_frames(condspir, base, classes)
    proto = create_protocol(16, 1, 1, "std")
    el = place_electrodes_equal_spacing(
        info.node, info.element, n_electrodes=16,
        starting_angle=math.radians(cfg.starting_angle_deg))
    vo = np.asarray(monitoring_oracle(
        info.node, info.element, sigma[:, info.cond], el,
        proto.ex_mat, proto.meas_mat)).reshape(8, -1)
    _oracle_bound(record_property, v, vo)
    assert np.allclose(vo[0][:6], GOLD_ROW0, rtol=2e-4)
    assert np.allclose(vo[5][-6:], GOLD_ROW5, rtol=2e-4)
    # the port's own rows against the pinned oracle values
    assert np.allclose(v[0][:6], GOLD_ROW0, rtol=2e-2)
    assert np.allclose(v[5][-6:], GOLD_ROW5, rtol=2e-2)
    assert abs(v.sum() - GOLD_SUM) / GOLD_SUM < 2e-3
    assert abs(np.abs(v).max() - GOLD_ABSMAX) / GOLD_ABSMAX < 2e-3


def test_dat_files_byte_equal_over_two_runs(small_thorax_mesh, tmp_path):
    cfg = SimulationConfig(n_points=4, n_spir=2)
    paths = []
    for k in range(2):
        path = str(tmp_path / f"run{k}.dat")
        simulate_eit_monitoring(small_thorax_mesh, cfg, save_to_file=True,
                                filename=path, device="cpu")
        paths.append(path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b
    rows = a.decode().strip().split("\n")
    assert len(rows) == 8 and len(rows[0].split()) == 208


def test_write_dat_identical_to_eitx(tmp_path):
    v = np.random.default_rng(7).normal(0, 1, (3, 16, 13)).astype(np.float32)
    write_dat(str(tmp_path / "port.dat"), v, n_repeats=2)
    eitx_write_dat(str(tmp_path / "eitx.dat"), v, n_repeats=2)
    assert (tmp_path / "port.dat").read_bytes() == (
        tmp_path / "eitx.dat").read_bytes()


@pytest.mark.parametrize("field,value", [
    ("solver", "cholesky"), ("solver", "spectral_full"),
    ("electrode_model", "cem"), ("precision", "f64"),
])
def test_unported_branches_raise(small_thorax_mesh, field, value):
    """The branches that raised NotImplementedError before the solver
    families were ported now run on the thorax: finite voltages of the
    serving shape (their parity with eitx: tests/test_torch_fem_solvers.py)."""
    from dataclasses import replace

    cfg = replace(SimulationConfig(n_points=4), **{field: value})
    v, _ = simulate_eit_monitoring(small_thorax_mesh, cfg, device="cpu")
    assert v.shape == (4, 208) and np.isfinite(v).all()
    assert v.dtype == (np.float64 if value == "f64" else np.float32)


def test_scatter_assembly_restores_determinism_flag():
    before = torch.are_deterministic_algorithms_enabled()
    nodes, tris, cls = disk_mesh_with_classes(24, 3)
    ClassStiffness.build(nodes, tris, cls, n_classes=5, device="cpu")
    assert torch.are_deterministic_algorithms_enabled() == before


@pytest.mark.parametrize("swap", [False, True])
def test_load_mesh_txt_equals_eitx(tmp_path, swap):
    """The FEMM-format text mesh (1-based ids, a class per triangle) loads
    into the same MeshInfo in both packages, class groups included."""
    from eitx.fem import load_mesh_txt as eitx_load_mesh_txt
    from eitx_torch.core.config import ClassMap as PortClassMap
    from eitx_torch.fem import load_mesh_txt
    from eitx_torch.mesh.export import write_mesh_txt

    nodes, tris, cls = disk_mesh_with_classes(24, 3)
    path = str(tmp_path / "mesh.txt")
    write_mesh_txt(path, {"NODES": nodes * 37.5, "TRIANGLES": tris,
                          "CLASS": cls})
    got = load_mesh_txt(path, PortClassMap(compat_swap_lung_fat=swap))
    want = eitx_load_mesh_txt(path, ClassMap(compat_swap_lung_fat=swap))
    assert np.array_equal(got.element, want.element)
    assert np.array_equal(got.element, tris)
    assert np.array_equal(got.node, want.node)
    assert np.array_equal(got.cond, want.cond)
    assert got.classes_gr == want.classes_gr
