"""Every forward-solver family of the port against eitx on the CPU: the
direct batched Cholesky, CG, both spectral solvers and their batched
setups, the complete electrode model, and the float64 route against the
float64 oracle. Same seeded inputs through both packages; each comparison
records its measured error beside its bound (tests/torch_bounds.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eitx.core.config import SimulationConfig as EitxSimulationConfig
from eitx.fem import ClassStiffness as EitxClassStiffness
from eitx.fem import simulate_eit_monitoring as eitx_simulate
from eitx.fem.assembly import assemble_stiffness as eitx_assemble
from eitx.fem.cem import build_cem_system as eitx_build_cem
from eitx.fem.cem import electrode_arcs as eitx_electrode_arcs
from eitx.fem.cem import forward_solve_cem as eitx_forward_cem
from eitx.fem.cem import spectral_cem_solver as eitx_spectral_cem
from eitx.fem.forward import (
    simulate_eit_monitoring_subjects as eitx_subjects,
)
from eitx.fem.oracle import monitoring_oracle as eitx_monitoring_oracle
from eitx.fem.solver import forward_solve as eitx_forward_solve
from eitx.fem.solver import forward_solve_batched as eitx_batched
from eitx.fem.solver import forward_solve_cg as eitx_cg
from eitx.fem.spectral import LowRankSpectralSolver as EitxLowRank
from eitx.fem.spectral import SpectralEITSolver as EitxSpectral
from eitx_torch.core.config import ClassMap, SimulationConfig
from eitx_torch.fem import (
    ClassStiffness,
    LowRankSpectralSolver,
    SpectralEITSolver,
    assemble_stiffness,
    create_protocol,
    forward_solve,
    forward_solve_batched,
    forward_solve_cg,
    lowrank_solve_batch,
    place_electrodes_equal_spacing,
    simulate_eit_monitoring,
    simulate_eit_monitoring_subjects,
)
from eitx_torch.fem.cem import (
    build_cem_system,
    electrode_arcs,
    forward_solve_cem,
    spectral_cem_solver,
)
from eitx_torch.fem.forward import (
    _breathing_schedule,
    build_sigma_frames,
    compact_mesh_nodes,
    prepare_mesh_info,
)
from eitx_torch.fem.oracle import monitoring_oracle
from eitx_torch.fem.solver import forward_solve_cg_info
from eitx_torch.physio.materials import get_materials, tissue_conductivities
from meshfix import disk_mesh_with_classes
from torch_bounds import bounded

CPU = "cpu"
BASE = np.array([0.006, 0.35, 0.15, 0.017, 0.4])
SIGMA0 = np.array([0.006, 0.35, 0.15, 0.017, 0.0002])
PROTO = create_protocol(16, 1, 1, "std")


def _rel_to_max(got, ref) -> float:
    """max |got - ref| / max |ref|: the scale-relative error of the
    reference's solver tests (tests/test_fem.py:163, :182)."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _allclose_err(got, ref, rtol, atol) -> float:
    """The largest |got - ref| / (atol + rtol |ref|): <= 1 is allclose."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float((np.abs(got - ref) / (atol + rtol * np.abs(ref))).max())


def _disk(nb=48, rings=6):
    nodes, tris, cls = disk_mesh_with_classes(nb, rings)
    el = place_electrodes_equal_spacing(nodes, tris, 16, starting_angle=np.pi)
    return nodes, tris, cls, el


def _stiffness_pair(nodes, tris, cls, **kw):
    return (EitxClassStiffness.build(nodes, tris, cls, n_classes=5, **kw),
            ClassStiffness.build(nodes, tris, cls, n_classes=5, device=CPU,
                                 **kw))


def test_assemble_stiffness_and_system_matrices_match_eitx(record_property):
    nodes, tris, cls, _ = _disk(40, 5)
    cond = np.random.default_rng(3).uniform(0.05, 1.0, tris.shape[0])
    ref = np.asarray(eitx_assemble(jnp.asarray(nodes, jnp.float32),
                                   jnp.asarray(tris, jnp.int32),
                                   jnp.asarray(cond, jnp.float32),
                                   nodes.shape[0]))
    got = assemble_stiffness(torch.as_tensor(nodes, dtype=torch.float32),
                             torch.as_tensor(tris),
                             torch.as_tensor(cond, dtype=torch.float32),
                             nodes.shape[0]).numpy()
    # float32 sums of at most ~8 element contributions per entry
    bounded(record_property, "stiffness allclose(1e-5, 1e-6) err",
            _allclose_err(got, ref, 1e-5, 1e-6), "<=", 1.0)
    cs_ref, cs = _stiffness_pair(nodes, tris, cls, pad_nodes_to=128)
    sigma = np.random.default_rng(4).uniform(0.05, 1.0, (3, 5))
    k_ref = np.asarray(cs_ref.system_matrices(jnp.asarray(sigma, jnp.float32)))
    k_got = cs.system_matrices(torch.as_tensor(sigma)).numpy()
    bounded(record_property, "system_matrices allclose(1e-5, 1e-6) err",
            _allclose_err(k_got, k_ref, 1e-5, 1e-6), "<=", 1.0)


def test_forward_solve_matches_eitx(record_property):
    nodes, tris, cls, el = _disk()
    cond = BASE[cls]
    ref = np.asarray(eitx_forward_solve(
        jnp.asarray(nodes, jnp.float32), jnp.asarray(tris, jnp.int32),
        jnp.asarray(cond, jnp.float32), jnp.asarray(el),
        jnp.asarray(PROTO.ex_mat), jnp.asarray(PROTO.meas_mat),
        nodes.shape[0]))
    got = forward_solve(nodes, tris, cond, el, PROTO.ex_mat, PROTO.meas_mat,
                        nodes.shape[0], device=CPU).numpy()
    assert got.shape == ref.shape == (16, 13)
    # the reference's batched-vs-single bound (tests/test_spectral.py:81)
    bounded(record_property, "allclose(2e-4, 1e-7) err",
            _allclose_err(got, ref, 2e-4, 1e-7), "<=", 1.0)


def test_forward_solve_batched_matches_eitx_and_oracle(record_property):
    nodes, tris, cls, el = _disk()
    cs_ref, cs = _stiffness_pair(nodes, tris, cls)
    sigma = np.random.default_rng(2).uniform(0.05, 1.0, (7, 5))
    ref = np.asarray(eitx_batched(
        cs_ref, jnp.asarray(sigma, jnp.float32), jnp.asarray(el),
        jnp.asarray(PROTO.ex_mat), jnp.asarray(PROTO.meas_mat)))
    got = forward_solve_batched(cs, sigma, el, PROTO.ex_mat,
                                PROTO.meas_mat).numpy()
    assert got.shape == ref.shape == (7, 16, 13)
    bounded(record_property, "vs eitx allclose(2e-4, 1e-7) err",
            _allclose_err(got, ref, 2e-4, 1e-7), "<=", 1.0)
    oracle = eitx_monitoring_oracle(nodes, tris, sigma[:, cls], el,
                                    PROTO.ex_mat, PROTO.meas_mat)
    # f32 Cholesky vs f64 sparse LU (tests/test_fem.py:163)
    bounded(record_property, "vs oracle rel to max", _rel_to_max(got, oracle),
            "<", 5e-3)


def test_cg_matches_cholesky_and_eitx(record_property):
    """The reference's CG test settings (tests/test_fem.py:167-182)."""
    nodes, tris, cls, el = _disk(40, 5)
    cs_ref, cs = _stiffness_pair(nodes, tris, cls)
    sigma = np.array([[0.006, 0.35, 0.1, 0.04, 0.4]])
    args = (el, PROTO.ex_mat, PROTO.meas_mat)
    v_chol = forward_solve_batched(cs, sigma, *args).numpy()
    v_cg, iters, res = forward_solve_cg_info(cs, sigma, *args, tol=1e-9,
                                             maxiter=3000)
    bounded(record_property, "cg vs cholesky rel to max",
            _rel_to_max(v_cg.numpy(), v_chol), "<", 5e-3)
    ref = np.asarray(eitx_cg(cs_ref, jnp.asarray(sigma, jnp.float32),
                             jnp.asarray(el), jnp.asarray(PROTO.ex_mat),
                             jnp.asarray(PROTO.meas_mat), tol=1e-9,
                             maxiter=3000))
    bounded(record_property, "cg vs eitx cg rel to max",
            _rel_to_max(v_cg.numpy(), ref), "<", 5e-3)
    record_property("iterations", int(iters[0]))
    record_property("relative residual", float(res[0]))
    assert int(iters[0]) < 3000 and float(res[0]) <= 1e-9


def test_cg_frames_stop_on_their_own_and_match_eitx(record_property):
    """Frames of different conditioning converge at different iterations
    and stay frozen; at a maxiter too small to converge the port gives
    what eitx gives, not a converged answer."""
    nodes, tris, cls, el = _disk(40, 5)
    cs_ref, cs = _stiffness_pair(nodes, tris, cls)
    sigma = np.array([[0.35, 0.35, 0.35, 0.35, 0.35],
                      [0.006, 0.35, 0.1, 0.04, 0.4],
                      [0.0002, 0.35, 0.05, 0.0002, 0.4]])
    args = (el, PROTO.ex_mat, PROTO.meas_mat)
    v, iters, res = forward_solve_cg_info(cs, sigma, *args)
    iters = iters.tolist()
    record_property("iterations", iters)
    assert len(set(iters)) > 1 and max(iters) < 800
    assert float(res.max()) <= 1e-6
    for t in range(3):
        alone = forward_solve_cg(cs, sigma[t:t + 1], *args).numpy()
        bounded(record_property, f"frame {t} alone vs together rel to max",
                _rel_to_max(v[t:t + 1].numpy(), alone), "<", 1e-5)
    for maxiter in (800, 20):
        ref = np.asarray(eitx_cg(
            cs_ref, jnp.asarray(sigma, jnp.float32), jnp.asarray(el),
            jnp.asarray(PROTO.ex_mat), jnp.asarray(PROTO.meas_mat),
            maxiter=maxiter))
        got = forward_solve_cg(cs, sigma, *args, maxiter=maxiter).numpy()
        bounded(record_property, f"maxiter {maxiter} vs eitx rel to max",
                _rel_to_max(got, ref), "<", 5e-3)


def _subjects(pad_nodes=512, pad_elems=1024, sizes=(40, 48), rings=6):
    subs = []
    for nb in sizes:
        nodes, tris, cls = disk_mesh_with_classes(nb, rings)
        el = place_electrodes_equal_spacing(nodes, tris, 16,
                                            starting_angle=np.pi)
        subs.append(_stiffness_pair(nodes, tris, cls, pad_nodes_to=pad_nodes,
                                    pad_elems_to=pad_elems) + (el,))
    return subs


@pytest.mark.parametrize("family", ["spectral_full", "lowrank"])
def test_build_batch_matches_single_and_eitx(family, record_property):
    """Batched setup == per-subject setup (tests/test_spectral.py:49-83,
    :118-146), and both == eitx's."""
    subs = _subjects()
    alphas = np.linspace(0.1, 0.2, 5)
    a0 = float(alphas.mean())
    kw = {} if family == "spectral_full" else {"rank_bucket": 64}
    Port = SpectralEITSolver if family == "spectral_full" else LowRankSpectralSolver
    Ref = EitxSpectral if family == "spectral_full" else EitxLowRank
    args = (SIGMA0, 2, [el for *_, el in subs], PROTO.ex_mat, PROTO.meas_mat,
            [a0, a0])
    batched = Port.build_batch([cs for _, cs, _ in subs], *args, **kw)
    ref_batched = Ref.build_batch([cs for cs, _, _ in subs], *args, **kw)
    for k, ((cs_ref, cs, el), bs, rb) in enumerate(
            zip(subs, batched, ref_batched)):
        single = Port.build(cs, SIGMA0, 2, el, PROTO.ex_mat, PROTO.meas_mat,
                            a0, **kw).solve(alphas).numpy()
        vb = bs.solve(alphas).numpy()
        bounded(record_property, f"subject {k} batched vs single "
                "allclose(2e-4, 1e-7) err",
                _allclose_err(vb, single, 2e-4, 1e-7), "<=", 1.0)
        _vs_eitx(record_property, f"subject {k} batched vs eitx batched",
                 vb, rb.solve(alphas), family)


def _vs_eitx(record_property, name, got, ref, family):
    """Port vs eitx. Same factorization: the reference's batched-vs-single
    bound (tests/test_spectral.py:81). The full N x N eigh in float32
    moves small voltages more: the scale-relative bound of its
    full-vs-low-rank test (tests/test_spectral.py:108)."""
    if family == "spectral_full":
        bounded(record_property, f"{name} rel to max", _rel_to_max(got, ref),
                "<", 2e-4)
    else:
        bounded(record_property, f"{name} allclose(2e-4, 1e-7) err",
                _allclose_err(got, ref, 2e-4, 1e-7), "<=", 1.0)


def test_lowrank_solve_batch_matches_per_solver_and_guards():
    """tests/test_spectral.py:149-173, and the same-bucket guard."""
    subs = _subjects(sizes=(40, 41, 42), rings=5)
    alphas = np.linspace(0.1, 0.2, 5)
    a0 = float(alphas.mean())
    solvers = LowRankSpectralSolver.build_batch(
        [cs for _, cs, _ in subs], SIGMA0, 2, [el for *_, el in subs],
        PROTO.ex_mat, PROTO.meas_mat, [a0] * 3, rank_bucket=64)
    fused = lowrank_solve_batch(solvers, alphas)
    for s, vf in zip(solvers, fused):
        assert np.allclose(s.solve(alphas).numpy(), vf.numpy(), rtol=1e-5,
                           atol=1e-8)
    assert lowrank_solve_batch([], alphas) == []
    other = create_protocol(16, 2, 1, "meas_current")
    odd = dataclasses.replace(solvers[1], meas_mat=torch.as_tensor(
        other.meas_mat))
    with pytest.raises(ValueError, match="same-bucket"):
        lowrank_solve_batch([solvers[0], odd], alphas)


CEM_F32_BOUND = 3e-3


def _cem_pair(nb=64, rings=6, z=1e-2, dtype=torch.float32):
    nodes, tris, cls = disk_mesh_with_classes(nb, rings)
    cs_ref, cs = _stiffness_pair(nodes, tris, cls, ground_ref=False)
    return (nodes, tris, eitx_build_cem(cs_ref, nodes, tris, 16, z_contact=z),
            build_cem_system(cs, nodes, tris, 16, z_contact=z, dtype=dtype))


def test_cem_arcs_and_fixed_block_equal_eitx():
    nodes, tris, cls = disk_mesh_with_classes(64, 6)
    for coverage in (0.5, 0.2):
        ref = eitx_electrode_arcs(nodes, tris, 16, coverage=coverage)
        got = electrode_arcs(nodes, tris, 16, coverage=coverage)
        assert len(got) == len(ref) == 16
        for (p, length), (pr, lr) in zip(got, ref):
            assert np.array_equal(p, pr) and np.array_equal(length, lr)
    _, _, sys_ref, sys_ = _cem_pair()
    assert np.array_equal(sys_.fixed.numpy(), np.asarray(sys_ref.fixed))
    # the tissue blocks: float32 scatter sums in another order
    assert np.allclose(sys_.k_class.numpy(), np.asarray(sys_ref.k_class),
                       rtol=1e-5, atol=1e-6)
    assert (sys_.n_nodes, sys_.n_el, sys_.dim) == (
        sys_ref.n_nodes, sys_ref.n_el, sys_ref.dim)
    with pytest.raises(ValueError, match="pad_nodes_to=1"):
        build_cem_system(ClassStiffness.build(
            nodes, tris, cls, 5, pad_nodes_to=512, ground_ref=False,
            device=CPU), nodes, tris, 16)


def test_cem_direct_and_spectral_match_eitx(record_property):
    _, _, sys_ref, sys_ = _cem_pair()
    alphas = np.linspace(0.06, 0.18, 5)
    base = np.array([0.006, 0.35, 0.12, 0.017, 0.4])
    sigma = np.tile(base, (5, 1))
    sigma[:, 2] = alphas
    args = (PROTO.ex_mat, PROTO.meas_mat)
    v_direct = forward_solve_cem(sys_, sigma, *args).numpy()
    ref_direct = np.asarray(eitx_forward_cem(sys_ref, sigma, *args))
    # the augmented system's float32 round-off: two float32 CEM solves of
    # the reference agree within 3e-3 of scale (tests/test_cem.py:128)
    bounded(record_property, "direct vs eitx rel to max",
            _rel_to_max(v_direct, ref_direct), "<", CEM_F32_BOUND)
    v_spec = spectral_cem_solver(sys_, base, 2, *args,
                                 alpha0=float(alphas.mean())).solve(alphas)
    ref_spec = eitx_spectral_cem(sys_ref, base, 2, *args,
                                 alpha0=float(alphas.mean())).solve(alphas)
    bounded(record_property, "spectral vs eitx rel to max",
            _rel_to_max(v_spec.numpy(), ref_spec), "<", CEM_F32_BOUND)
    bounded(record_property, "spectral vs direct rel to max",
            _rel_to_max(v_spec.numpy(), v_direct), "<", CEM_F32_BOUND)
    # the float32 error itself, against the port's float64 solve
    _, _, _, sys64 = _cem_pair(dtype=torch.float64)
    v64 = forward_solve_cem(sys64, sigma, *args).numpy()
    bounded(record_property, "direct f32 vs f64 rel to max",
            _rel_to_max(v_direct, v64), "<", CEM_F32_BOUND)


def _mesh_data(nb=48, rings=6, scale=1.0):
    nodes, tris, cls = disk_mesh_with_classes(nb, rings)
    return {"NODES": nodes * scale, "TRIANGLES": tris, "CLASS": cls}


def _f32_bound(solver, electrode_model):
    """Scale-relative float32 bound of the port against eitx: the CEM's
    (tests/test_cem.py:128; "cg" runs the direct CEM solve there), CG's
    (tests/test_fem.py:182: both stop at a relative residual of 1e-6 from
    different roundings), else spectral's (tests/test_spectral.py:108)."""
    if electrode_model == "cem":
        return CEM_F32_BOUND
    return 5e-3 if solver == "cg" else 2e-4


@pytest.mark.parametrize("electrode_model", ["point", "cem"])
@pytest.mark.parametrize("solver", ["spectral", "spectral_full", "cholesky",
                                    "cg"])
def test_simulate_eit_monitoring_f32_matches_eitx(solver, electrode_model,
                                                  record_property):
    kw = dict(n_points=4, solver=solver, electrode_model=electrode_model,
              z_contact=5e-3)
    mesh = _mesh_data()
    ref, _ = eitx_simulate(mesh, EitxSimulationConfig(**kw))
    got, _ = simulate_eit_monitoring(mesh, SimulationConfig(**kw), device=CPU)
    assert got.shape == ref.shape == (4, 208) and np.isfinite(got).all()
    bounded(record_property, "rel to max", _rel_to_max(got, ref), "<",
            _f32_bound(solver, electrode_model))


def _oracle_frames(mesh_data, cfg):
    """The float64 oracle on the port's own schedule and electrodes."""
    classes = ClassMap()
    info = compact_mesh_nodes(prepare_mesh_info(mesh_data, classes))
    materials = get_materials(None)
    _, condspir = _breathing_schedule(cfg, materials, False)
    base = tissue_conductivities(materials, cfg.frequency_hz,
                                 classes.id_to_name(), False)
    sigma = build_sigma_frames(condspir, base, classes)
    el = place_electrodes_equal_spacing(info.node, info.element, 16,
                                        starting_angle=np.pi)
    return monitoring_oracle(info.node, info.element, sigma[:, info.cond], el,
                             PROTO.ex_mat, PROTO.meas_mat).reshape(
                                 cfg.n_points, -1)


def _f64_bound(solver, electrode_model):
    """Scale-relative bound of the float64 route against its float64
    truth. Direct and spectral solves are exact algebra up to float64
    round-off and the low-rank solver's cut of eigenvalues below 1e-7 of
    the largest: 1e-8. CG stops at a relative residual of 1e-6: 1e-4."""
    if solver == "cg" and electrode_model == "point":
        return 1e-4
    return 1e-8


@pytest.mark.parametrize("electrode_model", ["point", "cem"])
@pytest.mark.parametrize("solver", ["spectral", "spectral_full", "cholesky",
                                    "cg"])
def test_simulate_eit_monitoring_f64(solver, electrode_model,
                                     record_property):
    """precision="f64" computes in float64 in the port (eitx's "f64" is
    float32: it never enables x64). Point electrodes: against the float64
    oracle. CEM (no oracle): against the port's float64 direct CEM solve,
    and every case against eitx at the float32 bound."""
    kw = dict(n_points=4, solver=solver, electrode_model=electrode_model,
              z_contact=5e-3, precision="f64")
    mesh = _mesh_data()
    cfg = SimulationConfig(**kw)
    got, _ = simulate_eit_monitoring(mesh, cfg, device=CPU)
    assert got.dtype == np.float64 and got.shape == (4, 208)
    if electrode_model == "point":
        truth = _oracle_frames(mesh, cfg)
    else:
        truth, _ = simulate_eit_monitoring(
            mesh, dataclasses.replace(cfg, solver="cholesky"), device=CPU)
    bounded(record_property, "f64 rel to max", _rel_to_max(got, truth), "<",
            _f64_bound(solver, electrode_model))
    ref, _ = eitx_simulate(mesh, EitxSimulationConfig(**kw))
    bounded(record_property, "vs eitx (float32) rel to max",
            _rel_to_max(got, ref), "<", _f32_bound(solver, electrode_model))


@pytest.mark.parametrize("solver", ["spectral", "spectral_full"])
def test_simulate_subjects_matches_eitx_and_single(solver, record_property):
    meshes = [_mesh_data(40, 6, 100.0), _mesh_data(48, 6, 100.0),
              _mesh_data(40, 5, 100.0)]
    kw = dict(n_points=3, solver=solver, pad_nodes_to=512, pad_elems_to=1024)
    ref = eitx_subjects(meshes, EitxSimulationConfig(**kw))
    got = simulate_eit_monitoring_subjects(meshes, SimulationConfig(**kw),
                                           device=CPU)
    assert len(got) == len(ref) == 3
    for k, ((v, dt), (vr, _), mesh) in enumerate(zip(got, ref, meshes)):
        assert v.shape == vr.shape == (3, 208) and dt > 0
        single, _ = simulate_eit_monitoring(mesh, SimulationConfig(**kw),
                                            device=CPU)
        _vs_eitx(record_property, f"subject {k} vs eitx", v, vr, solver)
        bounded(record_property, f"subject {k} vs single allclose(2e-4, "
                "1e-7) err", _allclose_err(v, single, 2e-4, 1e-7), "<=", 1.0)
