"""The six examples of the port (examples/torch/) on the CPU, at the coarse
sizes of tests/test_examples.py. The mesh demos and the physics example
are held to eitx's examples run the same way: mesh arrays equal, voltages
at the port's float32 bound against eitx (tests/test_torch_fem.py).
real_slice_demo and auto_mode_demo run on the port alone; their stages
are held to eitx by the pipeline, mesh and FEM tests."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_bounds import bounded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: parallel test workers share the CPU."""
    # never set back above 1: a batched float32 linalg.solve (oneMKL)
    # later in the same worker can then hang
    torch.set_num_threads(1)


def _load(package: str, name: str):
    """examples/<name>.py (eitx) or examples/torch/<name>.py (the port)
    as a module of its own name, with the meshes of its module-level
    ``create_mesh`` recorded in ``meshes``."""
    folder = os.path.join(ROOT, "examples", *(["torch"] if package ==
                                              "port" else []))
    spec = importlib.util.spec_from_file_location(
        f"{package}_example_{name}", os.path.join(folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.meshes = []
    inner = getattr(mod, "create_mesh", None)
    if inner is None:
        return mod

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        mod.meshes.append(out[1])
        return out

    mod.create_mesh = recorded
    return mod


def _assert_same_meshes(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for key in ("NODES", "TRIANGLES", "CLASS"):
            assert np.array_equal(np.asarray(g[key]), np.asarray(r[key])), key


@pytest.mark.parametrize(
    "script", ["building_floorplan", "spiral_art", "gear_section"])
def test_mesh_example_equals_eitx(tmp_path, monkeypatch, script):
    monkeypatch.chdir(tmp_path)
    ref = _load("eitx", script)
    ref.main()
    got = _load("port", script)
    mesh = got.main(device="cpu")
    _assert_same_meshes(got.meshes, ref.meshes)
    assert mesh is got.meshes[0]
    assert [p.suffix for p in tmp_path.iterdir()] == [".png"]


def test_eit_monitoring_example_matches_eitx(tmp_path, record_property):
    ref_dir, got_dir = tmp_path / "eitx", tmp_path / "port"
    ref_dir.mkdir()
    got_dir.mkdir()
    ref = _load("eitx", "eit_monitoring")
    v_ref, _ = ref.main(str(ref_dir), lc=14.0, n_points=4)
    got = _load("port", "eit_monitoring")
    v, dsigma = got.main(str(got_dir), lc=14.0, n_points=4, device="cpu")
    # the thorax and the three subjects
    _assert_same_meshes(got.meshes, ref.meshes)
    assert len(got.meshes) == 4
    assert v.shape == np.asarray(v_ref).shape and v.shape[0] == 4
    assert dsigma.shape[0] == 4 and np.isfinite(dsigma).all()
    rel = np.abs(v - v_ref) / (np.abs(v_ref) + 1e-9)
    bounded(record_property, "max_rel", rel.max(), "<", 2e-2)
    bounded(record_property, "mean_rel", rel.mean(), "<", 2e-3)
    rows = np.loadtxt(got_dir / "monitoring.dat")
    assert rows.shape[1] == 208 and np.isfinite(rows).all()
    assert (got_dir / "greit_strip.png").stat().st_size > 0


def test_real_slice_demo_runs(tmp_path):
    mod = _load("port", "real_slice_demo")
    v, mesh = mod.main(str(tmp_path), lc=14.0, n_points=4, device="cpu")
    assert v.shape == (4, 208) and np.isfinite(v).all()
    assert v.std(axis=0).mean() > 0  # the breathing modulates the rows
    assert set(np.unique(mesh["CLASS"])) >= {0, 1, 2, 3}
    assert np.loadtxt(tmp_path / "real_slice_dataset.dat").shape == (4, 208)
    assert (tmp_path / "real_slice_mesh.png").stat().st_size > 0


def test_auto_mode_demo_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    summary = _load("port", "auto_mode_demo").main(device="cpu")
    assert summary["status"] == "success"
    assert summary["tissue_classes_in_answer"] == ["0", "1", "2", "3", "4"]
    rows = np.loadtxt(summary["dataset_file"])
    assert rows.shape == (25 * 12, 208) and np.isfinite(rows).all()


@pytest.mark.parametrize("script", [
    "building_floorplan", "spiral_art", "gear_section", "eit_monitoring",
    "real_slice_demo", "auto_mode_demo"])
def test_example_defaults_to_the_card(script):
    """``device`` defaults to "cuda"; without a card the example refuses
    rather than running on the CPU."""
    import inspect

    main = _load("port", script).main
    assert inspect.signature(main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            if script in ("eit_monitoring", "real_slice_demo"):
                main(".", 14.0, 4)
            else:
                main()
